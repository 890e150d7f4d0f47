"""Which stage of the port's fused VQA path drives its per-draw distance from
the plain path, on one NVIDIA GPU:

    python3 scripts/torch_vqa_stage_split.py [--seeds 9,10,...]

The VQA teacher of chip_smoke.py's generation phase (12L / 12L at 480 px,
params from seed 0 in bf16) ranks 128 of 3,128 answers for 16 questions on
each input draw (chip_smoke.vqa_inputs over Rand(seed); by default seed 9
and chip_smoke.VQA_SEEDS). On each draw forward_eval's topk_probs are taken
with each stage of the fused path in turn on its plain version:
- "vit": the ViT (#1 patch_embed, #2 fused self-attention);
- "question": the question encoder's self and fusion sublayers (#2 / #3);
- "decoder_cores": the answer decoder's flash cores (#5 / #6,
  chip_smoke.plain_cores); the rest of the decoder is already plain code;
- "scoring_f32": nothing swapped, the MLM head computed in f32 from the
  decoder's last hidden state, so the scores start from unrounded logits.
  The plain path's scoring is the same code, so this stage's share of the
  kernel-vs-plain gap is nil by construction; it measures what the bf16
  logits cost against f32.
A stage's share of the gap is 1 - gap(stage plain) / gap(kernel path),
where gap is the max abs difference of topk_probs from the plain path.
Prints each draw, then the medians. Checks only that every output is
finite; the check on the path stays chip_smoke.py's. Exits non-zero
without a CUDA device.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import statistics
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAGES = ("kernel", "vit", "question", "decoder_cores", "scoring_f32")


@contextlib.contextmanager
def stage_plain(cs, stage: str):
    """The kernel path with `stage` of XVLMForVQA.forward_eval on its plain
    version ("kernel": nothing swapped)."""
    import torch

    from efficientvlm_tpu_torch.models import bert as B
    from efficientvlm_tpu_torch.models import vit as V

    def plain_if(pred):
        def make(orig):
            def fn(*a, **kw):
                return orig(*a, **dict(kw, impl="plain")) if pred(kw) else orig(*a, **kw)
            return fn
        return make

    def head_f32(orig):
        def fn(params, h, cfg, dtype=None):
            return orig(params, h.float(), cfg, dtype=torch.float32)
        return fn

    with contextlib.ExitStack() as stack:
        if stage == "vit":
            stack.enter_context(cs.patched(V, "vit_apply", plain_if(lambda kw: True)))
        elif stage == "question":
            stack.enter_context(cs.patched(B, "bert_apply",
                                           plain_if(lambda kw: not kw.get("is_decoder"))))
        elif stage == "decoder_cores":
            stack.enter_context(cs.plain_cores())
        elif stage == "scoring_f32":
            stack.enter_context(cs.patched(B, "mlm_head_apply", head_f32))
        yield


def split(cs, model, params, draws) -> dict:
    """Per draw and stage: (max abs difference from the plain path, from f32
    compute) of topk_probs; the medians and each stage's median share."""
    import torch

    from efficientvlm_tpu_torch.bridge import cast_floating

    bf16, k = torch.bfloat16, cs.VQA_UNIT["k"]
    params32 = cast_floating(params, torch.float32)
    rows = []
    for i, inputs in enumerate(draws):
        with torch.inference_mode():
            p_plain = model.forward_eval(params, *inputs, k=k, dtype=bf16, impl="plain")[1]
            p_32 = model.forward_eval(params32, inputs[0].float(), *inputs[1:], k=k,
                                      dtype=torch.float32, impl="plain")[1]
            row = {}
            for stage in STAGES:
                with stage_plain(cs, stage):
                    p = model.forward_eval(params, *inputs, k=k, dtype=bf16)[1].float()
                cs.check(bool(torch.isfinite(p).all()), f"vqa stage split {stage}: not finite")
                row[stage] = ((p - p_plain.float()).abs().max().item(),
                              (p - p_32.float()).abs().max().item())
        row["plain_vs_f32"] = (0.0, (p_plain.float() - p_32.float()).abs().max().item())
        rows.append(row)
        gap = row["kernel"][0]
        print(f"vqa stage split draw {i}: kernel vs plain {gap:.4e}; with one stage plain, "
              "vs plain / vs f32 (share of the gap): " + "; ".join(
                  f"{st} {row[st][0]:.4e} / {row[st][1]:.4e} ({1 - row[st][0] / gap:+.2f})"
                  for st in STAGES[1:]) + f"; plain vs f32 {row['plain_vs_f32'][1]:.4e}")
    med = {st: (statistics.median(r[st][0] for r in rows),
                statistics.median(r[st][1] for r in rows)) for st in rows[0]}
    shares = {st: statistics.median(1 - r[st][0] / r["kernel"][0] for r in rows)
              for st in STAGES[1:]}
    print(f"vqa stage split medians over {len(rows)} draws: " + "; ".join(
        f"{st} vs plain {m[0]:.4e} vs f32 {m[1]:.4e}" for st, m in med.items())
        + "; median share of the gap: " + ", ".join(f"{st} {v:+.2f}" for st, v in shares.items()))
    return {"draws": rows, "medians": med, "shares": shares}


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--seeds", default="")
    args = p.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_vqa_stage_split: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from efficientvlm_tpu_torch.device import strict_fp32

    strict_fp32()
    cs.phase_environment()
    seeds = ([int(s) for s in args.seeds.split(",")] if args.seeds
             else [9, *cs.VQA_SEEDS])
    model, params = cs.build_generation("vqa", 12)
    split(cs, model, params, [cs.vqa_inputs(cs.Rand(s)) for s in seeds])
    return 0


if __name__ == "__main__":
    sys.exit(main())
