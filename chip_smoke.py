"""On-card smoke test of the PyTorch/CUDA port (efficientvlm_tpu_torch).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It builds the port's CUDA kernels from csrc/ (into build/kernels/), then:

1. environment: prints the card's name and power limit (nvidia-smi) and the
   kernel build time;
2. kernels: holds each of the four ported kernels against its plain PyTorch
   version on the card, in bf16, at the shapes of the main path (masked key
   tails, non-trivial head gates, a rectangular 8-head A=512 width, the
   grouped rerank with and without its LayerNorm epilogue);
3. slice: drives retrieval evaluation at the full width of X-VLM base
   (CLIP-ViT-B/16 at 384 px, BERT-base, 40 text tokens): the teacher 12L/12L
   and the student 6L/6L retrieval forward at batch 32, one i2t (grouped)
   and one t2i (expanded) rerank chunk of 4 rows x 256 candidates, and
   retrieval_scores -> itm_eval over a synthetic bank; checks the kernel
   launch counts, finite outputs, and the kernel path against the plain
   path in f32 params;
4. times: each kernel's time beside its bound, its plain version's and a
   library yardstick's time (CUDA events, median of runs after warm-up),
   and pairs/s.

Weights are random, made from a seed. Any failed check exits non-zero
before the last line, which is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Without a CUDA device it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 tensor-core peak
PEAK_BYTES = 3.35e12       # H100 SXM HBM3 rate
BF16_ULP = 2.0 ** -8


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond: bool, msg: str):
    if not cond:
        fail(msg)


def timed_ms(fn, *, iters: int = 10, runs: int = 5, warmup: int = 2) -> float:
    """Median over `runs` of the mean time of `iters` back-to-back calls,
    by CUDA events, after `warmup` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def bound(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes")


# --------------------------------------------------------------------------
# phase 1: environment and build
# --------------------------------------------------------------------------


def phase_environment() -> str:
    import torch

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip()
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    from efficientvlm_tpu_torch.kernels.build import build, library

    path, log, seconds = build()
    library()
    print(f"kernels built in {seconds:.1f} s (0 = reused) -> {os.path.relpath(path)}")
    for line in log.splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            print("  ptxas:", line.strip())
    return smi


# --------------------------------------------------------------------------
# phase 2: each kernel against its plain version, bf16, main-path shapes
# --------------------------------------------------------------------------


class Rand:
    def __init__(self, seed: int):
        import torch

        self.g = torch.Generator(device="cuda")
        self.g.manual_seed(seed)

    def __call__(self, *shape, std=1.0, mean=0.0, dtype=None):
        import torch

        x = torch.randn(shape, generator=self.g, device="cuda") * std + mean
        return x.to(dtype or torch.bfloat16)

    def attn(self, d, a, de=None):
        de = de or d
        w = lambda i, o: {"kernel": self(i, o, std=i ** -0.5), "bias": self(o, std=0.1)}
        return {"q": w(d, a), "k": w(de, a), "v": w(de, a), "out": w(a, d)}

    def mask(self, b, s, min_len):
        import torch

        lens = torch.randint(min_len, s + 1, (b,), generator=self.g, device="cuda")
        lens[0] = s  # one full row, the rest with masked tails
        return (torch.arange(s, device="cuda")[None] < lens[:, None]).to(torch.int32)

    def gates(self, h):
        import torch

        return torch.rand(h, generator=self.g, device="cuda") * 0.8 + 0.2


def kernel_cases(rnd):
    """(kernel name, case, kernel call, plain call, flops, bytes) at main-path
    shapes; the first case of each kernel is the one timed in phase 4."""
    import torch

    from efficientvlm_tpu_torch.ops import fused_mha as F
    from efficientvlm_tpu_torch.ops.patch_embed import fused_patch_embed, patch_embed_plain

    cases = []
    # 1: ViT input stage, B=32 at 384 px / patch 16
    b, res, p, d = 32, 384, 16, 768
    n = (res // p) ** 2
    k = p * p * 3
    pp = {"patch_embed": {"kernel": rnd(p, p, 3, d, std=k ** -0.5)},
          "class_embedding": rnd(d, std=0.5), "pos_embed": {"embedding": rnd(n + 1, d, std=0.5)},
          "pre_ln": {"scale": rnd(d, std=0.1, mean=1.0), "bias": rnd(d, std=0.1)}}
    img = rnd(b, res, res, 3)
    cases.append(("patch_embed", "vit_b16_384",
                  lambda: fused_patch_embed(pp, img, patch_size=p),
                  lambda: patch_embed_plain(pp, img, patch_size=p),
                  2 * b * n * k * d,
                  2 * (img.numel() + k * d + b * (n + 1) * d) + 4 * n * d, (pp, img, p)))

    def self_case(case, bsz, t, a, heads):
        prm, x = rnd.attn(d, a), rnd(bsz, t, d)
        mask, hz = rnd.mask(bsz, t, t // 4), rnd.gates(heads)
        kb = F._key_bias(bsz, t, mask, None, x.device)
        flops = 2 * bsz * t * d * a * 4 + 4 * bsz * t * t * a
        nbytes = 2 * (2 * x.numel() + 4 * d * a) + 4 * bsz * t
        return ("fused_self_attention", case,
                lambda: F.fused_self_attention(prm, x, num_heads=heads, mask=mask, head_z=hz),
                lambda: F.self_attention_plain(prm, x, kb, hz, heads), flops, nbytes,
                (prm, x, mask, hz, heads))

    cases.append(self_case("vit_b32_t577", 32, 577, 768, 12))
    cases.append(self_case("text_b1024_t40", 1024, 40, 768, 12))
    cases.append(self_case("rect_a512_h8", 32, 577, 512, 8))

    def cross_case(case, bsz, t, s, a, heads):
        prm, x, enc = rnd.attn(d, a), rnd(bsz, t, d), rnd(bsz, s, d)
        mask, hz = rnd.mask(bsz, s, s // 4), rnd.gates(heads)
        kb = F._key_bias(bsz, s, mask, None, x.device)
        flops = 2 * bsz * t * d * a * 2 + 2 * bsz * s * d * a * 2 + 4 * bsz * t * s * a
        nbytes = 2 * (2 * x.numel() + enc.numel() + 4 * d * a) + 4 * bsz * s
        return ("fused_cross_attention", case,
                lambda: F.fused_cross_attention(prm, x, enc, num_heads=heads, mask=mask,
                                                head_z=hz),
                lambda: F.cross_attention_plain(prm, x, enc, kb, hz, heads), flops, nbytes,
                (prm, x, enc, mask, hz, heads))

    cases.append(cross_case("fusion_b32", 32, 40, 577, 768, 12))
    cases.append(cross_case("t2i_b1024", 1024, 40, 577, 768, 12))
    cases.append(cross_case("rect_a512_h8", 32, 40, 577, 512, 8))

    def grouped_case(case, a, heads, with_ln):
        bk, g, t, s = 4, 256, 40, 577
        prm, x, enc = rnd.attn(d, a), rnd(bk * g, t, d), rnd(bk, s, d)
        mask, hz = rnd.mask(bk, s, s // 4), rnd.gates(heads)
        ln = {"scale": rnd(d, std=0.1, mean=1.0, dtype=torch.float32),
              "bias": rnd(d, std=0.1, dtype=torch.float32)} if with_ln else None
        kb = F._key_bias(bk, s, mask, None, x.device)
        flops = 2 * bk * g * t * d * a * 2 + 2 * bk * s * d * a * 2 + 4 * bk * g * t * s * a
        nbytes = 2 * (2 * x.numel() + enc.numel() + 4 * d * a) + 4 * bk * s
        return ("fused_cross_attention_grouped", case,
                lambda: F.fused_cross_attention_grouped(prm, x, enc, num_heads=heads,
                                                        kv_groups=g, mask=mask, head_z=hz,
                                                        ln_params=ln),
                lambda: F.cross_attention_grouped_plain(prm, x, enc, kb, hz, heads, g, ln),
                flops, nbytes, (prm, x, enc, mask, hz, heads, ln))

    cases.append(grouped_case("i2t_g256_ln", 768, 12, True))
    cases.append(grouped_case("i2t_g256_no_ln", 768, 12, False))
    cases.append(grouped_case("rect_a512_h8_ln", 512, 8, True))
    return cases


def phase_kernels(cases) -> dict:
    """Max abs error of each kernel against its plain version, held to 4
    bf16 ulps at the output's largest magnitude: both round to bf16 at the
    same points and differ in summation order, in the exp approximation, and
    in the kernel rounding un-normalised softmax weights before P.V."""
    import torch

    errs = {}
    for name, case, run, plain, *_ in cases:
        out, ref = run().float(), plain().float()
        torch.cuda.synchronize()
        check(out.shape == ref.shape, f"{name}/{case}: shape {tuple(out.shape)} != "
                                      f"{tuple(ref.shape)}")
        check(bool(torch.isfinite(out).all()), f"{name}/{case}: non-finite output")
        err = (out - ref).abs().max().item()
        tol = 4 * BF16_ULP * ref.abs().max().item()
        print(f"kernel {name} [{case}]: max_abs_err {err:.4e} tol {tol:.4e} "
              f"(max|plain| {ref.abs().max().item():.3f})")
        check(err <= tol, f"{name}/{case} disagrees with its plain version")
        errs[name] = max(errs.get(name, 0.0), err)
    return errs


# --------------------------------------------------------------------------
# phase 3: the slice
# --------------------------------------------------------------------------


def build_model(layers: int):
    from efficientvlm_tpu_torch.config import Config, TextConfig, VisionConfig
    from efficientvlm_tpu_torch.models.model_retrieval import XVLMForRetrieval

    vcfg = VisionConfig.create(num_hidden_layers=layers, image_res=384)
    tcfg = TextConfig.create(num_hidden_layers=layers, fusion_layer=layers // 2,
                             encoder_width=768, hidden_dropout_prob=0.0,
                             attention_probs_dropout_prob=0.0)
    model = XVLMForRetrieval(vcfg, tcfg, Config({"embed_dim": 256}))
    return model, model.init(0, device="cuda")


def wrappers():
    from efficientvlm_tpu_torch.ops import fused_mha as F
    from efficientvlm_tpu_torch.ops.patch_embed import fused_patch_embed

    return {"patch_embed": fused_patch_embed, "fused_self_attention": F.fused_self_attention,
            "fused_cross_attention": F.fused_cross_attention,
            "fused_cross_attention_grouped": F.fused_cross_attention_grouped}


def counts() -> dict:
    return {k: w.launches for k, w in wrappers().items()}


def expect_launches(before: dict, expected: tuple, what: str):
    now = counts()
    delta = tuple(now[k] - before[k] for k in now)
    print(f"launches {what}: {dict(zip(now, delta))}")
    check(delta == expected, f"{what}: launches {delta} != expected {expected}")
    return now


def phase_slice(rnd):
    import numpy as np
    import torch

    from efficientvlm_tpu_torch.bridge import cast_floating
    from efficientvlm_tpu_torch.evaluation import retrieval as R

    bf16 = torch.bfloat16
    teacher, t_params = build_model(12)
    student, s_params = build_model(6)
    t_bf16, s_bf16 = cast_floating(t_params, bf16), cast_floating(s_params, bf16)
    image = rnd(32, 384, 384, 3)
    ids = torch.randint(0, 30522, (32, 40), generator=rnd.g, device="cuda")
    atts = rnd.mask(32, 40, 8)
    rows, k = 4, 256
    ib, txt = rnd(rows, 577, 768), rnd(rows * k, 40, 768)
    txt_atts = rnd.mask(rows * k, 40, 8)
    ib_expanded = ib.repeat_interleave(k, 0)

    for w in wrappers().values():  # the main path's run starts here
        w.launches = 0
    c = counts()
    with torch.inference_mode():
        out = R.retrieval_forward(teacher, t_bf16, image, ids, atts, dtype=bf16)
        c = expect_launches(c, (1, 24, 6, 0), "teacher forward")
        for x, shape in zip(out, [(32, 256), (32, 256), (32, 2)]):
            check(tuple(x.shape) == shape and bool(torch.isfinite(x.float()).all()),
                  f"teacher forward output {tuple(x.shape)} not finite / not {shape}")
        norms = torch.linalg.vector_norm(out[0].float(), dim=-1)
        check(bool(((norms - 1).abs() < 1e-2).all()), "image features are not unit vectors")
        out = R.retrieval_forward(student, s_bf16, image, ids, atts, dtype=bf16)
        c = expect_launches(c, (1, 12, 3, 0), "student forward")
        check(all(bool(torch.isfinite(x.float()).all()) for x in out), "student not finite")
        i2t = R.itm_rerank_scores(teacher, t_bf16, ib, txt, txt_atts, rows, k, dtype=bf16)
        c = expect_launches(c, (0, 6, 0, 6), "i2t rerank chunk")
        t2i = R.itm_rerank_scores(teacher, t_bf16, ib_expanded, txt, txt_atts, rows, k,
                                  dtype=bf16)
        c = expect_launches(c, (0, 6, 6, 0), "t2i rerank chunk")
        for x in (i2t, t2i):
            check(tuple(x.shape) == (rows, k) and bool(torch.isfinite(x.float()).all()),
                  "rerank chunk output not finite / wrong shape")
        # the same pairs score alike whether the image K/V are grouped or expanded
        diff = (i2t.float() - t2i.float()).abs().max().item()
        print(f"i2t (grouped) vs t2i (expanded) on the same pairs: max_abs_diff {diff:.4e}")
        check(diff <= 0.05 * max(1.0, t2i.float().abs().max().item()),
              "grouped and expanded rerank disagree")

    # retrieval_scores -> itm_eval over a synthetic bank: 64 images x 5 texts
    n_img, per, k_test = 64, 5, 32
    n_txt = n_img * per
    gen = np.random.default_rng(0)
    img_feats = gen.standard_normal((n_img, 577, 768), dtype=np.float32)
    txt_feats = gen.standard_normal((n_txt, 40, 768), dtype=np.float32)
    txt_bank_atts = np.ones((n_txt, 40), np.int32)
    txt_bank_atts[::2, 20:] = 0
    img_emb = gen.standard_normal((n_img, 256)).astype(np.float32)
    txt_emb = img_emb[np.arange(n_txt) // per] + 0.5 * gen.standard_normal((n_txt, 256))
    img_emb /= np.linalg.norm(img_emb, axis=1, keepdims=True)
    txt_emb = (txt_emb / np.linalg.norm(txt_emb, axis=1, keepdims=True)).astype(np.float32)
    t0 = time.perf_counter()
    s_i2t, s_t2i = R.retrieval_scores(teacher, t_bf16, img_feats, img_emb, txt_feats,
                                      txt_bank_atts, txt_emb, k_test=k_test, dtype=bf16)
    torch.cuda.synchronize()
    scores_s = time.perf_counter() - t0
    chunks_i2t, chunks_t2i = n_img // 4, n_txt // 4
    c = expect_launches(c, (0, 6 * (chunks_i2t + chunks_t2i), 6 * chunks_t2i, 6 * chunks_i2t),
                        "retrieval_scores")
    check(bool(((s_i2t > -100).sum(1) == k_test).all()) and
          bool(((s_t2i > -100).sum(1) == k_test).all()), "rerank filled the wrong entries")
    check(bool(np.isfinite(s_i2t).all() and np.isfinite(s_t2i).all()), "scores not finite")
    metrics = R.itm_eval(s_i2t, s_t2i, np.arange(n_txt) // per,
                         [list(range(i * per, (i + 1) * per)) for i in range(n_img)])
    check(all(0.0 <= v <= 100.0 for v in metrics.values()), f"itm_eval out of range {metrics}")
    print(f"retrieval_scores {n_img} images x {n_txt} texts, k_test {k_test}: "
          f"{scores_s:.2f} s host clock; itm_eval {json.dumps(metrics)}")
    main_launches = counts()

    # kernel path against the plain path, the same f32 params, bf16 compute
    with torch.inference_mode():
        sl = slice(0, 8)
        kern = R.retrieval_forward(teacher, t_params, image[sl], ids[sl], atts[sl], dtype=bf16)
        plain = R.retrieval_forward(teacher, t_params, image[sl], ids[sl], atts[sl], dtype=bf16,
                                    impl="plain")
        plain32 = R.retrieval_forward(teacher, t_params, image[sl].float(), ids[sl], atts[sl],
                                      impl="plain")
    for name, a, b, c32 in zip(("image_feat", "text_feat", "itm_logits"), kern, plain, plain32):
        a, b, c32 = a.float(), b.float(), c32.float()
        err = (a - b).abs().max().item()
        tol = 0.05 * b.abs().max().item()
        print(f"kernel path vs plain path (f32 params, bf16 compute) {name}: max_abs_err "
              f"{err:.4e} tol {tol:.4e}; vs plain f32 compute {(a - c32).abs().max().item():.4e}")
        check(err <= tol, f"kernel path and plain path disagree on {name}")
    return {"teacher": (teacher, t_bf16), "student": (student, s_bf16), "image": image,
            "ids": ids, "atts": atts, "rerank": (ib, ib_expanded, txt, txt_atts, rows, k),
            "launches": main_launches, "retrieval_scores_s": scores_s}


# --------------------------------------------------------------------------
# phase 4: times
# --------------------------------------------------------------------------


def library_yardstick(name, args):
    """One PyTorch composition of library calls computing the kernel's
    function: torch.matmul projections + scaled_dot_product_attention for
    the attention kernels, torch.matmul + F.layer_norm for the patch
    embedding. Timed only; the port never calls it."""
    import torch
    import torch.nn.functional as Fn

    def proj(x, p):
        return torch.matmul(x, p["kernel"]) + p["bias"]

    def heads(x, h):
        b, t, a = x.shape
        return x.reshape(b, t, h, a // h).transpose(1, 2)

    def attend(prm, x, enc, mask, hz, h, fold=1):
        q, k, v = proj(x, prm["q"]), proj(enc, prm["k"]), proj(enc, prm["v"])
        b, t, a = q.shape
        q = heads(q.reshape(b // fold, fold * t, a), h)
        bias = ((1.0 - mask.to(q.dtype)) * -1e9)[:, None, None, :]
        ctx = Fn.scaled_dot_product_attention(q, heads(k, h), heads(v, h), attn_mask=bias)
        ctx = (ctx * hz.to(ctx.dtype)[None, :, None, None]).transpose(1, 2).reshape(b, t, a)
        return proj(ctx, prm["out"])

    if name == "fused_self_attention":
        prm, x, mask, hz, h = args
        return lambda: attend(prm, x, x, mask, hz, h)
    if name == "fused_cross_attention":
        prm, x, enc, mask, hz, h = args
        return lambda: attend(prm, x, enc, mask, hz, h)
    if name == "fused_cross_attention_grouped":
        prm, x, enc, mask, hz, h, ln = args
        fold = x.shape[0] // enc.shape[0]
        return lambda: Fn.layer_norm(x + attend(prm, x, enc, mask, hz, h, fold), (x.shape[-1],),
                                     ln["scale"].to(x.dtype), ln["bias"].to(x.dtype), 1e-12)
    raise ValueError(name)


def patch_yardstick(pp, img, p):
    import torch
    import torch.nn.functional as Fn

    b, res, _, c = img.shape
    n, d = (res // p) ** 2, pp["pre_ln"]["scale"].shape[0]
    w = pp["patch_embed"]["kernel"].reshape(-1, d)
    pos = pp["pos_embed"]["embedding"]
    cls = (pp["class_embedding"] + pos[0]).expand(b, 1, d)

    def run():
        x = img.reshape(b, res // p, p, res // p, p, c).permute(0, 1, 3, 2, 4, 5)
        y = torch.matmul(x.reshape(b, n, p * p * c), w) + pos[1:]
        y = torch.cat([cls, y], dim=1)
        return Fn.layer_norm(y, (d,), pp["pre_ln"]["scale"], pp["pre_ln"]["bias"], 1e-5)
    return run


KERNEL_META = {
    "patch_embed": ("efficientvlm_tpu_torch/csrc/patch_embed.cu",
                    "efficientvlm_tpu/ops/pallas_patch_embed.py:62"),
    "fused_self_attention": ("efficientvlm_tpu_torch/csrc/fused_mha.cu",
                             "efficientvlm_tpu/ops/pallas_fused_mha.py:148"),
    "fused_cross_attention": ("efficientvlm_tpu_torch/csrc/fused_mha.cu",
                              "efficientvlm_tpu/ops/pallas_fused_mha.py:270"),
    "fused_cross_attention_grouped": ("efficientvlm_tpu_torch/csrc/fused_mha.cu",
                                      "efficientvlm_tpu/ops/pallas_fused_mha.py:624"),
}


def phase_times(cases, errs, slice_state) -> list:
    import torch

    from efficientvlm_tpu_torch.evaluation import retrieval as R

    bf16 = torch.bfloat16
    rows_out, seen = [], set()
    for name, case, run, plain, flops, nbytes, *extra in cases:
        if name in seen:
            continue
        seen.add(name)
        lib = (patch_yardstick(*extra[0]) if name == "patch_embed"
               else library_yardstick(name, extra[0]))
        with torch.inference_mode():
            ms, plain_ms, lib_ms = timed_ms(run), timed_ms(plain), timed_ms(lib)
        bound_ms, bound_by = bound(flops, nbytes)
        print(f"time {name} [{case}]: {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
              f"{lib_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
              f"{flops / ms / 1e9:.1f} TFLOP/s")
        src, replaces = KERNEL_META[name]
        rows_out.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                         "launches": slice_state["launches"][name],
                         "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
                         "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms})
    # the other main-path shapes of the self / cross kernels, for the record
    for name, case, run, plain, flops, nbytes, *extra in cases:
        if case in ("text_b1024_t40", "t2i_b1024"):
            with torch.inference_mode():
                ms = timed_ms(run)
            print(f"time {name} [{case}]: {ms:.4f} ms, bound {bound(flops, nbytes)[0]:.4f} ms")

    image, ids, atts = slice_state["image"], slice_state["ids"], slice_state["atts"]
    ib, ib_x, txt, txt_atts, rows, k = slice_state["rerank"]
    tput = {}
    with torch.inference_mode():
        for which in ("teacher", "student"):
            model, params = slice_state[which]
            ms = timed_ms(lambda: R.retrieval_forward(model, params, image, ids, atts,
                                                      dtype=bf16), iters=5)
            tput[f"{which}_pairs_per_s"] = 32 / ms * 1e3
            ms = timed_ms(lambda: R.itm_rerank_scores(model, params, ib, txt, txt_atts, rows, k,
                                                      dtype=bf16), iters=5)
            tput[f"{which}_rerank_i2t_pairs_per_s"] = rows * k / ms * 1e3
        model, params = slice_state["teacher"]
        ms = timed_ms(lambda: R.itm_rerank_scores(model, params, ib_x, txt, txt_atts, rows, k,
                                                  dtype=bf16), iters=3, runs=3)
        tput["teacher_rerank_t2i_pairs_per_s"] = rows * k / ms * 1e3
        tput["plain_teacher_pairs_per_s"] = 32 / timed_ms(
            lambda: R.retrieval_forward(model, params, image, ids, atts, dtype=bf16,
                                        impl="plain"), iters=3, runs=3) * 1e3
    tput["teacher_retrieval_scores_64x320_s"] = slice_state["retrieval_scores_s"]
    print(json.dumps({"throughput": tput}))
    with torch.inference_mode():
        model, params = slice_state["teacher"]
        profile("teacher forward b32", lambda: R.retrieval_forward(
            model, params, image, ids, atts, dtype=bf16))
        profile("teacher i2t rerank chunk 4x256", lambda: R.itm_rerank_scores(
            model, params, ib, txt, txt_atts, rows, k, dtype=bf16))
    return rows_out


def profile(what: str, fn, calls: int = 3, top: int = 12):
    """Device time by kernel over `calls` calls (torch.profiler), and the
    device's busy share of the host-clock window."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # device-side events only (kernels, copies): the aten ops that launched
    # them carry the same device time again
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in kernels)
    check(busy_us > 0, f"profile {what}: no device time recorded")
    print(f"profile {what}: {calls} calls, device busy {busy_us / calls / 1e3:.3f} ms/call "
          f"of {wall_us / calls / 1e3:.3f} ms/call host clock, idle share "
          f"{1 - busy_us / wall_us:.3f}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"  {e.self_device_time_total / busy_us:6.1%} {e.self_device_time_total / calls / 1e3:8.3f}"
              f" ms/call {e.count // calls:5d}x  {e.key[:90]}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from efficientvlm_tpu_torch.device import strict_fp32

    strict_fp32()
    t0 = time.perf_counter()
    smi = phase_environment()
    rnd = Rand(0)
    cases = kernel_cases(rnd)
    errs = phase_kernels(cases)
    slice_state = phase_slice(rnd)
    kernels = phase_times(cases, errs, slice_state)
    print(f"card: {smi}; total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
