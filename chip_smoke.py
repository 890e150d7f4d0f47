"""On-card smoke test of the PyTorch/CUDA port (efficientvlm_tpu_torch).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It builds the port's CUDA kernels from csrc/ (into build/kernels/), then:

1. environment: prints the card's name and power limit (nvidia-smi) and the
   kernel build time;
2. kernels: holds each of the six ported kernels against its plain PyTorch
   version on the card, in bf16, at the shapes of the main paths (masked key
   tails, non-trivial head gates, a rectangular 8-head A=512 width, the
   grouped rerank with and without its LayerNorm epilogue; for the two
   bare attention cores every shape the generation path gives them, called
   as the decoder calls them (q the projection's strided view, unscaled,
   with the softmax scale), with a causal + padding matrix bias, the decode
   mask over a partly filled cache, grouped K/V with G=3 and G=128, and
   edge cases of the split-KV and small-problem regimes: a ragged last
   split, a split whose keys are all masked, a row whose only key is in the
   last split, (b, h) counts no block size divides, batch-broadcast biases,
   dh 32 and 128; misaligned or wrongly shaped operands must raise), and
   the device kernels under #1-#4 on their own: gemm_bias at the ViT's
   fused Q/K/V shape, gemm_ln (the LayerNorm epilogue over a cluster) at
   #4's output projection, attn_core and attn_wgmma (the wgmma core of #4)
   at the i2t rerank, ViT and fusion shapes; the training forms: the probs
   forms of #2 and #3 (the pre-gate f32 softmax maps beside the output) at
   the training batch's ViT, text and fusion shapes and at the pruned widths
   (2-12 heads), and their core attn_probs on its own at the long-key
   shapes, the maps held entry by entry, with row sums and masked keys
   checked, and every input
   gradient of the differentiable forms of #1-#3 against the plain
   versions' own autograd;
3. paths, each driven with every launch count set to 0 just before it and
   read just after:
   - retrieval evaluation at the full width of X-VLM base (CLIP-ViT-B/16 at
     384 px, BERT-base, 40 text tokens): the teacher 12L/12L and the student
     6L/6L retrieval forward at batch 32, one i2t (grouped) and one t2i
     (expanded) rerank chunk of 4 rows x 256 candidates, and
     retrieval_scores -> itm_eval over a synthetic bank;
   - generation: VQA answer ranking (480 px, batch 16, 25 question tokens,
     3,128 answers x 6 tokens, k = 128) and captioning (384 px, batch 16,
     3 beams and greedy, max_length 20, min_length 5, a 4-token prompt), for
     the teacher and the student;
   - the retrieval pruning fine-tune (configs/x-vlm-small-ft/
     Retrieval_coco.yaml: the 6L/6L student with L0 gates over head pairs,
     the 12L/12L teacher, KD, ITC, ITM, the Lagrangian and three AdamWs) at
     batch 24 for three steps, on the kernel path, the plain path and the
     plain path in f32 from one state, then forward_deterministic ->
     prune_xvlm_params (for the trained gates and for gates drawn from a
     seed; FFN widths rounded up to multiples of EXPORT_ALIGN) and the
     pruned student's retrieval forward and rerank chunks;
   - general distillation (configs/Pretrain_XVLM_small_4m.yaml: the 6L/6L
     student with local_attn_depth 2, the 12L/12L teacher): three general
     steps at batch 128 (uint8 images of 257 x 257 -> preprocess_train on
     the card -> ITC + ITM + MLM + KD) and three region steps (48 images,
     128 region texts: local attention over 176 rows, + bbox L1 / GIoU) on
     the kernel path, the plain path and the plain path in f32 from one
     init, and one plain pretrain step (no teacher) at chance;
   - the VQA and captioning pruning fine-tunes (configs/x-vlm-small-ft/
     VQA_480.yaml and Captioning.yaml: the 6L/6L student with L0 gates over
     head pairs, VQA's 3-layer answer decoder and VQAL0Module, the 12L/12L
     teacher with a 6-layer decoder, task + KD + Lagrangian, three AdamWs):
     three VQA steps at batch 8 (uint8 512 x 512 -> preprocess_train at 480
     on the card without the flip, 40-token questions, 1-10 answers each
     through vqa_collate) and three caption steps at batch 16 (384 px, 30
     tokens, a 4-token prompt, label smoothing 0.1), each on the kernel,
     plain and f32 plain paths from one state, one stop_prune step (frozen
     deterministic gates: no Lagrangian, loga, λ and their optimizer states
     unchanged), then the decoder-aware export and the pruned student's
     forward_eval (k 128 over 3,128 answers) or 3-beam generate against the
     gated dense student;
   - NLVR2 (configs/x-vlm-small-ft/NLVR.yaml: the 6L / 3 + 2 x 3 replicated
     student under NLVRL0Module, the 12L / 6 + 2 x 6 teacher, task 0.8 + KD
     0.2 + the Lagrangian): three steps at 16 pairs (uint8 448 x 448 ->
     preprocess_train at 384 on the card, image0 then image1, 40 tokens) on
     the kernel, plain and f32 plain paths from one state and a stop_prune
     step; the teacher's, the gated dense student's and the pruned
     student's (prune_xvlm_params(nlvr=True)) logits at 16 pairs, the
     pruned student against the gated dense one for the trained gates and
     for drawn gates that differ within every replicated pair,
     nlvr_accuracy; one XVLMForNLVRPretraining loss at batch 64, 224 px;
   - visual grounding (configs/x-vlm-small-ft/Grounding.yaml, no teacher):
     three steps at batch 16 on the three paths and a stop_prune step, the
     gated student's boxes and grounding_eval_bbox;
   - the host data layer (phase_data), from files it writes under build/
     (a 30,522-entry vocab, COCO-style annotations, 640 x 480 textured JPEGs,
     a pretraining JSONL shard of base64 JPEGs): three retrieval fine-tune
     steps at batch 24 from RetrievalTrainDataset + ImageTransform.train(384)
     + SimpleLoader (the host loaders' images/s at one process, four threads
     and four spawned processes beside the step's samples/s, and a batch's
     host ms by part), the retrieval evaluation over 128 images x 5 captions
     (k_test 128, itm_eval), VQA (16 questions at 480, vqa_accuracy) and
     caption (16 images at 384, 3 beams, coco_caption_eval) evaluation on the
     kernel and plain paths, and one GD general step at batch 128 from the
     shard through GD's DevicePreprocess (crop area 0.2-1, the reference's
     10 RandAugment ops); it prints the JPEG decoder in use;
   with exact launch counts, finite outputs, and the kernel path against the
   plain path (f32 params for retrieval; the same bf16 params for
   generation, with a teacher-forced replay of the generated captions, and
   VQA's ranked answer probabilities over nine input draws, held by their
   medians to the plain bf16 path's own distance from f32 compute; the
   training losses and step-1 gradients held likewise to the plain bf16
   path's distance from the f32 step; the pruned student against the gated
   dense student with the same zs);
4. times: each kernel's time beside its bound, its plain version's and a
   library yardstick's time (CUDA events, median of runs after warm-up),
   the same at the other main-path shapes (for #5 and #6 timed in turns
   with the library call, and after the profiles their device time per call
   from torch.profiler, their host time per call, and the device time of
   the S = 577 split-KV shapes at other keys per split; for #1 and #4 the
   device time, device launches and host time per call), the device kernels
   with their TFLOP/s and share of the bf16 peak, gemm_ln's resident
   clusters (cudaOccupancyMaxActiveClusters), pairs/s, questions/s,
   images/s (and the pruned student's pairs/s), a torch.profiler breakdown;
   the train step's ms split into teacher forward, student forward +
   backward and optimizer, samples/s, peak memory and its profile, and the
   probs forms' times beside their bounds and a library composition that
   also returns the maps; the same for the general and region GD steps
   (with the general step's preprocessing) and the probs forms at the GD
   shapes; the same for the VQA step (with its preprocessing) and the
   caption step and the probs forms at their shapes (#2 at 8 x 901 tokens,
   #3 at the question fusion and the answer decoder), the same for the NLVR
   step (its probs forms at 32 x 577, 16 x 40 and 16 x 40 x 577) and the
   grounding step, NLVR's pairs/s (teacher, gated and pruned student) and
   grounding's images/s, the device and host
   time per call of the probs forms at 40 query tokens or fewer, and the
   probs core alone (CUDA events: its time, the maps' write rate beside the
   card's maps.zero_() of the same buffer), each with the card's name and
   power limit. Every probs launch of the main paths must be served by the
   probs core (bindings.probs_routes).

Weights are random, made from a seed. Any failed check exits non-zero
before the last line, which is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Without a CUDA device it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import json
import math
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


def timed_pair_ms(fa, fb, *, iters: int = 20, runs: int = 7, warmup: int = 3) -> tuple:
    """Medians of alternating runs of fa and fb (each `iters` back-to-back
    calls, CUDA events), so that a drift of the shared host falls on both."""
    import torch

    for _ in range(warmup):
        fa()
        fb()
    torch.cuda.synchronize()
    times = ([], [])
    for _ in range(runs):
        for fn, out in zip((fa, fb), times):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            end.synchronize()
            out.append(start.elapsed_time(end) / iters)
    return statistics.median(times[0]), statistics.median(times[1])


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

    from efficientvlm_tpu_torch.kernels.bindings import gemm_ln_clusters

    path, log, seconds = build()
    library()
    print(f"kernels built in {seconds:.1f} s (0 = reused) -> {os.path.relpath(path)}")
    print(f"gemm_ln resident clusters (cudaOccupancyMaxActiveClusters) at width 768, 6 blocks "
          f"each: {gemm_ln_clusters(768)}, gather form {gemm_ln_clusters(768, gather=True)}; "
          f"{torch.cuda.get_device_properties(0).multi_processor_count} SMs")
    for line in log.splitlines():
        # registers and spills of every kernel, and any performance warning
        # (a wgmma serialised by ptxas, a setmaxnreg ignored)
        if any(w in line for w in ("registers", "spill", "Performance", "warning")) \
                or line.startswith("=="):
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

    from efficientvlm_tpu_torch.ops import attention as A
    from efficientvlm_tpu_torch.ops import flash_attention as FA
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
    # general distillation's batch: 128 images at 224 px (196 patches)
    pp224 = dict(pp, pos_embed={"embedding": pp["pos_embed"]["embedding"][:197]})
    img224 = rnd(128, 224, 224, 3)
    cases.append(("patch_embed", "gd_b128_224",
                  lambda: fused_patch_embed(pp224, img224, patch_size=p),
                  lambda: patch_embed_plain(pp224, img224, patch_size=p),
                  2 * 128 * 196 * k * d,
                  2 * (img224.numel() + k * d + 128 * 197 * d) + 4 * 196 * d, (pp224, img224, p)))
    # the VQA fine-tune's batch: 8 images at 480 px (900 patches), f32 from
    # the on-card preprocessing
    pp480 = dict(pp, pos_embed={"embedding": rnd(901, d, std=0.5)})
    img480 = rnd(8, 480, 480, 3, dtype=torch.float32)
    cases.append(("patch_embed", "vqa_b8_480_f32_in",
                  lambda: fused_patch_embed(pp480, img480, patch_size=p, dtype=torch.bfloat16),
                  lambda: patch_embed_plain(pp480, img480, patch_size=p, dtype=torch.bfloat16),
                  2 * 8 * 900 * k * d,
                  4 * img480.numel() + 2 * (k * d + 8 * 901 * d) + 4 * 900 * d,
                  (pp480, img480, p)))

    def self_case(case, bsz, t, a, heads, r=rnd):
        prm, x = r.attn(d, a), r(bsz, t, d)
        mask, hz = r.mask(bsz, t, t // 4), r.gates(heads)
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
    # general distillation's plain pretrain step: the student ViT without maps
    cases.append(self_case("gd_vit_b128_t197", 128, 197, 768, 12))

    def cross_case(case, bsz, t, s, a, heads, r=rnd):
        prm, x, enc = r.attn(d, a), r(bsz, t, d), r(bsz, s, d)
        mask, hz = r.mask(bsz, s, s // 4), r.gates(heads)
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
        # bf16 LN params and the f32 key bias, as models/bert.py passes them
        ln = {"scale": rnd(d, std=0.1, mean=1.0), "bias": rnd(d, std=0.1)} if with_ln else None
        kb = F._key_bias(bk, s, mask, None, x.device)
        flops = 2 * bk * g * t * d * a * 2 + 2 * bk * s * d * a * 2 + 4 * bk * g * t * s * a
        nbytes = 2 * (2 * x.numel() + enc.numel() + 4 * d * a) + 4 * bk * s
        return ("fused_cross_attention_grouped", case,
                lambda: F.fused_cross_attention_grouped(prm, x, enc, num_heads=heads,
                                                        kv_groups=g, key_bias=kb, head_z=hz,
                                                        ln_params=ln),
                lambda: F.cross_attention_grouped_plain(prm, x, enc, kb, hz, heads, g, ln),
                flops, nbytes, (prm, x, enc, mask, hz, heads, ln))

    cases.append(grouped_case("i2t_g256_ln", 768, 12, True))
    cases.append(grouped_case("i2t_g256_no_ln", 768, 12, False))
    cases.append(grouped_case("rect_a512_h8_ln", 512, 8, True))

    # 5, 6: bare attention cores of the generation path (teacher, 12 heads,
    # dh 64), called as ops/attention.py calls them: q is the projection's
    # [B,T,H,dh] view, unscaled, with scale = dh ** -0.5 applied in the
    # kernel; bytes read each input once, bias in f32
    h, dh = 12, 64

    def heads_view(b, t, hh, d):
        return rnd(b, t, hh * d).view(b, t, hh, d).transpose(1, 2)

    def flash_bias(kind, b, tq, tk, filled, split):
        if kind == "key_vector":  # padding mask with masked tails
            return A.make_attention_bias(rnd.mask(b, tk, max(1, tk // 4)))
        if kind == "key_vector_broadcast":
            return A.make_attention_bias(rnd.mask(1, tk, max(1, tk // 4)))
        if kind == "causal_padding":  # decoder self-attention over padded answers
            return A.causal_bias(tq, tk, device="cuda") + A.make_attention_bias(
                rnd.mask(b, tk, 2))
        if kind == "matrix_broadcast":
            return A.causal_bias(tq, tk, offset=tk - tq, device="cuda")
        if kind == "decode":  # the decode mask over a cache whose first `filled` slots are written
            return A.decode_bias(tk, filled - tq, q_len=tq, device="cuda")
        m = torch.ones(b, tk, dtype=torch.int32, device="cuda")
        if kind == "all_masked_split":  # every key of the first split masked
            m[:, :split] = 0
        elif kind == "last_split_only":  # row 1 sees one key, the last of the ragged last split
            m[1] = 0
            m[1, tk - 1] = 1
        return A.make_attention_bias(m)

    def flash_case(case, b, tq, tk, kind, filled=0, hh=h, d=dh):
        q = heads_view(b, tq, hh, d)
        if kind == "causal_padding":  # uncached decoder self-attention: k/v are views too
            k, v = heads_view(b, tk, hh, d), heads_view(b, tk, hh, d)
        else:
            k, v = rnd(b, hh, tk, d), rnd(b, hh, tk, d)
        bias = flash_bias(kind, b, tq, tk, filled, FA.split_keys(b * hh * -(-tq // 16), tk))
        if kind == "decode":
            k[:, :, filled:] = 0
            v[:, :, filled:] = 0
        scale = d ** -0.5
        flops = 4 * b * hh * tq * tk * d
        nbytes = 2 * (2 * q.numel() + k.numel() + v.numel()) + 4 * bias[:, 0].numel()
        return ("flash_attention", case,
                lambda: FA.flash_attention(q, k, v, bias=bias, scale=scale),
                lambda: FA.flash_attention_plain(q, k, v, bias, scale), flops, nbytes,
                (q, k, v, bias, scale))

    cases.append(flash_case("vqa_score_self_b2048_tq6", 2048, 6, 6, "causal_padding"))
    cases.append(flash_case("vqa_first_cross_b16_tq1_s25", 16, 1, 25, "key_vector"))
    cases.append(flash_case("caption_step_self_b48_l20", 48, 1, 20, "decode", filled=10))
    cases.append(flash_case("greedy_step_self_b16_l20", 16, 1, 20, "decode", filled=10))
    cases.append(flash_case("caption_prefill_self_b48_tq4_l20", 48, 4, 20, "decode", filled=4))
    cases.append(flash_case("greedy_prefill_self_b16_tq4_l20", 16, 4, 20, "decode", filled=4))
    cases.append(flash_case("vqa_first_self_b16_tq1_tk1", 16, 1, 1, "decode", filled=1))
    cases.append(flash_case("greedy_step_cross_b16_s577", 16, 1, 577, "key_vector"))
    cases.append(flash_case("greedy_prefill_cross_b16_tq4_s577", 16, 4, 577, "key_vector"))
    # edge cases, checked and not timed: a ragged last split, a split whose
    # keys are all masked, a row whose only key is in the last split, (b, h)
    # counts that no block size divides, batch-broadcast biases, dh 32 / 128
    cases.append(flash_case("edge_split_ragged_dh128", 2, 1, 145, "key_vector", hh=3, d=128))
    cases.append(flash_case("edge_all_masked_split", 2, 1, 577, "all_masked_split"))
    cases.append(flash_case("edge_last_split_only", 2, 1, 577, "last_split_only", hh=2))
    cases.append(flash_case("edge_9_pairs_vector_broadcast", 3, 1, 25, "key_vector_broadcast",
                            hh=3))
    cases.append(flash_case("edge_15_pairs_matrix_broadcast_dh32", 5, 6, 6, "matrix_broadcast",
                            hh=3, d=32))

    def grouped_flash_case(case, bk, g, tq, s, d=dh, broadcast=False):
        q, k, v = heads_view(bk * g, tq, h, d), rnd(bk, h, s, d), rnd(bk, h, s, d)
        bias = A.make_attention_bias(rnd.mask(1 if broadcast else bk, s, s // 4))
        scale = d ** -0.5
        flops = 4 * bk * g * h * tq * s * d
        nbytes = 2 * (2 * q.numel() + k.numel() + v.numel()) + 4 * bias.numel()
        return ("flash_attention_grouped", case,
                lambda: FA.flash_attention_grouped(q, k, v, kv_groups=g, bias=bias, scale=scale),
                lambda: FA.flash_attention_grouped_plain(q, k, v, g, bias, scale), flops, nbytes,
                (q, k, v, bias, g, scale))

    cases.append(grouped_flash_case("vqa_score_cross_bk16_g128_tq6_s25", 16, 128, 6, 25))
    cases.append(grouped_flash_case("caption_step_cross_bk16_g3_tq1_s577", 16, 3, 1, 577))
    cases.append(grouped_flash_case("caption_prefill_cross_bk16_g3_tq4_s577", 16, 3, 4, 577))
    cases.append(grouped_flash_case("edge_g3_split_dh32_broadcast", 3, 3, 1, 577, d=32,
                                    broadcast=True))
    cases.append(grouped_flash_case("edge_g128_dh128", 2, 128, 6, 25, d=128))

    # NLVR2 and grounding (drawn from their own generator, so the draws above
    # stay as they were): #1 over NLVR's 2 x 16 images from the on-card
    # preprocessing (f32 in) and its pretraining batch of 64 at 224 px; #2
    # over the text stacks ([16, 40], grounding's [16, 30]); #3 over one
    # image of each pair ([16, 40] x 577, grounding's [16, 30] x 577); the
    # pretraining loss's #2 (ViT [64, 197], text [64, 40]) and #3 ([64, 40]
    # x 197)
    r = Rand(7)
    img_nlvr = r(2 * 16, res, res, 3, dtype=torch.float32)
    cases.append(("patch_embed", "nlvr_b32_384_f32_in",
                  lambda: fused_patch_embed(pp, img_nlvr, patch_size=p, dtype=torch.bfloat16),
                  lambda: patch_embed_plain(pp, img_nlvr, patch_size=p, dtype=torch.bfloat16),
                  2 * 32 * n * k * d, 4 * img_nlvr.numel() + 2 * (k * d + 32 * (n + 1) * d)
                  + 4 * n * d, (pp, img_nlvr, p)))
    img_pre = r(64, 224, 224, 3)
    cases.append(("patch_embed", "nlvr_pretrain_b64_224",
                  lambda: fused_patch_embed(pp224, img_pre, patch_size=p),
                  lambda: patch_embed_plain(pp224, img_pre, patch_size=p),
                  2 * 64 * 196 * k * d,
                  2 * (img_pre.numel() + k * d + 64 * 197 * d) + 4 * 196 * d,
                  (pp224, img_pre, p)))
    cases.append(self_case("nlvr_text_b16_t40", 16, 40, 768, 12, r))
    cases.append(self_case("grounding_text_b16_t30", 16, 30, 768, 12, r))
    cases.append(cross_case("nlvr_cross_b16_tq40_s577", 16, 40, 577, 768, 12, r))
    cases.append(cross_case("grounding_cross_b16_tq30_s577", 16, 30, 577, 768, 12, r))
    cases.append(self_case("nlvr_pretrain_vit_b64_t197", 64, 197, 768, 12, r))
    cases.append(self_case("nlvr_pretrain_text_b64_t40", 64, 40, 768, 12, r))
    cases.append(cross_case("nlvr_pretrain_cross_b64_tq40_s197", 64, 40, 197, 768, 12, r))
    return cases


def device_kernel_cases(rnd):
    """The device kernels under #1-#4 on their own, through their bare
    bindings, as (name, case, kernel call, plain call, flops, bytes, library
    call): gemm_bias at the ViT's fused Q/K/V shape; gemm_ln at #4's output
    projection with the residual and post-LN (the i2t rerank chunk's 10,240
    query rows per image); attn_core and attn_wgmma at the i2t rerank's
    folded rows, the ViT's self-attention and the fusion layers'
    cross-attention shapes (attn_wgmma's plain twin is attn_core_plain: the
    same function)."""
    import torch
    import torch.nn.functional as Fn

    from efficientvlm_tpu_torch.kernels import bindings as K
    from efficientvlm_tpu_torch.ops import fused_mha as F

    m, d = 32 * 577, 768
    x, w = rnd(m, d), rnd(d, 3 * d, std=d ** -0.5)
    bias = rnd(3 * d, std=0.1, dtype=torch.float32)
    bias16 = bias.to(torch.bfloat16)
    cases = [("gemm_bias", "vit_qkv_m18464_n2304_k768", lambda: K.gemm_bias(x, w, bias),
              lambda: F.gemm_bias_plain(x, w, bias), 2 * m * d * 3 * d,
              2 * (x.numel() + w.numel() + m * 3 * d) + 4 * 3 * d,
              lambda: torch.addmm(bias16, x, w))]

    m4 = 4 * 256 * 40  # #4's output projection over the i2t chunk's rows
    ctx, wo, res = rnd(m4, d), rnd(d, d, std=d ** -0.5), rnd(m4, d)
    bo, g, bt = rnd(d, std=0.1), rnd(d, std=0.1, mean=1.0), rnd(d, std=0.1)
    # the route gemm_ln replaces: gemm_bias into f32 (then residual_layernorm)
    cases.append(("gemm_bias", "i2t_out_f32_m40960_n768_k768",
                  lambda: K.gemm_bias(ctx, wo, bo, out_f32=True),
                  lambda: F.gemm_bias_plain(ctx, wo, bo, out_f32=True), 2 * m4 * d * d,
                  2 * (ctx.numel() + wo.numel() + d) + 4 * m4 * d,
                  lambda: torch.addmm(bo, ctx, wo)))
    cases.append(("gemm_ln", "i2t_out_ln_m40960_n768_k768",
                  lambda: K.gemm_ln(ctx, wo, g, bt, 1e-12, bias=bo, residual=res),
                  lambda: F.gemm_ln_plain(ctx, wo, g, bt, 1e-12, bias=bo, residual=res),
                  2 * m4 * d * d, 2 * (ctx.numel() + wo.numel() + 2 * res.numel() + 3 * d),
                  lambda: Fn.layer_norm(torch.addmm(bo, ctx, wo) + res, (d,), g, bt, 1e-12)))

    def attn_case(case, b, tq, s, h, dh):
        a = h * dh
        q, k, v = rnd(b * tq, a), rnd(b * s, a), rnd(b * s, a)
        kb = F._key_bias(b, s, rnd.mask(b, s, s // 4), None, q.device)
        hz = rnd.gates(h)
        split = lambda t, n: t.view(b, n, h, dh).transpose(1, 2)
        mask = kb.to(torch.bfloat16)[:, None, None, :]
        return ("attn_core", case, lambda: K.attn_core(q, k, v, kb, hz, batch=b, tq=tq, s=s),
                lambda: F.attn_core_plain(q, k, v, kb, hz, batch=b, tq=tq, s=s),
                4 * b * tq * s * a, 2 * (2 * q.numel() + k.numel() + v.numel()) + 4 * b * s,
                lambda: Fn.scaled_dot_product_attention(split(q, tq), split(k, s), split(v, s),
                                                        attn_mask=mask))

    def wgmma_case(case, b, tq, s, h):
        a = h * 64
        q, k, v = rnd(b * tq, a), rnd(b * s, a), rnd(b * s, a)
        mask = rnd.mask(b, s, s // 4)
        kb, hz = F._key_bias(b, s, mask, None, q.device), rnd.gates(h)
        split = lambda t, n: t.view(b, n, h, 64).transpose(1, 2)
        bias16 = kb.to(torch.bfloat16)[:, None, None, :]
        return ("attn_wgmma", case,
                lambda: K.attn_wgmma(q, k, v, kb, hz, batch=b, tq=tq, s=s),
                lambda: F.attn_core_plain(q, k, v, kb, hz, batch=b, tq=tq, s=s),
                4 * b * tq * s * a, 2 * (2 * q.numel() + k.numel() + v.numel()) + 4 * b * s,
                lambda: Fn.scaled_dot_product_attention(split(q, tq), split(k, s), split(v, s),
                                                        attn_mask=bias16))

    cases.append(attn_case("i2t_rerank_b4_tq10240_s577_h12", 4, 10240, 577, 12, 64))
    cases.append(wgmma_case("i2t_rerank_b4_tq10240_s577_h12", 4, 10240, 577, 12))
    cases.append(attn_case("vit_b32_t577_h12", 32, 577, 577, 12, 64))
    cases.append(wgmma_case("vit_b32_t577_h12", 32, 577, 577, 12))
    cases.append(attn_case("fusion_b32_tq40_s577_h12", 32, 40, 577, 12, 64))
    cases.append(wgmma_case("fusion_b32_tq40_s577_h12", 32, 40, 577, 12))
    return cases


def flash_refusals(rnd):
    """The bare cores raise on operands their kernel cannot read in place: a
    misaligned q, a row stride that is no multiple of 8, a wrong head dim."""
    from efficientvlm_tpu_torch.ops import flash_attention as FA

    k = rnd(2, 2, 9, 64)
    bad = {"misaligned q": rnd(2 * 2 * 3 * 64 + 1)[1:].view(2, 2, 3, 64),
           "q row stride 132": rnd(2, 3, 132)[..., :128].view(2, 3, 2, 64).transpose(1, 2)}
    for what, q in bad.items():
        try:
            FA.flash_attention(q, k, k)
        except ValueError:
            continue
        fail(f"flash_attention accepted a {what}")
    try:
        FA.flash_attention(rnd(2, 2, 3, 64), rnd(2, 2, 9, 32), rnd(2, 2, 9, 32))
    except ValueError:
        print("kernel flash_attention: misaligned, badly strided and wrongly shaped operands "
              "raise")
        return
    fail("flash_attention accepted a k of another head dim")


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
    """name -> (wrapper, its count attribute); the probs forms of #2 / #3
    are counted apart from their plain forms."""
    from efficientvlm_tpu_torch.ops import flash_attention as FA
    from efficientvlm_tpu_torch.ops import fused_mha as F
    from efficientvlm_tpu_torch.ops.patch_embed import fused_patch_embed

    return {"patch_embed": (fused_patch_embed, "launches"),
            "fused_self_attention": (F.fused_self_attention, "launches"),
            "fused_cross_attention": (F.fused_cross_attention, "launches"),
            "fused_cross_attention_grouped": (F.fused_cross_attention_grouped, "launches"),
            "flash_attention": (FA.flash_attention, "launches"),
            "flash_attention_grouped": (FA.flash_attention_grouped, "launches"),
            "fused_self_attention_probs": (F.fused_self_attention, "probs_launches"),
            "fused_cross_attention_probs": (F.fused_cross_attention, "probs_launches")}


ROUTES = ("attn_probs", "attn_core")  # bindings.probs_routes: the core of each probs call


def counts() -> dict:
    """The wrappers' launch counts, then the probs forms' calls by the core
    that served them (`route_attn_probs`: the probs core attn_probs;
    `route_attn_core`: attn_core's two-sweep form)."""
    from efficientvlm_tpu_torch.kernels import bindings

    return {**{k: getattr(w, attr) for k, (w, attr) in wrappers().items()},
            **{f"route_{r}": bindings.probs_routes[r] for r in ROUTES}}


def reset_counts() -> dict:
    """Every launch count to 0: a main path's run starts here."""
    from efficientvlm_tpu_torch.kernels import bindings

    for w, attr in wrappers().values():
        setattr(w, attr, 0)
    for r in ROUTES:
        bindings.probs_routes[r] = 0
    return counts()


def expect_launches(before: dict, expected: tuple, what: str):
    """The launches since `before`, in wrappers() order; names past the end
    of `expected` must not have launched. Every probs launch of the main
    path's shapes (head dim 64) is served by the probs core."""
    now = counts()
    names = list(wrappers())
    expected = tuple(expected) + (0,) * (len(names) - len(expected))
    delta = {k: now[k] - before[k] for k in now}
    print(f"launches {what}: {delta}")
    check(tuple(delta[k] for k in names) == expected,
          f"{what}: launches {tuple(delta[k] for k in names)} != expected {expected}")
    probs = delta["fused_self_attention_probs"] + delta["fused_cross_attention_probs"]
    check(delta["route_attn_probs"] == probs and delta["route_attn_core"] == 0,
          f"{what}: {probs} probs launches, the probs core served {delta['route_attn_probs']}")
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

    c = reset_counts()
    with torch.inference_mode():
        out = R.retrieval_forward(teacher, t_bf16, image, ids, atts, dtype=bf16)
        c = expect_launches(c, (1, 24, 6, 0, 0, 0), "teacher forward")
        for x, shape in zip(out, [(32, 256), (32, 256), (32, 2)]):
            check(tuple(x.shape) == shape and bool(torch.isfinite(x.float()).all()),
                  f"teacher forward output {tuple(x.shape)} not finite / not {shape}")
        norms = torch.linalg.vector_norm(out[0].float(), dim=-1)
        check(bool(((norms - 1).abs() < 1e-2).all()), "image features are not unit vectors")
        out = R.retrieval_forward(student, s_bf16, image, ids, atts, dtype=bf16)
        c = expect_launches(c, (1, 12, 3, 0, 0, 0), "student forward")
        check(all(bool(torch.isfinite(x.float()).all()) for x in out), "student not finite")
        i2t = R.itm_rerank_scores(teacher, t_bf16, ib, txt, txt_atts, rows, k, dtype=bf16)
        c = expect_launches(c, (0, 6, 0, 6, 0, 0), "i2t rerank chunk")
        t2i = R.itm_rerank_scores(teacher, t_bf16, ib_expanded, txt, txt_atts, rows, k,
                                  dtype=bf16)
        c = expect_launches(c, (0, 6, 6, 0, 0, 0), "t2i rerank chunk")
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
    c = expect_launches(c, (0, 6 * (chunks_i2t + chunks_t2i), 6 * chunks_t2i, 6 * chunks_i2t,
                            0, 0), "retrieval_scores")
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


VQA_UNIT = dict(batch=16, res=480, q_len=25, answers=3128, answer_len=6, k=128)
CAPTION_UNIT = dict(batch=16, res=384, beams=3, max_length=20, min_length=5,
                    prompt=[101, 1037, 3861, 1997], eos_id=102, pad_id=0)


def build_generation(kind: str, layers: int):
    """VQA or captioning model at the full X-VLM base width, `layers` deep
    (fusion at half; the VQA answer decoder has layers - fusion layers),
    params from seed 0 stored in bf16."""
    import torch

    from efficientvlm_tpu_torch.bridge import cast_floating
    from efficientvlm_tpu_torch.config import Config, TextConfig, VisionConfig
    from efficientvlm_tpu_torch.models.model_generation import XVLMForCaptioning, XVLMForVQA

    res = VQA_UNIT["res"] if kind == "vqa" else CAPTION_UNIT["res"]
    vcfg = VisionConfig.create(num_hidden_layers=layers, image_res=res)
    tcfg = TextConfig.create(num_hidden_layers=layers, fusion_layer=layers // 2,
                             encoder_width=768, hidden_dropout_prob=0.0,
                             attention_probs_dropout_prob=0.0)
    model = (XVLMForVQA(vcfg, tcfg, Config({"pad_token_id": 0})) if kind == "vqa"
             else XVLMForCaptioning(vcfg, tcfg, Config({})))
    return model, cast_floating(model.init(0, device="cuda"), torch.bfloat16)


def vqa_first_logits(model, params, states, atts, answer_ids, impl):
    """rank_answer's first decoder call: the start token over the question
    states, one row per question, through precomputed cross K/V."""
    import torch

    from efficientvlm_tpu_torch.models import bert as B

    dec, cfg = params["text_decoder"], model.decoder_cfg
    kv = B.precompute_cross_kv(dec, cfg, states, dtype=torch.bfloat16)
    out = B.bert_apply(dec, answer_ids[:1, :1].expand(states.shape[0], 1), cfg,
                       encoder_hidden=states, encoder_attention_mask=atts, mode="multi_modal",
                       is_decoder=True, cross_kv=kv, dtype=torch.bfloat16, impl=impl)
    return B.mlm_head_apply(dec["cls"], out["last_hidden"], cfg, dtype=torch.bfloat16)[:, 0]


def caption_replay_logits(model, params, image, tokens, prompt_len, impl):
    """Teacher-forced logits [B, L, V] of `tokens` [B, L]: impl="fused" runs
    the cached decoder (the prompt prefill, then one token per step, as
    generate does); impl="plain" runs the plain decoder without a cache."""
    import torch

    from efficientvlm_tpu_torch.generation import make_bert_decode_fn
    from efficientvlm_tpu_torch.models import bert as B

    bf16 = torch.bfloat16
    dec, cfg = params["text_decoder"], model.text_cfg
    embeds, atts, _ = model.encode_image(params, image, dtype=bf16, impl=impl)
    if impl == "plain":
        out = B.bert_apply(dec, tokens, cfg, encoder_hidden=embeds, encoder_attention_mask=atts,
                           mode="multi_modal", is_decoder=True, dtype=bf16, impl="plain")
        return B.mlm_head_apply(dec["cls"], out["last_hidden"], cfg, dtype=bf16)
    decode_fn = make_bert_decode_fn(dec, cfg, encoder_hidden=embeds, encoder_atts=atts,
                                    dtype=bf16, impl=impl)
    cache = B.init_bert_cache(dec, cfg, tokens.shape[0], tokens.shape[1], dtype=bf16)
    logits, cache = decode_fn(tokens[:, :prompt_len], cache, 0)
    steps = [logits]
    for pos in range(prompt_len, tokens.shape[1]):
        logits, cache = decode_fn(tokens[:, pos:pos + 1], cache, pos)
        steps.append(logits)
    return torch.cat(steps, 1)


def vqa_inputs(r):
    """forward_eval's inputs at VQA_UNIT (image, question ids and mask,
    answer ids and mask), drawn from the Rand `r`."""
    import torch

    u, b = VQA_UNIT, VQA_UNIT["batch"]
    return (r(b, u["res"], u["res"], 3),
            torch.randint(0, 30522, (b, u["q_len"]), generator=r.g, device="cuda"),
            torch.ones(b, u["q_len"], dtype=torch.int32, device="cuda"),
            torch.randint(0, 30522, (u["answers"], u["answer_len"]), generator=r.g,
                          device="cuda"),
            torch.ones(u["answers"], u["answer_len"], dtype=torch.int32, device="cuda"))


@contextlib.contextmanager
def plain_cores():
    """The fused path with #5 and #6 on their plain twins and the rest of it
    unchanged, to tell which part of the path a difference comes from."""
    from efficientvlm_tpu_torch.ops import attention as A
    from efficientvlm_tpu_torch.ops import flash_attention as FA

    saved = A.flash_attention, A.flash_attention_grouped
    A.flash_attention = lambda q, k, v, *, bias=None, scale=1.0: FA._bthd(
        FA.flash_attention_plain(q, k, v, bias, scale))
    A.flash_attention_grouped = lambda q, k, v, *, kv_groups, bias=None, scale=1.0: FA._bthd(
        FA.flash_attention_grouped_plain(q, k, v, kv_groups, bias, scale))
    try:
        yield
    finally:
        A.flash_attention, A.flash_attention_grouped = saved


# the VQA kernel-vs-plain check: input draws beside the main one, and the
# bound on its medians in units of the plain bf16 path's distance from f32
# compute (over the 9 draws on the H100 the ratio of the kernel path's
# distance from f32 to the plain path's ranged 0.34-2.02 per draw, with a
# median of 1.00; the ratio of the two medians was 0.82)
VQA_SEEDS = (10, 11, 12, 13, 14, 15, 16, 17)
VQA_MEDIAN_FACTOR = 1.5


def vqa_agreement(model, params, params32, vqa_in, draw: str) -> dict:
    """forward_eval's topk_probs four ways on one input: the kernel path,
    the fused path with #5/#6 on their plain twins (plain_cores), the plain
    path, all in bf16, and the plain path in f32 compute on the same params
    upcast (exact). Prints their max abs differences and top-1 agreement."""
    import torch

    bf16, k = torch.bfloat16, VQA_UNIT["k"]
    with torch.inference_mode():
        ids_k, p_k = model.forward_eval(params, *vqa_in, k=k, dtype=bf16)
        with plain_cores():
            ids_t, p_t = model.forward_eval(params, *vqa_in, k=k, dtype=bf16)
        ids_p, p_p = model.forward_eval(params, *vqa_in, k=k, dtype=bf16, impl="plain")
        ids_32, p_32 = model.forward_eval(params32, vqa_in[0].float(), *vqa_in[1:], k=k,
                                          dtype=torch.float32, impl="plain")

    def err(a, b):
        return (a.float() - b.float()).abs().max().item()

    def top1(a, b):
        return (a[:, 0] == b[:, 0]).float().mean().item()

    out = {"kernel_vs_plain": err(p_k, p_p), "twins_vs_plain": err(p_t, p_p),
           "kernel_vs_f32": err(p_k, p_32), "plain_vs_f32": err(p_p, p_32),
           "max_prob": p_p.float().max().item(), "top1_kernel_plain": top1(ids_k, ids_p),
           "top1_kernel_f32": top1(ids_k, ids_32), "top1_plain_f32": top1(ids_p, ids_32)}
    print(f"vqa topk_probs [{draw}]: " + ", ".join(f"{a} {b:.4e}" for a, b in out.items()))
    return out


def phase_generation(rnd):
    """The generation path: VQA answer ranking and captioning, teacher and
    student, with exact launch counts; then the kernel path against the
    plain path on the same bf16 params."""
    import torch

    from efficientvlm_tpu_torch.bridge import cast_floating

    bf16 = torch.bfloat16
    u, c_u = VQA_UNIT, CAPTION_UNIT
    models = {(kind, which): build_generation(kind, layers)
              for kind in ("vqa", "caption") for which, layers in (("teacher", 12),
                                                                    ("student", 6))}
    b = u["batch"]
    vqa_in = vqa_inputs(rnd)
    image = rnd(c_u["batch"], c_u["res"], c_u["res"], 3)
    prompt = torch.tensor([c_u["prompt"]] * c_u["batch"], device="cuda")
    gen_kw = dict(max_length=c_u["max_length"], min_length=c_u["min_length"],
                  eos_id=c_u["eos_id"], pad_id=c_u["pad_id"], dtype=bf16)

    def check_vqa(ids, probs, what):
        check(tuple(ids.shape) == (b, u["k"]) and bool(((ids >= 0) & (ids < u["answers"])).all()),
              f"{what}: answer ids {tuple(ids.shape)} out of range")
        p = probs.float()
        check(bool(torch.isfinite(p).all()) and bool((p.sum(1) <= 1 + 1e-3).all())
              and bool((p[:, 1:] <= p[:, :-1]).all()), f"{what}: probs not a sorted distribution")

    def check_caption(tokens, what):
        check(tuple(tokens.shape) == (c_u["batch"], c_u["max_length"])
              and bool(((tokens >= 0) & (tokens < 30522)).all())
              and bool((tokens[:, :len(c_u["prompt"])] == prompt).all()),
              f"{what}: tokens {tuple(tokens.shape)} out of range or prompt lost")

    c = reset_counts()  # the generation path's run starts here
    outs = {}
    with torch.inference_mode():
        for which, (dec_layers, lv) in (("teacher", (6, 12)), ("student", (3, 6))):
            model, params = models[("vqa", which)]
            ids, probs = model.forward_eval(params, *vqa_in, k=u["k"], dtype=bf16)
            check_vqa(ids, probs, f"vqa {which}")
            # ViT + question self (#2), question fusion (#3); the decoder's self and
            # cross in the first call plus self in the scoring call (#6), its
            # grouped cross in the scoring call (#5)
            c = expect_launches(c, (1, 2 * lv, lv // 2, 0, 3 * dec_layers, dec_layers),
                                f"vqa forward_eval {which}")
            outs[("vqa", which)] = ids
            model, params = models[("caption", which)]
            for beams in (c_u["beams"], 1):
                stats = {}
                tokens = model.generate(params, image, prompt, num_beams=beams, stats=stats,
                                        **gen_kw)
                check_caption(tokens, f"caption {which} beams={beams}")
                n = stats["decoder_calls"]
                check(2 <= n <= c_u["max_length"] - len(c_u["prompt"]) + 1,
                      f"caption: {n} decoder calls")
                # per decoder call: cached self in every layer (#6), cross over the
                # shared image K/V (#5 with beams, #6 greedy)
                per_call = ((lv, lv // 2) if beams > 1 else (lv + lv // 2, 0))
                c = expect_launches(c, (1, lv, 0, 0, per_call[0] * n, per_call[1] * n),
                                    f"caption generate {which} beams={beams} ({n} decoder calls)")
                outs[("caption", which, beams)] = tokens
    launches = counts()

    # kernel path against the plain path, the same bf16 params
    model, params = models[("vqa", "teacher")]
    image480, q_ids, q_atts, a_ids, a_atts = vqa_in
    with torch.inference_mode():
        lk, lp = (vqa_first_logits(model, params, model.encode_question(
            params, image480, q_ids, q_atts, dtype=bf16, impl=impl)[0]["last_hidden"],
            q_atts, a_ids, impl).float() for impl in ("fused", "plain"))
    err, tol = (lk - lp).abs().max().item(), 0.05 * lp.abs().max().item()
    print(f"vqa kernel path vs plain path, first-call logits: max_abs_err {err:.4e} tol {tol:.4e}")
    check(err <= tol, "vqa first-call logits: kernel path and plain path disagree")
    # topk_probs: near-tied answers reorder under any bf16 rounding, so a
    # single input's max difference says little (on some draws the plain
    # twins of #5/#6 inside the fused path differ from the plain path as
    # much as the kernels do). The yardstick is the plain bf16 path's own
    # distance from f32 compute, and both checks take medians over draws.
    params32 = cast_floating(params, torch.float32)
    runs = [vqa_agreement(model, params, params32, inputs, draw)
            for draw, inputs in [("main", vqa_in)] + [(f"seed {s}", vqa_inputs(Rand(s)))
                                                      for s in VQA_SEEDS]]
    del params32
    med = {key: statistics.median(r[key] for r in runs) for key in runs[0]}
    tol = VQA_MEDIAN_FACTOR * med["plain_vs_f32"]
    print(f"vqa topk_probs over {len(runs)} draws, medians: kernel vs f32 "
          f"{med['kernel_vs_f32']:.4e}, kernel vs plain {med['kernel_vs_plain']:.4e}, plain #5/#6 "
          f"twins vs plain {med['twins_vs_plain']:.4e}; tol {tol:.4e} = {VQA_MEDIAN_FACTOR} x "
          f"plain bf16 vs f32 {med['plain_vs_f32']:.4e}")
    check(med["kernel_vs_f32"] <= tol, "vqa topk_probs: the kernel path is further from f32 "
                                       "compute than the plain bf16 path")
    check(med["kernel_vs_plain"] <= tol, "vqa topk_probs: kernel path and plain path disagree")

    model, params = models[("caption", "teacher")]
    for beams in (c_u["beams"], 1):
        tokens = outs[("caption", "teacher", beams)]
        with torch.inference_mode():
            kern = caption_replay_logits(model, params, image, tokens, len(c_u["prompt"]),
                                         "fused").float()
            plain = caption_replay_logits(model, params, image, tokens, len(c_u["prompt"]),
                                          "plain").float()
            plain_tokens = model.generate(params, image, prompt, num_beams=beams, impl="plain",
                                          **gen_kw)
        err, tol = (kern - plain).abs().max().item(), 0.05 * plain.abs().max().item()
        same = (plain_tokens == tokens).all(1).float().mean().item()
        print(f"caption beams={beams} teacher-forced replay, cached kernel decoder vs plain "
              f"uncached decoder over all {tokens.shape[1]} positions: max_abs_err {err:.4e} "
              f"tol {tol:.4e}; identical captions kernel vs plain path: {same:.3f}")
        check(err <= tol, f"caption beams={beams}: replayed logits disagree")
    return {"models": models, "vqa_in": vqa_in, "image": image, "prompt": prompt,
            "gen_kw": gen_kw, "launches": launches}


# --------------------------------------------------------------------------
# phase 2b: the training forms of #1-#3 against their plain versions
# --------------------------------------------------------------------------


def probs_yardstick(prm, x, enc, mask, hz, h):
    """One eager PyTorch composition that also returns the maps, as a model
    run with output_attentions does: addmm projections, bmm, softmax in
    f32, bmm, addmm (scaled_dot_product_attention returns no maps). Timed
    only."""
    import torch

    b, t, d = x.shape
    s, a = enc.shape[1], prm["q"]["kernel"].shape[1]
    dh = a // h
    bias = ((1.0 - mask.float()) * -1e9)[:, None, None, :]

    def proj(y, p):
        return torch.addmm(p["bias"], y.reshape(-1, y.shape[-1]), p["kernel"])

    def heads(y, n):
        return y.view(b, n, h, dh).transpose(1, 2).reshape(b * h, n, dh)

    def run():
        q, k, v = heads(proj(x, prm["q"]), t), heads(proj(enc, prm["k"]), s), heads(
            proj(enc, prm["v"]), s)
        probs = torch.softmax(torch.bmm(q, k.transpose(1, 2)).view(b, h, t, s).float()
                              * dh ** -0.5 + bias, dim=-1)
        ctx = torch.bmm(probs.to(x.dtype).view(b * h, t, s), v).view(b, h, t, dh)
        ctx = (ctx * hz.to(ctx.dtype)[None, :, None, None]).transpose(1, 2).reshape(b * t, a)
        return proj(ctx, prm["out"]), probs
    return run


def region_mask(rnd, b: int, s: int, sizes=(1, 8), full=None) -> tuple:
    """(key masks [b, s] int32 of a region batch's local layers, boxes [b, 4]
    (cx, cy, w, h) on the 0..1 scale): every row keeps the CLS key and a box
    of sizes[0]-sizes[1] x sizes[0]-sizes[1] patches of the square patch
    grid; the rows where `full` (bool [b]; default rows 0, 3, 6, ...) keep
    all keys (the full images, box (0.5, 0.5, 1, 1))."""
    import torch

    g = int(round((s - 1) ** 0.5))
    if full is None:
        full = torch.arange(b, device="cuda") % 3 == 0
    wh = torch.randint(sizes[0], sizes[1] + 1, (b, 2), generator=rnd.g, device="cuda")
    wh = torch.where(full[:, None], g, wh)
    x0 = (torch.rand(b, generator=rnd.g, device="cuda") * (g - wh[:, 0] + 1)).long()
    y0 = (torch.rand(b, generator=rnd.g, device="cuda") * (g - wh[:, 1] + 1)).long()
    ar = torch.arange(g, device="cuda")
    rows = (ar >= y0[:, None]) & (ar < (y0 + wh[:, 1])[:, None])
    cols = (ar >= x0[:, None]) & (ar < (x0 + wh[:, 0])[:, None])
    inside = rows[:, :, None] & cols[:, None, :]
    m = torch.cat([torch.ones(b, 1, dtype=torch.bool, device="cuda"), inside.reshape(b, -1)], 1)
    box = torch.stack([(x0 + wh[:, 0] / 2) / g, (y0 + wh[:, 1] / 2) / g, wh[:, 0] / g,
                       wh[:, 1] / g], 1).float()
    return m.to(torch.int32), box


def probs_case(rnd, kind, name, b, t, s, heads, min_len=None, mask=None):
    """(name, case, kernel call, plain call -> (out, probs), flops, bytes,
    mask, library call) of #2 (kind "self") or #3 with return_probs, masked
    key tails (or `mask`). Bytes: hidden in and out, the weights, the key
    bias and the f32 maps."""
    from efficientvlm_tpu_torch.ops import fused_mha as F

    d, a = 768, 64 * heads
    prm, x, enc = rnd.attn(d, a), rnd(b, t, d), rnd(b, s, d)
    mask = rnd.mask(b, s, min_len) if mask is None else mask
    hz = rnd.gates(heads)
    kb = F._key_bias(b, s, mask, None, x.device)
    flops = 2 * b * t * d * a * 2 + 2 * b * s * d * a * 2 + 4 * b * t * s * a
    nbytes = 2 * (2 * x.numel() + 4 * d * a) + 4 * b * s + 4 * b * heads * t * s
    if kind == "self":
        enc = x
        run = lambda: F.fused_self_attention(prm, x, num_heads=heads, mask=mask,  # noqa: E731
                                             head_z=hz, return_probs=True)
        plain = lambda: F.self_attention_plain(prm, x, kb, hz, heads,  # noqa: E731
                                               return_probs=True)
    else:
        nbytes += 2 * enc.numel()
        run = lambda: F.fused_cross_attention(prm, x, enc, num_heads=heads, mask=mask,  # noqa
                                              head_z=hz, return_probs=True)
        plain = lambda: F.cross_attention_plain(prm, x, enc, kb, hz, heads,  # noqa: E731
                                                return_probs=True)
    return (f"fused_{kind}_attention_probs", name, run, plain, flops, nbytes, mask,
            probs_yardstick(prm, x, enc, mask, hz, heads))


def probs_cases(rnd):
    """The probs forms of #2 at the ViT shape of the retrieval training batch
    (B 24, 577 tokens) and the text / fusion self shape (B 48, 40 tokens),
    of #3 at the fusion cross shape (B 48 x 40 x 577), with masked key
    tails, and at the pruned widths the export gives (head pairs: 2-12
    heads, A 128-768). The first case of each name is timed."""
    cases = [probs_case(rnd, "self", "vit_b24_t577_h12", 24, 577, 577, 12, 577 // 4),
             probs_case(rnd, "self", "text_fusion_b48_t40_h12", 48, 40, 40, 12, 8)]
    for heads in (2, 8):  # A 128, 512 at the ViT shape
        cases.append(probs_case(rnd, "self", f"vit_b24_t577_h{heads}", 24, 577, 577, heads,
                                577 // 4))
    for heads in (4, 6, 10):
        cases.append(probs_case(rnd, "self", f"text_fusion_b48_t40_h{heads}", 48, 40, 40, heads,
                                8))
    cases.append(probs_case(rnd, "cross", "fusion_b48_tq40_s577_h12", 48, 40, 577, 12, 577 // 4))
    for heads in (2, 8):
        cases.append(probs_case(rnd, "cross", f"fusion_b48_tq40_s577_h{heads}", 48, 40, 577,
                                heads, 577 // 4))
    return cases


def gd_probs_cases(rnd):
    """The probs forms at general distillation's shapes (224 px: 197 tokens,
    the maps' rows padded to 200 floats): #2 over the ViT batch of 128, over
    the 176 rows of a region batch's local layers with their key masks, and
    the 40-token text tower at 128 and the ITM-negative fusion pass at 256;
    #3 at the ITM-negative fusion pass (256 x 40 x 197, region masks on the
    image keys) and at the bbox / MLM pass (128 x 40 x 197)."""
    return [probs_case(rnd, "self", "gd_vit_b128_t197_h12", 128, 197, 197, 12, 197 // 4),
            probs_case(rnd, "self", "gd_region_local_b176_t197_h12", 176, 197, 197, 12,
                       mask=region_mask(rnd, 176, 197)[0]),
            probs_case(rnd, "self", "gd_text_b128_t40_h12", 128, 40, 40, 12, 8),
            probs_case(rnd, "self", "gd_itm_neg_b256_t40_h12", 256, 40, 40, 12, 8),
            probs_case(rnd, "cross", "gd_itm_neg_b256_tq40_s197_h12", 256, 40, 197, 12,
                       mask=region_mask(rnd, 256, 197)[0]),
            probs_case(rnd, "cross", "gd_bbox_b128_tq40_s197_h12", 128, 40, 197, 12, 197 // 4)]


# the maps held entry by entry: |p - ref| <= MAPS_ATOL + rtol * |ref|, rtol
# MAPS_RTOL_CORE where both sides read the same bf16 q, k and v (f32
# summation order and ex2.approx differ by ~1e-6 relatively), MAPS_RTOL for
# a sublayer (its q and k come out of the projections rounded to bf16: a
# rounding that falls the other way moves a score, so each probability
# relatively, by up to 2^-7 * |q_i k_i| / 8, a few 1e-3 at these inputs);
# MAPS_ATOL covers f32 values that ex2.approx flushes to zero
MAPS_ATOL, MAPS_RTOL_CORE, MAPS_RTOL = 1e-6, 1e-4, 8 * BF16_ULP


def phase_probs(cases, same_inputs: bool = False) -> dict:
    """Each probs form against its plain version: the output held to 4 bf16
    ulps at its largest magnitude (phase_kernels' rule); the maps to 4 bf16
    ulps of the largest probability, and entry by entry to MAPS_ATOL + rtol
    * |ref| (MAPS_RTOL_CORE with `same_inputs`, the core alone on the same
    bf16 q, k and v; else MAPS_RTOL), which a map written to the wrong place
    fails (two 32-key chunks swapped, or a 16-byte unit moved inside one,
    keeps every row sum at 1 and every value finite); each row summing to
    1 within 1e-4 (f32 sums of up to 901 terms); masked keys exactly 0."""
    import torch

    rtol = MAPS_RTOL_CORE if same_inputs else MAPS_RTOL
    errs = {}
    for name, case, run, plain, _, _, mask, *_ in cases:
        (out, probs), (ref, ref_probs) = run(), plain()
        out, ref = out.float(), ref.float()
        torch.cuda.synchronize()
        check(out.shape == ref.shape and probs.shape == ref_probs.shape,
              f"{name}/{case}: shapes {tuple(out.shape)}, {tuple(probs.shape)}")
        check(bool(torch.isfinite(out).all()) and bool(torch.isfinite(probs).all()),
              f"{name}/{case}: non-finite output")
        err, tol = (out - ref).abs().max().item(), 4 * BF16_ULP * ref.abs().max().item()
        diff = (probs - ref_probs).abs()
        perr = diff.max().item()
        ptol = 4 * BF16_ULP * ref_probs.abs().max().item()
        # the largest |p - ref| / (|ref| + MAPS_ATOL / rtol): at most rtol
        prel = (diff / (ref_probs.abs() + MAPS_ATOL / rtol)).max().item()
        del diff
        sums = (probs.sum(-1) - 1).abs().max().item()
        masked = probs.masked_select((mask == 0)[:, None, None, :].expand_as(probs))
        print(f"kernel {name} [{case}]: max_abs_err {err:.4e} tol {tol:.4e}; probs max_abs_err "
              f"{perr:.4e} tol {ptol:.4e}, entry-wise {prel:.3e} of |ref| (tol {rtol:.1e}), row "
              f"sums within {sums:.2e} of 1, {masked.numel()} masked entries, max "
              f"{masked.abs().max().item() if masked.numel() else 0:.1e}")
        check(err <= tol and perr <= ptol, f"{name}/{case} disagrees with its plain version")
        check(prel <= rtol, f"{name}/{case}: a map entry disagrees with its plain version")
        check(sums <= 1e-4, f"{name}/{case}: rows do not sum to 1")
        check(bool((masked == 0).all()), f"{name}/{case}: a masked key has a probability")
        errs[name] = max(errs.get(name, 0.0), err, perr)
    return errs


def grad_cases(rnd):
    """The differentiable forms of #1-#3 with f32 master params, as the
    student runs them, against the plain versions' own autograd: (name,
    kernel call, plain call, inputs, cotangents)."""
    import torch

    from efficientvlm_tpu_torch.ops import fused_mha as F
    from efficientvlm_tpu_torch.ops.patch_embed import fused_patch_embed, patch_embed_plain

    d, h, cases = 768, 12, []
    master = lambda t: t.float().requires_grad_(True)  # noqa: E731
    # with maps: the ViT at 577 tokens, the fusion cross-attention, and a
    # region batch's local layer at 197 tokens with its key masks; without:
    # the ViT of general distillation's plain pretrain step (B 128 at 224 px)
    for kind, b, t, s, region, probs in (
            ("self", 4, 577, 577, False, True), ("cross", 8, 40, 577, False, True),
            ("self", 8, 197, 197, True, True), ("self", 128, 197, 197, False, False)):
        prm = {n: {k: master(v) for k, v in p.items()} for n, p in rnd.attn(d, d).items()}
        x, enc = rnd(b, t, d).requires_grad_(True), rnd(b, s, d).requires_grad_(True)
        hz = master(rnd.gates(h))
        mask = region_mask(rnd, b, s)[0] if region else rnd.mask(b, s, s // 4)
        kb = F._key_bias(b, s, mask, None, x.device)
        ins = [x, hz] + [prm[n][k] for n in prm for k in prm[n]] + (
            [enc] if kind == "cross" else [])
        cts = [rnd(b, t, d)] + ([rnd(b, h, t, s, dtype=torch.float32)] if probs else [])
        # each call returns a tuple: (out, probs) or (out,)
        tup = (lambda y: y) if probs else (lambda y: (y,))
        if kind == "self":
            run = lambda prm=prm, x=x, mask=mask, hz=hz, p=probs, tup=tup: tup(  # noqa: E731
                F.fused_self_attention(prm, x, num_heads=h, mask=mask, head_z=hz,
                                       return_probs=p, differentiable=True))
            plain = lambda prm=prm, x=x, kb=kb, hz=hz, p=probs, tup=tup: tup(  # noqa: E731
                F.self_attention_plain(prm, x, kb, hz, h, return_probs=p))
        else:
            run = lambda prm=prm, x=x, enc=enc, mask=mask, hz=hz: F.fused_cross_attention(  # noqa
                prm, x, enc, num_heads=h, mask=mask, head_z=hz, return_probs=True,
                differentiable=True)
            plain = lambda prm=prm, x=x, enc=enc, kb=kb, hz=hz: F.cross_attention_plain(  # noqa
                prm, x, enc, kb, hz, h, return_probs=True)
        cases.append((f"fused_{kind}_attention" + ("_probs" if probs else "") +
                      f" [b{b} t{t}]", run, plain, ins, cts))
    p, res, b = 16, 384, 4
    n = (res // p) ** 2
    pp = {"patch_embed": {"kernel": master(rnd(p, p, 3, d, std=(p * p * 3) ** -0.5))},
          "class_embedding": master(rnd(d, std=0.5)),
          "pos_embed": {"embedding": master(rnd(n + 1, d, std=0.5))},
          "pre_ln": {"scale": master(rnd(d, std=0.1, mean=1.0)), "bias": master(rnd(d, std=0.1))}}
    img = rnd(b, res, res, 3)
    leaves = [pp["patch_embed"]["kernel"], pp["class_embedding"], pp["pos_embed"]["embedding"],
              pp["pre_ln"]["scale"], pp["pre_ln"]["bias"]]
    cases.append(("patch_embed",
                  lambda: (fused_patch_embed(pp, img, patch_size=p, dtype=torch.bfloat16,
                                             differentiable=True),),
                  lambda: (patch_embed_plain(pp, img, patch_size=p, dtype=torch.bfloat16),),
                  leaves, [rnd(b, n + 1, d)]))
    return cases


def phase_grads(cases):
    """Every input gradient of each differentiable form against the plain
    version's own autograd on the same inputs. The form's backward recomputes
    that version with the same casts, so the two run the same operations:
    held to 1e-5 of the largest gradient of each input (reduction order is
    all that may differ); the forward outputs, which come from the kernel,
    do not enter the gradients."""
    import torch

    for name, run, plain, ins, cts in cases:
        grads = []
        for fn in (run, plain):
            for t in ins:
                t.grad = None
            outs = fn()
            torch.autograd.backward(list(outs), cts[:len(outs)])
            grads.append([t.grad.float() for t in ins])
        torch.cuda.synchronize()
        worst = 0.0
        for g, r in zip(*grads):
            check(bool(torch.isfinite(g).all()), f"{name}: non-finite gradient")
            worst = max(worst, (g - r).abs().max().item() / max(r.abs().max().item(), 1e-30))
        print(f"kernel {name} differentiable: {len(ins)} input gradients, worst max_abs_err / "
              f"max|grad| {worst:.3e} (tol 1e-5)")
        check(worst <= 1e-5, f"{name}: gradients disagree with the plain version's autograd")


# --------------------------------------------------------------------------
# phase 3b: the retrieval pruning fine-tune and its export
# --------------------------------------------------------------------------

TRAIN_UNIT = dict(batch=24, tokens=40, steps=3, steps_per_epoch=1000)


def train_config():
    """configs/x-vlm-small-ft/Retrieval_coco.yaml with the vision tower of
    configs/config_clipvit_small.json (6L CLIP-ViT-B/16 at 384 px), BERT-base
    with 6 text layers (fusion at 3, dropout 0.1); the teacher 12L/12L
    (drivers/common.teacher_configs). The schedules assume an epoch of
    TRAIN_UNIT["steps_per_epoch"] steps."""
    from efficientvlm_tpu_torch.config import Config, VisionConfig

    vision = VisionConfig.create(vision_width=768, patch_size=16, hidden_act="quick_gelu",
                                 num_attention_heads=12, attention_dropout=0.0,
                                 intermediate_size=3072, num_hidden_layers=6,
                                 local_attn_depth=2, image_res=384)
    return Config({
        "image_res": 384, "vision": vision, "text_num_hidden_layers": 6,
        "batch_size_train": 24, "max_tokens": 40, "embed_dim": 256, "temp": 0.07,
        "sparsity": 0.25, "head_gate_group": 2,
        "optimizer": {"opt": "adamW", "lr": 3e-5, "reg_learning_rate": 0.01,
                      "weight_decay": 0.01, "lr_mult": 2},
        "schedular": {"sched": "linear", "lr": 3e-5, "epochs": 10, "num_warmup_steps": 0.1},
        "L0_schedular": {"epochs": 10, "droprate_init": 0.5, "temperature": 0.6667,
                         "lagrangian_warmup_epochs": 1}})


def clone_tree(tree):
    import torch

    if isinstance(tree, dict):
        return {k: clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [clone_tree(v) for v in tree]
    return tree.detach().clone() if isinstance(tree, torch.Tensor) else tree


def pin_negatives(model):
    """Hard negatives pinned to a fixed in-batch derangement on every path
    (no pair shares an image id under the batch's idx):
    the argmax of the sampling weights can flip between paths on near-ties
    (rounding a unit feature to bf16 moves a similarity by up to about
    2^-8 / 0.07 = 0.06 at temp 0.07)."""
    import torch

    def pick(generator, image_feat, text_feat, *, idx=None, temp):
        n = image_feat.shape[0]
        ar = torch.arange(n, device=image_feat.device)
        return (ar + 2) % n, (ar + 3) % n  # other ids under idx = arange // 2

    model.sample_hard_negatives = pick


def train_paths(rnd):
    """The student, teacher, gates and optimizers of the slice, and one
    state per path (kernel: impl fused, bf16; plain: impl plain, bf16; f32:
    impl plain, f32 compute), all from one init."""
    import torch

    from efficientvlm_tpu_torch.bridge import cast_floating
    from efficientvlm_tpu_torch.drivers.common import build_optimizers
    from efficientvlm_tpu_torch.drivers.retrieval import build_l0, build_models
    from efficientvlm_tpu_torch.train.steps import init_train_state, make_retrieval_train_step

    config = train_config()
    student, teacher = build_models(config)
    for m in (student, teacher):
        pin_negatives(m)
    l0 = build_l0(config)
    u = TRAIN_UNIT
    l0.lagrangian_warmup = u["steps_per_epoch"]  # lagrangian_warmup_epochs 1
    total = config["schedular"]["epochs"] * u["steps_per_epoch"]
    params, gates = student.init(0, device="cuda"), l0.init(0, device="cuda")
    # the frozen teacher stored in bf16: the values its kernels would round
    # the f32 weights to on every call; the f32 path upcasts them (exact)
    t_bf16 = cast_floating(teacher.init(1, device="cuda"), torch.bfloat16)
    paths = {}
    for name, impl, dtype in (("kernel", "fused", torch.bfloat16),
                              ("plain", "plain", torch.bfloat16), ("f32", "plain", None)):
        opts = build_optimizers(params, config, total)
        state = init_train_state(clone_tree(params), clone_tree(gates), opts)
        tparams = t_bf16 if dtype is not None else cast_floating(t_bf16, torch.float32)
        step = make_retrieval_train_step(student, teacher, l0, opts, teacher_params=tparams,
                                         dtype=dtype, impl=impl)
        paths[name] = (step, state, dtype)
    b, t = u["batch"], u["tokens"]
    image = rnd(b, 384, 384, 3)
    ids = torch.randint(1, 30522, (b, t), generator=rnd.g, device="cuda")
    atts = rnd.mask(b, t, 8)
    ids = torch.where(atts == 1, ids, 0)  # PAD past each text's length
    idx = torch.arange(b, device="cuda") // 2  # two texts an image, as COCO's five
    return config, student, teacher, l0, paths, {"image": image, "text_ids": ids,
                                                 "text_atts": atts, "idx": idx}


def flat_grads(grads):
    import torch

    return torch.cat([g.float().reshape(-1) for g in grads if g is not None])


def grad_distance(a, b) -> tuple:
    """(relative norm ||a - b|| / ||b||, cosine) of two gradient lists."""
    import torch

    fa, fb = flat_grads(a).double(), flat_grads(b).double()
    rel = (fa - fb).norm().item() / max(fb.norm().item(), 1e-30)
    return rel, torch.nn.functional.cosine_similarity(fa, fb, dim=0).item()


TRAIN_FACTOR = 3.0  # kernel path vs plain path, in units of plain bf16 vs f32


def hold_to_plain(results, steps: int, groups, what: str):
    """The kernel path's losses and step-1 gradients against the plain
    path's, in units of the plain bf16 path's distance from the f32 path.
    results: {"kernel" | "plain" | "f32": (metrics per step, step-1 gradient
    lists, one per group)}. The loss yardstick is the plain bf16 path's
    largest relative distance from f32 over every loss of every step (one
    scalar's own distance may cancel by chance: on an NVIDIA H100 80GB HBM3
    at 700 W the ITM-logit KD's was 1e-4 at one step and 2e-3 at the next)."""
    (mk, gk), (mp, gp), (mf, gf) = (results[n] for n in ("kernel", "plain", "f32"))
    rel = max(abs(mp[i][k] - mf[i][k]) / max(abs(mf[i][k]), 1e-3)
              for i in range(steps) for k in mf[i])
    for i in range(steps):
        worst = max((abs(mk[i][k] - mp[i][k]) / max(abs(mf[i][k]), 1e-3), k) for k in mf[i])
        print(f"{what} step {i + 1} losses: kernel vs plain worst relative {worst[0]:.3e} "
              f"({worst[1]}); plain bf16 vs f32 worst over the steps {rel:.3e}; tol "
              f"{TRAIN_FACTOR * rel:.3e}")
        check(worst[0] <= TRAIN_FACTOR * rel, f"{what} step {i + 1}: {worst[1]} of the kernel "
                                              "path disagrees with the plain path")
    for j, group in enumerate(groups):
        rel_kp, cos_kp = grad_distance(gk[j], gp[j])
        rel_pf, cos_pf = grad_distance(gp[j], gf[j])
        # per leaf (leaves with a non-zero gradient): (rel, 1 - cos) of kernel
        # vs plain, then of plain vs f32
        per_leaf = [(*grad_distance([a], [b_]), *grad_distance([b_], [c_]))
                    for a, b_, c_ in zip(gk[j], gp[j], gf[j])
                    if a is not None and b_ is not None and b_.abs().max().item() > 0]
        med = [statistics.median(x[i] if i % 2 == 0 else 1 - x[i] for x in per_leaf)
               for i in range(4)]
        print(f"{what} step-1 gradients [{group}, {len(per_leaf)} leaves]: kernel vs plain rel "
              f"{rel_kp:.3e} cos {cos_kp:.6f}; plain bf16 vs f32 rel {rel_pf:.3e} cos "
              f"{cos_pf:.6f}; per-leaf medians: rel {med[0]:.3e} vs {med[2]:.3e}, 1 - cos "
              f"{med[1]:.3e} vs {med[3]:.3e}; worst leaf rel {max(x[0] for x in per_leaf):.3e} "
              f"vs {max(x[2] for x in per_leaf):.3e}")
        check(rel_kp <= TRAIN_FACTOR * rel_pf and 1 - cos_kp <= TRAIN_FACTOR * (1 - cos_pf)
              + 1e-7 and med[0] <= TRAIN_FACTOR * med[2]
              and med[1] <= TRAIN_FACTOR * med[3] + 1e-7,
              f"{what} step-1 gradients [{group}]: the kernel path disagrees with the plain path")


def phase_train(rnd):
    """TRAIN_UNIT["steps"] full-width steps at batch 24 on the kernel path,
    the plain path and the f32 plain path from one state, with the concrete
    noise, the dropout generator and the hard negatives pinned alike: exact
    launch counts per kernel-path step, finite losses, gradients and params,
    each loss and the step-1 gradients of the kernel path against the plain
    path (held to TRAIN_FACTOR x the plain bf16 path's distance from f32),
    and loga / λ moving (λ along its gradient: ascent)."""
    import torch

    from efficientvlm_tpu_torch.train.optim import tree_leaves

    config, student, teacher, l0, paths, batch = train_paths(rnd)
    u = TRAIN_UNIT
    noises = []
    for _ in range(u["steps"]):
        noises.append({k: torch.rand(g["shape"], generator=rnd.g, device="cuda") * (1 - 2e-6)
                       + 1e-6 for k, g in l0.groups.items()})
    results = {}
    launches = None
    for name, (step, state, dtype) in paths.items():
        gen = torch.Generator(device="cuda").manual_seed(7)
        b = dict(batch, image=batch["image"] if dtype is not None else batch["image"].float())
        loga0 = [t.clone() for t in tree_leaves(state.loga)]
        lam0 = [t.detach().clone() for t in tree_leaves(state.lam)]
        metrics, first_grads = [], None
        if name == "kernel":
            c = reset_counts()  # the training path's run starts here
        for i in range(u["steps"]):
            t_out = step.teacher_forward(b)
            m, grads = step.loss_and_grads(state, b, t_out, gen, noise=noises[i])
            del t_out
            if i == 0:
                first_grads = grads
            step.apply(state, grads)
            metrics.append({k: float(v) for k, v in m.items()})
            if name == "kernel":
                # teacher 12 ViT + 6 text + 2x6 fusion self, student 6 ViT (#2 probs);
                # teacher 2x6 fusion cross (#3 probs); #1 for teacher and student
                c = expect_launches(c, (2, 0, 0, 0, 0, 0, 36, 12), f"train step {i + 1}")
        if name == "kernel":
            launches = counts()
        torch.cuda.synchronize()
        check(all(math.isfinite(v) for mm in metrics for v in mm.values()),
              f"train {name}: non-finite loss")
        check(all(bool(torch.isfinite(g).all()) for g in sum(first_grads, []) if g is not None),
              f"train {name}: non-finite gradient")
        check(all(bool(torch.isfinite(t).all()) for t in tree_leaves(state.params)),
              f"train {name}: non-finite params")
        dloga = max((a - b_).abs().max().item() for a, b_ in zip(tree_leaves(state.loga), loga0))
        dlam = [(a.detach() - b_).item() for a, b_ in zip(tree_leaves(state.lam), lam0)]
        g_lam1 = first_grads[2][0].item()
        print(f"train {name} ({u['steps']} steps, batch {u['batch']}): " + ", ".join(
            f"{k} " + "/".join(f"{mm[k]:.5f}" for mm in metrics) for k in metrics[0]) +
            f"; loga moved {dloga:.3e}, lambda_1/2 moved {dlam[0]:+.3e}/{dlam[1]:+.3e} "
            f"(step-1 grad of lambda_1 {g_lam1:+.3e})")
        check(dloga > 0 and all(d != 0 for d in dlam), f"train {name}: the gates did not move")
        check(dlam[0] * g_lam1 > 0, f"train {name}: lambda_1 did not ascend its gradient")
        results[name] = (metrics, first_grads, state)

    hold_to_plain({n: r[:2] for n, r in results.items()}, u["steps"],
                  ("params", "loga", "lambda"), "train")
    step, state, _ = paths["kernel"]
    for name in ("plain", "f32"):
        del paths[name]
    del results
    return {"step": step, "state": state, "batch": batch, "noise": noises[-1], "l0": l0,
            "student": student, "config": config, "launches": launches}


# the export's FFN width alignment on the H100 (NVIDIA H100 80GB HBM3, 700
# W): ffn_width_sweep put the ViT FFN at 1.316 ms at width 2255 against
# 0.412 at 2256 and 0.399 at 2240, and the student exported at 25.5%
# sparsity ran 3,251 / 4,598 / 4,720 pairs/s at alignment 1 / 8 / 64
# (dense: 4,275); head pairs keep the attention widths at multiples of 128
EXPORT_ALIGN = 64
FFN_SWEEP = (2240, 2248, 2255, 2256, 2304, 2556, 2560, 3072)


def ffn_width_sweep():
    """The ViT FFN (fc1 -> quick_gelu -> fc2, F.linear on [in, out] kernels
    as models/vit.py runs it) at 32 x 577 rows, bf16, over pruned widths."""
    import torch

    from efficientvlm_tpu_torch.ops.basic import dense, quick_gelu

    x, out = torch.randn(32 * 577, 768, device="cuda", dtype=torch.bfloat16), {}
    for width in FFN_SWEEP:
        fc1 = {"kernel": torch.randn(768, width, device="cuda", dtype=torch.bfloat16) * 0.03,
               "bias": torch.zeros(width, device="cuda", dtype=torch.bfloat16)}
        fc2 = {"kernel": torch.randn(width, 768, device="cuda", dtype=torch.bfloat16) * 0.03,
               "bias": torch.zeros(768, device="cuda", dtype=torch.bfloat16)}
        with torch.inference_mode():
            out[width] = timed_ms(lambda: dense(fc2, quick_gelu(dense(fc1, x))))
    print("ffn width sweep (ViT FFN, 18,464 rows, bf16, ms): " +
          ", ".join(f"{w} {ms:.4f}" for w, ms in out.items()))
    return out


def drawn_loga(state, rnd) -> dict:
    """Log-alphas drawn from a seed for the export checks: head groups in
    [-4, 4), FFN units in [-3, 3), so the deterministic gates drop some."""
    import torch

    return {key: (torch.rand(v.shape, generator=rnd.g, device="cuda") * 8 - 4
                  if key.endswith("head") else torch.rand(v.shape, generator=rnd.g,
                                                          device="cuda") * 6 - 3)
            for key, v in state.loga.items()}


def pruned_counts(params, fusion: int) -> tuple:
    """(ViT, text, fusion self, fusion cross) sublayers left in a pruned tree."""
    layers = params["text"]["layers"]
    return (sum(lp.get("attn") is not None for lp in params["vision"]["layers"]),
            sum(lp.get("attention") is not None for lp in layers[:fusion]),
            sum(lp.get("attention") is not None for lp in layers[fusion:]),
            sum(lp.get("crossattention") is not None for lp in layers[fusion:]))


def phase_export(train_state, slice_state, rnd) -> dict:
    """forward_deterministic -> prune_xvlm_params, for the trained gates and
    for gates drawn from a seed in place of a longer run's (3 steps move no
    head gate far from its init of 10): heads per layer and FFN widths, then
    the pruned student's retrieval forward at batch 32 and one i2t and one
    t2i rerank chunk (4 x 256) with exact launch counts, each held against
    the gated dense student with the same zs (the export's exactness) and
    against the plain path, both to 5% of the largest value (the tolerance
    of the eval slice's kernel-vs-plain check: bf16 rounding over 6 layers
    in another summation order)."""
    import torch

    from efficientvlm_tpu_torch.bridge import cast_floating
    from efficientvlm_tpu_torch.evaluation import retrieval as R
    from efficientvlm_tpu_torch.pruning.export import prune_xvlm_params

    bf16 = torch.bfloat16
    l0, student, state = train_state["l0"], train_state["student"], train_state["state"]
    fusion = student.text_cfg["fusion_layer"]
    image, ids, atts = slice_state["image"], slice_state["ids"], slice_state["atts"]
    ib, ib_x, txt, txt_atts, rows, k = slice_state["rerank"]
    drawn = drawn_loga(state, rnd)
    with torch.no_grad():
        dense = cast_floating(state.params, bf16)
    out = {}
    for gates_name, loga in (("trained", state.loga), ("drawn", drawn)):
        zs = l0.forward_deterministic({"loga": loga})
        sizes = l0.calculate_model_size(zs)
        with torch.no_grad():
            pruned = cast_floating(prune_xvlm_params(state.params, zs, fusion_layer=fusion,
                                                     head_dim=64,
                                                     align_intermediate=EXPORT_ALIGN), bf16)
        vit, text, fself, fcross = pruned_counts(pruned, fusion)
        n_heads = lambda attn: 0 if attn is None else attn["q"]["kernel"].shape[1] // 64  # noqa
        text_layers = pruned["text"]["layers"]
        heads = {"vision": [n_heads(lp.get("attn")) for lp in pruned["vision"]["layers"]],
                 "text_self": [n_heads(lp.get("attention")) for lp in text_layers],
                 "cross": [n_heads(lp.get("crossattention")) for lp in text_layers[fusion:]]}
        ffn = {"vision": [0 if lp.get("mlp") is None else lp["mlp"]["fc1"]["kernel"].shape[1]
                          for lp in pruned["vision"]["layers"]],
               "text": [0 if lp.get("intermediate") is None
                        else lp["intermediate"]["kernel"].shape[1]
                        for lp in pruned["text"]["layers"]]}
        print(f"export [{gates_name} gates]: sparsity {sizes['pruned_model_sparsity']:.4f}; "
              f"heads per layer {json.dumps(heads)}; FFN widths {json.dumps(ffn)}")
        c = reset_counts()
        with torch.inference_mode():
            got = R.retrieval_forward(student, pruned, image, ids, atts, dtype=bf16)
            c = expect_launches(c, (1, vit + text + fself, fcross), f"pruned forward "
                                                                     f"[{gates_name}]")
            i2t = R.itm_rerank_scores(student, pruned, ib, txt, txt_atts, rows, k, dtype=bf16)
            c = expect_launches(c, (0, fself, 0, fcross), f"pruned i2t chunk [{gates_name}]")
            t2i = R.itm_rerank_scores(student, pruned, ib_x, txt, txt_atts, rows, k, dtype=bf16)
            c = expect_launches(c, (0, fself, fcross), f"pruned t2i chunk [{gates_name}]")
            gated = R.retrieval_forward(student, dense, image, ids, atts, zs=zs, dtype=bf16)
            plain = R.retrieval_forward(student, pruned, image, ids, atts, dtype=bf16,
                                        impl="plain")
            chunks = [(R.itm_rerank_scores(student, dense, img_rows, txt, txt_atts, rows, k,
                                           zs=zs, dtype=bf16),
                       R.itm_rerank_scores(student, pruned, img_rows, txt, txt_atts, rows, k,
                                           dtype=bf16, impl="plain"))
                      for img_rows in (ib, ib_x)]
        for what, a, g, p in zip(("image_feat", "text_feat", "itm_logits", "i2t_scores",
                                  "t2i_scores"), (*got, i2t, t2i),
                                 (*gated, chunks[0][0], chunks[1][0]),
                                 (*plain, chunks[0][1], chunks[1][1])):
            a, g, p = a.float(), g.float(), p.float()
            check(bool(torch.isfinite(a).all()), f"pruned {what} not finite")
            e_g, e_p = (a - g).abs().max().item(), (a - p).abs().max().item()
            tol = 0.05 * g.abs().max().item()
            print(f"pruned [{gates_name}] {what}: vs gated dense {e_g:.4e}, vs plain path "
                  f"{e_p:.4e}, tol {tol:.4e}")
            check(e_g <= tol and e_p <= tol, f"pruned [{gates_name}] {what} disagrees")
        for align in sorted({1, EXPORT_ALIGN, 64}):
            with torch.no_grad():
                other = pruned if align == EXPORT_ALIGN else cast_floating(prune_xvlm_params(
                    state.params, zs, fusion_layer=fusion, head_dim=64,
                    align_intermediate=align), bf16)
            with torch.inference_mode():
                run = lambda: R.retrieval_forward(student, other, image, ids, atts,  # noqa
                                                  dtype=bf16)
                ms, dev_us = timed_ms(run, iters=5), device_us(run)[0]
            out[f"pruned_{gates_name}_align{align}_student_pairs_per_s"] = 32 / ms * 1e3
            out[f"pruned_{gates_name}_align{align}_device_ms"] = dev_us and dev_us / 1e3
        if gates_name == "trained":
            with torch.inference_mode():
                profile("pruned student forward b32 [trained gates]",
                        lambda: R.retrieval_forward(student, pruned, image, ids, atts,
                                                    dtype=bf16), top=8)
    ffn_width_sweep()
    with torch.inference_mode():
        run = lambda: R.retrieval_forward(student, dense, image, ids, atts, dtype=bf16)  # noqa
        profile("dense student forward b32", run, top=8)
        ms, dev_us = timed_ms(run, iters=5), device_us(run)[0]
    out["dense_student_pairs_per_s"] = 32 / ms * 1e3
    # device busy per forward (torch.profiler): the host sets the pace of the
    # student's batch-32 forward on some hosts, so this is the stable figure
    out["dense_device_ms"] = dev_us and dev_us / 1e3
    print(json.dumps({"export_throughput": out}))
    return out


# --------------------------------------------------------------------------
# phase 3c: general distillation (stage 1)
# --------------------------------------------------------------------------

GD_UNIT = dict(batch=128, raw=257, res=224, tokens=40, max_masks=8, region_images=48,
               region_texts=128, steps=3)
# launches per kernel-path step, wrappers() order: #1 teacher + student; #2's
# probs form: teacher ViT 12, text 6, ITM pos / neg 6 + 6, MLM 12, student
# ViT 6; #3's: teacher ITM pos / neg 6 + 6, MLM 6. The teacher runs no bbox
# head (no KD loss reads it); the student's BERT layers (dropout 0.1),
# its bbox head included, take the plain core
GD_LAUNCHES = {False: (2, 0, 0, 0, 0, 0, 48, 18), True: (2, 0, 0, 0, 0, 0, 48, 18)}
GD_PATHS = (("kernel", "fused", "bfloat16"), ("plain", "plain", "bfloat16"),
            ("f32", "plain", None))


def gd_config():
    """configs/Pretrain_XVLM_small_4m.yaml with the vision tower of
    configs/config_clipvit_small.json: the student's 6L CLIP-ViT-B/16 at 224
    px with local_attn_depth 2 and BERT-base with 6 layers (fusion at 3,
    dropout 0.1); the teacher 12L ViT (local_attn_depth 4) + 12L BERT (fusion
    at 6) (drivers/common.teacher_configs); embed 256, temp 0.07, 40 tokens,
    8 masks at most, one AdamW (lr 1e-4, weight decay 0.01, lr_mult 2, clip
    1.0) over the published schedule's length, device_preprocess. One cut:
    the warm-up of 2,500 steps is 0 here, so that the three checked steps
    update at the peak lr (under the warm-up their lrs are 0, 4e-8, 8e-8)."""
    from efficientvlm_tpu_torch.config import Config, VisionConfig

    vision = VisionConfig.create(vision_width=768, patch_size=16, hidden_act="quick_gelu",
                                 num_attention_heads=12, attention_dropout=0.0,
                                 intermediate_size=3072, num_hidden_layers=6,
                                 local_attn_depth=2, image_res=224)
    return Config({
        "image_res": 224, "vision": vision, "text_num_hidden_layers": 6, "embed_dim": 256,
        "temp": 0.07, "max_tokens": 40, "max_masks": 8, "mask_prob": 0.25,
        "train_dataset_size": 5114489, "images": {"batch_size": 128},
        "regions": {"batch_size": 128, "max_images": 48},
        "optimizer": {"opt": "adamW", "lr": 1e-4, "weight_decay": 0.01, "lr_mult": 2},
        "schedular": {"sched": "linear", "lr": 1e-4, "epochs": 41, "num_warmup_steps": 0},
        "accelerator": {"CLIP_GRAD_NORM": 1.0}, "device_preprocess": True})


def gd_text(rnd, n: int) -> dict:
    """n texts of 40 tokens ([CLS] first, PAD past each length of 8-40) and
    their MLM inputs: 25% of the tokens after [CLS], at least 1 and at most
    8, replaced by [MASK] (103); masked_pos / masked_ids padded with 0 /
    -100."""
    import torch

    t, m = GD_UNIT["tokens"], GD_UNIT["max_masks"]
    atts = rnd.mask(n, t, 8)
    ids = torch.randint(1000, 30522, (n, t), generator=rnd.g, device="cuda")
    ids[:, 0] = 101
    ids = torch.where(atts == 1, ids, 0)
    lens = atts.sum(1)
    n_mask = ((lens - 1).float() * 0.25).long().clamp(1, m)
    ar = torch.arange(t, device="cuda")
    score = torch.rand(n, t, generator=rnd.g, device="cuda")
    score = torch.where((ar[None] >= 1) & (ar[None] < lens[:, None]), score, 2.0)
    valid = torch.arange(m, device="cuda")[None] < n_mask[:, None]
    pos = torch.where(valid, score.argsort(1)[:, :m], 0)
    masked_ids = torch.where(valid, ids.gather(1, pos), -100)
    masked = ids.scatter(1, pos, torch.where(valid, 103, ids.gather(1, pos)))
    return {"text_ids": ids, "text_atts": atts, "text_ids_masked": masked,
            "masked_pos": pos, "masked_ids": masked_ids}


def gd_batches(rnd) -> tuple:
    """The general batch (128 uint8 images of 257 x 257, what
    ImageTransform.uint8(224) ships, and their texts) and the region batch
    (48 images at 224 and 128 region texts: every image has one text or
    more, each text a box of 2-10 x 2-10 patches whose patch mask (and the
    CLS) is its image_atts; every 8th text is a whole-image "region",
    is_image 1)."""
    import torch

    u = GD_UNIT
    general = {"image": torch.randint(0, 256, (u["batch"], u["raw"], u["raw"], 3),
                                      generator=rnd.g, device="cuda", dtype=torch.uint8),
               **gd_text(rnd, u["batch"])}
    n_img, n_txt = u["region_images"], u["region_texts"]
    idx = torch.cat([torch.arange(n_img, device="cuda"),
                     torch.randint(0, n_img, (n_txt - n_img,), generator=rnd.g, device="cuda")])
    idx = idx[torch.randperm(n_txt, generator=rnd.g, device="cuda")]
    is_image = (torch.arange(n_txt, device="cuda") % 8 == 7).long()
    image_atts, box = region_mask(rnd, n_txt, (u["res"] // 16) ** 2 + 1, sizes=(2, 10),
                                  full=is_image == 1)
    region = {"image": rnd(n_img, u["res"], u["res"], 3, dtype=torch.float32),
              **gd_text(rnd, n_txt), "image_atts": image_atts, "idx_to_group_img": idx,
              "target_bbox": box, "is_image": is_image}
    return general, region


def gd_models():
    """The config, the student and teacher (bbox heads included), the
    student's f32 params and the frozen teacher's, stored in bf16 (the f32
    path upcasts them, exactly)."""
    import torch

    from efficientvlm_tpu_torch.bridge import cast_floating
    from efficientvlm_tpu_torch.drivers.gd import build_models

    config = gd_config()
    student, teacher = build_models(config)
    for m in (student, teacher):
        pin_negatives(m)
    params = student.init(0, device="cuda", with_bbox_head=True)
    t_bf16 = cast_floating(teacher.init(1, device="cuda", with_bbox_head=True), torch.bfloat16)
    return config, student, teacher, params, t_bf16


def gd_step(models, path: str, with_bbox: bool, distill: bool = True):
    """(preprocess or None, step, state) of one path from the shared init,
    built by drivers/gd.build_step (whose general step comes wrapped in
    DevicePreprocess; the parts are returned apart so they can be timed)."""
    import torch

    from efficientvlm_tpu_torch.bridge import cast_floating
    from efficientvlm_tpu_torch.drivers.common import build_optimizers
    from efficientvlm_tpu_torch.drivers.gd import DevicePreprocess, build_step, total_steps
    from efficientvlm_tpu_torch.train.steps import init_pretrain_state

    config, student, teacher, params, t_bf16 = models
    _, impl, dtype = next(p for p in GD_PATHS if p[0] == path)
    dtype = getattr(torch, dtype) if dtype else None
    opt = build_optimizers(params, config, total_steps(config))[0]
    state = init_pretrain_state(clone_tree(params), opt)
    tparams = t_bf16 if dtype is not None else cast_floating(t_bf16, torch.float32)
    step = build_step(config, student, opt, teacher=teacher if distill else None,
                      teacher_params=tparams, with_bbox=with_bbox, dtype=dtype, impl=impl)
    if isinstance(step, DevicePreprocess):
        return step.preprocess, step.step, state
    return None, step, state


def phase_gd(rnd, seeds: int = 0) -> dict:
    """GD_UNIT["steps"] steps of the general step (uint8 images ->
    preprocess_train -> ITC + ITM + MLM + KD) and of the region step (local
    attention, + bbox L1 / GIoU) on the kernel, plain and f32 plain paths
    from one init, each path's generator seeded alike (so the crops, flips,
    ops and dropout masks agree): exact launches per kernel-path step,
    finite losses, gradients and params, temp within its clamp, the kernel
    path held to the plain path (hold_to_plain); then one plain pretrain
    step (no teacher) whose losses sit at chance at init; with `seeds`,
    gd_leaf_seeds after (its launches are not counted)."""
    import torch

    from efficientvlm_tpu_torch.train.optim import tree_leaves

    t_phase = time.perf_counter()
    models = gd_models()
    general, region = gd_batches(rnd)
    u = GD_UNIT
    kept, c = {}, reset_counts()  # general distillation's run starts here
    for with_bbox, batch in ((False, general), (True, region)):
        what = "gd region" if with_bbox else "gd general"
        results = {}
        for path, _, _ in GD_PATHS:
            prep, step, state = gd_step(models, path, with_bbox)
            gen = torch.Generator(device="cuda").manual_seed(7)
            metrics, first = [], None
            for i in range(u["steps"]):
                b = prep(batch, gen) if prep else batch
                t_out = step.teacher_forward(b, gen)
                m, grads = step.loss_and_grads(state, b, t_out, gen)
                del t_out
                first = grads if first is None else first
                step.apply(state, grads)
                metrics.append({k: float(v) for k, v in m.items()})
                if path == "kernel":
                    c = expect_launches(c, GD_LAUNCHES[with_bbox], f"{what} step {i + 1}")
            if path != "kernel":  # the yardstick paths launch no kernel
                c = expect_launches(c, (), f"{what} {path}")
            torch.cuda.synchronize()
            check(all(math.isfinite(v) for mm in metrics for v in mm.values()),
                  f"{what} {path}: non-finite loss")
            check(all(bool(torch.isfinite(g).all()) for g in first if g is not None),
                  f"{what} {path}: non-finite gradient")
            check(all(bool(torch.isfinite(t).all()) for t in tree_leaves(state.params)),
                  f"{what} {path}: non-finite params")
            temp = float(state.params["temp"].detach())
            check(0.001 <= temp <= 0.5, f"{what} {path}: temp {temp} outside its clamp")
            print(f"{what} {path} ({u['steps']} steps): " + ", ".join(
                f"{k} " + "/".join(f"{mm[k]:.5f}" for mm in metrics) for k in metrics[0]))
            results[path] = (metrics, (first,))
            if path == "kernel":
                kept[with_bbox] = (prep, step, state, batch)
            del first, grads, step, state
        hold_to_plain(results, u["steps"], ("params",), what)
        leaf_report(what, models, *(results[p][1][0] for p in ("kernel", "plain", "f32")))
        del results

    # the plain pretrain step (the pretrain_* tasks): no teacher, no KD
    prep, step, state = gd_step(models, "kernel", False, distill=False)
    gen = torch.Generator(device="cuda").manual_seed(8)
    m = {k: float(v) for k, v in step(state, prep(general, gen), gen).items()}
    expect_launches(c, (1, 6, 0, 0, 0, 0, 0, 0), "pretrain step")  # the student's #1 and ViT
    chance = {"loss_itc": math.log(u["batch"]), "loss_itm": math.log(2),
              "loss_mlm": math.log(models[1].text_cfg["vocab_size"])}
    print("pretrain step (kernel path): " + ", ".join(f"{k} {v:.5f}" for k, v in m.items()) +
          "; chance: " + ", ".join(f"{k} {v:.5f}" for k, v in chance.items()))
    check(all(math.isfinite(v) for v in m.values()), "pretrain step: non-finite loss")
    check(abs(m["loss_itc"] - chance["loss_itc"]) < 1.0
          and abs(m["loss_itm"] - chance["loss_itm"]) < 0.2
          and abs(m["loss_mlm"] - chance["loss_mlm"]) < 1.0,
          "pretrain step: the losses at init are not at chance")
    del prep, step, state
    print(f"phase gd: {time.perf_counter() - t_phase:.1f} s")
    launches = counts()
    if seeds:
        gd_leaf_seeds(models, seeds)
    return {"kept": kept, "launches": launches}


def gd_parts(models) -> list:
    """(part name, leaf indices) of the student's params in tree order: the
    vision tower's global and local (region-masked) layers, its stem, the
    text layers, the fusion layers, the MLM head, the bbox head, the rest
    (ITM head, projections, temp)."""
    from efficientvlm_tpu_torch.train.optim import tree_leaves_with_path

    _, student, _, params, _ = models
    n_vis, local = student.vision_cfg["num_hidden_layers"], student.vision_cfg["local_attn_depth"]
    fusion = student.text_cfg["fusion_layer"]

    def part(p) -> str:
        if p[0] == "vision":
            if p[1] == "layers":
                return "vision_local" if p[2] >= n_vis - local else "vision_global"
            return "vision_stem"
        if p[0] == "text":
            if p[1] == "layers":
                return "fusion" if p[2] >= fusion else "text"
            return "mlm_head" if p[1] == "cls" else "text"
        return "bbox_head" if p[0] == "bbox_head" else "other"

    parts: dict = {}
    for i, (p, _) in enumerate(tree_leaves_with_path(params)):
        parts.setdefault(part(p), []).append(i)
    return list(parts.items())


def leaf_report(what, models, gk, gp, gf) -> dict:
    """Step-1 gradients by part of the student (gd_parts): the part's
    relative distance kernel vs plain beside plain bf16 vs f32, their ratio,
    and the part's worst leaf by that ratio. A kernel fault confined to some
    rows (the local layers' masked keys) shows as one part's ratio far above
    the others'; bf16 noise spreads alike. Returns {part: ratio}."""
    from efficientvlm_tpu_torch.train.optim import path_str, tree_leaves_with_path

    names = [path_str(p) for p, _ in tree_leaves_with_path(models[3])]
    ratios = {}
    for name, idx in gd_parts(models):
        idx = [i for i in idx if gp[i] is not None and gp[i].abs().max().item() > 0]
        if not idx:
            continue
        kp = grad_distance([gk[i] for i in idx], [gp[i] for i in idx])[0]
        pf = grad_distance([gp[i] for i in idx], [gf[i] for i in idx])[0]
        leaf = [(grad_distance([gk[i]], [gp[i]])[0], grad_distance([gp[i]], [gf[i]])[0], i)
                for i in idx]
        worst = max(leaf, key=lambda x: x[0] / max(x[1], 1e-12))
        ratios[name] = kp / max(pf, 1e-12)
        print(f"{what} step-1 gradients, part {name} ({len(idx)} leaves): kernel vs plain rel "
              f"{kp:.3e}, plain bf16 vs f32 {pf:.3e}, ratio {ratios[name]:.2f}; worst leaf "
              f"{names[worst[2]]}: {worst[0]:.3e} vs {worst[1]:.3e}")
    return ratios


def gd_leaf_seeds(models, seeds: int):
    """The region step's step-1 gradients by part (leaf_report) over `seeds`
    more region batches, each drawn from its own seed, on the kernel, plain
    and f32 paths from the shared init; then each part's ratio over the
    seeds. A diagnostic (chip_smoke.py --gd-seeds N); checks nothing."""
    import torch

    ratios: dict = {}
    for seed in range(1, seeds + 1):
        _, batch = gd_batches(Rand(100 + seed))
        grads = {}
        for path, _, _ in GD_PATHS:
            _, step, state = gd_step(models, path, True)
            gen = torch.Generator(device="cuda").manual_seed(7)
            grads[path] = step.loss_and_grads(state, batch, step.teacher_forward(batch, gen),
                                              gen)[1]
            del step, state
        for k, v in leaf_report(f"gd region seed {seed}", models,
                                *(grads[p] for p in ("kernel", "plain", "f32"))).items():
            ratios.setdefault(k, []).append(v)
        del grads
    print("gd region step-1 gradients, kernel vs plain over plain vs f32 by part, over "
          f"{seeds} seeds: " + ", ".join(f"{k} " + "/".join(f"{x:.2f}" for x in v)
                                         for k, v in ratios.items()))


def gd_times(gd_state, smi: str):
    """The GD steps' ms split into preprocessing (general only), teacher
    forward, student forward + backward and optimizer (host clock,
    synchronised at each boundary, median of 3 steps), samples/s, peak
    memory and a profile of one step, each with the card's name and power
    limit; then #2's and #3's probs forms at the GD shapes beside their
    bounds, plain versions and a library composition."""
    import torch

    for with_bbox, (prep, step, state, batch) in gd_state["kept"].items():
        what = "region" if with_bbox else "general"
        gen = torch.Generator(device="cuda").manual_seed(11)
        torch.cuda.reset_peak_memory_stats()
        parts = [("preprocess", lambda _: prep(batch, gen))] if prep else []
        med = split_ms(parts + [
            ("teacher_forward", lambda b: (b or batch, step.teacher_forward(b or batch, gen))),
            ("student_forward_backward",
             lambda bt: step.loss_and_grads(state, bt[0], bt[1], gen)[1]),
            ("optimizer", lambda grads: step.apply(state, grads))])
        total = sum(med.values())
        samples = GD_UNIT["region_texts"] if with_bbox else GD_UNIT["batch"]
        print(f"card: {smi}")
        print(json.dumps({f"gd_{what}_step": {
            **{f"{k}_ms": v for k, v in med.items()}, "step_ms": total,
            "samples_per_s": samples / total * 1e3,
            "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30}}))

        def one_step():
            b = prep(batch, gen) if prep else batch
            step(state, b, gen)

        profile(f"gd {what} step b{samples} (kernel path; card {smi})", one_step, calls=1,
                top=16)
    preprocess_split(gd_state["kept"][False][3]["image"], smi)
    for name, case, run, plain, flops, nbytes, _, lib in gd_probs_cases(Rand(3)):
        with torch.inference_mode():
            ms, plain_ms, lib_ms = timed_ms(run), timed_ms(plain), timed_ms(lib)
        bound_ms, bound_by = bound(flops, nbytes)
        print(f"time {name} [{case}]: {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
              f"{lib_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
              f"{nbytes / ms / 1e6:.1f} GB/s{device_host(case, run)}; card {smi}")


def preprocess_split(pixels, smi: str):
    """preprocess_train's parts at the general batch (CUDA events): the
    crop + flip, and each RandAugment op over the whole batch (in a step an
    op sees about 2 / 14 of it), so that the preprocessing's time can be
    told apart by op."""
    import torch

    from efficientvlm_tpu_torch.data import device_pipeline as P

    gen = torch.Generator(device="cuda").manual_seed(12)
    params = P.sample_train_params(gen, *pixels.shape[:3])
    res = GD_UNIT["res"]
    crop = lambda: P.flip_images(P.crop_resize(pixels, params["box"], res),  # noqa: E731
                                 params["flip"])
    imgs, sign = crop(), params["signs"][0]
    ms = {"crop_flip": timed_ms(crop, iters=3, runs=3)}
    for name, op in zip(("identity", "autocontrast", "equalize", "rotate", "solarize", "color",
                         "contrast", "brightness", "sharpness", "shear_x", "shear_y",
                         "translate_x", "translate_y", "posterize"),
                        P.make_randaug_ops(P.RANDAUG_M / P.MAX_LEVEL)):
        ms[name] = timed_ms(lambda: op(imgs, sign), iters=3, runs=3)
    ms["whole"] = timed_ms(lambda: P.preprocess_train(pixels, res, params=params), iters=3,
                           runs=3)
    print(f"preprocess split, ms at batch {pixels.shape[0]} ({smi}): " +
          ", ".join(f"{k} {v:.3f}" for k, v in ms.items()))


def split_ms(parts, runs: int = 3) -> dict:
    """Median host-clock ms of each part of a step over `runs` steps,
    synchronised at each boundary. parts: [(name, fn)] run in order, each fn
    taking the previous part's result (None for the first)."""
    import torch

    times = {name: [] for name, _ in parts}
    for _ in range(runs):
        out = None
        for name, fn in parts:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(out)
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) * 1e3)
        del out
    return {k: statistics.median(v) for k, v in times.items()}


def train_times(train_state, probs_case_list, errs) -> list:
    """ms per step split into its parts (host clock, synchronised at each
    boundary), samples/s, peak memory, a profile of one step; the probs
    forms' rows of the kernels line."""
    import torch

    step, state, batch = train_state["step"], train_state["state"], train_state["batch"]
    noise, gen = train_state["noise"], torch.Generator(device="cuda").manual_seed(11)
    torch.cuda.reset_peak_memory_stats()
    med = split_ms([
        ("teacher_forward", lambda _: step.teacher_forward(batch)),
        ("student_forward_backward",
         lambda t_out: step.loss_and_grads(state, batch, t_out, gen, noise=noise)[1]),
        ("optimizer", lambda grads: step.apply(state, grads))])
    total = sum(med.values())
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(json.dumps({"train_step": {**{f"{k}_ms": v for k, v in med.items()},
                                     "step_ms": total,
                                     "samples_per_s": TRAIN_UNIT["batch"] / total * 1e3,
                                     "peak_memory_gib": peak}}))
    profile("train step b24 (kernel path)", lambda: step(state, batch, gen, noise=noise),
            calls=1, top=16)

    rows, seen = [], set()
    for name, case, run, plain, flops, nbytes, _, lib in probs_case_list:
        if name in seen:  # the pruned widths
            continue
        seen.add(name)
        with torch.inference_mode():
            ms, plain_ms, lib_ms = timed_ms(run), timed_ms(plain), timed_ms(lib)
        bound_ms, bound_by = bound(flops, nbytes)
        print(f"time {name} [{case}]: {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
              f"{lib_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
              f"{nbytes / ms / 1e6:.1f} GB/s{device_host(case, run)}")
        src, replaces = KERNEL_META[name]
        rows.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                     "launches": train_state["launches"][name], "max_abs_err": errs[name],
                     "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                     "library_ms": lib_ms})
    return rows


# --------------------------------------------------------------------------
# phase 3d: the VQA and captioning pruning fine-tune (stage 2)
# --------------------------------------------------------------------------

TASK_UNIT = {"vqa": dict(batch=8, raw=512, res=480, q_len=40, a_len=20, max_answers=10,
                         k=128, steps=3, steps_per_epoch=1000),
             "captioning": dict(batch=16, res=384, tokens=30, steps=3, steps_per_epoch=1000),
             "nlvr": dict(batch=16, raw=448, res=384, tokens=40, steps=3, steps_per_epoch=1000),
             "grounding": dict(batch=16, res=384, tokens=30, steps=3, steps_per_epoch=1000)}
# launches per kernel-path step, wrappers() order: #1 teacher + student; #2's
# probs form: teacher ViT 12 (+ VQA question text 6 and fusion self 6; NLVR's
# replicated text stack 6 + 12), student ViT 6; #3's: teacher decoder cross 6
# (+ VQA question fusion 6; NLVR: the 12 replicated cross layers). The
# student's BERT layers and decoder (dropout 0.1) and every decoder
# self-attention (a causal matrix bias) take the plain core. Grounding has no
# teacher: #1 and the student ViT's 6 differentiable #2 without maps
TASK_LAUNCHES = {"vqa": (2, 0, 0, 0, 0, 0, 30, 12), "captioning": (2, 0, 0, 0, 0, 0, 18, 6),
                 "nlvr": (2, 0, 0, 0, 0, 0, 36, 12), "grounding": (1, 6)}


def task_config(task: str):
    """configs/x-vlm-small-ft/VQA_480.yaml, Captioning.yaml, NLVR.yaml or
    Grounding.yaml with the vision tower of configs/config_clipvit_small.json:
    the student's 6L CLIP-ViT-B/16 (at 480 / 384 px) and BERT-base with 6
    layers (fusion at 3, dropout 0.1; VQA: a 3-layer answer decoder; NLVR:
    3 + 2 x 3 replicated layers), the teacher 12L / 12L (VQA: a 6-layer
    decoder; NLVR: 6 + 2 x 6); head gates over pairs (grounding: one a
    head, as its config has no head_gate_group), the published lr, sparsity
    and schedules, TASK_UNIT's steps_per_epoch an epoch; VQA and NLVR
    preprocess on the card, captioning's prompt has 4 tokens."""
    from efficientvlm_tpu_torch.config import Config, VisionConfig

    u = TASK_UNIT[task]
    vision = VisionConfig.create(vision_width=768, patch_size=16, hidden_act="quick_gelu",
                                 num_attention_heads=12, attention_dropout=0.0,
                                 intermediate_size=3072, num_hidden_layers=6,
                                 local_attn_depth=2, image_res=u["res"])
    shared = {"image_res": u["res"], "vision": vision, "text_num_hidden_layers": 6,
              "embed_dim": 256, "temp": 0.07, "head_gate_group": 2,
              "batch_size_train": u["batch"],
              "L0_schedular": {"droprate_init": 0.5, "temperature": 0.6667,
                               "lagrangian_warmup_epochs": 1}}

    def schedule(lr: float, epochs: int) -> dict:
        return {"optimizer": {"opt": "adamW", "lr": lr, "reg_learning_rate": 0.01,
                              "weight_decay": 0.01, "lr_mult": 2},
                "schedular": {"sched": "linear", "lr": lr, "epochs": epochs,
                              "num_warmup_steps": 0.1}}

    if task == "vqa":
        return Config({**shared, "num_dec_layers": 3, "max_tokens": 40, "k_test": 128,
                       "sparsity": 0.35, "device_preprocess": True, **schedule(2e-5, 10)})
    if task == "nlvr":  # the images preprocessed on the card
        return Config({**shared, "max_tokens": 40, "sparsity": 0.25, "device_preprocess": True,
                       **schedule(3e-5, 10)})
    if task == "grounding":  # sparsity 0, head gates one a head
        return Config({**shared, "max_tokens": 30, "sparsity": 0.0, "head_gate_group": 1,
                       **schedule(3e-5, 10)})
    return Config({**shared, "max_tokens": 30, "prompt_length": len(CAPTION_UNIT["prompt"]),
                   "label_smoothing": 0.1, "sparsity": 0.25, **schedule(3e-5, 5)})


def vqa_task_batch(rnd) -> dict:
    """8 uint8 images of 512 x 512 (preprocess_train takes them to 480 on the
    card, without the flip), 40-token questions ([CLS] first, PAD past
    lengths of 8-40), 1-7 answers a question (one question has 10; mean
    about 4) of 20 tokens ([CLS], 1-4 words and [SEP], PAD after), weights
    summing to 1 a question, flattened by vqa_collate (answer rows padded to
    a multiple of 8 with weight-0 copies of the first)."""
    import torch

    from efficientvlm_tpu_torch.data.collate import vqa_collate

    u, dev = TASK_UNIT["vqa"], "cuda"
    b, t = u["batch"], u["q_len"]
    pixels = torch.randint(0, 256, (b, u["raw"], u["raw"], 3), generator=rnd.g, device=dev,
                           dtype=torch.uint8)
    q_atts = rnd.mask(b, t, 8)
    q_ids = torch.randint(1000, 30522, (b, t), generator=rnd.g, device=dev)
    q_ids[:, 0] = 101
    q_ids = torch.where(q_atts == 1, q_ids, 0)
    counts = torch.randint(1, 8, (b,), generator=rnd.g, device=dev).tolist()
    counts[1] = u["max_answers"]
    samples, row = [], 0
    for i, n in enumerate(counts):
        w = (torch.rand(n, generator=rnd.g, device=dev) + 0.2).tolist()
        samples.append((i, i, list(range(row, row + n)), [x / sum(w) for x in w]))
        row += n
    _, _, rows, weights, k_index = vqa_collate(samples)
    lens = torch.randint(3, 7, (row,), generator=rnd.g, device=dev)
    a_atts = (torch.arange(u["a_len"], device=dev)[None] < lens[:, None]).to(torch.int32)
    a_ids = torch.randint(1000, 30522, (row, u["a_len"]), generator=rnd.g, device=dev)
    a_ids[:, 0] = 101
    a_ids[torch.arange(row, device=dev), lens - 1] = 102
    a_ids = torch.where(a_atts == 1, a_ids, 0)
    rows = torch.tensor(rows, device=dev)
    return {"image": pixels, "q_ids": q_ids, "q_atts": q_atts, "a_ids": a_ids[rows],
            "a_atts": a_atts[rows], "weights": torch.from_numpy(weights).to(dev),
            "k_index": torch.from_numpy(k_index).to(dev)}


def nlvr_task_batch(rnd) -> dict:
    """16 pairs of uint8 images of 448 x 448 (preprocess_train takes image0
    and then image1 to 384 on the card), 40-token sentences ([CLS] first,
    PAD past lengths of 8-40), labels 0 / 1."""
    import torch

    u, dev = TASK_UNIT["nlvr"], "cuda"
    b, t = u["batch"], u["tokens"]
    pixels = lambda: torch.randint(0, 256, (b, u["raw"], u["raw"], 3), generator=rnd.g,  # noqa
                                   device=dev, dtype=torch.uint8)
    atts = rnd.mask(b, t, 8)
    ids = torch.randint(1000, 30522, (b, t), generator=rnd.g, device=dev)
    ids[:, 0] = 101
    return {"image0": pixels(), "image1": pixels(), "text_ids": torch.where(atts == 1, ids, 0),
            "text_atts": atts,
            "targets": torch.randint(0, 2, (b,), generator=rnd.g, device=dev)}


def grounding_task_batch(rnd) -> dict:
    """16 images at 384 px (bf16; no device preprocessing: the box would
    move with the crop), 30-token referring expressions, target boxes (cx,
    cy, w, h) with centres in [0.25, 0.75] and sides in [0.1, 0.5]."""
    import torch

    u, dev = TASK_UNIT["grounding"], "cuda"
    b, t = u["batch"], u["tokens"]
    atts = rnd.mask(b, t, 4)
    ids = torch.randint(1000, 30522, (b, t), generator=rnd.g, device=dev)
    ids[:, 0] = 101
    centre = torch.rand(b, 2, generator=rnd.g, device=dev) * 0.5 + 0.25
    side = torch.rand(b, 2, generator=rnd.g, device=dev) * 0.4 + 0.1
    return {"image": rnd(b, u["res"], u["res"], 3), "text_ids": torch.where(atts == 1, ids, 0),
            "text_atts": atts, "target_bbox": torch.cat([centre, side], 1)}


def caption_task_batch(rnd) -> dict:
    """16 images at 384 px (bf16; the config has no device preprocessing)
    and 30-token captions: [CLS] and the 3-word prompt first, PAD past
    lengths of 8-30."""
    import torch

    u = TASK_UNIT["captioning"]
    b, t = u["batch"], u["tokens"]
    atts = rnd.mask(b, t, 8)
    ids = torch.randint(1000, 30522, (b, t), generator=rnd.g, device="cuda")
    ids[:, :len(CAPTION_UNIT["prompt"])] = torch.tensor(CAPTION_UNIT["prompt"], device="cuda")
    return {"image": rnd(b, u["res"], u["res"], 3), "caption_ids": torch.where(atts == 1, ids, 0),
            "caption_atts": atts}


TASK_BATCH = {"vqa": vqa_task_batch, "captioning": caption_task_batch, "nlvr": nlvr_task_batch,
              "grounding": grounding_task_batch}


def task_driver(task: str):
    from efficientvlm_tpu_torch.drivers import captioning, grounding, nlvr, vqa

    return {"vqa": vqa, "captioning": captioning, "nlvr": nlvr, "grounding": grounding}[task]


def task_paths(task: str):
    """The config, driver, student, teacher and gates of a task, and one
    (step, state, dtype, optimizers) per path (kernel: impl fused, bf16;
    plain: impl plain, bf16; f32: impl plain, f32 compute), all from one
    init, built by the task's drivers/*.build_step (the VQA step comes in
    DevicePreprocess without the flip, NLVR's over image0 and image1), the
    optimizers by the driver's build_optimizers (NLVR's cls_head at
    lr_mult); a teacher only where the driver's KD_WEIGHT is not 0."""
    import torch

    from efficientvlm_tpu_torch.bridge import cast_floating
    from efficientvlm_tpu_torch.train.steps import init_train_state

    config, drv = task_config(task), task_driver(task)
    u = TASK_UNIT[task]
    student, teacher = drv.build_models(config)
    l0 = drv.build_l0(config)
    l0.lagrangian_warmup = u["steps_per_epoch"]  # lagrangian_warmup_epochs 1
    total = config["schedular"]["epochs"] * u["steps_per_epoch"]
    params, gates = student.init(0, device="cuda"), l0.init(0, device="cuda")
    t_bf16 = (cast_floating(teacher.init(1, device="cuda"), torch.bfloat16)
              if drv.KD_WEIGHT else None)
    paths = {}
    for name, impl, dtype in (("kernel", "fused", torch.bfloat16),
                              ("plain", "plain", torch.bfloat16), ("f32", "plain", None)):
        opts = drv.build_optimizers(params, config, total)
        state = init_train_state(clone_tree(params), clone_tree(gates), opts)
        tparams = t_bf16 if dtype is not None or t_bf16 is None else cast_floating(
            t_bf16, torch.float32)
        step = drv.build_step(config, student, teacher, l0, opts, teacher_params=tparams,
                              dtype=dtype, impl=impl)
        paths[name] = (step, state, dtype, opts)
    return config, drv, student, teacher, l0, t_bf16, paths


def step_parts(step):
    """(preprocess or None, the TaskTrainStep) of a step from drivers/*.build_step."""
    from efficientvlm_tpu_torch.drivers.common import DevicePreprocess

    return (step.preprocess, step.step) if isinstance(step, DevicePreprocess) else (None, step)


def snapshot(trees) -> list:
    import torch

    from efficientvlm_tpu_torch.train.optim import tree_leaves

    return [[t.detach().clone() if isinstance(t, torch.Tensor) else t for t in tree_leaves(x)]
            for x in trees]


def task_steps(task: str, rnd) -> dict:
    """TASK_UNIT[task]["steps"] steps on the kernel, plain and f32 paths from
    one state, the concrete noise and each path's generator (preprocessing
    draws, dropout) alike: exact launches per kernel-path step (the plain and
    f32 paths launch none), finite losses, gradients and params, loga and λ
    moving (λ ascending), the kernel path held to the plain path
    (hold_to_plain); then one stop_prune step on the kernel path with the
    deterministic gates of its trained loga."""
    import torch

    from efficientvlm_tpu_torch.train.optim import tree_leaves

    config, drv, student, teacher, l0, t_bf16, paths = task_paths(task)
    u = TASK_UNIT[task]
    batch = TASK_BATCH[task](rnd)
    if task == "vqa":
        print(f"vqa batch: {u['batch']} questions, {batch['a_ids'].shape[0]} answer rows "
              f"({int((batch['weights'] > 0).sum())} of weight > 0)")
    noises = [{k: torch.rand(g["shape"], generator=rnd.g, device="cuda") * (1 - 2e-6) + 1e-6
               for k, g in l0.groups.items()} for _ in range(u["steps"])]
    results, c = {}, reset_counts()  # the task's run starts here
    for name, (step, state, dtype, _) in paths.items():
        prep, inner = step_parts(step)
        gen = torch.Generator(device="cuda").manual_seed(7)
        b = batch if dtype is not None or prep else dict(batch, image=batch["image"].float())
        loga0, lam0 = snapshot((state.loga, state.lam))
        metrics, first = [], None
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        for i in range(u["steps"]):
            bi = prep(b, gen) if prep else b
            t_out = inner.teacher_forward(bi)
            m, grads = inner.loss_and_grads(state, bi, t_out, gen, noise=noises[i])
            del t_out
            first = grads if first is None else first
            inner.apply(state, grads)
            metrics.append({k: float(v) for k, v in m.items()})
            if name == "kernel":
                c = expect_launches(c, TASK_LAUNCHES[task], f"{task} step {i + 1}")
        if name != "kernel":  # the yardstick paths launch no kernel
            c = expect_launches(c, (), f"{task} {name}")
        torch.cuda.synchronize()
        check(all(math.isfinite(v) for mm in metrics for v in mm.values()),
              f"{task} {name}: non-finite loss")
        check(all(bool(torch.isfinite(g).all()) for g in sum(first, []) if g is not None),
              f"{task} {name}: non-finite gradient")
        check(all(bool(torch.isfinite(t).all()) for t in tree_leaves(state.params)),
              f"{task} {name}: non-finite params")
        dloga = max((a - b_).abs().max().item() for a, b_ in zip(tree_leaves(state.loga), loga0))
        dlam = [(a.detach() - b_).item() for a, b_ in zip(tree_leaves(state.lam), lam0)]
        g_lam1 = first[2][0].item()
        peak = torch.cuda.max_memory_allocated()
        print(f"{task} {name} ({u['steps']} steps, batch {u['batch']}): " + ", ".join(
            f"{k} " + "/".join(f"{mm[k]:.5f}" for mm in metrics) for k in metrics[0]) +
            f"; loga moved {dloga:.3e}, lambda_1/2 moved {dlam[0]:+.3e}/{dlam[1]:+.3e}; peak "
            f"memory {peak / 2 ** 30:.2f} GiB, {(peak - resident) / 2 ** 30:.2f} GiB above the "
            f"{resident / 2 ** 30:.2f} GiB resident when its steps began")
        check(dloga > 0 and all(d != 0 for d in dlam), f"{task} {name}: the gates did not move")
        check(dlam[0] * g_lam1 > 0, f"{task} {name}: lambda_1 did not ascend its gradient")
        results[name] = (metrics, first)
    hold_to_plain(results, u["steps"], ("params", "loga", "lambda"), task)
    del results
    for name in ("plain", "f32"):
        del paths[name]

    # stop_prune: the deterministic gates frozen into the step
    step, state, dtype, opts = paths["kernel"]
    zs = l0.forward_deterministic({"loga": state.loga})
    frozen = drv.build_step(config, student, teacher, l0, opts, teacher_params=t_bf16,
                            frozen_zs=zs, dtype=dtype, impl="fused")
    prep, inner = step_parts(frozen)
    before = snapshot((state.loga, state.lam, state.l0_state, state.lam_state))
    params0 = snapshot((state.params,))[0]
    gen = torch.Generator(device="cuda").manual_seed(9)
    bi = prep(batch, gen) if prep else batch
    m = inner(state, bi, gen)
    c = expect_launches(c, TASK_LAUNCHES[task], f"{task} stop_prune step")
    after = snapshot((state.loga, state.lam, state.l0_state, state.lam_state))
    same = all(torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
               for xs, ys in zip(before, after) for x, y in zip(xs, ys))
    moved = max((a.detach() - b_).abs().max().item()
                for a, b_ in zip(tree_leaves(state.params), params0))
    print(f"{task} stop_prune step: " + ", ".join(f"{k} {float(v):.5f}" for k, v in m.items())
          + f"; loga, lambda and their optimizer states unchanged: {same}; params moved "
          f"{moved:.3e}; sparsity of the frozen gates "
          f"{l0.calculate_model_size(zs)['pruned_model_sparsity']:.4f}")
    check(float(m["lagrangian_loss"]) == 0.0 and same and moved > 0,
          f"{task} stop_prune: the Lagrangian or the gate state moved, or the params did not")
    check(all(math.isfinite(float(v)) for v in m.values()), f"{task} stop_prune: non-finite")
    del params0, before, after
    return {"task": task, "config": config, "student": student, "teacher": teacher,
            "t_bf16": t_bf16, "l0": l0, "step": step,
            "state": state, "batch": batch, "noise": noises[-1], "zs": zs, "counts": c}


def pruned_task_counts(params, fusion: int) -> dict:
    """Sublayers left in a pruned generation student: ViT attention, the
    decoder's self and cross, and with a question stack (VQA) its text /
    fusion self and fusion cross."""
    n = lambda layers, key: sum(lp.get(key) is not None for lp in layers)  # noqa: E731
    dec = params["text_decoder"]["layers"]
    out = {"vit": n(params["vision"]["layers"], "attn"), "dec_self": n(dec, "attention"),
           "dec_cross": n(dec, "crossattention")}
    if "text" in params:
        layers = params["text"]["layers"]
        out.update(text=n(layers[:fusion], "attention"), fself=n(layers[fusion:], "attention"),
                   fcross=n(layers[fusion:], "crossattention"))
    return out


def task_export(run: dict, rnd):
    """forward_deterministic -> prune_xvlm_params with the decoder groups (FFN
    widths multiples of EXPORT_ALIGN), for the trained gates (the stop_prune
    step's) and for gates drawn from a seed: heads and FFN widths, then the
    pruned student's VQA forward_eval (3,128 answers, k 128) or 3-beam
    generate with exact launch counts, held to the gated dense student
    under the same zs: VQA's question states and captioning's
    teacher-forced logits of the pruned student's captions to 5% of the
    largest value (phase_export's tolerance); VQA's ranked probabilities
    (in order; near-ties may swap answers, not the values) to TRAIN_FACTOR
    x the gated dense student's own kernel path's distance from its f32
    compute on the same inputs: bf16 rounding alone moves them by about 5%
    of the largest (a 5% rule failed on the card at 5.7e-3 against 5.6e-3
    with every top-1 answer equal)."""
    import torch

    from efficientvlm_tpu_torch.bridge import cast_floating
    from efficientvlm_tpu_torch.pruning.export import prune_xvlm_params

    bf16 = torch.bfloat16
    task, l0, student, state, batch = (run[k] for k in ("task", "l0", "student", "state",
                                                        "batch"))
    fusion = student.text_cfg["fusion_layer"]
    head_dim = student.text_cfg["hidden_size"] // student.text_cfg["num_attention_heads"]
    drawn = drawn_loga(state, rnd)
    with torch.no_grad():
        dense = cast_floating(state.params, bf16)
    if task == "vqa":
        gen = torch.Generator(device="cuda").manual_seed(13)
        image = step_parts(run["step"])[0](batch, gen)["image"].to(bf16)
        r = Rand(14)
        answers = torch.randint(0, 30522, (VQA_UNIT["answers"], VQA_UNIT["answer_len"]),
                                generator=r.g, device="cuda")
        ans_atts = torch.ones_like(answers, dtype=torch.int32)
        args = (image, batch["q_ids"], batch["q_atts"], answers, ans_atts)
    else:
        prompt = batch["caption_ids"][:, :len(CAPTION_UNIT["prompt"])]
        gen_kw = dict(max_length=CAPTION_UNIT["max_length"], min_length=CAPTION_UNIT["min_length"],
                      eos_id=CAPTION_UNIT["eos_id"], pad_id=CAPTION_UNIT["pad_id"], dtype=bf16)
    launches = None
    for gates_name, loga in (("trained", state.loga), ("drawn", drawn)):
        zs = l0.forward_deterministic({"loga": loga})
        sparsity = l0.calculate_model_size(zs)["pruned_model_sparsity"]
        with torch.no_grad():
            pruned = cast_floating(prune_xvlm_params(state.params, zs, fusion_layer=fusion,
                                                     head_dim=head_dim,
                                                     align_intermediate=EXPORT_ALIGN), bf16)
        n = pruned_task_counts(pruned, fusion)
        heads = lambda a: 0 if a is None else a["q"]["kernel"].shape[1] // head_dim  # noqa
        dec = pruned["text_decoder"]["layers"]
        ffn = [0 if lp.get("intermediate") is None else lp["intermediate"]["kernel"].shape[1]
               for lp in dec]
        print(f"{task} export [{gates_name} gates]: sparsity {sparsity:.4f}; decoder heads "
              f"self {[heads(lp.get('attention')) for lp in dec]} cross "
              f"{[heads(lp.get('crossattention')) for lp in dec]}; decoder FFN {ffn}; "
              f"vision heads {[heads(lp.get('attn')) for lp in pruned['vision']['layers']]}")
        c = reset_counts()
        with torch.inference_mode():
            if task == "vqa":
                ids, probs = student.forward_eval(pruned, *args, k=TASK_UNIT["vqa"]["k"],
                                                  dtype=bf16)
                expect_launches(c, (1, n["vit"] + n["text"] + n["fself"], n["fcross"], 0,
                                    2 * n["dec_self"] + n["dec_cross"], n["dec_cross"]),
                                f"pruned vqa forward_eval [{gates_name}]")
                launches = counts() if launches is None else launches
                k = TASK_UNIT["vqa"]["k"]
                g_ids, g_probs = student.forward_eval(dense, *args, k=k, zs=zs, dtype=bf16)
                # the ranked probabilities' yardstick: the gated dense student's
                # kernel path (the path both sides run) against its f32
                # compute on these inputs; its plain bf16 path's for the record
                plain_probs = student.forward_eval(dense, *args, k=k, zs=zs, dtype=bf16,
                                                   impl="plain")[1].float()
                f32_probs = student.forward_eval(cast_floating(dense, torch.float32),
                                                 args[0].float(), *args[1:], k=k, zs=zs,
                                                 impl="plain")[1].float()
                yard = (g_probs.float() - f32_probs).abs().max().item()
                plain_yard = (plain_probs - f32_probs).abs().max().item()
                q_p = student.encode_question(pruned, *args[:3], dtype=bf16)[0]["last_hidden"]
                q_g = student.encode_question(dense, *args[:3], zs=zs, dtype=bf16)[0][
                    "last_hidden"]
                pairs = {"question_states": (q_p, q_g)}
                same = (ids[:, 0] == g_ids[:, 0]).float().mean().item()
                err = (probs.float() - g_probs.float()).abs().max().item()
                print(f"pruned vqa [{gates_name}] topk_probs: vs gated dense {err:.4e}, tol "
                      f"{TRAIN_FACTOR * yard:.4e} = {TRAIN_FACTOR} x the gated dense student's "
                      f"kernel path vs f32 {yard:.4e} (its plain bf16 path vs f32 "
                      f"{plain_yard:.4e}); top-1 answer as the gated dense student's for "
                      f"{same:.3f} of the questions")
                check(err <= TRAIN_FACTOR * yard, f"pruned vqa [{gates_name}] topk_probs "
                                                  "disagree with the gated dense student's")
            else:
                stats = {}
                tokens = student.generate(pruned, batch["image"], prompt, num_beams=3,
                                          stats=stats, **gen_kw)
                calls = stats["decoder_calls"]
                expect_launches(c, (1, n["vit"], 0, 0, n["dec_self"] * calls,
                                    n["dec_cross"] * calls),
                                f"pruned caption generate [{gates_name}] ({calls} calls)")
                launches = counts() if launches is None else launches
                check(tuple(tokens.shape) == (TASK_UNIT["captioning"]["batch"],
                                              CAPTION_UNIT["max_length"])
                      and bool((tokens[:, :prompt.shape[1]] == prompt).all()),
                      "pruned caption: tokens out of shape or prompt lost")
                atts = torch.ones_like(tokens, dtype=torch.int32)
                pairs = {"replay_logits": (
                    student.forward_logits(pruned, batch["image"], tokens, atts, dtype=bf16),
                    student.forward_logits(dense, batch["image"], tokens, atts, zs=zs,
                                           dtype=bf16))}
                g_tokens = student.generate(dense, batch["image"], prompt, num_beams=3, zs=zs,
                                            **gen_kw)
                print(f"pruned caption [{gates_name}]: identical captions to the gated dense "
                      f"student's {(g_tokens == tokens).all(1).float().mean().item():.3f}")
        for what, (a, g) in pairs.items():
            a, g = a.float(), g.float()
            check(bool(torch.isfinite(a).all()), f"pruned {task} {what} not finite")
            err, tol = (a - g).abs().max().item(), 0.05 * g.abs().max().item()
            print(f"pruned {task} [{gates_name}] {what}: vs gated dense {err:.4e}, tol {tol:.4e}")
            check(err <= tol, f"pruned {task} [{gates_name}] {what} disagrees")
    return launches


def phase_task_train(rnd) -> dict:
    """The VQA and then the captioning pruning fine-tune: task_steps and
    task_export for each; launches summed over both tasks' main paths (the
    checked steps, the stop_prune step and the pruned evaluation of the
    trained gates)."""
    t_phase = time.perf_counter()
    kept, launches = {}, {}
    for task in ("vqa", "captioning"):
        run = task_steps(task, rnd)
        pruned = task_export(run, rnd)
        for k in pruned:
            launches[k] = launches.get(k, 0) + run["counts"][k] + pruned[k]
        kept[task] = {k: run[k] for k in ("step", "state", "batch", "noise")}
        del run
    print(f"phase task train: {time.perf_counter() - t_phase:.1f} s")
    return {"kept": kept, "launches": launches}


def task_probs_cases(rnd):
    """The probs forms at the generation fine-tunes' shapes: #2 over the VQA
    ViT (8 x 901 tokens at 480 px, the maps' rows padded to 904 floats) and
    question stack (8 x 40), the caption ViT (16 x 577); #3 over the
    question fusion (8 x 40 x 901), the VQA answer decoder over gathered
    question states (40 answer rows x 20 x 40, the questions' key masks) and
    the caption decoder (16 x 30 x 577, every key kept)."""
    return [probs_case(rnd, "self", "vqa_vit_b8_t901_h12", 8, 901, 901, 12, 901),
            probs_case(rnd, "self", "vqa_question_b8_t40_h12", 8, 40, 40, 12, 8),
            probs_case(rnd, "self", "caption_vit_b16_t577_h12", 16, 577, 577, 12, 577),
            probs_case(rnd, "cross", "vqa_fusion_b8_tq40_s901_h12", 8, 40, 901, 12, 901),
            probs_case(rnd, "cross", "vqa_decoder_b40_tq20_s40_h12", 40, 20, 40, 12, 8),
            probs_case(rnd, "cross", "caption_decoder_b16_tq30_s577_h12", 16, 30, 577, 12,
                       577)]


def nlvr_probs_cases(rnd):
    """The probs forms at the NLVR teacher's shapes: #2 over the ViT of both
    images (32 x 577) and the replicated text stack (16 x 40); #3 over one
    image of each pair (16 x 40 x 577)."""
    return [probs_case(rnd, "self", "nlvr_vit_b32_t577_h12", 32, 577, 577, 12, 577),
            probs_case(rnd, "self", "nlvr_text_b16_t40_h12", 16, 40, 40, 12, 8),
            probs_case(rnd, "cross", "nlvr_cross_b16_tq40_s577_h12", 16, 40, 577, 12, 577)]


def probs_core_cases(rnd):
    """The probs core on its own, through bindings.attn_core(probs=True)
    (attn_probs where bindings.probs_tile admits the shape), at the training
    paths' long-key shapes, 12 heads, masked key tails: #2p's ViT
    self-attention at [24, 577] (retrieval), [8, 901] (VQA) and [128, 197]
    (GD), #3p's cross-attention at [48, 40] x 577 (retrieval fusion), [8, 40]
    x 901 (VQA question fusion) and [256, 40] x 197 (GD's ITM negatives). As
    (name, case, core call, plain call,
    flops, bytes, mask, library composition, the maps buffer's zero_(),
    (q, k, v, key bias, gates, batch, tq, s)). Bytes: q, k, v, the key bias
    and the output once, and the f32 maps. The library composition (matmul,
    f32 softmax, matmul; scaled_dot_product_attention returns no maps) is
    timed only."""
    import torch

    from efficientvlm_tpu_torch.kernels import bindings as K
    from efficientvlm_tpu_torch.ops import fused_mha as F

    def core_case(case, b, tq, s, h=12):
        a = h * 64
        q, k, v = rnd(b * tq, a), rnd(b * s, a), rnd(b * s, a)
        mask, hz = rnd.mask(b, s, s // 4), rnd.gates(h)
        kb = F._key_bias(b, s, mask, None, q.device)
        maps = torch.empty(b, h, tq, -(-s // 4) * 4, device="cuda")
        split = lambda t, n: t.view(b, n, h, 64).transpose(1, 2)  # noqa: E731

        def lib():
            scores = torch.matmul(split(q, tq), split(k, s).transpose(-1, -2)).float()
            probs = torch.softmax(scores * 0.125 + kb[:, None, None, :], dim=-1)
            ctx = torch.matmul(probs.to(q.dtype), split(v, s)) * hz.to(q.dtype)[:, None, None]
            return ctx.transpose(1, 2).reshape(b * tq, a), probs
        return ("attn_probs", case,
                lambda: K.attn_core(q, k, v, kb, hz, batch=b, tq=tq, s=s, probs=True),
                lambda: F.attn_core_plain(q, k, v, kb, hz, batch=b, tq=tq, s=s, probs=True),
                4 * b * tq * s * a, 2 * (2 * q.numel() + k.numel() + v.numel()) + 4 * b * s
                + 4 * b * h * tq * s, mask, lib, maps.zero_, (q, k, v, kb, hz, b, tq, s))

    return [core_case("vit_b24_t577_h12", 24, 577, 577),
            core_case("vqa_vit_b8_t901_h12", 8, 901, 901),
            core_case("gd_vit_b128_t197_h12", 128, 197, 197),
            core_case("fusion_b48_tq40_s577_h12", 48, 40, 577),
            core_case("vqa_fusion_b8_tq40_s901_h12", 8, 40, 901),
            core_case("gd_itm_neg_b256_tq40_s197_h12", 256, 40, 197)]


def probs_core_times(errs, launches: int, smi: str) -> dict:
    """The probs core alone at probs_core_cases' shapes, all by CUDA events
    (late in this run torch.profiler's device time under-counts, reading the
    maps' zero_() above the card's peak rate): its ms, the maps' write rate
    over that time beside the card's own write rate of the same maps buffer
    (maps.zero_()), the plain version's and the library composition's ms,
    the bound. Returns the kernels line's attn_probs row (its first case)."""
    import torch

    from efficientvlm_tpu_torch.kernels import bindings as K

    row = None
    for name, case, run, plain, flops, nbytes, _, lib, zero, args in probs_core_cases(Rand(5)):
        hz, b, tq, s = args[4:]
        maps_bytes = 4 * b * hz.numel() * tq * s
        with torch.inference_mode():
            ms, zero_ms = timed_pair_ms(run, zero)
            plain_ms, lib_ms = timed_ms(plain), timed_ms(lib)
        bound_ms, bound_by = bound(flops, nbytes)
        print(f"time {name} [{case}]: {ms:.4f} ms, maps at {maps_bytes / ms / 1e6:.1f} GB/s; "
              f"maps.zero_() {zero_ms:.4f} ms = {4 * zero.__self__.numel() / zero_ms / 1e6:.1f} "
              f"GB/s; plain {plain_ms:.4f} ms, library {lib_ms:.4f} ms, bound {bound_ms:.4f} ms "
              f"({bound_by}); tile {'x'.join(map(str, K.probs_tile(64, tq, s)))}; card {smi}")
        if row is None:
            row = {"name": name, "route": "cuda",
                   "source": "efficientvlm_tpu_torch/csrc/attn_probs.cuh",
                   "replaces": "efficientvlm_tpu/ops/pallas_fused_mha.py:119",
                   "launches": launches, "max_abs_err": errs[name], "ms": ms,
                   "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                   "library_ms": lib_ms}
    return row


def device_host(case: str, run) -> str:
    """For a probs case of 40 query tokens or fewer (text, question, answer
    decoder; the case name says tq20 / tq30 / t40 / tq40), where the call is
    mostly host work: its device time and device launches per call and its
    host time per call; '' for the others."""
    import re

    import torch

    if not re.search(r"_tq?(20|30|40)_", case):
        return ""
    with torch.inference_mode():
        us, launches = device_us(run)
        host = host_us(run, calls=50)
    return (f"; device {fmt_us(us)} us/call, "
            f"{'not measured' if launches is None else f'{launches:g}'} device launches/call, "
            f"host {host:.2f} us/call")


def task_times(task_state, smi: str, probs_cases=task_probs_cases):
    """Each task step's ms split into preprocessing (VQA, NLVR), teacher
    forward, student forward + backward and optimizer (host clock,
    synchronised at each boundary, median of 3 steps), samples/s (NLVR:
    pairs), peak memory (the other paths freed) and a profile of one step
    (device idle share, launches), each with the card's name and power
    limit; then #2's and #3's probs forms at the tasks' shapes (probs_cases;
    None: none) beside their bounds, plain versions and a library
    composition."""
    import torch

    for task, kept in task_state["kept"].items():
        prep, inner = step_parts(kept["step"])
        state, batch, noise = kept["state"], kept["batch"], kept["noise"]
        gen = torch.Generator(device="cuda").manual_seed(11)
        torch.cuda.reset_peak_memory_stats()
        parts = [("preprocess", lambda _: prep(batch, gen))] if prep else []
        med = split_ms(parts + [
            ("teacher_forward", lambda b: (b or batch, inner.teacher_forward(b or batch))),
            ("student_forward_backward",
             lambda bt: inner.loss_and_grads(state, bt[0], bt[1], gen, noise=noise)[1]),
            ("optimizer", lambda grads: inner.apply(state, grads))])
        total = sum(med.values())
        samples = TASK_UNIT[task]["batch"]
        print(f"card: {smi}")
        print(json.dumps({f"{task}_step": {
            **{f"{k}_ms": v for k, v in med.items()}, "step_ms": total,
            "samples_per_s": samples / total * 1e3,
            "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30}}))
        profile(f"{task} step b{samples} (kernel path; card {smi})",
                lambda: kept["step"](state, batch, gen, noise=noise), calls=1, top=16)
    for name, case, run, plain, flops, nbytes, _, lib in (probs_cases(Rand(4)) if probs_cases
                                                          else ()):
        with torch.inference_mode():
            ms, plain_ms, lib_ms = timed_ms(run), timed_ms(plain), timed_ms(lib)
        bound_ms, bound_by = bound(flops, nbytes)
        print(f"time {name} [{case}]: {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
              f"{lib_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
              f"{nbytes / ms / 1e6:.1f} GB/s{device_host(case, run)}; card {smi}")


# --------------------------------------------------------------------------
# phase 3e: NLVR2 and visual grounding
# --------------------------------------------------------------------------

NLVR_PRETRAIN_UNIT = dict(batch=64, res=224, tokens=40)
EVAL_SIZE = (640, 480)  # the synthetic referring boxes' image size (width, height)


def hold_outputs(what: str, got, ref, ref32, *, ranked: bool = True):
    """got against ref within TRAIN_FACTOR x ref's own distance from ref32,
    the same function in f32 compute (the yardstick of hold_to_plain and of
    the pruned VQA student); with ranked, the argmax equal on every row
    whose top-two margin in ref exceeds twice got's distance (a closer row
    may swap)."""
    import torch

    got, ref, ref32 = got.float(), ref.float(), ref32.float()
    check(got.shape == ref.shape and bool(torch.isfinite(got).all()),
          f"{what}: shape {tuple(got.shape)} != {tuple(ref.shape)} or not finite")
    err, yard = (got - ref).abs().max().item(), (ref - ref32).abs().max().item()
    tol = TRAIN_FACTOR * yard
    line = (f"{what}: max_abs_err {err:.4e}, tol {tol:.4e} = {TRAIN_FACTOR} x the reference's "
            f"distance from its f32 compute {yard:.4e}")
    same = True
    if ranked:
        top2 = ref.topk(2, dim=-1).values
        clear = (top2[:, 0] - top2[:, 1]) > 2 * err
        agree = got.argmax(-1) == ref.argmax(-1)
        same = bool(agree[clear].all())
        line += (f"; argmax equal on {agree.float().mean().item():.3f} of the rows, on "
                 f"{int(clear.sum())} rows with a clear margin {same}")
    print(line)
    check(err <= tol and same, f"{what} disagrees")


def nlvr_eval(run: dict, rnd) -> dict:
    """The teacher, the gated dense student (the trained deterministic gates)
    and the pruned student (prune_xvlm_params(nlvr=True), FFN widths
    multiples of EXPORT_ALIGN) on the step's 16 pairs through
    preprocess_eval, with exact launch counts; each held to its plain path
    (logits and argmax, hold_outputs, the plain path's f32 compute the
    yardstick), and the pruned student to the gated dense one (the gated
    dense student's f32 compute the yardstick), for the trained gates and for gates drawn from a seed whose
    pair-second layers' head log-alphas are the pair-first layers' negated,
    so every replicated pair keeps other heads; nlvr_accuracy of each; pairs
    per second. Returns the launches of the three evaluations (the trained
    gates' pruned student)."""
    import torch

    from efficientvlm_tpu_torch.bridge import cast_floating
    from efficientvlm_tpu_torch.data.device_pipeline import preprocess_eval
    from efficientvlm_tpu_torch.drivers import nlvr
    from efficientvlm_tpu_torch.evaluation.grounding import nlvr_accuracy
    from efficientvlm_tpu_torch.pruning.export import prune_xvlm_params

    bf16 = torch.bfloat16
    l0, student, teacher, t_bf16, state, batch = (run[k] for k in (
        "l0", "student", "teacher", "t_bf16", "state", "batch"))
    fusion, res = student.num_text_layers, TASK_UNIT["nlvr"]["res"]
    ev32 = dict(batch, **{k: preprocess_eval(batch[k], res) for k in nlvr.IMAGE_KEYS})
    ev = dict(ev32, **{k: ev32[k].to(bf16) for k in nlvr.IMAGE_KEYS})
    targets = batch["targets"].cpu().numpy()
    drawn = drawn_loga(state, rnd)
    for i in range(student.num_cross_layers):  # rows (self, cross) of layers 2i, 2i + 1
        drawn["cross_head"][4 * i + 2:4 * i + 4] = -drawn["cross_head"][4 * i:4 * i + 2]
    with torch.no_grad():
        dense = cast_floating(state.params, bf16)
    zs = l0.forward_deterministic({"loga": state.loga})
    predict = lambda model, params, **kw: nlvr.predict(model, params, ev, dtype=bf16,  # noqa
                                                       **kw)
    # the same function in f32 compute on the plain path (f32 params)
    predict32 = lambda model, params, **kw: nlvr.predict(  # noqa: E731
        model, cast_floating(params, torch.float32), ev32, impl="plain", **kw)
    c = reset_counts()
    logits = {"teacher": predict(teacher, t_bf16)}
    c = expect_launches(c, (1, 30, 12), "nlvr teacher evaluation")
    logits["student"] = predict(student, dense, zs=zs)
    c = expect_launches(c, (1, 15, 6), "nlvr gated dense student evaluation")
    hold_outputs("nlvr teacher logits vs its plain path", logits["teacher"],
                 predict(teacher, t_bf16, impl="plain"), predict32(teacher, t_bf16))
    hold_outputs("nlvr gated dense student logits vs its plain path", logits["student"],
                 predict(student, dense, zs=zs, impl="plain"), predict32(student, dense, zs=zs))
    tput, launches = {}, None
    for gates_name, loga in (("trained", state.loga), ("drawn", drawn)):
        zs = l0.forward_deterministic({"loga": loga})
        pairs_differ = [bool((zs["cross_head_z"][2 * i] != zs["cross_head_z"][2 * i + 1]).any())
                        for i in range(student.num_cross_layers)]
        with torch.no_grad():
            pruned = cast_floating(prune_xvlm_params(
                state.params, zs, fusion_layer=fusion, head_dim=64,
                align_intermediate=EXPORT_ALIGN, nlvr=True), bf16)
        vit, text, fself, fcross = pruned_counts(pruned, fusion)
        heads = lambda a: 0 if a is None else a["q"]["kernel"].shape[1] // 64  # noqa: E731
        layers = pruned["text"]["layers"][fusion:]
        print(f"nlvr export [{gates_name} gates]: sparsity "
              f"{l0.calculate_model_size(zs)['pruned_model_sparsity']:.4f}; replicated heads "
              f"self {[heads(lp.get('attention')) for lp in layers]} cross "
              f"{[heads(lp.get('crossattention')) for lp in layers]}; FFN "
              f"{[0 if lp.get('intermediate') is None else lp['intermediate']['kernel'].shape[1] for lp in layers]}; "  # noqa: E501
              f"the layers of each pair gated apart: {pairs_differ}")
        if gates_name == "drawn":
            check(all(pairs_differ), "nlvr drawn gates: a replicated pair gated alike")
        c = reset_counts() if launches is not None else c
        got = predict(student, pruned)
        c = expect_launches(c, (1, vit + text + fself, fcross),
                            f"nlvr pruned student evaluation [{gates_name}]")
        launches = counts() if launches is None else launches
        gated32 = predict32(student, dense, zs=zs)
        hold_outputs(f"nlvr pruned student [{gates_name}] vs gated dense", got,
                     predict(student, dense, zs=zs), gated32)
        plain = predict(student, pruned, impl="plain")
        hold_outputs(f"nlvr pruned student [{gates_name}] vs its plain path", got, plain,
                     predict32(student, pruned))
        if gates_name == "trained":
            logits["pruned"] = got
            with torch.inference_mode():
                for name, model, params, kw in (("teacher", teacher, t_bf16, {}),
                                                ("student", student, dense, {"zs": zs}),
                                                ("pruned_student", student, pruned, {})):
                    ms = timed_ms(lambda: predict(model, params, **kw), iters=5)
                    tput[f"{name}_pairs_per_s"] = TASK_UNIT["nlvr"]["batch"] / ms * 1e3
    acc = {k: nlvr_accuracy(v.float().cpu().numpy(), targets) for k, v in logits.items()}
    check(all(0.0 <= a <= 100.0 for a in acc.values()), f"nlvr_accuracy out of range {acc}")
    print(json.dumps({"nlvr_eval": {"accuracy_random_weights": acc, **tput}}))
    return launches


def nlvr_pretrain(rnd) -> dict:
    """One XVLMForNLVRPretraining pass (the student's towers at 224 px, batch
    64, 40 tokens) with the negatives (a derangement) and the 3-way labels
    pinned, exact launches; the replicated stack's last hidden state and
    the ta_head logits held to the plain path (hold_outputs: TRAIN_FACTOR x
    the plain path's distance from its f32 compute), and the loss with the
    generator's own draws finite. Returns the kernel path's launches."""
    import torch

    from efficientvlm_tpu_torch.bridge import cast_floating
    from efficientvlm_tpu_torch.config import Config, TextConfig, VisionConfig
    from efficientvlm_tpu_torch.models.model_nlvr import XVLMForNLVRPretraining

    u, bf16 = NLVR_PRETRAIN_UNIT, torch.bfloat16
    vision = VisionConfig.create(num_hidden_layers=6, local_attn_depth=2, image_res=u["res"])
    model = XVLMForNLVRPretraining(vision, TextConfig.create(num_hidden_layers=6),
                                   Config({"embed_dim": 256}))
    params = cast_floating(model.init(3, device="cuda"), bf16)
    b, t = u["batch"], u["tokens"]
    image, atts = rnd(b, u["res"], u["res"], 3), rnd.mask(b, t, 8)
    ids = torch.randint(1000, 30522, (b, t), generator=rnd.g, device="cuda")
    ids = torch.where(atts == 1, ids, 0)
    ar = torch.arange(b, device="cuda")
    noise = {"neg_idx": (ar + torch.randint(1, b, (b,), generator=rnd.g, device="cuda")) % b,
             "labels": torch.randint(0, 3, (b,), generator=rnd.g, device="cuda")}
    with torch.inference_mode():
        c = reset_counts()
        hidden, pred, _ = model.pair_forward(params, image, ids, atts, noise=noise, dtype=bf16)
        expect_launches(c, (1, 15, 6), "nlvr pretraining pass")
        launches = counts()
        plain = model.pair_forward(params, image, ids, atts, noise=noise, dtype=bf16,
                                   impl="plain")
        f32 = model.pair_forward(cast_floating(params, torch.float32), image.float(), ids, atts,
                                 noise=noise, impl="plain")
        drawn = model.forward_pretrain(params, image, ids, atts, dtype=bf16,
                                       generator=torch.Generator(device="cuda").manual_seed(21))
    hold_outputs("nlvr pretraining last hidden state vs the plain path", hidden, plain[0],
                 f32[0], ranked=False)
    hold_outputs("nlvr pretraining ta_head logits vs the plain path", pred, plain[1], f32[1])
    loss = float(torch.nn.functional.cross_entropy(pred.float(), noise["labels"]))
    drawn = float(drawn)
    print(f"nlvr pretraining loss (b{b}, {u['res']} px): kernel {loss:.5f}, with the "
          f"generator's draws {drawn:.5f}; ln 3 = {math.log(3):.5f}")
    check(math.isfinite(loss) and math.isfinite(drawn), "nlvr pretraining loss not finite")
    return launches


def phase_nlvr(rnd) -> dict:
    """The NLVR2 pruning fine-tune (task_steps: three steps on the kernel,
    plain and f32 paths, the kernel path held to the plain one, a stop_prune
    step), its evaluation and export (nlvr_eval) and one domain pretraining
    loss (nlvr_pretrain); launches summed over those main paths."""
    t_phase = time.perf_counter()
    run = task_steps("nlvr", rnd)
    ev, pre = nlvr_eval(run, rnd), nlvr_pretrain(rnd)
    launches = {k: run["counts"][k] + ev[k] + pre[k] for k in ev}
    print(f"phase nlvr: {time.perf_counter() - t_phase:.1f} s")
    return {"kept": {"nlvr": {k: run[k] for k in ("step", "state", "batch", "noise")}},
            "launches": launches}


def phase_grounding(rnd) -> dict:
    """The grounding fine-tune (task_steps, as phase_nlvr) and the gated
    student's evaluation with exact launches, its boxes held to the plain
    path (hold_outputs) and scored by grounding_eval_bbox against the batch's targets as
    pixel boxes; images per second."""
    import torch

    from efficientvlm_tpu_torch.bridge import cast_floating
    from efficientvlm_tpu_torch.drivers import grounding
    from efficientvlm_tpu_torch.evaluation.grounding import grounding_eval_bbox

    t_phase = time.perf_counter()
    run = task_steps("grounding", rnd)
    l0, student, state, batch = (run[k] for k in ("l0", "student", "state", "batch"))
    bf16 = torch.bfloat16
    zs = l0.forward_deterministic({"loga": state.loga})
    with torch.no_grad():
        dense = cast_floating(state.params, bf16)
    c = reset_counts()
    coords = grounding.predict(student, dense, batch, zs=zs, dtype=bf16)
    expect_launches(c, (1, 12, 3), "grounding evaluation")
    launches = counts()
    hold_outputs("grounding boxes vs the plain path", coords,
                 grounding.predict(student, dense, batch, zs=zs, dtype=bf16, impl="plain"),
                 grounding.predict(student, cast_floating(dense, torch.float32),
                                   dict(batch, image=batch["image"].float()), zs=zs,
                                   impl="plain"), ranked=False)
    check(tuple(coords.shape) == (TASK_UNIT["grounding"]["batch"], 4)
          and bool(((coords > 0) & (coords < 1)).all()), "grounding boxes out of (0, 1)")
    w, h = EVAL_SIZE
    results, boxes, splits = [], {}, {}
    for i, (pred, tgt) in enumerate(zip(coords.float().tolist(),
                                        batch["target_bbox"].float().tolist())):
        results.append({"ref_id": i, "pred": pred, "width": w, "height": h})
        boxes[i] = [(tgt[0] - tgt[2] / 2) * w, (tgt[1] - tgt[3] / 2) * h, tgt[2] * w, tgt[3] * h]
        splits[i] = ("val", "testA", "testB")[i % 3]
    acc = grounding_eval_bbox(results, boxes, splits)
    check(all(0.0 <= a <= 100.0 for a in acc.values()), f"grounding accuracy {acc}")
    with torch.inference_mode():
        ms = timed_ms(lambda: grounding.predict(student, dense, batch, zs=zs, dtype=bf16),
                      iters=5)
    print(json.dumps({"grounding_eval": {"accuracy_random_weights": acc,
                                         "student_images_per_s":
                                             TASK_UNIT["grounding"]["batch"] / ms * 1e3}}))
    launches = {k: run["counts"][k] + launches[k] for k in launches}
    print(f"phase grounding: {time.perf_counter() - t_phase:.1f} s")
    return {"kept": {"grounding": {k: run[k] for k in ("step", "state", "batch", "noise")}},
            "launches": launches}


# --------------------------------------------------------------------------
# phase 3b: the paths fed from files on disk
# --------------------------------------------------------------------------

DATA_UNIT = dict(vocab=30522, raw=(640, 480), train_images=48, captions=5, batch=24, steps=3,
                 loaded_batches=6, workers=4, eval_images=128, eval_batch=32, k_test=128,
                 vqa_questions=16, vqa_answers=3128, vqa_res=480, caption_images=16,
                 caption_res=384, gd_records=136, batch_timeout=120.0)
DATA_WORDS = ("a an the of in on with and two three man woman person people dog cat horse "
              "bird train bus car truck bike table bench chair bed street field beach grass "
              "water kitchen plate pizza cake ball frisbee kite umbrella sign clock red blue "
              "green white black yellow brown small large young old sitting standing riding "
              "holding playing eating walking looking flying parked next near front top "
              "picture photo image what where who how many color is are yes no left right "
              "sky tree building room window door wall snow wave board surf skate").split()
DATA_PROMPT = "a picture of "


def data_caption(rng, n_words=(5, 12)) -> str:
    """A caption of DATA_WORDS (the corpus's words, so that most tokens are
    in the vocab)."""
    words = rng.choice(DATA_WORDS, rng.integers(*n_words))
    return " ".join(words).capitalize() + rng.choice([".", "", "!"])


def data_image(rng, w: int, h: int, noise):
    """A textured uint8 RGB image (a gradient at a random angle, stripes at
    random frequencies, the int16 noise [h', w', 3] at a random offset):
    JPEG sizes and decode work as of a photograph, not of a flat colour."""
    import numpy as np

    x = np.arange(w, dtype=np.float32)[None, :]
    y = np.arange(h, dtype=np.float32)[:, None]
    a, b = rng.uniform(-0.5, 0.5, 2)
    fx, fy = rng.uniform(0.02, 0.3, 2)
    sx, cy = np.sin(fx * x), np.cos(fy * y)
    img = np.empty((h, w, 3), np.int16)
    img[..., 0] = (a * x + b * y) % 256
    img[..., 1] = 127 + 60 * sx + 60 * cy
    img[..., 2] = 127 + 120 * sx * cy
    oy, ox = rng.integers(0, noise.shape[0] - h + 1), rng.integers(0, noise.shape[1] - w + 1)
    img += noise[oy:oy + h, ox:ox + w]
    return np.clip(img, 0, 255).astype(np.uint8)


def write_data_corpus(root: str, rng) -> dict:
    """The files of phase_data under `root`: eval_images JPEGs of raw size
    (COCO-style names, so CaptioningEvalDataset reads an id off each), a
    30,522-entry vocab (make_test_vocab's specials and pieces, DATA_WORDS,
    then filler entries), the retrieval train / eval annotations, the VQA
    test questions, answer list and annotators' answers, the caption
    references and one pretraining JSONL shard of base64 JPEGs."""
    import base64
    import io

    import numpy as np
    from PIL import Image

    from efficientvlm_tpu_torch.data.tokenizer import make_test_vocab
    from efficientvlm_tpu_torch.data.utils import write_jsonl

    u = DATA_UNIT
    names, blobs = [], []
    w, h = u["raw"]
    noise = rng.integers(-12, 13, (h + 64, w + 64, 3), dtype=np.int16)
    for i in range(u["eval_images"]):
        buf = io.BytesIO()
        Image.fromarray(data_image(rng, w, h, noise)).save(buf, "JPEG", quality=85)
        names.append(f"COCO_val2014_{i + 1:012d}.jpg")
        blobs.append(buf.getvalue())
        with open(os.path.join(root, names[-1]), "wb") as f:
            f.write(blobs[-1])
    vocab = list(make_test_vocab(DATA_WORDS))
    vocab += [f"[unused{i}]" for i in range(u["vocab"] - len(vocab))]
    files = {"root": root, "vocab": os.path.join(root, "vocab.txt")}
    with open(files["vocab"], "w") as f:
        f.write("\n".join(vocab) + "\n")

    def dump(name, obj):
        files[name] = os.path.join(root, f"{name}.json")
        with open(files[name], "w") as f:
            json.dump(obj, f)

    captions = [[data_caption(rng) for _ in range(u["captions"])] for _ in names]
    dump("retrieval_train", [{"image": names[i], "caption": c, "image_id": i}
                             for i in range(u["train_images"]) for c in captions[i]])
    dump("retrieval_eval", [{"image": n, "caption": c} for n, c in zip(names, captions)])
    answers = list(dict.fromkeys(" ".join(rng.choice(DATA_WORDS, rng.integers(1, 4)))
                                 for _ in range(4 * u["vqa_answers"])))[:u["vqa_answers"]]
    dump("answer_list", answers)
    q = u["vqa_questions"]
    dump("vqa_test", [{"image": names[i], "question": f"what is {data_caption(rng, (2, 6))}?",
                       "question_id": 1000 + i} for i in range(q)])
    dump("vqa_annotations", {1000 + i: [answers[k] for k in rng.integers(0, 40, 10)]
                             for i in range(q)})
    dump("caption_eval", [{"image": n} for n in names[:u["caption_images"]]])
    dump("caption_refs", [{"image_id": i + 1, "caption": c}
                          for i in range(u["caption_images"]) for c in captions[i]])
    shard = [{"binary": base64.b64encode(blobs[i % len(blobs)]).decode(),
              "caption": captions[i % len(blobs)] if i % 2 else captions[i % len(blobs)][0]}
             for i in range(u["gd_records"])]
    files["gd_shard"] = os.path.join(root, "pretrain-00000.jsonl")
    write_jsonl(shard, files["gd_shard"])
    return files


def loader_rates(dataset, smi: str) -> dict:
    """Images per second of the host loaders over one epoch of the
    retrieval train set (240 samples, 10 batches): one process
    (SimpleLoader), ParallelMapLoader (threads) and ProcessMapLoader
    (spawned processes, each batch's wait bounded); `images_per_s` over the
    epoch (a pool's start included), `first_batch_s` the wait for the first
    batch, `steady_per_s` over the batches after the first loaded_batches
    (once the loaders' in-flight window, workers + 2 batches, has filled)."""
    from efficientvlm_tpu_torch.data.datasets import SimpleLoader
    from efficientvlm_tpu_torch.data.prefetch import ParallelMapLoader, ProcessMapLoader

    u = DATA_UNIT
    w, skip = u["workers"], u["loaded_batches"]

    def base():
        return SimpleLoader(dataset, batch_size=u["batch"], shuffle=True, drop_last=True)

    rates = {}
    for name, loader in (("1_process", base()), (f"{w}_threads", ParallelMapLoader(base(), w)),
                         (f"{w}_processes", ProcessMapLoader(base(), w,
                                                             batch_timeout=u["batch_timeout"]))):
        t0 = time.perf_counter()
        arrived = []
        for batch in loader:
            arrived.append(time.perf_counter() - t0)
            check(batch[0].shape == (u["batch"], 384, 384, 3), f"loader {name}: batch shape")
        n = len(arrived)
        check(n > skip, f"loader {name}: {n} batches")
        rates[name] = r = {"images_per_s": n * u["batch"] / arrived[-1],
                           "first_batch_s": arrived[0],
                           "steady_per_s": (n - skip) * u["batch"]
                           / (arrived[-1] - arrived[skip - 1])}
        print(f"host loader {name}, retrieval train set (ImageTransform.train(384) from "
              f"{u['raw'][0]} x {u['raw'][1]} JPEGs), {n} batches of {u['batch']}: "
              f"{r['images_per_s']:.1f} images/s (first batch {r['first_batch_s']:.2f} s; "
              f"batches {skip + 1}-{n}: {r['steady_per_s']:.1f} images/s); "
              f"{os.cpu_count()} host cores; card {smi}", flush=True)
    return rates


def host_split(dataset, tokenizer) -> dict:
    """Host ms of one batch of the retrieval train set, by part: decode
    (open_image), augmentation (ImageTransform: crop, flip, RandAugment,
    normalise), tokenizing (pre_caption + the tokenizer) and collation."""
    from efficientvlm_tpu_torch.data.datasets import default_collate, open_image
    from efficientvlm_tpu_torch.data.utils import pre_caption

    u = DATA_UNIT
    ms = dict.fromkeys(("decode", "augmentation", "tokenizing", "collation"), 0.0)
    samples, captions = [], []
    for ann in dataset.ann[:u["batch"]]:
        t0 = time.perf_counter()
        img = open_image(ann["image"], is_path=True, image_root=dataset.image_root)
        t1 = time.perf_counter()
        pixels = dataset.transform(img)
        t2 = time.perf_counter()
        captions.append(pre_caption(ann["caption"], dataset.max_words))
        ms["decode"] += (t1 - t0) * 1e3
        ms["augmentation"] += (t2 - t1) * 1e3
        ms["tokenizing"] += (time.perf_counter() - t2) * 1e3
        samples.append((pixels, captions[-1], dataset.img_ids[ann["image_id"]]))
    t0 = time.perf_counter()
    tokenizer(captions, padding="longest", truncation=True, max_length=40)
    t1 = time.perf_counter()
    default_collate(samples)
    ms["tokenizing"] += (t1 - t0) * 1e3
    ms["collation"] = (time.perf_counter() - t1) * 1e3
    return ms


def data_retrieval_train(files, tokenizer, smi: str, c: dict):
    """The retrieval fine-tune's kernel path fed by RetrievalTrainDataset +
    ImageTransform.train(384) + SimpleLoader at b24, batches made as the
    driver makes them (the tokenizer at padding "longest", 40 tokens): the
    host loaders' images/s and the host split of a batch, then
    DATA_UNIT["steps"] steps with phase_train's launches, finite losses and
    the step's samples/s."""
    import torch

    from efficientvlm_tpu_torch.bridge import cast_floating
    from efficientvlm_tpu_torch.data.datasets import RetrievalTrainDataset, SimpleLoader
    from efficientvlm_tpu_torch.data.transforms import ImageTransform
    from efficientvlm_tpu_torch.drivers.common import build_optimizers
    from efficientvlm_tpu_torch.drivers.retrieval import build_l0, build_models
    from efficientvlm_tpu_torch.train.steps import init_train_state, make_retrieval_train_step

    u = DATA_UNIT
    dataset = RetrievalTrainDataset(files["retrieval_train"], ImageTransform.train(384, seed=0),
                                    files["root"], max_words=40)
    rates = loader_rates(dataset, smi)
    split = host_split(dataset, tokenizer)
    print(f"host ms a batch of {u['batch']}: " + ", ".join(f"{k} {v:.1f}"
                                                           for k, v in split.items()))
    config = train_config()
    student, teacher = build_models(config)
    l0 = build_l0(config)
    params, gates = student.init(0, device="cuda"), l0.init(0, device="cuda")
    opts = build_optimizers(params, config,
                            config["schedular"]["epochs"] * TRAIN_UNIT["steps_per_epoch"])
    state = init_train_state(params, gates, opts)
    step = make_retrieval_train_step(
        student, teacher, l0, opts, dtype=torch.bfloat16, impl="fused",
        teacher_params=cast_floating(teacher.init(1, device="cuda"), torch.bfloat16))
    gen = torch.Generator(device="cuda").manual_seed(7)
    loader = SimpleLoader(dataset, batch_size=u["batch"], shuffle=True, drop_last=True)
    metrics, times = [], []
    for i, (images, captions, idx) in enumerate(loader):
        if i == u["steps"]:
            break
        tok = tokenizer(list(captions), padding="longest", truncation=True, max_length=40)
        batch = {"image": torch.from_numpy(images).cuda(),
                 "text_ids": torch.from_numpy(tok["input_ids"]).long().cuda(),
                 "text_atts": torch.from_numpy(tok["attention_mask"]).cuda(),
                 "idx": torch.from_numpy(idx).cuda()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = step(state, batch, gen)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        metrics.append({k: float(v) for k, v in m.items()})
        c = expect_launches(c, (2, 0, 0, 0, 0, 0, 36, 12), f"retrieval step {i + 1} from files")
    check(len(metrics) == u["steps"] and all(math.isfinite(v) for m in metrics
                                             for v in m.values()),
          "retrieval from files: a non-finite loss or too few batches")
    step_ms = statistics.median(times) * 1e3
    print(f"retrieval steps from files (b{u['batch']}, {tok['input_ids'].shape[1]} tokens at "
          f"padding longest): " + ", ".join(f"{k} " + "/".join(f"{m[k]:.4f}" for m in metrics)
                                            for k in metrics[0]) +
          f"; step {step_ms:.1f} ms median, {u['batch'] / step_ms * 1e3:.1f} samples/s")
    return {"student": student, "state": state, "l0": l0}, {
        "loader_images_per_s": rates, "host_ms_per_batch": split, "step_ms": step_ms,
        "step_samples_per_s": u["batch"] / step_ms * 1e3}, c


def data_retrieval_eval(files, tokenizer, run: dict, c: dict):
    """RetrievalEvalDataset (eval_images x 5 captions, ImageTransform.test
    at 384) through the trained student's encoders, retrieval_scores
    (k_test 128) and itm_eval, as the driver's evaluate does, on the kernel
    path and the plain path (the same f32 params, bf16 compute, the
    deterministic gates), held as phase 3 holds them: the ITC features
    within 5% of the plain path's largest, every row's k_test entries
    filled, finite scores, itm_eval in range; both paths' R@1/5/10."""
    import numpy as np
    import torch

    from efficientvlm_tpu_torch.data.datasets import RetrievalEvalDataset, SimpleLoader
    from efficientvlm_tpu_torch.data.prefetch import ParallelMapLoader
    from efficientvlm_tpu_torch.data.transforms import ImageTransform
    from efficientvlm_tpu_torch.evaluation import retrieval as R

    u = DATA_UNIT
    dataset = RetrievalEvalDataset(files["retrieval_eval"], ImageTransform.test(384),
                                   files["root"], max_words=40)
    images = [b[0] for b in ParallelMapLoader(SimpleLoader(dataset, batch_size=u["eval_batch"]),
                                              u["workers"])]
    tok = tokenizer(dataset.text, padding="max_length", truncation=True, max_length=40)
    model, params = run["student"], run["state"].params
    zs = run["l0"].forward_deterministic({"loga": run["state"].loga})
    n_img, n_txt = len(dataset), len(dataset.text)
    out = {}
    for impl in ("fused", "plain"):
        t0 = time.perf_counter()
        kw = dict(zs=zs, dtype=torch.bfloat16, impl=impl)
        text_feats, text_embeds = R.encode_texts(model, params, tok["input_ids"],
                                                 tok["attention_mask"], **kw)
        image_feats, image_embeds = R.encode_images(model, params, images, **kw)
        s_i2t, s_t2i = R.retrieval_scores(model, params, image_feats, image_embeds, text_feats,
                                          tok["attention_mask"], text_embeds,
                                          k_test=u["k_test"], **kw)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        if impl == "fused":
            chunks_i2t, chunks_t2i = n_img // 4, n_txt // 4
            text_batches = -(-n_txt // 256)
            c = expect_launches(c, (len(images), 6 * len(images) + 3 * text_batches
                                    + 3 * (chunks_i2t + chunks_t2i), 3 * chunks_t2i,
                                    3 * chunks_i2t), "retrieval evaluation from files")
        else:
            c = expect_launches(c, (), "retrieval evaluation from files, plain path")
        check(bool(np.isfinite(s_i2t).all() and np.isfinite(s_t2i).all()),
              f"retrieval eval {impl}: scores not finite")
        metrics = R.itm_eval(s_i2t, s_t2i, dataset.txt2img, dataset.img2txt)
        check(all(0.0 <= v <= 100.0 for v in metrics.values()), f"itm_eval out of range {metrics}")
        out[impl] = (text_embeds, image_embeds, s_i2t, s_t2i, metrics, seconds)
    for j, name in enumerate(("text_embeds", "image_embeds")):
        a, b = out["fused"][j], out["plain"][j]
        err, tol = float(np.abs(a - b).max()), 0.05 * float(np.abs(b).max())
        print(f"retrieval eval from files, {name} kernel vs plain: max_abs_err {err:.4e} "
              f"tol {tol:.4e}")
        check(err <= tol, f"retrieval eval from files: {name} disagree")
    for j, name, k in ((2, "i2t", min(u["k_test"], n_txt)), (3, "t2i", min(u["k_test"], n_img))):
        a, b = out["fused"][j], out["plain"][j]
        for impl, s in (("kernel", a), ("plain", b)):
            check(bool(((s > -100).sum(1) == k).all()),
                  f"retrieval eval from files: the {impl} path's {name} rerank filled the wrong "
                  "entries")
        both = (a > -100) & (b > -100)
        print(f"retrieval eval from files, {name} scores kernel vs plain on the {int(both.sum())}"
              f" pairs both reranked (of {int((b > -100).sum())}): max_abs_diff "
              f"{float(np.abs(a - b)[both].max()):.4e}, largest |score| "
              f"{float(np.abs(b[both]).max()):.4e}")
    for impl in ("fused", "plain"):
        m, seconds = out[impl][4], out[impl][5]
        print(f"retrieval eval from files ({n_img} images x {n_txt} texts, k_test "
              f"{u['k_test']}), {impl} path: " + ", ".join(
                  f"{k} {m[k]:.2f}" for k in ("txt_r1", "txt_r5", "txt_r10", "img_r1",
                                              "img_r5", "img_r10")) + f"; {seconds:.2f} s")
    return {"fused_s": out["fused"][5], "plain_s": out["plain"][5],
            "r_mean": {k: v[4]["r_mean"] for k, v in out.items()}}, c


def data_vqa_caption(files, tokenizer, c: dict):
    """VQA: VQADataset in test mode (16 questions at 480) -> forward_eval's
    ranking over the answer list (each answer + "[SEP]", as the driver
    tokenizes it) -> vqa_accuracy against the annotators' answers;
    captioning: CaptioningEvalDataset (16 images at 384) -> 3-beam generate
    from the prompt -> tokenizer.decode -> coco_caption_eval. Both on the
    student (6L) at random weights on the kernel and plain paths: exact
    launches, and equal strings scoring equally."""
    import numpy as np
    import torch

    from efficientvlm_tpu_torch.data.datasets import (CaptioningEvalDataset, SimpleLoader,
                                                      VQADataset)
    from efficientvlm_tpu_torch.data.transforms import ImageTransform
    from efficientvlm_tpu_torch.evaluation.caption_metrics import CiderD, coco_caption_eval
    from efficientvlm_tpu_torch.evaluation.vqa import vqa_accuracy, vqa_accuracy_breakdown

    u, bf16 = DATA_UNIT, torch.bfloat16
    out = {}
    # VQA
    dataset = VQADataset(files["vqa_test"], ImageTransform.test(u["vqa_res"]), files["root"],
                         split="test", answer_list=files["answer_list"])
    with open(files["vqa_annotations"]) as f:
        annotations = {int(k): v for k, v in json.load(f).items()}
    images, questions, qids = next(iter(SimpleLoader(dataset, batch_size=u["vqa_questions"])))
    ans = tokenizer([a + "[SEP]" for a in dataset.answer_list], padding="longest",
                    truncation=True, max_length=20)
    q = tokenizer(list(questions), padding="max_length", truncation=True, max_length=40)
    model, params = build_generation("vqa", 6)
    args = [torch.from_numpy(x).cuda() for x in (images, q["input_ids"], q["attention_mask"],
                                                  ans["input_ids"], ans["attention_mask"])]
    args[1], args[3] = args[1].long(), args[3].long()
    results = {}
    with torch.inference_mode():
        for impl in ("fused", "plain"):
            ids, probs = model.forward_eval(params, *args, k=u["k_test"], dtype=bf16, impl=impl)
            c = expect_launches(c, (1, 12, 3, 0, 9, 3) if impl == "fused" else (),
                                f"vqa forward_eval from files, {impl}")
            check(bool(torch.isfinite(probs.float()).all()), f"vqa {impl}: probs not finite")
            results[impl] = [{"question_id": int(qid), "answer": dataset.answer_list[int(a)]}
                             for qid, a in zip(qids, ids[:, 0].tolist())]
    del model, params
    per_q = {impl: vqa_accuracy_breakdown(r, annotations, n=12)["evalQA"]
             for impl, r in results.items()}
    same = [r["question_id"] for r, p in zip(results["fused"], results["plain"])
            if r["answer"] == p["answer"]]
    check(all(per_q["fused"][qid] == per_q["plain"][qid] for qid in same),
          "vqa: equal answers scored differently")
    out["vqa"] = {impl: vqa_accuracy(r, annotations) for impl, r in results.items()}
    print(f"vqa from files ({len(qids)} questions at {u['vqa_res']}, {len(dataset.answer_list)} "
          f"answers, k {u['k_test']}): accuracy kernel {out['vqa']['fused']:.2f} / plain "
          f"{out['vqa']['plain']:.2f}; {len(same)} of {len(qids)} answers equal")
    # captioning
    dataset = CaptioningEvalDataset(files["caption_eval"], ImageTransform.test(u["caption_res"]),
                                    files["root"])
    with open(files["caption_refs"]) as f:
        refs = json.load(f)
    images, image_ids = next(iter(SimpleLoader(dataset, batch_size=u["caption_images"])))
    prompt = tokenizer([DATA_PROMPT])["input_ids"][:, :-1]
    prompt_ids = torch.from_numpy(np.repeat(prompt, len(image_ids), 0)).long().cuda()
    model, params = build_generation("caption", 6)
    captions = {}
    with torch.inference_mode():
        for impl in ("fused", "plain"):
            stats = {}
            tokens = model.generate(params, torch.from_numpy(images).cuda(), prompt_ids,
                                    num_beams=3, max_length=20, min_length=5,
                                    eos_id=tokenizer.sep_token_id, pad_id=tokenizer.pad_token_id,
                                    dtype=bf16, impl=impl, stats=stats)
            n = stats["decoder_calls"]
            c = expect_launches(c, (1, 6, 0, 0, 6 * n, 3 * n) if impl == "fused" else (),
                                f"caption generate from files, {impl} ({n} decoder calls)")
            texts = []
            for toks in tokens.cpu().numpy():
                text = tokenizer.decode(toks, skip_special_tokens=True)
                p = DATA_PROMPT.strip()
                texts.append(text[len(p):].strip() if text.startswith(p) else text)
            captions[impl] = [{"image_id": int(i), "caption": t}
                              for i, t in zip(image_ids, texts)]
    del model, params
    out["caption"] = {impl: coco_caption_eval(refs, r) for impl, r in captions.items()}
    gts = {}
    for r in refs:
        gts.setdefault(r["image_id"], []).append(r["caption"])
    per_image = {}
    for impl, res in captions.items():
        hyps = {r["image_id"]: [r["caption"]] for r in res}
        per_image[impl] = dict(zip(hyps, CiderD().compute_score(gts, hyps)[1]))
    same = [a["image_id"] for a, b in zip(captions["fused"], captions["plain"])
            if a["caption"] == b["caption"]]
    check(all(per_image["fused"][i] == per_image["plain"][i] for i in same),
          "captioning: equal captions scored differently")
    if len(same) == len(image_ids):
        check(out["caption"]["fused"] == out["caption"]["plain"],
              "captioning: equal captions, different metrics")
    for impl in ("fused", "plain"):
        m = out["caption"][impl]
        print(f"captioning from files ({len(image_ids)} images at {u['caption_res']}, 3 beams), "
              f"{impl} path: " + ", ".join(f"{k} {m[k]:.4f}" for k in (
                  "Bleu_4", "CIDEr", "ROUGE_L", "METEOR")) + f"; e.g. "
              f"{captions[impl][0]['caption']!r}")
    print(f"captioning from files: {len(same)} of {len(image_ids)} captions equal on the two "
          f"paths")
    return out, c


def data_gd(files, tokenizer, c: dict):
    """One GD general step at b128 from the pretraining shard: one record
    decoded first (a stream whose records all fail would never yield),
    then PretrainImageTextDataset(transform=ImageTransform.uint8(224)) over
    one pass of the shard (no repeat: the wait ends with the shard), its
    TextMaskingGenerator's masks, and the general step through GD's
    DevicePreprocess (crop area in (0.2, 1.0), RandAugment over the 10
    reference ops): the draw's op histogram, exact launches, finite
    losses."""
    import numpy as np
    import torch

    from efficientvlm_tpu_torch.data import device_pipeline as P
    from efficientvlm_tpu_torch.data.datasets import PretrainImageTextDataset
    from efficientvlm_tpu_torch.data.transforms import ImageTransform
    from efficientvlm_tpu_torch.data.utils import read_jsonl

    u, g = DATA_UNIT, GD_UNIT
    config = gd_config()

    def dataset():
        return PretrainImageTextDataset(config, files["gd_shard"], tokenizer, repeat=False,
                                        transform=ImageTransform.uint8(g["res"]), seed=3)

    first = dataset().sample(read_jsonl(files["gd_shard"])[0])
    check(first[0].shape == (g["raw"], g["raw"], 3) and first[0].dtype == np.uint8,
          f"gd shard: the first record decodes to {first[0].shape} {first[0].dtype}")
    t0 = time.perf_counter()
    host = next(dataset().batches(), None)
    host_s = time.perf_counter() - t0
    check(host is not None, f"gd shard: no batch of {g['batch']} from {u['gd_records']} records")
    batch = {k: torch.from_numpy(v).cuda() for k, v in host.items()}
    for k in ("text_ids", "text_ids_masked", "masked_pos", "masked_ids"):
        batch[k] = batch[k].long()
    n_masked = int((host["masked_ids"] != -100).sum())
    models = gd_models()
    prep, step, state = gd_step(models, "kernel", False)
    check(prep.__self__.scale == P.PRETRAIN_CROP_SCALE, "GD's DevicePreprocess crop scale")
    drawn = P.sample_train_params(torch.Generator(device="cuda").manual_seed(9), g["batch"],
                                  g["raw"], g["raw"], scale=prep.__self__.scale)
    hist = torch.bincount(drawn["ops"].reshape(-1), minlength=P.N_OPS).tolist()
    ops = {P.OP_NAMES[k]: n for k, n in enumerate(hist) if n}
    check(set(ops) <= set(P.DEFAULT_AUGS), f"GD's RandAugment drew ops outside the 10: {ops}")
    area = drawn["box"][2].double() * drawn["box"][3] / (g["raw"] * g["raw"])
    gen = torch.Generator(device="cuda").manual_seed(9)  # the same draws as `drawn`
    b = prep(batch, gen)
    t_out = step.teacher_forward(b, gen)
    m, grads = step.loss_and_grads(state, b, t_out, gen)
    del t_out
    step.apply(state, grads)
    c = expect_launches(c, GD_LAUNCHES[False], "gd general step from the shard")
    m = {k: float(v) for k, v in m.items()}
    check(all(math.isfinite(v) for v in m.values()), "gd step from the shard: non-finite loss")
    print(f"gd general step from a JSONL shard (b{g['batch']}, uint8 {g['raw']} x {g['raw']}, "
          f"{n_masked} masked tokens; host {host_s:.2f} s for the batch): " + ", ".join(
              f"{k} {v:.4f}" for k, v in m.items()) + f"; RandAugment draw {ops}; crop area "
          f"{area.min().item():.3f}-{area.max().item():.3f}")
    return {"host_batch_s": host_s, "ops": ops}, c


def phase_data(smi: str) -> dict:
    """The host data layer feeding the card's paths from files written
    under build/ (removed after): the retrieval fine-tune (with the host
    loaders' images/s), the retrieval evaluation, VQA and caption
    evaluation with their metrics, and one GD step from a pretraining
    shard; launches summed over them."""
    import shutil
    import tempfile

    import numpy as np

    from efficientvlm_tpu_torch.data import fastjpeg
    from efficientvlm_tpu_torch.data.tokenizer import build_tokenizer

    t_phase = time.perf_counter()
    import PIL

    print(f"phase data: PIL {PIL.__version__}; JPEG decoder for the uint8 / native paths: "
          f"{fastjpeg.decoder()}")
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(root, exist_ok=True)
    root = tempfile.mkdtemp(prefix="data-corpus-", dir=root)
    try:
        t0 = time.perf_counter()
        files = write_data_corpus(root, np.random.default_rng(0))
        tokenizer = build_tokenizer(files["vocab"])
        check(tokenizer.vocab_size == DATA_UNIT["vocab"], "the corpus vocab's size")
        print(f"corpus written in {time.perf_counter() - t0:.1f} s")
        c = reset_counts()  # the data path's run starts here
        run, train, c = data_retrieval_train(files, tokenizer, smi, c)
        evaluation, c = data_retrieval_eval(files, tokenizer, run, c)
        del run
        gen_metrics, c = data_vqa_caption(files, tokenizer, c)
        gd, c = data_gd(files, tokenizer, c)
        launches = counts()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(json.dumps({"data_phase": {"decoder": fastjpeg.decoder(), "card": smi,
                                     "retrieval_train": train, "retrieval_eval": evaluation,
                                     "vqa_accuracy": gen_metrics["vqa"], "gd": gd}}))
    print(f"phase data: {time.perf_counter() - t_phase:.1f} s")
    return {"launches": launches}


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
        if ln is None:
            return lambda: attend(prm, x, enc, mask, hz, h, fold)
        return lambda: Fn.layer_norm(x + attend(prm, x, enc, mask, hz, h, fold), (x.shape[-1],),
                                     ln["scale"].to(x.dtype), ln["bias"].to(x.dtype), 1e-12)
    if name == "flash_attention":  # on the same views, scaled by SDPA
        q, k, v, bias, scale = args
        mask = bias.to(q.dtype)
        return lambda: Fn.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=scale)
    if name == "flash_attention_grouped":  # one call over the group-folded queries
        from efficientvlm_tpu_torch.ops.flash_attention import _fold

        q, k, v, bias, g, scale = args
        qf, mask = _fold(q, k.shape[0], g).contiguous(), bias.to(q.dtype)
        return lambda: Fn.scaled_dot_product_attention(qf, k, v, attn_mask=mask, scale=scale)
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
        x = img.reshape(b, res // p, p, res // p, p, c).permute(0, 1, 3, 2, 4, 5).to(w.dtype)
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
    "flash_attention": ("efficientvlm_tpu_torch/csrc/flash_attention.cu",
                        "efficientvlm_tpu/ops/pallas_attention.py:81"),
    "flash_attention_grouped": ("efficientvlm_tpu_torch/csrc/flash_attention.cu",
                                "efficientvlm_tpu/ops/pallas_attention.py:118"),
    # the emit_probs instances of #2 and #3: the probs core attn_probs
    "fused_self_attention_probs": ("efficientvlm_tpu_torch/csrc/attn_probs.cuh",
                                   "efficientvlm_tpu/ops/pallas_fused_mha.py:159"),
    "fused_cross_attention_probs": ("efficientvlm_tpu_torch/csrc/attn_probs.cuh",
                                    "efficientvlm_tpu/ops/pallas_fused_mha.py:282"),
}


def phase_times(cases, device_cases, errs, slice_state, gen_state, train_launches) -> list:
    """The kernels line's rows of #1-#6 (launches summed over every main
    path: retrieval, generation and the training paths of train_launches),
    and the times of phase 4."""
    import torch

    from efficientvlm_tpu_torch.evaluation import retrieval as R

    bf16 = torch.bfloat16
    rows_out, seen, redesigned = [], set(), []
    for name, case, run, plain, flops, nbytes, *extra in cases:
        if name in seen:
            continue
        seen.add(name)
        if name in ("patch_embed", "fused_cross_attention_grouped"):
            redesigned.append((name, case, run, bound(flops, nbytes)[0]))
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
                         "launches": slice_state["launches"][name] + gen_state["launches"][name]
                         + sum(t[name] for t in train_launches),
                         "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
                         "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms})
    # the other main-path shapes (text, t2i, rect, decode), for the record,
    # with the plain versions of #1-#4; the two bare cores (#5, #6) at every
    # shape, with the library call timed in turns (the host sets the pace at
    # the decode shapes)
    seen, flash_cases = set(), []
    for name, case, run, plain, flops, nbytes, *extra in cases:
        first = name not in seen
        seen.add(name)
        if case.startswith("edge_"):
            continue
        flash = name.startswith("flash_attention")
        if first and not flash:
            continue
        lib = (patch_yardstick(*extra[0]) if name == "patch_embed"
               else library_yardstick(name, extra[0]))
        with torch.inference_mode():
            ms, lib_ms = timed_pair_ms(run, lib) if flash else (timed_ms(run), timed_ms(lib))
            plain_ms = "" if flash else f", plain {timed_ms(plain, iters=3, runs=3):.4f} ms"
        if flash:
            flash_cases.append((name, case, run, lib))
        print(f"time {name} [{case}]: {ms:.4f} ms{plain_ms}, library {lib_ms:.4f} ms, "
              f"bound {bound(flops, nbytes)[0]:.4f} ms, {flops / ms / 1e9:.1f} TFLOP/s")
    # the two device kernels under #1-#4 on their own: which one leads
    for name, case, run, plain, flops, nbytes, lib in device_cases:
        with torch.inference_mode():
            ms, lib_ms = timed_ms(run), timed_ms(lib)
        bound_ms, bound_by = bound(flops, nbytes)
        print(f"time {name} [{case}]: {ms:.4f} ms, {flops / ms / 1e9:.1f} TFLOP/s = "
              f"{flops / ms * 1e3 / PEAK_BF16_FLOPS:.1%} of the bf16 peak; bound {bound_ms:.4f} "
              f"ms ({bound_by}); library {lib_ms:.4f} ms")

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

    # generation: VQA questions/s and caption images/s (device clock of the
    # whole call, host gaps included: the decode loop reads its condition on
    # the host every step)
    models, vqa_in, u = gen_state["models"], gen_state["vqa_in"], VQA_UNIT
    image, prompt, gen_kw = gen_state["image"], gen_state["prompt"], gen_state["gen_kw"]

    def vqa(which, impl="fused"):
        model, params = models[("vqa", which)]
        return lambda: model.forward_eval(params, *vqa_in, k=u["k"], dtype=bf16, impl=impl)

    def caption(which, beams, impl="fused"):
        model, params = models[("caption", which)]
        return lambda: model.generate(params, image, prompt, num_beams=beams, impl=impl,
                                      **gen_kw)

    with torch.inference_mode():
        for which in ("teacher", "student"):
            tput[f"vqa_{which}_questions_per_s"] = u["batch"] / timed_ms(
                vqa(which), iters=3, runs=3, warmup=1) * 1e3
            for beams in (CAPTION_UNIT["beams"], 1):
                tput[f"caption_{which}_beams{beams}_images_per_s"] = CAPTION_UNIT["batch"] / \
                    timed_ms(caption(which, beams), iters=2, runs=3, warmup=1) * 1e3
        tput["vqa_plain_teacher_questions_per_s"] = u["batch"] / timed_ms(
            vqa("teacher", "plain"), iters=2, runs=3, warmup=1) * 1e3
        tput["caption_plain_teacher_beams3_images_per_s"] = CAPTION_UNIT["batch"] / timed_ms(
            caption("teacher", CAPTION_UNIT["beams"], "plain"), iters=2, runs=3, warmup=1) * 1e3
    print(json.dumps({"throughput": tput}))
    with torch.inference_mode():
        model, params = slice_state["teacher"]
        image32, ids, atts = slice_state["image"], slice_state["ids"], slice_state["atts"]
        profile("teacher forward b32", lambda: R.retrieval_forward(
            model, params, image32, ids, atts, dtype=bf16))
        profile("teacher i2t rerank chunk 4x256", lambda: R.itm_rerank_scores(
            model, params, ib, txt, txt_atts, rows, k, dtype=bf16))
        profile("teacher vqa forward_eval b16", vqa("teacher"), calls=2)
        profile("teacher caption generate b16 beams3", caption("teacher", CAPTION_UNIT["beams"]),
                calls=2, top=16)
        # the device time per call of #5 / #6 at every shape, to tell the
        # wrapper's host work from the kernel (after the throughputs: the
        # profiler's sessions can slow the host work that follows them)
        for name, case, run, lib in flash_cases:
            print(f"device {name} [{case}]: {fmt_us(device_us(run)[0])} us/call, library "
                  f"{fmt_us(device_us(lib)[0])} us/call; host {host_us(run):.2f} us/call, "
                  f"library {host_us(lib):.2f}")
        # #1 and #4 (redesigned in one launch / four launches per call)
        for name, case, run, bound_ms in redesigned:
            us, launches = device_us(run)
            print(f"device {name} [{case}]: {fmt_us(us)} us/call, "
                  f"{'not measured' if launches is None else f'{launches:g}'} device launches/call "
                  f"(bound {bound_ms * 1e3:.2f} us); host {host_us(run):.2f} us/call")
        split_sweep(cases)
    return rows_out


def host_us(fn, calls: int = 200) -> float:
    """Host time per call: the host clock over `calls` back-to-back calls
    that only queue work (no synchronisation inside), after a warm-up. Where
    the device takes less per call than the host, this sets the call rate."""
    import torch

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


SPLIT_SWEEP = (32, 64, 128, 192, 289)


def split_sweep(cases):
    """Device time per call of the split-KV cores at the S = 577 decode
    shapes over other keys per split (the bindings called directly; 577 is
    no split), the measurement behind ops/flash_attention.SPLIT_KEYS."""
    from efficientvlm_tpu_torch.kernels import bindings as K

    for name, case, run, plain, flops, nbytes, args in cases:
        if not name.startswith("flash_attention") or case.startswith("edge_") or \
                args[1].shape[2] != 577:
            continue
        q, k, v, bias = args[:4]
        groups, scale = (args[4], args[5]) if name == "flash_attention_grouped" else (1, args[4])
        times = {n: device_us(lambda: K.flash_attention(q, k, v, bias, groups=groups, scale=scale,
                                                        split_keys=n))[0]
                 for n in SPLIT_SWEEP + (577,)}
        print(f"split sweep {name} [{case}]: device us/call by keys per split: " +
              ", ".join(f"{n} {fmt_us(t)}" for n, t in times.items()))


def device_us(fn, calls: int = 20) -> tuple:
    """Device time per call (kernels and copies) and device launches per
    call, from torch.profiler's device-side events."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a profiler session now and then records no device event
        with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                                ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        ev = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
        if ev:
            return (sum(e.self_device_time_total for e in ev) / calls,
                    sum(e.count for e in ev) / calls)
    return None, None


def fmt_us(us) -> str:
    return "not measured" if us is None else f"{us:.2f}"


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
    launches = sum(e.count for e in kernels) / calls
    print(f"profile {what}: {calls} calls, device busy {busy_us / calls / 1e3:.3f} ms/call "
          f"of {wall_us / calls / 1e3:.3f} ms/call host clock, idle share "
          f"{1 - busy_us / wall_us:.3f}, {launches:.0f} device launches/call")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"  {e.self_device_time_total / busy_us:6.1%} {e.self_device_time_total / calls / 1e3:8.3f}"
              f" ms/call {e.count // calls:5d}x  {e.key[:90]}")


def main(argv) -> int:
    """Every phase on one card. --gd-seeds N adds gd_leaf_seeds' diagnostic
    over N more region batches."""
    seeds = int(argv[argv.index("--gd-seeds") + 1]) if "--gd-seeds" in argv else 0
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
    cases, device_cases = kernel_cases(rnd), device_kernel_cases(rnd)
    errs = phase_kernels(cases + device_cases)
    flash_refusals(rnd)
    p_cases = probs_cases(rnd)
    errs.update(phase_probs(p_cases + gd_probs_cases(rnd) + task_probs_cases(rnd)
                            + nlvr_probs_cases(Rand(6))))
    errs.update(phase_probs(probs_core_cases(Rand(5)), same_inputs=True))
    phase_grads(grad_cases(rnd))
    slice_state = phase_slice(rnd)
    gen_state = phase_generation(rnd)
    train_state = phase_train(rnd)
    phase_export(train_state, slice_state, rnd)
    train_rows = train_times(train_state, p_cases, errs)
    train_launches = train_state["launches"]
    del train_state  # each training path's peak memory is its own
    gd_state = phase_gd(rnd, seeds)
    gd_times(gd_state, smi)
    gd_launches = gd_state["launches"]
    del gd_state
    task_state = phase_task_train(rnd)
    task_times(task_state, smi)
    task_launches = task_state["launches"]
    del task_state
    nlvr_state = phase_nlvr(rnd)
    task_times(nlvr_state, smi, nlvr_probs_cases)
    nlvr_launches = nlvr_state["launches"]
    del nlvr_state
    grounding_state = phase_grounding(rnd)
    task_times(grounding_state, smi, None)
    grounding_launches = grounding_state["launches"]
    del grounding_state
    data_launches = phase_data(smi)["launches"]
    later = [gd_launches, task_launches, nlvr_launches, grounding_launches, data_launches]
    kernels = phase_times(cases, device_cases, errs, slice_state, gen_state,
                          [train_launches] + later)
    for row in train_rows:  # the probs forms run on every training path
        row["launches"] += sum(p[row["name"]] for p in later)
    kernels += train_rows
    paths = (slice_state["launches"], gen_state["launches"], train_launches, *later)
    probs_launches = sum(p[k] for p in paths for k in ("fused_self_attention_probs",
                                                       "fused_cross_attention_probs"))
    core_launches = sum(p["route_attn_probs"] for p in paths)
    print(f"probs forms on the main paths: {probs_launches} launches, {core_launches} served "
          f"by attn_probs, {sum(p['route_attn_core'] for p in paths)} by attn_core")
    check(core_launches == probs_launches > 0, "a probs launch of the main paths missed attn_probs")
    kernels.append(probs_core_times(errs, core_launches, smi))
    print(f"card: {smi}; total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
