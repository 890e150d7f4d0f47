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
   at the i2t rerank, ViT and fusion shapes;
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
   with exact launch counts, finite outputs, and the kernel path against the
   plain path (f32 params for retrieval; the same bf16 params for
   generation, with a teacher-forced replay of the generated captions, and
   VQA's ranked answer probabilities over nine input draws, held by their
   medians to the plain bf16 path's own distance from f32 compute);
4. times: each kernel's time beside its bound, its plain version's and a
   library yardstick's time (CUDA events, median of runs after warm-up),
   the same at the other main-path shapes (for #5 and #6 timed in turns
   with the library call, and after the profiles their device time per call
   from torch.profiler, their host time per call, and the device time of
   the S = 577 split-KV shapes at other keys per split; for #1 and #4 the
   device time, device launches and host time per call), the device kernels
   with their TFLOP/s and share of the bf16 peak, gemm_ln's resident
   clusters (cudaOccupancyMaxActiveClusters), pairs/s, questions/s,
   images/s, and a torch.profiler breakdown.

Weights are random, made from a seed. Any failed check exits non-zero
before the last line, which is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Without a CUDA device it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
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
    from efficientvlm_tpu_torch.ops import flash_attention as FA
    from efficientvlm_tpu_torch.ops import fused_mha as F
    from efficientvlm_tpu_torch.ops.patch_embed import fused_patch_embed

    return {"patch_embed": fused_patch_embed, "fused_self_attention": F.fused_self_attention,
            "fused_cross_attention": F.fused_cross_attention,
            "fused_cross_attention_grouped": F.fused_cross_attention_grouped,
            "flash_attention": FA.flash_attention,
            "flash_attention_grouped": FA.flash_attention_grouped}


def counts() -> dict:
    return {k: w.launches for k, w in wrappers().items()}


def reset_counts() -> dict:
    """Every launch count to 0: a main path's run starts here."""
    for w in wrappers().values():
        w.launches = 0
    return counts()


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
    "flash_attention": ("efficientvlm_tpu_torch/csrc/flash_attention.cu",
                        "efficientvlm_tpu/ops/pallas_attention.py:81"),
    "flash_attention_grouped": ("efficientvlm_tpu_torch/csrc/flash_attention.cu",
                                "efficientvlm_tpu/ops/pallas_attention.py:118"),
}


def phase_times(cases, device_cases, errs, slice_state, gen_state) -> list:
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
                         "launches": slice_state["launches"][name] + gen_state["launches"][name],
                         "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
                         "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms})
    # the other main-path shapes (text, t2i, rect, decode), for the record;
    # the two bare cores (#5, #6) at every shape, with the library call timed
    # in turns (the host sets the pace at the decode shapes)
    seen, flash_cases = set(), []
    for name, case, run, plain, flops, nbytes, *extra in cases:
        first = name not in seen
        seen.add(name)
        if case.startswith("edge_"):
            continue
        flash = name.startswith("flash_attention")
        if first and not flash:
            continue
        lib = library_yardstick(name, extra[0])
        with torch.inference_mode():
            ms, lib_ms = timed_pair_ms(run, lib) if flash else (timed_ms(run), timed_ms(lib))
        if flash:
            flash_cases.append((name, case, run, lib))
        print(f"time {name} [{case}]: {ms:.4f} ms, library {lib_ms:.4f} ms, "
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
    cases, device_cases = kernel_cases(rnd), device_kernel_cases(rnd)
    errs = phase_kernels(cases + device_cases)
    flash_refusals(rnd)
    slice_state = phase_slice(rnd)
    gen_state = phase_generation(rnd)
    kernels = phase_times(cases, device_cases, errs, slice_state, gen_state)
    print(f"card: {smi}; total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
