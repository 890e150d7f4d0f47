"""Typed Python calls for the C entries in csrc/*.cu.

Each call checks device, dtype, shape and contiguity, allocates the output
and the workspaces with torch.empty (the kernels allocate nothing), launches
on the current stream and raises when the C entry returns a CUDA error.
"""

from __future__ import annotations

from typing import Optional

import torch

from .build import library

BF16, F32 = torch.bfloat16, torch.float32


def _check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc}")


def _ptr(t: Optional[torch.Tensor], dtype, name: str, shape) -> Optional[int]:
    if t is None:
        return None
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.requires_grad and torch.is_grad_enabled():
        raise RuntimeError(f"{name} requires grad: the CUDA kernels have no backward yet")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} shape {tuple(t.shape)} != {tuple(shape)}")
    return t.data_ptr()


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _aligned(ptrs: dict, name: str) -> None:
    """TMA (and the kernels' 16-byte loads) need 16-byte aligned operands."""
    bad = [k for k, p in ptrs.items() if p is not None and p % 16]
    if bad:
        raise ValueError(f"{name}: {', '.join(bad)} must be 16-byte aligned")


def patch_embed(patches: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor],
                pos: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, eps: float,
                *, batch: int) -> torch.Tensor:
    """patches [batch*Np, K] bf16 @ w [K, D] bf16 + bias [D] + pos [Np, D],
    LayerNorm(gamma, beta) in f32 -> [batch, 1+Np, D] bf16 with row 0 of each
    image left for the caller's CLS row."""
    rows, k = patches.shape
    n_patches, d = rows // batch, w.shape[1]
    if k % 8 or d % 8:
        raise ValueError(f"patch_embed: K={k} and D={d} must be multiples of 8")
    args = [_ptr(patches, BF16, "patches", (batch * n_patches, k)),
            _ptr(w, BF16, "w", (k, d)), _ptr(bias, F32, "bias", (d,)),
            _ptr(pos, F32, "pos", (n_patches, d)), _ptr(gamma, F32, "gamma", (d,)),
            _ptr(beta, F32, "beta", (d,))]
    _aligned({"patches": args[0], "w": args[1]}, "patch_embed")
    ws = torch.empty(rows, d, dtype=F32, device=patches.device)
    out = torch.empty(batch, 1 + n_patches, d, dtype=BF16, device=patches.device)
    _check(library().evlm_patch_embed(*args, ws.data_ptr(), out.data_ptr(), batch, n_patches,
                                      k, d, float(eps), _stream(patches)), "patch_embed")
    return out


def fused_attention(x: torch.Tensor, enc: torch.Tensor, w: dict, key_bias: torch.Tensor,
                    gates: torch.Tensor, *, batch: int, tq: int, s: int,
                    ln: Optional[tuple] = None, ln_eps: float = 0.0) -> torch.Tensor:
    """One attention sublayer. x [batch*tq, D] bf16 queries, enc [batch*s,
    De] bf16 keys/values source (x itself for self-attention), w holds
    wq/wk/wv/wo (bf16, [in, out]) and bq/bk/bv/bo (f32); key_bias [batch, s]
    f32, gates [H] f32; ln = (gamma, beta) f32 adds the residual + post-LN
    epilogue. Returns [batch*tq, D] bf16."""
    d, de = x.shape[1], enc.shape[1]
    a = w["wq"].shape[1]
    heads = gates.shape[0]
    dh = a // heads
    if dh * heads != a or dh not in (32, 64, 128):
        raise ValueError(f"fused_attention: width {a} over {heads} heads "
                         f"(head dim must be 32, 64 or 128)")
    if d % 8 or de % 8:
        raise ValueError(f"fused_attention: widths {d}, {de} must be multiples of 8")
    rq, rkv = batch * tq, batch * s
    args = [_ptr(x, BF16, "x", (rq, d)), _ptr(enc, BF16, "enc", (rkv, de)),
            _ptr(w["wq"], BF16, "wq", (d, a)), _ptr(w["bq"], F32, "bq", (a,)),
            _ptr(w["wk"], BF16, "wk", (de, a)), _ptr(w["bk"], F32, "bk", (a,)),
            _ptr(w["wv"], BF16, "wv", (de, a)), _ptr(w["bv"], F32, "bv", (a,)),
            _ptr(w["wo"], BF16, "wo", (a, d)), _ptr(w["bo"], F32, "bo", (d,)),
            _ptr(key_bias, F32, "key_bias", (batch, s)), _ptr(gates, F32, "gates", (heads,)),
            _ptr(ln[0] if ln else None, F32, "ln_gamma", (d,)),
            _ptr(ln[1] if ln else None, F32, "ln_beta", (d,))]
    _aligned(dict(zip(("x", "enc", "wq", "wk", "wv", "wo"),
                      (args[0], args[1], args[2], args[4], args[6], args[8]))), "fused_attention")
    dev = x.device
    ws = [torch.empty(rq, a, dtype=BF16, device=dev), torch.empty(rkv, a, dtype=BF16, device=dev),
          torch.empty(rkv, a, dtype=BF16, device=dev), torch.empty(rq, a, dtype=BF16, device=dev),
          torch.empty(rq, d, dtype=F32, device=dev) if ln else None]
    out = torch.empty(rq, d, dtype=BF16, device=dev)
    _check(library().evlm_fused_attention(
        *args, *[None if t is None else t.data_ptr() for t in ws], out.data_ptr(),
        batch, tq, s, d, de, heads, dh, float(ln_eps), _stream(x)), "fused_attention")
    return out


def gemm_bias(a: torch.Tensor, b: torch.Tensor, bias: Optional[torch.Tensor] = None,
              row_add: Optional[torch.Tensor] = None, *, out_f32: bool = False) -> torch.Tensor:
    """The projection kernel on its own: a [M, K] bf16 @ b [K, N] bf16
    (+ bias [N] f32) (+ row_add[m % period] of [period, N] f32), f32
    accumulation -> [M, N] bf16, or f32 with out_f32."""
    (m, k), n = a.shape, b.shape[1]
    if k % 8 or n % 8:
        raise ValueError(f"gemm_bias: K={k} and N={n} must be multiples of 8")
    period = 1 if row_add is None else row_add.shape[0]
    args = [_ptr(a, BF16, "a", (m, k)), _ptr(b, BF16, "b", (k, n)),
            _ptr(bias, F32, "bias", (n,)), _ptr(row_add, F32, "row_add", (period, n))]
    _aligned({"a": args[0], "b": args[1]}, "gemm_bias")
    c = torch.empty(m, n, dtype=F32 if out_f32 else BF16, device=a.device)
    _check(library().evlm_gemm_bias(*args, c.data_ptr(), period, int(out_f32), m, n, k,
                                    _stream(a)), "gemm_bias")
    return c


def attn_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, key_bias: torch.Tensor,
              gates: torch.Tensor, *, batch: int, tq: int, s: int) -> torch.Tensor:
    """The attention kernel on its own: per head h, softmax(q k^T / sqrt(dh)
    + key_bias) v * gates[h] over q [batch*tq, H*dh] and k/v [batch*s, H*dh]
    bf16 (heads side by side), key_bias [batch, s] and gates [H] f32.
    Returns [batch*tq, H*dh] bf16."""
    heads = gates.shape[0]
    a = q.shape[1]
    dh = a // heads
    if dh * heads != a or dh not in (32, 64, 128):
        raise ValueError(f"attn_core: width {a} over {heads} heads "
                         f"(head dim must be 32, 64 or 128)")
    args = [_ptr(q, BF16, "q", (batch * tq, a)), _ptr(k, BF16, "k", (batch * s, a)),
            _ptr(v, BF16, "v", (batch * s, a)), _ptr(key_bias, F32, "key_bias", (batch, s)),
            _ptr(gates, F32, "gates", (heads,))]
    _aligned({"q": args[0], "k": args[1], "v": args[2]}, "attn_core")
    out = torch.empty_like(q)
    _check(library().evlm_attn_core(*args, out.data_ptr(), batch, tq, s, heads, dh,
                                    float(dh ** -0.5), _stream(q)), "attn_core")
    return out


def _qkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, name: str, kv_shape) -> list:
    """Pointers of bf16 q [*, H, Tq, dh] and k/v `kv_shape`, each contiguous
    and 16-byte aligned (the kernels load 8 bf16 at a time)."""
    dh = q.shape[-1]
    if dh not in (32, 64, 128):
        raise ValueError(f"{name}: head dim {dh} (must be 32, 64 or 128)")
    ptrs = [_ptr(q, BF16, "q", q.shape), _ptr(k, BF16, "k", kv_shape),
            _ptr(v, BF16, "v", kv_shape)]
    if any(p % 16 for p in ptrs):
        raise ValueError(f"{name}: q, k and v must be 16-byte aligned")
    return ptrs


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T + bias) v per (batch row, head). q [B,H,Tq,dh] (already
    scaled), k/v [B,H,Tk,dh] bf16; bias f32, a key vector [1|B, Tk] or a
    matrix [1|B, Tq, Tk] (batch 1 broadcasts). Returns [B,H,Tq,dh] bf16."""
    b, h, tq, dh = q.shape
    tk = k.shape[2]
    matrix = bias.ndim == 3
    bb = bias.shape[0]
    if bb not in (1, b):
        raise ValueError(f"flash_attention: bias batch {bb} != 1 or {b}")
    args = _qkv(q, k, v, "flash_attention", (b, h, tk, dh))
    args.append(_ptr(bias, F32, "bias", (bb, tq, tk) if matrix else (bb, tk)))
    out = torch.empty_like(q)
    per_row = tq * tk if matrix else tk
    _check(library().evlm_flash_attention(
        *args, out.data_ptr(), b, h, tq, tk, dh, 0 if bb == 1 else per_row,
        tk if matrix else 0, _stream(q)), "flash_attention")
    return out


def flash_attention_grouped(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            bias: torch.Tensor, *, groups: int) -> torch.Tensor:
    """Grouped K/V: q [Bk*G,H,Tq,dh] (already scaled, each group's G rows
    contiguous), k/v [Bk,H,S,dh] bf16 shared by the group; bias f32 key
    vector per group [1|Bk, S]. Returns [Bk*G,H,Tq,dh] bf16."""
    bq, h, tq, dh = q.shape
    bk, _, s, _ = k.shape
    if bq != bk * groups:
        raise ValueError(f"flash_attention_grouped: query batch {bq} != {groups} * kv batch {bk}")
    bb = bias.shape[0]
    if bb not in (1, bk):
        raise ValueError(f"flash_attention_grouped: bias batch {bb} != 1 or {bk}")
    args = _qkv(q, k, v, "flash_attention_grouped", (bk, h, s, dh))
    args.append(_ptr(bias, F32, "bias", (bb, s)))
    out = torch.empty_like(q)
    _check(library().evlm_flash_attention_grouped(
        *args, out.data_ptr(), bk, groups, h, tq, s, dh, 0 if bb == 1 else s, _stream(q)),
        "flash_attention_grouped")
    return out
