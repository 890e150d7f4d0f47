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
    dev = x.device
    ws = [torch.empty(rq, a, dtype=BF16, device=dev), torch.empty(rkv, a, dtype=BF16, device=dev),
          torch.empty(rkv, a, dtype=BF16, device=dev), torch.empty(rq, a, dtype=BF16, device=dev),
          torch.empty(rq, d, dtype=F32, device=dev) if ln else None]
    out = torch.empty(rq, d, dtype=BF16, device=dev)
    _check(library().evlm_fused_attention(
        *args, *[None if t is None else t.data_ptr() for t in ws], out.data_ptr(),
        batch, tq, s, d, de, heads, dh, float(ln_eps), _stream(x)), "fused_attention")
    return out
