"""Typed Python calls for the C entries in csrc/*.cu.

Each call checks device, dtype, shape and layout (contiguous, or for the
flash core the strides it reads in place), allocates the output and the
workspaces with torch.empty (the kernels allocate nothing; the flash core's
split workspace is cached per device and stream), launches on the current stream and
raises when the C entry returns a CUDA error.
"""

from __future__ import annotations

import struct
from typing import Optional

import torch

from .build import library

BF16, F32 = torch.bfloat16, torch.float32


def _check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc}")


def _operand(t: torch.Tensor, dtype, name: str) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.requires_grad and torch.is_grad_enabled():
        raise RuntimeError(f"{name} requires grad: the CUDA kernels have no backward yet")


def _ptr(t: Optional[torch.Tensor], dtype, name: str, shape) -> Optional[int]:
    if t is None:
        return None
    _operand(t, dtype, name)
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} shape {tuple(t.shape)} != {tuple(shape)}")
    return t.data_ptr()


def _stream(t: torch.Tensor) -> int:
    """The raw handle of the current stream of t's device (no Stream object)."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)


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


def _strides(t: torch.Tensor, name: str) -> tuple:
    """Element strides of dims 0-2 of a bf16 [N, H, T, dh] CUDA operand read
    in place (0 for a dim of size 1). The kernel loads 8 bf16 at a time: the
    columns must be contiguous, the base 16-byte aligned and every stride a
    multiple of 8."""
    n, h, t_, _ = t.shape
    sn, sh, st, sd = t.stride()
    st3 = (0 if n == 1 else sn, 0 if h == 1 else sh, 0 if t_ == 1 else st)
    if sd != 1:
        raise ValueError(f"flash_attention: {name} must have contiguous columns")
    if t.data_ptr() % 16:
        raise ValueError(f"flash_attention: {name} must be 16-byte aligned")
    if (st3[0] | st3[1] | st3[2]) % 8 or max(st3) >= 2 ** 31:
        raise ValueError(f"flash_attention: {name} strides {tuple(t.stride())} must be "
                         f"multiples of 8 below 2**31")
    return st3


_WORKSPACE: dict = {}  # (device index, raw stream) -> (split partials f32, tickets int32)


def _workspace(device: torch.device, stream: int, floats: int, pieces: int) -> tuple:
    """The split workspace and ticket buffer of `stream` on `device`, grown
    on demand and reused by every later launch on that stream (launches on
    one stream run in order, and the kernel leaves every ticket at 0; two
    streams never share tickets)."""
    ws, tickets = _WORKSPACE.get((device.index, stream), (None, None))
    if ws is None or ws.numel() < floats:
        ws = torch.empty(floats, dtype=F32, device=device)
    if tickets is None or tickets.numel() < pieces:
        tickets = torch.zeros(pieces, dtype=torch.int32, device=device)
    _WORKSPACE[(device.index, stream)] = (ws, tickets)
    return ws, tickets


_DIMS = struct.Struct("18i")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: Optional[torch.Tensor], *, groups: int, scale: float,
                    split_keys: int) -> torch.Tensor:
    """softmax(bf16(q * scale) k^T + bias) v per (batch row, head), with G =
    `groups` contiguous query rows sharing one K/V row. q [Bk*G,H,Tq,dh],
    k/v [Bk,H,Tk,dh] bf16, each read in place through its strides (the
    projection's [B,T,H,dh] view included); bias None or f32 [1|Bk,1,1|Tq,Tk]
    with contiguous keys, read in place (a key vector per group when G > 1);
    keys in splits of `split_keys`. The caller (ops/flash_attention.py)
    checks the shapes. Returns [Bk*G,H,Tq,dh] bf16 as a view of a contiguous
    [Bk*G,Tq,H,dh] tensor, so merging the heads is a view."""
    bq, h, tq, dh = q.shape
    bk, _, tk, _ = k.shape
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        _operand(t, BF16, name)
    if dh not in (32, 64, 128):
        raise ValueError(f"flash_attention: head dim {dh} (must be 32, 64 or 128)")
    qs, ks, vs = _strides(q, "q"), _strides(k, "k"), _strides(v, "v")
    bias_ptr, bias_b, bias_t = None, 0, 0
    if bias is not None:
        _operand(bias, F32, "bias")
        if bias.stride(3) != 1 and tk > 1:
            raise ValueError("flash_attention: the bias must have contiguous keys")
        bias_ptr = bias.data_ptr()
        bias_b = 0 if bias.shape[0] == 1 else bias.stride(0)
        bias_t = 0 if bias.shape[2] == 1 else bias.stride(2)
    out = torch.empty_strided((bq, h, tq, dh), (tq * h * dh, dh, h * dh, 1), dtype=BF16,
                              device=q.device)
    stream = _stream(q)
    ws = tickets = None
    if tk > split_keys:
        pieces = bk * h * -(-groups * tq // 16)  # of 16 query rows, one ticket each
        ws, tickets = _workspace(q.device, stream, pieces * -(-tk // split_keys) * 16 * (dh + 2),
                                 pieces)
    _check(library().evlm_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias_ptr, out.data_ptr(),
        None if ws is None else ws.data_ptr(), None if tickets is None else tickets.data_ptr(),
        _DIMS.pack(bk, groups, h, tq, tk, dh, qs[0], qs[1], qs[2], ks[0], ks[1], ks[2],
                   vs[0], vs[1], vs[2], bias_b, bias_t, split_keys),
        float(scale), stream), "flash_attention")
    return out
