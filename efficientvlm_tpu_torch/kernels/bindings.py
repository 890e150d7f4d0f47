"""Typed Python calls for the C entries in csrc/*.cu.

Each call checks device, dtype, shape and layout (contiguous, or for the
flash core the strides it reads in place), allocates the output and the
workspaces with torch.empty (the kernels allocate nothing; the flash core's
split workspace is cached per device and stream), launches on the current stream and
raises when the C entry returns a CUDA error. Small parameter vectors
(biases, LayerNorm scale and shift, positional rows, head gates) are passed
as stored with one flag per kernel call: all bf16, or all f32, so that no
call converts params stored in one dtype. The shape rules that choose between device kernels live here too
(gemm_ln_fits, wgmma_core_fits, patch_gather_fits, probs_tile), and
`probs_routes` counts which core served each call of a probs form.
"""

from __future__ import annotations

import functools
import struct
from typing import Optional

import torch

from ..train.profiler import span
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
        raise RuntimeError(f"{name} requires grad: a kernel call has no backward (the "
                           f"wrappers' differentiable forms run it inside an autograd Function)")


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


# --------------------------------------------------------------------------
# shape rules: which device kernel a shape takes (each side tested)
# --------------------------------------------------------------------------

LN_TILE, LN_MAX_CLUSTER = 128, 8


def gemm_ln_fits(d: int) -> bool:
    """A LayerNorm over rows of width d runs in gemm_ln's epilogue (one
    cluster of d / 128 blocks per row tile) when d is a multiple of 128 up to
    1024. Other widths keep gemm_bias into an f32 workspace and
    residual_layernorm."""
    return d > 0 and d % LN_TILE == 0 and d // LN_TILE <= LN_MAX_CLUSTER


def wgmma_core_fits(head_dim: int, grouped: bool) -> bool:
    """The grouped cross-attention's core is attn_wgmma at head dim 64;
    other head dims, and the self- and cross-attention sublayers, take
    attn_core."""
    return grouped and head_dim == 64


def patch_gather_fits(patch: int) -> bool:
    """gemm_ln's gather reads 16-byte pieces of the image: the P*3 values of
    one patch row must be a multiple of 8."""
    return patch > 0 and patch * 3 % 8 == 0


PROBS_HEAD_DIM, PROBS_MAX_ROWS, PROBS_MAX_WARPS = 64, 128, 16
PROBS_SMEM_LIMIT = 227 * 1024  # a block's shared memory on the H100


def probs_smem(rows: int, s: int, warps: int) -> int:
    """Shared memory of an attn_probs block of `rows` query rows over s keys
    with `warps` consumer warps a 16-row group (csrc/attn_probs.cuh
    smem_bytes): the f32 e of every row staged over ceil(s / 64) key tiles
    with each tile's running max, Q, the warps' (max, sum), the key bias, the
    K/V rings (one per warp of a group: 3 slots of 8 KB at up to 2 warps,
    else 2), their barriers and Q's, and the alignment."""
    nt = -(-s // 64)
    slots = warps * (3 if warps <= 2 else 2)
    return rows * (nt * 260 + 128 + 8 * warps) + nt * 256 + slots * (8192 + 16) + 8 + 1024


def probs_tile_fits(rows: int, s: int, warps: int) -> bool:
    return (0 < rows <= PROBS_MAX_ROWS and rows % 16 == 0 and warps > 0
            and rows // 16 * warps <= PROBS_MAX_WARPS
            and probs_smem(rows, s, warps) <= PROBS_SMEM_LIMIT)


PROBS_GROUP_WARPS, PROBS_MIN_WARPS = 5, 8
PROBS_SMEM_PAIR = 113 * 1024  # two blocks on one SM (228 KB, 1 KB reserved a block)


@functools.lru_cache(maxsize=None)
def probs_tile(head_dim: int, tq: int, s: int) -> tuple:
    """(query rows a block, consumer warps a 16-row group) of the probs core
    attn_probs, or (0, 0) when the probs form takes attn_core's two-sweep
    route (head dim 32 or 128, or s past the staging limit of 2,944 keys).
    The rows are as many 16-row groups as tq needs, up to 128, whose shared
    memory fits with at least 8 consumer warps in all (fewer where the keys
    have fewer 64-key tiles); each group gets as many warps as fit, up to 5
    and at most one a key tile, 16 a block; at 4 key tiles or fewer, the
    most warps with which two blocks share an SM. Measured on the H100
    (PERF.md, the tile sweep of scripts/torch_probs_bench.py): 5 warps a
    group beat 6 and 8; at S = 197, 128 rows of 2 warps beat 96 of 2; at 40
    x 197, 48 rows of 3 warps (two blocks an SM) beat 48 of 4 (one). Cached:
    every probs call asks."""
    if head_dim != PROBS_HEAD_DIM or tq <= 0 or s <= 0:
        return 0, 0
    nt, best = -(-s // 64), (0, 0)
    for rows in range(min(PROBS_MAX_ROWS, -(-tq // 16) * 16), 0, -16):
        groups = rows // 16
        fit = [w for w in range(min(PROBS_GROUP_WARPS, nt, PROBS_MAX_WARPS // groups), 0, -1)
               if probs_tile_fits(rows, s, w)]
        if not fit:
            continue
        warps = fit[0]
        if nt <= 4:  # short keys: two blocks an SM hide each other's fixed latency
            pair = [w for w in fit if probs_smem(rows, s, w) <= PROBS_SMEM_PAIR
                    and 2 * groups * w >= PROBS_MIN_WARPS]
            warps = pair[0] if pair else warps
        if groups * warps >= min(PROBS_MIN_WARPS, groups * min(PROBS_GROUP_WARPS, nt)):
            return rows, warps
        if groups * warps > best[0] // 16 * best[1]:
            best = (rows, warps)
    return best


# calls of the probs forms by the core that served them: attn_probs, or
# attn_core's two-sweep form outside probs_tile's rule
probs_routes = {"attn_probs": 0, "attn_core": 0}


def as_stored(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """A small parameter vector as the kernels read it: as stored when bf16
    or f32 (no copy), else as f32; contiguous."""
    if t is None:
        return None
    return (t if t.dtype in (BF16, F32) else t.float()).contiguous()


def _vecs(specs) -> tuple:
    """The small parameter vectors of one kernel call: [(name, tensor or
    None, shape)] -> (tensors as the kernel reads them, vec16), each bf16 or
    f32, contiguous, of its shape and aligned for pairwise loads. vec16 = 1
    when every one is bf16 (read as stored); when they mix, the bf16 ones are
    widened to f32 (exact; a copy that params stored in one dtype never
    need) and vec16 = 0. Keep the tensors alive until the launch."""
    out = []
    for name, t, shape in specs:
        if t is not None:
            if t.dtype not in (BF16, F32):
                raise TypeError(f"{name} must be bfloat16 or float32, got {t.dtype}")
            _ptr(t, t.dtype, name, shape)
        out.append(t)
    vec16 = all(t.dtype == BF16 for t in out if t is not None)
    if not vec16:
        out = [None if t is None else t.float() for t in out]
    for (name, *_), t in zip(specs, out):
        if t is not None and t.data_ptr() % (2 * t.element_size()):
            raise ValueError(f"{name} must be {2 * t.element_size()}-byte aligned")
    return out, int(vec16)


def _addr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def patch_embed(images: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor],
                pos: torch.Tensor, cls: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                eps: float, *, patch: int) -> torch.Tensor:
    """The ViT input stage in one launch: images [B, H, W, 3] bf16 (NHWC),
    gathered patch by patch; w [P*P*3, D] bf16; bias [D] (or None), pos
    [1+Np, D], cls [D], gamma/beta [D] as stored (bf16 or f32). Returns [B,
    1+Np, D] bf16: LN(cls + pos[0]) then LN(patch @ w + bias + pos[1+n]) per
    patch, f32 statistics. The patches tile the top-left floor(H/P)*P x
    floor(W/P)*P of the image, read in place (Np = floor(H/P) * floor(W/P)).
    D must fit gemm_ln_fits, P patch_gather_fits, and W*3 % 8 == 0 (rows of
    whole 16-byte pieces)."""
    b, hh, ww, c = images.shape
    d = w.shape[1]
    if c != 3 or hh < patch or ww < patch or ww * 3 % 8:
        raise ValueError(f"patch_embed: image {tuple(images.shape)} at patch {patch} (3 "
                         f"channels, at least one patch, W * 3 % 8 == 0)")
    if not patch_gather_fits(patch):
        raise ValueError(f"patch_embed: patch {patch} (the gather needs patch * 3 % 8 == 0)")
    if not gemm_ln_fits(d):
        raise ValueError(f"patch_embed: width {d} (a multiple of 128 up to 1024)")
    n_patches = (hh // patch) * (ww // patch)
    img_ptr = _ptr(images, BF16, "images", (b, hh, ww, 3))
    w_ptr = _ptr(w, BF16, "w", (patch * patch * 3, d))
    _aligned({"images": img_ptr, "w": w_ptr}, "patch_embed")
    vecs, vec16 = _vecs([("bias", bias, (d,)), ("pos", pos, (1 + n_patches, d)),
                         ("cls", cls, (d,)), ("gamma", gamma, (d,)), ("beta", beta, (d,))])
    out = torch.empty(b, 1 + n_patches, d, dtype=BF16, device=images.device)
    _check(library().evlm_patch_embed(img_ptr, w_ptr, *map(_addr, vecs), out.data_ptr(), b, hh,
                                      ww, patch, d, vec16, float(eps), _stream(images)),
           "patch_embed")
    return out


def patch_embed_im2col(patches: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor],
                       pos: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, eps: float,
                       *, batch: int) -> torch.Tensor:
    """The route of widths outside gemm_ln_fits: patches [batch*Np, K] bf16
    (im2col'd) @ w [K, D] bf16 + bias [D] + pos [Np, D] into an f32
    workspace, then the f32 LayerNorm -> [batch, 1+Np, D] bf16 with row 0 of
    each image left for the caller's CLS row. Vectors as stored."""
    rows, k = patches.shape
    n_patches, d = rows // batch, w.shape[1]
    if k % 8 or d % 8:
        raise ValueError(f"patch_embed: K={k} and D={d} must be multiples of 8")
    p_ptr = _ptr(patches, BF16, "patches", (batch * n_patches, k))
    w_ptr = _ptr(w, BF16, "w", (k, d))
    _aligned({"patches": p_ptr, "w": w_ptr}, "patch_embed")
    vecs, vec16 = _vecs([("bias", bias, (d,)), ("pos", pos, (n_patches, d)),
                         ("gamma", gamma, (d,)), ("beta", beta, (d,))])
    ws = torch.empty(rows, d, dtype=F32, device=patches.device)
    out = torch.empty(batch, 1 + n_patches, d, dtype=BF16, device=patches.device)
    _check(library().evlm_patch_embed_im2col(p_ptr, w_ptr, *map(_addr, vecs), ws.data_ptr(),
                                             out.data_ptr(), batch, n_patches, k, d, vec16,
                                             float(eps), _stream(patches)), "patch_embed")
    return out


def fused_attention(x: torch.Tensor, enc: torch.Tensor, w: dict, key_bias: torch.Tensor,
                    gates: Optional[torch.Tensor], *, heads: int, batch: int, tq: int, s: int,
                    grouped: bool = False, ln: Optional[tuple] = None,
                    ln_eps: float = 0.0, probs: bool = False):
    """One attention sublayer. x [batch*tq, D] bf16 queries, enc [batch*s,
    De] bf16 keys/values source (x itself for self-attention), w holds
    wq/wk/wv/wo (bf16, [in, out]) and bq/bk/bv/bo; key_bias [batch, s] f32;
    gates [H] or None (all ones); ln = (gamma, beta) adds the residual +
    post-LN epilogue; vectors as stored (bf16 or f32). Returns [batch*tq, D]
    bf16; with probs, (that, the pre-gate f32 softmax maps [batch, H, tq,
    s]) where the maps are a view of rows padded to a multiple of 4 floats
    (16-byte row strides for attn_probs' TMA stores), as JAX returns its
    padded maps trimmed. The probs form's core follows probs_tile. The call
    runs under the span evlm.fused_attention (train/profiler.span)."""
    with span("evlm.fused_attention"):
        d, de = x.shape[1], enc.shape[1]
        a = w["wq"].shape[1]
        dh = a // heads
        if dh * heads != a or dh not in (32, 64, 128):
            raise ValueError(f"fused_attention: width {a} over {heads} heads "
                             f"(head dim must be 32, 64 or 128)")
        if d % 8 or de % 8:
            raise ValueError(f"fused_attention: widths {d}, {de} must be multiples of 8")
        if probs and grouped:
            raise ValueError("fused_attention: the grouped sublayer has no probs form")
        rows, warps = probs_tile(dh, tq, s) if probs else (0, 0)
        core = 2 if rows else 1 if wgmma_core_fits(dh, grouped) else 0
        ln_route = 0 if ln is None else (1 if gemm_ln_fits(d) else 2)
        rq, rkv = batch * tq, batch * s
        mats = [_ptr(x, BF16, "x", (rq, d)), _ptr(enc, BF16, "enc", (rkv, de)),
                _ptr(w["wq"], BF16, "wq", (d, a)), _ptr(w["wk"], BF16, "wk", (de, a)),
                _ptr(w["wv"], BF16, "wv", (de, a)), _ptr(w["wo"], BF16, "wo", (a, d))]
        _aligned(dict(zip(("x", "enc", "wq", "wk", "wv", "wo"), mats)), "fused_attention")
        vecs, vec16 = _vecs([("bq", w["bq"], (a,)), ("bk", w["bk"], (a,)), ("bv", w["bv"], (a,)),
                             ("bo", w["bo"], (d,)), ("ln_gamma", ln[0] if ln else None, (d,)),
                             ("ln_beta", ln[1] if ln else None, (d,))])
        (g,), gates16 = _vecs([("gates", gates, (heads,))])
        bq, bk, bv, bo, lg, lb = map(_addr, vecs)
        kb = _ptr(key_bias, F32, "key_bias", (batch, s))
        dev = x.device
        ws = [torch.empty(rq, a, dtype=BF16, device=dev), torch.empty(rkv, a, dtype=BF16, device=dev),
              torch.empty(rkv, a, dtype=BF16, device=dev), torch.empty(rq, a, dtype=BF16, device=dev),
              torch.empty(rq, d, dtype=F32, device=dev) if ln_route == 2 else None]
        out = torch.empty(rq, d, dtype=BF16, device=dev)
        pitch = -(-s // 4) * 4
        maps = torch.empty(batch, heads, tq, pitch, dtype=F32, device=dev) if probs else None
        _check(library().evlm_fused_attention(
            mats[0], mats[1], mats[2], bq, mats[3], bk, mats[4], bv, mats[5], bo, kb, _addr(g), lg,
            lb, *map(_addr, ws), out.data_ptr(), _addr(maps), pitch, batch, tq, s, d, de, heads, dh,
            core, rows, warps, ln_route, vec16, gates16, float(ln_eps), _stream(x)),
            "fused_attention")
        if not probs:
            return out
        probs_routes["attn_probs" if rows else "attn_core"] += 1
        return out, maps[..., :s]


def gemm_bias(a: torch.Tensor, b: torch.Tensor, bias: Optional[torch.Tensor] = None,
              row_add: Optional[torch.Tensor] = None, *, out_f32: bool = False) -> torch.Tensor:
    """The projection kernel on its own: a [M, K] bf16 @ b [K, N] bf16
    (+ bias [N]) (+ row_add[m % period] of [period, N]), vectors bf16 or f32
    as stored, f32 accumulation -> [M, N] bf16, or f32 with out_f32."""
    (m, k), n = a.shape, b.shape[1]
    if k % 8 or n % 8:
        raise ValueError(f"gemm_bias: K={k} and N={n} must be multiples of 8")
    period = 1 if row_add is None else row_add.shape[0]
    args = [_ptr(a, BF16, "a", (m, k)), _ptr(b, BF16, "b", (k, n))]
    _aligned({"a": args[0], "b": args[1]}, "gemm_bias")
    vecs, vec16 = _vecs([("bias", bias, (n,)), ("row_add", row_add, (period, n))])
    c = torch.empty(m, n, dtype=F32 if out_f32 else BF16, device=a.device)
    _check(library().evlm_gemm_bias(*args, *map(_addr, vecs), c.data_ptr(), period, int(out_f32),
                                    vec16, m, n, k, _stream(a)), "gemm_bias")
    return c


def gemm_ln(a: torch.Tensor, b: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
            eps: float, *, bias: Optional[torch.Tensor] = None,
            row_add: Optional[torch.Tensor] = None, residual: Optional[torch.Tensor] = None,
            out: Optional[torch.Tensor] = None, group: Optional[int] = None,
            out_group_stride: Optional[int] = None, out_offset: int = 0) -> torch.Tensor:
    """The GEMM with the LayerNorm epilogue on its own: LN(a [M, K] bf16 @ b
    [K, N] bf16 + bias [N] + row_add[m % period] + residual [M, N] bf16) *
    gamma + beta, f32 statistics, bf16 out; vectors as stored. Row m lands
    at (m // group) * out_group_stride + out_offset + m % group of `out`
    (default: a new [M, N], rows in order). N must fit gemm_ln_fits."""
    (m, k), n = a.shape, b.shape[1]
    if not gemm_ln_fits(n) or k % 8:
        raise ValueError(f"gemm_ln: N={n} (a multiple of 128 up to 1024), K={k} (of 8)")
    group = m if group is None else group
    out_group_stride = group if out_group_stride is None else out_group_stride
    if out is None:
        out = torch.empty(m, n, dtype=BF16, device=a.device)
    rows_needed = (m - 1) // group * out_group_stride + out_offset + min(m, group)
    if out.dim() != 2 or out.shape[1] != n or out.shape[0] < rows_needed:
        raise ValueError(f"gemm_ln: out {tuple(out.shape)} holds fewer than {rows_needed} rows")
    period = 1 if row_add is None else row_add.shape[0]
    args = [_ptr(a, BF16, "a", (m, k)), _ptr(b, BF16, "b", (k, n)),
            _ptr(residual, BF16, "residual", (m, n)), _ptr(out, BF16, "out", tuple(out.shape))]
    _aligned(dict(zip(("a", "b", "residual", "out"), args)), "gemm_ln")
    vecs, vec16 = _vecs([("bias", bias, (n,)), ("row_add", row_add, (period, n)),
                         ("gamma", gamma, (n,)), ("beta", beta, (n,))])
    bias_p, ra_p, g_p, b_p = map(_addr, vecs)
    _check(library().evlm_gemm_ln(args[0], args[1], bias_p, ra_p, args[2], g_p, b_p, args[3],
                                  period, group, out_group_stride, out_offset, vec16, m, n, k,
                                  float(eps), _stream(a)), "gemm_ln")
    return out


def gemm_ln_clusters(n: int, gather: bool = False) -> int:
    """The clusters of gemm_ln (of n / 128 blocks) the current card keeps
    resident, from cudaOccupancyMaxActiveClusters; the persistent grid's
    size."""
    got = library().evlm_gemm_ln_clusters(n, int(gather))
    if got <= 0:
        raise RuntimeError(f"gemm_ln_clusters: width {n} gave {got}")
    return got


def attn_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, key_bias: torch.Tensor,
              gates: torch.Tensor, *, batch: int, tq: int, s: int, probs: bool = False):
    """The attention kernel on its own: per head h, softmax(q k^T / sqrt(dh)
    + key_bias) v * gates[h] over q [batch*tq, H*dh] and k/v [batch*s, H*dh]
    bf16 (heads side by side), key_bias [batch, s] f32 and gates [H] (bf16
    or f32). Returns [batch*tq, H*dh] bf16; with probs (its probs form),
    also the pre-gate f32 maps [batch, H, tq, s] (a view, as
    fused_attention's), from attn_probs where probs_tile admits the shape,
    else from attn_core's two-sweep form."""
    heads = gates.shape[0]
    a = q.shape[1]
    dh = a // heads
    if dh * heads != a or dh not in (32, 64, 128):
        raise ValueError(f"attn_core: width {a} over {heads} heads "
                         f"(head dim must be 32, 64 or 128)")
    if probs and probs_tile(dh, tq, s)[0]:
        return attn_probs(q, k, v, key_bias, gates, batch=batch, tq=tq, s=s)
    args = [_ptr(q, BF16, "q", (batch * tq, a)), _ptr(k, BF16, "k", (batch * s, a)),
            _ptr(v, BF16, "v", (batch * s, a)), _ptr(key_bias, F32, "key_bias", (batch, s))]
    _aligned({"q": args[0], "k": args[1], "v": args[2]}, "attn_core")
    (g,), gates16 = _vecs([("gates", gates, (heads,))])
    out = torch.empty_like(q)
    pitch = -(-s // 4) * 4
    maps = torch.empty(batch, heads, tq, pitch, dtype=F32, device=q.device) if probs else None
    _check(library().evlm_attn_core(*args, g.data_ptr(), out.data_ptr(), _addr(maps), pitch, batch,
                                    tq, s, heads, dh, gates16, float(dh ** -0.5), _stream(q)),
           "attn_core")
    if not probs:
        return out
    probs_routes["attn_core"] += 1
    return out, maps[..., :s]


def attn_probs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, key_bias: torch.Tensor,
               gates: torch.Tensor, *, batch: int, tq: int, s: int) -> tuple:
    """The probs core on its own: attn_core's function and arguments with
    probs at head dim 64 (q [batch*tq, H*64], k/v [batch*s, H*64] bf16,
    key_bias [batch, s] f32, gates [H] bf16 or f32), at probs_tile's tile.
    Returns (out [batch*tq, H*64] bf16, the pre-gate f32 maps [batch, H, tq,
    s], a view of rows padded to a multiple of 4 floats)."""
    return _attn_probs_tile(q, k, v, key_bias, gates, batch, tq, s,
                            *probs_tile(PROBS_HEAD_DIM, tq, s))


def _attn_probs_tile(q, k, v, key_bias, gates, batch: int, tq: int, s: int, rows: int,
                     warps: int) -> tuple:
    """attn_probs at `rows` query rows a block and `warps` consumer warps a
    16-row group; tiles other than probs_tile's serve only to measure and
    test the rule."""
    heads, a = gates.shape[0], q.shape[1]
    if a != heads * PROBS_HEAD_DIM:
        raise ValueError(f"attn_probs: width {a} is not {heads} heads of 64")
    if not probs_tile_fits(rows, s, warps):
        raise ValueError(f"attn_probs: {rows} rows a block, {warps} warps a 16-row group, over "
                         f"{s} keys (rows a multiple of 16 up to 128, at most 16 warps, within "
                         f"{PROBS_SMEM_LIMIT} bytes of shared memory)")
    args = [_ptr(q, BF16, "q", (batch * tq, a)), _ptr(k, BF16, "k", (batch * s, a)),
            _ptr(v, BF16, "v", (batch * s, a)), _ptr(key_bias, F32, "key_bias", (batch, s))]
    _aligned({"q": args[0], "k": args[1], "v": args[2]}, "attn_probs")
    (g,), gates16 = _vecs([("gates", gates, (heads,))])
    out = torch.empty_like(q)
    pitch = -(-s // 4) * 4
    maps = torch.empty(batch, heads, tq, pitch, dtype=F32, device=q.device)
    _check(library().evlm_attn_probs(*args, g.data_ptr(), out.data_ptr(), maps.data_ptr(), pitch,
                                     batch, tq, s, heads, rows, warps, gates16,
                                     float(PROBS_HEAD_DIM ** -0.5), _stream(q)),
           "attn_probs")
    probs_routes["attn_probs"] += 1
    return out, maps[..., :s]


def attn_wgmma(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, key_bias: torch.Tensor,
               gates: torch.Tensor, *, batch: int, tq: int, s: int) -> torch.Tensor:
    """The wgmma attention core on its own: attn_core's function and
    arguments at head dim 64 (q [batch*tq, H*64], k/v [batch*s, H*64] bf16,
    key_bias [batch, s] f32, gates [H] bf16 or f32)."""
    heads, a = gates.shape[0], q.shape[1]
    if a != heads * 64:
        raise ValueError(f"attn_wgmma: width {a} is not {heads} heads of 64")
    args = [_ptr(q, BF16, "q", (batch * tq, a)), _ptr(k, BF16, "k", (batch * s, a)),
            _ptr(v, BF16, "v", (batch * s, a)), _ptr(key_bias, F32, "key_bias", (batch, s))]
    _aligned({"q": args[0], "k": args[1], "v": args[2]}, "attn_wgmma")
    (g,), gates16 = _vecs([("gates", gates, (heads,))])
    out = torch.empty_like(q)
    _check(library().evlm_attn_wgmma(*args, g.data_ptr(), out.data_ptr(), batch, tq, s, heads,
                                     gates16, float(64 ** -0.5), _stream(q)), "attn_wgmma")
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
