"""Bare attention cores over already projected q/k/v (port of
efficientvlm_tpu/ops/pallas_attention.py):

- `flash_attention` <- `_flash_attention_padded` (`_kernel_vec` /
  `_kernel_mat`): q [B,H,Tq,dh], k/v [B,H,Tk,dh], an additive bias that is
  a key vector [B|1,1,1,Tk] or a full matrix [B|1,1,Tq,Tk];
- `flash_attention_grouped` <- `_flash_attention_grouped_padded`: q
  [Bk*G,H,Tq,dh] with each group's G rows contiguous, k/v [Bk,H,S,dh] shared
  by the group, one key vector per group [1|Bk,1,1,S].

Both take q unscaled with `scale` (the softmax is over bf16(q * scale) k^T +
bias, the rounding of the caller's q * scale) and read q, k and v in place
through their strides, so the projection's [B,T,H,dh] view goes in as it
is. The result is [B,H,Tq,dh] as a view of a contiguous [B,Tq,H,dh] tensor,
so merging the heads afterwards is a view too.

On a CUDA tensor each wrapper launches csrc/flash_attention.cu once, in
bfloat16, and raises on anything else; on a CPU tensor it runs the plain
version below, which does the TPU kernels' arithmetic: f32 scores and
softmax, the probabilities rounded to the compute dtype before P.V, f32
accumulation. Nothing is padded to 128 lanes (a TPU layout fact), and the
grouped core never repeats K/V: the group is folded into the query rows.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..kernels import bindings

# Split-KV (flash-decoding) dispatch. A (b, h) whose rows fit few warps
# over a long key run would leave most of the H100's SMs idle, so its keys
# are split into pieces of their own when there are fewer than FILL_PIECES
# pieces of 16 query rows, never below SPLIT_KEYS keys per split nor into
# more than MAX_SPLITS splits (the kernel merges at most 30). FILL_PIECES
# is 3 units per resident warp on the H100 (132 SMs, each holding two
# 4-warp blocks of 108-124 KB); no shape of the generation path comes near
# it (the most split pieces are 192), so SPLIT_KEYS alone decides there,
# and the threshold itself is not tuned. SPLIT_KEYS is the H100's own
# choice, from the split sweep of chip_smoke.py at the caption cross steps
# (577 keys, 192 (b, h)): 128 keys per split ran 12.5-14.2 us of device
# time per call against 12.1-17.4 at 64, 13.2-14.9 at 192 and 21.4-22.8
# unsplit (H100 80GB HBM3, 700 W).
SPLIT_KEYS = 128
FILL_PIECES = 3 * 132 * 2 * 4
MAX_SPLITS = 30


def split_keys(pieces: int, tk: int) -> int:
    """Keys per split for `pieces` (b, h, 16 query rows) over `tk` keys;
    `tk` means no split."""
    if pieces >= FILL_PIECES or tk <= SPLIT_KEYS:
        return tk
    per = -(-tk // -(-FILL_PIECES // pieces))  # keys per split for FILL_PIECES units
    return min(tk, max(SPLIT_KEYS, -(-per // 16) * 16, -(-tk // MAX_SPLITS)))


def _pieces(bk: int, h: int, rows: int) -> int:
    return bk * h * -(-rows // 16)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          bias: Optional[torch.Tensor] = None,
                          scale: float = 1.0) -> torch.Tensor:
    if scale != 1.0:
        q = q * scale  # rounded to q's dtype, as the kernel rounds bf16(q * scale)
    scores = q.float() @ k.float().transpose(-1, -2)
    if bias is not None:
        scores = scores + bias.float()
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return (probs.float() @ v.float()).to(q.dtype)


def _split_combine_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         bias: Optional[torch.Tensor], splits: int) -> torch.Tensor:
    """The kernel's split-KV arithmetic in plain PyTorch (q already scaled):
    the keys in pieces of ceil(Tk / splits), each starting at a real key (the
    last one may be short), each piece's max m_s, sum l_s and un-normalised
    P.V O_s in f32, merged as sum exp(m_s - M) O_s / sum exp(m_s - M) l_s
    with M = max m_s. A piece whose keys are all masked (-1e9) gets weight
    exp(-1e9 - M) = 0."""
    tk = k.shape[2]
    per = -(-tk // splits)
    scores = q.float() @ k.float().transpose(-1, -2)
    if bias is not None:
        scores = scores + bias.float()
    parts = []
    for s0 in range(0, tk, per):
        piece = scores[..., s0:s0 + per]
        m = piece.amax(-1, keepdim=True)
        p = torch.exp(piece - m)
        parts.append((m, p.sum(-1, keepdim=True),
                      p.to(v.dtype).float() @ v[:, :, s0:s0 + per].float()))
    top = torch.stack([m for m, _, _ in parts]).amax(0)
    num = sum(torch.exp(m - top) * o for m, _, o in parts)
    den = sum(torch.exp(m - top) * l for m, l, _ in parts)
    return (num / den).to(q.dtype)


def _fold(q: torch.Tensor, bk: int, g: int) -> torch.Tensor:
    """[Bk*G, H, Tq, dh] -> [Bk, H, G*Tq, dh]: a group's rows side by side."""
    _, h, tq, dh = q.shape
    return q.reshape(bk, g, h, tq, dh).transpose(1, 2).reshape(bk, h, g * tq, dh)


def flash_attention_grouped_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                  kv_groups: int, bias: Optional[torch.Tensor] = None,
                                  scale: float = 1.0) -> torch.Tensor:
    bq, h, tq, dh = q.shape
    bk = k.shape[0]
    out = flash_attention_plain(_fold(q, bk, kv_groups), k, v, bias, scale)
    return out.reshape(bk, h, kv_groups, tq, dh).transpose(1, 2).reshape(bq, h, tq, dh)


def _bthd(out: torch.Tensor) -> torch.Tensor:
    """[B,H,T,dh] in the kernel's output layout: a view of [B,T,H,dh]."""
    return out.transpose(1, 2).contiguous().transpose(1, 2)


def _check_kv(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bk: int) -> None:
    h, dh = q.shape[1], q.shape[3]
    if q.ndim != 4 or k.ndim != 4 or k.shape[0] != bk or k.shape[1] != h or \
            k.shape[3] != dh or v.shape != k.shape:
        raise ValueError(f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    bias: Optional[torch.Tensor] = None, scale: float = 1.0) -> torch.Tensor:
    """q [B,H,Tq,dh] (unscaled; any strides with contiguous columns), k/v
    [B,H,Tk,dh]; bias additive [B|1,1,1,Tk] (key vector) or [B|1,1,Tq,Tk]
    (matrix) or None. Returns [B,H,Tq,dh], a view of [B,Tq,H,dh]."""
    b, h, tq, dh = q.shape
    tk = k.shape[2]
    _check_kv("flash attention", q, k, v, b)
    if bias is not None and (bias.ndim != 4 or bias.shape[0] not in (1, b)
                             or bias.shape[1] != 1 or bias.shape[2] not in (1, tq)
                             or bias.shape[3] != tk):
        raise ValueError(f"flash attention: bias {tuple(bias.shape)} is neither "
                         f"[{b}|1,1,1,{tk}] nor [{b}|1,1,{tq},{tk}]")
    if not q.is_cuda:
        return _bthd(flash_attention_plain(q, k, v, bias, scale))
    out = bindings.flash_attention(q, k, v, bias, groups=1, scale=scale,
                                   split_keys=split_keys(_pieces(b, h, tq), tk))
    flash_attention.launches += 1
    return out


def flash_attention_grouped(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                            kv_groups: int, bias: Optional[torch.Tensor] = None,
                            scale: float = 1.0) -> torch.Tensor:
    """q [Bk*G,H,Tq,dh] (unscaled, groups contiguous; any strides with
    contiguous columns), k/v [Bk,H,S,dh]; bias one additive key vector per
    group [1|Bk,1,1,S] or None (a per-query-row or matrix bias is an error).
    Returns [Bk*G,H,Tq,dh], a view of [Bk*G,Tq,H,dh]."""
    bq, h, tq, dh = q.shape
    bk, s, g = k.shape[0], k.shape[2], kv_groups
    if bq != bk * g:
        raise ValueError(f"flash grouped: query batch {bq} != {g} * kv batch {bk}")
    _check_kv("flash grouped", q, k, v, bk)
    if bias is not None and (bias.ndim != 4 or bias.shape[0] not in (1, bk)
                             or bias.shape[1:3] != (1, 1) or bias.shape[3] != s):
        raise ValueError(f"flash grouped: bias {tuple(bias.shape)} is not one key vector "
                         f"per group [{bk}|1,1,1,{s}]")
    if not q.is_cuda:
        return _bthd(flash_attention_grouped_plain(q, k, v, g, bias, scale))
    out = bindings.flash_attention(q, k, v, bias, groups=g, scale=scale,
                                   split_keys=split_keys(_pieces(bk, h, g * tq), s))
    flash_attention_grouped.launches += 1
    return out


flash_attention.launches = 0
flash_attention_grouped.launches = 0
