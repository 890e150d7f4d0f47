"""Plain multi-head attention (self and image-grounded cross) with gates.

The generic path that every fused kernel is checked against, and the one
`impl="plain"` runs. Gates:

- head_z [H]: multiplies each head's context before the output projection;
- head_layer_z (scalar): scales the attention output.

Head counts come from the caller (derived from param shapes), so pruned
rectangular widths (q kernel [D, A], A = H*dh < D) need no extra code.
The decode cache and precomputed cross K/V come with the generation slice.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from .basic import dense, init_dense

NEG_INF = -1e9  # additive-bias masking value (f32)


def init_attention(generator, d_model: int, num_heads: int, *,
                   kv_width: Optional[int] = None, device=None):
    """Params for one attention block; kv_width != d_model for
    cross-attention into the vision tower."""
    kv_width = kv_width or d_model
    return {
        "q": init_dense(generator, d_model, d_model, device=device),
        "k": init_dense(generator, kv_width, d_model, device=device),
        "v": init_dense(generator, kv_width, d_model, device=device),
        "out": init_dense(generator, d_model, d_model, device=device),
    }


def make_attention_bias(mask: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """[B, Tk] or [B, Tq, Tk] 0/1 mask -> additive bias [B,1,*,Tk]."""
    mask = mask.float()
    if mask.ndim == 2:
        bias = (1.0 - mask)[:, None, None, :] * NEG_INF
    elif mask.ndim == 3:
        bias = (1.0 - mask)[:, None, :, :] * NEG_INF
    else:
        raise ValueError(f"mask ndim {mask.ndim}")
    return bias.to(dtype)


def _split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    b, t, d = x.shape
    return x.reshape(b, t, num_heads, d // num_heads).transpose(1, 2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, t, dh = x.shape
    return x.transpose(1, 2).reshape(b, t, h * dh)


def _gate_and_project(params, ctx, head_z, head_layer_z, dtype):
    if head_z is not None:
        ctx = ctx * head_z.reshape(1, -1, 1, 1).to(ctx.dtype)
    out = dense(params["out"], _merge_heads(ctx), dtype=dtype)
    if head_layer_z is not None:
        out = out * torch.as_tensor(head_layer_z, dtype=out.dtype, device=out.device)
    return out


def multi_head_attention(
    params,
    x_q: torch.Tensor,
    x_kv: Optional[torch.Tensor] = None,
    *,
    num_heads: int,
    bias: Optional[torch.Tensor] = None,
    head_z: Optional[torch.Tensor] = None,
    head_layer_z=None,
    output_probs: bool = False,
    dtype=None,
    kv_groups: int = 1,
):
    """Returns (attn_output [B,Tq,D], probs [B,H,Tq,Tk] f32 or None).

    kv_groups=G > 1 declares grouped K/V: the K/V batch is 1/G of the query
    batch, query rows grouped contiguously, and every group of G query rows
    attends to one shared K/V row. The flag is explicit so that an
    accidental batch mismatch stays a loud error."""
    if x_kv is None:
        x_kv = x_q
    q = _split_heads(dense(params["q"], x_q, dtype=dtype), num_heads)
    k = _split_heads(dense(params["k"], x_kv, dtype=dtype), num_heads)
    v = _split_heads(dense(params["v"], x_kv, dtype=dtype), num_heads)
    if kv_groups > 1:
        if k.shape[0] * kv_groups != q.shape[0]:
            raise ValueError(
                f"kv_groups={kv_groups}: query batch {q.shape[0]} != "
                f"{kv_groups} * kv batch {k.shape[0]}")
        return _grouped_kv_attention(
            params, q, k, v, bias=bias, head_z=head_z,
            head_layer_z=head_layer_z, output_probs=output_probs, dtype=dtype)
    if k.shape[0] != q.shape[0]:
        raise ValueError(
            f"query batch {q.shape[0]} != kv batch {k.shape[0]} — pass "
            f"kv_groups={q.shape[0] // max(k.shape[0], 1)} if the kv rows "
            f"are intentionally shared across contiguous query groups")

    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = (q.float() @ k.float().transpose(-1, -2)) * scale
    if bias is not None:
        scores = scores + bias.float()
    probs = torch.softmax(scores, dim=-1)
    ctx = probs.to(v.dtype) @ v
    out = _gate_and_project(params, ctx, head_z, head_layer_z, dtype)
    return out, (probs if output_probs else None)


def _grouped_kv_attention(
    params,
    q: torch.Tensor,   # [Bk*G, H, Tq, dh] — groups contiguous
    k: torch.Tensor,   # [Bk, H, S, dh]
    v: torch.Tensor,   # [Bk, H, S, dh]
    *,
    bias: Optional[torch.Tensor] = None,
    head_z: Optional[torch.Tensor] = None,
    head_layer_z=None,
    output_probs: bool = False,
    dtype=None,
):
    """Attention where G contiguous query rows share one K/V row; K/V are
    broadcast over the group dimension, never repeated in memory."""
    bq, h, tq, dh = q.shape
    bk, _, s, _ = k.shape
    if bq % bk != 0:
        raise ValueError(f"grouped K/V: query batch {bq} not a multiple of kv batch {bk}")
    g = bq // bk
    scale = 1.0 / math.sqrt(dh)
    qg = q.reshape(bk, g, h, tq, dh)
    scores = (qg.float() @ k.float().transpose(-1, -2)[:, None]) * scale
    if bias is not None:
        if bias.shape[0] == bq:         # per-query-row bias [Bq,1|H,Tq|1,S]
            bias = bias.reshape((bk, g) + tuple(bias.shape[1:]))
        elif bias.shape[0] in (1, bk):  # shared / per-kv-row bias
            bias = bias[:, None]
        else:
            raise ValueError(f"grouped K/V: bias batch {bias.shape[0]} "
                             f"matches neither query ({bq}) nor kv ({bk}) batch")
        scores = scores + bias.float()
    probs = torch.softmax(scores, dim=-1)
    ctx = (probs.to(v.dtype) @ v[:, None]).reshape(bq, h, tq, dh)
    out = _gate_and_project(params, ctx, head_z, head_layer_z, dtype)
    return out, (probs.reshape(bq, h, tq, s) if output_probs else None)
