"""Multi-head attention (self and image-grounded cross) with gates, a
fixed-size decode cache and precomputed cross K/V.

The plain path (`impl="plain"`) is the generic one that every kernel is
checked against. Under `impl="fused"` the attention core between the
projections runs through ops/flash_attention.py (csrc/flash_attention.cu on
CUDA): `flash_attention` for ordinary and cached attention,
`flash_attention_grouped` for grouped K/V; the q/k/v/out projections stay
`F.linear` around it. Those cores have no backward and no probs, so the
plain core runs instead whenever probs are asked for, dropout is active, or
autograd records the projections (a training forward). The core takes the
projections' [B,T,H,dh] views and the softmax scale as they are and returns
its context in the layout that `_merge_heads` turns into a view, so no copy
surrounds it. Gates:

- head_z [H]: multiplies each head's context before the output projection;
- head_layer_z (scalar): scales the attention output.

Head counts come from the caller (derived from param shapes), so pruned
rectangular widths (q kernel [D, A], A = H*dh < D) need no extra code.

The decode cache {"k": [B,H,L,dh], "v": [B,H,L,dh], "index": int} is
written IN PLACE (slice assignment where the JAX package uses
`dynamic_update_slice`): the returned cache holds the same k/v tensors and
the advanced index. `index` is a host integer, since the decode loop runs on
the host.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from .basic import dense, dropout, init_dense
from .flash_attention import flash_attention, flash_attention_grouped

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


def causal_bias(q_len: int, k_len: int, *, offset: int = 0, device=None) -> torch.Tensor:
    """Causal additive f32 bias [1,1,q_len,k_len]; offset = number of cached
    positions preceding the current query block."""
    q_pos = torch.arange(q_len, device=device)[:, None] + offset
    k_pos = torch.arange(k_len, device=device)[None, :]
    return torch.where(k_pos <= q_pos, 0.0, NEG_INF)[None, None]


def decode_bias(max_len: int, index: int, q_len: int = 1, *, device=None) -> torch.Tensor:
    """Bias for cached decode: positions < index+q_len are visible, causally
    within the query block."""
    return causal_bias(q_len, max_len, offset=index, device=device)


def init_decode_cache(batch: int, num_heads: int, max_len: int, head_dim: int,
                      dtype=torch.float32, device=None) -> dict:
    shape = (batch, num_heads, max_len, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device), "index": 0}


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
    dropout_rate: float = 0.0,
    generator=None,
    train: bool = False,
    dtype=None,
    cache: Optional[dict] = None,
    precomputed_kv: Optional[dict] = None,
    kv_groups: int = 1,
    impl: str = "plain",
):
    """Returns (attn_output [B,Tq,D], probs [B,H,Tq,Tk] f32 or None, cache).
    The probs are the pre-dropout softmax; in training (train=True, a
    generator) dropout at `dropout_rate` acts on the probabilities before
    P.V.

    cache (see init_decode_cache): new keys/values are written at `index`
    (in place) and attention spans the whole cache; the bias must mask the
    positions past index+Tq (`decode_bias`).

    precomputed_kv {"k", "v"} [Bk,H,S,dh] (see project_kv): already projected
    keys/values, for cross-attention whose source is constant across decode
    steps; the k/v projections are skipped. Mutually exclusive with `cache`.

    kv_groups=G > 1 declares grouped K/V: the K/V batch is 1/G of the query
    batch, query rows grouped contiguously, and every group of G query rows
    attends to one shared K/V row. The flag is explicit so that an
    accidental batch mismatch stays a loud error.

    impl="fused" runs the attention core through flash_attention /
    flash_attention_grouped unless probs are asked for; "plain" runs it in
    plain PyTorch."""
    if cache is not None and (kv_groups > 1 or precomputed_kv is not None):
        # grouped or precomputed K/V would skip the cache update (stale K/V)
        # or write cross K/V into the self-attention slots
        raise ValueError("cache is mutually exclusive with kv_groups>1 and precomputed_kv")
    if x_kv is None:
        x_kv = x_q
    q = _split_heads(dense(params["q"], x_q, dtype=dtype), num_heads)
    if precomputed_kv is not None:
        k, v = precomputed_kv["k"], precomputed_kv["v"]
    else:
        k = _split_heads(dense(params["k"], x_kv, dtype=dtype), num_heads)
        v = _split_heads(dense(params["v"], x_kv, dtype=dtype), num_heads)
    if kv_groups > 1:
        if k.shape[0] * kv_groups != q.shape[0]:
            raise ValueError(
                f"kv_groups={kv_groups}: query batch {q.shape[0]} != "
                f"{kv_groups} * kv batch {k.shape[0]}")
        out, probs = _grouped_kv_attention(
            params, q, k, v, bias=bias, head_z=head_z, head_layer_z=head_layer_z,
            output_probs=output_probs, dropout_rate=dropout_rate, generator=generator,
            train=train, dtype=dtype, impl=impl)
        return out, probs, cache
    if k.shape[0] != q.shape[0]:
        raise ValueError(
            f"query batch {q.shape[0]} != kv batch {k.shape[0]} — pass "
            f"kv_groups={q.shape[0] // max(k.shape[0], 1)} if the kv rows "
            f"are intentionally shared across contiguous query groups")

    new_cache = cache
    if cache is not None:
        idx, t = cache["index"], x_q.shape[1]
        cache["k"][:, :, idx:idx + t] = k
        cache["v"][:, :, idx:idx + t] = v
        k, v = cache["k"], cache["v"]
        new_cache = {"k": k, "v": v, "index": idx + t}

    scale = 1.0 / math.sqrt(q.shape[-1])
    if _kernel_core(impl, output_probs, dropout_rate, train, generator, q, k, v):
        # q and k/v go in as the projections' views, scaled in the kernel
        ctx, probs = flash_attention(q, k, v, bias=bias, scale=scale), None
    else:
        scores = (q.float() @ k.float().transpose(-1, -2)) * scale
        if bias is not None:
            scores = scores + bias.float()
        probs = torch.softmax(scores, dim=-1)
        probs_d = dropout(probs, dropout_rate, generator=generator, train=train)
        ctx = probs_d.to(v.dtype) @ v
    out = _gate_and_project(params, ctx, head_z, head_layer_z, dtype)
    return out, (probs if output_probs else None), new_cache


def _requires_grad(x) -> bool:
    if isinstance(x, torch.Tensor):
        return x.requires_grad
    if isinstance(x, dict):
        return any(_requires_grad(v) for v in x.values())
    if isinstance(x, (list, tuple)):
        return any(_requires_grad(v) for v in x)
    return False


def graded(*inputs) -> bool:
    """The one rule for which form a kernel call takes: graded when autograd
    records through one of `inputs` (tensors, or trees of them such as a
    sublayer's params; None is skipped), in training or not. A graded call
    of a fused sublayer takes its differentiable form; the flash cores,
    which have no backward, give way to the plain core."""
    return torch.is_grad_enabled() and _requires_grad(inputs)


def _kernel_core(impl, output_probs, dropout_rate, train, generator, *tensors) -> bool:
    """The flash cores serve impl="fused" only where they compute all that
    is asked: no probs, no active dropout, and no autograd through them."""
    dropout_on = train and dropout_rate > 0.0 and generator is not None
    return impl == "fused" and not output_probs and not dropout_on and not graded(*tensors)


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
    dropout_rate: float = 0.0,
    generator=None,
    train: bool = False,
    dtype=None,
    impl: str = "plain",
):
    """Attention where G contiguous query rows share one K/V row; K/V are
    broadcast over the group dimension, never repeated in memory. Under
    impl="fused" the bias must be one key vector per group (the kernel's
    form); anything else raises."""
    bq, h, tq, dh = q.shape
    bk, _, s, _ = k.shape
    if bq % bk != 0:
        raise ValueError(f"grouped K/V: query batch {bq} not a multiple of kv batch {bk}")
    g = bq // bk
    scale = 1.0 / math.sqrt(dh)
    if _kernel_core(impl, output_probs, dropout_rate, train, generator, q, k, v):
        ctx = flash_attention_grouped(q, k, v, kv_groups=g, bias=bias, scale=scale)
        return _gate_and_project(params, ctx, head_z, head_layer_z, dtype), None
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
    probs_d = dropout(probs, dropout_rate, generator=generator, train=train)
    ctx = (probs_d.to(v.dtype) @ v[:, None]).reshape(bq, h, tq, dh)
    out = _gate_and_project(params, ctx, head_z, head_layer_z, dtype)
    return out, (probs.reshape(bq, h, tq, s) if output_probs else None)


def project_kv(params, x_kv: torch.Tensor, *, num_heads: int, dtype=None) -> dict:
    """Project keys/values once for `multi_head_attention(precomputed_kv=)`,
    the same arithmetic as the in-call projections; stored contiguous
    [B,H,S,dh], the layout the attention kernels read."""
    return {"k": _split_heads(dense(params["k"], x_kv, dtype=dtype), num_heads).contiguous(),
            "v": _split_heads(dense(params["v"], x_kv, dtype=dtype), num_heads).contiguous()}
