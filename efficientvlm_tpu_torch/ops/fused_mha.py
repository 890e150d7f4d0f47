"""Fused attention sublayers: Q/K/V projections -> attention -> head gates ->
output projection, as one call.

Ports of efficientvlm_tpu/ops/pallas_fused_mha.py:
- `fused_self_attention`   <- `_fused_mha_padded` / `_fused_kernel`;
- `fused_cross_attention`  <- `_fused_cross_padded` / `_fused_cross_kernel`;
- `fused_cross_attention_grouped` <- `_fused_cross_grouped_padded` /
  `_fused_cross_grouped_kernel` (G contiguous query rows share one image's
  K/V; K/V are projected once per image; optional residual + post-LN).

On a CUDA tensor each wrapper runs csrc/fused_mha.cu, whose hand-written
kernels are gemm_bias for every projection, attn_core for the attention of
all heads, and (grouped, with ln_params) residual_layernorm. It computes in bfloat16
with f32 accumulation and raises on anything else. On a CPU tensor it runs
the plain PyTorch version below, which does the same arithmetic. The
arithmetic follows the TPU kernels: projections accumulate in f32, add the
bias in f32 and round to the compute dtype; scores and softmax are f32;
probabilities are rounded before P.V; each head's f32 context is scaled by
head_z[h] and rounded before the output projection.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..kernels import bindings

NEG = -1e9


def _key_bias(b: int, s: int, mask, key_bias, device) -> torch.Tensor:
    """[b, s] f32 additive key bias from a 0/1 mask or a bias."""
    if key_bias is not None:
        return key_bias.float().expand(b, s).contiguous()
    if mask is None:
        return torch.zeros(b, s, device=device)
    return ((1.0 - mask.float()) * NEG).contiguous()


def _gates(num_heads: int, head_z, device) -> torch.Tensor:
    if head_z is None:
        return torch.ones(num_heads, device=device)
    return head_z.float().reshape(num_heads).contiguous()


def _split(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    b, t, a = x.shape
    return x.reshape(b, t, num_heads, a // num_heads).transpose(1, 2)


# --------------------------------------------------------------------------
# plain PyTorch versions
# --------------------------------------------------------------------------


def _linear_plain(x: torch.Tensor, p: dict, dt, out_f32: bool = False) -> torch.Tensor:
    """x @ kernel in f32 over operands rounded to dt, + f32 bias."""
    y = x.float() @ p["kernel"].to(dt).float() + p["bias"].float()
    return y if out_f32 else y.to(dt)


def _attention_plain(q, k, v, kb2, gates1, num_heads: int, groups: int = 1):
    """q [Bk*G, Tq, A], k/v [Bk, S, A] (dt), kb2 [Bk, S] f32 -> ctx [Bk*G, Tq, A]."""
    dt = q.dtype
    bq, tq, a = q.shape
    bk = k.shape[0]
    dh = a // num_heads
    qh = _split(q, num_heads).float().reshape(bk, groups, num_heads, tq, dh)
    kh = _split(k, num_heads).float()[:, None]
    vh = _split(v, num_heads).float()[:, None]
    scores = qh @ kh.transpose(-1, -2) * dh ** -0.5 + kb2[:, None, None, None, :]
    probs = torch.softmax(scores, dim=-1).to(dt)
    ctx = (probs.float() @ vh) * gates1.reshape(1, 1, num_heads, 1, 1)
    return ctx.reshape(bq, num_heads, tq, dh).transpose(1, 2).reshape(bq, tq, a).to(dt)


def self_attention_plain(params, hidden, kb2, gates1, num_heads: int):
    dt = hidden.dtype
    q = _linear_plain(hidden, params["q"], dt)
    k = _linear_plain(hidden, params["k"], dt)
    v = _linear_plain(hidden, params["v"], dt)
    ctx = _attention_plain(q, k, v, kb2, gates1, num_heads)
    return _linear_plain(ctx, params["out"], dt)


def cross_attention_plain(params, hidden, enc, kb2, gates1, num_heads: int):
    dt = hidden.dtype
    enc = enc.to(dt)
    q = _linear_plain(hidden, params["q"], dt)
    k = _linear_plain(enc, params["k"], dt)
    v = _linear_plain(enc, params["v"], dt)
    ctx = _attention_plain(q, k, v, kb2, gates1, num_heads)
    return _linear_plain(ctx, params["out"], dt)


def cross_attention_grouped_plain(params, hidden, enc, kb2, gates1, num_heads: int,
                                  groups: int, ln_params=None, ln_eps: float = 1e-12):
    dt = hidden.dtype
    enc = enc.to(dt)
    q = _linear_plain(hidden, params["q"], dt)
    k = _linear_plain(enc, params["k"], dt)   # Bk image rows only
    v = _linear_plain(enc, params["v"], dt)
    ctx = _attention_plain(q, k, v, kb2, gates1, num_heads, groups)
    out = _linear_plain(ctx, params["out"], dt, out_f32=True)
    if ln_params is None:
        return out.to(dt)
    y = hidden.float() + out
    mean = y.mean(-1, keepdim=True)
    var = (y - mean).square().mean(-1, keepdim=True)
    y = (y - mean) * torch.rsqrt(var + ln_eps)
    return (y * ln_params["scale"].float() + ln_params["bias"].float()).to(dt)


# --------------------------------------------------------------------------
# CUDA paths
# --------------------------------------------------------------------------


def _weights(params: dict) -> dict:
    """bf16 [in, out] kernels and f32 biases, as csrc/fused_mha.cu takes them."""
    w = {}
    for name, key in (("q", "q"), ("k", "k"), ("v", "v"), ("out", "o")):
        w["w" + key] = params[name]["kernel"].to(torch.bfloat16).contiguous()
        w["b" + key] = params[name]["bias"].float().contiguous()
    return w


def _rows(x: torch.Tensor) -> torch.Tensor:
    if x.dtype != torch.bfloat16:
        raise TypeError(f"the fused attention kernels compute in bfloat16, got {x.dtype}")
    return x.reshape(-1, x.shape[-1]).contiguous()


# --------------------------------------------------------------------------
# wrappers
# --------------------------------------------------------------------------


def fused_self_attention(params: dict, hidden: torch.Tensor, *, num_heads: int,
                         mask: Optional[torch.Tensor] = None,
                         key_bias: Optional[torch.Tensor] = None,
                         head_z: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Self-attention sublayer over params {'q','k','v','out'}; hidden
    [B,T,D]; mask [B,T] (1 = attend) or key_bias [B,T] additive; head_z [H].
    The projection width A = H*dh may be below D (pruned exports)."""
    b, t, d = hidden.shape
    kb2 = _key_bias(b, t, mask, key_bias, hidden.device)
    gates1 = _gates(num_heads, head_z, hidden.device)
    if not hidden.is_cuda:
        return self_attention_plain(params, hidden, kb2, gates1, num_heads)
    x = _rows(hidden)
    out = bindings.fused_attention(x, x, _weights(params), kb2, gates1, batch=b, tq=t, s=t)
    fused_self_attention.launches += 1
    return out.reshape(b, t, d)


def fused_cross_attention(params: dict, hidden: torch.Tensor, encoder_hidden: torch.Tensor,
                          *, num_heads: int, mask: Optional[torch.Tensor] = None,
                          key_bias: Optional[torch.Tensor] = None,
                          head_z: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Cross-attention sublayer: queries from hidden [B,T,D], keys/values
    from encoder_hidden [B,S,De]; mask / key_bias [B,S]; head_z [H]."""
    b, t, d = hidden.shape
    s = encoder_hidden.shape[1]
    if encoder_hidden.shape[0] != b:
        raise ValueError(f"fused cross: query batch {b} != kv batch {encoder_hidden.shape[0]}")
    kb2 = _key_bias(b, s, mask, key_bias, hidden.device)
    gates1 = _gates(num_heads, head_z, hidden.device)
    if not hidden.is_cuda:
        return cross_attention_plain(params, hidden, encoder_hidden, kb2, gates1, num_heads)
    out = bindings.fused_attention(_rows(hidden), _rows(encoder_hidden.to(hidden.dtype)),
                                   _weights(params), kb2, gates1, batch=b, tq=t, s=s)
    fused_cross_attention.launches += 1
    return out.reshape(b, t, d)


def fused_cross_attention_grouped(params: dict, hidden: torch.Tensor,
                                  encoder_hidden: torch.Tensor, *, num_heads: int,
                                  kv_groups: int, mask: Optional[torch.Tensor] = None,
                                  key_bias: Optional[torch.Tensor] = None,
                                  head_z: Optional[torch.Tensor] = None,
                                  ln_params: Optional[dict] = None,
                                  ln_eps: float = 1e-12) -> torch.Tensor:
    """Grouped cross-attention sublayer: queries hidden [Bk*G, T, D] (groups
    contiguous), keys/values encoder_hidden [Bk, S, De] projected once per
    image; mask / key_bias per image [Bk, S]. With ln_params
    {'scale','bias'} returns LN(hidden + attn_out), the BERT layer's
    residual + post-LN. A query batch other than Bk*G is an error."""
    b, t, d = hidden.shape
    bk, s, _ = encoder_hidden.shape
    g = kv_groups
    if b != bk * g:
        raise ValueError(f"fused grouped cross: query batch {b} != {g} * kv batch {bk}")
    kb2 = _key_bias(bk, s, mask, key_bias, hidden.device)
    gates1 = _gates(num_heads, head_z, hidden.device)
    if not hidden.is_cuda:
        return cross_attention_grouped_plain(params, hidden, encoder_hidden, kb2, gates1,
                                             num_heads, g, ln_params, ln_eps)
    ln = None if ln_params is None else (ln_params["scale"].float().contiguous(),
                                         ln_params["bias"].float().contiguous())
    # a group's G*T query rows are contiguous, so the kernel sees Bk batch
    # rows of G*T queries each: K/V are projected for the Bk images only and
    # one K/V tile in shared memory serves the whole group
    out = bindings.fused_attention(_rows(hidden), _rows(encoder_hidden.to(hidden.dtype)),
                                   _weights(params), kb2, gates1, batch=bk, tq=g * t, s=s,
                                   ln=ln, ln_eps=ln_eps)
    fused_cross_attention_grouped.launches += 1
    return out.reshape(b, t, d)


fused_self_attention.launches = 0
fused_cross_attention.launches = 0
fused_cross_attention_grouped.launches = 0
