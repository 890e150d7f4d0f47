"""Fused attention sublayers: Q/K/V projections -> attention -> head gates ->
output projection, as one call.

Ports of efficientvlm_tpu/ops/pallas_fused_mha.py:
- `fused_self_attention`   <- `_fused_mha_padded` / `_fused_kernel`;
- `fused_cross_attention`  <- `_fused_cross_padded` / `_fused_cross_kernel`;
- `fused_cross_attention_grouped` <- `_fused_cross_grouped_padded` /
  `_fused_cross_grouped_kernel` (G contiguous query rows share one image's
  K/V; K/V are projected once per image; optional residual + post-LN);
- `fused_cross_attention_bank` <- `_fused_cross_kernel` after its K/V
  projection: the K/V of a bank of images, projected once
  (`project_kv_rows`), read by a per-row image index (the t2i rerank,
  whose candidate images are shared by many texts in no contiguous order).

On a CUDA tensor each wrapper runs csrc/fused_mha.cu, whose hand-written
kernels are gemm_bias for the projections, an attention core for all heads
(attn_core, its indexed form for the bank; for the grouped sublayer at
head dim 64 attn_wgmma) and, for the grouped sublayer with ln_params,
gemm_ln: the output projection with the
residual + post-LN in its epilogue (widths outside bindings.gemm_ln_fits:
gemm_bias into f32 + residual_layernorm). Four device launches per grouped
call with the f32 key bias the models pass: biases, gates and LN params are
read as stored (bf16 or f32; see bindings._vecs). It computes in bfloat16 with f32
accumulation and raises on anything else. On a CPU tensor it runs the plain
PyTorch version below, which does the same arithmetic. The
arithmetic follows the TPU kernels: projections accumulate in f32, add the
bias in f32 and round to the compute dtype; scores and softmax are f32;
probabilities are rounded before P.V; each head's f32 context is scaled by
head_z[h] and rounded before the output projection.

The training forms (ports of `_dv_self` / `_dv_cross` and the emit_probs
instances of the TPU kernels): `return_probs=True` also returns the pre-gate
f32 softmax maps [B, H, Tq, Tk] that the KD taps read (on CUDA the probs
core attn_probs, which stages each row's scores in shared memory and stores
the maps by TMA while it attends; attn_core's two-sweep form outside
bindings.probs_tile; counted in `probs_launches`, the core that served each
call in bindings.probs_routes); `differentiable=True` runs the kernel inside a
torch.autograd.Function that saves its inputs only and whose backward
recomputes the plain version under autograd and takes its gradients, as
JAX's custom_vjp recomputes its XLA reference. Cotangents flow into both
outputs, and the gradient of head_z is how the losses reach the L0 gates.
On a CPU tensor autograd runs straight through the plain versions.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..kernels import bindings
from .basic import ACT2FN, recompute_grads

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


def _attention_plain(q, k, v, kb2, gates1, num_heads: int, groups: int = 1,
                     return_probs: bool = False):
    """q [Bk*G, Tq, A], k/v [Bk, S, A] (dt), kb2 [Bk, S] f32 -> ctx [Bk*G, Tq, A]
    (and the pre-gate f32 probabilities [Bk*G, H, Tq, S] with return_probs)."""
    dt = q.dtype
    bq, tq, a = q.shape
    bk, s = k.shape[:2]
    dh = a // num_heads
    qh = _split(q, num_heads).float().reshape(bk, groups, num_heads, tq, dh)
    kh = _split(k, num_heads).float()[:, None]
    vh = _split(v, num_heads).float()[:, None]
    scores = qh @ kh.transpose(-1, -2) * dh ** -0.5 + kb2[:, None, None, None, :]
    probs = torch.softmax(scores, dim=-1)
    ctx = (probs.to(dt).float() @ vh) * gates1.reshape(1, 1, num_heads, 1, 1)
    ctx = ctx.reshape(bq, num_heads, tq, dh).transpose(1, 2).reshape(bq, tq, a).to(dt)
    if return_probs:
        return ctx, probs.reshape(bq, num_heads, tq, s)
    return ctx


def gemm_bias_plain(a, b, bias=None, row_add=None, out_f32: bool = False, act: str = "none"):
    """Plain version of the projection kernel (bindings.gemm_bias): a [M, K]
    @ b [K, N] in f32 (+ bias [N]) (+ row_add[m % period]), then the
    activation `act` (ops/basic.ACT2FN's, "none" the identity) in f32,
    rounded to a's dtype unless out_f32."""
    y = a.float() @ b.float()
    if bias is not None:
        y = y + bias.float()
    if row_add is not None:
        y = y + row_add.float()[torch.arange(y.shape[0], device=y.device) % row_add.shape[0]]
    if act != "none":
        y = ACT2FN[act](y)
    return y if out_f32 else y.to(a.dtype)


def attn_core_plain(q, k, v, kb2, gates1, *, batch: int, tq: int, s: int,
                    probs: bool = False):
    """Plain version of both attention kernels, bindings.attn_core and
    bindings.attn_wgmma (the same function): q [batch*tq, A], k/v [batch*s,
    A], heads side by side; kb2 [batch, s], gates1 [H]; with probs also the
    f32 maps [batch, H, tq, s] (attn_core's probs form)."""
    a = q.shape[1]
    res = _attention_plain(q.reshape(batch, tq, a), k.reshape(batch, s, a),
                           v.reshape(batch, s, a), kb2, gates1, gates1.shape[0],
                           return_probs=probs)
    ctx, maps = res if probs else (res, None)
    ctx = ctx.reshape(batch * tq, a)
    return (ctx, maps) if probs else ctx


def gemm_ln_plain(a, b, gamma, beta, eps: float, *, bias=None, row_add=None, residual=None,
                  out=None, group=None, out_group_stride=None, out_offset: int = 0):
    """Plain version of the GEMM with the LayerNorm epilogue
    (bindings.gemm_ln): y = a [M, K] @ b [K, N] + bias + row_add[m % period]
    + residual, all in f32; the mean, then the mean of (y - mean)^2; (y -
    mean) * rsqrt(var + eps) * gamma + beta rounded to a's dtype, row m
    written at (m // group) * out_group_stride + out_offset + m % group of
    `out` (default: a new [M, N], rows in order)."""
    y = a.float() @ b.float()
    if bias is not None:
        y = y + bias.float()
    if row_add is not None:
        y = y + row_add.float()[torch.arange(y.shape[0], device=y.device) % row_add.shape[0]]
    if residual is not None:
        y = y + residual.float()
    mean = y.mean(-1, keepdim=True)
    c = y - mean
    var = (c * c).mean(-1, keepdim=True)
    y = (c * torch.rsqrt(var + eps) * gamma.float() + beta.float()).to(a.dtype)
    group = y.shape[0] if group is None else group
    out_group_stride = group if out_group_stride is None else out_group_stride
    if out is None:
        out = torch.empty_like(y)
    rows = torch.arange(y.shape[0], device=y.device)
    out[rows // group * out_group_stride + out_offset + rows % group] = y
    return out


def self_attention_plain(params, hidden, kb2, gates1, num_heads: int,
                         return_probs: bool = False):
    return cross_attention_plain(params, hidden, hidden, kb2, gates1, num_heads, return_probs)


def cross_attention_plain(params, hidden, enc, kb2, gates1, num_heads: int,
                          return_probs: bool = False):
    """Plain version of #2 (enc = hidden) and #3: the output [B, Tq, D] in
    hidden's dtype, and with return_probs the pre-gate f32 maps."""
    dt = hidden.dtype
    enc = enc.to(dt)
    q = _linear_plain(hidden, params["q"], dt)
    k = _linear_plain(enc, params["k"], dt)
    v = _linear_plain(enc, params["v"], dt)
    res = _attention_plain(q, k, v, kb2, gates1, num_heads, return_probs=return_probs)
    ctx, probs = res if return_probs else (res, None)
    out = _linear_plain(ctx, params["out"], dt)
    return (out, probs) if return_probs else out


def cross_attention_bank_plain(params, hidden, k_bank, v_bank, kv_rows, kb2, gates1,
                               num_heads: int):
    """Plain version of the bank form: the bank's K/V rows gathered by
    kv_rows, then #3's arithmetic after its K/V projection."""
    dt = hidden.dtype
    idx = kv_rows.long()
    q = _linear_plain(hidden, params["q"], dt)
    ctx = _attention_plain(q, k_bank[idx].to(dt), v_bank[idx].to(dt), kb2, gates1, num_heads)
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


def _weights(params: dict, names=("q", "k", "v", "out")) -> dict:
    """bf16 [in, out] kernels and the biases as stored, as csrc/fused_mha.cu
    takes them (no copy for bf16 params): w/b + q, k, v, o."""
    w = {}
    for name in names:
        w["w" + name[0]] = params[name]["kernel"].to(torch.bfloat16).contiguous()
        w["b" + name[0]] = bindings.as_stored(params[name]["bias"])
    return w


def _kernel_gates(num_heads: int, head_z) -> Optional[torch.Tensor]:
    """head_z as the kernels read it, or None for all ones."""
    return None if head_z is None else bindings.as_stored(head_z.reshape(num_heads))


def _rows(x: torch.Tensor) -> torch.Tensor:
    if x.dtype != torch.bfloat16:
        raise TypeError(f"the fused attention kernels compute in bfloat16, got {x.dtype}")
    return x.reshape(-1, x.shape[-1]).contiguous()


# --------------------------------------------------------------------------
# the training forms: kernel forward, plain-recompute backward
# --------------------------------------------------------------------------

_LEAVES = (("q", "kernel"), ("q", "bias"), ("k", "kernel"), ("k", "bias"), ("v", "kernel"),
           ("v", "bias"), ("out", "kernel"), ("out", "bias"))


def _tree(leaves) -> dict:
    params: dict = {}
    for (name, leaf), t in zip(_LEAVES, leaves):
        params.setdefault(name, {})[leaf] = t
    return params


def _attention_cuda(params, hidden, enc, kb2, head_z, num_heads: int, return_probs: bool):
    """One launch of #2 (enc None) or #3 on CUDA tensors; counted."""
    b, t, d = hidden.shape
    s = t if enc is None else enc.shape[1]
    x = _rows(hidden)
    e = x if enc is None else _rows(enc.to(hidden.dtype))
    res = bindings.fused_attention(x, e, _weights(params), kb2, _kernel_gates(num_heads, head_z),
                                   heads=num_heads, batch=b, tq=t, s=s, probs=return_probs)
    wrapper = fused_self_attention if enc is None else fused_cross_attention
    if return_probs:
        wrapper.probs_launches += 1
        return res[0].reshape(b, t, d), res[1]
    wrapper.launches += 1
    return res.reshape(b, t, d)


class _AttentionFn(torch.autograd.Function):
    """Port of _dv_self / _dv_cross: the forward launches the kernel (with
    probs when asked) and saves its inputs only; the backward recomputes
    cross_attention_plain with the same bf16 casts under autograd and returns
    the gradients of every weight and bias, of hidden, of the encoder hidden
    and of the gates. Inputs: the key bias [B, S] f32, head_z (or None),
    hidden, enc (None for self-attention), then the eight leaves of _LEAVES
    (f32 masters are cast inside, so their gradients come back in f32)."""

    @staticmethod
    def forward(ctx, num_heads, return_probs, kb2, head_z, hidden, enc, *leaves):
        ctx.num_heads, ctx.return_probs = num_heads, return_probs
        ctx.save_for_backward(kb2, head_z, hidden, enc, *leaves)
        return _attention_cuda(_tree(leaves), hidden, enc, kb2, head_z, num_heads, return_probs)

    @staticmethod
    def backward(ctx, *cotangents):
        h = ctx.num_heads

        def plain(kb2, head_z, hidden, enc, *leaves):
            return cross_attention_plain(_tree(leaves), hidden, hidden if enc is None else enc,
                                         kb2, _gates(h, head_z, hidden.device), h,
                                         ctx.return_probs)

        return (None, None) + recompute_grads(plain, ctx.saved_tensors,
                                              ctx.needs_input_grad[2:], cotangents)


def _attention(params, hidden, enc, kb2, head_z, num_heads, return_probs, differentiable):
    if not hidden.is_cuda:  # the plain version, autograd straight through it
        return cross_attention_plain(params, hidden, hidden if enc is None else enc, kb2,
                                     _gates(num_heads, head_z, hidden.device), num_heads,
                                     return_probs)
    if differentiable:
        return _AttentionFn.apply(num_heads, return_probs, kb2,
                                  None if head_z is None else head_z.reshape(num_heads), hidden,
                                  enc, *(params[n][l] for n, l in _LEAVES))
    return _attention_cuda(params, hidden, enc, kb2, head_z, num_heads, return_probs)


# --------------------------------------------------------------------------
# wrappers
# --------------------------------------------------------------------------


def fused_self_attention(params: dict, hidden: torch.Tensor, *, num_heads: int,
                         mask: Optional[torch.Tensor] = None,
                         key_bias: Optional[torch.Tensor] = None,
                         head_z: Optional[torch.Tensor] = None, return_probs: bool = False,
                         differentiable: bool = False):
    """Self-attention sublayer over params {'q','k','v','out'}; hidden
    [B,T,D]; mask [B,T] (1 = attend) or key_bias [B,T] additive; head_z [H].
    The projection width A = H*dh may be below D (pruned exports). Returns
    [B,T,D], or (that, probs [B,H,T,T] f32) with return_probs;
    differentiable=True is the training form (see the module note)."""
    b, t, _ = hidden.shape
    kb2 = _key_bias(b, t, mask, key_bias, hidden.device)
    return _attention(params, hidden, None, kb2, head_z, num_heads, return_probs,
                      differentiable)


def fused_cross_attention(params: dict, hidden: torch.Tensor, encoder_hidden: torch.Tensor,
                          *, num_heads: int, mask: Optional[torch.Tensor] = None,
                          key_bias: Optional[torch.Tensor] = None,
                          head_z: Optional[torch.Tensor] = None, return_probs: bool = False,
                          differentiable: bool = False):
    """Cross-attention sublayer: queries from hidden [B,T,D], keys/values
    from encoder_hidden [B,S,De]; mask / key_bias [B,S]; head_z [H]. Returns
    [B,T,D], or (that, probs [B,H,T,S] f32) with return_probs."""
    b = hidden.shape[0]
    s = encoder_hidden.shape[1]
    if encoder_hidden.shape[0] != b:
        raise ValueError(f"fused cross: query batch {b} != kv batch {encoder_hidden.shape[0]}")
    kb2 = _key_bias(b, s, mask, key_bias, hidden.device)
    return _attention(params, hidden, encoder_hidden, kb2, head_z, num_heads, return_probs,
                      differentiable)


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
    if not hidden.is_cuda:
        return cross_attention_grouped_plain(params, hidden, encoder_hidden, kb2,
                                             _gates(num_heads, head_z, "cpu"), num_heads, g,
                                             ln_params, ln_eps)
    ln = None if ln_params is None else (bindings.as_stored(ln_params["scale"]),
                                         bindings.as_stored(ln_params["bias"]))
    # a group's G*T query rows are contiguous, so the kernel sees Bk batch
    # rows of G*T queries each: K/V are projected for the Bk images only and
    # one (image, head)'s K/V serve the whole group
    out = bindings.fused_attention(_rows(hidden), _rows(encoder_hidden.to(hidden.dtype)),
                                   _weights(params), kb2, _kernel_gates(num_heads, head_z),
                                   heads=num_heads, batch=bk, tq=g * t, s=s, grouped=True,
                                   ln=ln, ln_eps=ln_eps)
    fused_cross_attention_grouped.launches += 1
    return out.reshape(b, t, d)


def project_kv_rows(params: dict, enc: torch.Tensor, *, dtype=None) -> dict:
    """The K/V of encoder rows enc [N, S, De], projected as the fused cross
    sublayer projects them inside its call, for fused_cross_attention_bank:
    {"k", "v"} [N, S, A] in the compute dtype (dtype, else enc's), heads
    side by side. On CUDA gemm_bias (bf16), the kernel and arithmetic of
    #3's own K/V projection, so that a bank row equals what #3 computes for
    that row; on the CPU the plain version's."""
    dt = dtype or enc.dtype
    enc = enc.to(dt)
    if not enc.is_cuda:
        return {name: _linear_plain(enc, params[name], dt) for name in ("k", "v")}
    n, s = enc.shape[:2]
    x, w = _rows(enc), _weights(params, ("k", "v"))
    return {name: bindings.gemm_bias(x, w["w" + name], w["b" + name]).reshape(n, s, -1)
            for name in ("k", "v")}


def fused_cross_attention_bank(params: dict, hidden: torch.Tensor, k_bank: torch.Tensor,
                               v_bank: torch.Tensor, kv_rows: torch.Tensor, *, num_heads: int,
                               mask: Optional[torch.Tensor] = None,
                               key_bias: Optional[torch.Tensor] = None,
                               head_z: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Cross-attention sublayer over a K/V bank: queries hidden [B,T,D];
    k_bank / v_bank [N,S,A], each encoder row's K/V projected once
    (project_kv_rows); query row b attends to bank row kv_rows[b] (int32
    [B], each in [0, N): on the card a row outside comes out NaN, unread,
    on the CPU it raises); mask / key_bias [B,S], per query row; head_z
    [H]. Returns [B,T,D], what fused_cross_attention returns over the
    encoder rows enc[kv_rows]. Eval only: no probs, no differentiable
    form."""
    b, t, d = hidden.shape
    n, s, a = k_bank.shape
    kb2 = _key_bias(b, s, mask, key_bias, hidden.device)
    if not hidden.is_cuda:
        if kv_rows.numel() and not 0 <= int(kv_rows.min()) <= int(kv_rows.max()) < n:
            raise ValueError(f"fused bank cross: kv_rows outside a bank of {n} rows")
        return cross_attention_bank_plain(params, hidden, k_bank, v_bank, kv_rows, kb2,
                                          _gates(num_heads, head_z, "cpu"), num_heads)
    out = bindings.fused_attention_bank(_rows(hidden), k_bank.reshape(n * s, a),
                                        v_bank.reshape(n * s, a), kv_rows,
                                        _weights(params, ("q", "out")), kb2,
                                        _kernel_gates(num_heads, head_z), heads=num_heads,
                                        batch=b, tq=t, s=s)
    fused_cross_attention_bank.launches += 1
    return out.reshape(b, t, d)


fused_self_attention.launches = 0
fused_self_attention.probs_launches = 0
fused_cross_attention.launches = 0
fused_cross_attention.probs_launches = 0
fused_cross_attention_grouped.launches = 0
fused_cross_attention_bank.launches = 0
