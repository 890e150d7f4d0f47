"""Mixture-of-Experts FFN, Switch-style top-1, on one device (port of
efficientvlm_tpu/ops/moe.py; the reference's FFNs are dense).

- Dense dispatch: one-hot dispatch / combine tensors and three einsums, no
  data-dependent shape.
- Static capacity C = ceil(capacity_factor * T / E): tokens routed past
  their expert's capacity are dropped (their output is zero; the caller's
  residual carries them).
- The load-balancing loss of the Switch Transformer: E * sum_e f_e * P_e
  over the tokens.

Expert parallelism (JAX's expert_partition_spec and make_ep_mesh: the
expert axis sharded over devices) comes with distribution.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .basic import gelu_new


def init_moe_ffn(generator: Optional[torch.Generator] = None, *, hidden: int, ffn: int,
                 num_experts: int, device=None) -> dict:
    def normal(*shape, std):
        return torch.randn(shape, generator=generator, device=device) * std

    s1, s2 = 1.0 / math.sqrt(hidden), 1.0 / math.sqrt(ffn)
    return {"router": {"kernel": normal(hidden, num_experts, std=s1)},
            "wi": normal(num_experts, hidden, ffn, std=s1),
            "bi": torch.zeros(num_experts, ffn, device=device),
            "wo": normal(num_experts, ffn, hidden, std=s2),
            "bo": torch.zeros(num_experts, hidden, device=device)}


def moe_ffn(params: dict, h: torch.Tensor, *,
            capacity_factor: float = 1.25) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-1 MoE FFN over h [B, S, D] (or [T, D]), in h's dtype. Returns
    (out in h's shape, aux_loss): each kept token's expert FFN (the tanh
    GELU, jax.nn.gelu's default) output scaled by its router probability;
    tokens past capacity give zero. Slots go in token order (a stable
    cumulative count)."""
    orig_shape = h.shape
    x = h.reshape(-1, orig_shape[-1])
    t, e = x.shape[0], params["wi"].shape[0]
    cap = max(1, math.ceil(capacity_factor * t / e))

    logits = x @ params["router"]["kernel"].to(x.dtype)          # [T, E]
    probs = torch.softmax(logits.float(), dim=-1)
    gate, choice = probs.max(-1)                                # [T]
    onehot = F.one_hot(choice, e)                               # [T, E]
    slot = (torch.cumsum(onehot, 0) * onehot).sum(-1) - 1       # [T], 0-based
    keep = (slot >= 0) & (slot < cap)
    slot_hot = F.one_hot(torch.where(keep, slot, 0), cap).to(x.dtype) * keep[:, None].to(x.dtype)
    dispatch = onehot.to(x.dtype)[:, :, None] * slot_hot[:, None, :]   # [T, E, C]
    combine = dispatch * gate.to(x.dtype)[:, None, None]

    expert_in = torch.einsum("td,tec->ecd", x, dispatch)        # [E, C, D]
    hmid = gelu_new(torch.einsum("ecd,edf->ecf", expert_in, params["wi"].to(x.dtype))
               + params["bi"].to(x.dtype)[:, None, :])
    expert_out = (torch.einsum("ecf,efd->ecd", hmid, params["wo"].to(x.dtype))
                  + params["bo"].to(x.dtype)[:, None, :])
    out = torch.einsum("ecd,tec->td", expert_out, combine)      # [T, D]

    frac = onehot.float().mean(0)
    aux = e * (frac * probs.mean(0)).sum()
    return out.reshape(orig_shape), aux
