"""Mixture-of-Experts FFN, Switch-style top-1, on one device (port of
efficientvlm_tpu/ops/moe.py; the reference's FFNs are dense).

- Dense dispatch: one-hot dispatch / combine tensors and three einsums, no
  data-dependent shape.
- Static capacity C = ceil(capacity_factor * T / E): tokens routed past
  their expert's capacity are dropped (their output is zero; the caller's
  residual carries them).
- The load-balancing loss of the Switch Transformer: E * sum_e f_e * P_e
  over the tokens.

Expert parallelism (JAX's expert_partition_spec / make_ep_mesh, whose
sharded expert axis GSPMD serves with all-to-alls): each rank of a group
holds E / n experts (shard_experts: the leading axis cut, the router
replicated) and its own block of the tokens. moe_ffn_ep routes its tokens
with the replicated router, numbers their slots as the one-device op would
over all the tokens in rank order (each rank's per-expert counts gathered,
the ranks before it counted first), dispatches each expert's slot rows to
the expert's owner by an all-to-all (the owners sum the ranks' rows; each
slot has one token), runs its own experts, and returns each rank the rows
of its tokens' slots by a second all-to-all; the aux loss sums the
routing statistics over the ranks. Forward only: the all-to-alls carry no
gradient.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..utils import dist as D
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


def expert_partition_spec() -> dict:
    """The dim of each init_moe_ffn leaf that expert parallelism shards
    (the experts' leading axis), None for the replicated router."""
    return {"router": {"kernel": None}, "wi": 0, "bi": 0, "wo": 0, "bo": 0}


def shard_experts(params: dict, group=None) -> dict:
    """This rank's experts (E / n of them, in rank order) and the router."""
    n, r = D.dist.get_world_size(group), D.dist.get_rank(group)
    e = params["wi"].shape[0]
    if e % n:
        raise ValueError(f"expert parallelism: {e} experts over {n} ranks")
    k = e // n
    return {"router": params["router"],
            **{name: params[name][r * k:(r + 1) * k].clone() for name in ("wi", "bi", "wo", "bo")}}


def moe_ffn_ep(params: dict, h: torch.Tensor, *, group=None,
               capacity_factor: float = 1.25) -> Tuple[torch.Tensor, torch.Tensor]:
    """moe_ffn over the tokens of every rank of `group` (each rank its
    block h [B, S, D] or [T, D], equal sizes; the global token order is the
    ranks' blocks in rank order) with the experts sharded (shard_experts):
    this rank's output rows and the aux loss, each equal to the one-device
    op's over all the tokens."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (h, *params.values())
                                       if torch.is_tensor(t)):
        raise NotImplementedError("expert parallelism is forward only: run it under "
                                  "torch.no_grad()")
    n, r = D.dist.get_world_size(group), D.dist.get_rank(group)
    orig_shape = h.shape
    x = h.reshape(-1, orig_shape[-1])
    t_local, el = x.shape[0], params["wi"].shape[0]
    t, e = t_local * n, el * n
    cap = max(1, math.ceil(capacity_factor * t / e))

    logits = x @ params["router"]["kernel"].to(x.dtype)
    probs = torch.softmax(logits.float(), dim=-1)
    gate, choice = probs.max(-1)
    onehot = F.one_hot(choice, e)                                  # [T_local, E]
    counts = D.all_gather_rows(onehot.sum(0)[None], group)         # [n, E]
    before = counts[:r].sum(0)
    slot = ((torch.cumsum(onehot, 0) + before) * onehot).sum(-1) - 1
    keep = (slot >= 0) & (slot < cap)
    slot_hot = F.one_hot(torch.where(keep, slot, 0), cap).to(x.dtype) * keep[:, None].to(x.dtype)
    dispatch = onehot.to(x.dtype)[:, :, None] * slot_hot[:, None, :]   # [T_local, E, C]
    combine = dispatch * gate.to(x.dtype)[:, None, None]

    rows = torch.einsum("td,tec->ecd", x, dispatch)                # this rank's tokens' slots
    mine = D.all_to_all_rows(rows, group).reshape(n, el, cap, -1).sum(0)   # [E/n, C, D]
    hmid = gelu_new(torch.einsum("ecd,edf->ecf", mine, params["wi"].to(x.dtype))
                    + params["bi"].to(x.dtype)[:, None, :])
    expert_out = (torch.einsum("ecf,efd->ecd", hmid, params["wo"].to(x.dtype))
                  + params["bo"].to(x.dtype)[:, None, :])
    # each destination gets the slots its tokens hold: rank j's tokens of
    # expert g sit in slots [start_jg, start_jg + count_jg)
    starts = torch.cumsum(counts, 0) - counts                      # [n, E]
    mine_ex = slice(r * el, (r + 1) * el)
    c = torch.arange(cap, device=x.device)
    held = ((c >= starts[:, mine_ex, None]) & (c < (starts + counts)[:, mine_ex, None]))
    send = expert_out[None] * held[..., None].to(expert_out.dtype)  # [n, E/n, C, D]
    back = D.all_to_all_rows(send.reshape(n * el, cap, -1), group)     # [E, C, D]
    out = torch.einsum("ecd,tec->td", back, combine)

    frac = D.all_reduce_sum(onehot.float().sum(0), group) / t
    mean_prob = D.all_reduce_sum(probs.sum(0), group) / t
    aux = e * (frac * mean_prob).sum()
    return out.reshape(orig_shape), aux
