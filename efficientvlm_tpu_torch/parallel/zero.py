"""ZeRO-1: the optimizer state sharded over the data-parallel ranks (port of
efficientvlm_tpu/parallel/zero.py).

JAX declares the AdamW moments sharded over its data axis and lets XLA place
the collectives. The port runs one process a device, so each rank keeps its
own slice of every sharded moment and its optimizer steps on that slice:

- zero1_state_specs / moment_shard_dim: each moment leaf of rank >= 2 is
  sharded on its largest dim that divides by the world size; 1-D and scalar
  leaves (biases, LayerNorms, λ, counts) stay replicated. This covers the
  three optimizers' states (opt_state, l0_state, lam_state; GD's opt_state);
- Zero1 wraps an optimizer (AdamW, or MultiSteps / ApplyIfFinite around
  one): a reduce-scatter of each sharded leaf's gradient (the mean over the
  ranks), the update of this rank's slice of the param (a view, so AdamW's
  in-place update lands in the param), then an all-gather of the updated
  slices; the replicated leaves take the all-reduce mean. The gradient clip
  stays global (the shards' squares summed over the ranks, the replicated
  leaves counted once; optim.shard_optimizer), and ApplyIfFinite skips on
  every rank when one rank saw a non-finite gradient;
- Zero1Sync (the step's data_parallel): rank 0's state broadcast once, the
  moments then cut to this rank's slices (shard_moments), the metrics
  averaged, the gradients left to Zero1; the ITC still gathers the world
  batch over its group.

A sharded optimizer state carries its layout under DIMS_KEY (the dim of
each leaf, -1 for replicated), so a save can gather it (gather_moments, the
default single-file backend) or write it as it is (train/sharded_io), and a
restore can cut a full state (shard_saved). One process is a no-op, as in
JAX.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch

from ..train.optim import shard_optimizer, tree_leaves
from ..utils import dist as D

DIMS_KEY = "zero1_dims"
MOMENT_FIELDS = {"opt_state": "params", "l0_state": "loga", "lam_state": "lam"}


def moment_shard_dim(shape, n: int) -> Optional[int]:
    """The largest dim that divides by n (the first of equal ones), None for
    1-D and scalar leaves or when none divides (JAX's _moment_spec)."""
    shape = tuple(shape)
    if len(shape) < 2:
        return None
    for d in sorted(range(len(shape)), key=lambda i: -shape[i]):
        if shape[d] >= n and shape[d] % n == 0:
            return d
    return None


def _fields(state) -> list:
    return [f.name for f in dataclasses.fields(state)]


def zero1_state_specs(state, n: int) -> dict:
    """{field: per-leaf shard dims or None}: for each optimizer-state field,
    the shard dim of the moments of each leaf it steps (params, loga, λ);
    the other fields (params, gates, λ, step) None, replicated."""
    specs = {}
    for name in _fields(state):
        owner = MOMENT_FIELDS.get(name)
        specs[name] = (None if owner is None else
                       [moment_shard_dim(t.shape, n) for t in tree_leaves(getattr(state, owner))])
    return specs


def _view(p: torch.Tensor, d: Optional[int], rank: int, world: int) -> torch.Tensor:
    if d is None:
        return p
    k = p.shape[d] // world
    return p.movedim(d, 0).narrow(0, rank * k, k).movedim(0, d)


def leaf_lists(opt_state: dict, n: int, path: tuple = ()):
    """(path, container, key) of each per-leaf list of n tensors in an
    optimizer state (AdamW's mu / nu, MultiSteps' acc_grads), through its
    wrappers."""
    for k, v in opt_state.items():
        if k == DIMS_KEY:
            continue
        if isinstance(v, dict):
            yield from leaf_lists(v, n, path + (k,))
        elif isinstance(v, list) and len(v) == n and v and all(torch.is_tensor(t) for t in v):
            yield path + (k,), opt_state, k


def copy_dicts(node: dict) -> dict:
    """A copy of the nested dicts (lists copied, tensors shared)."""
    return {k: copy_dicts(v) if isinstance(v, dict) else (list(v) if isinstance(v, list) else v)
            for k, v in node.items()}


def dims_of(opt_state: dict) -> List[Optional[int]]:
    return [None if d < 0 else d for d in opt_state[DIMS_KEY]]


def is_sharded(state) -> bool:
    return any(isinstance(getattr(state, f, None), dict) and DIMS_KEY in getattr(state, f)
               for f in MOMENT_FIELDS)


def shard_moments(state, group=None):
    """Cut each optimizer state's moments to this rank's slices (in place;
    a state already sharded stays as it is). Returns the state."""
    rank, world = D.dist.get_rank(group), D.dist.get_world_size(group)
    for name in _fields(state):
        owner, opt_state = MOMENT_FIELDS.get(name), getattr(state, name)
        if owner is None or DIMS_KEY in opt_state:
            continue
        leaves = tree_leaves(getattr(state, owner))
        dims = [moment_shard_dim(t.shape, world) for t in leaves]
        for _, box, k in leaf_lists(opt_state, len(leaves)):
            box[k] = [_view(t, d, rank, world).contiguous().clone() for t, d in zip(box[k], dims)]
        opt_state[DIMS_KEY] = [-1 if d is None else d for d in dims]
    return state


def gather_moments(state, group=None):
    """A copy of the state (the same params) with every sharded moment
    gathered whole and the layout dropped: what a replicated run holds. A
    collective: every rank calls it."""
    out = dataclasses.replace(state)
    for name in MOMENT_FIELDS:
        opt_state = getattr(state, name, None)
        if not isinstance(opt_state, dict) or DIMS_KEY not in opt_state:
            continue
        dims = dims_of(opt_state)
        full = copy_dicts(opt_state)
        full.pop(DIMS_KEY)
        for _, box, k in leaf_lists(full, len(dims)):
            box[k] = [t if d is None else D.gather_dim(t.detach(), d, group)
                      for t, d in zip(box[k], dims)]
        setattr(out, name, full)
    return out


def shard_saved(template, saved: dict, group=None) -> dict:
    """A saved state's field dict (whole moments) cut to the layout of a
    sharded template, so it restores into it."""
    rank, world = D.dist.get_rank(group), D.dist.get_world_size(group)
    saved = dict(saved)
    for name in MOMENT_FIELDS:
        tmpl = getattr(template, name, None)
        if not isinstance(tmpl, dict) or DIMS_KEY not in tmpl or DIMS_KEY in saved[name]:
            continue
        dims = dims_of(tmpl)
        cut = copy_dicts(saved[name])
        for _, box, k in leaf_lists(cut, len(dims)):
            box[k] = [_view(t, d, rank, world).contiguous() for t, d in zip(box[k], dims)]
        cut[DIMS_KEY] = list(tmpl[DIMS_KEY])
        saved[name] = cut
    return saved


def sharded_moment_bytes(state) -> dict:
    """Per-rank vs replicated optimizer-state bytes (every tensor of the
    optimizers' states; a sharded leaf's whole size is its slice's times
    the world)."""
    total = local = 0
    for name in MOMENT_FIELDS:
        opt_state = getattr(state, name, None)
        if not isinstance(opt_state, dict):
            continue
        seen = set()
        if DIMS_KEY in opt_state:
            dims, world = dims_of(opt_state), D.get_world_size()
            for _, box, k in leaf_lists(opt_state, len(dims)):
                seen.add(id(box[k]))
                for t, d in zip(box[k], dims):
                    n = t.numel() * t.element_size()
                    local += n
                    total += n * (1 if d is None else world)
        for t in _other_tensors(opt_state, seen):
            n = t.numel() * t.element_size()
            local += n
            total += n
    return {"replicated_bytes": total, "per_device_bytes": local}


def _other_tensors(node, seen: set):
    for k, v in node.items():
        if isinstance(v, dict):
            yield from _other_tensors(v, seen)
        elif isinstance(v, list):
            if id(v) not in seen:
                yield from (t for t in v if torch.is_tensor(t))
        elif torch.is_tensor(v):
            yield v


# ---------------------------------------------------------------------------
# the step


def _buckets(idx: list, sizes: list, bucket_bytes: int) -> list:
    out, bucket, size = [], [], 0
    for i in idx:
        if bucket and size + sizes[i] > bucket_bytes:
            out.append(bucket)
            bucket, size = [], 0
        bucket.append(i)
        size += sizes[i]
    if bucket:
        out.append(bucket)
    return out


class Zero1:
    """ZeRO-1 around one optimizer (see the module note). Its state is the
    inner optimizer's over this rank's slices, with DIMS_KEY; Zero1Sync.begin
    (or shard_moments) cuts it from a whole one."""

    def __init__(self, inner, group=None):
        self.inner, self.group = inner, group

    def init(self, leaves: list) -> dict:
        return self.inner.init(leaves)

    @torch.no_grad()
    def step(self, leaves: list, grads: list, state: dict) -> None:
        group = self.group
        rank, world = D.dist.get_rank(group), D.dist.get_world_size(group)
        if DIMS_KEY not in state:
            raise RuntimeError("ZeRO-1: the optimizer state is whole; the step's data_parallel "
                               "(Zero1Sync.begin) shards it before the first update")
        dims = dims_of(state)
        shard_optimizer(self.inner, [d is not None for d in dims], group)
        grads = [torch.zeros_like(p, dtype=torch.float32) if g is None else g.float()
                 for p, g in zip(leaves, grads)]
        out = list(grads)
        repl = [i for i, d in enumerate(dims) if d is None]
        for i, g in zip(repl, D.all_reduce_mean([grads[i] for i in repl], group)):
            out[i] = g
        spread = [i for i, d in enumerate(dims) if d is not None]
        sizes = [g.numel() * 4 for g in grads]
        for bucket in _buckets(spread, sizes, D.BUCKET_BYTES):
            rows = torch.cat([grads[i].movedim(dims[i], 0).reshape(world, -1) for i in bucket], 1)
            mine = D.reduce_scatter_sum(rows.reshape(-1), group).div_(world)
            at = 0
            for i in bucket:
                moved = grads[i].movedim(dims[i], 0)
                shape = (moved.shape[0] // world,) + tuple(moved.shape[1:])
                n = grads[i].numel() // world
                out[i] = mine[at:at + n].view(shape).movedim(0, dims[i])
                at += n
        views = [_view(p, d, rank, world) for p, d in zip(leaves, dims)]
        self.inner.step(views, out, state)
        for bucket in _buckets(spread, sizes, D.BUCKET_BYTES):
            mine = torch.cat([views[i].movedim(dims[i], 0).reshape(-1) for i in bucket])
            rows = D.all_gather_rows(mine, group).view(world, -1)
            at = 0
            for i in bucket:
                moved = leaves[i].movedim(dims[i], 0)
                n = leaves[i].numel() // world
                moved.copy_(rows[:, at:at + n].reshape(moved.shape))
                at += n


class Zero1Sync(D.GradientSync):
    """The data_parallel of a ZeRO-1 step: GradientSync's broadcast of rank
    0's state, then the moments cut to this rank's slices (once per state
    object); the metrics averaged; the gradients left to Zero1."""

    reduce_grads = False

    def begin(self, state) -> None:
        if id(state) == self._state_id:
            return
        super().begin(state)
        shard_moments(state, self.group)


def make_zero1(step, group=None) -> None:
    """Give a step (RetrievalTrainStep, TaskTrainStep, the pretrain and GD
    steps) ZeRO-1: its optimizers wrapped in Zero1 and a Zero1Sync as its
    data_parallel."""
    if hasattr(step, "optimizers"):
        step.optimizers = tuple(o if isinstance(o, Zero1) else Zero1(o, group)
                                for o in step.optimizers)
    else:
        if not isinstance(step.optimizer, Zero1):
            step.optimizer = Zero1(step.optimizer, group)
    step.data_parallel = Zero1Sync(group)
