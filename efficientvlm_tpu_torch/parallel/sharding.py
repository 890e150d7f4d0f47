"""Tensor parallelism and the sequence axis (port of
efficientvlm_tpu/parallel/sharding.py).

JAX declares the layouts and lets GSPMD insert the collectives. Eager
PyTorch runs one process a device, so each rank holds its own shard of the
params and the layers call the collectives themselves (Megatron's recipe).

Tensor parallelism (`tensor_parallel(group)` around the forwards; the
params from shard_params):
- param_partition_specs: JAX's rules over the port's param paths: the q /
  k / v projections and the FFN's fc1 / `intermediate` shard their output
  dim, `out` and fc2 / `output` their input dim, the word embeddings and
  the MLM decoder the vocab dim. The column layers' biases shard with their
  kernels (GSPMD slices JAX's replicated 1-D leaves itself; here the rank's
  kernel needs its own bias). Each rank runs its own heads (the head count
  comes from the q kernel's width) and its own FFN units;
- tp_enter at a column layer's input (identity forward, all-reduce of the
  gradient) and tp_exit after a row layer's output (all-reduce forward,
  identity backward); the row layer's bias enters once (tp_row: rank 0's
  forward adds it, every rank gets its gradient), the kernels add it inside;
- tp_slice: a rank's block of a head or FFN gate [.., H]; its backward sums
  the blocks over the group, so each head's log-alpha gradient comes from
  the rank that owns the head while every rank holds the whole gradient;
- tp_mean: a loss over head-sharded maps (the attention KD): the group's
  mean of the ranks' partial means;
- vocab_parallel_lookup / vocab_parallel_cross_entropy: the embedding
  lookup of a vocab shard (ids outside it masked, then summed over the
  group) and the MLM loss over vocab-sharded logits.
The sums of partials run in f32, rounded once to the activation's dtype.

The sequence axis (`sequence_parallel(group)`; a tower config's
act_partition turns it on; without an active group the axis has size 1 and
the forward is the unsharded one, as JAX's with a seq axis of 1): each
rank holds a token block of [B, T, D], the last one padded up to equal
blocks; self-attention takes its queries from the block and its K/V from
the gathered tokens (the cross form), with the padding masked in the key
bias; LayerNorm and the FFN are token-local; the towers gather their
outputs at the end. Forward only, as JAX's hook.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.nn.functional as F

from ..utils import dist as D

NEG = -1e9
_ACTIVE = {"tp": None, "sp": None}


def _world(group) -> int:
    return D.dist.get_world_size(group)


def _rank(group) -> int:
    return D.dist.get_rank(group)


# ---------------------------------------------------------------------------
# the rules


def spec_for(path: str, leaf) -> Optional[int]:
    """The dim of the leaf at `path` ("/"-joined, lower case) that tensor
    parallelism shards, or None (replicated)."""
    parts = path.split("/")
    if "layers" in parts and len(parts) >= 2:
        name, kind = parts[-2], parts[-1]
        if name in ("q", "k", "v", "intermediate", "fc1") and kind in ("kernel", "bias"):
            return leaf.ndim - 1
        if name in ("out", "output", "fc2") and kind == "kernel":
            return 0
        return None
    if path.endswith("word/embedding"):
        return 0
    if path.endswith("cls/decoder/kernel"):
        return 1
    if path.endswith("cls/decoder/bias"):
        return 0
    return None


def _map_with_path(tree, fn, path=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(v, fn, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_with_path(v, fn, path + (i,)) for i, v in enumerate(tree)]
    if tree is None:
        return None
    return fn("/".join(str(p) for p in path).lower(), tree)


def param_partition_specs(params):
    """The tree of sharded dims (None: replicated) of a param tree."""
    return _map_with_path(params, lambda p, t: spec_for(p, t) if torch.is_tensor(t) else None)


def _block(t: torch.Tensor, dim: int, rank: int, world: int) -> torch.Tensor:
    if t.shape[dim] % world:
        raise ValueError(f"tensor parallelism: dim {dim} of {tuple(t.shape)} does not split "
                         f"over {world} ranks")
    k = t.shape[dim] // world
    return t.narrow(dim, rank * k, k)


def shard_params(params, group=None):
    """This rank's shard of a full param tree (every rank holds the same
    full tree): the sharded leaves' blocks as new tensors, the others as
    they are."""
    rank, world = _rank(group), _world(group)

    def one(path, t):
        d = spec_for(path, t) if torch.is_tensor(t) else None
        return t if d is None else _block(t, d, rank, world).clone()

    return _map_with_path(params, one)


def gather_params(local, group=None):
    """The full tree from every rank's shard (shard_params' inverse)."""

    def one(path, t):
        d = spec_for(path, t) if torch.is_tensor(t) else None
        return t if d is None else D.gather_dim(t.detach(), d, group)

    return _map_with_path(local, one)


def check_heads(num_heads: int, world: int, head_group: int = 1) -> None:
    """Heads split evenly over the ranks, and a gate's group of adjacent
    heads stays on one rank."""
    if num_heads % world or (num_heads // world) % head_group:
        raise ValueError(f"tensor parallelism: {num_heads} heads in gate groups of {head_group} "
                         f"do not split over {world} ranks")


# ---------------------------------------------------------------------------
# the active groups


@contextlib.contextmanager
def tensor_parallel(group=None):
    """Run the forwards inside on this rank's param shards over `group`
    (default: the world)."""
    prev = _ACTIVE["tp"]
    _ACTIVE["tp"] = D.dist.group.WORLD if group is None else group
    try:
        yield
    finally:
        _ACTIVE["tp"] = prev


@contextlib.contextmanager
def sequence_parallel(group=None):
    """Shard the tokens of the towers whose config sets act_partition over
    `group` (default: the world)."""
    prev = _ACTIVE["sp"]
    _ACTIVE["sp"] = D.dist.group.WORLD if group is None else group
    try:
        yield
    finally:
        _ACTIVE["sp"] = prev


def tp_group():
    return _ACTIVE["tp"]


def seq_group():
    return _ACTIVE["sp"]


# ---------------------------------------------------------------------------
# tensor parallelism's autograd pieces


def _sum_f32(x: torch.Tensor, group) -> torch.Tensor:
    return D.all_reduce_sum(x.float(), group).to(x.dtype)


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _sum_f32(grad, ctx.group), None


class _Exit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _sum_f32(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _Once(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return x.clone() if _rank(group) == 0 else torch.zeros_like(x)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _Slice(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group, ctx.shape = dim, group, x.shape
        return _block(x, dim, _rank(group), _world(group)).clone()

    @staticmethod
    def backward(ctx, grad):
        full = grad.new_zeros(ctx.shape)
        _block(full, ctx.dim, _rank(ctx.group), _world(ctx.group)).copy_(grad)
        return _sum_f32(full, ctx.group), None, None


def tp_enter(x):
    """A column layer's input: identity forward, the gradient summed over
    the group (a no-op outside tensor_parallel)."""
    g = tp_group()
    return x if g is None or x is None else _Enter.apply(x, g)


def tp_exit(x):
    """A row layer's partial output summed over the group (f32), identity
    backward."""
    g = tp_group()
    return x if g is None else _Exit.apply(x, g)


def tp_slice(z, dim: int = -1):
    """This rank's block of a gate tensor along `dim` (heads or FFN units)."""
    g = tp_group()
    if g is None or z is None or not torch.is_tensor(z):
        return z
    return _Slice.apply(z, dim % z.ndim, g)


def tp_mean(x):
    """The group's mean of a loss over head-sharded maps (each rank's
    partial mean over the same count)."""
    g = tp_group()
    return x if g is None else _Exit.apply(x / _world(g), g)


def tp_row(params):
    """A row layer's params (`out`, `output`, fc2) whose bias enters once."""
    g = tp_group()
    if g is None or params is None or params.get("bias") is None:
        return params
    return {**params, "bias": _Once.apply(params["bias"], g)}


def tp_attention(params):
    """An attention block's params with its output projection's bias once."""
    if tp_group() is None or params is None:
        return params
    return {**params, "out": tp_row(params["out"])}


def vocab_parallel_lookup(table: torch.Tensor, ids: torch.Tensor, *, dtype=None) -> torch.Tensor:
    """[.., D] rows of a vocab-sharded table [V / n, D]: the ids outside this
    rank's block give zeros, and the group sums the ranks' rows."""
    g = tp_group()
    v = table.shape[0]
    lo = _rank(g) * v
    local = ids - lo
    inside = (local >= 0) & (local < v)
    h = F.embedding(torch.where(inside, local, 0), table)
    h = torch.where(inside[..., None], h, torch.zeros((), dtype=h.dtype, device=h.device))
    h = h.to(dtype) if dtype is not None else h
    return _Exit.apply(h, g)


def vocab_parallel_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                                 ignore_index: int = -100) -> torch.Tensor:
    """Mean cross-entropy over labels != ignore_index (f32) from this rank's
    vocab block of the logits [.., V / n]: the max and the exp-sum over the
    group, the target logit from the rank that holds it."""
    g = tp_group()
    x = logits.float()
    v = x.shape[-1]
    lo = _rank(g) * v
    m = x.detach().amax(-1)
    D.dist.all_reduce(m, op=D.dist.ReduceOp.MAX, group=g)
    sum_exp = _Exit.apply((x - m[..., None]).exp().sum(-1), g)
    valid = labels != ignore_index
    local = labels.long() - lo
    inside = valid & (local >= 0) & (local < v)
    target = x.gather(-1, torch.where(inside, local, 0)[..., None])[..., 0]
    target = _Exit.apply(torch.where(inside, target, 0.0), g)
    nll = sum_exp.log() + m - target
    return torch.where(valid, nll, 0.0).sum() / valid.sum().clamp(min=1)


# ---------------------------------------------------------------------------
# a tensor-parallel train step


def shard_flags(params) -> list:
    """Per leaf (tree order): whether tensor parallelism shards it."""
    from ..train.optim import path_str, tree_leaves_with_path

    return [spec_for(path_str(p), t) is not None for p, t in tree_leaves_with_path(params)]


def _gate_group(step, cfg) -> int:
    """The heads a learned gate covers in the tower of `cfg` (the L0 layout's
    head_gate_group), 1 without gates."""
    l0, heads = getattr(step, "l0", None), cfg["num_attention_heads"]
    vision = "vision_width" in cfg
    for name, g in getattr(l0, "groups", {}).items():
        if name.endswith("_head") and name.startswith("vision") == vision:
            return max(1, heads // g["shape"][1])
    return 1


class TensorParallelStep:
    """A train step (RetrievalTrainStep and the others) whose forwards run
    tensor parallel over `group`: the state's params and the step's teacher
    params are this rank's shards (shard_params), and the main optimizer's
    clip sums the shards' squares over the group (optim.shard_optimizer).
    The ranks of a group are one replica: they step on the same batch with
    generators in the same state. Other attributes are the step's."""

    def __init__(self, step, local_params, group=None):
        from ..train.optim import shard_optimizer

        self.step, self.group = step, group
        world = _world(self.group)
        for model in (getattr(step, "student", None), getattr(step, "teacher", None)):
            for cfg in () if model is None else (model.vision_cfg, model.text_cfg):
                check_heads(cfg["num_attention_heads"], world, _gate_group(step, cfg))
        opts = step.optimizers if hasattr(step, "optimizers") else (step.optimizer,)
        shard_optimizer(opts[0], shard_flags(local_params), self.group)

    def __getattr__(self, name):
        return getattr(self.step, name)

    def __call__(self, state, batch: dict, generator=None, **kw):
        with tensor_parallel(self.group):
            return self.step(state, batch, generator, **kw)


# ---------------------------------------------------------------------------
# the sequence axis


class SeqShard:
    """A token block of [B, T, D] over the active sequence group: the block
    of this rank (T padded up to a multiple of the ranks), the key bias of
    the gathered tokens with the padding masked, and the gather back."""

    def __init__(self, group, t: int):
        self.group, self.t = group, t
        self.world, self.rank = _world(group), _rank(group)
        self.block = -(-t // self.world)
        self.pad = self.block * self.world - t

    def split(self, h: torch.Tensor) -> torch.Tensor:
        if self.pad:
            h = torch.cat([h, h.new_zeros((h.shape[0], self.pad) + tuple(h.shape[2:]))], 1)
        return h[:, self.rank * self.block:(self.rank + 1) * self.block]

    def key_bias(self, kb: Optional[torch.Tensor], b: int, device) -> torch.Tensor:
        """[B, T + pad] f32: `kb` [B, T] (or zeros) with NEG on the padding."""
        kb = torch.zeros(b, self.t, device=device) if kb is None else kb.float().expand(b, self.t)
        if not self.pad:
            return kb.contiguous()
        return torch.cat([kb, torch.full((b, self.pad), NEG, device=device)], 1)

    def gather_tokens(self, x: torch.Tensor) -> torch.Tensor:
        """The whole padded token axis [B, T + pad, ..] (the K/V input)."""
        return D.gather_dim(x, 1, self.group)

    def gather(self, x: torch.Tensor, dim: int = 1, keys: bool = False) -> torch.Tensor:
        """The block gathered along `dim` and the padding cut off (also the
        padded key columns of a map, keys=True)."""
        full = D.gather_dim(x, dim, self.group).narrow(dim, 0, self.t)
        return full.narrow(-1, 0, self.t) if keys else full


def seq_shard(cfg, t: int) -> Optional[SeqShard]:
    """The token sharding of a tower whose config sets act_partition, over
    the active sequence group; None without one."""
    g = seq_group()
    if not cfg.get("act_partition") or g is None or _world(g) == 1:
        return None
    return SeqShard(g, t)
