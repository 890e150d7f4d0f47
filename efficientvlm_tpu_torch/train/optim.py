"""The three AdamW optimizers of the pruning fine-tune (port of
efficientvlm_tpu/train/optim.py), written by hand so that each update is
optax's, in optax's order:

    clip_by_global_norm (main only) -> Adam direction with bias correction
    -> + weight_decay * p on the decayed leaves -> * -lr(count)
    -> * lr_mult on the from-scratch leaves -> p += update.

- create_optimizer: the main AdamW over the model params, betas (0.9, 0.98),
  eps 1e-8, weight decay on >1-D leaves whose path names no bias / norm /
  temp / class embedding, an lr schedule, global-norm clipping, lr_mult;
- create_l0_optimizer: AdamW over the gate log-alphas, lr reg_lr, no decay;
- create_lagrangian_optimizer: AdamW over λ1, λ2 with lr -reg_lr, gradient
  ascent. torch.optim.AdamW refuses a negative lr; this one takes it as the
  sign of the update, which is optax's arithmetic.

The update is in place on the param tensors (no second copy of the
params); the moments are f32 tensors beside them. Params are nested
dicts / lists of tensors, as in the JAX package; a leaf without a gradient
(None) counts as a zero gradient, as a zero cotangent does in JAX.

Two wrappers take any of them (the same init / step over a list of
leaves), as optax's do in the JAX package's drivers:
- MultiSteps: optax.MultiSteps(every_k_schedule=k), gradient accumulation;
- ApplyIfFinite: optax.apply_if_finite(max_consecutive_errors=n), the skip
  of non-finite updates.
Their state (the accumulator, the micro-step and error counts) is part of
the optimizer state, beside the wrapped optimizer's under "inner".

When some leaves are shards of a tensor spread over a process group
(ZeRO-1's moments, tensor parallelism's params), shard_optimizer tells the
optimizer so: the clip's global norm then sums the shards' squares over the
group and counts the replicated leaves once, and ApplyIfFinite skips a step
on every rank when any rank saw a non-finite gradient.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional

import torch

from ..utils.dist import all_reduce_sum

NO_DECAY_SUBSTRINGS = ("bias", "ln", "layer_norm", "norm", "temp", "class_embedding")


def tree_leaves_with_path(tree, path=()) -> list:
    """[(path tuple, leaf tensor)] in the tree's order (dict insertion order,
    list order); None leaves are skipped."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in tree_leaves_with_path(v, path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in tree_leaves_with_path(v, path + (i,))]
    return [] if tree is None else [(path, tree)]


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in tree_leaves_with_path(tree)]


def path_str(path) -> str:
    return "/".join(str(p) for p in path).lower()


def weight_decay_mask(params) -> list:
    """Per leaf (tree order): True where decay applies, i.e. >1-D leaves
    whose path names none of NO_DECAY_SUBSTRINGS."""
    return [leaf.ndim > 1 and not any(t in path_str(p) for t in NO_DECAY_SUBSTRINGS)
            for p, leaf in tree_leaves_with_path(params)]


def lr_mult_mask(params, init_param_paths: Iterable[str]) -> list:
    """Per leaf: True where the path starts with (or contains, after a '/')
    one of the from-scratch module prefixes."""
    prefixes = tuple(init_param_paths)
    return [any(path_str(p).startswith(x) or f"/{x}" in path_str(p) for x in prefixes)
            for p, _ in tree_leaves_with_path(params)]


class AdamW:
    """optax.chain(clip_by_global_norm(grad_clip), adamw(lr, b1, b2, eps,
    weight_decay, mask=decay), scale_by_mask(lr_mult, mult)) as an in-place
    step over a list of leaves. lr is a float or a schedule of the update
    count (0 for the first update); decay and mult are per-leaf flags.
    `sharded` (set by shard_optimizer): (per-leaf flags, group) of the
    leaves that are shards over a process group."""

    sharded = None

    def __init__(self, lr: float | Callable, *, b1: float = 0.9, b2: float = 0.98,
                 eps: float = 1e-8, weight_decay: float = 0.0, decay: Optional[list] = None,
                 lr_mult: float = 1.0, mult: Optional[list] = None,
                 grad_clip: Optional[float] = None):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.weight_decay, self.decay = weight_decay, decay
        self.lr_mult, self.mult = lr_mult, mult
        self.grad_clip = grad_clip

    def init(self, leaves: list) -> dict:
        return {"count": 0, "mu": [torch.zeros_like(p, dtype=torch.float32) for p in leaves],
                "nu": [torch.zeros_like(p, dtype=torch.float32) for p in leaves]}

    def global_norm(self, grads: list) -> torch.Tensor:
        """The f32 norm of all the gradients (over the group, when sharded)."""
        norms = torch.stack(torch._foreach_norm(grads))
        if self.sharded is None:
            return torch.linalg.vector_norm(norms)
        flags, group = self.sharded
        sq = norms.square()
        on = torch.tensor(flags, device=sq.device)
        spread = all_reduce_sum(torch.where(on, sq, 0.0).sum(), group)
        return (spread + torch.where(on, 0.0, sq).sum()).sqrt()

    def learning_rate(self, count: int) -> float:
        return self.lr(count) if callable(self.lr) else self.lr

    @torch.no_grad()
    def step(self, leaves: list, grads: list, state: dict) -> None:
        """One update of `leaves` in place from `grads` (same order)."""
        grads = [torch.zeros_like(p, dtype=torch.float32) if g is None else g.float()
                 for p, g in zip(leaves, grads)]
        if self.grad_clip:
            # g / norm * clip above the clip, g itself (divided and multiplied by 1) below
            norm = self.global_norm(grads)
            keep = norm < self.grad_clip
            grads = torch._foreach_div(grads, torch.where(keep, 1.0, norm))
            torch._foreach_mul_(grads, torch.where(keep, 1.0, self.grad_clip).to(norm.dtype))
        lr = self.learning_rate(state["count"])
        state["count"] += 1
        mu, nu, t = state["mu"], state["nu"], state["count"]
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, grads, alpha=1.0 - self.b1)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_addcmul_(nu, grads, grads, value=1.0 - self.b2)
        denom = torch._foreach_div(nu, 1.0 - self.b2 ** t)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(mu, 1.0 - self.b1 ** t)
        torch._foreach_div_(upd, denom)
        if self.weight_decay and self.decay is not None:
            dec = [i for i, d in enumerate(self.decay) if d]
            torch._foreach_add_([upd[i] for i in dec], [leaves[i].float() for i in dec],
                                alpha=self.weight_decay)
        torch._foreach_mul_(upd, -lr)
        if self.lr_mult != 1.0 and self.mult is not None:
            torch._foreach_mul_([u for u, m in zip(upd, self.mult) if m], self.lr_mult)
        torch._foreach_add_(leaves, [u.to(p.dtype) for p, u in zip(leaves, upd)])


class MultiSteps:
    """optax.MultiSteps(inner, every_k_schedule=k): each step folds the
    gradients into a running mean (optax's, acc + (g - acc) / (n + 1)); the
    k-th applies `inner` once with that mean and restarts it. The params
    stay as they are on the other micro-steps, and the inner count (so the
    schedule) moves only on applied updates. optax restarts its mean by
    multiplying it by 0, so a NaN micro-batch stays in its accumulator for
    good; here the accumulator is zeroed."""

    def __init__(self, inner, every_k_schedule: int):
        self.inner, self.every_k = inner, int(every_k_schedule)

    def init(self, leaves: list) -> dict:
        return {"mini_step": 0, "gradient_step": 0, "inner": self.inner.init(leaves),
                "acc_grads": [torch.zeros_like(p, dtype=torch.float32) for p in leaves]}

    @torch.no_grad()
    def step(self, leaves: list, grads: list, state: dict) -> None:
        acc, n = state["acc_grads"], state["mini_step"]
        grads = [torch.zeros_like(a) if g is None else g.float() for a, g in zip(acc, grads)]
        delta = torch._foreach_sub(grads, acc)
        torch._foreach_div_(delta, float(n + 1))
        torch._foreach_add_(acc, delta)
        if n < self.every_k - 1:
            state["mini_step"] = n + 1
            return
        self.inner.step(leaves, acc, state["inner"])
        torch._foreach_zero_(acc)
        state["mini_step"], state["gradient_step"] = 0, state["gradient_step"] + 1


class ApplyIfFinite:
    """optax.apply_if_finite(inner, max_consecutive_errors=n): a step whose
    gradients hold a NaN or an inf leaves the leaves and the inner state (the
    moments, the count) as they are and counts the error; once more than n
    come in a row, the update goes through. The finiteness test reads one
    flag off the device a step; with a `group` (shard_optimizer) the ranks
    agree on it."""

    group = None

    def __init__(self, inner, max_consecutive_errors: int):
        self.inner, self.max_errors = inner, int(max_consecutive_errors)

    def init(self, leaves: list) -> dict:
        return {"notfinite_count": 0, "last_finite": True, "total_notfinite": 0,
                "inner": self.inner.init(leaves)}

    @torch.no_grad()
    def step(self, leaves: list, grads: list, state: dict) -> None:
        flags = [torch.isfinite(g).all() for g in grads if g is not None]
        finite = bool(torch.stack(flags).all()) if flags else True
        if self.group is not None:
            dev = next((g.device for g in grads if g is not None), torch.device("cpu"))
            bad = torch.tensor([0.0 if finite else 1.0], device=dev)
            finite = bool(all_reduce_sum(bad, self.group).item() == 0)
        state["notfinite_count"] = 0 if finite else state["notfinite_count"] + 1
        state["last_finite"] = finite
        state["total_notfinite"] += 0 if finite else 1
        if finite or state["notfinite_count"] > self.max_errors:
            self.inner.step(leaves, grads, state["inner"])


def shard_optimizer(opt, flags: list, group=None) -> None:
    """Mark which of an optimizer's leaves (tree order) are shards over
    `group` (default: the world), through its wrappers (MultiSteps,
    ApplyIfFinite, ZeRO-1's)."""
    if group is None:
        import torch.distributed as dist

        group = dist.group.WORLD
    while True:
        if isinstance(opt, ApplyIfFinite):
            opt.group = group
        if isinstance(opt, AdamW):
            opt.sharded = (list(flags), group)
            return
        opt = opt.inner


def create_optimizer(params, *, lr: float | Callable, weight_decay: float = 0.01,
                     lr_mult: float = 1.0, init_param_paths: Iterable[str] = (),
                     betas=(0.9, 0.98), eps: float = 1e-8,
                     grad_clip: Optional[float] = None) -> AdamW:
    init_param_paths = tuple(init_param_paths)
    return AdamW(lr, b1=betas[0], b2=betas[1], eps=eps, weight_decay=weight_decay,
                 decay=weight_decay_mask(params), lr_mult=lr_mult,
                 mult=lr_mult_mask(params, init_param_paths) if init_param_paths else None,
                 grad_clip=grad_clip)


def create_l0_optimizer(*, reg_lr: float = 0.01) -> AdamW:
    """AdamW over the gate log-alphas."""
    return AdamW(reg_lr, b1=0.9, b2=0.98, eps=1e-8)


def create_lagrangian_optimizer(*, reg_lr: float = 0.01) -> AdamW:
    """A negative learning rate: gradient ascent on λ1, λ2."""
    return AdamW(-reg_lr, b1=0.9, b2=0.98, eps=1e-8)
