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
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional

import torch

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
    count (0 for the first update); decay and mult are per-leaf flags."""

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

    def learning_rate(self, count: int) -> float:
        return self.lr(count) if callable(self.lr) else self.lr

    @torch.no_grad()
    def step(self, leaves: list, grads: list, state: dict) -> None:
        """One update of `leaves` in place from `grads` (same order)."""
        grads = [torch.zeros_like(p, dtype=torch.float32) if g is None else g.float()
                 for p, g in zip(leaves, grads)]
        if self.grad_clip:
            norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
            keep = norm < self.grad_clip
            scaled = torch._foreach_mul(torch._foreach_div(grads, norm), self.grad_clip)
            grads = [torch.where(keep, g, s) for g, s in zip(grads, scaled)]
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
        for p, u in zip(leaves, upd):
            p.add_(u.to(p.dtype))


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
