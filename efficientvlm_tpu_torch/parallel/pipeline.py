"""GPipe pipeline parallelism over a uniform layer stack (port of
efficientvlm_tpu/parallel/pipeline.py).

JAX runs the schedule as one scan under shard_map, with a ppermute hop per
tick, and differentiates it as a whole. Here each stage is a process of a
group: stage s holds layers s*L/S .. (s+1)*L/S - 1 of the stacked params.
The batch is cut into M microbatches; stage 0 feeds microbatch m on its
turn, every stage runs its layers and sends the result to the next stage
(send / recv through utils/dist, staged through host memory under gloo),
and the last stage's outputs are broadcast to every stage (JAX's psum), so
the result is replicated.

The backward keeps each microbatch's stage input and output; it runs
microbatch by microbatch in reverse: the last stage takes the cotangent of
its own output (the ranks' mean of the output's cotangent: every stage
computes the same loss), each stage backpropagates through its layers with
the cotangent it received from the next, sends the input's cotangent back,
and keeps its layers' gradients. Stage 0's input cotangent is broadcast, so
x's gradient is the same on every stage. Sends and receives pair up in the
same order on both sides, so the schedule needs no tags.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from ..train.optim import tree_leaves_with_path
from ..utils import dist as D


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(v, fn) for v in tree]
    return None if tree is None else fn(tree)


def stack_layers(layers: list):
    """[{param tree} x L] -> one tree with a leading L axis on every leaf."""
    flat = [tree_leaves_with_path(lp) for lp in layers]
    stacked = [torch.stack([f[i][1] for f in flat]) for i in range(len(flat[0]))]
    it = iter(stacked)
    return _map(layers[0], lambda _: next(it))


def layer_at(stacked, i: int):
    """Layer i's params out of a stacked tree."""
    return _map(stacked, lambda t: t[i])


def stage_block(stacked, n_stages: int, stage: int):
    """Stage `stage`'s L / S layers of a stacked tree (views)."""
    leading = tree_leaves_with_path(stacked)[0][1].shape[0]
    if leading % n_stages:
        raise ValueError(f"pipeline: {leading} layers over {n_stages} stages")
    k = leading // n_stages
    return _map(stacked, lambda t: t[stage * k:(stage + 1) * k])


def _unflatten(tree, leaves):
    it = iter(leaves)
    return _map(tree, lambda _: next(it))


class _Pipeline(torch.autograd.Function):
    @staticmethod
    def forward(ctx, run, x, aux, *leaves):
        group, n_micro = run["group"], run["n_micro"]
        stage, n_stages = D.dist.get_rank(group), D.dist.get_world_size(group)
        ranks = D.dist.get_process_group_ranks(group)
        params = [t.detach().requires_grad_(t.requires_grad) for t in leaves]
        tree = _unflatten(run["tree"], params)
        n_layers = tree_leaves_with_path(tree)[0][1].shape[0]
        if x.shape[0] % n_micro:
            raise ValueError(f"pipeline: a batch of {x.shape[0]} in {n_micro} microbatches")
        xm = x.detach().reshape((n_micro, -1) + tuple(x.shape[1:]))
        am = None if aux is None else aux.reshape((n_micro, -1) + tuple(aux.shape[1:]))
        records, outs = [], []
        with torch.enable_grad():
            for m in range(n_micro):
                if stage == 0:
                    h = xm[m].clone().requires_grad_(x.requires_grad)
                else:
                    h = D.recv(xm[m], ranks[stage - 1], group).requires_grad_(True)
                inp = h
                for i in range(n_layers):
                    h = run["layer_fn"](layer_at(tree, i), h, None if am is None else am[m])
                if stage < n_stages - 1:
                    D.send(h, ranks[stage + 1], group)
                else:
                    outs.append(h.detach())
                records.append((inp, h))
        y = torch.cat(outs) if stage == n_stages - 1 else torch.empty(
            (x.shape[0],) + tuple(xm.shape[2:]), dtype=records[0][1].dtype, device=x.device)
        D.dist.broadcast(y, ranks[-1], group=group)
        ctx.run, ctx.records, ctx.params = run, records, params
        ctx.x_shape, ctx.x_grad = x.shape, x.requires_grad
        return y.reshape(x.shape[:1] + y.shape[1:])

    @staticmethod
    def backward(ctx, grad):
        group, n_micro = ctx.run["group"], ctx.run["n_micro"]
        stage, n_stages = D.dist.get_rank(group), D.dist.get_world_size(group)
        ranks = D.dist.get_process_group_ranks(group)
        gm = (D.all_reduce_sum(grad.float(), group) / n_stages).to(grad.dtype)
        gm = gm.reshape((n_micro, -1) + tuple(grad.shape[1:]))
        want = [p for p in ctx.params if p.requires_grad]
        acc = [None] * len(want)
        gx = torch.zeros((n_micro, gm.shape[1]) + tuple(ctx.x_shape[1:]), device=grad.device,
                         dtype=ctx.records[0][0].dtype)
        for m in reversed(range(n_micro)):
            inp, out = ctx.records[m]
            cot = gm[m] if stage == n_stages - 1 else D.recv(out, ranks[stage + 1], group)
            wrt = ([inp] if inp.requires_grad else []) + want
            got = torch.autograd.grad(out, wrt, cot, allow_unused=True)
            if inp.requires_grad:
                g_in, got = got[0], got[1:]
                if stage > 0:
                    D.send(torch.zeros_like(inp) if g_in is None else g_in, ranks[stage - 1],
                           group)
                elif g_in is not None:
                    gx[m] = g_in
            acc = [a if g is None else (g if a is None else a + g) for a, g in zip(acc, got)]
        ctx.records = None
        grad_x = None
        if ctx.x_grad:
            D.dist.broadcast(gx, ranks[0], group=group)
            grad_x = gx.reshape(ctx.x_shape)
        it = iter(acc)
        grads = [next(it) if p.requires_grad else None for p in ctx.params]
        return (None, grad_x, None, *grads)


def pipeline_apply(layer_fn: Callable[[Any, torch.Tensor, Any], torch.Tensor], local_params,
                   x: torch.Tensor, aux=None, *, n_micro: int, group=None) -> torch.Tensor:
    """The pipelined stack on this stage (every rank of `group` calls it).

    layer_fn(layer_params, h, aux) -> h: one layer over a microbatch.
    local_params: this stage's layers, a stacked tree with a leading L / S
    dim (stage_block). x [B, ...]: the full input, the same on every stage;
    B divides by n_micro. aux: an optional batch-leading tensor (an
    attention bias) cut into microbatches beside x. Returns the full output,
    the same on every stage; differentiable in x and the local params."""
    group = D.dist.group.WORLD if group is None else group
    flat = [t for _, t in tree_leaves_with_path(local_params)]
    run = {"layer_fn": layer_fn, "n_micro": int(n_micro), "group": group,
           "tree": local_params}
    return _Pipeline.apply(run, x, aux, *flat)


def pipelined_stack_forward(layer_fn, stacked_params, x: torch.Tensor, aux=None, *,
                            n_micro: int, group=None) -> torch.Tensor:
    """The one-call form: the whole stacked [L, ...] params (as every rank
    holds them), cut to this stage's block, then pipeline_apply."""
    local = stage_block(stacked_params, D.dist.get_world_size(group), D.dist.get_rank(group))
    return pipeline_apply(layer_fn, local, x, aux, n_micro=n_micro, group=group)
