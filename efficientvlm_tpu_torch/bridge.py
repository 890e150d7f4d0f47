"""Params from the JAX package's tree to the port's, one leaf at a time.

The JAX package keeps params as nested dicts/lists of arrays; `np.asarray`
over each leaf gives numpy. The port keeps the same keys and layouts (dense
kernels [in, out], the patch kernel HWIO), so the bridge only converts
leaves.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device


def params_from_numpy(tree, device=None, dtype=None):
    """Nested dict/list of numpy arrays -> same structure of torch tensors on
    `device` (default cuda). Floating leaves are cast to `dtype` when given;
    integer leaves keep their type."""
    device = resolve_device(device)

    def leaf(x):
        t = torch.from_numpy(np.array(x, copy=True))
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        return t.to(device)

    def walk(x):
        if isinstance(x, dict):
            return {k: walk(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [walk(v) for v in x]
        if x is None:
            return None
        return leaf(x)

    return walk(tree)


def cast_floating(tree, dtype):
    """Same tree with every floating leaf cast to `dtype` (bf16 param storage
    for inference)."""
    if isinstance(tree, dict):
        return {k: cast_floating(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [cast_floating(v, dtype) for v in tree]
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        return tree.to(dtype)
    return tree


def l0_params_from_numpy(tree, device=None) -> dict:
    """The JAX L0Module's params ({"loga": {group: [L, size]}, "lambda_1",
    "lambda_2"}, leaves as numpy or anything np.asarray reads) -> the port's,
    f32 on `device` (default cuda)."""
    return params_from_numpy({"loga": dict(tree["loga"]), "lambda_1": tree["lambda_1"],
                              "lambda_2": tree["lambda_2"]}, device=device, dtype=torch.float32)


def train_state_from_numpy(state, optimizers, device=None):
    """A JAX TrainState (params, loga, lam, step; leaves read with
    np.asarray) -> the port's train.steps.TrainState on `device`, with every
    optimizer's moments at zero (as JAX's are at init)."""
    from .train.steps import init_train_state

    params = params_from_numpy(state.params, device=device)
    l0 = l0_params_from_numpy({"loga": state.loga, **state.lam}, device=device)
    out = init_train_state(params, l0, optimizers)
    out.step = int(np.asarray(state.step))
    return out
