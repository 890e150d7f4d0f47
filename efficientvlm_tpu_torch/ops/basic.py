"""Basic functional ops over nested param dicts (the JAX package's layouts).

- Dense kernels are stored [in, out]; `dense` computes x @ kernel + bias.
- `dtype` is the compute dtype; params may be stored in another one.
- LayerNorm computes its statistics in f32 and casts back.
- `dropout` draws from an explicit torch.Generator (JAX's explicit keys);
  without one it is the identity, as JAX's is without a key.
- `dense` also applies the int8 dicts of ops/quant.py.
- `remat` runs a layer under a per-layer recompute (a config's `remat:
  true`, JAX's jax.checkpoint on its layer scan) that replays the explicit
  generators' dropout draws.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _trunc_normal(shape, stddev, generator, device):
    t = torch.empty(shape, device=device)
    return torch.nn.init.trunc_normal_(
        t, std=stddev, a=-2.0 * stddev, b=2.0 * stddev, generator=generator)


def init_dense(generator, d_in: int, d_out: int, *, bias: bool = True,
               stddev: float = 0.02, device=None):
    p = {"kernel": _trunc_normal((d_in, d_out), stddev, generator, device)}
    if bias:
        p["bias"] = torch.zeros(d_out, device=device)
    return p


def init_layer_norm(d: int, device=None):
    return {"scale": torch.ones(d, device=device),
            "bias": torch.zeros(d, device=device)}


def init_embedding(generator, n: int, d: int, stddev: float = 0.02, device=None):
    return {"embedding": _trunc_normal((n, d), stddev, generator, device)}


def dense(params, x: torch.Tensor, *, dtype=None) -> torch.Tensor:
    """x @ kernel + bias; the bias add rides in the matmul's epilogue. An
    int8 dict (ops/quant.py: kernel_q8 / kernel_q8a8 and scale) runs
    quant.dense_quantized."""
    if "kernel" not in params:
        from .quant import dense_quantized

        return dense_quantized(params, x, dtype=dtype)
    kernel = params["kernel"]
    if dtype is not None:
        kernel = kernel.to(dtype)
        x = x.to(dtype)
    bias = params.get("bias")
    return F.linear(x, kernel.t(), None if bias is None else bias.to(x.dtype))


def layer_norm(params, x: torch.Tensor, *, eps: float = 1e-12) -> torch.Tensor:
    """Statistics, normalisation and affine in f32, result in x.dtype.
    F.layer_norm accumulates in f32 for bf16 input; params of another dtype
    than x go through an f32 copy of x, so their values are never rounded."""
    scale, bias = params["scale"], params["bias"]
    if scale.dtype == x.dtype:
        return F.layer_norm(x, x.shape[-1:], scale, bias, eps)
    return F.layer_norm(x.float(), x.shape[-1:], scale.float(), bias.float(), eps).to(x.dtype)


def embedding_lookup(params, ids: torch.Tensor, *, dtype=None) -> torch.Tensor:
    h = F.embedding(ids, params["embedding"])
    return h.to(dtype) if dtype is not None else h


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """CLIP's quick_gelu: x * sigmoid(1.702 x)."""
    return x * torch.sigmoid(1.702 * x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU."""
    return F.gelu(x)


def gelu_new(x: torch.Tensor) -> torch.Tensor:
    """The tanh approximation of GELU (HF's gelu_new)."""
    return F.gelu(x, approximate="tanh")


ACT2FN = {"gelu": gelu, "quick_gelu": quick_gelu, "relu": F.relu, "gelu_new": gelu_new}


def recompute_grads(fn, saved, needs, cotangents) -> tuple:
    """The backward of a kernel run inside a torch.autograd.Function:
    recompute fn(*saved) (the kernel's plain version) under autograd from the
    saved inputs and return the gradient of each input that needs one (None
    for the others); cotangents pair with fn's outputs in order, None where
    an output got none."""
    with torch.enable_grad():
        inputs = [None if t is None else t.detach().requires_grad_(n)
                  for t, n in zip(saved, needs)]
        outs = fn(*inputs)
        outs = outs if isinstance(outs, tuple) else (outs,)
        pairs = [(o, c) for o, c in zip(outs, cotangents) if c is not None]
        wrt = [t for t, n in zip(inputs, needs) if n and t is not None]
        grads = iter(torch.autograd.grad([o for o, _ in pairs], wrt, [c for _, c in pairs],
                                         allow_unused=True))
    return tuple(next(grads) if n and t is not None else None for t, n in zip(inputs, needs))


def dropout(x: torch.Tensor, rate: float, *, generator=None, train: bool = False) -> torch.Tensor:
    """Inverted dropout: keep each element with probability 1 - rate and
    scale it by 1 / (1 - rate). The identity outside training, at rate 0 and
    without a generator (on x's device)."""
    if not train or rate == 0.0 or generator is None:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, 0.0)


def remat(fn, *, generators=()):
    """fn() with its activations dropped after the forward and recomputed in
    the backward (torch.utils.checkpoint, non-reentrant), as jax.checkpoint
    recomputes a layer. The port draws dropout from explicit generators,
    whose states torch.utils.checkpoint does not keep: each of `generators`
    (None entries skipped) is set back, for the recompute, to its state
    before the forward, so the recompute draws the same masks, and is then
    put back where the backward found it. Outside autograd fn() runs as is."""
    if not torch.is_grad_enabled():
        return fn()
    from torch.utils.checkpoint import checkpoint

    gens = [g for g in generators if g is not None]
    before = [g.get_state() for g in gens]
    calls = [0]

    def run():
        calls[0] += 1
        if calls[0] == 1:
            return fn()
        now = [g.get_state() for g in gens]
        for g, st in zip(gens, before):
            g.set_state(st)
        try:
            return fn()
        finally:
            for g, st in zip(gens, now):
                g.set_state(st)

    return checkpoint(run, use_reentrant=False, preserve_rng_state=False)
