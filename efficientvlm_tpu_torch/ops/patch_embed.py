"""Fused ViT input stage: patch matmul + bias + positional rows + pre-LN.

Port of efficientvlm_tpu/ops/pallas_patch_embed.py (fused_patch_embed,
TPU kernel `_patch_embed_padded` / `_kernel`). images [B,H,W,3] (NHWC) ->
pre-LN'd hidden [B, 1+Np, D], CLS row first.

On a CUDA tensor `fused_patch_embed` runs csrc/patch_embed.cu: one launch
of gemm_ln in its gather form, which reads the patches straight from the
NHWC image (no im2col copy), adds the bias and positional rows, normalises
each row in f32 in its epilogue (no f32 round trip) and writes every
image's CLS row LN(cls + pos[0]). The small parameters are read as stored
(bf16 or f32): with bf16 images and bf16 params nothing is converted or
copied per call. f32 images are rounded to bf16 by the wrapper first (one
conversion launch); the gather reads bf16 only. The patch size must satisfy
bindings.patch_gather_fits (P*3 % 8 == 0: 8 and 16), else it raises. Widths
outside bindings.gemm_ln_fits (not a multiple of 128, or above 1024) keep
the earlier route: im2col here, then gemm_bias into f32 and
residual_layernorm, with the CLS row filled here. On a CPU tensor it runs
`patch_embed_plain`.

An image whose sides the patch does not tile is cropped to its top-left
floor(H/P)*P x floor(W/P)*P, and the positional rows are pos[:1+Np'] for
its Np' patches, as JAX's VALID convolution does (models/vit.py). The gather
reads the cropped patches in place with the full row stride; only a width
whose rows are no whole number of 16-byte pieces (W*3 % 8) is copied
cropped first.

`differentiable=True` is the training form (port of `_diff_embed`): the
kernel runs inside a torch.autograd.Function that saves its inputs, and the
backward recomputes patch_embed_plain under autograd, as JAX's custom_vjp
recomputes its XLA reference.
"""

from __future__ import annotations

import torch

from ..kernels import bindings
from .basic import recompute_grads


def _im2col(images: torch.Tensor, patch_size: int, dtype) -> torch.Tensor:
    """[B,H,W,C] -> [B, Np, P*P*C] over the patches that tile the image's
    top-left floor(H/P)*P x floor(W/P)*P, flattened (ph, pw, c) to match the
    HWIO conv kernel's (H, W, I) order."""
    b, hh, ww, c = images.shape
    p = patch_size
    hp, wp = hh // p, ww // p
    if not hp or not wp:
        raise ValueError(f"image {hh}x{ww} is smaller than patch {p}")
    x = images[:, :hp * p, :wp * p].to(dtype).reshape(b, hp, p, wp, p, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, hp * wp, p * p * c)


def _cls_row(params: dict, eps: float) -> torch.Tensor:
    """LN(cls + pos[0]) in f32, [D]."""
    cls = params["class_embedding"].float() + params["pos_embed"]["embedding"][0].float()
    mean = cls.mean()
    var = (cls - mean).square().mean()
    return ((cls - mean) * torch.rsqrt(var + eps) * params["pre_ln"]["scale"].float()
            + params["pre_ln"]["bias"].float())


def patch_embed_plain(params: dict, images: torch.Tensor, *, patch_size: int,
                      eps: float = 1e-5, dtype=None) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the same f32 arithmetic."""
    dtype = dtype or images.dtype
    x = _im2col(images, patch_size, dtype)
    b, n_patches, k = x.shape
    w = params["patch_embed"]["kernel"].to(dtype).reshape(k, -1)
    y = x.float() @ w.float()
    if "bias" in params["patch_embed"]:
        y = y + params["patch_embed"]["bias"].float()
    y = y + params["pos_embed"]["embedding"][1:1 + n_patches].float()
    mean = y.mean(-1, keepdim=True)
    c = y - mean
    var = (c * c).mean(-1, keepdim=True)
    out = (c * torch.rsqrt(var + eps) * params["pre_ln"]["scale"].float()
           + params["pre_ln"]["bias"].float()).to(dtype)
    cls = _cls_row(params, eps).to(dtype).expand(b, 1, -1)
    return torch.cat([cls, out], dim=1)


def _patch_embed_cuda(params, images, patch_size, eps, dtype):
    if dtype != torch.bfloat16:
        raise TypeError(f"fused_patch_embed on CUDA computes in bfloat16, got {dtype}")
    b, hh, ww, _ = images.shape
    p = patch_size
    n_patches = (hh // p) * (ww // p)
    k = p * p * 3
    w = params["patch_embed"]["kernel"].to(dtype).reshape(k, -1).contiguous()
    stored = bindings.as_stored
    bias, pos = stored(params["patch_embed"].get("bias")), params["pos_embed"]["embedding"]
    gamma, beta = stored(params["pre_ln"]["scale"]), stored(params["pre_ln"]["bias"])
    if bindings.gemm_ln_fits(w.shape[1]):
        if ww * 3 % 8:  # rows of no whole 16-byte pieces: gather from a cropped copy
            images = images[:, :, :ww // p * p]
        return bindings.patch_embed(images.to(dtype).contiguous(), w, bias,
                                    stored(pos[:1 + n_patches]), stored(params["class_embedding"]),
                                    gamma, beta, eps, patch=p)
    x = _im2col(images, p, dtype)
    out = bindings.patch_embed_im2col(x.reshape(b * n_patches, k).contiguous(), w, bias,
                                      stored(pos[1:1 + n_patches]), gamma, beta, eps, batch=b)
    out[:, 0] = _cls_row(params, eps).to(dtype)
    return out


_LEAVES = (("patch_embed", "kernel"), ("patch_embed", "bias"), ("class_embedding", None),
           ("pos_embed", "embedding"), ("pre_ln", "scale"), ("pre_ln", "bias"))


def _tree(leaves) -> dict:
    params: dict = {}
    for (name, leaf), t in zip(_LEAVES, leaves):
        if leaf is None:
            params[name] = t
        elif t is not None:
            params.setdefault(name, {})[leaf] = t
    return params


class _PatchEmbedFn(torch.autograd.Function):
    """Port of _diff_embed: the forward launches the kernel and saves its
    inputs; the backward recomputes patch_embed_plain (the same casts) under
    autograd and returns the gradients of the images and of every param
    leaf (_LEAVES; the patch bias may be None)."""

    @staticmethod
    def forward(ctx, patch_size, eps, dtype, images, *leaves):
        ctx.args = (patch_size, eps, dtype)
        ctx.save_for_backward(images, *leaves)
        out = _patch_embed_cuda(_tree(leaves), images, patch_size, eps, dtype)
        fused_patch_embed.launches += 1
        return out

    @staticmethod
    def backward(ctx, cotangent):
        patch_size, eps, dtype = ctx.args

        def plain(images, *leaves):
            return patch_embed_plain(_tree(leaves), images, patch_size=patch_size, eps=eps,
                                     dtype=dtype)

        return (None, None, None) + recompute_grads(plain, ctx.saved_tensors,
                                                    ctx.needs_input_grad[3:], (cotangent,))


def fused_patch_embed(params: dict, images: torch.Tensor, *, patch_size: int,
                      eps: float = 1e-5, dtype=None, differentiable: bool = False) -> torch.Tensor:
    """images [B,H,W,3] -> [B, 1+Np, D]. CUDA tensors launch the kernel
    (bfloat16 only; differentiable=True: the training form); CPU tensors run
    patch_embed_plain, autograd straight through it."""
    dtype = dtype or images.dtype
    if not images.is_cuda:
        return patch_embed_plain(params, images, patch_size=patch_size, eps=eps, dtype=dtype)
    if differentiable:
        leaves = [params[n] if l is None else params[n].get(l) for n, l in _LEAVES]
        return _PatchEmbedFn.apply(patch_size, eps, dtype, images, *leaves)
    out = _patch_embed_cuda(params, images, patch_size, eps, dtype)
    fused_patch_embed.launches += 1
    return out


fused_patch_embed.launches = 0
