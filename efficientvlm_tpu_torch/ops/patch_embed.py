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
"""

from __future__ import annotations

import torch

from ..kernels import bindings


def _im2col(images: torch.Tensor, patch_size: int, dtype) -> torch.Tensor:
    """[B,H,W,C] -> [B, Np, P*P*C], flattened (ph, pw, c) to match the HWIO
    conv kernel's (H, W, I) order."""
    b, hh, ww, c = images.shape
    p = patch_size
    if hh % p or ww % p:
        raise ValueError(f"image {hh}x{ww} is not tiled by patch {p}")
    hp, wp = hh // p, ww // p
    x = images.to(dtype).reshape(b, hp, p, wp, p, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, hp * wp, p * p * c)


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
    if hh % p or ww % p:
        raise ValueError(f"image {hh}x{ww} is not tiled by patch {p}")
    n_patches = (hh // p) * (ww // p)
    k = p * p * 3
    w = params["patch_embed"]["kernel"].to(dtype).reshape(k, -1).contiguous()
    stored = bindings.as_stored
    bias, pos = stored(params["patch_embed"].get("bias")), params["pos_embed"]["embedding"]
    gamma, beta = stored(params["pre_ln"]["scale"]), stored(params["pre_ln"]["bias"])
    if bindings.gemm_ln_fits(w.shape[1]):
        return bindings.patch_embed(images.to(dtype).contiguous(), w, bias,
                                    stored(pos[:1 + n_patches]), stored(params["class_embedding"]),
                                    gamma, beta, eps, patch=p)
    x = _im2col(images, p, dtype)
    out = bindings.patch_embed_im2col(x.reshape(b * n_patches, k).contiguous(), w, bias,
                                      stored(pos[1:1 + n_patches]), gamma, beta, eps, batch=b)
    out[:, 0] = _cls_row(params, eps).to(dtype)
    return out


def fused_patch_embed(params: dict, images: torch.Tensor, *, patch_size: int,
                      eps: float = 1e-5, dtype=None) -> torch.Tensor:
    """images [B,H,W,3] -> [B, 1+Np, D]. CUDA tensors launch the kernels
    (bfloat16 only); CPU tensors run patch_embed_plain."""
    dtype = dtype or images.dtype
    if not images.is_cuda:
        return patch_embed_plain(params, images, patch_size=patch_size, eps=eps, dtype=dtype)
    out = _patch_embed_cuda(params, images, patch_size, eps, dtype)
    fused_patch_embed.launches += 1
    return out


fused_patch_embed.launches = 0
