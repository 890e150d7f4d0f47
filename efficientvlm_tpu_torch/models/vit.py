"""CLIP-ViT vision encoder, functional and gated (port of
efficientvlm_tpu/models/vit.py, non-region path).

conv patch-embed (no bias) -> [CLS] + learned pos-embed -> pre-LN ->
N pre-LN transformer layers (quick_gelu MLP) -> post-LN.

impl="fused" runs the input stage through fused_patch_embed and every
self-attention sublayer through fused_self_attention (hand-written kernels
on CUDA, their plain versions on the CPU); impl="plain" runs the plain
PyTorch path. Region batches (local attention for general distillation)
come with that slice.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..config import VisionConfig
from ..ops.attention import init_attention, multi_head_attention
from ..ops.basic import ACT2FN, dense, init_dense, init_layer_norm, layer_norm
from ..ops.fused_mha import fused_self_attention
from ..ops.patch_embed import fused_patch_embed, patch_embed_plain


def init_vit(generator: torch.Generator, cfg: VisionConfig, device=None) -> dict:
    d = cfg["vision_width"]
    p = cfg["patch_size"]
    n_pos = cfg.num_patches + 1

    def randn(*shape):
        return torch.randn(shape, generator=generator, device=device) * 0.02

    params = {
        "patch_embed": {"kernel": randn(p, p, 3, d)},  # HWIO, no bias
        "class_embedding": randn(d),
        "pos_embed": {"embedding": randn(n_pos, d)},
        "pre_ln": init_layer_norm(d, device),
        "post_ln": init_layer_norm(d, device),
        "layers": [],
    }
    for _ in range(cfg["num_hidden_layers"]):
        params["layers"].append({
            "ln1": init_layer_norm(d, device),
            "attn": init_attention(generator, d, cfg["num_attention_heads"], device=device),
            "ln2": init_layer_norm(d, device),
            "mlp": {
                "fc1": init_dense(generator, d, cfg["intermediate_size"], device=device),
                "fc2": init_dense(generator, cfg["intermediate_size"], d, device=device),
            },
        })
    return params


def _num_heads(layer_params: dict, head_dim: int) -> int:
    if layer_params.get("attn") is None:
        return 0
    return layer_params["attn"]["q"]["kernel"].shape[1] // head_dim


def vit_layer(lp: dict, h: torch.Tensor, *, num_heads: int, act,
              head_z: Optional[torch.Tensor] = None, head_layer_z=None,
              mlp_z: Optional[torch.Tensor] = None, dtype=None, impl: str = "fused"):
    if lp.get("attn") is not None:  # fully-pruned attention -> identity
        x = layer_norm(lp["ln1"], h, eps=1e-5)
        if impl == "fused":
            attn_out = fused_self_attention(
                lp["attn"], x.to(dtype) if dtype is not None else x,
                num_heads=num_heads, head_z=head_z)
            if head_layer_z is not None:
                attn_out = attn_out * torch.as_tensor(
                    head_layer_z, dtype=attn_out.dtype, device=attn_out.device)
        else:
            attn_out, _ = multi_head_attention(
                lp["attn"], x, num_heads=num_heads, head_z=head_z,
                head_layer_z=head_layer_z, dtype=dtype)
        h = h + attn_out

    if lp.get("mlp") is not None:  # fully-pruned FFN -> identity
        x = layer_norm(lp["ln2"], h, eps=1e-5)
        x = dense(lp["mlp"]["fc1"], x, dtype=dtype)
        if mlp_z is not None:
            # the ViT gates the FFN between fc1 and the activation (the text
            # tower gates after it); continuous gates tell the two apart
            x = x * mlp_z.to(x.dtype)
        x = act(x)
        h = h + dense(lp["mlp"]["fc2"], x, dtype=dtype)
    return h


def vit_apply(params: dict, images: torch.Tensor, cfg: VisionConfig, *,
              idx_to_group_img=None, head_z=None, head_layer_z=None, mlp_z=None,
              dtype=None, impl: str = "fused") -> dict:
    """images [B,H,W,3] NHWC; head_z/mlp_z [L,H] / [L,I] stacked per-layer
    gates (None = dense). Returns {"last_hidden": [B, 1+Np, D]}."""
    if idx_to_group_img is not None:
        raise NotImplementedError(
            "region batches (local attention) come with the general-distillation slice")
    act = ACT2FN[cfg["hidden_act"]]
    head_dim = cfg["vision_width"] // cfg["num_attention_heads"]
    embed = fused_patch_embed if impl == "fused" else patch_embed_plain
    h = embed(params, images, patch_size=cfg["patch_size"], eps=1e-5,
              dtype=dtype or torch.promote_types(images.dtype,
                                                 params["patch_embed"]["kernel"].dtype))
    for i, lp in enumerate(params["layers"]):
        h = vit_layer(
            lp, h, num_heads=_num_heads(lp, head_dim), act=act,
            head_z=None if head_z is None else head_z[i],
            head_layer_z=None if head_layer_z is None else head_layer_z[i],
            mlp_z=None if mlp_z is None else mlp_z[i], dtype=dtype, impl=impl)
    return {"last_hidden": layer_norm(params["post_ln"], h, eps=1e-5)}
