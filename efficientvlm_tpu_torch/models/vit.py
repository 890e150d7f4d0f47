"""CLIP-ViT vision encoder, functional and gated (port of
efficientvlm_tpu/models/vit.py).

conv patch-embed (no bias) -> [CLS] + learned pos-embed -> pre-LN ->
N pre-LN transformer layers (quick_gelu MLP) -> post-LN.

impl="fused" runs the input stage through fused_patch_embed and every
self-attention sublayer through fused_self_attention (hand-written kernels
on CUDA, their plain versions on the CPU); impl="plain" runs the plain
PyTorch path.

Region batches (general distillation): the last `local_attn_depth` layers
run local attention. `image_atts` [n_txt, 1+Np] holds one patch mask per
region text (the CLS position is 1); stacked on all-ones rows for the full
images it is the key mask of the local layers. At the first local layer
the rows of each text's image are gathered (idx_to_group_img) and stacked
on top of the full batch, so those layers run n_txt + B rows; the output
splits into `last_hidden` (the n_txt region rows) and `full_atts_hidden`
(the B full images). On the kernel path the key mask goes into
fused_self_attention(mask=...), whose kernel takes it as a key vector.

Training (train=True): a layer fuses through the kernels' differentiable
forms, and only while attention_dropout is 0 (CLIP's is); otherwise
multi_head_attention runs with dropout on the probabilities.
output_attentions / output_hidden_states collect the KD taps: each layer's
input and the last layer's output (before the post-LN), and each layer's
pre-gate f32 probabilities.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..config import VisionConfig
from ..ops.attention import init_attention, make_attention_bias, multi_head_attention
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
              key_mask: Optional[torch.Tensor] = None,
              head_z: Optional[torch.Tensor] = None, head_layer_z=None,
              mlp_z: Optional[torch.Tensor] = None, output_probs: bool = False,
              dropout_rate: float = 0.0, train: bool = False, generator=None, dtype=None,
              impl: str = "fused"):
    """Pre-LN CLIP layer; returns (h, probs or None). key_mask [B, S] (1 =
    attend) masks keys (the region masks of the local layers)."""
    probs = None
    if lp.get("attn") is not None:  # fully-pruned attention -> identity
        x = layer_norm(lp["ln1"], h, eps=1e-5)
        if impl == "fused" and (not train or dropout_rate == 0.0):
            res = fused_self_attention(
                lp["attn"], x.to(dtype) if dtype is not None else x,
                num_heads=num_heads, mask=key_mask, head_z=head_z,
                return_probs=output_probs, differentiable=train)
            attn_out, probs = res if output_probs else (res, None)
            if head_layer_z is not None:
                attn_out = attn_out * torch.as_tensor(
                    head_layer_z, dtype=attn_out.dtype, device=attn_out.device)
        else:
            attn_out, probs, _ = multi_head_attention(
                lp["attn"], x, num_heads=num_heads,
                bias=None if key_mask is None else make_attention_bias(key_mask),
                head_z=head_z, head_layer_z=head_layer_z, output_probs=output_probs,
                dropout_rate=dropout_rate, generator=generator, train=train, dtype=dtype)
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
    return h, probs


def vit_apply(params: dict, images: torch.Tensor, cfg: VisionConfig, *,
              idx_to_group_img=None, image_atts=None, head_z=None, head_layer_z=None,
              mlp_z=None, output_attentions: bool = False, output_hidden_states: bool = False,
              train: bool = False, generator=None, dtype=None, impl: str = "fused") -> dict:
    """images [B,H,W,3] NHWC; head_z/mlp_z [L,H] / [L,I] stacked per-layer
    gates (None = dense); idx_to_group_img [n_txt] and image_atts [n_txt,
    1+Np] make a region batch (see the module note). Returns {"last_hidden":
    [B, 1+Np, D], "hidden_states", "attentions"} (the lists None unless
    asked for); a region batch's last_hidden holds its n_txt region rows
    and "full_atts_hidden" [B, 1+Np, D] the full images."""
    act = ACT2FN[cfg["hidden_act"]]
    depth = cfg["num_hidden_layers"]
    local_depth = cfg.get("local_attn_depth", 0)
    if idx_to_group_img is not None and local_depth <= 0:
        # the gather happens at the first local layer: without one there are
        # no region rows, and the bbox head would see an empty batch
        raise ValueError("region batches (idx_to_group_img) need a vision config with "
                         "local_attn_depth > 0")
    head_dim = cfg["vision_width"] // cfg["num_attention_heads"]
    embed_dtype = dtype or torch.promote_types(images.dtype,
                                               params["patch_embed"]["kernel"].dtype)
    if impl == "fused":
        h = fused_patch_embed(params, images, patch_size=cfg["patch_size"], eps=1e-5,
                              dtype=embed_dtype, differentiable=train)
    else:
        h = patch_embed_plain(params, images, patch_size=cfg["patch_size"], eps=1e-5,
                              dtype=embed_dtype)
    local_mask = None
    if idx_to_group_img is not None and image_atts is not None:
        full = torch.ones(h.shape[:2], dtype=torch.float32, device=h.device)
        local_mask = torch.cat([image_atts.float(), full], 0)
    all_hidden = [] if output_hidden_states else None
    all_probs = [] if output_attentions else None
    for i, lp in enumerate(params["layers"]):
        if output_hidden_states:
            all_hidden.append(h)  # before the gather, as JAX takes it
        is_local = local_depth > 0 and i >= depth - local_depth
        if idx_to_group_img is not None and i == depth - local_depth:
            h = torch.cat([h[idx_to_group_img], h], 0)
        h, probs = vit_layer(
            lp, h, num_heads=_num_heads(lp, head_dim), act=act,
            key_mask=local_mask if is_local else None,
            head_z=None if head_z is None else head_z[i],
            head_layer_z=None if head_layer_z is None else head_layer_z[i],
            mlp_z=None if mlp_z is None else mlp_z[i], output_probs=output_attentions,
            dropout_rate=cfg.get("attention_dropout", 0.0), train=train, generator=generator,
            dtype=dtype, impl=impl)
        if output_attentions:
            all_probs.append(probs)
    if output_hidden_states:
        all_hidden.append(h)
    h = layer_norm(params["post_ln"], h, eps=1e-5)
    out = {"last_hidden": h, "hidden_states": all_hidden, "attentions": all_probs}
    if idx_to_group_img is not None:
        n_txt = idx_to_group_img.shape[0]
        out["last_hidden"], out["full_atts_hidden"] = h[:n_txt], h[n_txt:]
    return out
