"""DeiT-style ViT, an alternative vision tower (port of
efficientvlm_tpu/models/deit.py; the reference's timm-style models/vit.py).

Beside the CLIP tower: the patch embedding has a bias, the positional table
is added with no pre-LN, the MLP is the exact GELU, the layers' LayerNorms
take eps 1e-6 and a final LayerNorm closes the stack. Head and FFN gates as
the CLIP tower takes them.

Each attention is multi_head_attention over the whole sequence: under
impl="fused" its core is the flash kernel (ops/flash_attention.py,
csrc/flash_attention.cu) at Tq = Tk = 1 + patches; its projections and the
patch embedding (a patch-flattening matmul, the stride-p convolution's
arithmetic) are plain. Head counts are read from the q projection's width,
int8-quantized or not.
"""

from __future__ import annotations

import torch

from ..config import VisionConfig
from ..ops.attention import init_attention, multi_head_attention
from ..ops.basic import dense, gelu, init_dense, init_layer_norm, layer_norm
from ..ops.quant import out_width


def init_deit(generator: torch.Generator, cfg: VisionConfig, device=None) -> dict:
    d, p = cfg["vision_width"], cfg["patch_size"]

    def randn(*shape):
        return torch.randn(shape, generator=generator, device=device) * 0.02

    params = {
        "patch_embed": {"kernel": randn(p, p, 3, d), "bias": torch.zeros(d, device=device)},
        "cls_token": randn(d),
        "pos_embed": {"embedding": randn(cfg.num_patches + 1, d)},
        "norm": init_layer_norm(d, device),
        "layers": [],
    }
    for _ in range(cfg["num_hidden_layers"]):
        params["layers"].append({
            "ln1": init_layer_norm(d, device),
            "attn": init_attention(generator, d, cfg["num_attention_heads"], device=device),
            "ln2": init_layer_norm(d, device),
            "mlp": {"fc1": init_dense(generator, d, cfg["intermediate_size"], device=device),
                    "fc2": init_dense(generator, cfg["intermediate_size"], d, device=device)},
        })
    return params


def patchify(images: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
             dtype=None) -> torch.Tensor:
    """A VALID convolution of stride p = the kernel's size over NHWC images
    with an HWIO kernel, as patches [B, gh, gw, p*p*C] @ kernel [p*p*C, D] +
    bias; returns [B, gh, gw, D]."""
    p, _, c, d = kernel.shape
    if dtype is not None:
        images, kernel = images.to(dtype), kernel.to(dtype)
    b, hh, ww, _ = images.shape
    x = images.reshape(b, hh // p, p, ww // p, p, c).permute(0, 1, 3, 2, 4, 5)
    x = x.reshape(b, hh // p, ww // p, p * p * c) @ kernel.reshape(p * p * c, d)
    return x + bias.to(dtype or torch.float32)


def deit_apply(params: dict, images: torch.Tensor, cfg: VisionConfig, *, head_z=None,
               mlp_z=None, output_attentions: bool = False, output_hidden_states: bool = False,
               train: bool = False, generator=None, dtype=None, impl: str = "fused") -> dict:
    """images [B,H,W,3] NHWC -> {"last_hidden" [B, 1+Np, D], "hidden_states",
    "attentions"} (the lists None unless asked for); head_z / mlp_z [L,H] /
    [L,I] per-layer gates. No dropout (JAX's tower has none)."""
    del train, generator
    d = cfg["vision_width"]
    head_dim = d // cfg["num_attention_heads"]
    x = patchify(images, params["patch_embed"]["kernel"], params["patch_embed"]["bias"], dtype)
    b = x.shape[0]
    x = x.reshape(b, -1, d)
    cls = params["cls_token"].to(x.dtype).expand(b, 1, d)
    h = torch.cat([cls, x], 1)
    h = h + params["pos_embed"]["embedding"][None, :h.shape[1]].to(h.dtype)

    all_hidden = [] if output_hidden_states else None
    all_probs = [] if output_attentions else None
    for i, lp in enumerate(params["layers"]):
        if output_hidden_states:
            all_hidden.append(h)
        x = layer_norm(lp["ln1"], h, eps=1e-6)
        attn_out, probs, _ = multi_head_attention(
            lp["attn"], x, num_heads=out_width(lp["attn"]["q"]) // head_dim,
            head_z=None if head_z is None else head_z[i], output_probs=output_attentions,
            dtype=dtype, impl=impl)
        h = h + attn_out
        x = gelu(dense(lp["mlp"]["fc1"], layer_norm(lp["ln2"], h, eps=1e-6), dtype=dtype))
        if mlp_z is not None:
            x = x * mlp_z[i].to(x.dtype)
        h = h + dense(lp["mlp"]["fc2"], x, dtype=dtype)
        if output_attentions:
            all_probs.append(probs)
    if output_hidden_states:
        all_hidden.append(h)
    h = layer_norm(params["norm"], h, eps=1e-6)
    return {"last_hidden": h, "hidden_states": all_hidden, "attentions": all_probs}
