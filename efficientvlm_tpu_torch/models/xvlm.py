"""X-VLM composite base: vision + text towers, ITC projections, ITM head
(port of the evaluation half of efficientvlm_tpu/models/xvlm.py).

Gates arrive as a `zs` dict (vision_head_z [Lv,H], vision_intermediate_z
[Lv,I], text_head_z [Lt,H], text_intermediate_z [Lt,I], cross_head_z
[Lc,2,H], cross_intermediate_z [Lc,I]); zs=None runs the dense teacher.
The losses come with the training slice.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..config import Config, TextConfig, VisionConfig
from ..device import resolve_device
from ..ops.basic import dense, gelu, init_dense, init_layer_norm, layer_norm
from . import bert as B
from . import vit as V


def init_mlp_head(generator, d_in: int, d_out: int, device=None) -> dict:
    """2-layer MLP head with a mid LayerNorm."""
    return {
        "fc1": init_dense(generator, d_in, d_in * 2, device=device),
        "ln": init_layer_norm(d_in * 2, device),
        "fc2": init_dense(generator, d_in * 2, d_out, device=device),
    }


def mlp_head_apply(params: dict, x: torch.Tensor, *, dtype=None) -> torch.Tensor:
    x = dense(params["fc1"], x, dtype=dtype)
    x = layer_norm(params["ln"], x)
    x = gelu(x)
    return dense(params["fc2"], x, dtype=dtype)


def init_xvlm(generator, vision_cfg: VisionConfig, text_cfg: TextConfig, *,
              embed_dim: int = 256, temp: float = 0.07, with_mlm_head: bool = True,
              device=None) -> dict:
    return {
        "vision": V.init_vit(generator, vision_cfg, device),
        "text": B.init_bert(generator, text_cfg, with_mlm_head=with_mlm_head, device=device),
        "vision_proj": init_dense(generator, vision_cfg["vision_width"], embed_dim,
                                  device=device),
        "text_proj": init_dense(generator, text_cfg["hidden_size"], embed_dim, device=device),
        "temp": torch.tensor(temp, device=device),
        "itm_head": init_mlp_head(generator, text_cfg["hidden_size"], 2, device),
    }


def split_zs(zs: Optional[dict]):
    """zs dict -> (vision gates, text/cross gates) kwargs."""
    if zs is None:
        return {}, {}
    vision = {"head_z": zs.get("vision_head_z"), "mlp_z": zs.get("vision_intermediate_z")}
    if "vision_head_layer_z" in zs:
        vision["head_layer_z"] = zs["vision_head_layer_z"]
    text = {
        "text_head_z": zs.get("text_head_z"),
        "cross_head_z": zs.get("cross_head_z"),
        "text_mlp_z": zs.get("text_intermediate_z"),
        "cross_mlp_z": zs.get("cross_intermediate_z"),
    }
    return vision, text


class XVLM:
    """Stateless namespace bundling the configs; every method is a function
    of (params, inputs)."""

    def __init__(self, vision_cfg: VisionConfig, text_cfg: TextConfig,
                 config: Optional[Config] = None):
        self.vision_cfg = vision_cfg
        self.text_cfg = text_cfg
        self.config = config or Config()
        self.embed_dim = self.config.get("embed_dim", 256)

    def init(self, seed: int, *, device=None, **kw) -> dict:
        """Params from a seed, on `device` (default cuda)."""
        device = resolve_device(device)
        generator = torch.Generator(device=device)
        generator.manual_seed(seed)
        return init_xvlm(generator, self.vision_cfg, self.text_cfg,
                         embed_dim=self.embed_dim, temp=self.config.get("temp", 0.07),
                         device=device, **kw)

    def get_vision_embeds(self, params, image, *, zs=None, dtype=None, impl="fused"):
        """Returns (embeds [B,S,D], atts [B,S] ones, tower outputs)."""
        vz, _ = split_zs(zs)
        out = V.vit_apply(params["vision"], image, self.vision_cfg, dtype=dtype,
                          impl=impl, **vz)
        embeds = out["last_hidden"]
        atts = torch.ones(embeds.shape[:2], dtype=torch.int32, device=embeds.device)
        return embeds, atts, out

    def get_text_embeds(self, params, text_ids, text_atts, *, zs=None, dtype=None,
                        impl="fused"):
        """mode='text'."""
        _, tz = split_zs(zs)
        return B.bert_apply(
            params["text"], text_ids, self.text_cfg, attention_mask=text_atts, mode="text",
            dtype=dtype, impl=impl, text_head_z=tz.get("text_head_z"),
            text_mlp_z=tz.get("text_mlp_z"))

    def get_cross_embeds(self, params, image_embeds, image_atts, *, text_embeds, text_atts,
                         zs=None, encoder_groups=1, dtype=None, impl="fused"):
        """mode='fusion'. encoder_groups > 1 declares image rows shared by
        groups of contiguous text rows (grouped K/V, the i2t rerank)."""
        _, tz = split_zs(zs)
        return B.bert_apply(
            params["text"], None, self.text_cfg, inputs_embeds=text_embeds,
            attention_mask=text_atts, encoder_hidden=image_embeds,
            encoder_attention_mask=image_atts, mode="fusion", encoder_groups=encoder_groups,
            dtype=dtype, impl=impl, cross_head_z=tz.get("cross_head_z"),
            cross_mlp_z=tz.get("cross_mlp_z"))

    def get_features(self, params, image_embeds=None, text_embeds=None, *, dtype=None):
        """CLS projections, L2-normalized."""
        outs = []
        if image_embeds is not None:
            v = dense(params["vision_proj"], image_embeds[:, 0], dtype=dtype)
            outs.append(v / torch.linalg.vector_norm(v, dim=-1, keepdim=True))
        if text_embeds is not None:
            t = dense(params["text_proj"], text_embeds[:, 0], dtype=dtype)
            outs.append(t / torch.linalg.vector_norm(t, dim=-1, keepdim=True))
        return outs[0] if len(outs) == 1 else tuple(outs)
