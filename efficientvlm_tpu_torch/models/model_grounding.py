"""Visual grounding: a box regressed from the image and the referring text
(port of efficientvlm_tpu/models/model_grounding.py). Params come from
init, XVLM.init with the bbox head; teacher and student are this class,
the student gated by zs.

Training forwards (train=True) draw dropout from one torch.Generator, the
vision tower's first, then the text tower's; the bbox head's fusion pass
gets none, as in JAX.
"""

from __future__ import annotations

from typing import Optional

import torch

from .xvlm import XVLM


class XVLMForGrounding(XVLM):
    def init(self, seed: int, *, device=None, **kw) -> dict:
        """XVLM.init with the bbox head."""
        return super().init(seed, device=device, with_bbox_head=True, **kw)

    def forward(self, params: dict, image: torch.Tensor, text_ids: torch.Tensor,
                text_atts: torch.Tensor, *, target_bbox: Optional[torch.Tensor] = None,
                zs: Optional[dict] = None, generator: Optional[torch.Generator] = None,
                train: bool = True, dtype=None, impl: str = "fused"):
        """train: (loss_bbox, loss_giou) against target_bbox [B, 4]; else the
        predicted boxes [B, 4] (cx, cy, w, h in [0, 1], f32)."""
        kw = dict(zs=zs, train=train, dtype=dtype, impl=impl)
        image_embeds, _, _ = self.get_vision_embeds(params, image, generator=generator, **kw)
        text_embeds = self.get_text_embeds(params, text_ids, text_atts, generator=generator,
                                           **kw)["last_hidden"]
        output_coord = self.predict_bbox(params, image_embeds, text_embeds, text_atts, **kw)
        if not train:
            return output_coord
        return self.get_bbox_loss(output_coord, target_bbox)
