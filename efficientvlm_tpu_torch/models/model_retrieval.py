"""Retrieval task model (ITC + ITM), teacher and student in one: the
student is the same forward with a zs dict; the teacher passes zs=None
(port of efficientvlm_tpu/models/model_retrieval.py).

Evaluation runs through the XVLM methods and evaluation/retrieval.py;
`forward` is the training forward, whose KD mode (output_hidden_states)
returns the dict of taps that train/steps.retrieval_kd_losses reads.
"""

from __future__ import annotations

from typing import Optional

import torch

from .xvlm import XVLM


class XVLMForRetrieval(XVLM):
    def forward(self, params: dict, image: torch.Tensor, text_ids: torch.Tensor,
                text_atts: torch.Tensor, *, idx: Optional[torch.Tensor] = None,
                zs: Optional[dict] = None, generator: Optional[torch.Generator] = None,
                output_attentions: bool = False, output_hidden_states: bool = False,
                train: bool = False, dtype=None, impl: str = "fused"):
        """(loss_itc, loss_itm), or in KD mode (output_hidden_states) {"loss",
        "hidden_dict", "attention_dict", "cross_attention_dict",
        "logits_dict"}. One generator drives the text tower's dropout and the
        hard-negative draw, in that order."""
        kw = dict(zs=zs, output_attentions=output_attentions,
                  output_hidden_states=output_hidden_states, train=train, generator=generator,
                  dtype=dtype, impl=impl)
        image_embeds, image_atts, vout = self.get_vision_embeds(params, image, **kw)
        tout = self.get_text_embeds(params, text_ids, text_atts, **kw)
        text_embeds = tout["last_hidden"]
        image_feat, text_feat = self.get_features(params, image_embeds, text_embeds, dtype=dtype)
        loss_itc = self.get_contrastive_loss(params, image_feat, text_feat, idx=idx)
        itm = self.get_matching_loss(
            params, generator, image_embeds, image_atts, image_feat, text_embeds, text_atts,
            text_feat, idx=idx, zs=zs, output_attentions=output_attentions,
            output_hidden_states=output_hidden_states, train=train, dtype=dtype, impl=impl)
        if not output_hidden_states:
            return loss_itc, itm
        loss_itm, extra = itm
        return {
            "loss": {"loss_itc": loss_itc, "loss_itm": loss_itm},
            "hidden_dict": {
                "image_hidden_states": vout["hidden_states"],
                "text_hidden_states": tout["hidden_states"],
                "itm_pos_hidden_states": extra["pos_hidden_states"],
                "itm_neg_hidden_states": extra["neg_hidden_states"],
            },
            "attention_dict": {
                "image_attentions": vout["attentions"],
                "text_attentions": tout["attentions"],
                "itm_pos_attentions": extra["pos_attentions"],
                "itm_neg_attentions": extra["neg_attentions"],
            },
            "cross_attention_dict": {
                "itm_pos_cross_attentions": extra["pos_cross_attentions"],
                "itm_neg_cross_attentions": extra["neg_cross_attentions"],
            },
            "logits_dict": {"itm_head_logits": extra["logits"]},
        }
