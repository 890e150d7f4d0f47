"""Pretrain / general-distillation model: ITC + ITM + MLM, + bbox L1 / GIoU
on region batches, with the KD output dict (port of
efficientvlm_tpu/models/model_pretrain.py). The teacher (12L/12L) and the
student (6L/6L) are both this class; general distillation has no gates.

Randomness: one torch.Generator drives, in this order, the vision tower's
dropout (none at CLIP's attention_dropout 0), the text tower's dropout, the
hard-negative draw and the dropout of the MLM pass. The ITM and bbox fusion
passes get no generator, as in JAX: no dropout there.

Region batches (ret_bbox_loss): the image embeds of ITC, ITM and MLM are
the region rows, one per text, with the region patch masks as their
attention mask; the bbox head reads each text's full-attention image row
(XVLM.get_vision_embeds gathers it by idx_to_group_img, as the reference
does). A region batch without target_bbox skips the bbox head: the teacher
of a GD step reads none of its outputs (JAX's jit drops that pass as dead
code).
"""

from __future__ import annotations

from typing import Optional

import torch

from .xvlm import XVLM

TEMP_CLAMP = (0.001, 0.5)  # the reference clamps temp after each update


class XVLMForPretrain(XVLM):
    def forward(self, params: dict, image: torch.Tensor, text_ids: torch.Tensor,
                text_atts: torch.Tensor, *, text_ids_masked: Optional[torch.Tensor] = None,
                masked_pos: Optional[torch.Tensor] = None,
                masked_ids: Optional[torch.Tensor] = None,
                image_atts: Optional[torch.Tensor] = None,
                idx_to_group_img: Optional[torch.Tensor] = None,
                target_bbox: Optional[torch.Tensor] = None,
                is_image: Optional[torch.Tensor] = None, ret_bbox_loss: bool = False,
                zs: Optional[dict] = None, generator: Optional[torch.Generator] = None,
                output_attentions: bool = False, output_hidden_states: bool = False,
                train: bool = False, dtype=None, impl: str = "fused", group=None) -> dict:
        """{"loss": {"loss_itc", "loss_itm", "loss_mlm"[, "loss_bbox",
        "loss_giou"]}, "hidden_dict", "attention_dict",
        "cross_attention_dict", "logits_dict"}: the dicts hold the KD taps
        (image_*, text_*, itm_pos_*, itm_neg_*, mlm_*, bbox_* lists and the
        itm_head / mlm logits) with output_hidden_states, else are empty.
        The bbox losses and taps need ret_bbox_loss and target_bbox. `group`:
        the ITC over the world batch of that process group."""
        taps = dict(output_attentions=output_attentions,
                    output_hidden_states=output_hidden_states, dtype=dtype, impl=impl)
        if ret_bbox_loss:
            image_embeds, image_atts, image_embeds_full, _, vout = self.get_vision_embeds(
                params, image, image_atts=image_atts, idx_to_group_img=idx_to_group_img,
                zs=zs, train=train, generator=generator, **taps)
        else:
            image_embeds, image_atts, vout = self.get_vision_embeds(
                params, image, zs=zs, train=train, generator=generator, **taps)
        tout = self.get_text_embeds(params, text_ids, text_atts, zs=zs, train=train,
                                    generator=generator, **taps)
        text_embeds = tout["last_hidden"]
        hidden_dict = {"image_hidden_states": vout["hidden_states"],
                       "text_hidden_states": tout["hidden_states"]}
        attention_dict = {"image_attentions": vout["attentions"],
                          "text_attentions": tout["attentions"]}
        cross_attention_dict: dict = {}
        logits_dict: dict = {}

        image_feat, text_feat = self.get_features(params, image_embeds, text_embeds, dtype=dtype)
        loss_itc = self.get_contrastive_loss(params, image_feat, text_feat, group=group)

        itm = self.get_matching_loss(params, generator, image_embeds, image_atts, image_feat,
                                     text_embeds, text_atts, text_feat, zs=zs, train=train,
                                     **taps)
        if output_hidden_states:
            loss_itm, extra = itm
            hidden_dict["itm_pos_hidden_states"] = extra["pos_hidden_states"]
            hidden_dict["itm_neg_hidden_states"] = extra["neg_hidden_states"]
            attention_dict["itm_pos_attentions"] = extra["pos_attentions"]
            attention_dict["itm_neg_attentions"] = extra["neg_attentions"]
            cross_attention_dict["itm_pos_cross_attentions"] = extra["pos_cross_attentions"]
            cross_attention_dict["itm_neg_cross_attentions"] = extra["neg_cross_attentions"]
            logits_dict["itm_head_logits"] = extra["logits"]
        else:
            loss_itm = itm

        mlm = self.get_mlm_loss(params, text_ids_masked, text_atts, image_embeds, image_atts,
                                masked_pos, masked_ids, zs=zs, train=train, generator=generator,
                                **taps)
        if output_hidden_states:
            loss_mlm, extra = mlm
            hidden_dict["mlm_hidden_states"] = extra["hidden_states"]
            attention_dict["mlm_attentions"] = extra["attentions"]
            cross_attention_dict["mlm_cross_attentions"] = extra["cross_attentions"]
            logits_dict["mlm_logits"] = extra["logits"]
        else:
            loss_mlm = mlm
        loss = {"loss_itc": loss_itc, "loss_itm": loss_itm, "loss_mlm": loss_mlm}

        if ret_bbox_loss and target_bbox is not None:
            bbox = self.predict_bbox(params, image_embeds_full, text_embeds, text_atts, zs=zs,
                                     train=train, **taps)
            if output_hidden_states:
                output_coord, extra = bbox
                hidden_dict["bbox_hidden_states"] = extra["hidden_states"]
                attention_dict["bbox_attentions"] = extra["attentions"]
                cross_attention_dict["bbox_cross_attentions"] = extra["cross_attentions"]
            else:
                output_coord = bbox
            loss["loss_bbox"], loss["loss_giou"] = self.get_bbox_loss(
                output_coord, target_bbox, is_image=is_image)

        return {"loss": loss, "hidden_dict": hidden_dict, "attention_dict": attention_dict,
                "cross_attention_dict": cross_attention_dict, "logits_dict": logits_dict}
