"""X-VLM composite base: vision + text towers, ITC projections, the ITM
and bbox heads and the losses (port of efficientvlm_tpu/models/xvlm.py):

- get_contrastive_loss: ITC with idx-aware soft labels over the world batch:
  with a process group, every rank's features and idx are gathered
  (utils/dist.all_gather_with_grad), as JAX's all_gather over its axis;
- get_matching_loss: ITM with in-batch hard negatives drawn from the softmax
  of the similarities (`sample_hard_negatives`, torch.multinomial with the
  step's generator; a method, so a test can pin the draw);
- get_mlm_loss: MLM over the multi_modal pass, at the masked positions;
- predict_bbox + get_bbox_loss: the region box head and its L1 + GIoU loss.

Gates arrive as a `zs` dict (vision_head_z [Lv,H], vision_intermediate_z
[Lv,I], text_head_z [Lt,H], text_intermediate_z [Lt,I], cross_head_z
[Lc,2,H], cross_intermediate_z [Lc,I]); zs=None runs the dense teacher.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..config import Config, TextConfig, VisionConfig
from ..device import resolve_device
from ..ops.basic import dense, gelu, init_dense, init_layer_norm, layer_norm
from . import bert as B
from . import vit as V
from .box_ops import box_cxcywh_to_xyxy, generalized_box_iou


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
              with_bbox_head: bool = False, vision_init=None, device=None) -> dict:
    params = {
        "vision": (vision_init or V.init_vit)(generator, vision_cfg, device),
        "text": B.init_bert(generator, text_cfg, with_mlm_head=with_mlm_head, device=device),
        "vision_proj": init_dense(generator, vision_cfg["vision_width"], embed_dim,
                                  device=device),
        "text_proj": init_dense(generator, text_cfg["hidden_size"], embed_dim, device=device),
        "temp": torch.tensor(temp, device=device),
        "itm_head": init_mlp_head(generator, text_cfg["hidden_size"], 2, device),
    }
    if with_bbox_head:
        params["bbox_head"] = init_mlp_head(generator, text_cfg["hidden_size"], 4, device)
    return params


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


def vision_encoder_dispatch(config: Optional[Config]):
    """(init_fn(generator, cfg, device), apply_fn(params, images, cfg, **kw))
    of the tower the config selects: Swin with use_swin, DeiT with
    use_deit, else CLIP-ViT (the reference's build_vision_encoder). The gated
    students and the task models run CLIP-ViT only, as JAX's do."""
    config = config or {}
    if config.get("use_swin"):
        from .swin import init_swin, swin_apply

        return init_swin, swin_apply
    if config.get("use_deit"):
        from .deit import deit_apply, init_deit

        return init_deit, deit_apply
    return V.init_vit, V.vit_apply


class XVLM:
    """Stateless namespace bundling the configs; every method is a function
    of (params, inputs). The vision tower is the one config selects
    (vision_encoder_dispatch)."""

    def __init__(self, vision_cfg: VisionConfig, text_cfg: TextConfig,
                 config: Optional[Config] = None):
        self.vision_cfg = vision_cfg
        self.text_cfg = text_cfg
        self.config = config or Config()
        self.embed_dim = self.config.get("embed_dim", 256)
        self.vision_init, self.vision_apply = vision_encoder_dispatch(self.config)

    def init(self, seed: int, *, device=None, **kw) -> dict:
        """Params from a seed, on `device` (default cuda)."""
        device = resolve_device(device)
        generator = torch.Generator(device=device)
        generator.manual_seed(seed)
        return init_xvlm(generator, self.vision_cfg, self.text_cfg,
                         embed_dim=self.embed_dim, temp=self.config.get("temp", 0.07),
                         vision_init=self.vision_init, device=device, **kw)

    def get_vision_embeds(self, params, image, *, idx_to_group_img=None, image_atts=None,
                          zs=None, output_attentions=False, output_hidden_states=False,
                          train=False, generator=None, dtype=None, impl="fused"):
        """Returns (embeds [B,S,D], atts [B,S] ones, tower outputs); for a
        region batch (idx_to_group_img [n_txt], image_atts [n_txt, S]):
        (region embeds [n_txt,S,D], image_atts, full [n_txt,S,D], full_atts
        ones, tower outputs). `full` is the full-attention image row of each
        text, gathered by idx_to_group_img as the reference's
        get_vision_embeds does (models/xvlm.py:340-364), so the bbox head
        sees one image row per text; the JAX package returns the B image rows
        ungathered, which breaks predict_bbox when n_txt != B. The CLIP-ViT
        tower takes the region masks in its local layers; the Swin tower
        pools its region rows by them, and they reach the fusion's
        cross-attention as image_atts with either tower."""
        vz, _ = split_zs(zs)
        kw = dict(output_attentions=output_attentions,
                  output_hidden_states=output_hidden_states, train=train, generator=generator,
                  dtype=dtype, impl=impl, **vz)
        if self.vision_apply is V.vit_apply or self.config.get("use_swin"):
            kw.update(idx_to_group_img=idx_to_group_img, image_atts=image_atts)
        elif idx_to_group_img is not None:
            raise ValueError("region batches (idx_to_group_img) need the CLIP-ViT or Swin tower")
        out = self.vision_apply(params["vision"], image, self.vision_cfg, **kw)
        embeds = out["last_hidden"]
        if idx_to_group_img is None:
            atts = torch.ones(embeds.shape[:2], dtype=torch.int32, device=embeds.device)
            return embeds, atts, out
        full = out["full_atts_hidden"][idx_to_group_img]
        full_atts = torch.ones(full.shape[:2], dtype=torch.int32, device=full.device)
        return embeds, image_atts.to(torch.int32), full, full_atts, out

    def get_text_embeds(self, params, text_ids, text_atts, *, zs=None,
                        output_attentions=False, output_hidden_states=False, train=False,
                        generator=None, dtype=None, impl="fused"):
        """mode='text'."""
        _, tz = split_zs(zs)
        return B.bert_apply(
            params["text"], text_ids, self.text_cfg, attention_mask=text_atts, mode="text",
            output_attentions=output_attentions, output_hidden_states=output_hidden_states,
            train=train, generator=generator, dtype=dtype, impl=impl,
            text_head_z=tz.get("text_head_z"), text_mlp_z=tz.get("text_mlp_z"))

    def get_cross_embeds(self, params, image_embeds, image_atts, *, text_embeds, text_atts,
                         zs=None, encoder_groups=1, cross_kv=None, kv_rows=None,
                         output_attentions=False, output_hidden_states=False, train=False,
                         generator=None, dtype=None, impl="fused"):
        """mode='fusion'. encoder_groups > 1 declares image rows shared by
        groups of contiguous text rows (grouped K/V, the i2t rerank). With
        cross_kv, a bank of images' cross K/V (bert.precompute_cross_kv(
        rows=True)), and kv_rows (int32 [B]), text row b attends to bank
        image kv_rows[b] (the t2i rerank); image_embeds is then None and
        image_atts [B, S] the text rows' image mask."""
        _, tz = split_zs(zs)
        return B.bert_apply(
            params["text"], None, self.text_cfg, inputs_embeds=text_embeds,
            attention_mask=text_atts, encoder_hidden=image_embeds,
            encoder_attention_mask=image_atts, mode="fusion", encoder_groups=encoder_groups,
            cross_kv=cross_kv, kv_rows=kv_rows,
            output_attentions=output_attentions, output_hidden_states=output_hidden_states,
            train=train, generator=generator, dtype=dtype, impl=impl,
            cross_head_z=tz.get("cross_head_z"), cross_mlp_z=tz.get("cross_mlp_z"))

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

    # -- losses --------------------------------------------------------------

    def get_contrastive_loss(self, params, image_feat, text_feat, *, idx=None, group=None):
        """ITC with idx-aware soft labels (texts of one image are all
        positives) over this process's batch, or with `group` (a process
        group) over the world batch: the features and idx of every rank
        gathered, the gradient of the gather summed back to each rank's rows
        (efficientvlm_tpu/models/xvlm.py:215-237)."""
        if group is not None:
            from ..utils.dist import all_gather_with_grad

            image_feat = all_gather_with_grad(image_feat, group)
            text_feat = all_gather_with_grad(text_feat, group)
            if idx is not None:
                idx = all_gather_with_grad(idx, group)
        logits = (image_feat @ text_feat.t()).float() / params["temp"]
        bsz = logits.shape[0]
        if idx is None:
            labels = torch.eye(bsz, device=logits.device)
        else:
            idx = idx.reshape(-1, 1)
            pos = (idx == idx.t()).float()
            labels = pos / pos.sum(1, keepdim=True)
        loss_i2t = -(torch.log_softmax(logits, dim=1) * labels).sum(1).mean()
        loss_t2i = -(torch.log_softmax(logits.t(), dim=1) * labels).sum(1).mean()
        return (loss_i2t + loss_t2i) / 2

    def sample_hard_negatives(self, generator, image_feat, text_feat, *, idx=None, temp):
        """(neg_image_idx, neg_text_idx) [B]: for each image a text and for
        each text an image, drawn with weights softmax(sim / temp) + 1e-5,
        positives zeroed (torch.multinomial with `generator`)."""
        sim_i2t = (image_feat @ text_feat.t()).float() / temp
        sim_t2i = (text_feat @ image_feat.t()).float() / temp
        bs = sim_i2t.shape[0]
        if idx is None:
            mask = torch.eye(bs, dtype=torch.bool, device=sim_i2t.device)
        else:
            idx = idx.reshape(-1, 1)
            mask = idx == idx.t()
        w_i2t = torch.where(mask, 0.0, torch.softmax(sim_i2t, dim=1) + 1e-5)
        w_t2i = torch.where(mask, 0.0, torch.softmax(sim_t2i, dim=1) + 1e-5)
        neg_text_idx = torch.multinomial(w_i2t, 1, generator=generator)[:, 0]
        neg_image_idx = torch.multinomial(w_t2i, 1, generator=generator)[:, 0]
        return neg_image_idx, neg_text_idx

    def get_matching_loss(self, params, generator, image_embeds, image_atts, image_feat,
                          text_embeds, text_atts, text_feat, *, idx=None, zs=None,
                          output_attentions=False, output_hidden_states=False, train=False,
                          dtype=None, impl="fused"):
        """ITM over B positives and 2B in-batch hard negatives. Returns the
        loss, or (loss, the KD taps and logits) with output_hidden_states.
        The fusion passes get no generator, as in JAX: no dropout there."""
        bs = image_embeds.shape[0]
        neg_image_idx, neg_text_idx = self.sample_hard_negatives(
            generator, image_feat.detach(), text_feat.detach(), idx=idx,
            temp=params["temp"].detach())
        text_embeds_all = torch.cat([text_embeds, text_embeds[neg_text_idx]], 0)
        text_atts_all = torch.cat([text_atts, text_atts[neg_text_idx]], 0)
        image_embeds_all = torch.cat([image_embeds[neg_image_idx], image_embeds], 0)
        image_atts_all = torch.cat([image_atts[neg_image_idx], image_atts], 0)
        kw = dict(zs=zs, output_attentions=output_attentions,
                  output_hidden_states=output_hidden_states, train=train, dtype=dtype,
                  impl=impl)
        pos = self.get_cross_embeds(params, image_embeds, image_atts, text_embeds=text_embeds,
                                    text_atts=text_atts, **kw)
        neg = self.get_cross_embeds(params, image_embeds_all, image_atts_all,
                                    text_embeds=text_embeds_all, text_atts=text_atts_all, **kw)
        cls = torch.cat([pos["last_hidden"][:, 0], neg["last_hidden"][:, 0]], 0)
        logits = mlp_head_apply(params["itm_head"], cls, dtype=dtype)
        labels = torch.cat([torch.ones(bs, dtype=torch.long, device=cls.device),
                            torch.zeros(2 * bs, dtype=torch.long, device=cls.device)])
        loss = B.cross_entropy_ignore_index(logits, labels)
        if not output_hidden_states:
            return loss
        return loss, {
            "pos_hidden_states": pos["hidden_states"],
            "neg_hidden_states": neg["hidden_states"],
            "pos_attentions": pos["attentions"],
            "neg_attentions": neg["attentions"],
            "pos_cross_attentions": pos["cross_attentions"],
            "neg_cross_attentions": neg["cross_attentions"],
            "logits": logits,
        }

    def get_mlm_loss(self, params, text_ids_masked, text_atts, image_embeds, image_atts,
                     masked_pos, masked_ids, *, zs=None, output_attentions=False,
                     output_hidden_states=False, train=False, generator=None, dtype=None,
                     impl="fused"):
        """MLM over the multi_modal pass of the masked text, read at
        masked_pos [B,M] (labels masked_ids [B,M], -100 ignored). Returns the
        loss, or (loss, {"logits", "hidden_states", "attentions",
        "cross_attentions"}) with output_hidden_states."""
        _, tz = split_zs(zs)
        out = B.bert_apply(
            params["text"], text_ids_masked, self.text_cfg, attention_mask=text_atts,
            encoder_hidden=image_embeds, encoder_attention_mask=image_atts, mode="multi_modal",
            output_attentions=output_attentions, output_hidden_states=output_hidden_states,
            train=train, generator=generator, dtype=dtype, impl=impl, **tz)
        gathered = B.gather_seq_out_by_pos(out["last_hidden"], masked_pos)
        logits = B.mlm_head_apply(params["text"]["cls"], gathered, self.text_cfg, dtype=dtype)
        loss = B.mlm_cross_entropy(logits, masked_ids)
        if not output_hidden_states:
            return loss
        return loss, {"logits": logits, "hidden_states": out["hidden_states"],
                      "attentions": out["attentions"],
                      "cross_attentions": out["cross_attentions"]}

    def predict_bbox(self, params, image_embeds, text_embeds, text_atts, *, zs=None,
                     output_attentions=False, output_hidden_states=False, train=False,
                     dtype=None, impl="fused"):
        """Box [B,4] (cx, cy, w, h in [0, 1], f32) from the fusion pass of
        the text over its full image. The pass has no dropout (no generator,
        as in JAX); train marks a forward that autograd records, as in
        get_matching_loss. Returns the box, or (box, fusion outputs)."""
        image_atts = torch.ones(image_embeds.shape[:2], dtype=torch.int32,
                                device=image_embeds.device)
        out = self.get_cross_embeds(params, image_embeds, image_atts, text_embeds=text_embeds,
                                    text_atts=text_atts, zs=zs,
                                    output_attentions=output_attentions,
                                    output_hidden_states=output_hidden_states, train=train,
                                    dtype=dtype, impl=impl)
        coord = mlp_head_apply(params["bbox_head"], out["last_hidden"][:, 0], dtype=dtype)
        coord = torch.sigmoid(coord.float())
        return (coord, out) if output_hidden_states else coord

    def get_bbox_loss(self, output_coord, target_bbox, *, is_image=None):
        """(L1, GIoU) losses over the boxes. The GIoU loss of the whole batch
        is 0 when any predicted or target box is degenerate (x1 < x0 or y1 <
        y0), as the reference does; rows with is_image 1 (a whole-image
        "region") count for neither loss."""
        loss_bbox = (output_coord - target_bbox).abs()
        boxes1, boxes2 = box_cxcywh_to_xyxy(output_coord), box_cxcywh_to_xyxy(target_bbox)
        degen = (boxes1[:, 2:] < boxes1[:, :2]).any() | (boxes2[:, 2:] < boxes2[:, :2]).any()
        giou = 1.0 - torch.diagonal(generalized_box_iou(boxes1, boxes2))
        loss_giou = torch.where(degen, torch.zeros_like(giou), giou)
        if is_image is None:
            num_boxes = target_bbox.shape[0]
        else:
            not_image = 1 - is_image.to(loss_bbox.dtype)
            num_boxes = not_image.sum().clamp(min=1)
            loss_bbox = loss_bbox * not_image.reshape(-1, 1)
            loss_giou = loss_giou * not_image
        return loss_bbox.sum() / num_boxes, loss_giou.sum() / num_boxes
