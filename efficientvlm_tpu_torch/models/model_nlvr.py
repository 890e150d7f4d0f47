"""NLVR2 two-image reasoning model (port of efficientvlm_tpu/models/
model_nlvr.py).

The text encoder's cross layers are replicated x2: layer fusion+2i
cross-attends image0, layer fusion+2i+1 image1, and each pair shares its
cross-attention KEY/VALUE weights (query, output and LNs stay apart). The
tie is structural, as in JAX: `_tie_cross_kv` hands the pair-second layer
the pair-first layer's K/V tensors, so the pair-second layer's own K/V are
never read (they get no gradient and only weight decay moves them) and
autograd sums both layers' contributions into the shared tensors. Both
images run through the vision tower as one 2B batch (image0 rows, then
image1 rows), then split.

Gates: cross_head_z [2Lc, 2, H] is read per replicated layer; the FFN of
replicated layer ci reads row ci // 2 of cross_intermediate_z, which
NLVRL0Module emits with 2Lc rows: rows Lc...2Lc-1 are never read. That is
JAX's forward, kept for parity.

A pruned export (pruning/export.prune_xvlm_params(nlvr=True)) gives every
replicated layer K/V of its own, sliced to its own heads. It marks its text
tree untied with the key UNTIED (value None, so no tree walk sees a leaf);
the forward then reads each layer's own K/V and does not re-tie them.

Training forwards (train=True) draw dropout from one torch.Generator, the
vision tower's first, then the text stack's.
"""

from __future__ import annotations

import re
from typing import Optional

import torch

from ..config import Config, TextConfig, VisionConfig
from ..device import resolve_device
from ..ops.attention import make_attention_bias
from ..ops.basic import dense, init_dense
from . import bert as B
from . import vit as V
from .xvlm import XVLM, init_mlp_head, mlp_head_apply, split_zs

UNTIED = "untied_cross_kv"


def tie_cross_kv(layers: list, fusion_layer: int) -> list:
    """The replicated stack's layers with each pair-second layer (fusion +
    2i + 1) holding the pair-first layer's cross K/V tensors; the other
    entries as they are."""
    layers = list(layers)
    for a in range(fusion_layer, len(layers), 2):
        xa, xb = layers[a]["crossattention"], layers[a + 1]["crossattention"]
        layers[a + 1] = {**layers[a + 1], "crossattention": {**xb, "k": xa["k"], "v": xa["v"]}}
    return layers


def make_nlvr_text_config(text_cfg: TextConfig) -> TextConfig:
    """The text stack with its cross layers doubled: fusion + 2 x (N - fusion)."""
    fusion = text_cfg["fusion_layer"]
    return TextConfig.create(**{**text_cfg,
                                "num_hidden_layers": fusion + 2 * (
                                    text_cfg["num_hidden_layers"] - fusion),
                                "fusion_layer": fusion})


class XVLMForNLVR(XVLM):
    def __init__(self, vision_cfg: VisionConfig, text_cfg: TextConfig,
                 config: Optional[Config] = None):
        super().__init__(vision_cfg, make_nlvr_text_config(text_cfg), config)
        self.base_text_cfg = text_cfg
        self.num_text_layers = text_cfg["fusion_layer"]
        self.num_cross_layers = text_cfg["num_hidden_layers"] - text_cfg["fusion_layer"]

    def _init(self, generator, device, num_labels: int) -> dict:
        return {"vision": V.init_vit(generator, self.vision_cfg, device),
                "text": B.init_bert(generator, self.text_cfg, with_mlm_head=False,
                                    device=device),
                "cls_head": init_mlp_head(generator, self.text_cfg["hidden_size"], num_labels,
                                          device)}

    def init(self, seed: int, *, device=None, num_labels: int = 2) -> dict:
        """{"vision", "text" (the replicated stack, no MLM head), "cls_head"}
        from a seed, on `device` (default cuda)."""
        device = resolve_device(device)
        generator = torch.Generator(device=device)
        generator.manual_seed(seed)
        return self._init(generator, device, num_labels)

    def _tie_cross_kv(self, params: dict) -> dict:
        """The pair-second layers reading the pair-first layers' cross K/V
        (the same tensors); an untied (pruned) tree as it is."""
        if UNTIED in params["text"]:
            return params
        layers = tie_cross_kv(params["text"]["layers"], self.num_text_layers)
        return {**params, "text": {**params["text"], "layers": layers}}

    def cross_forward(self, params, image0_embeds, image0_atts, image1_embeds, image1_atts,
                      text_ids, text_atts, *, zs=None, output_attentions=False,
                      output_hidden_states=False, train=False, generator=None, dtype=None,
                      impl="fused") -> dict:
        """The multi_modal pass, replicated layer ci cross-attending image0
        (ci even) or image1 (ci odd). Returns {"last_hidden",
        "hidden_states", "attentions", "cross_attentions"} (the lists None
        unless asked for)."""
        params = self._tie_cross_kv(params)
        cfg = self.text_cfg
        fusion = self.num_text_layers
        _, gates = split_zs(zs)  # cross_head_z [2Lc, 2, H] over the replicated stack
        h = B.bert_embeddings(params["text"]["embeddings"], text_ids, cfg, train=train,
                              generator=generator, dtype=dtype)
        bias = make_attention_bias(text_atts)
        encoders = ((image0_embeds, make_attention_bias(image0_atts)),
                    (image1_embeds, make_attention_bias(image1_atts)))
        all_hidden = [] if output_hidden_states else None
        all_probs = [] if output_attentions else None
        all_cross = [] if output_attentions else None
        for i in range(cfg["num_hidden_layers"]):
            if output_hidden_states:
                all_hidden.append(h)
            if i >= fusion:
                ci = i - fusion
                enc_h, enc_b = encoders[ci % 2]
                shz, mz = gates.get("cross_head_z"), gates.get("cross_mlp_z")
                self_z, cross_z = (None, None) if shz is None else (shz[ci][0], shz[ci][1])
                mlp_zi = None if mz is None else mz[ci // 2]
            else:
                enc_h = enc_b = cross_z = None
                thz, tm = gates.get("text_head_z"), gates.get("text_mlp_z")
                self_z = None if thz is None else thz[i]
                mlp_zi = None if tm is None else tm[i]
            h, sp, cp, _ = B.bert_layer_apply(
                params["text"]["layers"][i], h, cfg, bias=bias, encoder_hidden=enc_h,
                encoder_bias=enc_b, self_head_z=self_z, cross_head_z=cross_z, mlp_z=mlp_zi,
                output_probs=output_attentions, train=train, generator=generator, dtype=dtype,
                impl=impl)
            if output_attentions:
                all_probs.append(sp)
                if cp is not None:
                    all_cross.append(cp)
        if output_hidden_states:
            all_hidden.append(h)
        return {"last_hidden": h, "hidden_states": all_hidden, "attentions": all_probs,
                "cross_attentions": all_cross}

    def forward(self, params, image, text_ids, text_atts, targets=None, *, zs=None,
                generator=None, train=True, output_attentions=False,
                output_hidden_states=False, dtype=None, impl="fused"):
        """image [2B, H, W, 3]: the image0 batch, then the image1 batch.
        Returns the loss (train) or the logits [B, 2]; with
        output_hidden_states {"loss" (None unless train), "hidden_dict",
        "attention_dict", "cross_attention_dict", "logits_dict"} (the KD
        taps and cls_head_logits)."""
        vz, _ = split_zs(zs)
        vout = V.vit_apply(params["vision"], image, self.vision_cfg,
                           output_attentions=output_attentions,
                           output_hidden_states=output_hidden_states, train=train,
                           generator=generator, dtype=dtype, impl=impl, **vz)
        image_embeds = vout["last_hidden"]
        bs = image_embeds.shape[0] // 2
        atts = torch.ones(image_embeds.shape[:2], dtype=torch.int32, device=image_embeds.device)
        out = self.cross_forward(
            params, image_embeds[:bs], atts[:bs], image_embeds[bs:], atts[bs:], text_ids,
            text_atts, zs=zs, output_attentions=output_attentions,
            output_hidden_states=output_hidden_states, train=train, generator=generator,
            dtype=dtype, impl=impl)
        prediction = mlp_head_apply(params["cls_head"], out["last_hidden"][:, 0], dtype=dtype)
        loss = B.cross_entropy_ignore_index(prediction, targets) if train else None
        if not output_hidden_states:
            return loss if train else prediction
        return {"loss": loss,
                "hidden_dict": {"image_hidden_states": vout["hidden_states"],
                                "text_hidden_states": out["hidden_states"]},
                "attention_dict": {"image_attentions": vout["attentions"],
                                   "text_attentions": out["attentions"]},
                "cross_attention_dict": {"cross_attentions": out["cross_attentions"]},
                "logits_dict": {"cls_head_logits": prediction}}


class XVLMForNLVRPretraining(XVLMForNLVR):
    """The NLVR domain post-pretrain: a 3-way text-pair task over the
    replicated cross stack. With probability 2/3 an image is paired with an
    in-batch hard negative (the label says which slot holds the original),
    else with itself (label 2). The negatives are drawn from softmax(sim /
    0.07) + 1e-5 with the diagonal zeroed (torch.multinomial) and the labels
    uniformly, both from the generator, or pinned through `noise`; the
    passes have no dropout, as in JAX."""

    def init(self, seed: int, *, device=None, **kw) -> dict:
        """{"vision", "text", "ta_head" (a Linear to 3), "vision_proj"}."""
        device = resolve_device(device)
        generator = torch.Generator(device=device)
        generator.manual_seed(seed)
        params = self._init(generator, device, 3)
        params.pop("cls_head")
        params["ta_head"] = init_dense(generator, self.text_cfg["hidden_size"], 3, device=device)
        params["vision_proj"] = init_dense(generator, self.vision_cfg["vision_width"],
                                           self.embed_dim, device=device)
        return params

    def draw_pairs(self, generator, feat: torch.Tensor) -> tuple:
        """(neg_idx [B], labels [B]) from unit image features [B, E]."""
        bs = feat.shape[0]
        sim = (feat @ feat.t()).detach().float() / 0.07
        eye = torch.eye(bs, dtype=torch.bool, device=feat.device)
        weights = torch.where(eye, 0.0, torch.softmax(sim, dim=1) + 1e-5)
        neg_idx = torch.multinomial(weights, 1, generator=generator)[:, 0]
        labels = torch.randint(0, 3, (bs,), generator=generator, device=feat.device)
        return neg_idx, labels

    def pair_forward(self, params, image, text_ids, text_atts, *, generator=None,
                     noise: Optional[dict] = None, zs=None, train: bool = False, dtype=None,
                     impl="fused") -> tuple:
        """(the replicated stack's last hidden state [B,T,D], the ta_head
        logits [B,3], the labels [B]) of the 3-way task. noise {"neg_idx",
        "labels"} pins the draws; train marks a forward that autograd
        records (no dropout either way)."""
        vz, _ = split_zs(zs)
        image_embeds = V.vit_apply(params["vision"], image, self.vision_cfg, train=train,
                                   dtype=dtype, impl=impl, **vz)["last_hidden"]
        atts = torch.ones(image_embeds.shape[:2], dtype=torch.int32, device=image_embeds.device)
        feat = dense(params["vision_proj"], image_embeds[:, 0], dtype=dtype)
        feat = feat / torch.linalg.vector_norm(feat, dim=-1, keepdim=True)
        if noise is None:
            neg_idx, labels = self.draw_pairs(generator, feat)
        else:
            neg_idx, labels = (torch.as_tensor(noise[k], device=feat.device).long()
                               for k in ("neg_idx", "labels"))
        neg = image_embeds[neg_idx]
        lab = labels.reshape(-1, 1, 1)
        img0 = torch.where(lab == 1, neg, image_embeds)
        img1 = torch.where(lab == 0, neg, image_embeds)
        out = self.cross_forward(params, img0, atts, img1, atts, text_ids, text_atts, zs=zs,
                                 train=train, dtype=dtype, impl=impl)
        pred = dense(params["ta_head"], out["last_hidden"][:, 0], dtype=dtype)
        return out["last_hidden"], pred, labels

    def forward_pretrain(self, params, image, text_ids, text_atts, **kw) -> torch.Tensor:
        """The 3-way loss; keyword arguments as pair_forward's."""
        _, pred, labels = self.pair_forward(params, image, text_ids, text_atts, **kw)
        return B.cross_entropy_ignore_index(pred, labels)


def duplicate_cross_layers_for_nlvr(sd: dict, num_text_layers: int) -> dict:
    """Checkpoint remap of a torch-keyed text encoder state dict
    ('...encoder.layer.N....'): every layer N >= num_text_layers becomes
    layers 2(N - num_text_layers) + num_text_layers and the one after it,
    both holding the same value."""
    out = {}
    pat = re.compile(r"(.*encoder\.layer\.)(\d+)(\..*)")
    for k, v in sd.items():
        m = pat.match(k)
        if not m or int(m.group(2)) < num_text_layers:
            out[k] = v
            continue
        new0 = (int(m.group(2)) - num_text_layers) * 2 + num_text_layers
        out[f"{m.group(1)}{new0}{m.group(3)}"] = v
        out[f"{m.group(1)}{new0 + 1}{m.group(3)}"] = v
    return out
