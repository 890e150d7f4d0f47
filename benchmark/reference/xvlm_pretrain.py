"""Plain PyTorch reference of X-VLM's pretraining step (Zeng et al.,
"Multi-Grained Vision Language Pre-Training", arXiv:2111.08276;
github.com/zengyan-97/X-VLM models/model_pretrain.py with
configs/Pretrain_XVLM_base_4m.yaml): the Swin-B tower (reference/swin.py)
over the images, BERT-base's text layers and its fusion layers, the ITC,
ITM, MLM and, on region steps, bbox L1 + GIoU losses, autograd's gradients
and one AdamW update, in f32 with TF32 off (reference/xvlm.exact_f32), or,
as the control, every matrix product's operands rounded to fp8
(reference/xvlm.Fp8). It imports nothing of the port.

One step, with one generator g:
- the image rows: the tower's full rows, or on a region step the region
  rows (each text's image's tokens behind their image_atts-weighted mean)
  with image_atts as the key mask of every cross-attention over them; the
  full rows of each text's image go to the box head;
- the text rows: BERT's first fusion_layer layers over the caption, with
  dropout from g (after the embeddings, on the attention maps, after the
  attention and FFN outputs);
- ITC: the unit [CLS] projections, their products over temp, each row's
  positive its own pair, the two cross-entropies averaged;
- ITM: for each image a text and for each text an image drawn as hard
  negatives (g's stream of that draw is consumed here, the indices taken
  from the program, as reference/xvlm_train does), the fusion layers (no
  dropout) over the positive pairs and the 2B negative pairs, the ITM head
  (fc1, LN eps 1e-12, GELU, fc2) and cross-entropy with label 1 on the
  positives;
- MLM: all layers over the masked caption with dropout from g (on the
  cross-attention maps and outputs too), the MLM head (dense, GELU, LN,
  decoder) at the masked positions, cross-entropy over the labels that
  are not -100;
- bbox (region steps): the fusion layers (no dropout) over each text's
  full image row, the box head through a sigmoid to (cx, cy, w, h); L1 and
  1 - GIoU of each box against its target, over the rows that are not a
  whole image (is_image 0), both 0 for GIoU when any box is degenerate;
- loss: the sum of the terms; AdamW (betas 0.9, 0.98, eps 1e-8, decay
  0.01 on the >1-D leaves whose path names no bias), the gradients
  clipped to the accelerator's global norm, the lr linear up over the
  warm-up and down to 0 at the run's end, read at the run's global step;
  then temp clamped to [0.001, 0.5].

Departures from the published description:
- the device augmentation of the image-text steps (crop at scale 0.2-1,
  flip, RandAugment) is taken from the program, as the hard negatives
  are: the reference starts from the images the step computed with and
  from the generator's state after that draw;
- lr_mult (2) multiplies the lr of the modules that X-VLM's checkpoints
  lack; no checkpoint is loaded here, and the program passes no such
  modules, so it multiplies nothing (as in the program);
- if every row of a region batch is a whole image, X-VLM divides the box
  losses by 0; they are 0 here, as in the program.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn.functional as F

from benchmark.reference import swin as S
from benchmark.reference import xvlm as R
from benchmark.reference import xvlm_train as RT

TEMP_CLAMP = (0.001, 0.5)


def embed(num, e, ids, tcfg, g):
    """Word + position + token-type embeddings, LN, dropout; the PAD row
    gets no gradient."""
    t = ids.shape[1]
    word = e["word"]["embedding"].float()[ids]
    word = torch.where((ids == tcfg["pad_token_id"])[..., None], word.detach(), word)
    hid = word + e["position"]["embedding"].float()[:t] + e["token_type"]["embedding"].float()[0]
    return RT.dropout(R.ln(hid, e["ln"], tcfg["layer_norm_eps"]), tcfg["hidden_dropout_prob"], g)


def bias_of(mask):
    return (1.0 - mask.float()) * R.NEG


def layer(num, lp, hid, bias, tcfg, g=None, image=None, image_bias=None):
    """A post-LN BERT layer with dropout (with g) on the maps and after each
    sublayer's output; with image, cross-attention over it between the
    self-attention and the FFN."""
    eps, h = tcfg["layer_norm_eps"], tcfg["num_attention_heads"]
    hdrop, adrop = tcfg["hidden_dropout_prob"], tcfg["attention_probs_dropout_prob"]
    out, _ = RT.mha(num, lp["attention"], hid, hid, h, bias, None, adrop, g)
    hid = R.ln(hid + RT.dropout(out, hdrop, g), lp["attention_ln"], eps)
    if image is not None:
        out, _ = RT.mha(num, lp["crossattention"], hid, image, h, image_bias, None, adrop, g)
        hid = R.ln(hid + RT.dropout(out, hdrop, g), lp["crossattention_ln"], eps)
    out = R.linear(num, F.gelu(R.linear(num, hid, lp["intermediate"])), lp["output"])
    return R.ln(hid + RT.dropout(out, hdrop, g), lp["output_ln"], eps)


def text(num, p, ids, atts, tcfg, g):
    hid, bias = embed(num, p["embeddings"], ids, tcfg, g), bias_of(atts)
    for lp in p["layers"][:tcfg["fusion_layer"]]:
        hid = layer(num, lp, hid, bias, tcfg, g)
    return hid


def fusion(num, p, text_hidden, atts, image, image_atts, tcfg, g=None):
    """The fusion layers over text rows against their image rows; the
    [CLS] rows out."""
    hid, bias, ibias = text_hidden, bias_of(atts), bias_of(image_atts)
    for lp in p["layers"][tcfg["fusion_layer"]:]:
        hid = layer(num, lp, hid, bias, tcfg, g, image=image, image_bias=ibias)
    return hid


def mlm(num, p, batch, image, image_atts, tcfg, g):
    """The masked caption through every layer (dropout from g) and the MLM
    loss at the masked positions."""
    atts = batch["text_atts"]
    hid = text(num, p, batch["text_ids_masked"], atts, tcfg, g)
    hid = fusion(num, p, hid, atts, image, image_atts, tcfg, g)
    pos = batch["masked_pos"].long()
    hid = hid.gather(1, pos[:, :, None].expand(-1, -1, hid.shape[-1]))
    c = p["cls"]
    x = R.ln(F.gelu(R.linear(num, hid, c["transform"]["dense"])), c["transform"]["ln"],
             tcfg["layer_norm_eps"])
    logits = R.linear(num, x, c["decoder"])
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           batch["masked_ids"].long().reshape(-1), ignore_index=-100)


def xyxy(b):
    cx, cy, w, h = b.unbind(-1)
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)


def giou_loss(pred, target):
    """1 - GIoU of each box with its own target ((cx, cy, w, h) boxes)."""
    a, b = xyxy(pred), xyxy(target)
    area = lambda x: (x[:, 2] - x[:, 0]) * (x[:, 3] - x[:, 1])  # noqa: E731
    lo, hi = torch.maximum(a[:, :2], b[:, :2]), torch.minimum(a[:, 2:], b[:, 2:])
    inter = (hi - lo).clamp(min=0).prod(-1)
    union = area(a) + area(b) - inter
    elo, ehi = torch.minimum(a[:, :2], b[:, :2]), torch.maximum(a[:, 2:], b[:, 2:])
    enclosing = (ehi - elo).clamp(min=0).prod(-1)
    giou = inter / union - (enclosing - union) / enclosing
    degenerate = (a[:, 2:] < a[:, :2]).any() | (b[:, 2:] < b[:, :2]).any()
    return torch.where(degenerate, torch.zeros_like(giou), 1.0 - giou)


def box_losses(pred, target, is_image):
    keep = 1.0 - is_image.float()
    n = keep.sum().clamp(min=1.0)
    return ((pred - target).abs() * keep[:, None]).sum() / n, (giou_loss(pred, target)
                                                               * keep).sum() / n


def forward(num, p, cfg, batch, negatives, g, *, region: bool):
    """The step's loss terms {"loss_itc", "loss_itm", "loss_mlm"[,
    "loss_bbox", "loss_giou"]} from generator g (see the module note);
    negatives: (neg_image_idx, neg_text_idx) as the program drew them."""
    vcfg, tcfg = cfg["vision"], cfg["text"]
    if region:
        idx = batch["idx_to_group_img"].long()
        full, image = S.swin(num, p["vision"], batch["image"], vcfg, idx_to_group_img=idx,
                             image_atts=batch["image_atts"])
        image_atts = batch["image_atts"]
    else:
        image = S.swin(num, p["vision"], batch["image"], vcfg)
        image_atts = torch.ones(image.shape[:2], device=image.device)
    atts = batch["text_atts"]
    text_h = text(num, p["text"], batch["text_ids"], atts, tcfg, g)
    img_feat = R.features(num, p, image[:, 0], "vision_proj")
    txt_feat = R.features(num, p, text_h[:, 0], "text_proj")
    temp = p["temp"].float()
    logits = img_feat @ txt_feat.T / temp
    b = logits.shape[0]
    labels = torch.arange(b, device=logits.device)
    out = {"loss_itc": (F.cross_entropy(logits, labels) + F.cross_entropy(logits.T, labels)) / 2}
    draws = [RT.consume_negative_draw(g, b, logits.device) for _ in range(2)]
    if negatives is None or any(n.shape != (b,) for n in negatives):
        negatives = RT.own_negatives(img_feat, txt_feat, labels[:, None], temp.detach(), draws)
    neg_image, neg_text = negatives
    pos = fusion(num, p["text"], text_h, atts, image, image_atts, tcfg)
    neg = fusion(num, p["text"], torch.cat([text_h, text_h[neg_text]]),
                 torch.cat([atts, atts[neg_text]]), torch.cat([image[neg_image], image]),
                 torch.cat([image_atts[neg_image], image_atts]), tcfg)
    itm_logits = RT.mlp_head(num, p["itm_head"], torch.cat([pos[:, 0], neg[:, 0]]))
    itm_labels = torch.cat([torch.ones(b, dtype=torch.long, device=logits.device),
                            torch.zeros(2 * b, dtype=torch.long, device=logits.device)])
    out["loss_itm"] = F.cross_entropy(itm_logits, itm_labels)
    out["loss_mlm"] = mlm(num, p["text"], batch, image, image_atts, tcfg, g)
    if region:
        rows = full[idx]
        cls = fusion(num, p["text"], text_h, atts, rows, torch.ones(rows.shape[:2],
                                                                     device=rows.device), tcfg)
        box = torch.sigmoid(RT.mlp_head(num, p["bbox_head"], cls[:, 0]))
        out["loss_bbox"], out["loss_giou"] = box_losses(box, batch["target_bbox"].float(),
                                                        batch["is_image"])
    return out


def leaves_with_paths(tree, path=()) -> list:
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in leaves_with_paths(v, path + (str(k),))]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree) for x in leaves_with_paths(v, path + (str(i),))]
    return [] if tree is None else [("/".join(path), tree)]


class AdamW:
    """AdamW over a list of leaves, updated in place, decay on the flagged
    leaves, the gradients clipped to a global norm first."""

    def __init__(self, leaves: List[torch.Tensor], decay: List[bool], lr, *, wd: float,
                 clip: Optional[float], b1: float = 0.9, b2: float = 0.98, eps: float = 1e-8):
        self.leaves, self.decay, self.lr, self.wd, self.clip = leaves, decay, lr, wd, clip
        self.b1, self.b2, self.eps, self.count = b1, b2, eps, 0
        self.mu = [torch.zeros_like(x) for x in leaves]
        self.nu = [torch.zeros_like(x) for x in leaves]
        self.first_grads = None

    @torch.no_grad()
    def step(self, grads) -> None:
        grads = [torch.zeros_like(x) if gr is None else gr.float()
                 for x, gr in zip(self.leaves, grads)]
        if self.clip:
            norm = torch.sqrt(sum(gr.square().sum() for gr in grads))
            if norm >= self.clip:
                grads = [gr / norm * self.clip for gr in grads]
        if self.first_grads is None:
            self.first_grads = [gr.clone() for gr in grads]
        lr = self.lr(self.count)
        self.count += 1
        t = self.count
        for x, gr, m, v, d in zip(self.leaves, grads, self.mu, self.nu, self.decay):
            m.mul_(self.b1).add_(gr, alpha=1 - self.b1)
            v.mul_(self.b2).addcmul_(gr, gr, value=1 - self.b2)
            upd = (m / (1 - self.b1 ** t)) / ((v / (1 - self.b2 ** t)).sqrt() + self.eps)
            if d:
                upd = upd + self.wd * x
            x.add_(-lr * upd)


class Trainer:
    """The reference's copy of the pretraining run: the params in f32 and
    the AdamW, at global step start_step of total_steps."""

    def __init__(self, num, cfg, params: dict, *, total_steps: int, start_step: int):
        self.num, self.cfg, self.p = num, cfg, params
        named = leaves_with_paths(params)
        self.paths = [n for n, _ in named]
        self.leaves = [x for _, x in named]
        for x in self.leaves:
            x.requires_grad_(True)
        self.before = [x.detach().clone() for x in self.leaves]
        opt = cfg["optimizer"]
        clip = float(cfg.get("accelerator", {}).get("CLIP_GRAD_NORM", 0) or 0) or None
        decay = [x.ndim > 1 and "bias" not in n for n, x in named]
        lr = RT.linear_schedule(float(opt["lr"]), total_steps,
                                cfg["schedular"]["num_warmup_steps"], start_step)
        self.opt = AdamW(self.leaves, decay, lr, wd=float(opt["weight_decay"]), clip=clip)
        self.parts = []   # each step's loss and its terms, as floats
        self.after_first = None

    def step(self, batch: dict, g: torch.Generator, negatives, *, region: bool) -> dict:
        """One step from generator g (in its state after the program's
        augmentation draw); returns the terms as floats."""
        terms = forward(self.num, self.p, self.cfg, batch, negatives, g, region=region)
        loss = sum(terms.values())
        grads = torch.autograd.grad(loss, self.leaves, allow_unused=True)
        self.opt.step(list(grads))
        with torch.no_grad():
            self.p["temp"].clamp_(*TEMP_CLAMP)
        if self.after_first is None:
            self.after_first = [x.detach().clone() for x in self.leaves]
        out = {k: float(v.detach()) for k, v in terms.items()}
        out["loss"] = float(loss.detach())
        self.parts.append(out)
        return out
