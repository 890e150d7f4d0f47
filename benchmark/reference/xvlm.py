"""Plain PyTorch reference of the X-VLM student's evaluation path: the
deterministic L0 gates from the log-alphas, the gated CLIP-ViT, the BERT
text and fusion towers, the ITC features and the ITM head, in f32 with
TF32 off (or, as the control, with every matrix product's operands rounded
to fp8).

It follows the published model (X-VLM, arXiv:2111.08276; EfficientVLM,
arXiv:2210.07795) over the params tree that the benchmark makes, and
imports nothing of the port: the pruned export is not read but worked out
again as the gated dense forward, which computes the same function for
gates of exactly 0 and 1.

- ViT: conv patch embedding (no bias) + CLS + positions, pre-LN, pre-LN
  layers (quick_gelu FFN, its gate before the activation), post-LN, all LN
  eps 1e-5; the local-attention layers attend fully outside region batches.
- BERT: word + position + token-type embeddings, LN eps 1e-12, post-LN
  layers (erf GELU FFN, its gate after the activation); fusion layers add
  cross-attention into the image tokens.
- head gates scale each head's context before the output projection; the
  ITM head is fc1 -> LN (eps 1e-12) -> GELU -> fc2, its score logit 1.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

NEG = -1e9          # additive bias of a masked key
LIMIT_A, LIMIT_B, EPS = -0.1, 1.1, 1e-6  # hard-concrete stretch and clamp


def exact_f32() -> None:
    """f32 products in full f32: no TF32 anywhere."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


class F32:
    """Matrix products in f32."""

    name = "f32"

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.matmul(a, b)


def fp8_round(x: torch.Tensor, dtype=torch.float8_e4m3fn) -> torch.Tensor:
    """x rounded to an fp8 format under one scale for the tensor (its
    largest magnitude to the format's largest), held in f32."""
    top = torch.finfo(dtype).max
    scale = x.abs().amax().clamp(min=1e-30) / top
    return (x / scale).to(dtype).float() * scale


class _Fp8MatMul(torch.autograd.Function):
    """a @ b over e4m3-rounded operands; the backward's products over the
    e5m2-rounded output gradient and the rounded operands, as fp8 training
    runs them."""

    @staticmethod
    def forward(ctx, a, b):
        qa, qb = fp8_round(a), fp8_round(b)
        ctx.save_for_backward(qa, qb)
        return torch.matmul(qa, qb)

    @staticmethod
    def backward(ctx, go):
        qa, qb = ctx.saved_tensors
        g = fp8_round(go, torch.float8_e5m2)
        # the reference's products never broadcast: operands of one rank
        return torch.matmul(g, qb.transpose(-1, -2)), torch.matmul(qa.transpose(-1, -2), g)


class Fp8(F32):
    """The control: each operand of each matrix product rounded to fp8
    (e4m3, and the gradients flowing back e5m2) under one scale per tensor,
    the products accumulated in f32; softmax, LayerNorm and the rest in
    f32."""

    name = "fp8"

    def mm(self, a, b):
        return _Fp8MatMul.apply(a, b)


# --------------------------------------------------------------------------
# gates
# --------------------------------------------------------------------------


def deterministic_row(loga: np.ndarray, temperature: float, magical: float = 0.8) -> np.ndarray:
    """One layer's evaluation mask: round(expected zeros) units with the
    smallest soft mask sigmoid(loga / T * 0.8) are 0, the rest 1 (f32, as
    the gates are stated)."""
    loga = np.asarray(loga, np.float32)
    xn = (0.0 - LIMIT_A) / (LIMIT_B - LIMIT_A)
    logit0 = math.log(xn) - math.log(1 - xn)
    keep = 1.0 - np.clip(1.0 / (1.0 + np.exp(-(logit0 * temperature - loga))), EPS, 1 - EPS)
    zeros = round(float(loga.shape[-1] - keep.sum()))
    soft = 1.0 / (1.0 + np.exp(-loga / temperature * magical))
    mask = np.ones_like(soft)
    if zeros > 0:
        mask[np.argsort(soft)[:zeros]] = 0.0
    return mask


def gates(loga: Dict[str, np.ndarray], cfg: dict) -> Dict[str, np.ndarray]:
    """Per-layer 0/1 gates from the log-alphas: heads [L, H] (each gate
    repeated over head_gate_group heads), cross heads [Lc, 2, H] (self,
    cross), FFN units [L, I]."""
    t = float(cfg["L0_schedular"]["temperature"])
    g = int(cfg.get("head_gate_group", 1))
    rows = {k: np.stack([deterministic_row(r, t) for r in np.asarray(v, np.float32)])
            for k, v in loga.items()}
    heads = lambda z: np.repeat(z, g, axis=-1)  # noqa: E731
    cross = heads(rows["cross_head"])
    return {"vision_head": heads(rows["vision_head"]), "text_head": heads(rows["text_head"]),
            "cross_head": cross.reshape(-1, 2, cross.shape[-1]),
            "vision_ffn": rows["vision_intermediate"], "text_ffn": rows["text_intermediate"],
            "cross_ffn": rows["cross_intermediate"]}


# --------------------------------------------------------------------------
# layers
# --------------------------------------------------------------------------


def ln(x, p, eps):
    return F.layer_norm(x, x.shape[-1:], p["scale"].float(), p["bias"].float(), eps)


def linear(num, x, p):
    y = num.mm(x.reshape(-1, x.shape[-1]), p["kernel"].float())
    y = y.reshape(*x.shape[:-1], y.shape[-1])
    return y + p["bias"].float() if "bias" in p else y


def heads_split(x, h):
    b, t, a = x.shape
    return x.reshape(b, t, h, a // h).transpose(1, 2)


def attend(num, q, k, v, key_bias, head_z):
    """q [B,H,Tq,dh], k/v [B,H,S,dh], key_bias [B,S] additive; head_z [H]
    scales each head's context. Returns [B, Tq, H*dh]."""
    scores = num.mm(q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    if key_bias is not None:
        scores = scores + key_bias[:, None, None, :]
    ctx = num.mm(torch.softmax(scores, -1), v)
    ctx = ctx * head_z.reshape(1, -1, 1, 1)
    b, h, t, dh = ctx.shape
    return ctx.transpose(1, 2).reshape(b, t, h * dh)


def self_attention(num, p, x, key_bias, head_z, h):
    q, k, v = (heads_split(linear(num, x, p[n]), h) for n in ("q", "k", "v"))
    return linear(num, attend(num, q, k, v, key_bias, head_z), p["out"])


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


# --------------------------------------------------------------------------
# towers
# --------------------------------------------------------------------------


def vit(num, p, images, vcfg, head_z, ffn_z):
    """images [B, H, W, 3] -> post-LN hidden [B, 1+Np, D]."""
    ps, d, h = vcfg["patch_size"], vcfg["vision_width"], vcfg["num_attention_heads"]
    b, hh, ww, c = images.shape
    hp, wp = hh // ps, ww // ps
    x = images[:, :hp * ps, :wp * ps].float().reshape(b, hp, ps, wp, ps, c)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, hp * wp, ps * ps * c)
    pos = p["pos_embed"]["embedding"].float()
    y = num.mm(x, p["patch_embed"]["kernel"].float().reshape(ps * ps * c, d)) + pos[1:1 + hp * wp]
    cls = (p["class_embedding"].float() + pos[0]).expand(b, 1, d)
    hid = ln(torch.cat([cls, y], 1), p["pre_ln"], 1e-5)
    for i, lp in enumerate(p["layers"]):
        hid = hid + self_attention(num, lp["attn"], ln(hid, lp["ln1"], 1e-5), None,
                                   head_z[i], h)
        x = linear(num, ln(hid, lp["ln2"], 1e-5), lp["mlp"]["fc1"]) * ffn_z[i]
        hid = hid + linear(num, quick_gelu(x), lp["mlp"]["fc2"])
    return ln(hid, p["post_ln"], 1e-5)


def bert_layer(num, lp, hid, key_bias, tcfg, self_z, ffn_z, cross=None):
    """A post-LN layer; cross = (k, v, cross_z) with k/v [B,H,S,dh] of the
    image tokens (all attended)."""
    eps, h = tcfg["layer_norm_eps"], tcfg["num_attention_heads"]
    hid = ln(hid + self_attention(num, lp["attention"], hid, key_bias, self_z, h),
             lp["attention_ln"], eps)
    if cross is not None:
        k, v, cross_z = cross
        q = heads_split(linear(num, hid, lp["crossattention"]["q"]), h)
        out = linear(num, attend(num, q, k, v, None, cross_z), lp["crossattention"]["out"])
        hid = ln(hid + out, lp["crossattention_ln"], eps)
    inter = F.gelu(linear(num, hid, lp["intermediate"])) * ffn_z
    return ln(hid + linear(num, inter, lp["output"]), lp["output_ln"], eps)


def text(num, p, ids, atts, tcfg, head_z, ffn_z):
    """Token ids [N, T] and their 0/1 mask -> the text layers' hidden [N, T, D]."""
    e = p["embeddings"]
    t = ids.shape[1]
    hid = (e["word"]["embedding"].float()[ids] + e["position"]["embedding"].float()[:t]
           + e["token_type"]["embedding"].float()[0])
    hid = ln(hid, e["ln"], tcfg["layer_norm_eps"])
    bias = (1.0 - atts.float()) * NEG
    for i in range(tcfg["fusion_layer"]):
        hid = bert_layer(num, p["layers"][i], hid, bias, tcfg, head_z[i], ffn_z[i])
    return hid


def cross_kv(num, p, image_hidden, tcfg):
    """Each fusion layer's cross K/V of the image tokens, [N, H, S, dh]."""
    h = tcfg["num_attention_heads"]
    out = []
    for lp in p["layers"][tcfg["fusion_layer"]:]:
        x = lp["crossattention"]
        out.append((heads_split(linear(num, image_hidden, x["k"]), h),
                    heads_split(linear(num, image_hidden, x["v"]), h)))
    return out


def fusion(num, p, text_hidden, atts, kv, tcfg, head_z, ffn_z):
    """The fusion layers over text rows [P, T, D] against per-row image K/V
    (kv: per fusion layer (k, v) [P, H, S, dh]). Returns the CLS hidden [P, D]."""
    bias = (1.0 - atts.float()) * NEG
    hid = text_hidden
    for j, lp in enumerate(p["layers"][tcfg["fusion_layer"]:]):
        k, v = kv[j]
        hid = bert_layer(num, lp, hid, bias, tcfg, head_z[j][0], ffn_z[j],
                         cross=(k, v, head_z[j][1]))
    return hid[:, 0]


def features(num, p, cls, proj: str):
    x = linear(num, cls, p[proj])
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)


def itm_score(num, p, cls):
    hp = p["itm_head"]
    x = F.gelu(ln(linear(num, cls, hp["fc1"]), hp["ln"], 1e-12))
    return linear(num, x, hp["fc2"])[:, 1]


# --------------------------------------------------------------------------
# the evaluation
# --------------------------------------------------------------------------


class Evaluation:
    """The reference's view of one bank: image and text features, and the
    ITM score of any (image, text) pair, computed in blocks so that it fits
    beside nothing else on the card."""

    def __init__(self, num, params, cfg, loga, images, ids, atts, *, device,
                 image_block: int = 16, pair_block: int = 256):
        self.num, self.p, self.cfg = num, params, cfg
        self.vcfg, self.tcfg = cfg["vision"], cfg["text"]
        z = gates({k: v.detach().float().cpu().numpy() for k, v in loga.items()}, cfg)
        as_t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)  # noqa
        self.z = {k: as_t(v) for k, v in z.items()}
        self.pair_block = pair_block
        with torch.no_grad():
            img_h, img_f, kv = [], [], []
            for i in range(0, images.shape[0], image_block):
                x = torch.as_tensor(images[i:i + image_block], device=device)
                hid = vit(num, params["vision"], x, self.vcfg, self.z["vision_head"],
                          self.z["vision_ffn"])
                img_f.append(features(num, params, hid[:, 0], "vision_proj"))
                kv.append(cross_kv(num, params["text"], hid, self.tcfg))
            self.image_feat = torch.cat(img_f)
            self.kv = [(torch.cat([b[j][0] for b in kv]), torch.cat([b[j][1] for b in kv]))
                       for j in range(len(kv[0]))]
            self.ids = torch.as_tensor(ids, device=device)
            self.atts = torch.as_tensor(atts, device=device)
            txt = []
            for i in range(0, self.ids.shape[0], 256):
                txt.append(text(num, params["text"], self.ids[i:i + 256], self.atts[i:i + 256],
                                self.tcfg, self.z["text_head"], self.z["text_ffn"]))
            self.text_hidden = torch.cat(txt)
            self.text_feat = features(num, params, self.text_hidden[:, 0], "text_proj")

    def sims(self) -> np.ndarray:
        """ITC similarities [N_img, N_txt] (f32 product of the unit features)."""
        return (self.image_feat @ self.text_feat.T).cpu().numpy()

    def scores(self, image_idx: np.ndarray, text_idx: np.ndarray) -> np.ndarray:
        """ITM scores of the pairs (image_idx[j], text_idx[j])."""
        out = []
        with torch.no_grad():
            for s in range(0, len(image_idx), self.pair_block):
                ii = torch.as_tensor(image_idx[s:s + self.pair_block], device=self.ids.device)
                tt = torch.as_tensor(text_idx[s:s + self.pair_block], device=self.ids.device)
                kv = [(k[ii], v[ii]) for k, v in self.kv]
                cls = fusion(self.num, self.p["text"], self.text_hidden[tt], self.atts[tt], kv,
                             self.tcfg, self.z["cross_head"], self.z["cross_ffn"])
                out.append(itm_score(self.num, self.p, cls))
        return torch.cat(out).cpu().numpy()


def kept(z: Dict[str, np.ndarray]) -> Optional[dict]:
    """Kept heads and FFN units per layer: {"vision_heads": [...], ...}."""
    count = lambda a: [int(x) for x in np.asarray(a).reshape(len(a), -1).sum(-1)]  # noqa
    return {"vision_heads": count(z["vision_head"]), "vision_ffn": count(z["vision_ffn"]),
            "text_heads": count(z["text_head"]), "text_ffn": count(z["text_ffn"]),
            "cross_self_heads": count(np.asarray(z["cross_head"])[:, 0]),
            "cross_heads": count(np.asarray(z["cross_head"])[:, 1]),
            "cross_ffn": count(z["cross_ffn"])}
