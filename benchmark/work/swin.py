"""Work counts of X-VLM-base with its Swin-B tower: the FLOP a pretraining
step needs, and the FLOP and bytes of the Swin blocks' window-attention
cores (scores, bias and mask, softmax, P.V), counted from shapes.

A multiply-add counts 2 FLOP; LayerNorms, softmaxes, activations, gathers
and the optimizer are left out of the step's FLOP, as work/xvlm.py leaves
them out. A backward counts twice its forward.
"""

from __future__ import annotations

from typing import Dict, List

from benchmark.work.xvlm import BF16, F32, encoder_layer_flops


def stages(vcfg: dict) -> List[dict]:
    """Per stage: its grid side, width, heads, depth and (clamped) window."""
    g = vcfg["image_res"] // vcfg["patch_size"]
    c, out = vcfg["embed_dim"], []
    for depth, heads in zip(vcfg["depths"], vcfg["num_heads"]):
        out.append({"grid": g, "width": c, "heads": heads, "depth": depth,
                    "window": min(vcfg["window_size"], g)})
        c, g = 2 * c, g // 2
    return out


def swin_forward_flops(vcfg: dict) -> float:
    """One image through the tower: the patch embedding, each block's
    qkv, scores, P.V, proj and MLP, each patch merging."""
    ps = vcfg["patch_size"]
    st = stages(vcfg)
    total = 2.0 * st[0]["grid"] ** 2 * ps * ps * 3 * vcfg["embed_dim"]
    for i, s in enumerate(st):
        n, c = s["grid"] ** 2, s["width"]
        hidden = int(c * vcfg.get("mlp_ratio", 4.0))
        total += s["depth"] * (encoder_layer_flops(n, c, s["heads"], c // s["heads"], hidden,
                                                   s["window"] ** 2))
        if i < len(st) - 1:
            total += 2.0 * (n // 4) * 4 * c * 2 * c
    return total


def window_attention_work(vcfg: dict, images: int) -> Dict[str, float]:
    """FLOP and bytes of every block's attention core over `images` images,
    forward: Q K^T and P.V over each window's tokens and heads; q, k and v
    read once in bf16, each block's bias table and (shifted blocks) its
    window mask once in f32, the context written once in bf16."""
    flops = nbytes = 0.0
    for s in stages(vcfg):
        n, c, w = s["grid"] ** 2, s["width"], s["window"]
        windows = images * (s["grid"] // w) ** 2
        shifts = s["depth"] // 2 if s["grid"] > vcfg["window_size"] else 0
        flops += s["depth"] * 2.0 * 2 * windows * w * w * w * w * c
        nbytes += s["depth"] * (4 * images * n * c * BF16
                                + (2 * vcfg["window_size"] - 1) ** 2 * s["heads"] * F32)
        nbytes += shifts * (s["grid"] // w) ** 2 * (w * w) ** 2 * F32
    return {"flops": flops, "bytes": nbytes}


def text_layer(rows: int, t: int, d: int, heads: int, ffn: int, keys: int,
               cross_keys: int = 0) -> float:
    """A BERT layer over rows x t tokens; with cross_keys, its cross
    sublayer's query side (Q, scores, P.V, output) over that many keys."""
    f = rows * encoder_layer_flops(t, d, heads, d // heads, ffn, keys)
    if cross_keys:
        f += rows * (4.0 * t * d * d + 4.0 * t * cross_keys * d)
    return f


def pretrain_step_flops(cfg: dict, *, texts: int, images: int, text_len: int, masks: int,
                        region: bool) -> Dict[str, float]:
    """FLOP a pretraining step needs at the batch's padded text length:
    the tower over `images` images, the text layers over the captions, the
    ITC logits, the fusion layers over the B positive and 2B negative pairs
    and the ITM head, the MLM pass (every layer, the head at the masked
    slots), and on region steps the box pass and head; each image row's
    cross K/V counted once a step (the region rows' for ITM and MLM, the
    full rows' for the box); forward and backward (3 x the forward)."""
    v, t = cfg["vision"], cfg["text"]
    d, e, heads, ffn = t["hidden_size"], cfg["embed_dim"], t["num_attention_heads"], \
        t["intermediate_size"]
    dv, s = v["vision_width"], stages(v)[-1]["grid"] ** 2 + 1
    fusion, lc = t["fusion_layer"], t["num_hidden_layers"] - t["fusion_layer"]
    kv_row = lc * 2.0 * 2 * s * dv * d  # one image row's cross K and V, every fusion layer
    parts = {
        "swin": images * swin_forward_flops(v) + texts * 2.0 * dv * e,
        "text": fusion * text_layer(texts, text_len, d, heads, ffn, text_len)
        + texts * 2.0 * d * e,
        "itc": 2.0 * texts * texts * e,
        "itm": lc * text_layer(3 * texts, text_len, d, heads, ffn, text_len, s)
        + 3 * texts * (2.0 * d * 2 * d + 2.0 * 2 * d * 2),
        "mlm": (fusion * text_layer(texts, text_len, d, heads, ffn, text_len)
                + lc * text_layer(texts, text_len, d, heads, ffn, text_len, s)
                + texts * masks * (2.0 * d * d + 2.0 * d * t["vocab_size"])),
        "cross_kv": texts * kv_row,
    }
    if region:
        parts["bbox"] = (lc * text_layer(texts, text_len, d, heads, ffn, text_len, s)
                         + texts * (2.0 * d * 2 * d + 2.0 * 2 * d * 4) + images * kv_row)
    forward = sum(parts.values())
    parts["forward"] = forward
    parts["total"] = 3.0 * forward
    return parts
