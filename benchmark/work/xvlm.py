"""Work counts of the X-VLM family: the FLOP and bytes of one fused
attention sublayer call (csrc/fused_mha.cu, counted from the call's shapes
as the op's inputs need them: each input byte read once, each output byte
written once, whatever a kernel reads again), and the FLOP that an
evaluation pass of the retrieval task needs at the gates' widths.

A multiply-add counts 2 FLOP. LayerNorms, softmaxes, activations and
gathers are left out of the FLOP (they are not matrix work and a few
percent at most); they are what keeps a share below 100%.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

BF16 = 2
F32 = 4


def attention_call(*, batch: int, tq: int, s: int, d: int, de: int, heads: int, dh: int,
                   self_attn: bool, ln: bool = False, probs: bool = False,
                   vec_bytes: int = F32) -> Tuple[float, float]:
    """(FLOP, bytes) of one sublayer call: queries [batch*tq, d] bf16, keys
    and values from [batch*s, de] bf16 (the queries themselves for
    self-attention), bf16 weights, `vec_bytes` biases, gates and LN params,
    an f32 key bias [batch, s]; out [batch*tq, d] bf16, plus the f32 maps
    [batch, heads, tq, s] with probs. With ln the residual is the query
    input itself (the grouped form's epilogue)."""
    a = heads * dh
    rq, rkv = batch * tq, batch * s
    flops = (2.0 * rq * d * a + 2.0 * 2 * rkv * de * a   # Q; K and V
             + 2.0 * 2 * batch * heads * tq * s * dh     # QK^T and PV
             + 2.0 * rq * a * d)                          # output projection
    nbytes = rq * d * BF16 + (0 if self_attn else rkv * de * BF16)
    nbytes += (d * a + 2 * de * a + a * d) * BF16 + (3 * a + d) * vec_bytes
    nbytes += batch * s * F32 + heads * vec_bytes + (2 * d * vec_bytes if ln else 0)
    nbytes += rq * d * BF16 + (batch * heads * tq * s * F32 if probs else 0)
    return flops, float(nbytes)


def calls_work(calls: List[dict]) -> Tuple[float, float]:
    """Summed (FLOP, bytes) over recorded calls (attention_call's keywords)."""
    f = b = 0.0
    for c in calls:
        cf, cb = attention_call(**c)
        f += cf
        b += cb
    return f, b


def encoder_layer_flops(tokens: int, d: int, heads: int, dh: int, ffn: int,
                        keys: int) -> float:
    """Self-attention (Q, K, V, out; QK^T, PV) and FFN of one layer over
    `tokens` rows attending `keys` keys."""
    a = heads * dh
    return 8.0 * tokens * d * a + 4.0 * tokens * keys * a + 4.0 * tokens * d * ffn


def eval_pass_flops(cfg: dict, kept: Dict[str, list], *, n_img: int, n_txt: int,
                    text_len: int, pairs: int) -> Dict[str, float]:
    """FLOP an evaluation pass needs at the kept widths: the ViT over the
    images, the text layers over the captions (padded length), the ITC
    similarities, and per scored pair the fusion layers' query side and the
    ITM head, with each image's cross K/V counted once per pass and layer
    (the pass's candidates cover every image)."""
    v, t = cfg["vision"], cfg["text"]
    dv, ps, dh = v["vision_width"], v["patch_size"], v["vision_width"] // v["num_attention_heads"]
    n_patch = (v["image_res"] // ps) ** 2
    s = n_patch + 1
    d, e = t["hidden_size"], cfg["embed_dim"]
    tdh = d // t["num_attention_heads"]
    vit = 2.0 * n_patch * ps * ps * 3 * dv + 2.0 * dv * e
    vit += sum(encoder_layer_flops(s, dv, h, dh, f, s)
               for h, f in zip(kept["vision_heads"], kept["vision_ffn"]))
    txt = 2.0 * d * e + sum(encoder_layer_flops(text_len, d, h, tdh, f, text_len)
                            for h, f in zip(kept["text_heads"], kept["text_ffn"]))
    pair = 2.0 * d * 2 * d + 2.0 * 2 * d * 2
    kv = 0.0
    for hs, hx, f in zip(kept["cross_self_heads"], kept["cross_heads"], kept["cross_ffn"]):
        pair += encoder_layer_flops(text_len, d, hs, tdh, f, text_len)
        ax = hx * tdh
        pair += 4.0 * text_len * d * ax + 4.0 * text_len * s * ax
        kv += 4.0 * s * t["encoder_width"] * ax
    parts = {"vit": n_img * vit, "text": n_txt * txt, "itc": 2.0 * n_img * n_txt * e,
             "fusion_pairs": pairs * pair, "cross_kv": n_img * kv}
    parts["total"] = sum(parts.values())
    return parts


def forward_flops(cfg: dict, *, batch: int, text_len: int) -> Dict[str, float]:
    """FLOP of one retrieval training forward at the towers' full widths:
    the ViT over the batch, the text layers over its captions, the ITC
    logits, and the fusion layers and ITM head over the batch's positive
    pairs and its two hard negatives a row (3 x batch pairs), each image's
    cross K/V counted once (every pair's image is one of the batch's)."""
    v, t = cfg["vision"], cfg["text"]
    dv, ps = v["vision_width"], v["patch_size"]
    n_patch = (v["image_res"] // ps) ** 2
    s = n_patch + 1
    d, e = t["hidden_size"], cfg["embed_dim"]
    vit = 2.0 * n_patch * ps * ps * 3 * dv + 2.0 * dv * e + v["num_hidden_layers"] * (
        encoder_layer_flops(s, dv, v["num_attention_heads"], dv // v["num_attention_heads"],
                            v["intermediate_size"], s))
    tdh = d // t["num_attention_heads"]
    layer = encoder_layer_flops(text_len, d, t["num_attention_heads"], tdh,
                                t["intermediate_size"], text_len)
    txt = 2.0 * d * e + t["fusion_layer"] * layer
    lc = t["num_hidden_layers"] - t["fusion_layer"]
    pair = lc * (layer + 4.0 * text_len * d * d + 4.0 * text_len * s * d)
    pair += 2.0 * d * 2 * d + 2.0 * 2 * d * 2
    parts = {"vit": batch * vit, "text": batch * txt, "itc": 2.0 * batch * batch * e,
             "fusion": 3 * batch * pair, "cross_kv": batch * lc * 4.0 * s * t["encoder_width"] * d}
    parts["total"] = sum(parts.values())
    return parts


def train_step_flops(student: dict, teacher: dict, *, batch: int,
                     text_len: int) -> Dict[str, float]:
    """FLOP a pruning fine-tune step needs: the frozen teacher's forward,
    and the student's forward and backward (twice the forward) at its full
    widths (the gates scale units, they remove none in training); no
    recomputed work."""
    t = forward_flops(teacher, batch=batch, text_len=text_len)["total"]
    s = forward_flops(student, batch=batch, text_len=text_len)["total"]
    return {"teacher_forward": t, "student_forward_backward": 3.0 * s, "total": t + 3.0 * s}
