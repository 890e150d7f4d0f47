"""Plain PyTorch reference of the retrieval pruning fine-tune step
(EfficientVLM stage 2, arXiv:2210.07795; X-VLM, arXiv:2111.08276): the
frozen teacher's forward with its distillation taps, the student's forward
under hard-concrete gates and dropout, the ITC, ITM, distillation and
Lagrangian losses, autograd's gradients, and the three AdamW updates, in f32
with TF32 off (or, as the control, with every matrix product's operands
rounded to fp8, reference/xvlm.Fp8). It imports nothing of the port.

Randomness: one generator a step, drawn in the step's order (the teacher's
hard negatives, the gate noise group by group, the text tower's dropout
masks, the student's hard negatives). The reference draws the same stream;
the hard negatives themselves it takes from the program (`negatives`), since
a sampled index flips when two candidates nearly tie under another
precision, and checks that draw by itself (no negative shares its anchor's
image id).

- taps: each layer's input and the last layer's output, and each layer's
  pre-gate softmax maps (cross maps in the fusion layers);
- the teacher's taps are matched to the student's by the layer map of the
  distillation (hidden state i to teacher state i * block, map i to the
  block end);
- the distillation: MSE of hidden states, MSE of maps times the key count,
  the image tower's last state left out, KL of the ITM logits; weights 0.2
  (image hidden), 0.5 (fusion), 0.33 (all taps);
- AdamW: betas (0.9, 0.98), eps 1e-8, decay on >1-D leaves, global-norm
  clip on the model's gradients, the lr schedule linear up over the
  warm-up and down to 0 at the end, read at the run's global step; the gate
  log-alphas at the regulariser's rate, then clamped to [ln 0.01, ln 100];
  the two multipliers at minus that rate (ascent).
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F

from benchmark.reference import xvlm as R

EPS_GATE = 1e-6
LOGA_MIN, LOGA_MAX = math.log(1e-2), math.log(1e2)


# --------------------------------------------------------------------------
# gates
# --------------------------------------------------------------------------


def gate_groups(cfg: dict) -> Dict[str, dict]:
    """Each gate group's shape, parameters per gate and prunable parameters
    (the L0 layout's accounting: a head gate counts its heads' share of the
    attention block, an FFN gate its unit's share of the FFN; an FFN group's
    prunable total is the whole FFN of each layer)."""
    v, t = cfg["vision"], cfg["text"]
    g = int(cfg.get("head_gate_group", 1))
    fusion, n = t["fusion_layer"], t["num_hidden_layers"]

    def sizes(d, i, h):
        per_head = (d * d * 4 + d * 4) // h
        mlp = d * i * 2 + d + d * 4
        return per_head, mlp // i, mlp

    vh, vi, vmlp = sizes(v["vision_width"], v["intermediate_size"], v["num_attention_heads"])
    th, ti, tmlp = sizes(t["hidden_size"], t["intermediate_size"], t["num_attention_heads"])
    lv, lc = v["num_hidden_layers"], n - fusion

    def heads(rows, h, per):
        return {"shape": (rows, h // g), "per": per * g, "prunable": per * g * rows * (h // g)}

    def ffn(rows, i, per, mlp):
        return {"shape": (rows, i), "per": per, "prunable": mlp * rows}

    return {"vision_head": heads(lv, v["num_attention_heads"], vh),
            "text_head": heads(fusion, t["num_attention_heads"], th),
            "cross_head": heads(2 * lc, t["num_attention_heads"], th),
            "vision_intermediate": ffn(lv, v["intermediate_size"], vi, vmlp),
            "text_intermediate": ffn(fusion, t["intermediate_size"], ti, tmlp),
            "cross_intermediate": ffn(lc, t["intermediate_size"], ti, tmlp)}


def logit0(temperature: float) -> float:
    xn = 0.1 / 1.2
    return (math.log(xn) - math.log(1 - xn)) * temperature


def sample_gates(loga: dict, cfg: dict, g: torch.Generator) -> dict:
    """Hard-concrete gates: per group one uniform draw u in (eps, 1 - eps),
    z = clamp(sigmoid((log u - log(1 - u) + loga) / T) * 1.2 - 0.1, 0, 1);
    heads repeated over their group, cross rows paired (self, cross)."""
    t = float(cfg["L0_schedular"]["temperature"])
    rep = int(cfg.get("head_gate_group", 1))
    z = {}
    for name, a in loga.items():
        u = torch.rand(a.shape, generator=g, device=a.device) * (1 - 2 * EPS_GATE) + EPS_GATE
        s = torch.sigmoid((torch.log(u) - torch.log(1 - u) + a) / t) * 1.2 - 0.1
        z[name] = s.clamp(0.0, 1.0)
    heads = lambda x: torch.repeat_interleave(x, rep, dim=-1)  # noqa: E731
    cross = heads(z["cross_head"])
    return {"vision_head": heads(z["vision_head"]), "text_head": heads(z["text_head"]),
            "cross_head": cross.reshape(-1, 2, cross.shape[-1]),
            "vision_ffn": z["vision_intermediate"], "text_ffn": z["text_intermediate"],
            "cross_ffn": z["cross_intermediate"]}


def lagrangian(loga: dict, lam: dict, cfg: dict, step: int, warmup_steps: int):
    """(loss, expected sparsity): λ1 (s - t) + λ2 (s - t)^2 with s the
    expected sparsity of the gates and t the target, ramped linearly from 0
    over the warm-up's steps."""
    temp = float(cfg["L0_schedular"]["temperature"])
    groups = gate_groups(cfg)
    size = sum((1.0 - torch.sigmoid(logit0(temp) - loga[k]).clamp(EPS_GATE, 1 - EPS_GATE)).sum()
               * groups[k]["per"] for k in loga)
    prunable = sum(g["prunable"] for g in groups.values())
    s = 1.0 - size / prunable
    target = float(cfg["sparsity"]) * min(1.0, step / max(warmup_steps, 1))
    d = s - target
    return lam["lambda_1"] * d + lam["lambda_2"] * d * d, s


# --------------------------------------------------------------------------
# layers with taps and dropout
# --------------------------------------------------------------------------


def dropout(x, rate: float, g):
    """Inverted dropout from one uniform draw of x's shape; none without g."""
    if g is None or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=g, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), device=x.device))


def mha(num, p, x, kv, heads, key_bias, head_z, drop=0.0, g=None):
    """Multi-head attention: (output [B, T, D], pre-dropout maps [B, H, T, S])."""
    q, k, v = (R.heads_split(R.linear(num, src, p[n]), heads)
               for n, src in (("q", x), ("k", kv), ("v", kv)))
    scores = num.mm(q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    if key_bias is not None:
        scores = scores + key_bias[:, None, None, :]
    probs = torch.softmax(scores, -1)
    ctx = num.mm(dropout(probs, drop, g), v)
    if head_z is not None:
        ctx = ctx * head_z.reshape(1, -1, 1, 1)
    b, h, t, dh = ctx.shape
    return R.linear(num, ctx.transpose(1, 2).reshape(b, t, h * dh), p["out"]), probs


def vit(num, p, images, vcfg, head_z=None, ffn_z=None):
    """(post-LN hidden, hidden taps, map taps)."""
    ps, d, h = vcfg["patch_size"], vcfg["vision_width"], vcfg["num_attention_heads"]
    b, hh, ww, c = images.shape
    hp, wp = hh // ps, ww // ps
    x = images[:, :hp * ps, :wp * ps].float().reshape(b, hp, ps, wp, ps, c)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, hp * wp, ps * ps * c)
    pos = p["pos_embed"]["embedding"].float()
    y = num.mm(x, p["patch_embed"]["kernel"].float().reshape(-1, d)) + pos[1:1 + hp * wp]
    cls = (p["class_embedding"].float() + pos[0]).expand(b, 1, d)
    hid = R.ln(torch.cat([cls, y], 1), p["pre_ln"], 1e-5)
    hs, maps = [], []
    for i, lp in enumerate(p["layers"]):
        hs.append(hid)
        x = R.ln(hid, lp["ln1"], 1e-5)
        out, probs = mha(num, lp["attn"], x, x, h, None, None if head_z is None else head_z[i])
        maps.append(probs)
        hid = hid + out
        x = R.linear(num, R.ln(hid, lp["ln2"], 1e-5), lp["mlp"]["fc1"])
        if ffn_z is not None:
            x = x * ffn_z[i]
        hid = hid + R.linear(num, R.quick_gelu(x), lp["mlp"]["fc2"])
    hs.append(hid)
    return R.ln(hid, p["post_ln"], 1e-5), hs, maps


def bert_layer(num, lp, hid, bias, tcfg, self_z, ffn_z, g=None, image=None, cross_z=None):
    """A post-LN layer; (hidden, self maps, cross maps or None). Dropout
    (with g): on the maps, after the attention output and after the FFN."""
    eps, h = tcfg["layer_norm_eps"], tcfg["num_attention_heads"]
    hdrop, adrop = tcfg["hidden_dropout_prob"], tcfg["attention_probs_dropout_prob"]
    out, probs = mha(num, lp["attention"], hid, hid, h, bias, self_z, adrop, g)
    hid = R.ln(hid + dropout(out, hdrop, g), lp["attention_ln"], eps)
    xprobs = None
    if image is not None:
        out, xprobs = mha(num, lp["crossattention"], hid, image, h, None, cross_z)
        hid = R.ln(hid + out, lp["crossattention_ln"], eps)
    inter = F.gelu(R.linear(num, hid, lp["intermediate"]))
    if ffn_z is not None:
        inter = inter * ffn_z
    out = dropout(R.linear(num, inter, lp["output"]), hdrop, g)
    return R.ln(hid + out, lp["output_ln"], eps), probs, xprobs


def text(num, p, ids, atts, tcfg, head_z=None, ffn_z=None, g=None):
    """The text layers: (hidden, hidden taps, map taps); the PAD embedding
    row gets no gradient."""
    e = p["embeddings"]
    t = ids.shape[1]
    word = e["word"]["embedding"].float()[ids]
    word = torch.where((ids == tcfg["pad_token_id"])[..., None], word.detach(), word)
    hid = word + e["position"]["embedding"].float()[:t] + e["token_type"]["embedding"].float()[0]
    hid = dropout(R.ln(hid, e["ln"], tcfg["layer_norm_eps"]), tcfg["hidden_dropout_prob"], g)
    bias = (1.0 - atts.float()) * R.NEG
    hs, maps = [], []
    for i in range(tcfg["fusion_layer"]):
        hs.append(hid)
        hid, probs, _ = bert_layer(num, p["layers"][i], hid, bias, tcfg,
                                   None if head_z is None else head_z[i],
                                   None if ffn_z is None else ffn_z[i], g)
        maps.append(probs)
    hs.append(hid)
    return hid, hs, maps


def fusion(num, p, text_hidden, atts, image_hidden, tcfg, head_z=None, ffn_z=None):
    """The fusion layers (no dropout): (hidden, hidden taps, self maps,
    cross maps)."""
    bias = (1.0 - atts.float()) * R.NEG
    hid, hs, maps, xmaps = text_hidden, [], [], []
    for j, lp in enumerate(p["layers"][tcfg["fusion_layer"]:]):
        hs.append(hid)
        hid, probs, xprobs = bert_layer(
            num, lp, hid, bias, tcfg, None if head_z is None else head_z[j][0],
            None if ffn_z is None else ffn_z[j], image=image_hidden,
            cross_z=None if head_z is None else head_z[j][1])
        maps.append(probs)
        xmaps.append(xprobs)
    hs.append(hid)
    return hid, hs, maps, xmaps


def mlp_head(num, hp, x):
    return R.linear(num, F.gelu(R.ln(R.linear(num, x, hp["fc1"]), hp["ln"], 1e-12)), hp["fc2"])


# --------------------------------------------------------------------------
# the model's losses
# --------------------------------------------------------------------------


def consume_negative_draw(g, b: int, device) -> torch.Tensor:
    """The uniform stream one sampled negative per row uses: an Exp(1) draw
    of the [b, b] weights' shape (sampling one index is argmax(w / q))."""
    return torch.empty((b, b), device=device).exponential_(1, generator=g)


@torch.no_grad()
def own_negatives(img_feat, txt_feat, idx, temp, draws):
    """(neg_image, neg_text) drawn from the step's stream: for each image a
    text and for each text an image, with weights softmax(sim / temp) +
    1e-5 and the positives at 0, one index a row as argmax(w / q) over its
    Exp(1) draw q (the i2t draw first)."""
    sim = (img_feat @ txt_feat.T) / temp
    mask = idx == idx.T
    w_i2t = torch.where(mask, 0.0, torch.softmax(sim, 1) + 1e-5)
    w_t2i = torch.where(mask, 0.0, torch.softmax(sim.T, 1) + 1e-5)
    return (w_t2i / draws[1]).argmax(1), (w_i2t / draws[0]).argmax(1)


def forward(num, p, vcfg, tcfg, batch, negatives, g, *, dropout_on: bool = False, z=None):
    """The retrieval model's training forward: ITC and ITM losses, the taps,
    the ITM logits. The student runs with gates z and dropout from g; the
    teacher with neither. negatives: (neg_image_idx, neg_text_idx) as the
    program drew them; g's stream of that draw is consumed here."""
    zv = zt = {}
    if z is not None:
        zv = {"head_z": z["vision_head"], "ffn_z": z["vision_ffn"]}
        zt = {"head_z": z["text_head"], "ffn_z": z["text_ffn"]}
    image_h, img_hs, img_maps = vit(num, p["vision"], batch["image"], vcfg, **zv)
    text_h, txt_hs, txt_maps = text(num, p["text"], batch["text_ids"], batch["text_atts"], tcfg,
                                    g=g if dropout_on else None, **zt)
    img_feat = R.features(num, p, image_h[:, 0], "vision_proj")
    txt_feat = R.features(num, p, text_h[:, 0], "text_proj")
    logits = (img_feat @ txt_feat.T) / p["temp"].float()
    idx = batch["idx"].reshape(-1, 1)
    pos = (idx == idx.T).float()
    labels = pos / pos.sum(1, keepdim=True)
    itc = (-(torch.log_softmax(logits, 1) * labels).sum(1).mean()
           - (torch.log_softmax(logits.T, 1) * labels).sum(1).mean()) / 2
    b = image_h.shape[0]
    draws = [consume_negative_draw(g, b, image_h.device) for _ in range(2)]
    if negatives is None or any(n.shape != (b,) for n in negatives):
        negatives = own_negatives(img_feat, txt_feat, idx, p["temp"].float(), draws)
    neg_image, neg_text = negatives
    fz = {} if z is None else {"head_z": z["cross_head"], "ffn_z": z["cross_ffn"]}
    atts = batch["text_atts"]
    pos_out = fusion(num, p["text"], text_h, atts, image_h, tcfg, **fz)
    neg_out = fusion(num, p["text"], torch.cat([text_h, text_h[neg_text]]),
                     torch.cat([atts, atts[neg_text]]),
                     torch.cat([image_h[neg_image], image_h]), tcfg, **fz)
    cls = torch.cat([pos_out[0][:, 0], neg_out[0][:, 0]])
    itm_logits = mlp_head(num, p["itm_head"], cls)
    itm_labels = torch.cat([torch.ones(b, dtype=torch.long, device=cls.device),
                            torch.zeros(2 * b, dtype=torch.long, device=cls.device)])
    itm = F.cross_entropy(itm_logits, itm_labels)
    return {"itc": itc, "itm": itm, "logits": itm_logits,
            "hidden": {"image": img_hs, "text": txt_hs, "pos": pos_out[1], "neg": neg_out[1]},
            "maps": {"image": img_maps, "text": txt_maps, "pos": pos_out[2], "neg": neg_out[2],
                     "pos_x": pos_out[3], "neg_x": neg_out[3]}}


def matched(teacher: list, n_student: int, maps: bool) -> list:
    """The teacher's taps matched to the student's: hidden state i to
    teacher state i * block, map i to the end of block i."""
    t = len(teacher)
    if maps:
        block = t // n_student
        return [teacher[i * block + block - 1] for i in range(n_student)]
    block = (t - 1) // (n_student - 1)
    return [teacher[i * block] for i in range(n_student)]


def kd(student: list, teacher: list, maps: bool = False, image: bool = False):
    teacher = matched(teacher, len(student), maps)
    total = 0.0
    for i, (s, t) in enumerate(zip(student, teacher)):
        if image and not maps and i == 6:
            continue  # the image tower's seventh state is left out
        mse = (s - t.detach()).square().mean()
        total = total + (mse * s.shape[-1] if maps else mse)
    return total


def distillation(s: dict, t: dict) -> torch.Tensor:
    sh, th, sm, tm = s["hidden"], t["hidden"], s["maps"], t["maps"]
    text_kd = kd(sh["text"], th["text"]) + kd(sm["text"], tm["text"], maps=True)
    img_kd = 0.2 * kd(sh["image"], th["image"], image=True) + kd(sm["image"], tm["image"],
                                                                maps=True)
    cross_kd = 0.5 * (kd(sh["neg"], th["neg"]) + kd(sh["pos"], th["pos"])
                      + sum(kd(sm[k], tm[k], maps=True) for k in ("pos", "pos_x", "neg", "neg_x")))
    tp = torch.softmax(t["logits"].detach(), -1)
    log_ratio = torch.log(tp.clamp(min=1e-12)) - torch.log_softmax(s["logits"], -1)
    kl = (tp * log_ratio).sum(-1).mean()
    return kl + (text_kd + img_kd + cross_kd) * 0.33


# --------------------------------------------------------------------------
# the optimizers
# --------------------------------------------------------------------------


class AdamW:
    """AdamW over a list of leaves, updated in place."""

    def __init__(self, leaves: List[torch.Tensor], lr, *, wd: float = 0.0, clip=None,
                 b1: float = 0.9, b2: float = 0.98, eps: float = 1e-8):
        self.leaves, self.lr, self.wd, self.clip = leaves, lr, wd, clip
        self.b1, self.b2, self.eps, self.count = b1, b2, eps, 0
        self.mu = [torch.zeros_like(p) for p in leaves]
        self.nu = [torch.zeros_like(p) for p in leaves]
        self.first_grads = None

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> None:
        grads = [torch.zeros_like(p) if gr is None else gr.float()
                 for p, gr in zip(self.leaves, grads)]
        if self.clip:
            norm = torch.sqrt(sum(gr.square().sum() for gr in grads))
            if norm >= self.clip:
                grads = [gr / norm * self.clip for gr in grads]
        if self.first_grads is None:
            self.first_grads = [gr.clone() for gr in grads]
        lr = self.lr(self.count) if callable(self.lr) else self.lr
        self.count += 1
        t = self.count
        for p, gr, m, v in zip(self.leaves, grads, self.mu, self.nu):
            m.mul_(self.b1).add_(gr, alpha=1 - self.b1)
            v.mul_(self.b2).addcmul_(gr, gr, value=1 - self.b2)
            upd = (m / (1 - self.b1 ** t)) / ((v / (1 - self.b2 ** t)).sqrt() + self.eps)
            if self.wd and p.ndim > 1:
                upd = upd + self.wd * p
            p.add_(-lr * upd)


def leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in leaves(v)]
    return [] if tree is None else [tree]


def linear_schedule(lr: float, total: int, warmup, start: int = 0):
    """The lr of update `count`, `start` updates into the run: a linear
    rise over the warm-up (a share of `total` when under 1, else a count of
    updates), then a linear fall to 0 at `total`."""
    warm = int(warmup * total) if isinstance(warmup, float) and warmup < 1 else int(warmup)

    def lr_at(count: int) -> float:
        step = count + start
        if step < warm:
            return lr * step / warm
        return lr * min(max((total - step) / max(1, total - warm), 0.0), 1.0)

    return lr_at


class Trainer:
    """The reference's copy of the fine-tune: student params, log-alphas and
    multipliers in f32, the frozen teacher, and the three optimizers."""

    def __init__(self, num, cfg, student: dict, teacher: dict, loga: dict, *,
                 total_steps: int, warmup_steps: int, start_step: int = 0):
        self.num, self.cfg = num, cfg
        self.p = student
        self.t = teacher
        self.loga = loga
        dev = next(iter(loga.values())).device
        self.lam = {k: torch.zeros((), device=dev) for k in ("lambda_1", "lambda_2")}
        opt = cfg["optimizer"]
        clip = float(cfg.get("accelerator", {}).get("CLIP_GRAD_NORM", 1.0) or 0) or None
        self.p_leaves, self.l_leaves = leaves(self.p), list(self.loga.values())
        self.lam_leaves = list(self.lam.values())
        for x in self.p_leaves + self.l_leaves + self.lam_leaves:
            x.requires_grad_(True)
        self.before = {"params": [x.detach().clone() for x in self.p_leaves],
                       "loga": [x.detach().clone() for x in self.l_leaves],
                       "lam": [x.detach().clone() for x in self.lam_leaves]}
        reg = float(opt["reg_learning_rate"])
        sched = linear_schedule(float(opt["lr"]), total_steps,
                                cfg["schedular"].get("num_warmup_steps", 0), start_step)
        self.opts = (AdamW(self.p_leaves, sched,
                           wd=float(opt["weight_decay"]), clip=clip),
                     AdamW(self.l_leaves, reg), AdamW(self.lam_leaves, -reg))
        self.warmup, self.step_no = warmup_steps, start_step
        self.parts = []  # each step's loss and its terms, as floats
        self.vcfg, self.tcfg = cfg["vision"], cfg["text"]
        self.tv, self.tt = cfg["teacher_vision"], cfg["teacher_text"]

    def step(self, batch: dict, g: torch.Generator, teacher_neg, student_neg) -> float:
        """One step from generator g; returns the loss."""
        with torch.no_grad():
            t_out = forward(self.num, self.t, self.tv, self.tt, batch, teacher_neg, g)
        z = sample_gates(self.loga, self.cfg, g)
        s_out = forward(self.num, self.p, self.vcfg, self.tcfg, batch, student_neg, g,
                        dropout_on=True, z=z)
        lag, _ = lagrangian(self.loga, self.lam, self.cfg, self.step_no, self.warmup)
        kd_loss = distillation(s_out, t_out)
        loss = (kd_loss + s_out["itc"] + s_out["itm"]) * 0.5 + lag
        self.parts.append({k: float(v.detach()) for k, v in (
            ("loss", loss), ("loss_itc", s_out["itc"]), ("loss_itm", s_out["itm"]),
            ("loss_kd", kd_loss), ("lagrangian_loss", lag))})
        grads = torch.autograd.grad(loss, self.p_leaves + self.l_leaves + self.lam_leaves,
                                    allow_unused=True)
        n1, n2 = len(self.p_leaves), len(self.l_leaves)
        self.opts[0].step(list(grads[:n1]))
        self.opts[1].step(list(grads[n1:n1 + n2]))
        with torch.no_grad():
            for a in self.l_leaves:
                a.clamp_(LOGA_MIN, LOGA_MAX)
        self.opts[2].step(list(grads[n1 + n2:]))
        self.step_no += 1
        return float(loss.detach())


def rounded_bf16(tree):
    """The tree with every leaf rounded to bf16 and held in f32: the values
    a frozen teacher stored in bf16 computes with."""
    if isinstance(tree, dict):
        return {k: rounded_bf16(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [rounded_bf16(v) for v in tree]
    return tree.to(torch.bfloat16).float()
