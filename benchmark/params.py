"""Weights and gate log-alphas of the X-VLM family, made on the device from a
seed in one draw each, in the tree layout the port reads (the same layout
the reference reads).

The weights are random: speed and agreement with the reference need no
trained values. Their scales keep every layer doing real work: each dense
kernel has std fan_in^-1/2 (unit-scale outputs, so attention is far from
uniform), biases and LayerNorm shifts std 0.1, LayerNorm scales 1 + 0.1 n,
embeddings std 0.5. Every leaf is a view of one f32 draw, the type in which
a fine-tune hands its params to the export and the evaluation.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np


def _dense(din: int, dout: int, bias: bool = True) -> dict:
    p = {"kernel": ("w", (din, dout), din ** -0.5)}
    if bias:
        p["bias"] = ("b", (dout,), 0.1)
    return p


def _ln(d: int) -> dict:
    return {"scale": ("s", (d,), 0.1), "bias": ("b", (d,), 0.1)}


def _attn(d: int, kv: int) -> dict:
    return {"q": _dense(d, d), "k": _dense(kv, d), "v": _dense(kv, d), "out": _dense(d, d)}


def xvlm_layout(cfg: dict, *, mlm_head: bool = False, bbox_head: bool = False) -> dict:
    """The student's (or, with the teacher's towers in cfg, the teacher's)
    tree of (kind, shape, std) leaves: vision, text, the two projections,
    temp and the ITM head (with the MLM and bbox heads on request)."""
    v, t = cfg["vision"], cfg["text"]
    dv, p = v["vision_width"], v["patch_size"]
    n_pos = (v["image_res"] // p) ** 2 + 1
    vision = {"patch_embed": {"kernel": ("w", (p, p, 3, dv), (p * p * 3) ** -0.5)},
              "class_embedding": ("e", (dv,), 0.5),
              "pos_embed": {"embedding": ("e", (n_pos, dv), 0.5)},
              "pre_ln": _ln(dv), "post_ln": _ln(dv),
              "layers": [{"ln1": _ln(dv), "attn": _attn(dv, dv), "ln2": _ln(dv),
                          "mlp": {"fc1": _dense(dv, v["intermediate_size"]),
                                  "fc2": _dense(v["intermediate_size"], dv)}}
                         for _ in range(v["num_hidden_layers"])]}
    d, inter = t["hidden_size"], t["intermediate_size"]
    layers = []
    for i in range(t["num_hidden_layers"]):
        lp = {"attention": _attn(d, d), "attention_ln": _ln(d),
              "intermediate": _dense(d, inter), "output": _dense(inter, d), "output_ln": _ln(d)}
        if i >= t["fusion_layer"]:
            lp["crossattention"] = _attn(d, t["encoder_width"])
            lp["crossattention_ln"] = _ln(d)
        layers.append(lp)
    text = {"embeddings": {"word": {"embedding": ("e", (t["vocab_size"], d), 0.5)},
                           "position": {"embedding": ("e", (t["max_position_embeddings"], d),
                                                      0.5)},
                           "token_type": {"embedding": ("e", (t["type_vocab_size"], d), 0.5)},
                           "ln": _ln(d)},
            "layers": layers}
    if mlm_head:
        text["cls"] = {"transform": {"dense": _dense(d, d), "ln": _ln(d)},
                       "decoder": _dense(d, t["vocab_size"])}
    head = lambda n: {"fc1": _dense(d, 2 * d), "ln": _ln(2 * d), "fc2": _dense(2 * d, n)}  # noqa
    out = {"vision": vision, "text": text, "vision_proj": _dense(dv, cfg["embed_dim"]),
           "text_proj": _dense(d, cfg["embed_dim"]), "temp": ("c", (), cfg["temp"]),
           "itm_head": head(2)}
    if bbox_head:
        out["bbox_head"] = head(4)
    return out


def _leaves(tree, path=()) -> List[Tuple[tuple, tuple]]:
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k], path + (k,))]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree) for x in _leaves(v, path + (i,))]
    return [(path, tree)]


def _set(tree, path, value):
    for k in path[:-1]:
        tree = tree[k]
    tree[path[-1]] = value


def _skeleton(tree):
    if isinstance(tree, dict):
        return {k: _skeleton(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_skeleton(v) for v in tree]
    return None


def materialize(layout: dict, seed: int, device) -> dict:
    """The layout's leaves from one normal draw of a generator on `device`
    seeded with `seed`, f32."""
    import torch

    leaves = _leaves(layout)
    total = sum(int(np.prod(shape)) for _, (_, shape, _) in leaves)
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    flat = torch.randn(total, generator=g, device=device)
    out, at = _skeleton(layout), 0
    with torch.no_grad():
        for path, (kind, shape, std) in leaves:
            n = int(np.prod(shape))
            x = flat[at:at + n].view(shape)
            at += n
            if kind == "s":
                x.mul_(std).add_(1.0)
            elif kind == "c":
                x.fill_(std)
            else:
                x.mul_(std)
            _set(out, path, x)
    return out


def loga_shapes(cfg: dict) -> Dict[str, Tuple[int, int]]:
    """The retrieval student's gate groups (pruning/l0_module's XVLM layout):
    one head gate per head_gate_group adjacent heads, cross heads self and
    cross rows interleaved, one gate per FFN unit."""
    v, t = cfg["vision"], cfg["text"]
    g = cfg.get("head_gate_group", 1)
    fusion, n = t["fusion_layer"], t["num_hidden_layers"]
    return {"vision_head": (v["num_hidden_layers"], v["num_attention_heads"] // g),
            "text_head": (fusion, t["num_attention_heads"] // g),
            "cross_head": (2 * (n - fusion), t["num_attention_heads"] // g),
            "vision_intermediate": (v["num_hidden_layers"], v["intermediate_size"]),
            "text_intermediate": (fusion, t["intermediate_size"]),
            "cross_intermediate": (n - fusion, t["intermediate_size"])}


def _expected_zeros(loga: np.ndarray, temperature: float) -> np.ndarray:
    """Per row, the expected number of closed gates, in f32 as the gates
    are stated (1e-6 clamp)."""
    from benchmark.reference.xvlm_train import logit0

    p = 1.0 / (1.0 + np.exp(-(np.float32(logit0(temperature)) - loga.astype(np.float32))))
    return np.clip(p, 1e-6, 1 - 1e-6).sum(-1)


def draw_loga(cfg: dict, zeros: Dict[str, list], lo: float, hi: float, seed: int,
              device) -> dict:
    """Log-alphas from one uniform draw in [lo, hi), each row shifted so that
    its deterministic gates close exactly the traffic's count of units for
    that row: every seed then exports the same set of widths (so the same
    work), assigned to the layers in a seed-drawn order (cross heads: self
    rows among themselves, cross rows among themselves), with seed-drawn
    units closed."""
    import torch

    shapes = loga_shapes(cfg)
    t = float(cfg["L0_schedular"]["temperature"])
    total = sum(a * b for a, b in shapes.values())
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    flat = (torch.rand(total, generator=g, device=device) * (hi - lo) + lo).cpu().numpy()
    rng = np.random.default_rng(int(seed))
    out, at = {}, 0
    for name, (rows, size) in shapes.items():
        x = flat[at:at + rows * size].reshape(rows, size).astype(np.float64)
        at += rows * size
        want = np.asarray(zeros[name], np.float64)
        if want.shape != (rows,):
            raise ValueError(f"gate_zeros[{name}]: {rows} rows, got {want.shape}")
        if name == "cross_head":  # self and cross rows keep their own counts
            want = want.copy()
            want[0::2], want[1::2] = rng.permutation(want[0::2]), rng.permutation(want[1::2])
        else:
            want = rng.permutation(want)
        for r in range(rows):
            a, b = -30.0, 30.0  # the shift that makes the row's expected zeros its count
            for _ in range(100):
                mid = (a + b) / 2
                if _expected_zeros(x[r] + mid, t) > want[r]:
                    a = mid
                else:
                    b = mid
            x[r] += (a + b) / 2
            if round(float(_expected_zeros(x[r], t))) != want[r]:
                raise ValueError(f"{name} row {r}: cannot close {want[r]} of {size} units")
        out[name] = torch.as_tensor(x.astype(np.float32), device=device)
    return out


def init_loga(cfg: dict, seed: int, device) -> dict:
    """Log-alphas as a pruning run starts them, from one draw: N(10, 0.01)
    for the head gates (all open), N(logit(1 - droprate_init), 0.01) for the
    FFN units."""
    import torch

    shapes = loga_shapes(cfg)
    drop = float(cfg["L0_schedular"].get("droprate_init", 0.5))
    ffn_mean = float(np.log(1 - drop) - np.log(drop))
    total = sum(a * b for a, b in shapes.values())
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    flat = torch.randn(total, generator=g, device=device) * 0.01
    out, at = {}, 0
    for name, (a, b) in shapes.items():
        out[name] = (flat[at:at + a * b].view(a, b) + (10.0 if name.endswith("head")
                                                       else ffn_mean)).contiguous()
        at += a * b
    return out
