"""Physical pruning export (port of efficientvlm_tpu/pruning/export.py):
fold the learned gates into the weights, then slice the arrays to smaller
shapes, so that the pruned student runs smaller matrix products and fewer
heads through the same kernels.

- head gates fold into the value projection (per-head columns and bias),
  then dropped heads are sliced out of q/k/v (columns) and out (rows);
- FFN gates fold into the down-projection rows (text tower: the gate acts
  after the activation) or into fc1's columns and bias (vision tower: it
  acts before the activation), then dropped units are sliced out;
- a fully pruned sublayer becomes None, which the layers treat as identity.

NLVR's replicated stack (prune_xvlm_params(nlvr=True)) is exported as the
gated dense forward computes it (models/model_nlvr.py), not as JAX's export
does: replicated layer ci's FFN by row ci // 2 of cross_intermediate_z (the
row the forward reads), and each pair-second layer first given a copy of
the pair-first layer's dense cross K/V (the ones it reads), into which its
own cross head gate folds and from which its own heads are sliced. The
pruned text tree is marked untied (model_nlvr.UNTIED): each layer then
reads its own K/V. JAX's export folds the pair-first layer's gate into the
K/V that both layers of a pair read, slices them by it, and reads FFN row
ci; its pruned model differs from the gated one whenever the layers of a
pair keep different heads or FFN units.

align_heads / align_intermediate keep extra zero-folded units so that the
kept widths are multiples of those counts (outputs are unchanged, since the
folded weights of a dropped unit are zero). The head counts the slices
leave are all the attention kernels need: any head count at head dim 32, 64
or 128 runs. Everything here runs without autograd and returns new tensors
on the params' device.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..models.model_nlvr import UNTIED, tie_cross_kv


def _np(z) -> np.ndarray:
    return np.asarray(torch.as_tensor(z).detach().float().cpu()).reshape(-1)


def _fold_head_gate(attn: dict, head_z: np.ndarray, head_dim: int) -> dict:
    v = dict(attn["v"])
    z = torch.from_numpy(np.repeat(head_z.astype(np.float32), head_dim)).to(v["kernel"].device)
    v["kernel"] = attn["v"]["kernel"] * z[None, :].to(v["kernel"].dtype)
    if "bias" in v:
        v["bias"] = attn["v"]["bias"] * z.to(v["bias"].dtype)
    return {**attn, "v": v}


def _align_keep(keep: np.ndarray, dropped: np.ndarray, align: int) -> np.ndarray:
    """Round the kept-unit count up to a multiple of `align` by re-adding
    dropped units (whose folded weights are zero)."""
    if align <= 1 or keep.size % align == 0 or keep.size == 0:
        return keep
    pad = min(align - keep.size % align, dropped.size)
    return np.sort(np.concatenate([keep, dropped[:pad]]))


def _index(x: torch.Tensor, idx: np.ndarray, dim: int) -> torch.Tensor:
    return x.index_select(dim, torch.from_numpy(idx).to(x.device)).contiguous()


def _slice_heads(attn: dict, head_z: np.ndarray, head_dim: int, align: int = 1) -> Optional[dict]:
    keep = np.nonzero(head_z > 0)[0]
    if keep.size == 0:
        return None
    keep = _align_keep(keep, np.nonzero(head_z <= 0)[0], align)
    cols = np.concatenate([np.arange(h * head_dim, (h + 1) * head_dim) for h in keep])
    new = {}
    for name in ("q", "k", "v"):
        p = {"kernel": _index(attn[name]["kernel"], cols, 1)}
        if "bias" in attn[name]:
            p["bias"] = _index(attn[name]["bias"], cols, 0)
        new[name] = p
    new["out"] = {"kernel": _index(attn["out"]["kernel"], cols, 0)}
    if "bias" in attn["out"]:
        new["out"]["bias"] = attn["out"]["bias"]
    return new


def _fold_mlp_gate(fc2: dict, mlp_z: np.ndarray) -> dict:
    """A gate after the activation (text tower) folds into fc2's rows."""
    z = torch.from_numpy(mlp_z.astype(np.float32)).to(fc2["kernel"].device)
    return {**fc2, "kernel": fc2["kernel"] * z[:, None].to(fc2["kernel"].dtype)}


def _fold_mlp_gate_pre(fc1: dict, mlp_z: np.ndarray) -> dict:
    """A gate before the activation (vision tower) folds into fc1's columns
    and bias: exact for any gate value."""
    z = torch.from_numpy(mlp_z.astype(np.float32)).to(fc1["kernel"].device)
    out = {**fc1, "kernel": fc1["kernel"] * z[None, :].to(fc1["kernel"].dtype)}
    if "bias" in fc1:
        out["bias"] = fc1["bias"] * z.to(fc1["bias"].dtype)
    return out


def _slice_mlp(fc1: dict, fc2: dict, mlp_z: np.ndarray, align: int = 1):
    keep = np.nonzero(mlp_z > 0)[0]
    if keep.size == 0:
        return None, None
    keep = _align_keep(keep, np.nonzero(mlp_z <= 0)[0], align)
    nfc1 = {"kernel": _index(fc1["kernel"], keep, 1)}
    if "bias" in fc1:
        nfc1["bias"] = _index(fc1["bias"], keep, 0)
    nfc2 = {"kernel": _index(fc2["kernel"], keep, 0)}
    if "bias" in fc2:
        nfc2["bias"] = fc2["bias"]
    return nfc1, nfc2


@torch.no_grad()
def prune_vit_params(params: dict, zs: dict, *, head_dim: int = 64, align_heads: int = 1,
                     align_intermediate: int = 1) -> dict:
    """Slice the vision tower by vision_head_z [L,H] / vision_intermediate_z
    [L,I]; the gate values are folded first."""
    head_z, mlp_z = zs.get("vision_head_z"), zs.get("vision_intermediate_z")
    layers = []
    for i, lp in enumerate(params["layers"]):
        lp = dict(lp)
        if head_z is not None and lp.get("attn") is not None:
            hz = _np(head_z[i])
            lp["attn"] = _slice_heads(_fold_head_gate(lp["attn"], hz, head_dim), hz, head_dim,
                                      align_heads)
        if mlp_z is not None and lp.get("mlp") is not None:
            mz = _np(mlp_z[i])
            fc1, fc2 = _slice_mlp(_fold_mlp_gate_pre(lp["mlp"]["fc1"], mz), lp["mlp"]["fc2"],
                                  mz, align_intermediate)
            lp["mlp"] = None if fc1 is None else {"fc1": fc1, "fc2": fc2}
        layers.append(lp)
    return {**params, "layers": layers}


@torch.no_grad()
def prune_bert_params(params: dict, zs: dict, *, fusion_layer: int, head_dim: int = 64,
                      decoder: bool = False, nlvr: bool = False, align_heads: int = 1,
                      align_intermediate: int = 1) -> dict:
    """Slice a fusion BERT: layers [0, fusion) by text_head_z /
    text_intermediate_z, layers [fusion, N) by cross_head_z [Lc,2,H] (self,
    cross) / cross_intermediate_z. With decoder=True the decoder_* groups
    drive those layers instead (the VQA answer decoder, fusion_layer 0);
    with nlvr=True the layers are NLVR's replicated stack (see the module
    note) and the result is marked untied."""
    prefix = "decoder" if decoder else "cross"
    text_head_z, text_mlp_z = zs.get("text_head_z"), zs.get("text_intermediate_z")
    cross_head_z, cross_mlp_z = zs.get(f"{prefix}_head_z"), zs.get(f"{prefix}_intermediate_z")
    # NLVR: each pair-second layer slices the dense K/V the tied forward reads
    src = tie_cross_kv(params["layers"], fusion_layer) if nlvr else params["layers"]
    layers = []
    for i, lp in enumerate(src):
        lp = dict(lp)
        if i >= fusion_layer:
            ci = i - fusion_layer
            shz = None if cross_head_z is None else _np(cross_head_z[ci][0])
            xhz = None if cross_head_z is None else _np(cross_head_z[ci][1])
            mz = None if cross_mlp_z is None else _np(cross_mlp_z[ci // 2 if nlvr else ci])
        else:
            shz = None if text_head_z is None else _np(text_head_z[i])
            xhz = None
            mz = None if text_mlp_z is None else _np(text_mlp_z[i])
        for key, hz in (("attention", shz), ("crossattention", xhz)):
            if hz is not None and lp.get(key) is not None:
                lp[key] = _slice_heads(_fold_head_gate(lp[key], hz, head_dim), hz, head_dim,
                                       align_heads)
        if mz is not None and lp.get("intermediate") is not None:
            fc1, fc2 = _slice_mlp(lp["intermediate"], _fold_mlp_gate(lp["output"], mz), mz,
                                  align_intermediate)
            lp["intermediate"], lp["output"] = fc1, fc2
        layers.append(lp)
    out = {**params, "layers": layers}
    if nlvr:
        out[UNTIED] = None
    return out


@torch.no_grad()
def prune_xvlm_params(params: dict, zs: dict, *, fusion_layer: int, head_dim: int = 64,
                      align_heads: int = 1, align_intermediate: int = 1,
                      nlvr: bool = False) -> dict:
    """The whole export: the vision and text towers and a text_decoder,
    which is VQA's answer decoder (fusion_layer 0, the decoder_* gates) when
    zs has decoder_head_z, else captioning's (the text/cross layout at
    fusion_layer). nlvr=True reads the text tower as NLVR's replicated
    stack (see the module note). Params outside the towers are shared with
    the input tree."""
    kw = dict(head_dim=head_dim, align_heads=align_heads,
              align_intermediate=align_intermediate)
    new = dict(params)
    if "vision" in params:
        new["vision"] = prune_vit_params(params["vision"], zs, **kw)
    if "text" in params:
        new["text"] = prune_bert_params(params["text"], zs, fusion_layer=fusion_layer,
                                        nlvr=nlvr, **kw)
    if "text_decoder" in params:
        vqa = "decoder_head_z" in zs
        new["text_decoder"] = prune_bert_params(
            params["text_decoder"], zs, fusion_layer=0 if vqa else fusion_layer, decoder=vqa,
            **kw)
    return new


def load_zs_from_params(params: dict, *, num_heads: int, intermediate_size: int,
                        head_dim: int = 64, fusion_layer: Optional[int] = None,
                        vision_num_heads: Optional[int] = None,
                        vision_intermediate_size: Optional[int] = None,
                        decoder_groups: bool = False, nlvr: bool = False) -> dict:
    """Binary gate masks of every tower from the sliced shapes: how many
    units survived (the first n set), not which. num_heads /
    intermediate_size are the unpruned text widths; vision_* default to
    them. A text_decoder is read as VQA's answer decoder (fusion_layer 0,
    decoder_* groups) with decoder_groups=True, else, when the tree has no
    text tower, as captioning's (the text/cross layout at fusion_layer).
    nlvr=True reads the text tower as NLVR's pruned replicated stack: row r
    < Lc of cross_intermediate_z from the FFN of layer pair r (both layers
    of a pair keep that row's units), rows Lc...2Lc-1, which the forward
    never reads, zero. Returns numpy arrays."""
    v_heads = vision_num_heads or num_heads
    v_inter = vision_intermediate_size or intermediate_size

    def first(n: int, size: int) -> np.ndarray:
        m = np.zeros(size)
        m[:n] = 1
        return m

    def heads(lp, key, n_heads):
        attn = lp.get(key)
        return first(0 if attn is None else attn["q"]["kernel"].shape[1] // head_dim, n_heads)

    def mlp(lp, key, size):
        mod = lp.get(key)
        if mod is None:
            return np.zeros(size)
        return first(mod["fc1"]["kernel"].shape[1] if key == "mlp" else mod["kernel"].shape[1],
                     size)

    def bert_masks(layers: list, fusion: int, prefix: str) -> dict:
        """The text groups of layers [0, fusion) and the `prefix` (self,
        cross pair) groups of the rest."""
        text, cross = layers[:fusion], layers[fusion:]
        out = {}
        if text:
            out["text_head_z"] = np.stack([heads(lp, "attention", num_heads) for lp in text])
            out["text_intermediate_z"] = np.stack(
                [mlp(lp, "intermediate", intermediate_size) for lp in text])
        if cross:
            out[f"{prefix}_head_z"] = np.stack(
                [np.stack([heads(lp, "attention", num_heads),
                           heads(lp, "crossattention", num_heads)]) for lp in cross])
            out[f"{prefix}_intermediate_z"] = np.stack(
                [mlp(lp, "intermediate", intermediate_size) for lp in cross])
        return out

    zs = {}
    if "vision" in params:
        vl = params["vision"]["layers"]
        zs["vision_head_z"] = np.stack([heads(lp, "attn", v_heads) for lp in vl])
        zs["vision_intermediate_z"] = np.stack([mlp(lp, "mlp", v_inter) for lp in vl])
    if "text" in params and fusion_layer is not None:
        zs.update(bert_masks(params["text"]["layers"], fusion_layer, "cross"))
        if nlvr:
            pairs = zs["cross_intermediate_z"][::2]
            zs["cross_intermediate_z"] = np.concatenate([pairs, np.zeros_like(pairs)])
    if "text_decoder" in params:
        if decoder_groups:
            zs.update(bert_masks(params["text_decoder"]["layers"], 0, "decoder"))
        elif fusion_layer is not None and "text" not in params:
            zs.update(bert_masks(params["text_decoder"]["layers"], fusion_layer, "cross"))
    return zs
