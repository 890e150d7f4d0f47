"""Checkpoint IO (port of efficientvlm_tpu/train/checkpoint.py): the
reference's `.th` and HF `.bin` files read into the port's param tree with
every key remap of the reference's load_pretrained family, and the port's
own native files.

- HF CLIP `vision_model.embeddings.*` -> patch_embed / pos_embed;
- the 12 -> 6 layer mapper {1:0, 3:1, 5:2, 7:3, 9:4, 11:5} of the vision
  and text towers;
- the positional table resized when the resolution changes
  (models/vit.interpolate_pos_embed: the reference's bicubic, not JAX's);
- the `bert.` prefix strip, cross-attention from self-attention for a
  plain BERT, the MLM head's two bias keys;
- build_mlp's Sequential indices 0 / 1 / 3 -> fc1 / ln / fc2;
- the task trees: VQA's decoder from the cross layers, captioning's decoder
  from the text encoder, NLVR's replicated cross layers.

The loaders give the tree JAX's loaders give (the same keys and layouts:
dense kernels [in, out], the patch kernel HWIO), as f32 tensors on the
requested device (default cuda), each leaf with storage of its own (the
optimizers update leaves in place). The other vision towers' files (a
Microsoft Swin, a timm DeiT) fill the vision subtree
(alt_vision_params_from_file), and crossgen_params_from_state_dict builds the
two translation models from an X-VLM checkpoint.

Native files (`.ckpt`) are torch.save payloads: a params-only tree, a
snapshot {"model", "l0", "epoch"} or a full training state {"state",
"extra"}, where a TrainState is saved as its field dict and optimizer
moments as lists of tensors; they hold only tensors, dicts, lists, numbers
and strings, and are read with weights_only=True. Names and rotation are the
reference Checkpointer's (model_state_{step|epoch}_{N},
training_state_latest).

load_pytree also reads the JAX package's own `.ckpt` files, flax msgpack
(efficientvlm_tpu/train/checkpoint.py save_pytree), told apart by their
first bytes (a zip header against a msgpack map) and decoded on msgpack
without flax (decode_flax_msgpack): flax's ndarray, numpy-scalar and
complex extension types, bfloat16 by name, the chunked form of leaves over
2^30 bytes; list indices come back as lists (_relist). So a JAX snapshot,
a JAX full state (its params, gates and epoch) and a JAX physical export
evaluate and serve in the port; a JAX run's optimizer moments do not
resume (drivers/common.restore_full_state raises).
"""

from __future__ import annotations

import dataclasses
import io
import os
import re
from typing import Dict, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..models.model_nlvr import duplicate_cross_layers_for_nlvr
from ..models.vit import interpolate_pos_embed
from ..utils.io import hexists, hlist_files, hmkdir, hopen, hremove

StateDict = Dict[str, torch.Tensor]

LAYER_MAPPER_12_TO_6 = {1: 0, 3: 1, 5: 2, 7: 3, 9: 4, 11: 5}


def load_torch_state_dict(path: str) -> StateDict:
    """A torch checkpoint's tensors by key, on the CPU, unwrapped from a
    {"model": ...}, {"state_dict": ...} or {"module": ...} container. The
    reference's files also pickle non-tensor objects (its config, the
    optimizer), so they are read with weights_only=False: load only files
    you trust."""
    sd = torch.load(path, map_location="cpu", weights_only=False)
    for container_key in ("model", "state_dict", "module"):
        if isinstance(sd, dict) and container_key in sd and isinstance(sd[container_key], dict):
            sd = sd[container_key]
            break
    return {k: v.detach() for k, v in sd.items() if isinstance(v, torch.Tensor)}


def place(tree, device: torch.device):
    """A copy of the tree with every tensor leaf a contiguous f32 tensor of
    its own (integer leaves keep their type) on `device`."""
    if isinstance(tree, dict):
        return {k: place(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [place(v, device) for v in tree]
    if isinstance(tree, torch.Tensor):
        dtype = torch.float32 if tree.is_floating_point() else tree.dtype
        return tree.to(device=device, dtype=dtype, memory_format=torch.contiguous_format,
                       copy=True)
    return tree


def _ln(sd: StateDict, prefix: str) -> dict:
    return {"scale": sd[f"{prefix}.weight"], "bias": sd[f"{prefix}.bias"]}


def _dense(sd: StateDict, prefix: str) -> dict:
    p = {"kernel": sd[f"{prefix}.weight"].t()}
    if f"{prefix}.bias" in sd:
        p["bias"] = sd[f"{prefix}.bias"]
    return p


def _emb(sd: StateDict, key: str) -> dict:
    return {"embedding": sd[key]}


def _mlp_head(sd: StateDict, prefix: str) -> dict:
    """The reference's build_mlp: Sequential(Linear, LayerNorm, GELU, Linear)."""
    return {"fc1": _dense(sd, f"{prefix}.0"), "ln": _ln(sd, f"{prefix}.1"),
            "fc2": _dense(sd, f"{prefix}.3")}


def subsample_layers(sd: StateDict, prefix: str, mapper: Dict[int, int]) -> StateDict:
    """`{prefix}.{i}.` -> `{prefix}.{mapper[i]}.`; layers the mapper does not
    name are dropped (the reference's load_params_choose_layers)."""
    out = {}
    pat = re.compile(re.escape(prefix) + r"\.(\d+)\.(.*)")
    for k, v in sd.items():
        m = pat.match(k)
        if m is None:
            out[k] = v
        elif int(m.group(1)) in mapper:
            out[f"{prefix}.{mapper[int(m.group(1))]}.{m.group(2)}"] = v
    return out


def _layer_count(sd: StateDict, pattern: str) -> int:
    ids = [int(m.group(1)) for m in (re.match(pattern, k) for k in sd) if m]
    return 1 + max(ids) if ids else 0


# ---------------------------------------------------------------------------
# the vision tower
# ---------------------------------------------------------------------------


def convert_hf_clip_vision(sd: StateDict) -> StateDict:
    """HF clip-vit-base-patch16 keys -> the reference's CLIP keys:
    'vision_model.' stripped, embeddings.* flattened, position_ids dropped."""
    out = {}
    for k, v in sd.items():
        if not k.startswith("vision_model."):
            continue
        k = k[len("vision_model."):]
        if k.startswith("embeddings."):
            k = k[len("embeddings."):]
            k = k.replace("patch_embedding.weight", "patch_embed.weight")
            k = k.replace("position_embedding.weight", "pos_embed.weight")
        if k == "position_ids":
            continue
        out[k] = v
    return out


def _vit(sd: StateDict, num_layers: int, num_patches: Optional[int]) -> dict:
    n_ckpt = _layer_count(sd, r"encoder\.layers\.(\d+)\.")
    if n_ckpt == 12 and num_layers == 6:
        sd = subsample_layers(sd, "encoder.layers", LAYER_MAPPER_12_TO_6)
    elif n_ckpt != num_layers:
        raise ValueError(f"checkpoint has {n_ckpt} vision layers, target {num_layers}")
    pos = sd["pos_embed.weight"]
    if num_patches is not None and pos.shape[0] != num_patches + 1:
        pos = interpolate_pos_embed(pos, num_patches)
    params = {
        "patch_embed": {"kernel": sd["patch_embed.weight"].permute(2, 3, 1, 0)},  # OIHW -> HWIO
        "class_embedding": sd["class_embedding"],
        "pos_embed": {"embedding": pos},
        "pre_ln": _ln(sd, "pre_layrnorm"),
        "post_ln": _ln(sd, "post_layernorm"),
        "layers": [],
    }
    for i in range(num_layers):
        p = f"encoder.layers.{i}"
        params["layers"].append({
            "ln1": _ln(sd, f"{p}.layer_norm1"),
            "attn": {"q": _dense(sd, f"{p}.self_attn.q_proj"),
                     "k": _dense(sd, f"{p}.self_attn.k_proj"),
                     "v": _dense(sd, f"{p}.self_attn.v_proj"),
                     "out": _dense(sd, f"{p}.self_attn.out_proj")},
            "ln2": _ln(sd, f"{p}.layer_norm2"),
            "mlp": {"fc1": _dense(sd, f"{p}.mlp.fc1"), "fc2": _dense(sd, f"{p}.mlp.fc2")},
        })
    return params


def vit_params_from_state_dict(sd: StateDict, num_layers: int, *,
                               num_patches: Optional[int] = None, device=None) -> dict:
    """A reference-keyed CLIP ViT state dict -> the vit param tree on
    `device`: the 12 -> 6 mapper when the checkpoint has 12 layers and the
    target 6, and the positional table resized when num_patches differs."""
    return place(_vit(sd, num_layers, num_patches), resolve_device(device))


def interpolate_relative_pos_embed(rel_pos_bias, dst_num_pos: int) -> torch.Tensor:
    """A Swin relative-position bias table [(2w-1)^2, nH] resized to
    dst_num_pos = (2w'-1)^2 entries (the reference's swin_transformer.py,
    the BEiT recipe): the source grid's points spaced outward from the centre
    in a geometric progression, the target grid uniform, each head's table
    through scipy's bicubic RectBivariateSpline, in f32 on the CPU."""
    rel = np.asarray(torch.as_tensor(rel_pos_bias).detach().float().cpu())
    src_num_pos, num_heads = rel.shape
    src_size, dst_size = int(src_num_pos ** 0.5), int(dst_num_pos ** 0.5)
    if src_size == dst_size:
        return torch.from_numpy(rel.copy())

    def geometric_progression(a, r, n):
        return a * (1.0 - r ** n) / (1.0 - r)

    left, right = 1.01, 1.5
    while right - left > 1e-6:
        q = (left + right) / 2.0
        if geometric_progression(1, q, src_size // 2) > dst_size // 2:
            right = q
        else:
            left = q
    dis, cur = [], 1.0
    for i in range(src_size // 2):
        dis.append(cur)
        cur += q ** (i + 1)
    x = np.asarray([-v for v in reversed(dis)] + [0] + dis)
    t = dst_size // 2.0
    dx = np.arange(-t, t + 0.1, 1.0)

    from scipy.interpolate import RectBivariateSpline

    cols = [RectBivariateSpline(x, x, rel[:, h].reshape(src_size, src_size), kx=3, ky=3)(
        dx, dx).reshape(-1, 1) for h in range(num_heads)]
    return torch.from_numpy(np.concatenate(cols, axis=-1).astype(np.float32))


def swin_params_from_state_dict(sd: StateDict, *, depths, window_size: int,
                                device=None) -> dict:
    """A Microsoft Swin-Transformer state dict -> the swin param tree on
    `device`: each relative-position bias table resized to the configured
    window, the relative_position_index / attn_mask buffers and head.*
    ignored."""
    dst_num_pos = (2 * window_size - 1) ** 2
    params: dict = {
        "patch_embed": {"kernel": sd["patch_embed.proj.weight"].permute(2, 3, 1, 0),
                        "bias": sd["patch_embed.proj.bias"]},
        "patch_norm": _ln(sd, "patch_embed.norm"),
        "stages": [],
        "norm": _ln(sd, "norm"),
    }
    for s, depth in enumerate(depths):
        stage: dict = {"blocks": []}
        for b in range(depth):
            p = f"layers.{s}.blocks.{b}"
            stage["blocks"].append({
                "ln1": _ln(sd, f"{p}.norm1"),
                "qkv": _dense(sd, f"{p}.attn.qkv"),
                "proj": _dense(sd, f"{p}.attn.proj"),
                "rel_bias": interpolate_relative_pos_embed(
                    sd[f"{p}.attn.relative_position_bias_table"], dst_num_pos),
                "ln2": _ln(sd, f"{p}.norm2"),
                "fc1": _dense(sd, f"{p}.mlp.fc1"),
                "fc2": _dense(sd, f"{p}.mlp.fc2"),
            })
        if f"layers.{s}.downsample.reduction.weight" in sd:
            stage["downsample"] = {"reduction": _dense(sd, f"layers.{s}.downsample.reduction"),
                                   "norm": _ln(sd, f"layers.{s}.downsample.norm")}
        params["stages"].append(stage)
    return place(params, resolve_device(device))


def deit_params_from_state_dict(sd: StateDict, num_layers: int, *,
                                num_patches: Optional[int] = None, device=None) -> dict:
    """A DeiT (timm ViT) state dict -> the deit param tree on `device`: the
    12 -> 6 mapper when the checkpoint has 12 blocks and the target 6, the
    positional table resized when num_patches differs (the reference's
    bicubic, as for the CLIP tower), the fused qkv split into q / k / v (zero
    biases where it has none), head.* ignored."""
    n_ckpt = _layer_count(sd, r"blocks\.(\d+)\.")
    if n_ckpt == 12 and num_layers == 6:
        sd = subsample_layers(sd, "blocks", LAYER_MAPPER_12_TO_6)
    elif n_ckpt != num_layers:
        raise ValueError(f"checkpoint has {n_ckpt} deit layers, target {num_layers}")
    pos = sd["pos_embed"].reshape(sd["pos_embed"].shape[-2], -1)
    if num_patches is not None and pos.shape[0] != num_patches + 1:
        pos = interpolate_pos_embed(pos, num_patches)
    params: dict = {
        "patch_embed": {"kernel": sd["patch_embed.proj.weight"].permute(2, 3, 1, 0),
                        "bias": sd["patch_embed.proj.bias"]},
        "cls_token": sd["cls_token"].reshape(-1),
        "pos_embed": {"embedding": pos},
        "norm": _ln(sd, "norm"),
        "layers": [],
    }
    for i in range(num_layers):
        p = f"blocks.{i}"
        qkv_w = sd[f"{p}.attn.qkv.weight"]  # [3D, D]
        d = qkv_w.shape[1]
        qkv_b = sd.get(f"{p}.attn.qkv.bias")
        if qkv_b is None:
            qkv_b = torch.zeros(3 * d, dtype=qkv_w.dtype)
        attn = {name: {"kernel": qkv_w[j * d:(j + 1) * d].t(), "bias": qkv_b[j * d:(j + 1) * d]}
                for j, name in enumerate(("q", "k", "v"))}
        attn["out"] = _dense(sd, f"{p}.attn.proj")
        params["layers"].append({
            "ln1": _ln(sd, f"{p}.norm1"), "attn": attn, "ln2": _ln(sd, f"{p}.norm2"),
            "mlp": {"fc1": _dense(sd, f"{p}.mlp.fc1"), "fc2": _dense(sd, f"{p}.mlp.fc2")},
        })
    return place(params, resolve_device(device))


def alt_vision_params_from_file(path: str, config, vision_cfg, *, device=None) -> dict:
    """A Swin or DeiT torch checkpoint file -> the vision subtree of the
    tower config["use_swin"] / config["use_deit"] selects (the reference's
    build_vision_encoder(load_params=True))."""
    sd = load_torch_state_dict(path)
    if config.get("use_swin"):
        return swin_params_from_state_dict(sd, depths=vision_cfg["depths"],
                                           window_size=vision_cfg["window_size"], device=device)
    if config.get("use_deit"):
        return deit_params_from_state_dict(sd, vision_cfg["num_hidden_layers"],
                                           num_patches=vision_cfg.num_patches, device=device)
    raise ValueError("alt_vision_params_from_file: the config selects neither swin nor deit")


# ---------------------------------------------------------------------------
# the text tower
# ---------------------------------------------------------------------------


def strip_bert_prefix(sd: StateDict) -> StateDict:
    return {k[5:] if k.startswith("bert.") else k: v for k, v in sd.items()}


def _bert(sd: StateDict, num_layers: int, fusion_layer: int, with_mlm_head: bool,
          cross_from_self_init: bool) -> dict:
    sd = strip_bert_prefix(sd)
    n_ckpt = _layer_count(sd, r"encoder\.layer\.(\d+)\.")
    if n_ckpt == 12 and num_layers == 6:
        sd = subsample_layers(sd, "encoder.layer", LAYER_MAPPER_12_TO_6)
    elif n_ckpt != num_layers:
        raise ValueError(f"checkpoint has {n_ckpt} text layers, target {num_layers}")

    def attn(p: str) -> dict:
        return {"q": _dense(sd, f"{p}.self.query"), "k": _dense(sd, f"{p}.self.key"),
                "v": _dense(sd, f"{p}.self.value"), "out": _dense(sd, f"{p}.output.dense")}

    params: dict = {
        "embeddings": {"word": _emb(sd, "embeddings.word_embeddings.weight"),
                       "position": _emb(sd, "embeddings.position_embeddings.weight"),
                       "token_type": _emb(sd, "embeddings.token_type_embeddings.weight"),
                       "ln": _ln(sd, "embeddings.LayerNorm")},
        "layers": [],
    }
    for i in range(num_layers):
        p = f"encoder.layer.{i}"
        layer = {"attention": attn(f"{p}.attention"),
                 "attention_ln": _ln(sd, f"{p}.attention.output.LayerNorm"),
                 "intermediate": _dense(sd, f"{p}.intermediate.dense"),
                 "output": _dense(sd, f"{p}.output.dense"),
                 "output_ln": _ln(sd, f"{p}.output.LayerNorm")}
        if i >= fusion_layer:
            if f"{p}.crossattention.self.query.weight" in sd:
                layer["crossattention"] = attn(f"{p}.crossattention")
                layer["crossattention_ln"] = _ln(sd, f"{p}.crossattention.output.LayerNorm")
            elif cross_from_self_init:
                # copies of the self-attention (placement gives each leaf its
                # own storage, so the two are trained apart)
                layer["crossattention"] = attn(f"{p}.attention")
                layer["crossattention_ln"] = _ln(sd, f"{p}.attention.output.LayerNorm")
        params["layers"].append(layer)
    if with_mlm_head and "cls.predictions.transform.dense.weight" in sd:
        decoder = {"kernel": sd["cls.predictions.decoder.weight"].t()}
        bias_key = ("cls.predictions.decoder.bias" if "cls.predictions.decoder.bias" in sd
                    else "cls.predictions.bias")
        if bias_key in sd:
            decoder["bias"] = sd[bias_key]
        params["cls"] = {"transform": {"dense": _dense(sd, "cls.predictions.transform.dense"),
                                       "ln": _ln(sd, "cls.predictions.transform.LayerNorm")},
                         "decoder": decoder}
    return params


def bert_params_from_state_dict(sd: StateDict, num_layers: int, fusion_layer: int, *,
                                with_mlm_head: bool = True, cross_from_self_init: bool = False,
                                device=None) -> dict:
    """An HF / X-VLM BERT state dict -> the bert param tree on `device`: the
    12 -> 6 mapper when needed; cross_from_self_init fills the cross
    attention of a plain BERT (which has none) with copies of its
    self-attention; the MLM head's decoder bias from
    cls.predictions.decoder.bias or cls.predictions.bias."""
    return place(_bert(sd, num_layers, fusion_layer, with_mlm_head, cross_from_self_init),
                  resolve_device(device))


# ---------------------------------------------------------------------------
# whole X-VLM checkpoints
# ---------------------------------------------------------------------------


def split_by_prefix(sd: StateDict, prefix: str) -> StateDict:
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def xvlm_params_from_state_dict(sd: StateDict, *, vision_layers: int, text_layers: int,
                                fusion_layer: int, num_patches: Optional[int] = None,
                                with_bbox_head: bool = False, with_mlm_head: bool = True,
                                device=None) -> dict:
    """The reference's XVLMBase state dict -> the full param tree."""
    params = {
        "vision": _vit(split_by_prefix(sd, "vision_encoder."), vision_layers, num_patches),
        "text": _bert(split_by_prefix(sd, "text_encoder."), text_layers, fusion_layer,
                      with_mlm_head, False),
        "vision_proj": _dense(sd, "vision_proj"),
        "text_proj": _dense(sd, "text_proj"),
        "temp": sd["temp"].reshape(()),
        "itm_head": _mlp_head(sd, "itm_head"),
    }
    if with_bbox_head and "bbox_head.0.weight" in sd:
        params["bbox_head"] = _mlp_head(sd, "bbox_head")
    return place(params, resolve_device(device))


def _decoder_from_cross(text_sd: StateDict, fusion_layer: int, num_dec_layers: int) -> StateDict:
    """Text-encoder layer fusion_layer + i -> decoder layer i; the
    embeddings and heads as they are."""
    dec_sd = {}
    for k, v in text_sd.items():
        m = re.match(r"encoder\.layer\.(\d+)\.(.*)", k)
        if not m:
            dec_sd[k] = v
        elif fusion_layer <= int(m.group(1)) < fusion_layer + num_dec_layers:
            dec_sd[f"encoder.layer.{int(m.group(1)) - fusion_layer}.{m.group(2)}"] = v
    return dec_sd


def vqa_params_from_state_dict(sd: StateDict, *, vision_layers: int, text_layers: int,
                               fusion_layer: int, num_dec_layers: Optional[int] = None,
                               num_patches: Optional[int] = None,
                               use_stored_decoder: bool = False, device=None) -> dict:
    """An X-VLM checkpoint -> VQA params: the question encoder keeps the
    whole fusion stack, and the answer decoder is initialised from the cross
    layers (the reference's model_generation.py load_pretrained). With
    use_stored_decoder (--evaluate / --load_vqa_pretrain) a VQA-shaped
    checkpoint's own text_decoder.* keys are loaded as they are."""
    num_dec_layers = num_dec_layers or (text_layers - fusion_layer)
    text_sd = strip_bert_prefix(split_by_prefix(sd, "text_encoder."))
    if use_stored_decoder and any(k.startswith("text_decoder.") for k in sd):
        dec_sd = strip_bert_prefix(split_by_prefix(sd, "text_decoder."))
    else:
        dec_sd = _decoder_from_cross(text_sd, fusion_layer, num_dec_layers)
    params = {
        "vision": _vit(split_by_prefix(sd, "vision_encoder."), vision_layers, num_patches),
        "text": _bert(text_sd, text_layers, fusion_layer, False, False),
        "text_decoder": _bert(dec_sd, num_dec_layers, 0, True, False),
    }
    return place(params, resolve_device(device))


def captioning_params_from_state_dict(sd: StateDict, *, vision_layers: int, text_layers: int,
                                      fusion_layer: int, num_patches: Optional[int] = None,
                                      load_capt_pretrain: bool = False, device=None) -> dict:
    """An X-VLM checkpoint -> captioning params: the decoder carries the
    whole fusion text stack, copied from text_encoder.*. The stored
    text_decoder.* keys are used with load_capt_pretrain, or when the
    checkpoint has no text_encoder.* to copy from."""
    has_dec = any(k.startswith("text_decoder.") for k in sd)
    has_enc = any(k.startswith("text_encoder.") for k in sd)
    prefix = ("text_decoder." if has_dec and (load_capt_pretrain or not has_enc)
              else "text_encoder.")
    params = {
        "vision": _vit(split_by_prefix(sd, "vision_encoder."), vision_layers, num_patches),
        "text_decoder": _bert(split_by_prefix(sd, prefix), text_layers, fusion_layer, True,
                              False),
    }
    return place(params, resolve_device(device))


def crossgen_params_from_state_dict(sd: StateDict, fresh: dict, *,
                                    vision_layers: Optional[int] = None, text_layers: int,
                                    fusion_layer: int, num_dec_layers: Optional[int] = None,
                                    num_patches: Optional[int] = None, device=None) -> dict:
    """An X-VLM checkpoint -> XVLMForCrossGeneration / TextTranslater params
    on `device`: the source text encoder whole; decoder layer i from text
    layer fusion_layer + i; the decoder's word embeddings and cls head as
    the `fresh` tree (the model's init) has them, its target vocabulary
    being another; each decoder cross K/V whose kernel shape differs from
    the fresh one's (a decoder K/V width other than the text tower's cross
    width) stays fresh too. The vision tower loads when vision_layers is
    given and `fresh` has one."""
    num_dec_layers = num_dec_layers or (text_layers - fusion_layer)
    text_sd = strip_bert_prefix(split_by_prefix(sd, "text_encoder."))
    decoder = _bert(_decoder_from_cross(text_sd, fusion_layer, num_dec_layers), num_dec_layers,
                    0, False, False)
    fresh_dec = fresh["text_decoder"]
    decoder["embeddings"]["word"] = fresh_dec["embeddings"]["word"]
    decoder["cls"] = fresh_dec["cls"]
    for layer, fresh_layer in zip(decoder["layers"], fresh_dec["layers"]):
        for kv in ("k", "v"):
            want = fresh_layer["crossattention"][kv]
            if tuple(layer["crossattention"][kv]["kernel"].shape) != tuple(want["kernel"].shape):
                layer["crossattention"][kv] = want
    params = {"text": _bert(text_sd, text_layers, fusion_layer, False, False),
              "text_decoder": decoder}
    if vision_layers is not None and "vision" in fresh:
        params["vision"] = _vit(split_by_prefix(sd, "vision_encoder."), vision_layers,
                                num_patches)
    return place(params, resolve_device(device))


def nlvr_params_from_state_dict(sd: StateDict, *, vision_layers: int, text_layers: int,
                                fusion_layer: int, num_patches: Optional[int] = None,
                                load_nlvr_pretrain: bool = False, device=None) -> dict:
    """An X-VLM checkpoint -> NLVR params: every cross layer replicated into
    the pair of the two-image stack (models/model_nlvr
    .duplicate_cross_layers_for_nlvr), unless the checkpoint is an NLVR
    domain pretrain already; cls_head and ta_head when present."""
    text_sd = strip_bert_prefix(split_by_prefix(sd, "text_encoder."))
    if not load_nlvr_pretrain:
        text_sd = duplicate_cross_layers_for_nlvr(text_sd, fusion_layer)
    n_layers = fusion_layer + 2 * (text_layers - fusion_layer)
    params = {
        "vision": _vit(split_by_prefix(sd, "vision_encoder."), vision_layers, num_patches),
        "text": _bert(text_sd, n_layers, fusion_layer, False, False),
    }
    if "cls_head.0.weight" in sd:
        params["cls_head"] = _mlp_head(sd, "cls_head")
    if "ta_head.weight" in sd:
        params["ta_head"] = _dense(sd, "ta_head")
    return place(params, resolve_device(device))


# ---------------------------------------------------------------------------
# back to the reference's keys
# ---------------------------------------------------------------------------


def xvlm_state_dict_from_params(params: dict, fusion_layer: int) -> StateDict:
    """Inverse of xvlm_params_from_state_dict: the reference's keys, CPU
    tensors."""
    sd: StateDict = {}

    def cpu(t: torch.Tensor) -> torch.Tensor:
        return t.detach().cpu().contiguous()

    def put_dense(prefix, p):
        sd[f"{prefix}.weight"] = cpu(p["kernel"].t())
        if "bias" in p:
            sd[f"{prefix}.bias"] = cpu(p["bias"])

    def put_ln(prefix, p):
        sd[f"{prefix}.weight"] = cpu(p["scale"])
        sd[f"{prefix}.bias"] = cpu(p["bias"])

    v = params["vision"]
    sd["vision_encoder.patch_embed.weight"] = cpu(v["patch_embed"]["kernel"].permute(3, 2, 0, 1))
    sd["vision_encoder.class_embedding"] = cpu(v["class_embedding"])
    sd["vision_encoder.pos_embed.weight"] = cpu(v["pos_embed"]["embedding"])
    put_ln("vision_encoder.pre_layrnorm", v["pre_ln"])
    put_ln("vision_encoder.post_layernorm", v["post_ln"])
    for i, layer in enumerate(v["layers"]):
        p = f"vision_encoder.encoder.layers.{i}"
        put_ln(f"{p}.layer_norm1", layer["ln1"])
        put_ln(f"{p}.layer_norm2", layer["ln2"])
        for name, hf in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"), ("out", "out_proj")):
            put_dense(f"{p}.self_attn.{hf}", layer["attn"][name])
        put_dense(f"{p}.mlp.fc1", layer["mlp"]["fc1"])
        put_dense(f"{p}.mlp.fc2", layer["mlp"]["fc2"])

    t = params["text"]
    for name, key in (("word", "word_embeddings"), ("position", "position_embeddings"),
                      ("token_type", "token_type_embeddings")):
        sd[f"text_encoder.embeddings.{key}.weight"] = cpu(t["embeddings"][name]["embedding"])
    put_ln("text_encoder.embeddings.LayerNorm", t["embeddings"]["ln"])
    for i, layer in enumerate(t["layers"]):
        p = f"text_encoder.encoder.layer.{i}"
        for part in ("attention", "crossattention"):
            if part not in layer:
                continue
            for name, hf in (("q", "query"), ("k", "key"), ("v", "value")):
                put_dense(f"{p}.{part}.self.{hf}", layer[part][name])
            put_dense(f"{p}.{part}.output.dense", layer[part]["out"])
            put_ln(f"{p}.{part}.output.LayerNorm", layer[f"{part}_ln"])
        put_dense(f"{p}.intermediate.dense", layer["intermediate"])
        put_dense(f"{p}.output.dense", layer["output"])
        put_ln(f"{p}.output.LayerNorm", layer["output_ln"])
    if "cls" in t:
        put_dense("text_encoder.cls.predictions.transform.dense", t["cls"]["transform"]["dense"])
        put_ln("text_encoder.cls.predictions.transform.LayerNorm", t["cls"]["transform"]["ln"])
        put_dense("text_encoder.cls.predictions.decoder", t["cls"]["decoder"])

    put_dense("vision_proj", params["vision_proj"])
    put_dense("text_proj", params["text_proj"])
    sd["temp"] = cpu(params["temp"])
    for head in ("itm_head", "bbox_head"):
        if head in params:
            put_dense(f"{head}.0", params[head]["fc1"])
            put_ln(f"{head}.1", params[head]["ln"])
            put_dense(f"{head}.3", params[head]["fc2"])
    return sd


# ---------------------------------------------------------------------------
# native files
# ---------------------------------------------------------------------------


def to_cpu(tree):
    """Tensors copied onto the CPU (a copy of a CPU tensor too: the optimizers
    update the originals in place), dataclasses (TrainState) as their field
    dicts, tuples as lists."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return {f.name: to_cpu(getattr(tree, f.name)) for f in dataclasses.fields(tree)}
    if isinstance(tree, dict):
        return {k: to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_cpu(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    return tree


def save_pytree(path: str, tree) -> None:
    """torch.save of the tree's CPU copy to a local, hdfs:// or gs:// path."""
    payload = to_cpu(tree)
    if "://" not in path:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        torch.save(payload, path)
        return
    buf = io.BytesIO()
    torch.save(payload, buf)
    with hopen(path, "wb") as f:
        f.write(buf.getvalue())


_ZIP_MAGIC = b"PK\x03\x04"
_CHUNKED = "__msgpack_chunked_array__"


def _looks_msgpack(head: bytes) -> bool:
    """A msgpack map (fixmap of 1-15 entries, map16, map32): what flax
    writes. torch.save writes a zip (and its legacy format a pickle)."""
    return bool(head) and not head.startswith(_ZIP_MAGIC) and (
        0x81 <= head[0] <= 0x8F or head[0] in (0xDE, 0xDF))


def is_msgpack(path: str) -> bool:
    """Whether the file at `path` is a JAX (flax msgpack) checkpoint."""
    with (open(path, "rb") if "://" not in path else hopen(path, "rb")) as f:
        return _looks_msgpack(f.read(4))


def _flax_array(data: bytes):
    """flax's ndarray extension: msgpack of (shape, dtype name, C bytes), as
    a CPU tensor (bfloat16 read as uint16 and viewed)."""
    import msgpack

    shape, name, buf = msgpack.unpackb(data, raw=True)
    name = name.decode() if isinstance(name, bytes) else name
    if name == "bfloat16":
        arr = np.frombuffer(buf, dtype=np.uint16).reshape(shape)
        return torch.from_numpy(arr.copy()).view(torch.bfloat16)
    arr = np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape)
    return torch.from_numpy(arr.copy())


def _flax_ext(code: int, data: bytes):
    import msgpack

    if code == 1:  # ndarray
        return _flax_array(data)
    if code == 2:  # native complex
        re, im = msgpack.unpackb(data)
        return complex(re, im)
    if code == 3:  # numpy scalar, packed as a 0-d ndarray
        return _flax_array(data).item()
    return msgpack.ExtType(code, data)


def _unchunk(node):
    if isinstance(node, dict):
        if _CHUNKED in node:
            shape = tuple(int(node["shape"][k]) for k in sorted(node["shape"], key=int))
            chunks = [node["chunks"][k] for k in sorted(node["chunks"], key=int)]
            return torch.cat([c.reshape(-1) for c in chunks]).reshape(shape)
        return {k: _unchunk(v) for k, v in node.items()}
    return node


def decode_flax_msgpack(data: bytes):
    """A flax msgpack payload (serialization.msgpack_serialize) as the tree
    flax's msgpack_restore gives, with tensors for its arrays: dicts keyed
    by strings ("0".."n-1" for a list's entries), numbers, strings."""
    import msgpack

    return _unchunk(msgpack.unpackb(data, ext_hook=_flax_ext, raw=False,
                                    strict_map_key=False))


def load_pytree(path: str):
    """The payload of a native file, tensors on the CPU (weights_only); a
    JAX file (flax msgpack) decoded as decode_flax_msgpack."""
    if "://" not in path:
        if is_msgpack(path):
            with open(path, "rb") as f:
                return decode_flax_msgpack(f.read())
        return torch.load(path, map_location="cpu", weights_only=True)
    with hopen(path, "rb") as f:
        data = f.read()
    if _looks_msgpack(data[:4]):
        return decode_flax_msgpack(data)
    return torch.load(io.BytesIO(data), map_location="cpu", weights_only=True)


def _relist(node):
    """Dicts keyed "0".."n-1" as lists (JAX's msgpack files stringify list
    indices; torch.save keeps lists, so the port's own files pass as they
    are)."""
    if not isinstance(node, dict):
        return node
    node = {k: _relist(v) for k, v in node.items()}
    if node and all(isinstance(k, str) and k.isdigit() for k in node):
        idx = sorted(node, key=int)
        if [int(k) for k in idx] == list(range(len(idx))):
            return [node[k] for k in idx]
    return node


_LOAD_MEMO = {"key": None, "tree": None}


def clear_load_memo() -> None:
    """Release the one-entry load_params memo (the drivers clear it once the
    model is built, native_eval_gates after its gate read)."""
    _LOAD_MEMO["key"] = _LOAD_MEMO["tree"] = None


def load_params(path: str):
    """A native file's tree (CPU tensors), memoised by (path, mtime, size):
    an evaluation reads one file for its params and again for its gates, and
    the second read returns the same tree."""
    st = os.stat(path)
    key = (os.path.abspath(path), st.st_mtime_ns, st.st_size)
    if _LOAD_MEMO["key"] == key:
        return _LOAD_MEMO["tree"]
    tree = _relist(load_pytree(path))
    _LOAD_MEMO["key"], _LOAD_MEMO["tree"] = key, tree
    return tree


def extract_model_and_gates(tree):
    """(model params, L0 params or None) of any native payload:

    - a params-only export -> (tree, None);
    - a snapshot {"model", "l0"?, "epoch"} -> (model, l0);
    - a full state {"state", "extra"}: a TrainState's field dict ->
      (params, {"loga", λs}), a (params, opt_state, step) list -> (params,
      None).

    The gates are None exactly when the tree holds no log-alphas (a physical
    export or a gate-free pretrain state): evaluate dense."""
    if isinstance(tree, dict) and "state" in tree:
        st = tree["state"]
        if isinstance(st, dict) and "params" in st:
            l0 = {"loga": st["loga"], **st.get("lam", {})} if "loga" in st else None
            return st["params"], l0
        if isinstance(st, (list, tuple)):
            return st[0], None
        return st, None
    if isinstance(tree, dict) and "model" in tree:
        l0 = tree.get("l0")
        if not (isinstance(l0, dict) and "loga" in l0):
            l0 = None
        return tree["model"], l0
    return tree, None


def restore_pytree_like(template, saved):
    """`saved` (a load_pytree payload) rebuilt in `template`'s structure:
    dataclasses from their field dicts, every tensor on its template leaf's
    device and dtype (shapes checked), numbers as the template's type."""
    if dataclasses.is_dataclass(template) and not isinstance(template, type):
        return type(template)(**{f.name: restore_pytree_like(getattr(template, f.name),
                                                             saved[f.name])
                                 for f in dataclasses.fields(template)})
    if isinstance(template, dict):
        if set(template) != set(saved):
            raise ValueError(f"saved keys {sorted(saved)} != {sorted(template)}")
        return {k: restore_pytree_like(v, saved[k]) for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        if len(template) != len(saved):
            raise ValueError(f"saved list of {len(saved)} != {len(template)}")
        return type(template)(restore_pytree_like(t, s) for t, s in zip(template, saved))
    if isinstance(template, torch.Tensor):
        if tuple(saved.shape) != tuple(template.shape):
            raise ValueError(f"saved shape {tuple(saved.shape)} != {tuple(template.shape)}")
        return saved.to(device=template.device, dtype=template.dtype, copy=True)
    if template is None or isinstance(template, str):
        return saved
    return type(template)(saved)


class Checkpointer:
    """The reference's utils/checkpointer.py: model_state_step_{N} /
    model_state_epoch_{N} snapshots and the rolling training_state_latest,
    on a local, hdfs:// or gs:// directory. keep_last N (beyond the
    reference) deletes all but the newest N numbered snapshots of a tag after
    each numbered save; string tags ("best", "final") never rotate."""

    def __init__(self, serialization_dir: str, *, keep_last: Optional[int] = None):
        self.serialization_dir = serialization_dir
        self.keep_last = keep_last
        hmkdir(serialization_dir)

    def save_checkpoint(self, step, train_state, *, training_states=None,
                        step_mode: bool = True) -> str:
        tag = "step" if step_mode else "epoch"
        path = os.path.join(self.serialization_dir, f"model_state_{tag}_{step}.ckpt")
        save_pytree(path, train_state)
        if training_states is not None:
            save_pytree(os.path.join(self.serialization_dir, "training_state_latest.ckpt"),
                        training_states)
        if self.keep_last and isinstance(step, int):
            self._rotate(tag)
        return path

    def _rotate(self, tag: str) -> None:
        pat = re.compile(rf"model_state_{tag}_(\d+)\.ckpt$")
        numbered = sorted((int(m.group(1)), f) for f in hlist_files([self.serialization_dir])
                          for m in [pat.search(f)] if m)
        for _, f in numbered[:-self.keep_last]:
            hremove(f)

    def load_latest(self):
        latest = os.path.join(self.serialization_dir, "training_state_latest.ckpt")
        return load_pytree(latest) if hexists(latest) else None
