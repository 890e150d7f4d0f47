"""Fusion BERT in the text and fusion modes, functional and gated (port of
efficientvlm_tpu/models/bert.py).

- layers [0, fusion_layer) are text-only self-attention; layers
  [fusion_layer, N) add image-grounded cross-attention whose K/V width is
  `encoder_width`;
- modes: 'text' = [0, fusion), 'fusion' = [fusion, N) over precomputed text
  embeds, 'multi_modal' = all;
- gates: head_z per layer, cross layers take a (self_z, cross_z) pair
  ([Lc, 2, H]); mlp_z masks FFN intermediate activations after the
  activation.

impl="fused" runs every attention sublayer through the port's fused
kernels: self-attention (the 40-token text tower included), cross-attention,
and grouped cross-attention when `encoder_groups` > 1, whose epilogue also
applies the layer's residual + post-LN. A matrix attention bias has no
kernel yet and raises under impl="fused"; impl="plain" runs the plain
PyTorch path. The decoder mode, its KV cache and the MLM / LM losses come
with later slices.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..config import TextConfig
from ..ops.attention import init_attention, make_attention_bias, multi_head_attention
from ..ops.basic import (
    ACT2FN, dense, embedding_lookup, init_dense, init_embedding, init_layer_norm, layer_norm,
)
from ..ops.fused_mha import (
    fused_cross_attention, fused_cross_attention_grouped, fused_self_attention,
)


def init_bert_layer(generator, cfg: TextConfig, layer_idx: int, device=None) -> dict:
    d = cfg["hidden_size"]
    layer = {
        "attention": init_attention(generator, d, cfg["num_attention_heads"], device=device),
        "attention_ln": init_layer_norm(d, device),
        "intermediate": init_dense(generator, d, cfg["intermediate_size"], device=device),
        "output": init_dense(generator, cfg["intermediate_size"], d, device=device),
        "output_ln": init_layer_norm(d, device),
    }
    if layer_idx >= cfg["fusion_layer"]:
        layer["crossattention"] = init_attention(
            generator, d, cfg["num_attention_heads"], kv_width=cfg["encoder_width"],
            device=device)
        layer["crossattention_ln"] = init_layer_norm(d, device)
    return layer


def init_mlm_head(generator, cfg: TextConfig, device=None) -> dict:
    d = cfg["hidden_size"]
    return {
        "transform": {"dense": init_dense(generator, d, d, device=device),
                      "ln": init_layer_norm(d, device)},
        "decoder": init_dense(generator, d, cfg["vocab_size"], device=device),
    }


def init_bert(generator, cfg: TextConfig, *, with_mlm_head: bool = False, device=None) -> dict:
    d = cfg["hidden_size"]
    params = {
        "embeddings": {
            "word": init_embedding(generator, cfg["vocab_size"], d, device=device),
            "position": init_embedding(generator, cfg["max_position_embeddings"], d,
                                       device=device),
            "token_type": init_embedding(generator, cfg["type_vocab_size"], d, device=device),
            "ln": init_layer_norm(d, device),
        },
        "layers": [init_bert_layer(generator, cfg, i, device)
                   for i in range(cfg["num_hidden_layers"])],
    }
    if with_mlm_head:
        params["cls"] = init_mlm_head(generator, cfg, device)
    return params


def bert_embeddings(params: dict, input_ids: torch.Tensor, cfg: TextConfig, *,
                    dtype=None) -> torch.Tensor:
    t = input_ids.shape[1]
    pos_ids = torch.arange(t, device=input_ids.device)[None]
    h = embedding_lookup(params["word"], input_ids, dtype=dtype)
    h = h + embedding_lookup(params["position"], pos_ids, dtype=dtype)
    h = h + embedding_lookup(params["token_type"], torch.zeros_like(input_ids), dtype=dtype)
    return layer_norm(params["ln"], h, eps=cfg.get("layer_norm_eps", 1e-12))


def _num_heads(attn_params: dict, head_dim: int) -> int:
    return attn_params["q"]["kernel"].shape[1] // head_dim


def _key_vector(bias: Optional[torch.Tensor], what: str) -> Optional[torch.Tensor]:
    """[B,1,1,S] additive bias -> [B,S]; the fused kernels take nothing else."""
    if bias is None:
        return None
    if bias.ndim != 4 or bias.shape[1] != 1 or bias.shape[2] != 1:
        raise NotImplementedError(
            f"{what}: a matrix attention bias {tuple(bias.shape)} has no fused kernel "
            f"yet; use impl='plain'")
    return bias[:, 0, 0, :]


def bert_layer_apply(lp: dict, h: torch.Tensor, cfg: TextConfig, *,
                     bias: Optional[torch.Tensor] = None,
                     encoder_hidden: Optional[torch.Tensor] = None,
                     encoder_bias: Optional[torch.Tensor] = None,
                     self_head_z=None, cross_head_z=None, mlp_z=None,
                     encoder_groups: int = 1, dtype=None, impl: str = "fused"):
    """Post-LN BERT layer. `encoder_groups` > 1 declares that encoder_hidden
    rows are shared by groups of contiguous query rows (grouped K/V); a
    batch mismatch without it is a loud error."""
    eps = cfg.get("layer_norm_eps", 1e-12)
    head_dim = cfg["hidden_size"] // cfg["num_attention_heads"]
    act = ACT2FN[cfg.get("hidden_act", "gelu")]
    fused = impl == "fused"

    if lp.get("attention") is not None:  # fully-pruned self-attn -> identity
        nh = _num_heads(lp["attention"], head_dim)
        if fused:
            attn_out = fused_self_attention(
                lp["attention"], h.to(dtype) if dtype is not None else h, num_heads=nh,
                key_bias=_key_vector(bias, "self-attention"), head_z=self_head_z)
        else:
            attn_out, _ = multi_head_attention(
                lp["attention"], h, num_heads=nh, bias=bias, head_z=self_head_z, dtype=dtype)
        h = layer_norm(lp["attention_ln"], h + attn_out, eps=eps)

    if lp.get("crossattention") is not None and encoder_hidden is not None:
        nh = _num_heads(lp["crossattention"], head_dim)
        hq = h.to(dtype) if dtype is not None else h
        if fused and encoder_groups > 1:
            kb = _key_vector(encoder_bias, "grouped cross-attention")
            # the kernel's epilogue applies this layer's residual + post-LN
            h = fused_cross_attention_grouped(
                lp["crossattention"], hq, encoder_hidden, num_heads=nh,
                kv_groups=encoder_groups,
                key_bias=None if kb is None else kb.expand(
                    encoder_hidden.shape[0], encoder_hidden.shape[1]),
                head_z=cross_head_z, ln_params=lp["crossattention_ln"], ln_eps=eps)
        else:
            if fused:
                x_out = fused_cross_attention(
                    lp["crossattention"], hq, encoder_hidden, num_heads=nh,
                    key_bias=_key_vector(encoder_bias, "cross-attention"),
                    head_z=cross_head_z)
            else:
                x_out, _ = multi_head_attention(
                    lp["crossattention"], h, encoder_hidden, num_heads=nh,
                    bias=encoder_bias, head_z=cross_head_z, dtype=dtype,
                    kv_groups=encoder_groups)
            h = layer_norm(lp["crossattention_ln"], h + x_out, eps=eps)

    if lp.get("intermediate") is not None:  # fully-pruned FFN -> identity
        inter = act(dense(lp["intermediate"], h, dtype=dtype))
        if mlp_z is not None:
            inter = inter * mlp_z.to(inter.dtype)
        out = dense(lp["output"], inter, dtype=dtype)
        h = layer_norm(lp["output_ln"], h + out, eps=eps)
    return h


def bert_encoder_apply(params: dict, h: torch.Tensor, cfg: TextConfig, *,
                       bias=None, mode: str = "multi_modal", encoder_hidden=None,
                       encoder_bias=None, text_head_z=None, cross_head_z=None,
                       text_mlp_z=None, cross_mlp_z=None, encoder_groups: int = 1,
                       dtype=None, impl: str = "fused") -> dict:
    """Run the layers of `mode`; returns {"last_hidden": h}."""
    fusion = cfg["fusion_layer"]
    n = cfg["num_hidden_layers"]
    lo, hi = {"text": (0, fusion), "fusion": (fusion, n), "multi_modal": (0, n)}.get(
        mode, (None, None))
    if lo is None:
        raise ValueError(f"mode {mode} is not supported")
    for i in range(lo, hi):
        is_cross = i >= fusion
        if is_cross:
            z = None if cross_head_z is None else cross_head_z[i - fusion]
            self_z, cross_z = (None, None) if z is None else (z[0], z[1])
            mlp_zi = None if cross_mlp_z is None else cross_mlp_z[i - fusion]
        else:
            self_z = None if text_head_z is None else text_head_z[i]
            cross_z = None
            mlp_zi = None if text_mlp_z is None else text_mlp_z[i]
        h = bert_layer_apply(
            params["layers"][i], h, cfg, bias=bias,
            encoder_hidden=encoder_hidden if is_cross else None,
            encoder_bias=encoder_bias if is_cross else None,
            self_head_z=self_z, cross_head_z=cross_z, mlp_z=mlp_zi,
            encoder_groups=encoder_groups if is_cross else 1, dtype=dtype, impl=impl)
    return {"last_hidden": h}


def bert_apply(params: dict, input_ids: Optional[torch.Tensor], cfg: TextConfig, *,
               attention_mask=None, inputs_embeds=None, encoder_hidden=None,
               encoder_attention_mask=None, mode: str = "multi_modal",
               encoder_groups: int = 1, text_head_z=None, cross_head_z=None,
               text_mlp_z=None, cross_mlp_z=None, dtype=None, impl: str = "fused") -> dict:
    """BertModel.forward (encoder modes). In 'fusion' mode pass
    inputs_embeds (the text tower's output)."""
    if inputs_embeds is None:
        h = bert_embeddings(params["embeddings"], input_ids, cfg, dtype=dtype)
    else:
        h = inputs_embeds
    bias = make_attention_bias(attention_mask) if attention_mask is not None else None
    encoder_bias = None
    if encoder_hidden is not None and encoder_attention_mask is not None:
        encoder_bias = make_attention_bias(encoder_attention_mask)
    return bert_encoder_apply(
        params, h, cfg, bias=bias, mode=mode, encoder_hidden=encoder_hidden,
        encoder_bias=encoder_bias, text_head_z=text_head_z, cross_head_z=cross_head_z,
        text_mlp_z=text_mlp_z, cross_mlp_z=cross_mlp_z, encoder_groups=encoder_groups,
        dtype=dtype, impl=impl)
