"""Fusion BERT in the text, fusion and decoder modes, functional and gated
(port of efficientvlm_tpu/models/bert.py).

- layers [0, fusion_layer) are text-only self-attention; layers
  [fusion_layer, N) add image-grounded cross-attention whose K/V width is
  `encoder_width`;
- modes: 'text' = [0, fusion), 'fusion' = [fusion, N) over precomputed text
  embeds, 'multi_modal' = all; `is_decoder` adds the causal (or, with a
  cache, the decode) bias to the padding mask;
- gates: head_z per layer, cross layers take a (self_z, cross_z) pair
  ([Lc, 2, H]); mlp_z masks FFN intermediate activations after the
  activation;
- decoding: a fixed-size per-layer self-attention cache (init_bert_cache,
  written in place) and cross K/V projected once (precompute_cross_kv);
- heads: the MLM / LM head (over the masked positions,
  gather_seq_out_by_pos) and the shift-by-one LM loss, with optional label
  smoothing (LabelSmoothSoftmaxCEV1).

impl="fused" dispatch, per attention sublayer:
- self-attention with a key-vector bias, outside the decoder: the fused
  self-attention kernel (the 40-token text tower included);
- decoder self-attention (causal or decode bias, with or without a cache)
  and any matrix bias: multi_head_attention -> flash_attention;
- cross-attention over precomputed cross K/V: flash_attention_grouped when
  `encoder_groups` > 1, flash_attention otherwise;
- other cross-attention: the fused cross kernel, or the grouped one when
  `encoder_groups` > 1, whose epilogue also applies the layer's residual +
  post-LN; a matrix encoder bias has no kernel there and raises.
impl="plain" runs the plain PyTorch path.

Training (train=True with a torch.Generator): dropout after the embeddings,
on the attention probabilities and after each attention and FFN output, as
in JAX; the PAD embedding row gets no gradient (nn.Embedding's padding_idx).
A sublayer takes its fused kernel in training only through the kernel's
differentiable form and only when the layer's dropout rates are 0, as JAX
dispatches; otherwise it runs multi_head_attention, whose plain core serves
any forward that autograd records. output_attentions / output_hidden_states
collect the KD taps: each layer's input and the last output, and the
pre-dropout probabilities (the fused kernels' probs forms where they run).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..config import TextConfig
from ..ops.attention import (
    causal_bias, decode_bias, init_attention, init_decode_cache, make_attention_bias,
    multi_head_attention, project_kv,
)
from ..ops.basic import (
    ACT2FN, dense, dropout, embedding_lookup, init_dense, init_embedding, init_layer_norm,
    layer_norm,
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
                    position_offset: int = 0, train: bool = False, generator=None,
                    dtype=None) -> torch.Tensor:
    t = input_ids.shape[1]
    pos_ids = torch.arange(t, device=input_ids.device)[None] + position_offset
    h = embedding_lookup(params["word"], input_ids, dtype=dtype)
    # nn.Embedding(padding_idx=pad) gives the PAD row no gradient; the KD
    # hidden taps see padded positions, so without this the row would drift
    pad = cfg.get("pad_token_id", 0)
    if pad is not None:
        h = torch.where((input_ids == pad)[..., None], h.detach(), h)
    h = h + embedding_lookup(params["position"], pos_ids, dtype=dtype)
    h = h + embedding_lookup(params["token_type"], torch.zeros_like(input_ids), dtype=dtype)
    h = layer_norm(params["ln"], h, eps=cfg.get("layer_norm_eps", 1e-12))
    return dropout(h, cfg.get("hidden_dropout_prob", 0.0), generator=generator, train=train)


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


def _is_key_vector(bias: Optional[torch.Tensor]) -> bool:
    return bias is None or (bias.ndim == 4 and bias.shape[1] == 1 and bias.shape[2] == 1)


def bert_layer_apply(lp: dict, h: torch.Tensor, cfg: TextConfig, *,
                     bias: Optional[torch.Tensor] = None,
                     encoder_hidden: Optional[torch.Tensor] = None,
                     encoder_bias: Optional[torch.Tensor] = None,
                     self_head_z=None, cross_head_z=None, mlp_z=None,
                     cache: Optional[dict] = None, cross_kv: Optional[dict] = None,
                     encoder_groups: int = 1, is_decoder: bool = False,
                     output_probs: bool = False, train: bool = False, generator=None,
                     dtype=None, impl: str = "fused"):
    """Post-LN BERT layer; returns (h, self_probs, cross_probs, new_cache).
    `cross_kv` supplies pre-projected cross K/V (precompute_cross_kv).
    `encoder_groups` > 1 declares that encoder_hidden / cross_kv rows are
    shared by groups of contiguous query rows (grouped K/V); a batch mismatch
    without it is a loud error."""
    eps = cfg.get("layer_norm_eps", 1e-12)
    head_dim = cfg["hidden_size"] // cfg["num_attention_heads"]
    act = ACT2FN[cfg.get("hidden_act", "gelu")]
    hdrop = cfg.get("hidden_dropout_prob", 0.0)
    adrop = cfg.get("attention_probs_dropout_prob", 0.0)
    # in training a sublayer fuses only through the kernel's differentiable
    # form, which computes no dropout
    fused = impl == "fused" and (not train or (adrop == 0.0 and hdrop == 0.0))
    drop = dict(generator=generator, train=train)

    self_probs = cross_probs = None
    self_cache = cache.get("self") if cache is not None else None
    if lp.get("attention") is not None:  # fully-pruned self-attn -> identity
        nh = _num_heads(lp["attention"], head_dim)
        if fused and self_cache is None and not is_decoder and _is_key_vector(bias):
            res = fused_self_attention(
                lp["attention"], h.to(dtype) if dtype is not None else h, num_heads=nh,
                key_bias=None if bias is None else bias[:, 0, 0, :], head_z=self_head_z,
                return_probs=output_probs, differentiable=train)
            attn_out, self_probs = res if output_probs else (res, None)
        else:
            attn_out, self_probs, self_cache = multi_head_attention(
                lp["attention"], h, num_heads=nh, bias=bias, head_z=self_head_z,
                output_probs=output_probs, dropout_rate=adrop, dtype=dtype, cache=self_cache,
                impl=impl, **drop)
            attn_out = dropout(attn_out, hdrop, **drop)
        h = layer_norm(lp["attention_ln"], h + attn_out, eps=eps)

    if lp.get("crossattention") is not None and (
            encoder_hidden is not None or cross_kv is not None):
        nh = _num_heads(lp["crossattention"], head_dim)
        hq = h.to(dtype) if dtype is not None else h
        if fused and cross_kv is None and encoder_groups > 1 and not train and not output_probs:
            kb = _key_vector(encoder_bias, "grouped cross-attention")
            # the kernel's epilogue applies this layer's residual + post-LN
            h = fused_cross_attention_grouped(
                lp["crossattention"], hq, encoder_hidden, num_heads=nh,
                kv_groups=encoder_groups,
                key_bias=None if kb is None else kb.expand(
                    encoder_hidden.shape[0], encoder_hidden.shape[1]),
                head_z=cross_head_z, ln_params=lp["crossattention_ln"], ln_eps=eps)
        else:
            if fused and cross_kv is None and encoder_groups == 1:
                res = fused_cross_attention(
                    lp["crossattention"], hq, encoder_hidden, num_heads=nh,
                    key_bias=_key_vector(encoder_bias, "cross-attention"),
                    head_z=cross_head_z, return_probs=output_probs, differentiable=train)
                x_out, cross_probs = res if output_probs else (res, None)
            else:
                x_out, cross_probs, _ = multi_head_attention(
                    lp["crossattention"], h, None if cross_kv is not None else encoder_hidden,
                    num_heads=nh, bias=encoder_bias, head_z=cross_head_z,
                    output_probs=output_probs, dropout_rate=adrop, dtype=dtype,
                    precomputed_kv=cross_kv, kv_groups=encoder_groups, impl=impl, **drop)
                x_out = dropout(x_out, hdrop, **drop)
            h = layer_norm(lp["crossattention_ln"], h + x_out, eps=eps)

    if lp.get("intermediate") is not None:  # fully-pruned FFN -> identity
        inter = act(dense(lp["intermediate"], h, dtype=dtype))
        if mlp_z is not None:
            inter = inter * mlp_z.to(inter.dtype)
        out = dropout(dense(lp["output"], inter, dtype=dtype), hdrop, **drop)
        h = layer_norm(lp["output_ln"], h + out, eps=eps)
    new_cache = None if cache is None else {**cache, "self": self_cache}
    return h, self_probs, cross_probs, new_cache


def bert_encoder_apply(params: dict, h: torch.Tensor, cfg: TextConfig, *,
                       bias=None, mode: str = "multi_modal", encoder_hidden=None,
                       encoder_bias=None, text_head_z=None, cross_head_z=None,
                       text_mlp_z=None, cross_mlp_z=None, cache: Optional[list] = None,
                       cross_kv: Optional[list] = None, encoder_groups: int = 1,
                       is_decoder: bool = False, output_attentions: bool = False,
                       output_hidden_states: bool = False, train: bool = False,
                       generator=None, dtype=None, impl: str = "fused") -> dict:
    """Run the layers of `mode`; returns {"last_hidden": h, "hidden_states",
    "attentions", "cross_attentions" (lists, or None when not asked for),
    "cache": new cache list or None}. `cache` has one entry per layer run,
    `cross_kv` one per cross layer (precompute_cross_kv)."""
    fusion = cfg["fusion_layer"]
    n = cfg["num_hidden_layers"]
    lo, hi = {"text": (0, fusion), "fusion": (fusion, n), "multi_modal": (0, n)}.get(
        mode, (None, None))
    if lo is None:
        raise ValueError(f"mode {mode} is not supported")
    new_cache = list(cache) if cache is not None else None
    all_hidden = [] if output_hidden_states else None
    all_probs = [] if output_attentions else None
    all_cross = [] if output_attentions else None
    for i in range(lo, hi):
        if output_hidden_states:
            all_hidden.append(h)
        is_cross = i >= fusion
        if is_cross:
            z = None if cross_head_z is None else cross_head_z[i - fusion]
            self_z, cross_z = (None, None) if z is None else (z[0], z[1])
            mlp_zi = None if cross_mlp_z is None else cross_mlp_z[i - fusion]
        else:
            self_z = None if text_head_z is None else text_head_z[i]
            cross_z = None
            mlp_zi = None if text_mlp_z is None else text_mlp_z[i]
        h, sp, cp, layer_cache = bert_layer_apply(
            params["layers"][i], h, cfg, bias=bias,
            encoder_hidden=encoder_hidden if is_cross else None,
            encoder_bias=encoder_bias if is_cross else None,
            self_head_z=self_z, cross_head_z=cross_z, mlp_z=mlp_zi,
            cache=None if cache is None else cache[i - lo],
            cross_kv=cross_kv[i - fusion] if (is_cross and cross_kv is not None) else None,
            encoder_groups=encoder_groups if is_cross else 1, is_decoder=is_decoder,
            output_probs=output_attentions, train=train, generator=generator, dtype=dtype,
            impl=impl)
        if output_attentions:
            all_probs.append(sp)
            if cp is not None:
                all_cross.append(cp)
        if new_cache is not None:
            new_cache[i - lo] = layer_cache
    if output_hidden_states:
        all_hidden.append(h)
    return {"last_hidden": h, "hidden_states": all_hidden, "attentions": all_probs,
            "cross_attentions": all_cross, "cache": new_cache}


def bert_apply(params: dict, input_ids: Optional[torch.Tensor], cfg: TextConfig, *,
               attention_mask=None, inputs_embeds=None, encoder_hidden=None,
               encoder_attention_mask=None, mode: str = "multi_modal",
               is_decoder: bool = False, cache: Optional[list] = None,
               cross_kv: Optional[list] = None, encoder_groups: int = 1,
               position_offset: int = 0, text_head_z=None, cross_head_z=None,
               text_mlp_z=None, cross_mlp_z=None, output_attentions: bool = False,
               output_hidden_states: bool = False, train: bool = False, generator=None,
               dtype=None, impl: str = "fused") -> dict:
    """BertModel.forward. In 'fusion' mode pass inputs_embeds (the text
    tower's output). For cached decode pass `cache` (init_bert_cache) and
    position_offset = the number of tokens already decoded."""
    if inputs_embeds is None:
        h = bert_embeddings(params["embeddings"], input_ids, cfg,
                            position_offset=position_offset, train=train, generator=generator,
                            dtype=dtype)
    else:
        h = inputs_embeds
    t = h.shape[1]
    if is_decoder:
        if cache is not None:
            self_cache = cache[0]["self"]
            bias = decode_bias(self_cache["k"].shape[2], self_cache["index"], q_len=t,
                               device=h.device)
        else:
            bias = causal_bias(t, t, device=h.device)
        if attention_mask is not None:
            bias = bias + make_attention_bias(attention_mask)[:, :, :, : bias.shape[-1]]
    else:
        bias = make_attention_bias(attention_mask) if attention_mask is not None else None
    encoder_bias = None
    if encoder_hidden is not None and encoder_attention_mask is not None:
        encoder_bias = make_attention_bias(encoder_attention_mask)
    return bert_encoder_apply(
        params, h, cfg, bias=bias, mode=mode, encoder_hidden=encoder_hidden,
        encoder_bias=encoder_bias, text_head_z=text_head_z, cross_head_z=cross_head_z,
        text_mlp_z=text_mlp_z, cross_mlp_z=cross_mlp_z, cache=cache, cross_kv=cross_kv,
        encoder_groups=encoder_groups, is_decoder=is_decoder,
        output_attentions=output_attentions, output_hidden_states=output_hidden_states,
        train=train, generator=generator, dtype=dtype, impl=impl)


def precompute_cross_kv(params: dict, cfg: TextConfig, encoder_hidden: torch.Tensor, *,
                        dtype=None) -> list:
    """The cross-attention K/V of every cross layer, projected once (list
    indexed by cross layer i - fusion; None for fully-pruned modules): the
    encoder states are constant across decode steps."""
    fusion = cfg["fusion_layer"]
    head_dim = cfg["hidden_size"] // cfg["num_attention_heads"]
    out = []
    for i in range(fusion, cfg["num_hidden_layers"]):
        lp = params["layers"][i]
        if lp.get("crossattention") is None:
            out.append(None)
            continue
        out.append(project_kv(lp["crossattention"], encoder_hidden,
                              num_heads=_num_heads(lp["crossattention"], head_dim), dtype=dtype))
    return out


def init_bert_cache(params: dict, cfg: TextConfig, batch: int, max_len: int,
                    dtype=torch.float32) -> list:
    """Fixed-size decode cache for the multi_modal decoder, one entry per
    layer, on the params' device."""
    head_dim = cfg["hidden_size"] // cfg["num_attention_heads"]
    device = params["embeddings"]["word"]["embedding"].device
    return [{"self": init_decode_cache(batch, _num_heads(lp["attention"], head_dim),
                                       max_len, head_dim, dtype, device)}
            for lp in params["layers"]]


def mlm_head_apply(params: dict, h: torch.Tensor, cfg: TextConfig, *,
                   dtype=None) -> torch.Tensor:
    x = dense(params["transform"]["dense"], h, dtype=dtype)
    x = ACT2FN[cfg.get("hidden_act", "gelu")](x)
    x = layer_norm(params["transform"]["ln"], x, eps=cfg.get("layer_norm_eps", 1e-12))
    return dense(params["decoder"], x, dtype=dtype)


def gather_seq_out_by_pos(seq: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """[B, T, D], [B, M] positions -> [B, M, D] (the MLM head reads the
    masked positions only)."""
    return seq.gather(1, pos.long()[:, :, None].expand(-1, -1, seq.shape[-1]))


def cross_entropy_ignore_index(logits: torch.Tensor, labels: torch.Tensor,
                               ignore_index: int = -100) -> torch.Tensor:
    """Mean cross-entropy over labels != ignore_index, in f32
    (CrossEntropyLoss semantics)."""
    valid = labels != ignore_index
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, torch.where(valid, labels, 0)[..., None].long())[..., 0]
    return torch.where(valid, nll, 0.0).sum() / valid.sum().clamp(min=1)


def label_smooth_cross_entropy(logits: torch.Tensor, labels: torch.Tensor, *,
                               smoothing: float = 0.1, ignore_index: int = -100,
                               reduction: str = "mean") -> torch.Tensor:
    """LabelSmoothSoftmaxCEV1: the target gets 1 - smoothing, every class
    smoothing / V on top, in f32; labels == ignore_index count nothing.
    reduction='none' returns the per-token loss."""
    valid = labels != ignore_index
    logp = torch.log_softmax(logits.float(), dim=-1)
    target = logp.gather(-1, torch.where(valid, labels, 0)[..., None].long())[..., 0]
    nll = -((1.0 - smoothing) * target + smoothing / logits.shape[-1] * logp.sum(-1))
    nll = torch.where(valid, nll, 0.0)
    if reduction == "none":
        return nll
    return nll.sum() / valid.sum().clamp(min=1)


def lm_loss(logits: torch.Tensor, labels: torch.Tensor, *, label_smoothing: float = 0.0,
            reduction: str = "mean") -> torch.Tensor:
    """Next-token LM loss with shift-by-one, labels -100 ignored, label
    smoothing when label_smoothing > 0; reduction='none' returns the
    per-sequence summed loss."""
    labels = labels[:, 1:]
    valid = labels != -100
    if label_smoothing > 0:
        per_tok = label_smooth_cross_entropy(logits[:, :-1], labels, smoothing=label_smoothing,
                                             reduction="none")
    else:
        logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
        per_tok = -logp.gather(-1, torch.where(valid, labels, 0)[..., None].long())[..., 0]
        per_tok = torch.where(valid, per_tok, 0.0)
    if reduction == "none":
        return per_tok.sum(1)
    return per_tok.sum() / valid.sum().clamp(min=1)
