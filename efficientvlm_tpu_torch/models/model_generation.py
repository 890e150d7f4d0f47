"""Generation task models (port of efficientvlm_tpu/models/
model_generation.py): captioning (image -> caption) and VQA (question +
image -> ranked answers), teacher and student in one via zs.

- XVLMForCaptioning: the vision encoder and a BERT LM-head decoder with the
  full fusion text config (layers [0, fusion) text-only, [fusion, N)
  cross-attending into the image). `forward` is the training LM loss (the
  prompt and PAD positions masked out, label smoothing) or, with
  output_hidden_states, the loss and the KD taps; `forward_logits` the
  teacher-forced logits; `generate` decodes greedily or by beam search, the
  beams of an image sharing its cross K/V.
- XVLMForVQA: the question through the fusion text encoder (multi_modal over
  the image), then an answer decoder with fusion_layer 0 (every layer
  cross-attends into the question states). `forward_train` is the weighted
  answer LM loss over the answers gathered to their questions by `k`
  (vqa_collate's k_index); `forward_eval` ranks a list of answers in two
  batched decoder calls (`rank_answer`).

Training forwards (train=True) draw dropout from one torch.Generator, the
vision tower's first. Sampling (do_sample / top_p), SCST and the two
translation models come with later slices.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..config import Config, TextConfig, VisionConfig
from ..device import resolve_device
from ..generation import generate_beam, generate_no_beam, make_bert_decode_fn, top_k
from . import bert as B
from . import vit as V
from .xvlm import split_zs


def _decoder_zs(zs: Optional[dict]) -> dict:
    """VQA decoder gates: decoder_head_z [Ld,2,H] -> the cross gates of a
    fusion_layer=0 stack; decoder_intermediate_z -> its cross mlp gates."""
    if zs is None:
        return {}
    return {"cross_head_z": zs.get("decoder_head_z"),
            "cross_mlp_z": zs.get("decoder_intermediate_z")}


def _text_stack_zs(zs: Optional[dict]) -> dict:
    """Full fusion-stack gates (the captioning decoder has the X-VLM text
    layout: text_* for [0, fusion), cross_* for the rest)."""
    if zs is None:
        return {}
    return {"text_head_z": zs.get("text_head_z"), "cross_head_z": zs.get("cross_head_z"),
            "text_mlp_z": zs.get("text_intermediate_z"),
            "cross_mlp_z": zs.get("cross_intermediate_z")}


def _generator(seed: int, device) -> tuple:
    device = resolve_device(device)
    generator = torch.Generator(device=device)
    generator.manual_seed(seed)
    return generator, device


class XVLMForCaptioning:
    def __init__(self, vision_cfg: VisionConfig, text_cfg: TextConfig,
                 config: Optional[Config] = None):
        self.vision_cfg = vision_cfg
        self.text_cfg = text_cfg
        self.config = config or Config()
        self.label_smoothing = self.config.get("label_smoothing", 0.0)
        self.prompt_length = self.config.get("prompt_length", 2)  # '[CLS] a picture of'

    def init(self, seed: int, *, device=None) -> dict:
        """Params from a seed, on `device` (default cuda)."""
        generator, device = _generator(seed, device)
        return {"vision": V.init_vit(generator, self.vision_cfg, device),
                "text_decoder": B.init_bert(generator, self.text_cfg, with_mlm_head=True,
                                            device=device)}

    def encode_image(self, params, image, *, zs=None, output_attentions=False,
                     output_hidden_states=False, train=False, generator=None, dtype=None,
                     impl="fused"):
        """Returns (image_embeds [B,S,D], atts [B,S] ones, tower outputs)."""
        vz, _ = split_zs(zs)
        out = V.vit_apply(params["vision"], image, self.vision_cfg,
                          output_attentions=output_attentions,
                          output_hidden_states=output_hidden_states, train=train,
                          generator=generator, dtype=dtype, impl=impl, **vz)
        embeds = out["last_hidden"]
        atts = torch.ones(embeds.shape[:2], dtype=torch.int32, device=embeds.device)
        return embeds, atts, out

    def _decode(self, params, image, caption_ids, caption_atts, *, zs, output_attentions,
                output_hidden_states, train, generator, dtype, impl):
        """(logits [B, L, V], decoder outputs, tower outputs) of the
        teacher-forced decoder over the image."""
        embeds, atts, vout = self.encode_image(
            params, image, zs=zs, output_attentions=output_attentions,
            output_hidden_states=output_hidden_states, train=train, generator=generator,
            dtype=dtype, impl=impl)
        out = B.bert_apply(
            params["text_decoder"], caption_ids, self.text_cfg, attention_mask=caption_atts,
            encoder_hidden=embeds, encoder_attention_mask=atts, mode="multi_modal",
            is_decoder=True, output_attentions=output_attentions,
            output_hidden_states=output_hidden_states, train=train, generator=generator,
            dtype=dtype, impl=impl, **_text_stack_zs(zs))
        logits = B.mlm_head_apply(params["text_decoder"]["cls"], out["last_hidden"],
                                  self.text_cfg, dtype=dtype)
        return logits, out, vout

    def forward(self, params, image, caption_ids, caption_atts, *, pad_token_id: int = 0,
                prompt_length: Optional[int] = None, zs=None, generator=None,
                output_attentions=False, output_hidden_states=False, train=False, dtype=None,
                impl="fused"):
        """The caption LM loss, PAD and prompt positions masked to -100, with
        the model's label smoothing; with output_hidden_states {"loss",
        "hidden_dict", "attention_dict", "cross_attention_dict",
        "logits_dict"} (the KD taps)."""
        prompt_length = self.prompt_length if prompt_length is None else prompt_length
        logits, out, vout = self._decode(
            params, image, caption_ids, caption_atts, zs=zs, output_attentions=output_attentions,
            output_hidden_states=output_hidden_states, train=train, generator=generator,
            dtype=dtype, impl=impl)
        targets = torch.where(caption_ids == pad_token_id, -100, caption_ids)
        pos = torch.arange(caption_ids.shape[1], device=caption_ids.device)[None]
        targets = torch.where(pos < prompt_length, -100, targets)
        loss = B.lm_loss(logits, targets, label_smoothing=self.label_smoothing)
        if not output_hidden_states:
            return loss
        return {"loss": loss,
                "hidden_dict": {"image_hidden_states": vout["hidden_states"],
                                "decoder_hidden_states": out["hidden_states"]},
                "attention_dict": {"image_attentions": vout["attentions"],
                                   "decoder_attentions": out["attentions"]},
                "cross_attention_dict": {"decoder_cross_attentions": out["cross_attentions"]},
                "logits_dict": {"logits": logits}}

    def forward_logits(self, params, image, caption_ids, caption_atts, *, zs=None,
                       dtype=None, impl="fused") -> torch.Tensor:
        """Teacher-forced decoder logits [B, L, V] of the given token ids."""
        return self._decode(params, image, caption_ids, caption_atts, zs=zs,
                            output_attentions=False, output_hidden_states=False, train=False,
                            generator=None, dtype=dtype, impl=impl)[0]

    def generate(self, params, image, prompt_ids, *, max_length: int = 30,
                 min_length: int = 10, num_beams: int = 1, do_sample: bool = False,
                 repetition_penalty: float = 1.0, eos_id: int = 102,
                 pad_id: int = 0, zs=None, dtype=None, impl="fused",
                 stats: Optional[dict] = None) -> torch.Tensor:
        """Token ids [B, max_length]. prompt_ids [B, P] without the final
        [SEP]. The image embeds stay unexpanded across beams: all beams of an
        image share its cross K/V (grouped K/V). `stats`, when given, gets
        "decoder_calls"."""
        image_embeds, image_atts, _ = self.encode_image(params, image, zs=zs, dtype=dtype,
                                                        impl=impl)
        bsz = image_embeds.shape[0]
        decode_fn = make_bert_decode_fn(
            params["text_decoder"], self.text_cfg, encoder_hidden=image_embeds,
            encoder_atts=image_atts, dtype=dtype, impl=impl, **_text_stack_zs(zs))
        cache = B.init_bert_cache(params["text_decoder"], self.text_cfg,
                                  bsz * max(num_beams, 1), max_length,
                                  dtype=dtype or torch.float32)
        if num_beams > 1:
            return generate_beam(decode_fn, cache, prompt_ids, num_beams=num_beams,
                                 max_length=max_length, min_length=min_length, eos_id=eos_id,
                                 pad_id=pad_id, repetition_penalty=repetition_penalty,
                                 stats=stats)
        tokens, _ = generate_no_beam(decode_fn, cache, prompt_ids, max_length=max_length,
                                     min_length=min_length, eos_id=eos_id, pad_id=pad_id,
                                     do_sample=do_sample, repetition_penalty=repetition_penalty, stats=stats)
        return tokens


class XVLMForVQA:
    def __init__(self, vision_cfg: VisionConfig, text_cfg: TextConfig,
                 config: Optional[Config] = None):
        self.vision_cfg = vision_cfg
        self.text_cfg = text_cfg
        self.config = config or Config()
        self.pad_token_id = self.config.get("pad_token_id", 0)
        num_dec = self.config.get(
            "num_dec_layers", text_cfg["num_hidden_layers"] - text_cfg["fusion_layer"])
        # the decoder: every layer cross-attends into the question states
        self.decoder_cfg = TextConfig.create(
            **{**{k: text_cfg[k] for k in TextConfig.DEFAULTS if k in text_cfg},
               "fusion_layer": 0, "num_hidden_layers": num_dec,
               "encoder_width": text_cfg["hidden_size"]})

    def init(self, seed: int, *, device=None) -> dict:
        """Params from a seed, on `device` (default cuda)."""
        generator, device = _generator(seed, device)
        return {"vision": V.init_vit(generator, self.vision_cfg, device),
                "text": B.init_bert(generator, self.text_cfg, device=device),
                "text_decoder": B.init_bert(generator, self.decoder_cfg, with_mlm_head=True,
                                            device=device)}

    def encode_question(self, params, image, question_ids, question_atts, *, zs=None,
                        output_attentions=False, output_hidden_states=False, train=False,
                        generator=None, dtype=None, impl="fused"):
        """Returns (question outputs {"last_hidden", ...}, vision outputs)."""
        vz, tz = split_zs(zs)
        taps = dict(output_attentions=output_attentions,
                    output_hidden_states=output_hidden_states, train=train,
                    generator=generator, dtype=dtype, impl=impl)
        vout = V.vit_apply(params["vision"], image, self.vision_cfg, **taps, **vz)
        image_embeds = vout["last_hidden"]
        image_atts = torch.ones(image_embeds.shape[:2], dtype=torch.int32,
                                device=image_embeds.device)
        qout = B.bert_apply(
            params["text"], question_ids, self.text_cfg, attention_mask=question_atts,
            encoder_hidden=image_embeds, encoder_attention_mask=image_atts,
            mode="multi_modal", **taps, **tz)
        return qout, vout

    def forward_train(self, params, image, question_ids, question_atts, answer_ids,
                      answer_atts, weights, k, *, zs=None, generator=None,
                      output_attentions=False, output_hidden_states=False, train=True,
                      dtype=None, impl="fused"):
        """The weighted answer LM loss: answer row a decodes over the states
        of question k[a] (vqa_collate's k_index), its summed LM loss weighted
        by weights[a], summed over the answers and divided by the number of
        images; pad answers of weight 0 count nothing. With
        output_hidden_states {"loss", "hidden_dict", "attention_dict",
        "cross_attention_dict", "logits_dict"} (the KD taps)."""
        qout, vout = self.encode_question(
            params, image, question_ids, question_atts, zs=zs,
            output_attentions=output_attentions, output_hidden_states=output_hidden_states,
            train=train, generator=generator, dtype=dtype, impl=impl)
        k = k.long()
        targets = torch.where(answer_ids == self.pad_token_id, -100, answer_ids)
        dout = B.bert_apply(
            params["text_decoder"], answer_ids, self.decoder_cfg, attention_mask=answer_atts,
            encoder_hidden=qout["last_hidden"][k], encoder_attention_mask=question_atts[k],
            mode="multi_modal", is_decoder=True, output_attentions=output_attentions,
            output_hidden_states=output_hidden_states, train=train, generator=generator,
            dtype=dtype, impl=impl, **_decoder_zs(zs))
        logits = B.mlm_head_apply(params["text_decoder"]["cls"], dout["last_hidden"],
                                  self.decoder_cfg, dtype=dtype)
        per_answer = B.lm_loss(logits, targets, reduction="none")
        loss = (weights.float() * per_answer).sum() / image.shape[0]
        if not output_hidden_states:
            return loss
        return {"loss": loss,
                "hidden_dict": {"image_hidden_states": vout["hidden_states"],
                                "text_hidden_states": qout["hidden_states"],
                                "decoder_hidden_states": dout["hidden_states"]},
                "attention_dict": {"image_attentions": vout["attentions"],
                                   "text_attentions": qout["attentions"],
                                   "decoder_attentions": dout["attentions"]},
                "cross_attention_dict": {"cross_attentions": qout["cross_attentions"],
                                         "decoder_cross_attentions": dout["cross_attentions"]},
                "logits_dict": {"logits": logits}}

    def rank_answer(self, params, question_states, question_atts, answer_ids, answer_atts,
                    k: int, *, zs=None, dtype=None, impl="fused"):
        """k-way answer re-ranking: two batched decoder calls and the chain
        rule. The decoder's cross K/V over the question states are projected
        once ([Q] rows); the k-tiled scoring call shares each question's K/V
        across its k candidate rows (grouped K/V). Returns (topk_ids [Q, k],
        topk_probs [Q, k])."""
        num_ques = question_states.shape[0]
        dz = _decoder_zs(zs)

        def dec(ids, atts):
            out = B.bert_apply(
                params["text_decoder"], ids, self.decoder_cfg, attention_mask=atts,
                encoder_hidden=question_states, encoder_attention_mask=question_atts,
                mode="multi_modal", is_decoder=True, cross_kv=kv,
                encoder_groups=ids.shape[0] // num_ques, dtype=dtype, impl=impl, **dz)
            return B.mlm_head_apply(params["text_decoder"]["cls"], out["last_hidden"],
                                    self.decoder_cfg, dtype=dtype)

        kv = B.precompute_cross_kv(params["text_decoder"], self.decoder_cfg, question_states,
                                   dtype=dtype)
        # the first answer token is the start token of every answer; no mask
        start_ids = answer_ids[:1, :1].expand(num_ques, 1)
        logits = dec(start_ids, None)[:, 0]
        prob_first = torch.softmax(logits.float(), dim=1)[:, answer_ids[:, 1].long()]
        topk_probs, topk_ids = top_k(prob_first, k)  # [Q, k]

        flat = topk_ids.reshape(-1)  # ordered by question: groups contiguous
        input_ids, input_atts = answer_ids[flat], answer_atts[flat]
        targets = torch.where(input_ids == self.pad_token_id, -100, input_ids)
        answer_loss = B.lm_loss(dec(input_ids, input_atts), targets, reduction="none")

        log_probs_sum = (torch.log(topk_probs.reshape(-1)) - answer_loss).reshape(num_ques, k)
        topk_probs2, rerank_id = top_k(torch.softmax(log_probs_sum, dim=-1), k)
        return topk_ids.gather(1, rerank_id), topk_probs2

    def forward_eval(self, params, image, question_ids, question_atts, answer_ids,
                     answer_atts, *, k: int, zs=None, dtype=None, impl="fused"):
        qout, _ = self.encode_question(params, image, question_ids, question_atts, zs=zs,
                                       dtype=dtype, impl=impl)
        return self.rank_answer(params, qout["last_hidden"], question_atts, answer_ids,
                                answer_atts, k, zs=zs, dtype=dtype, impl=impl)
