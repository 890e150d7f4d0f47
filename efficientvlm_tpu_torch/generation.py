"""Autoregressive generation: greedy decode and beam search with a KV cache
(port of efficientvlm_tpu/generation.py).

- a fixed-size decode cache, written in place; the beam reorder is a
  gather of the cache rows;
- the position loop is a Python loop whose condition is read on the host
  each step: it stops once every sequence is finished (greedy) or no live
  beam can beat the finished pool (beam, HF BeamHypotheses.is_done), which
  gives the same output as running to max_length;
- min_length EOS masking and the repetition penalty as in HF;
- gates (zs) thread through every step.

The decoder is abstracted as `decode_fn(tokens, cache, offset) -> (logits,
cache)`, so the same loops serve the captioning decoder (the full fusion
stack) and any other cross-attending BERT decoder.

Every ranking uses `top_k`, a stable descending sort: ties go to the lower
index, as in `jax.lax.top_k` (`torch.topk` promises no tie order, and equal
scores are common here: runs of -1e9 in the beam pool, answers that share a
first token in VQA ranking).

Sampling (`do_sample`) draws by Gumbel-max, as `jax.random.categorical`
does: the next token is argmax(filtered logits + g), g = -log(-log(u)), u
uniform from an explicit torch.Generator on the logits' device
(`gumbel_noise`), one [B, V] draw a step and no host read beyond the loop's
own. Two generators seeded alike give the same noise, so a test can replay
the draws.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from .config import TextConfig
from .models import bert as B

NEG_INF = -1e9


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest values along the last dim, descending, ties to the lower
    index (jax.lax.top_k's order)."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def make_bert_decode_fn(params: dict, cfg: TextConfig, *, encoder_hidden: torch.Tensor,
                        encoder_atts: torch.Tensor, text_head_z=None, cross_head_z=None,
                        text_mlp_z=None, cross_mlp_z=None, dtype=None,
                        impl: str = "fused") -> Callable:
    """decode_fn over a BERT LM-head decoder (is_decoder, multi_modal,
    cross-attending into encoder_hidden). The cross K/V over the step-constant
    encoder states are projected once here. `encoder_hidden` / `encoder_atts`
    may have fewer rows than the decode tokens (B against B*K beam rows,
    groups contiguous): grouped K/V attention shares each row's K/V across
    its group. Logits stay in the compute dtype."""
    cross_kv = B.precompute_cross_kv(params, cfg, encoder_hidden, dtype=dtype)

    def decode_fn(tokens: torch.Tensor, cache: list, offset: int):
        out = B.bert_apply(
            params, tokens, cfg, encoder_hidden=encoder_hidden,
            encoder_attention_mask=encoder_atts, mode="multi_modal", is_decoder=True,
            cache=cache, cross_kv=cross_kv,
            encoder_groups=tokens.shape[0] // encoder_hidden.shape[0],
            position_offset=offset, text_head_z=text_head_z, cross_head_z=cross_head_z,
            text_mlp_z=text_mlp_z, cross_mlp_z=cross_mlp_z, dtype=dtype, impl=impl)
        logits = B.mlm_head_apply(params["cls"], out["last_hidden"], cfg, dtype=dtype)
        return logits, out["cache"]

    return decode_fn


def apply_repetition_penalty(logits: torch.Tensor, tokens: torch.Tensor, valid: torch.Tensor,
                             penalty: float) -> torch.Tensor:
    """HF semantics: for tokens already generated, divide positive logits by
    `penalty`, multiply negative ones."""
    if penalty == 1.0:
        return logits
    onehot = torch.nn.functional.one_hot(tokens.long(), logits.shape[-1]).float()
    seen = (onehot * valid[..., None]).sum(-2).clamp(0, 1)  # [B, V]
    penalized = torch.where(logits > 0, logits / penalty, logits * penalty)
    return torch.where(seen > 0, penalized, logits)


def top_p_filter(logits: torch.Tensor, top_p: float) -> torch.Tensor:
    """Keep the smallest set of top tokens whose probability reaches top_p
    (one past the cut); the rest get NEG_INF."""
    if top_p >= 1.0:
        return logits
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
    cutoff_idx = (cum < top_p).sum(-1, keepdim=True)
    cutoff = sorted_logits.gather(-1, cutoff_idx)
    return torch.where(logits < cutoff, NEG_INF, logits)


def gumbel_noise(shape, generator: Optional[torch.Generator], device) -> torch.Tensor:
    """Standard Gumbel noise [shape] in f32: -log(-log(u)), u uniform in
    [tiny, 1) from `generator` (torch's default one when None)."""
    u = torch.rand(shape, generator=generator, device=device)
    return -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))


def sample_tokens(logits: torch.Tensor, *, top_p: float = 1.0,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """One token a row [B] from softmax(top_p_filter(logits)) by Gumbel-max
    (jax.random.categorical's draw), the noise from `generator`."""
    filtered = top_p_filter(logits.float(), top_p)
    noise = gumbel_noise(filtered.shape, generator, filtered.device)
    return (filtered + noise).argmax(-1)


def _valid(max_length: int, cur_len: int, device) -> torch.Tensor:
    return (torch.arange(max_length, device=device) < cur_len).float()[None, :]


def _report(stats: Optional[dict], calls: int) -> None:
    if stats is not None:
        stats["decoder_calls"] = calls


def generate_no_beam(decode_fn: Callable, init_cache: list, prompt_ids: torch.Tensor, *,
                     max_length: int, eos_id: int, pad_id: int, do_sample: bool = False,
                     temperature: float = 1.0, top_p: float = 1.0,
                     repetition_penalty: float = 1.0, min_length: int = 0,
                     generator: Optional[torch.Generator] = None,
                     stats: Optional[dict] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy or sampled decode (OSCAR _generate_no_beam_search semantics).
    Returns (tokens [B, max_length], sum_logprobs [B]): each step's logits
    divided by `temperature`, the repetition penalty and min_length's EOS
    mask applied, then the argmax or, with do_sample, a draw from the top_p
    filtered softmax (`sample_tokens`, noise from `generator`); the summed
    log-prob is the unfiltered log-softmax's. Finished rows write pad and
    keep their sum. `stats`, when given, gets "decoder_calls" (the prefill
    plus one call per step)."""
    bsz, prompt_len = prompt_ids.shape
    dev = prompt_ids.device
    tokens = torch.full((bsz, max_length), pad_id, dtype=torch.long, device=dev)
    tokens[:, :prompt_len] = prompt_ids

    logits, cache = decode_fn(prompt_ids, init_cache, 0)
    next_logits = logits[:, -1]
    calls = 1
    cur_len = prompt_len
    finished = torch.zeros(bsz, dtype=torch.bool, device=dev)
    sum_logprobs = torch.zeros(bsz, device=dev)
    while cur_len < max_length and not bool(finished.all()):
        scores = apply_repetition_penalty(next_logits.float() / temperature, tokens,
                                          _valid(max_length, cur_len, dev), repetition_penalty)
        if cur_len < min_length:
            scores = scores.clone()
            scores[:, eos_id] = NEG_INF
        logp = torch.log_softmax(scores, dim=-1)
        choice = (sample_tokens(scores, top_p=top_p, generator=generator) if do_sample
                  else scores.argmax(-1))
        next_tok = torch.where(finished, pad_id, choice)
        tok_logp = logp.gather(1, next_tok[:, None])[:, 0]
        sum_logprobs = sum_logprobs + torch.where(finished, 0.0, tok_logp)
        tokens[:, cur_len] = next_tok
        finished = finished | (next_tok == eos_id)
        step_logits, cache = decode_fn(next_tok[:, None], cache, cur_len)
        next_logits = step_logits[:, -1]
        calls += 1
        cur_len += 1
    _report(stats, calls)
    return tokens, sum_logprobs


def _gather_beams(tree, beam_idx: torch.Tensor, bsz: int, beams: int):
    """Reorder the [B*K, ...] tensors of a nested dict/list by per-batch beam
    indices [B, K]; host integers (the cache index) pass through."""
    flat = (torch.arange(bsz, device=beam_idx.device)[:, None] * beams + beam_idx).reshape(-1)

    def g(x):
        if isinstance(x, dict):
            return {k: g(v) for k, v in x.items()}
        if isinstance(x, list):
            return [g(v) for v in x]
        if isinstance(x, torch.Tensor) and x.ndim > 0:
            return x.index_select(0, flat)
        return x

    return g(tree)


def _pow(x: int, p: float) -> torch.Tensor:
    """x ** p in f32, as the JAX package computes the length normaliser."""
    return torch.tensor(float(x), dtype=torch.float32).pow(p)


def generate_beam(decode_fn: Callable, init_cache: list, prompt_ids: torch.Tensor, *,
                  num_beams: int, max_length: int, eos_id: int, pad_id: int,
                  min_length: int = 0, repetition_penalty: float = 1.0,
                  length_penalty: float = 1.0, stats: Optional[dict] = None) -> torch.Tensor:
    """Beam search with an HF-style finished-hypothesis pool: live beams
    continue with the best K non-EOS continuations of 2K candidates; EOS
    candidates within the top K enter a per-batch pool of K finished
    hypotheses, scored by their sum of log-probs over cur_len**length_penalty.

    prompt_ids [B, P] (not beam-expanded); the self-attention cache is sized
    for B*K rows, the encoder states / cross K/V stay at B rows (grouped K/V).
    Returns the best tokens [B, max_length]. `stats` as in generate_no_beam."""
    bsz, prompt_len = prompt_ids.shape
    dev = prompt_ids.device
    flat = bsz * num_beams
    tokens = torch.full((flat, max_length), pad_id, dtype=torch.long, device=dev)
    tokens[:, :prompt_len] = prompt_ids.repeat_interleave(num_beams, 0)

    logits, cache = decode_fn(tokens[:, :prompt_len], init_cache, 0)
    next_logits = logits[:, -1]
    calls = 1
    # only beam 0 is seeded: identical prompts would fill the beam with
    # identical candidates
    scores = torch.tensor([0.0] + [NEG_INF] * (num_beams - 1), device=dev).repeat(bsz)
    fin_tokens = torch.full((bsz, num_beams, max_length), pad_id, dtype=torch.long, device=dev)
    fin_scores = torch.full((bsz, num_beams), NEG_INF, device=dev)
    vocab = next_logits.shape[-1]
    k2 = 2 * num_beams
    denom_max = _pow(max_length, length_penalty).to(dev)

    def is_done(cur_len: int) -> bool:
        # no live beam can still beat the worst finished hypothesis: live raw
        # scores only decrease, so a future insert is bounded by best_live
        # over max_length**lp (lp > 0) or cur_len**lp (otherwise)
        denom = denom_max if length_penalty > 0.0 else _pow(cur_len, length_penalty).to(dev)
        best_live = scores.reshape(bsz, num_beams).max(1).values
        worst_fin = fin_scores.min(1).values
        return bool((worst_fin >= best_live / denom).all())

    cur_len = prompt_len
    while cur_len < max_length and not is_done(cur_len):
        if repetition_penalty == 1.0 and vocab >= k2 + 1:
            # fast path: rank on the raw compute-dtype logits (bf16 -> f32 is
            # monotone, so the top 2K+1 per row are those of the log-probs);
            # only the selected candidates get exact f32 log-probs
            kc = k2 + 1
            cand_logit, cand_tok = top_k(next_logits, kc)                # [B*K, kc]
            x = next_logits.float()
            m = x.max(-1, keepdim=True).values
            log_s = torch.log(torch.exp(x - m).sum(-1, keepdim=True))
            logp_cand = (cand_logit.float() - m) - log_s  # log_softmax's order
            if cur_len < min_length:
                logp_cand = torch.where(cand_tok == eos_id, NEG_INF, logp_cand)
            merged = (scores[:, None] + logp_cand).reshape(bsz, num_beams * kc)
            top_scores, midx = top_k(merged, k2)                         # [B, 2K]
            beam_idx = midx // kc
            tok_idx = cand_tok.reshape(bsz, num_beams * kc).gather(1, midx)
        else:
            # HF order: log_softmax first, then the processors on the log-probs
            logp = torch.log_softmax(next_logits.float(), dim=-1)
            logp = apply_repetition_penalty(logp, tokens, _valid(max_length, cur_len, dev),
                                            repetition_penalty)
            if cur_len < min_length:
                logp[:, eos_id] = NEG_INF
            cand = (scores[:, None] + logp).reshape(bsz, num_beams * vocab)
            top_scores, top_idx = top_k(cand, k2)
            beam_idx = top_idx // vocab
            tok_idx = top_idx % vocab

        live = tokens.reshape(bsz, num_beams, max_length)
        cand_tokens = live.gather(1, beam_idx[..., None].expand(-1, -1, max_length)).clone()
        cand_tokens[:, :, cur_len] = tok_idx
        is_eos = tok_idx == eos_id

        # finished pool insert (BeamHypotheses.add): normalised by the prefix
        # length; an EOS candidate enters only from within the top K
        norm = top_scores / _pow(cur_len, length_penalty).to(dev)
        in_top_k = torch.arange(k2, device=dev)[None, :] < num_beams
        eos_scores = torch.where(is_eos & in_top_k, norm, NEG_INF)
        pool_scores = torch.cat([fin_scores, eos_scores], 1)
        pool_tokens = torch.cat([fin_tokens, cand_tokens], 1)
        fin_scores, keep = top_k(pool_scores, num_beams)
        fin_tokens = pool_tokens.gather(1, keep[..., None].expand(-1, -1, max_length))

        # live beams: the best K non-EOS candidates
        live_scores, pick = top_k(torch.where(is_eos, NEG_INF, top_scores), num_beams)
        live_beam = beam_idx.gather(1, pick)
        next_tok = tok_idx.gather(1, pick).reshape(flat)
        tokens = live.gather(1, live_beam[..., None].expand(-1, -1, max_length))
        tokens = tokens.reshape(flat, max_length)
        tokens[:, cur_len] = next_tok
        cache = _gather_beams(cache, live_beam, bsz, num_beams)
        step_logits, cache = decode_fn(next_tok[:, None], cache, cur_len)
        next_logits = step_logits[:, -1]
        scores = live_scores.reshape(flat)
        calls += 1
        cur_len += 1
    _report(stats, calls)

    # finalize (HF): unfinished batches fall back to the live beams, inserted
    # at max_length norm; then the best of the pool
    live_norm = (scores / denom_max).reshape(bsz, num_beams)
    all_scores = torch.cat([fin_scores, live_norm], 1)
    all_tokens = torch.cat([fin_tokens, tokens.reshape(bsz, num_beams, max_length)], 1)
    best = all_scores.argmax(1)
    return all_tokens[torch.arange(bsz, device=dev), best]
