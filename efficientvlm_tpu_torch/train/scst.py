"""Self-critical sequence training (SCST) with the CIDEr-D reward (port of
efficientvlm_tpu/train/scst.py, the reference's ScstRewardCriterion and its
--scst flag): sample K captions per image, reward each by CIDEr-D against
the ground truths, take as baseline the greedy caption's reward (default) or
the leave-one-out mean of the other samples, and minimise -(reward -
baseline) x the sample's log-probability.

The split is JAX's: the sampler gives token ids on the device, the reward is
computed on the host from the decoded strings, and the gradient step runs one
teacher-forced decoder forward over the sampled ids (the training forms of
the fused kernels under autograd) for every sequence's log-probability at
once.

Where the port's step differs in form, not in function: each image is
encoded once and its embeddings serve its K rows (JAX repeats the image K
times). The sampler decodes the K rows over the image's shared cross K/V
(grouped K/V, as the beams do); the gradient step repeats the embeddings, so
autograd sums the K rows' gradients into the one encode, as JAX's sum over
the K copies does.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from ..evaluation.caption_metrics import CiderD
from .optim import tree_leaves
from .steps import PretrainState, _dp_begin, _dp_sync


class ScstRewardCriterion:
    """baseline_type "greedy" (the greedy decode's score, the SCST paper's
    baseline) or "sample" (the leave-one-out mean of the other K - 1
    samples)."""

    CIDER_REWARD_WEIGHT = 1.0

    def __init__(self, sample_n: int = 5, baseline_type: str = "greedy"):
        if baseline_type not in ("greedy", "sample"):
            raise ValueError(f"baseline_type {baseline_type!r}: 'greedy' or 'sample'")
        self.sample_n = sample_n
        self.baseline_type = baseline_type
        self.scorer = CiderD()
        self._cur_score: Optional[float] = None

    @staticmethod
    def _wrap_sentence(s: str) -> str:
        """A trailing '.' stripped and ' <eos>' appended, so the n-grams match
        the reference's cached document frequencies."""
        r = s.strip()
        if r.endswith("."):
            r = r[:-1]
        return r + " <eos>"

    def _scores(self, gen: List[str], gt_idx: List[int], gt_captions) -> np.ndarray:
        gts = {i: [self._wrap_sentence(c) for c in gt_captions[gt_idx[i]]]
               for i in range(len(gen))}
        res = {i: [self._wrap_sentence(gen[i])] for i in range(len(gen))}
        _, scores = self.scorer.compute_score(gts, res)
        return np.asarray(scores, np.float32) * self.CIDER_REWARD_WEIGHT

    def rewards(self, gt_captions: Sequence[Sequence[str]], sampled: Sequence[str],
                greedy: Optional[Sequence[str]] = None) -> np.ndarray:
        """sampled: B*K strings (K consecutive per image); greedy: B strings
        with the greedy baseline. Returns each sample's advantage [B*K]."""
        k, b = self.sample_n, len(gt_captions)
        if len(sampled) != b * k:
            raise ValueError(f"{len(sampled)} samples for {b} images x {k}")
        gen = list(sampled)
        gt_idx = [i // k for i in range(b * k)]
        if self.baseline_type == "greedy":
            if greedy is None or len(greedy) != b:
                raise ValueError("the greedy baseline needs one greedy caption per image")
            gen += list(greedy)
            gt_idx += list(range(b))
        scores = self._scores(gen, gt_idx, gt_captions)
        sample_scores = scores[:b * k].reshape(b, k)
        self._cur_score = float(sample_scores.mean())
        if self.baseline_type == "greedy":
            baseline = scores[b * k:][:, None]
        else:
            baseline = (sample_scores.sum(1, keepdims=True) - sample_scores) / (k - 1)
        return (sample_scores - baseline).reshape(-1)

    def get_score(self) -> Optional[float]:
        return self._cur_score


def sequence_logprobs(logits: torch.Tensor, tokens: torch.Tensor, *, prompt_length: int,
                      eos_id: int, pad_id: int) -> torch.Tensor:
    """Each sequence's sum of next-token log-probs [B] over the generated
    span: positions prompt_length to the first EOS inclusive, pads excluded.
    logits [B, L, V] are the teacher-forced decoder's over `tokens` [B, L]
    (the logits at t predict token t + 1)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    next_tok = tokens[:, 1:].long()
    tok_logp = logp[:, :-1].gather(-1, next_tok[..., None])[..., 0]
    pos = torch.arange(next_tok.shape[1], device=tokens.device)[None]
    gen_mask = pos >= (prompt_length - 1)  # the first generated token sits at prompt_length
    is_eos = next_tok == eos_id
    after_eos = (torch.cumsum(is_eos.int(), dim=1) - is_eos.int()) > 0
    valid = (gen_mask & ~after_eos & (next_tok != pad_id)) | (gen_mask & is_eos & ~after_eos)
    return (tok_logp * valid.to(tok_logp.dtype)).sum(1)


class ScstGradStep:
    """The advantage-weighted log-prob update. step(state, batch) ->
    metrics, updating the PretrainState (params, opt_state, step) in place;
    batch {"image" [B,H,W,3], "tokens" [B*K, L] sampled ids, "advantages"
    [B*K]}. The forward is teacher-forced in eval mode (no dropout): the
    fused sublayers run their differentiable forms. loss_and_grads and apply
    are its parts, for timing. Above one process `data_parallel` (a
    utils/dist.GradientSync) averages the gradients and metrics over the
    ranks before the update, as the other steps do."""

    data_parallel = None  # a utils/dist.GradientSync above one process

    def __init__(self, model, optimizer, *, prompt_length: int, pad_token_id: int,
                 eos_id: int, sample_n: int, zs=None, dtype=None, impl: str = "fused"):
        self.model, self.optimizer = model, optimizer
        self.prompt_length, self.pad_token_id, self.eos_id = prompt_length, pad_token_id, eos_id
        self.sample_n, self.zs, self.dtype, self.impl = sample_n, zs, dtype, impl

    def loss(self, params, batch: dict) -> tuple:
        tokens = batch["tokens"].long()
        atts = (tokens != self.pad_token_id).to(torch.int32)
        logits = self.model.forward_logits(params, batch["image"], tokens, atts, zs=self.zs,
                                           image_repeats=self.sample_n, dtype=self.dtype,
                                           impl=self.impl)
        logp = sequence_logprobs(logits, tokens, prompt_length=self.prompt_length,
                                 eos_id=self.eos_id, pad_id=self.pad_token_id)
        adv = torch.as_tensor(batch["advantages"], dtype=torch.float32, device=logp.device)
        loss = -(adv * logp).mean()
        return loss, {"loss_scst": loss, "mean_logprob": logp.mean()}

    def loss_and_grads(self, state: PretrainState, batch: dict):
        """(metrics, the loss's gradient over the params in tree order)."""
        leaves = tree_leaves(state.params)
        for leaf in leaves:
            leaf.requires_grad_(True)
        with torch.enable_grad():
            loss, metrics = self.loss(state.params, batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        return {k: v.detach() for k, v in metrics.items()}, list(grads)

    def apply(self, state: PretrainState, grads) -> PretrainState:
        self.optimizer.step(tree_leaves(state.params), grads, state.opt_state)
        state.step += 1
        return state

    def __call__(self, state: PretrainState, batch: dict) -> dict:
        _dp_begin(self, state)
        metrics, grads = _dp_sync(self, *self.loss_and_grads(state, batch))
        self.apply(state, grads)
        return metrics


def make_scst_step(model, optimizer, *, prompt_length: int, pad_token_id: int, eos_id: int,
                   sample_n: int = 5, max_length: int = 30, min_length: int = 5,
                   top_p: float = 1.0, zs=None, dtype=None, impl: str = "fused"):
    """(sample_fn, grad_step) of the SCST fine-tune.

    sample_fn(params, image, prompt_ids, generator) -> (sample_tokens [B*K,
    L], greedy_tokens [B, L]): K rows a image sampled from the top_p
    filtered softmax (noise from `generator`), then the greedy decode.
    grad_step: an ScstGradStep."""

    @torch.no_grad()
    def sample_fn(params, image, prompt_ids, generator: Optional[torch.Generator] = None):
        kw = dict(max_length=max_length, min_length=min_length, num_beams=1, eos_id=eos_id,
                  pad_id=pad_token_id, zs=zs, dtype=dtype, impl=impl)
        sample_tokens = model.generate(params, image, prompt_ids, do_sample=True, top_p=top_p,
                                       num_return_sequences=sample_n, generator=generator, **kw)
        greedy_tokens = model.generate(params, image, prompt_ids, do_sample=False, **kw)
        return sample_tokens, greedy_tokens

    grad_step = ScstGradStep(model, optimizer, prompt_length=prompt_length,
                             pad_token_id=pad_token_id, eos_id=eos_id, sample_n=sample_n,
                             zs=zs, dtype=dtype, impl=impl)
    return sample_fn, grad_step
