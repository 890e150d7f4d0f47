"""Captions of the benchmark's traffic: their tokenised lengths and their
token ids, made on the device from a seed.

A traffic file's "captions" entry gives the length distribution in words
(`words_min`, `words_mean`: the least count and the mean) and the tokens a
caption holds beyond its words (`tokens_over_words`: [CLS], the full stop
and [SEP]). The words above the least count follow a geometric law with the
stated mean. A set of n captions takes the n quantiles (i + 1/2) / n of that
law, cut at the configuration's max_tokens as the tokenizer truncates: the
seed draws the order, never the lengths, so every seed gives the same work.
"""

from __future__ import annotations

import math

import numpy as np

CLS, SEP, PAD = 101, 102, 0
FIRST_WORD_ID = 1000  # below lie BERT's special and unused ids


def quantile_lengths(spec: dict, n: int, max_tokens: int) -> np.ndarray:
    """The n tokenised lengths of a caption set, ascending."""
    lo, mean = float(spec["words_min"]), float(spec["words_mean"])
    extra = int(spec["tokens_over_words"])
    q = (np.arange(n) + 0.5) / n
    if mean > lo:
        keep = (mean - lo) / (mean - lo + 1.0)  # P(one more word) of the geometric law
        over = np.ceil(np.log1p(-q) / math.log(keep) - 1.0 - 1e-9).clip(min=0.0)
    else:
        over = np.zeros(n)
    return np.minimum(lo + over + extra, max_tokens).astype(np.int64)


def lengths_in_order(spec: dict, n: int, max_tokens: int, g, device):
    """quantile_lengths in an order drawn from generator g, on the device."""
    import torch

    lens = torch.as_tensor(quantile_lengths(spec, n, max_tokens), device=device)
    return lens[torch.randperm(n, generator=g, device=device)]


def tokens(lens, width: int, vocab: int, g, device):
    """(ids [n, width] int64, atts [n, width] int64) for captions of the
    given lengths: [CLS], word ids drawn from g, [SEP], then [PAD]."""
    import torch

    n = lens.shape[0]
    ids = torch.randint(FIRST_WORD_ID, vocab, (n, width), generator=g, device=device)
    pos = torch.arange(width, device=device)[None]
    ids = torch.where(pos == lens[:, None] - 1, SEP, ids)
    ids[:, 0] = CLS
    atts = (pos < lens[:, None]).long()
    return torch.where(atts == 1, ids, PAD), atts
