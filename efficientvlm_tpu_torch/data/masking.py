"""MLM masking with whole-word expansion and skipgram spans (the port's
copy of efficientvlm_tpu/data/masking.py, after the reference's
TextMaskingGenerator, dataset/pretrain_dataset.py:46-137): about mask_prob
of the positions (at least 1, at most mask_max), widened to whole
WordPiece words and, with probability skipgram_prb, to an n-gram of 2 to
skipgram_size; then 80% [MASK], 10% a random token, 10% kept. The draws
come from a numpy Generator seeded at construction, in the JAX package's
order.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np


class TextMaskingGenerator:
    def __init__(self, tokenizer, mask_prob: float, mask_max: int, skipgram_prb: float = 0.2,
                 skipgram_size: int = 3, mask_whole_word: bool = True,
                 seed: Optional[int] = None):
        self.id2token = {i: w for w, i in tokenizer.get_vocab().items()}
        self.cls_token = tokenizer.cls_token
        self.mask_token = tokenizer.mask_token
        self.mask_max = mask_max
        self.mask_prob = mask_prob
        self.skipgram_prb = skipgram_prb
        self.skipgram_size = skipgram_size
        self.mask_whole_word = mask_whole_word
        self.rng = np.random.default_rng(seed)

    def get_random_word(self) -> str:
        return self.id2token[int(self.rng.integers(0, len(self.id2token)))]

    def __call__(self, tokens: List[str]) -> Tuple[List[str], List[int]]:
        """tokens (starting with [CLS]) -> (masked tokens, masked positions)."""
        tokens = list(tokens)
        if tokens[0] != self.cls_token:
            raise ValueError(f"tokens must start with {self.cls_token}, not {tokens[0]}")
        n_pred = min(self.mask_max, max(1, int(round(len(tokens) * self.mask_prob))))
        cand_pos = list(range(1, len(tokens)))
        self.rng.shuffle(cand_pos)
        masked_pos: set = set()
        max_cand_pos = max(cand_pos)

        def whole_word(st, end):
            while st >= 0 and tokens[st].startswith("##"):
                st -= 1
            while end < len(tokens) and tokens[end].startswith("##"):
                end += 1
            return st, end

        for pos in cand_pos:
            if len(masked_pos) >= n_pred:
                break
            if pos in masked_pos:
                continue
            if (self.skipgram_prb > 0 and self.skipgram_size >= 2
                    and self.rng.random() < self.skipgram_prb):
                size = int(self.rng.integers(2, self.skipgram_size + 1))
            else:
                size = 1
            st_pos, end_pos = (whole_word(pos, pos + size) if self.mask_whole_word
                               else (pos, pos + size))
            for mp in range(st_pos, end_pos):
                if not 0 < mp <= max_cand_pos:
                    break
                masked_pos.add(mp)

        masked_list = list(masked_pos)
        if len(masked_list) > n_pred:
            self.rng.shuffle(masked_list)
            masked_list = masked_list[:n_pred]
        for pos in masked_list:
            if self.rng.random() < 0.8:
                tokens[pos] = self.mask_token
            elif self.rng.random() < 0.5:
                tokens[pos] = self.get_random_word()
        return tokens, masked_list
