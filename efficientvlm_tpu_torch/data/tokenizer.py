"""BERT WordPiece tokenizer over a local vocabulary file (the port's copy
of WordPieceTokenizer, load_vocab, make_test_vocab and build_tokenizer of
efficientvlm_tpu/data/tokenizer.py): greedy longest-match WordPiece, as
HF's BertTokenizer, with nothing downloaded. Ids come back as int32 numpy
arrays; a card path takes them with torch.from_numpy.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np


class _Batch(dict):
    """{"input_ids", "attention_mask"}, also readable as attributes."""

    @property
    def input_ids(self):
        return self["input_ids"]

    @property
    def attention_mask(self):
        return self["attention_mask"]


class WordPieceTokenizer:
    """Lower-casing basic split (alphanumeric runs; every other non-space
    character its own token), then WordPiece over the vocab dict."""

    def __init__(self, vocab: Dict[str, int], *, lowercase: bool = True,
                 max_chars_per_word: int = 100):
        self.vocab = vocab
        self.ids_to_tokens = {i: t for t, i in vocab.items()}
        self.lowercase = lowercase
        self.max_chars_per_word = max_chars_per_word
        self.pad_token, self.unk_token = "[PAD]", "[UNK]"
        self.cls_token, self.sep_token, self.mask_token = "[CLS]", "[SEP]", "[MASK]"
        self.bos_token, self.eos_token = "[CLS]", "[SEP]"

    def get_vocab(self) -> Dict[str, int]:
        return self.vocab

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    @property
    def pad_token_id(self) -> int:
        return self.vocab[self.pad_token]

    @property
    def cls_token_id(self) -> int:
        return self.vocab[self.cls_token]

    @property
    def sep_token_id(self) -> int:
        return self.vocab[self.sep_token]

    @property
    def mask_token_id(self) -> int:
        return self.vocab[self.mask_token]

    @property
    def bos_token_id(self) -> int:
        return self.cls_token_id

    @property
    def eos_token_id(self) -> int:
        return self.sep_token_id

    def basic_tokenize(self, text: str) -> List[str]:
        if self.lowercase:
            text = text.lower()
        out: List[str] = []
        word: List[str] = []
        for ch in text:
            if ch.isalnum():
                word.append(ch)
                continue
            if word:
                out.append("".join(word))
                word = []
            if not ch.isspace():
                out.append(ch)
        if word:
            out.append("".join(word))
        return out

    def wordpiece(self, word: str) -> List[str]:
        """Longest vocab piece first, '##' on every piece after the first;
        [UNK] for the whole word where a piece cannot be matched."""
        if len(word) > self.max_chars_per_word:
            return [self.unk_token]
        tokens: List[str] = []
        start = 0
        while start < len(word):
            end = len(word)
            cur = None
            while start < end:
                sub = word[start:end] if start == 0 else "##" + word[start:end]
                if sub in self.vocab:
                    cur = sub
                    break
                end -= 1
            if cur is None:
                return [self.unk_token]
            tokens.append(cur)
            start = end
        return tokens

    def tokenize(self, text: str) -> List[str]:
        return [p for w in self.basic_tokenize(text) for p in self.wordpiece(w)]

    def convert_tokens_to_ids(self, tokens):
        unk = self.vocab[self.unk_token]
        if isinstance(tokens, str):
            return self.vocab.get(tokens, unk)
        return [self.vocab.get(t, unk) for t in tokens]

    def convert_ids_to_tokens(self, ids) -> List[str]:
        """Ids outside the vocab (a model head wider than the tokenizer)
        read as [UNK]."""
        return [self.ids_to_tokens.get(int(i), self.unk_token) for i in ids]

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        toks = self.convert_ids_to_tokens(ids)
        if skip_special_tokens:
            specials = {self.pad_token, self.cls_token, self.sep_token, self.mask_token}
            toks = [t for t in toks if t not in specials]
        out: List[str] = []
        for t in toks:
            if t.startswith("##") and out:
                out[-1] += t[2:]
            else:
                out.append(t)
        return " ".join(out)

    def __call__(self, texts, *, padding: str = "longest", truncation: bool = True,
                 max_length: int = 40, return_tensors: Optional[str] = "np"):
        """[CLS] + pieces, cut to max_length - 1 (truncation), + [SEP], then
        padded with [PAD] to the longest row or to max_length (padding
        "max_length"): {"input_ids", "attention_mask"} int32 [N, L]."""
        if isinstance(texts, str):
            texts = [texts]
        all_ids = []
        for t in texts:
            toks = [self.cls_token] + self.tokenize(t)
            if truncation:
                toks = toks[: max_length - 1]
            all_ids.append(self.convert_tokens_to_ids(toks + [self.sep_token]))
        pad_to = max_length if padding == "max_length" else max(len(x) for x in all_ids)
        input_ids = np.full((len(all_ids), pad_to), self.pad_token_id, np.int32)
        attention_mask = np.zeros((len(all_ids), pad_to), np.int32)
        for i, ids in enumerate(all_ids):
            ids = ids[:pad_to]
            input_ids[i, : len(ids)] = ids
            attention_mask[i, : len(ids)] = 1
        return _Batch(input_ids=input_ids, attention_mask=attention_mask)


def load_vocab(path: str) -> Dict[str, int]:
    """A vocab.txt: one token a line, its id the line number."""
    vocab: Dict[str, int] = {}
    with open(path, encoding="utf-8") as f:
        for i, line in enumerate(f):
            vocab[line.rstrip("\n")] = i
    return vocab


def make_test_vocab(extra_words: Optional[List[str]] = None) -> Dict[str, int]:
    """A small deterministic vocab: the specials, single characters, their
    '##' forms, common caption / question words and extra_words."""
    toks = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    toks += list("abcdefghijklmnopqrstuvwxyz0123456789.,!?'")
    toks += ["##" + c for c in "abcdefghijklmnopqrstuvwxyz0123456789"]
    common = (
        "a an the of in on is are was were picture photo image man woman dog cat "
        "two one three red blue green left right yes no and with person people "
        "what where who how many color standing sitting"
    ).split()
    toks += common + ["##ing", "##s", "##ed"]
    if extra_words:
        toks += [w for w in extra_words if w not in toks]
    return {t: i for i, t in enumerate(dict.fromkeys(toks))}


def build_tokenizer(text_encoder: str = "data/bert-base-uncased") -> WordPieceTokenizer:
    """The tokenizer of a directory holding vocab.txt or of a vocab file;
    make_test_vocab's where neither exists."""
    vocab_file = os.path.join(text_encoder, "vocab.txt")
    if os.path.isdir(text_encoder) and os.path.exists(vocab_file):
        return WordPieceTokenizer(load_vocab(vocab_file))
    if os.path.isfile(text_encoder):
        return WordPieceTokenizer(load_vocab(text_encoder))
    return WordPieceTokenizer(make_test_vocab())
