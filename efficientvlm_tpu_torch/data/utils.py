"""Text normalisation and JSONL files of the host data layer (the port's
copy of pre_question, pre_caption, write_jsonl and read_jsonl of
efficientvlm_tpu/data/utils.py, which follow the reference's
dataset/utils.py:17-57). The rank-sharded result merge (collect_result)
comes with distribution.
"""

from __future__ import annotations

import json
import os
import re
from typing import List

_PUNCT = r"([,.'!?\"()*#:;~])"


def pre_question(question: str, max_ques_words: int) -> str:
    """Lower-case, punctuation to spaces, '-' and '/' to spaces, trailing
    spaces dropped, cut to max_ques_words words."""
    question = re.sub(_PUNCT, " ", question.lower())
    question = question.replace("-", " ").replace("/", " ")
    question = question.rstrip(" ")
    words = question.split(" ")
    if len(words) > max_ques_words:
        question = " ".join(words[:max_ques_words])
    return question


def pre_caption(caption: str, max_words: int) -> str:
    """pre_question's normalisation, '<person>' -> 'person', runs of spaces
    collapsed, cut to max_words words; an empty result raises ValueError."""
    caption_raw = caption
    caption = re.sub(_PUNCT, " ", caption.lower())
    caption = caption.replace("-", " ").replace("/", " ").replace("<person>", "person")
    caption = re.sub(r"\s{2,}", " ", caption)
    caption = caption.rstrip("\n").strip(" ")
    words = caption.split(" ")
    if len(words) > max_words:
        caption = " ".join(words[:max_words])
    if not caption:
        raise ValueError(f"pre_caption yields invalid text (raw: {caption_raw})")
    return caption


def write_jsonl(result: List[dict], path: str) -> None:
    """One JSON object a line; the directory is made if missing."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        for r in result:
            f.write(json.dumps(r) + "\n")


def read_jsonl(path: str) -> List[dict]:
    """The objects of a JSONL file; blank lines are skipped."""
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]
