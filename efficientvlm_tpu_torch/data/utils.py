"""Text normalisation and JSONL files of the host data layer (the port's
copy of pre_question, pre_caption, write_jsonl and read_jsonl of
efficientvlm_tpu/data/utils.py, which follow the reference's
dataset/utils.py:17-57), and collect_result (dataset/utils.py:104-141): the
per-rank file, a barrier, rank 0's merge of every rank's file, the
de-duplication, the saved result and the hdfs:// copies.
"""

from __future__ import annotations

import json
import os
import re
from typing import List, Optional, Union

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


def collect_result(result: List[dict], filename: str, local_wdir: str, *, hdfs_wdir: str = "",
                   rank: Optional[int] = None, world_size: Optional[int] = None,
                   remove_duplicate: str = "",
                   save_result: bool = False) -> Union[List[dict], str, None]:
    """The evaluation's records through the reference's merge
    (efficientvlm_tpu/data/utils.py:65-120): this rank's records to
    <local_wdir>/<filename>_rank<r>.json (JSONL), copied to hdfs_wdir when
    given; a barrier over the processes (utils/dist); then rank 0 reads
    every rank's file back (from hdfs_wdir for the other ranks' when given:
    hosts without a shared filesystem) and merges them in rank order,
    keeping the first record of each remove_duplicate key. Rank 0 returns
    the merged list, or with save_result the path of <filename>.json (the
    merged list as one JSON array, copied to hdfs_wdir too); the other ranks
    return None after a second barrier. Above one process it needs the
    process group (init_distributed_mode); without one it raises."""
    from ..utils.dist import barrier, get_rank, get_world_size, is_initialized
    from ..utils.io import hcopy

    rank = get_rank() if rank is None else rank
    world_size = get_world_size() if world_size is None else world_size
    if world_size > 1 and not is_initialized():
        raise RuntimeError(f"collect_result over {world_size} processes needs their process "
                           "group: launch with torchrun (utils/dist.init_distributed_mode)")
    remote = hdfs_wdir.rstrip("/")
    rank_file = os.path.join(local_wdir, f"{filename}_rank{rank}.json")
    write_jsonl(result, rank_file)
    if remote:
        hcopy(rank_file, f"{remote}/{filename}_rank{rank}.json")
    barrier()
    if rank != 0:
        barrier()
        return None
    merged: List[dict] = []
    for r in range(world_size):
        path = os.path.join(local_wdir, f"{filename}_rank{r}.json")
        if remote and r != rank:
            hcopy(f"{remote}/{filename}_rank{r}.json", path)
        merged += read_jsonl(path)
    if remove_duplicate:
        seen, kept = set(), []
        for res in merged:
            if res[remove_duplicate] not in seen:
                seen.add(res[remove_duplicate])
                kept.append(res)
        merged = kept
    out: Union[List[dict], str] = merged
    if save_result:
        out = os.path.join(local_wdir, f"{filename}.json")
        with open(out, "w") as f:
            json.dump(merged, f, ensure_ascii=False, indent=4)
        if remote:
            hcopy(out, f"{remote}/{filename}.json")
    barrier()
    return out
