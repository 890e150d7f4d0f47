"""Sharded JSONL streaming reader (the port's copy of
efficientvlm_tpu/data/jsonl.py, after the reference's
DistLineReadingDataset, dataset/dist_dataset.py:19-95): the file list is
split contiguously by rank, then by worker; files are shuffled per epoch
from a seed; the stream may repeat forever; a broken line is skipped with a
message. The cursor (epoch, file index, line index) resumes a stream where
it stopped (state_dict / load_state_dict).
"""

from __future__ import annotations

import glob
import json
import os
from typing import Iterator, List

import numpy as np


def split_shard(data: List[str], shard_idx: int, shard_size: int) -> List[str]:
    """The shard_idx-th of shard_size contiguous parts of data; fewer items
    than parts raises RuntimeError."""
    num = len(data)
    if num < shard_size:
        raise RuntimeError(f"num:{num} < shard_size:{shard_size}")
    return data[(num * shard_idx) // shard_size:(num * (shard_idx + 1)) // shard_size]


def list_data_files(paths) -> List[str]:
    """Directories, files and glob patterns -> a sorted file list."""
    if isinstance(paths, str):
        paths = [paths]
    files: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            files.extend(sorted(glob.glob(os.path.join(p, "*"))))
        elif os.path.isfile(p):
            files.append(p)
        else:
            files.extend(sorted(glob.glob(p)))
    return sorted(files)


class ShardedJsonlDataset:
    """Iterates the JSON objects of this rank's and worker's files."""

    def __init__(self, data_paths, *, rank: int = 0, world_size: int = 1, num_workers: int = 1,
                 worker_idx: int = 0, shuffle: bool = True, repeat: bool = False,
                 seed: int = 42):
        self.files = list_data_files(data_paths)
        if not self.files:
            raise FileNotFoundError(f"no data files under {data_paths}")
        self.rank, self.world_size = rank, world_size
        self.num_workers, self.worker_idx = num_workers, worker_idx
        self.shuffle, self.repeat, self.seed = shuffle, repeat, seed
        self.epoch = 0
        self._cursor = (0, 0)  # (file index within the shard, next line)

    def shard_files(self, epoch: int) -> List[str]:
        files = list(self.files)
        if self.shuffle:
            np.random.default_rng(self.seed + epoch).shuffle(files)
        files = split_shard(files, self.rank, self.world_size)
        if self.num_workers > 1:
            files = split_shard(files, self.worker_idx, self.num_workers)
        return files

    def state_dict(self) -> dict:
        return {"epoch": self.epoch, "cursor": list(self._cursor)}

    def load_state_dict(self, state: dict) -> None:
        self.epoch = state["epoch"]
        self._cursor = tuple(state["cursor"])

    def __iter__(self) -> Iterator[dict]:
        while True:
            files = self.shard_files(self.epoch)
            start_file, start_line = self._cursor
            for fi in range(start_file, len(files)):
                with open(files[fi]) as f:
                    for li, line in enumerate(f):
                        if fi == start_file and li < start_line:
                            continue
                        self._cursor = (fi, li + 1)
                        try:
                            record = json.loads(line)
                        except json.JSONDecodeError as e:
                            print(f"### skipping broken line in {files[fi]}: {e}")
                            continue
                        yield record
                self._cursor = (fi + 1, 0)
            self.epoch += 1
            self._cursor = (0, 0)
            if not self.repeat:
                return
