"""Faults planted in the reference put in the program's place, read on the
chip at a cell's size for the upper readings of its limits (tools/
limits.py --faults): a step that leaves its state unchanged reads 1 by the
comparison's measure and needs no run.

- half_batch: each step runs on the first half of its batch, the losses
  taken as the mean over those rows (its own hard negatives, drawn from the
  step's stream);
- altered: the ITM head's two logits swapped on the positive pairs (the
  first third of its rows) where it produces them.
"""

from __future__ import annotations

import contextlib

from benchmark.reference import xvlm_train as RT


class HalfBatch(RT.Trainer):
    def step(self, batch, g, teacher_neg, student_neg):
        half = {k: v[:v.shape[0] // 2] for k, v in batch.items()}
        return super().step(half, g, None, None)


def swap_positives(logits):
    """The ITM logits [3B, 2] with the B positive rows' two logits swapped."""
    import torch

    b = logits.shape[0] // 3
    return torch.cat([logits[:b].flip(-1), logits[b:]])


@contextlib.contextmanager
def altered_itm():
    orig = RT.mlp_head

    def head(num, hp, x):
        out = orig(num, hp, x)
        return swap_positives(out) if out.shape[-1] == 2 else out

    RT.mlp_head = head
    try:
        yield
    finally:
        RT.mlp_head = orig
