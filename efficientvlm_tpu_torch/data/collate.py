"""Batch collation of the VQA fine-tune (the port's own copy of vqa_collate
in efficientvlm_tpu/data/datasets.py; numpy only).

A VQA sample is (image, question, answers, weights): a question has 1-10
answers, each with a weight. The model decodes every answer over its
question's states, so the batch flattens the answer lists and gives each
answer row the index of its question (k_index), the gather
XVLMForVQA.forward_train takes, instead of the reference's loop that
repeats each question's states once per answer.
"""

from __future__ import annotations

import numpy as np


def vqa_collate(samples, *, pad_multiple: int = 8, n_shards: int = 1):
    """samples: [(image, question, answers list, weights list)] -> (images
    stacked, questions list, answers list, weights [A] f32, k_index [A]
    int64). The answer count A is padded up to a multiple of pad_multiple
    with weight-0 copies of the first answer (k_index 0), so the steps see
    a few answer counts, not one per batch.

    With n_shards > 1 the questions split into n_shards contiguous groups;
    each group's answers are flattened and padded to one common length
    (the padded count of the longest group), and its k_index counts from 0
    within the group, so that splitting every array into n_shards equal
    parts along its first axis gives each part a self-consistent block."""
    images, questions, answer_lists, weight_lists = zip(*samples)
    if len(samples) % n_shards:
        raise ValueError(f"{len(samples)} questions do not split into {n_shards} shards")
    per = len(samples) // n_shards
    groups = []
    for s in range(n_shards):
        answers, weights, k_index = [], [], []
        for qi in range(per):
            answers += list(answer_lists[s * per + qi])
            weights += list(weight_lists[s * per + qi])
            k_index += [qi] * len(answer_lists[s * per + qi])
        groups.append((answers, weights, k_index))
    length = max(len(g[0]) for g in groups)
    if pad_multiple > 1:
        length += (-length) % pad_multiple
    answers, weights, k_index = [], [], []
    for ans, ws, ks in groups:
        pad = length - len(ans)
        answers += ans + [ans[0]] * pad
        weights += ws + [0.0] * pad
        k_index += ks + [0] * pad
    return (np.stack(images), list(questions), answers, np.asarray(weights, np.float32),
            np.asarray(k_index, np.int64))
