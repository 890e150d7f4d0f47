"""Knowledge-distillation losses and the teacher -> student layer map (port
of efficientvlm_tpu/train/distill.py).

- get_cor_teacher: hidden-state lists (L + 1 entries) map teacher[i * block]
  with block = (T - 1) / (S - 1); attention lists (L entries) map the block
  ends teacher[i * block + block - 1];
- kd_loss: MSE over matched lists; attention maps are scaled by their last
  dim and filtered at <= -1e2 (a no-op on probabilities, kept for parity);
  the image hidden list drops its 7th entry; paired entries must have one
  shape (no broadcast); under tensor parallelism each rank holds its heads'
  maps, and a map's MSE is the group's mean (sharding.tp_mean);
- soft_cross_entropy: KL(batchmean) of the teacher's probabilities against
  the student's log-probabilities.
Teacher tensors enter detached.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from ..parallel.sharding import tp_mean


def get_cor_teacher(teacher_reps: Sequence, student_reps: Sequence, *,
                    is_attn: bool = False) -> List:
    t, s = len(teacher_reps), len(student_reps)
    if is_attn:
        if t % s:
            raise ValueError(f"{t} teacher attention maps do not map onto {s}")
        block = t // s
        return [teacher_reps[i * block + block - 1] for i in range(s)]
    if (t - 1) % (s - 1):
        raise ValueError(f"{t} teacher hidden states do not map onto {s}")
    block = (t - 1) // (s - 1)
    return [teacher_reps[i * block] for i in range(s)]


def _mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a.float() - b.float()).square().mean()


def kd_loss(student_reps: Sequence[torch.Tensor], teacher_reps: Sequence[torch.Tensor], *,
            is_attn: bool = False, is_img: bool = False) -> torch.Tensor:
    total = 0.0
    for layer, (s, t) in enumerate(zip(student_reps, teacher_reps)):
        if s.shape != t.shape:  # no broadcast: a region tap meets its own depth
            raise ValueError(f"KD entry {layer}: student {tuple(s.shape)} != teacher "
                             f"{tuple(t.shape)}")
        if is_attn:
            s = torch.where(s <= -1e2, 0.0, s)
            t = torch.where(t <= -1e2, 0.0, t)
            total = total + tp_mean(_mse(s, t)) * s.shape[-1]
        elif is_img and layer == 6:
            continue  # the reference drops the 7th image hidden entry
        else:
            total = total + _mse(s, t)
    return total


def subset_taps(taps: Sequence, n_student: int, *, is_attn: bool = False) -> list:
    """The student-mapped teacher taps only (get_cor_teacher's map), so the
    unread ones can be dropped right after the teacher forward; kd_list over
    the subset maps one to one."""
    want = n_student if is_attn else n_student + 1
    if len(taps) == want:
        return list(taps)
    return get_cor_teacher(list(taps), [None] * want, is_attn=is_attn)


def kd_list(student: Sequence[torch.Tensor], teacher: Sequence[torch.Tensor], *,
            is_attn: bool = False, is_img: bool = False) -> torch.Tensor:
    t = get_cor_teacher([x.detach() for x in teacher], student, is_attn=is_attn)
    return kd_loss(student, t, is_attn=is_attn, is_img=is_img)


def soft_cross_entropy(predicts: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """KLDivLoss(batchmean)(log_softmax(student), softmax(teacher)): summed
    over classes, averaged over rows."""
    p = predicts.reshape(-1, predicts.shape[-1]).float()
    t = targets.detach().reshape(-1, targets.shape[-1]).float()
    student_logp = torch.log_softmax(p, dim=-1)
    teacher_prob = torch.softmax(t, dim=-1)
    teacher_logp = torch.log(teacher_prob.clamp(min=1e-12))
    return (teacher_prob * (teacher_logp - student_logp)).sum(-1).mean()
