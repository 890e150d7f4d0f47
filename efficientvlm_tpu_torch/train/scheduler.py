"""Linear warm-up then linear decay (port of
efficientvlm_tpu/train/scheduler.py). warmup is a step count, or a fraction
of the total steps when it is a float below 1."""

from __future__ import annotations


def create_scheduler(*, lr: float, num_training_steps: int,
                     num_warmup_steps: float | int = 0):
    if isinstance(num_warmup_steps, float) and num_warmup_steps < 1:
        warmup = int(num_warmup_steps * num_training_steps)
    else:
        warmup = int(num_warmup_steps)

    def schedule(step: int) -> float:
        step = float(step)
        warm = step / max(1.0, warmup)
        decay = (num_training_steps - step) / max(1.0, num_training_steps - warmup)
        return lr * min(max(warm if step < warmup else decay, 0.0), 1.0)

    return schedule
