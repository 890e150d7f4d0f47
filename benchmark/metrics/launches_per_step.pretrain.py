"""Per-layer metric launches_per_step.pretrain: CUDA kernels launched a
step in the profiled steps."""

from benchmark.metrics._read import launches_per_step


def read(ctx):
    return launches_per_step(ctx)
