"""Per-layer metric mfu.eval: percent of the bf16 peak reached by the FLOP
the passes need over the window."""

from benchmark.metrics._read import window_mfu


def read(ctx):
    return window_mfu(ctx)
