"""Per-layer metric mfu.pretrain: percent of the bf16 peak reached by the
FLOP the pretraining steps need (work/swin.pretrain_step_flops: the Swin
tower, the text, ITM, MLM and box passes, forward and backward, at the
batches' padded lengths) over the window."""

from benchmark.metrics._read import window_mfu


def read(ctx):
    return window_mfu(ctx)
