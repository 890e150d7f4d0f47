"""Per-layer metric fused_mha_roofline.train: percent of the roofline
reached by the calls into csrc/fused_mha.cu in the profiled steps."""

from benchmark.metrics._read import fused_mha_roofline


def read(ctx):
    return fused_mha_roofline(ctx)
