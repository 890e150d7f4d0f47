"""Per-layer metric eval_stage_s.encode: seconds a pass spent in the
encoders (encode_texts, encode_images), synchronised spans."""

from benchmark.metrics._read import span_per_pass


def read(ctx):
    return span_per_pass(ctx, "eval.encode")
