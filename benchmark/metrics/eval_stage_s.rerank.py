"""Per-layer metric eval_stage_s.rerank: seconds a pass spent in
retrieval_scores (ITC shortlist and ITM rerank), synchronised spans."""

from benchmark.metrics._read import span_per_pass


def read(ctx):
    return span_per_pass(ctx, "eval.rerank")
