"""What the per-layer readers share: the span means, the traced slice's
idle share, a kernel file's roofline share and the whole window's MFU."""

from __future__ import annotations

from benchmark import peaks
from benchmark import trace as T
from benchmark.work import xvlm as W

FUSED_MHA_SPAN = "evlm.fused_attention"


def span_per_pass(ctx, name: str):
    """The seconds of span `name` over the window, per pass spanned."""
    vals, passes = ctx.spans.get(name), ctx.layer.get("spanned_passes")
    return sum(vals) / passes if vals and passes else None


def idle_share(ctx):
    """Percent of the traced slice with no device op running: the slice
    traced with the device's activity alone where there is one."""
    s = ctx.layer.get("device_slice") or ctx.layer.get("trace_summary")
    if not s or s["window_s"] <= 0 or s["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])


def fused_mha_roofline(ctx):
    calls, tr = ctx.layer.get("fused_calls"), ctx.layer.get("trace")
    if not calls or tr is None:
        return None
    flops, nbytes = W.calls_work(calls)
    return peaks.roofline_share(flops, nbytes, T.device_seconds_under(tr, FUSED_MHA_SPAN))


def window_mfu(ctx):
    return peaks.mfu(ctx.layer.get("mfu_flops", 0.0), ctx.layer.get("window_s"))


def launches_per_step(ctx):
    tr, steps = ctx.layer.get("trace"), ctx.layer.get("steps_profiled")
    if tr is None or not steps:
        return None
    lo, hi = tr.window
    kernels = [d for d in tr.device if lo <= d[1] < hi and not d[0].startswith("Memcpy")
               and not d[0].startswith("Memset")]
    return len(kernels) / steps if kernels else None
