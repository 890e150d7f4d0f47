"""Per-layer metric swin_attn_roofline.pretrain: percent of the roofline
reached by the Swin blocks' window-attention cores in the profiled steps:
the least time of their forward work (work/swin.window_attention_work:
Q K^T and P.V FLOP at 989 TFLOP/s, or q, k, v, bias, mask and context
bytes at 3.35 TB/s) over the device time launched under the program's
span evlm.swin.attention. None where the program has no such span."""

from benchmark import peaks
from benchmark import trace as T

SPAN = "evlm.swin.attention"


def read(ctx):
    work, tr = ctx.layer.get("swin_attention_work"), ctx.layer.get("trace")
    if not work or tr is None:
        return None
    return peaks.roofline_share(work["flops"], work["bytes"], T.device_seconds_under(tr, SPAN))
