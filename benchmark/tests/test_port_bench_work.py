"""The work counters against hand counts at tiny shapes, and the shares
that they feed: a roofline or MFU share reads 100% at the least time and
less at any longer one, never more."""

import pytest

from benchmark import peaks
from benchmark.work import xvlm as W


def test_self_attention_call_by_hand():
    # 2 rows of 3 tokens, width 8, 2 heads of 4: Q, K, V, out 2*6*8*8 each;
    # QK^T and PV 2*2*2*3*3*4 each
    f, b = W.attention_call(batch=2, tq=3, s=3, d=8, de=8, heads=2, dh=4, self_attn=True)
    assert f == 4 * 2 * 6 * 8 * 8 + 2 * 2 * 2 * 2 * 3 * 3 * 4
    # x once (bf16), 4 bf16 kernels, 4 f32 biases, f32 key bias and gates, out
    assert b == 6 * 8 * 2 + 4 * 64 * 2 + (3 * 8 + 8) * 4 + 2 * 3 * 4 + 2 * 4 + 6 * 8 * 2


def test_cross_and_grouped_calls_by_hand():
    f, b = W.attention_call(batch=1, tq=2, s=5, d=8, de=4, heads=1, dh=8, self_attn=False,
                            ln=True, probs=True, vec_bytes=2)
    assert f == 2 * 2 * 8 * 8 + 2 * 2 * 5 * 4 * 8 + 2 * 2 * 1 * 2 * 5 * 8 + 2 * 2 * 8 * 8
    assert b == (2 * 8 * 2 + 5 * 4 * 2 + (64 + 2 * 32 + 64) * 2 + (3 * 8 + 8) * 2 + 5 * 4
                 + 2 + 2 * 8 * 2 + 2 * 8 * 2 + 1 * 2 * 5 * 4)
    calls = [dict(batch=1, tq=2, s=5, d=8, de=4, heads=1, dh=8, self_attn=False)] * 3
    assert W.calls_work(calls)[0] == 3 * W.attention_call(**calls[0])[0]


def test_eval_pass_flops_by_hand():
    cfg = {"vision": {"vision_width": 8, "patch_size": 2, "num_attention_heads": 2,
                      "image_res": 4},
           "text": {"hidden_size": 8, "num_attention_heads": 2, "encoder_width": 8},
           "embed_dim": 4}
    kept = {"vision_heads": [2], "vision_ffn": [16], "text_heads": [1], "text_ffn": [0],
            "cross_self_heads": [0], "cross_heads": [2], "cross_ffn": [4]}
    got = W.eval_pass_flops(cfg, kept, n_img=3, n_txt=5, text_len=2, pairs=7)
    s = 5  # 4 patches + CLS
    vit = 2 * 4 * 12 * 8 + 2 * 8 * 4 + 8 * s * 8 * 8 + 4 * s * s * 8 + 4 * s * 8 * 16
    txt = 2 * 8 * 4 + 8 * 2 * 8 * 4 + 4 * 2 * 2 * 4
    pair = 2 * 8 * 16 + 2 * 16 * 2 + 4 * 2 * 8 * 8 + 4 * 2 * s * 8 + 4 * 2 * 8 * 4
    assert got["vit"] == 3 * vit and got["text"] == 5 * txt
    assert got["fusion_pairs"] == 7 * pair and got["cross_kv"] == 3 * 4 * s * 8 * 8
    assert got["itc"] == 2 * 3 * 5 * 4
    assert got["total"] == sum(v for k, v in got.items() if k != "total")


@pytest.mark.parametrize("flops,nbytes", [(1e12, 1e6), (1e6, 1e12), (3e12, 3e9)])
def test_shares_never_pass_100(flops, nbytes):
    least = peaks.least_seconds(flops, nbytes)
    assert peaks.roofline_share(flops, nbytes, least) == pytest.approx(100.0)
    for slower in (1.01, 2.0, 10.0):
        assert peaks.roofline_share(flops, nbytes, least * slower) < 100.0
    assert peaks.mfu(flops, flops / peaks.PEAK_BF16_FLOPS) == pytest.approx(100.0)
    assert peaks.roofline_share(flops, nbytes, 0.0) is None


def test_counted_calls_match_the_model_of_a_pass():
    """At the cell's widths with no unit pruned, the calls a pass makes (the
    driver's model: ViT and text self-attention per batch, per chunk a
    fusion self and a cross call) count the work the FLOP model gives for
    the matrix products the calls hold."""
    d, s, t, dh = 768, 577, 40, 64
    vit = W.attention_call(batch=24, tq=s, s=s, d=d, de=d, heads=12, dh=dh, self_attn=True)[0]
    assert vit == 24 * (8 * s * d * d + 4 * s * s * d)
    t2i = W.attention_call(batch=1024, tq=t, s=s, d=d, de=d, heads=12, dh=dh,
                           self_attn=False)[0]
    # the t2i call projects each pair's image again: 1024 K/V projections
    assert t2i == 1024 * (4 * t * d * d + 4 * s * d * d + 4 * t * s * d)
