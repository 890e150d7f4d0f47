"""The FFN sublayer op (ops/fused_ffn.py) on the CPU, at tiny widths: the
zero-padded weights it prepares compute the same function as the unpadded
ones, the prepared copies are reused until their source changes, the rule
that sends a call to the plain path names each excluded case, and a CPU
call runs the layer's plain path and counts it. The kernels themselves are
held to fused_ffn_plain on the card (tests/test_torch_cuda.py)."""

import gc

import pytest
import torch

from efficientvlm_tpu_torch.kernels import bindings as K
from efficientvlm_tpu_torch.ops import fused_ffn as FF
from efficientvlm_tpu_torch.ops.basic import ACT2FN, dense, layer_norm

torch.set_num_threads(1)
D, I, EPS = 128, 13, 1e-12  # D fits gemm_ln_fits; I pads to 64


def _layer(d=D, i=I, seed=0, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    r = lambda *s, std=1.0, mean=0.0: (torch.randn(s, generator=g) * std + mean).to(dtype)  # noqa: E731
    return {"intermediate": {"kernel": r(d, i, std=d ** -0.5), "bias": r(i, std=0.5)},
            "output": {"kernel": r(i, d, std=i ** -0.5), "bias": r(d, std=0.5)},
            "output_ln": {"scale": r(d, mean=1.0, std=0.1), "bias": r(d, std=0.1)}}


def _h(rows=7, d=D, seed=1):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(1, rows, d, generator=g).to(torch.bfloat16)


def _ulps(got, want):
    """The largest difference in bf16 ulps at the reference's largest magnitude."""
    got, want = got.float(), want.float()
    return ((got - want).abs().max() / (2 ** -8 * want.abs().max())).item()


@pytest.mark.parametrize("act", sorted(set(K.ACTIVATIONS) - {"none"}))
def test_padded_weights_compute_the_same_ffn(act):
    """The prepared weights (I zero-padded to a multiple of 64) give the
    unpadded weights' output on the kernels' plain twin, and that output is
    the layer's plain path within its bf16 rounding of the product."""
    lp = _layer()
    x = _h()[0]
    w1, b1, w2 = FF.prepared(lp["intermediate"], lp["output"])
    assert (w1.shape, b1.shape, w2.shape) == ((D, 64), (64,), (64, D))
    assert (w1.dtype, b1.dtype, w2.dtype) == (torch.bfloat16, torch.float32, torch.bfloat16)
    assert not w1[:, I:].any() and not b1[I:].any() and not w2[I:].any()
    assert ACT2FN[act](torch.zeros(1)).item() == 0.0  # a padded unit adds nothing
    ln, b2 = lp["output_ln"], lp["output"]["bias"]
    padded = FF.fused_ffn_plain(x, w1, b1, w2, b2, ln["scale"], ln["bias"], EPS, act=act)
    unpadded = FF.fused_ffn_plain(x, lp["intermediate"]["kernel"].to(torch.bfloat16),
                                  lp["intermediate"]["bias"],
                                  lp["output"]["kernel"].to(torch.bfloat16), b2, ln["scale"],
                                  ln["bias"], EPS, act=act)
    assert padded.dtype == torch.bfloat16
    assert _ulps(padded, unpadded) <= 1
    inter = ACT2FN[act](dense(lp["intermediate"], x, dtype=torch.bfloat16))
    layer = layer_norm(ln, x + dense(lp["output"], inter, dtype=torch.bfloat16), eps=EPS)
    assert _ulps(padded, layer) <= 4


def test_aligned_bf16_weights_are_used_as_they_are():
    """At a width that is a multiple of 64, bf16 kernels are neither padded
    nor copied, and a stored bias is passed as stored."""
    lp = _layer(i=128, dtype=torch.bfloat16)
    w1, b1, w2 = FF.prepared(lp["intermediate"], lp["output"])
    assert w1 is lp["intermediate"]["kernel"] and w2 is lp["output"]["kernel"]
    assert b1 is lp["intermediate"]["bias"]


def test_prepared_copies_are_reused_until_the_source_changes():
    lp = _layer()
    first = FF.prepared(lp["intermediate"], lp["output"])
    again = FF.prepared(lp["intermediate"], lp["output"])
    assert all(a is b for a, b in zip(first, again))
    lp["intermediate"]["kernel"].add_(1.0)  # an in-place update of W1 only
    w1, b1, w2 = FF.prepared(lp["intermediate"], lp["output"])
    assert w1 is not first[0] and b1 is first[1] and w2 is first[2]
    assert torch.equal(w1[:, :I], lp["intermediate"]["kernel"].to(torch.bfloat16))
    lp["output"]["kernel"] = lp["output"]["kernel"] * 2  # a new tensor: a copy of its own
    w2_new = FF.prepared(lp["intermediate"], lp["output"])[2]
    assert w2_new is not w2
    assert torch.equal(w2_new[:I], lp["output"]["kernel"].to(torch.bfloat16))


def test_a_copy_lives_no_longer_than_its_source():
    lp = _layer(seed=3)
    FF.prepared(lp["intermediate"], lp["output"])
    src = lp["intermediate"]["kernel"]
    assert src in FF._W1
    n = len(FF._W1)
    del lp, src
    gc.collect()
    assert len(FF._W1) == n - 1


def test_inference_tensors_are_copied_at_every_call():
    """An inference tensor keeps no version counter, so no copy of it is kept."""
    with torch.inference_mode():
        lp = _layer(seed=4)
    n = len(FF._W1)
    a = FF.prepared(lp["intermediate"], lp["output"])[0]
    b = FF.prepared(lp["intermediate"], lp["output"])[0]
    assert a is not b and torch.equal(a, b) and len(FF._W1) == n


EXCLUDED = {
    "impl": dict(impl="plain"),
    "train": dict(train=True),
    "mlp_z": dict(mlp_z=torch.ones(I)),
    "activation": dict(act="relu"),
    "dtype": dict(dtype=torch.float32),
    "width": dict(h=_h(d=12)),
}


@pytest.mark.parametrize("reason", sorted(EXCLUDED) + ["tensor_parallel", "quantized",
                                                        "graded", "f32_input", "device"])
def test_plain_reason_names_each_excluded_case(reason, monkeypatch):
    """Each excluded case takes the plain path for its own reason; the CPU
    tensor (last in the rule) is the only reason left for a call that meets
    the rest of it."""
    lp, kw = _layer(), dict(act="gelu", h=_h(), dtype=torch.bfloat16)
    kw.update(EXCLUDED.get(reason, {}))
    if reason == "tensor_parallel":
        monkeypatch.setattr(FF, "tp_group", lambda: object())
    elif reason == "quantized":
        lp["output"] = {"kernel_q8": lp["output"]["kernel"].to(torch.int8),
                        "scale": torch.ones(D)}
    elif reason == "graded":
        lp["output_ln"]["scale"].requires_grad_(True)
    elif reason == "f32_input":
        kw["h"] = kw["h"].float()
    h = kw.pop("h")
    want = "dtype" if reason == "f32_input" else reason
    assert FF.plain_reason(lp, h, **kw) == want
    if reason == "graded":
        with torch.no_grad():
            assert FF.plain_reason(lp, h, **kw) == "device"


def test_cpu_calls_run_the_layers_plain_path_and_count_it():
    lp, h = _layer(), _h()
    before = dict(FF.ffn_calls)
    out = FF.ffn_sublayer(lp, h, act="gelu", eps=EPS, dtype=torch.bfloat16)
    inter = ACT2FN["gelu"](dense(lp["intermediate"], h, dtype=torch.bfloat16))
    want = layer_norm(lp["output_ln"], h + dense(lp["output"], inter, dtype=torch.bfloat16),
                      eps=EPS)
    assert torch.equal(out, want)
    assert FF.ffn_calls == {"fused": before["fused"], "plain": before["plain"] + 1}


def test_the_fused_form_gets_the_prepared_weights(monkeypatch):
    """The call the fused form makes, with the binding stood in for by its
    plain twin: the input as rows, the padded weights, the vectors as
    stored; the output back in h's shape, counted as fused."""
    lp, h = _layer(), _h(rows=5)
    seen = {}

    def fake(x, w1, b1, w2, b2, gamma, beta, eps, *, act):
        seen.update(x=x, w1=w1, act=act, eps=eps)
        return FF.fused_ffn_plain(x, w1, b1, w2, b2, gamma, beta, eps, act=act)

    monkeypatch.setattr(FF, "plain_reason", lambda *a, **k: None)
    monkeypatch.setattr(K, "fused_ffn", fake)
    before = dict(FF.ffn_calls)
    out = FF.ffn_sublayer(lp, h, act="gelu", eps=EPS, dtype=torch.bfloat16)
    assert out.shape == h.shape and out.dtype == torch.bfloat16
    assert seen["x"].shape == (5, D) and seen["w1"].shape == (D, 64)
    assert (seen["act"], seen["eps"]) == ("gelu", EPS)
    assert FF.ffn_calls == {"fused": before["fused"] + 1, "plain": before["plain"]}
    plain = FF.ffn_sublayer(lp, h, act="gelu", eps=EPS, dtype=torch.bfloat16,
                            impl="plain")
    assert _ulps(out, plain) <= 4


@pytest.mark.parametrize("act", sorted(set(ACT2FN) - set(K.ACTIVATIONS)))
def test_activations_without_an_epilogue_take_the_plain_path(act):
    """gemm_bias's epilogue applies BERT's GELU only: a layer with another
    activation of ops/basic.ACT2FN runs the plain path, and its output is
    that activation's."""
    lp, h = _layer(), _h()
    assert FF.plain_reason(lp, h, act=act, dtype=torch.bfloat16) == "activation"
    out = FF.ffn_sublayer(lp, h, act=act, eps=EPS, dtype=torch.bfloat16)
    inter = ACT2FN[act](dense(lp["intermediate"], h, dtype=torch.bfloat16))
    want = layer_norm(lp["output_ln"], h + dense(lp["output"], inter, dtype=torch.bfloat16),
                      eps=EPS)
    assert torch.equal(out, want)


@pytest.mark.parametrize("d", [768, 1024, 64, 200, 1152])
def test_width_rule_is_gemm_ln_s(d):
    """The fused form takes the hidden widths gemm_ln normalises in its
    epilogue (multiples of 128 up to 1,024); the others run the plain path."""
    lp = _layer(d=d)
    reason = FF.plain_reason(lp, _h(d=d), act="gelu", dtype=torch.bfloat16)
    assert reason == ("device" if K.gemm_ln_fits(d) else "width")
