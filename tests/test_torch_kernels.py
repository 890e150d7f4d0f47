"""Port parity: the plain versions of the four ported kernels against the JAX
kernel functions (Pallas interpret mode off the TPU), on the CPU, at atol
3e-5 in f32. Widths are >= 128 because the JAX dispatchers only take their
kernels from one lane up."""

import jax
import numpy as np
import pytest
import torch

from efficientvlm_tpu.ops import attention as JA
from efficientvlm_tpu.ops import pallas_fused_mha as JF
from efficientvlm_tpu.ops.pallas_patch_embed import fused_patch_embed as j_patch_embed
from efficientvlm_tpu_torch.bridge import params_from_numpy
from efficientvlm_tpu_torch.ops import fused_mha as TF
from efficientvlm_tpu_torch.ops.patch_embed import fused_patch_embed as t_patch_embed

torch.set_num_threads(1)
ATOL = 3e-5
WRAPPERS = (t_patch_embed, TF.fused_self_attention, TF.fused_cross_attention,
            TF.fused_cross_attention_grouped)


@pytest.fixture(autouse=True)
def launch_counts_stay_zero():
    """CPU tensors run the plain versions: no wrapper counts a launch."""
    for w in WRAPPERS:
        w.launches = 0
    yield
    assert [w.launches for w in WRAPPERS] == [0, 0, 0, 0]


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _close(port, ref):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def _attn(seed, d, h, kv_width=None, a=None):
    p = jax.tree.map(np.asarray, JA.init_attention(jax.random.PRNGKey(seed), d, h,
                                                   kv_width=kv_width))
    rng = np.random.default_rng(seed)
    for n in p:  # non-zero biases, so every bias add is checked
        p[n]["bias"] = rng.standard_normal(p[n]["bias"].shape).astype(np.float32) * 0.1
    if a is not None:  # rectangular (pruned) projection width a < d
        for n in ("q", "k", "v"):
            p[n] = {"kernel": p[n]["kernel"][:, :a], "bias": p[n]["bias"][:a]}
        p["out"] = {"kernel": p["out"]["kernel"][:a], "bias": p["out"]["bias"]}
    return p


def _mask(b, s):
    m = np.ones((b, s), np.int32)
    m[-1, s - s // 3:] = 0  # masked key tail
    return m


def test_patch_embed_matches_jax():
    rng = np.random.default_rng(0)
    d, p, res = 128, 4, 16
    n = (res // p) ** 2
    params = {
        "patch_embed": {"kernel": rng.standard_normal((p, p, 3, d)).astype(np.float32) * 0.1},
        "class_embedding": rng.standard_normal(d).astype(np.float32),
        "pos_embed": {"embedding": rng.standard_normal((n + 1, d)).astype(np.float32)},
        "pre_ln": {"scale": rng.uniform(0.5, 1.5, d).astype(np.float32),
                   "bias": rng.standard_normal(d).astype(np.float32)},
    }
    images = rng.standard_normal((2, res, res, 3)).astype(np.float32)
    ref = j_patch_embed(params, images, patch_size=p, vision_width=d)
    out = t_patch_embed(params_from_numpy(params, device="cpu"), _t(images), patch_size=p)
    assert out.shape == (2, n + 1, d)
    _close(out, ref)


@pytest.mark.parametrize("heads,a", [(2, None), (2, 64)], ids=["two_heads", "one_head_rect"])
def test_self_attention_matches_jax(heads, a):
    rng = np.random.default_rng(1)
    d, t = 128, 13
    p = _attn(1, d, heads, a=a)
    nh = heads if a is None else a // (d // heads)
    x = rng.standard_normal((3, t, d)).astype(np.float32)
    mask = _mask(3, t)
    hz = rng.uniform(0.2, 1.0, nh).astype(np.float32)
    ref = JF.fused_self_attention(p, x, num_heads=nh, mask=mask, head_z=hz)
    out = TF.fused_self_attention(params_from_numpy(p, device="cpu"), _t(x), num_heads=nh,
                                  mask=_t(mask), head_z=_t(hz))
    _close(out, ref)


def test_cross_attention_matches_jax():
    rng = np.random.default_rng(2)
    d, de, t, s = 128, 192, 7, 19
    p = _attn(2, d, 2, kv_width=de)
    x = rng.standard_normal((3, t, d)).astype(np.float32)
    enc = rng.standard_normal((3, s, de)).astype(np.float32)
    mask = _mask(3, s)
    hz = np.asarray([0.3, 1.0], np.float32)
    ref = JF.fused_cross_attention(p, x, enc, num_heads=2, mask=mask, head_z=hz)
    out = TF.fused_cross_attention(params_from_numpy(p, device="cpu"), _t(x), _t(enc),
                                   num_heads=2, mask=_t(mask), head_z=_t(hz))
    _close(out, ref)


@pytest.mark.parametrize("with_ln", [False, True], ids=["no_ln", "ln_epilogue"])
def test_grouped_cross_attention_matches_jax(with_ln, monkeypatch):
    rng = np.random.default_rng(3)
    d, de, t, s, bk, g = 128, 192, 5, 19, 2, 3
    p = _attn(3, d, 2, kv_width=de)
    ln = {"scale": rng.uniform(0.5, 1.5, d).astype(np.float32),
          "bias": rng.standard_normal(d).astype(np.float32)} if with_ln else None
    x = rng.standard_normal((bk * g, t, d)).astype(np.float32)
    enc = rng.standard_normal((bk, s, de)).astype(np.float32)
    mask = _mask(bk, s)
    hz = np.asarray([0.5, 0.9], np.float32)
    ref = JF.fused_cross_attention_grouped(p, x, enc, num_heads=2, kv_groups=g, mask=mask,
                                           head_z=hz, ln_params=ln)

    tp = params_from_numpy(p, device="cpu")
    rows = {}
    real_linear = TF._linear_plain

    def spy(x_, p_, dt, out_f32=False):
        for name in ("q", "k", "v", "out"):
            if p_ is tp[name]:
                rows[name] = x_.shape[0]
        return real_linear(x_, p_, dt, out_f32)

    monkeypatch.setattr(TF, "_linear_plain", spy)
    out = TF.fused_cross_attention_grouped(
        tp, _t(x), _t(enc), num_heads=2, kv_groups=g, mask=_t(mask), head_z=_t(hz),
        ln_params=None if ln is None else params_from_numpy(ln, device="cpu"))
    _close(out, ref)
    # K/V are projected from the Bk image rows only, never the Bk*G query rows
    assert rows == {"q": bk * g, "k": bk, "v": bk, "out": bk * g}


def test_grouped_batch_mismatch_is_an_error():
    p = params_from_numpy(_attn(0, 128, 2, kv_width=192), device="cpu")
    with pytest.raises(ValueError, match="query batch 5 != 2 \\* kv batch 2"):
        TF.fused_cross_attention_grouped(p, torch.zeros(5, 4, 128), torch.zeros(2, 7, 192),
                                         num_heads=2, kv_groups=2)
