"""Port parity for the two bare attention cores: the plain versions behind
flash_attention and flash_attention_grouped against the JAX Pallas functions
(interpret mode off the TPU), on the CPU, at atol 2e-5 in f32 (the bar of
tests/test_pallas.py). CPU tensors never count a launch, and the grouped
core never repeats K/V in memory."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from efficientvlm_tpu.ops import pallas_attention as JP
from efficientvlm_tpu_torch.ops import attention as TA
from efficientvlm_tpu_torch.ops import flash_attention as TF

torch.set_num_threads(1)
ATOL = 2e-5
WRAPPERS = (TF.flash_attention, TF.flash_attention_grouped)


@pytest.fixture(autouse=True)
def launch_counts_stay_zero():
    """CPU tensors run the plain versions: no wrapper counts a launch."""
    for w in WRAPPERS:
        w.launches = 0
    yield
    assert [w.launches for w in WRAPPERS] == [0, 0]


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _qkv(rng, bq, bk, h, tq, tk, dh):
    q = rng.standard_normal((bq, h, tq, dh)).astype(np.float32) * dh ** -0.5
    k = rng.standard_normal((bk, h, tk, dh)).astype(np.float32)
    v = rng.standard_normal((bk, h, tk, dh)).astype(np.float32)
    return q, k, v


def _key_mask(rng, b, tk):
    m = (rng.uniform(size=(b, tk)) > 0.2).astype(np.float32)
    m[:, 0] = 1.0  # every row keeps a visible key
    return m


def _bias(kind, rng, b, tq, tk):
    if kind == "none":
        return None
    if kind == "vector":  # padding mask [B,1,1,Tk]
        return np.asarray(TA.make_attention_bias(_t(_key_mask(rng, b, tk))))
    if kind == "matrix":  # causal + padding [B,1,Tq,Tk]
        causal = TA.causal_bias(tq, tk, offset=tk - tq).numpy()
        return causal + np.asarray(TA.make_attention_bias(_t(_key_mask(rng, b, tk))))
    if kind == "decode":  # Tq rows over a cache of Tk slots, 7 of them written
        return TA.decode_bias(tk, 7 - tq, q_len=tq).numpy()
    raise ValueError(kind)


CASES = {
    # name: (B, H, Tq, Tk, dh, bias kind)
    "vector": (2, 4, 37, 53, 64, "vector"),
    "no_bias": (2, 4, 37, 53, 64, "none"),
    "matrix_causal_padding": (2, 4, 37, 53, 64, "matrix"),
    "decode_tq1_cache20": (3, 2, 1, 20, 32, "decode"),
    "prefill_tq4_cache20": (3, 2, 4, 20, 32, "decode"),
    "tq1_image_keys": (2, 2, 1, 77, 64, "vector"),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_flash_attention_matches_jax(name):
    b, h, tq, tk, dh, kind = CASES[name]
    rng = np.random.default_rng(0)
    q, k, v = _qkv(rng, b, b, h, tq, tk, dh)
    bias = _bias(kind, rng, b, tq, tk)
    ref = JP.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             bias=None if bias is None else jnp.asarray(bias))
    out = TF.flash_attention(_t(q), _t(k), _t(v), bias=None if bias is None else _t(bias))
    assert out.shape == (b, h, tq, dh)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


GROUPED = {
    # name: (Bk, G, H, Tq, S, dh, bias kind)
    "g16_tq24_s120": (2, 16, 2, 24, 120, 64, "per_group"),
    "caption_step_g3_tq1": (2, 3, 2, 1, 77, 64, "per_group"),
    "answer_scoring_g8_tq6": (2, 8, 2, 6, 25, 32, "shared"),
    "no_bias": (2, 3, 2, 5, 19, 32, "none"),
}


@pytest.mark.parametrize("name", sorted(GROUPED))
def test_flash_attention_grouped_matches_jax(name):
    bk, g, h, tq, s, dh, kind = GROUPED[name]
    rng = np.random.default_rng(1)
    q, k, v = _qkv(rng, bk * g, bk, h, tq, s, dh)
    bias = None
    if kind != "none":
        bias = np.asarray(TA.make_attention_bias(_t(_key_mask(rng, bk if kind == "per_group"
                                                               else 1, s))))
    ref = JP.flash_attention_grouped(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                     kv_groups=g,
                                     bias=None if bias is None else jnp.asarray(bias))
    out = TF.flash_attention_grouped(_t(q), _t(k), _t(v), kv_groups=g,
                                     bias=None if bias is None else _t(bias))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


class _Sizes(TorchDispatchMode):
    """Records the element count of every tensor an op produces."""

    def __init__(self):
        super().__init__()
        self.numels = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in out if isinstance(out, (tuple, list)) else (out,):
            if isinstance(t, torch.Tensor):
                self.numels.append(t.numel())
        return out


def test_grouped_core_never_repeats_kv():
    bk, g, h, tq, s, dh = 2, 3, 2, 5, 7, 16
    rng = np.random.default_rng(2)
    q, k, v = (_t(x) for x in _qkv(rng, bk * g, bk, h, tq, s, dh))
    with _Sizes() as sizes:
        out = TF.flash_attention_grouped(q, k, v, kv_groups=g)
    assert out.shape == q.shape
    repeated = g * k.numel()  # K or V expanded over the group
    assert repeated not in sizes.numels and max(sizes.numels) < repeated


def test_grouped_core_refuses_mismatches():
    q, k = torch.zeros(5, 2, 3, 32), torch.zeros(2, 2, 7, 32)
    with pytest.raises(ValueError, match="query batch 5 != 2 \\* kv batch 2"):
        TF.flash_attention_grouped(q, k, k, kv_groups=2)
    # a per-query-row bias has no kernel: it raises, it does not fall back
    q = torch.zeros(4, 2, 3, 32)
    with pytest.raises(ValueError, match="one key vector per group"):
        TF.flash_attention_grouped(q, k, k, kv_groups=2, bias=torch.zeros(4, 1, 1, 7))


def test_flash_attention_refuses_a_wrong_bias():
    q = torch.zeros(2, 2, 3, 32)
    k = torch.zeros(2, 2, 7, 32)
    with pytest.raises(ValueError, match="neither"):
        TF.flash_attention(q, k, k, bias=torch.zeros(2, 1, 5, 7))
