"""Port parity for the two bare attention cores: the plain versions behind
flash_attention and flash_attention_grouped against the JAX Pallas functions
(interpret mode off the TPU), on the CPU, at atol 2e-5 in f32 (the bar of
tests/test_pallas.py). Also the wrappers' calling convention (the
projection's strided view, unscaled q with `scale`, the output as a view of
[B,T,H,dh]), the plain mirror of the kernel's split-KV merge, the split
plan, and multi_head_attention(impl="fused") against JAX's. CPU tensors
never count a launch, and the grouped core never repeats K/V in memory."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from efficientvlm_tpu.ops import attention as JA
from efficientvlm_tpu.ops import pallas_attention as JP
from efficientvlm_tpu_torch.bridge import params_from_numpy
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


# --- the wrappers' calling convention: the projection's view, unscaled q ---

def _heads_view(x, h):
    """[B,T,H*dh] -> the [B,H,T,dh] view the projections hand the core."""
    b, t, a = x.shape
    return x.view(b, t, h, a // h).transpose(1, 2)


VIEW_CASES = {
    # name: (B, H, Tq, Tk, dh, bias kind, G)
    "decode_tq1_cache20": (3, 2, 1, 20, 32, "decode", 1),
    "prefill_tq4_cache20": (3, 2, 4, 20, 64, "decode", 1),
    "matrix_causal_padding": (2, 3, 6, 6, 32, "matrix", 1),
    "grouped_g3_tq1": (2, 2, 1, 77, 64, "per_group", 3),
    "grouped_g8_tq6": (2, 2, 6, 25, 32, "per_group", 8),
}


@pytest.mark.parametrize("name", sorted(VIEW_CASES))
def test_wrappers_take_views_and_scale(name):
    """q as the projection's strided [B,T,H,dh] view, unscaled, with scale:
    the same result as JAX's kernel fed q * scale, returned as a view of a
    contiguous [B,T,H,dh] tensor (merging the heads is then a view)."""
    b, h, tq, tk, dh, kind, g = VIEW_CASES[name]
    rng = np.random.default_rng(3)
    x = rng.standard_normal((b * g, tq, h * dh)).astype(np.float32)
    _, k, v = _qkv(rng, 1, b, h, 1, tk, dh)
    scale = dh ** -0.5
    q = _heads_view(_t(x), h)
    assert tq == 1 or not q.is_contiguous()  # (one row is contiguous either way)
    qs = np.ascontiguousarray(x.reshape(b * g, tq, h, dh).transpose(0, 2, 1, 3)) * scale
    if g == 1:
        bias = _bias(kind, rng, b, tq, tk)
        ref = JP.flash_attention(jnp.asarray(qs), jnp.asarray(k), jnp.asarray(v),
                                 bias=jnp.asarray(bias))
        out = TF.flash_attention(q, _t(k), _t(v), bias=_t(bias), scale=scale)
    else:
        bias = np.asarray(TA.make_attention_bias(_t(_key_mask(rng, b, tk))))
        ref = JP.flash_attention_grouped(jnp.asarray(qs), jnp.asarray(k), jnp.asarray(v),
                                         kv_groups=g, bias=jnp.asarray(bias))
        out = TF.flash_attention_grouped(q, _t(k), _t(v), kv_groups=g, bias=_t(bias),
                                         scale=scale)
    assert out.shape == (b * g, h, tq, dh) and out.transpose(1, 2).is_contiguous()
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)
    merged = out.transpose(1, 2).reshape(b * g, tq, h * dh)
    assert merged.data_ptr() == out.data_ptr()  # a view, no copy


def test_scale_rounds_like_the_callers_bf16_product():
    """In bf16 the kernel's q is bf16(q * scale): the plain twin rounds there too."""
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16) for x in _qkv(rng, 2, 2, 2, 3, 9, 32))
    scale = 32 ** -0.5
    np.testing.assert_array_equal(
        TF.flash_attention_plain(q, k, v, None, scale).float().numpy(),
        TF.flash_attention_plain(q * scale, k, v).float().numpy())


# --- the split-KV merge, in plain PyTorch ---

SPLITS = {
    # name: (B, H, Tq, Tk, splits, bias kind); every piece starts at a real key
    "ragged_last_piece": (2, 2, 1, 145, 3, "vector"),
    "tk_not_divisible": (2, 2, 4, 77, 5, "matrix"),
    "one_piece": (2, 2, 1, 40, 1, "vector"),
    "all_masked_piece": (2, 2, 1, 96, 3, "all_masked_piece"),
    "last_piece_only": (2, 2, 1, 96, 3, "last_piece_only"),
}


@pytest.mark.parametrize("name", sorted(SPLITS))
def test_split_combine_plain(name):
    """Per-piece partials merged in f32 equal the unsplit plain version at
    1e-6 and the JAX kernel at 2e-5; a piece whose keys are all -1e9 adds
    nothing."""
    b, h, tq, tk, splits, kind = SPLITS[name]
    rng = np.random.default_rng(5)
    q, k, v = _qkv(rng, b, b, h, tq, tk, dh=32)
    if kind in ("vector", "matrix"):
        bias = _bias(kind, rng, b, tq, tk)
    else:
        per = -(-tk // splits)
        m = np.ones((b, tk), np.float32)
        if kind == "all_masked_piece":
            m[:, per:2 * per] = 0.0  # the whole middle piece
        else:
            m[1] = 0.0
            m[1, tk - 1] = 1.0  # row 1's one key is in the last piece
        bias = np.asarray(TA.make_attention_bias(_t(m)))
    out = TF._split_combine_plain(_t(q), _t(k), _t(v), _t(bias), splits)
    whole = TF.flash_attention_plain(_t(q), _t(k), _t(v), _t(bias))
    np.testing.assert_allclose(out.numpy(), whole.numpy(), atol=1e-6, rtol=0)
    ref = JP.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             bias=jnp.asarray(bias))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


@pytest.mark.parametrize("pieces,tk,splits", [
    (192, 577, 5),     # a caption cross step: 16 images x 12 heads (x 3 beams folded)
    (768, 577, 5),     # 64 images: still too few to fill the card
    (2, 2000, 16),     # few (b, h) over many keys
    (2, 10000, 30),    # never more than 30 splits
    (192, 20, 1),      # the 20-slot self-attention cache
    (24576, 6, 1),     # answer scoring: plenty of (b, h)
    (9216, 25, 1),     # grouped answer scoring
    (3168, 577, 1),    # enough pieces to fill the card
], ids=["cross_step", "cross_step_b64", "long_tk", "max_splits", "self_cache",
        "vqa_self", "vqa_grouped", "full_card"])
def test_split_plan(pieces, tk, splits):
    keys = TF.split_keys(pieces, tk)
    assert -(-tk // keys) == splits and 1 <= keys <= tk


# --- multi_head_attention(impl="fused") on the CPU, against JAX's ---

def _mha_params(seed, d, heads, kv_width=None):
    p = jax.tree.map(np.asarray, JA.init_attention(jax.random.PRNGKey(seed), d, heads,
                                                   kv_width=kv_width))
    rng = np.random.default_rng(seed)
    for n in p:  # non-zero biases, so every bias add is checked
        p[n]["bias"] = rng.standard_normal(p[n]["bias"].shape).astype(np.float32) * 0.1
    return p


def test_fused_mha_decode_and_prefill_match_jax():
    """A 3-token prefill into an 8-slot cache, then two decode steps: the
    fused path (the bare core's view-and-scale call) equals JAX's
    multi_head_attention at every call."""
    d, heads, max_len = 64, 2, 8
    p = _mha_params(6, d, heads)
    tp = params_from_numpy(p, device="cpu")
    rng = np.random.default_rng(6)
    hz = rng.uniform(0.2, 1.0, heads).astype(np.float32)
    jc = JA.init_decode_cache(2, heads, max_len, d // heads)
    tc = TA.init_decode_cache(2, heads, max_len, d // heads)
    for t in (3, 1, 1):
        x = rng.standard_normal((2, t, d)).astype(np.float32)
        idx = tc["index"]
        ref, _, jc = JA.multi_head_attention(p, x, num_heads=heads, head_z=hz, cache=jc,
                                             bias=JA.decode_bias(max_len, idx, t))
        out, _, tc = TA.multi_head_attention(tp, _t(x), num_heads=heads, head_z=_t(hz),
                                             cache=tc, bias=TA.decode_bias(max_len, idx, t),
                                             impl="fused")
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=3e-5, rtol=0)


@pytest.mark.parametrize("kind", ["matrix_bias_self", "grouped_cross_precomputed",
                                  "cross_precomputed"])
def test_fused_mha_matches_jax(kind):
    d, heads = 64, 2
    rng = np.random.default_rng(7)
    if kind == "matrix_bias_self":  # the answer decoder's causal + padding self-attention
        p = _mha_params(7, d, heads)
        x = rng.standard_normal((3, 6, d)).astype(np.float32)
        mask = np.tril(np.ones((3, 6, 6), np.int32))
        mask[1, :, 4:] = 0
        ref, _, _ = JA.multi_head_attention(p, x, num_heads=heads,
                                            bias=JA.make_attention_bias(mask))
        out, _, _ = TA.multi_head_attention(params_from_numpy(p, device="cpu"), _t(x),
                                            num_heads=heads,
                                            bias=TA.make_attention_bias(_t(mask)), impl="fused")
    else:  # decode steps over image K/V projected once, shared by G rows
        g = 3 if kind.startswith("grouped") else 1
        p = _mha_params(8, d, heads, kv_width=48)
        enc = rng.standard_normal((2, 9, 48)).astype(np.float32)
        x = rng.standard_normal((2 * g, 1, d)).astype(np.float32)
        m = np.ones((2, 9), np.int32)
        m[1, 6:] = 0
        tp = params_from_numpy(p, device="cpu")
        ref, _, _ = JA.multi_head_attention(
            p, x, num_heads=heads, bias=JA.make_attention_bias(m), kv_groups=g,
            precomputed_kv=JA.project_kv(p, enc, num_heads=heads))
        out, _, _ = TA.multi_head_attention(
            tp, _t(x), num_heads=heads, bias=TA.make_attention_bias(_t(m)), kv_groups=g,
            precomputed_kv=TA.project_kv(tp, _t(enc), num_heads=heads), impl="fused")
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=3e-5, rtol=0)
