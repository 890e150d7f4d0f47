"""Port parity: basic ops and plain multi-head attention against the JAX
package, on the CPU, at atol 3e-5 in f32 (the bar of tests/test_fused_mha.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficientvlm_tpu import config as jcfg
from efficientvlm_tpu.ops import attention as JA
from efficientvlm_tpu.ops import basic as JB
from efficientvlm_tpu_torch import config as tcfg
from efficientvlm_tpu_torch.bridge import params_from_numpy
from efficientvlm_tpu_torch.ops import attention as TA
from efficientvlm_tpu_torch.ops import basic as TB

torch.set_num_threads(1)
ATOL = 3e-5


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _close(port, ref, atol=ATOL):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), atol=atol, rtol=0)


@pytest.mark.parametrize("eps", [1e-5, 1e-12])
def test_basic_ops_match_jax(eps):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 16)).astype(np.float32)
    ln = {"scale": rng.standard_normal(16).astype(np.float32),
          "bias": rng.standard_normal(16).astype(np.float32)}
    dp = {"kernel": rng.standard_normal((16, 8)).astype(np.float32),
          "bias": rng.standard_normal(8).astype(np.float32)}
    emb = {"embedding": rng.standard_normal((10, 16)).astype(np.float32)}
    ids = rng.integers(0, 10, (3, 5))
    tln, tdp, temb = (params_from_numpy(p, device="cpu") for p in (ln, dp, emb))

    _close(TB.layer_norm(tln, _t(x), eps=eps), JB.layer_norm(ln, x, eps=eps))
    _close(TB.dense(tdp, _t(x)), JB.dense(dp, x))
    _close(TB.gelu(_t(x)), JB.gelu(x))
    _close(TB.quick_gelu(_t(x)), JB.quick_gelu(x))
    _close(TB.embedding_lookup(temb, _t(ids)), JB.embedding_lookup(emb, ids))


def test_configs_match_jax():
    assert tcfg.VisionConfig.DEFAULTS == jcfg.VisionConfig.DEFAULTS
    assert tcfg.TextConfig.DEFAULTS == jcfg.TextConfig.DEFAULTS
    assert tcfg.TextConfig.create(num_hidden_layers=6)["fusion_layer"] == 3
    assert tcfg.VisionConfig.create(image_res=384).num_patches == 576


def _attn_params(seed, d, h, kv_width=None, a=None):
    """JAX init_attention params as numpy; `a` < d slices a rectangular
    (pruned) projection width."""
    p = jax.tree.map(np.asarray, JA.init_attention(jax.random.PRNGKey(seed), d, h,
                                                   kv_width=kv_width))
    if a is not None:
        for n in ("q", "k", "v"):
            p[n] = {"kernel": p[n]["kernel"][:, :a], "bias": p[n]["bias"][:a]}
        p["out"] = {"kernel": p["out"]["kernel"][:a], "bias": p["out"]["bias"]}
    return p


def _mask(b, t):
    m = np.ones((b, t), np.int32)
    m[-1, t // 2:] = 0  # a masked key tail
    return m


CASES = {
    # name: (d, heads, kv_width, a, tq, tk, kv_groups, gates, output_probs)
    "self_mask_gates": (32, 4, None, None, 7, 7, 1, True, True),
    "self_rectangular": (32, 2, None, 16, 7, 7, 1, False, False),
    "cross": (32, 2, 24, None, 5, 9, 1, True, True),
    "grouped": (32, 2, 24, None, 5, 9, 3, True, True),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_multi_head_attention_matches_jax(name):
    d, h, kvw, a, tq, tk, g, gates, probs = CASES[name]
    rng = np.random.default_rng(1)
    p = _attn_params(2, d, h, kv_width=kvw, a=a)
    heads = h if a is None else a // (d // h)
    bk = 2
    xq = rng.standard_normal((bk * g, tq, d)).astype(np.float32)
    cross = kvw is not None
    xkv = rng.standard_normal((bk, tk, kvw)).astype(np.float32) if cross else None
    mask = _mask(bk if cross else bk * g, tk)
    hz = rng.uniform(0.2, 1.0, heads).astype(np.float32) if gates else None
    hlz = np.float32(0.7) if gates else None

    ref, ref_p, _ = JA.multi_head_attention(
        p, xq, xkv, num_heads=heads, bias=JA.make_attention_bias(mask), head_z=hz,
        head_layer_z=hlz, output_probs=probs, kv_groups=g)
    out, out_p, _ = TA.multi_head_attention(
        params_from_numpy(p, device="cpu"), _t(xq), None if xkv is None else _t(xkv),
        num_heads=heads, bias=TA.make_attention_bias(_t(mask)),
        head_z=None if hz is None else _t(hz), head_layer_z=hlz, output_probs=probs,
        kv_groups=g)
    _close(out, ref)
    if probs:
        _close(out_p, ref_p)
    else:
        assert out_p is None and ref_p is None


def test_grouped_batch_mismatch_is_loud():
    p = params_from_numpy(_attn_params(0, 32, 2, kv_width=24), device="cpu")
    xq, xkv = torch.zeros(6, 5, 32), torch.zeros(2, 9, 24)
    with pytest.raises(ValueError, match="kv_groups=3"):
        TA.multi_head_attention(p, xq, xkv, num_heads=2)
    with pytest.raises(ValueError, match="query batch 6 != 2 \\* kv batch 2"):
        TA.multi_head_attention(p, xq, xkv, num_heads=2, kv_groups=2)


def test_make_attention_bias_matches_jax():
    m = np.array([[1, 1, 0], [1, 0, 0]], np.int32)
    _close(TA.make_attention_bias(_t(m)), JA.make_attention_bias(jnp.asarray(m)))
    m3 = np.tril(np.ones((2, 3, 3), np.int32))
    _close(TA.make_attention_bias(_t(m3)), JA.make_attention_bias(jnp.asarray(m3)))


def test_params_from_numpy_keeps_the_tree():
    tree = {"a": {"kernel": np.ones((2, 3), np.float32)}, "layers": [
        {"b": np.zeros(4, np.float32)}, None], "ids": np.arange(3, dtype=np.int32)}
    out = params_from_numpy(tree, device="cpu", dtype=torch.bfloat16)
    assert out["a"]["kernel"].shape == (2, 3) and out["a"]["kernel"].dtype == torch.bfloat16
    assert out["layers"][1] is None and out["layers"][0]["b"].shape == (4,)
    assert out["ids"].dtype == torch.int32
