"""Port parity of int8 quantization, the MoE FFN and the activations added to
ACT2FN against the JAX package, on the CPU, in f32:

- quantize_dense: the int8 kernel and its scales equal JAX's; quantize_params
  quantizes the same leaves (min_dim) and quantized_bytes counts the same;
- dense_quantized: w8 within 1e-5 of JAX's; w8a8 (bf16 per-row activation
  quantization, exact int8 product) within 1e-5 on the same input;
- the routing: a quantized retrieval model (width 256, so every attention
  projection is int8) calls none of the fused sublayer wrappers and its
  image / text features and ITM logits stay within 1e-4 (w8) of JAX's
  quantized forward on the same tree, cosine > 0.999 (w8a8: one activation
  rounding may land one int8 step apart), and near the float model's
  (cosine > 0.98, JAX's own bar); the float model still takes the fused
  wrappers;
- moe_ffn: output and aux loss within 1e-5 of JAX's without drops and at a
  capacity of one token an expert (the dropped tokens zero, the same ones),
  the gradient of a loss over both within 1e-5 of jax.grad's;
- ACT2FN relu and gelu_new within 1e-6 of JAX's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficientvlm_tpu import config as jcfg
from efficientvlm_tpu.models.model_retrieval import XVLMForRetrieval as JModel
from efficientvlm_tpu.models.xvlm import mlp_head_apply as j_mlp_head
from efficientvlm_tpu.ops import basic as JB
from efficientvlm_tpu.ops import moe as JMoE
from efficientvlm_tpu.ops import quant as JQ
from efficientvlm_tpu_torch import config as tcfg
from efficientvlm_tpu_torch.models import bert as TBert
from efficientvlm_tpu_torch.models import vit as TVit
from efficientvlm_tpu_torch.models.model_retrieval import XVLMForRetrieval as TModel
from efficientvlm_tpu_torch.models.xvlm import mlp_head_apply as t_mlp_head
from efficientvlm_tpu_torch.ops import basic as TB
from efficientvlm_tpu_torch.ops import moe as TMoE
from efficientvlm_tpu_torch.ops import quant as TQ

torch.set_num_threads(1)
VISION = dict(vision_width=256, num_attention_heads=4, intermediate_size=512,
              num_hidden_layers=2, image_res=32, patch_size=8)
TEXT = dict(vocab_size=200, hidden_size=256, num_hidden_layers=2, fusion_layer=1,
            num_attention_heads=4, intermediate_size=512, encoder_width=256,
            max_position_embeddings=32, hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0)


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_numpy(v) for v in tree]
    return tree.numpy() if isinstance(tree, torch.Tensor) else tree


def _cos(a, b):
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12))


def _dense(seed, d_in, d_out):
    rng = np.random.default_rng(seed)
    return {"kernel": (rng.standard_normal((d_in, d_out)) * 0.05).astype(np.float32),
            "bias": (rng.standard_normal(d_out) * 0.1).astype(np.float32)}


@pytest.mark.parametrize("mode", ["w8", "w8a8"])
def test_quantize_and_dense_match_jax(mode):
    p = _dense(0, 384, 256)
    p["kernel"][:, 3] = 0.0  # an all-zero channel: scale 1 / 127
    jq = JQ.quantize_dense({k: jnp.asarray(v) for k, v in p.items()}, mode=mode)
    tq = TQ.quantize_dense(_torch(p), mode=mode)
    key = "kernel_q8a8" if mode == "w8a8" else "kernel_q8"
    assert set(tq) == set(jq) and tq[key].dtype == torch.int8
    np.testing.assert_array_equal(tq[key].numpy(), np.asarray(jq[key]))
    np.testing.assert_array_equal(tq["scale"].numpy(), np.asarray(jq["scale"]))
    x = np.random.default_rng(1).standard_normal((5, 7, 384)).astype(np.float32)
    want = np.asarray(JB.dense(jq, jnp.asarray(x)))
    got = TB.dense(tq, torch.from_numpy(x))
    assert got.shape == (5, 7, 256) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    ref = x @ p["kernel"] + p["bias"]
    assert _cos(got.numpy(), ref) > 0.999


def test_quantize_params_and_bytes_match_jax():
    tree = {"big": _dense(3, 256, 256), "small_head": _dense(4, 256, 2),
            "ln": {"scale": np.ones(256, np.float32), "bias": np.zeros(256, np.float32)},
            "layers": [_dense(5, 256, 512), {"emb": {"embedding": np.zeros((100, 256),
                                                                           np.float32)}}]}
    jq = JQ.quantize_params(jax.tree.map(jnp.asarray, tree))
    tq = TQ.quantize_params(_torch(tree))
    assert jax.tree.structure(jax.tree.map(lambda x: 0, _numpy(tq))) == \
        jax.tree.structure(jax.tree.map(lambda x: 0, jq))
    for g, w in zip(jax.tree.leaves(_numpy(tq)), jax.tree.leaves(jq)):
        assert g.dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(g, np.asarray(w))
    assert TQ.quantized_bytes(tq) == JQ.quantized_bytes(jq)
    assert "kernel_q8" in tq["big"] and "kernel" in tq["small_head"]


@pytest.fixture(scope="module")
def retrieval():
    jmodel = JModel(jcfg.VisionConfig.create(**VISION), jcfg.TextConfig.create(**TEXT),
                    jcfg.Config({"embed_dim": 64}))
    tmodel = TModel(tcfg.VisionConfig.create(**VISION), tcfg.TextConfig.create(**TEXT),
                    tcfg.Config({"embed_dim": 64}))
    tp = tmodel.init(8, device="cpu")
    rng = np.random.default_rng(9)
    batch = (rng.standard_normal((2, 32, 32, 3)).astype(np.float32),
             rng.integers(0, 200, (2, 8)), np.ones((2, 8), np.int32))

    def jforward(p, image, ids, atts):
        emb, image_atts, _ = jmodel.get_vision_embeds(p, image)
        txt = jmodel.get_text_embeds(p, ids, atts)["last_hidden"]
        feats = jmodel.get_features(p, emb, txt)
        cross = jmodel.get_cross_embeds(p, emb, image_atts, text_embeds=txt, text_atts=atts)
        return (*feats, j_mlp_head(p["itm_head"], cross["last_hidden"][:, 0]))

    return tmodel, tp, batch, jax.jit(jforward)


def _tforward(model, p, image, ids, atts):
    emb, image_atts, _ = model.get_vision_embeds(p, image)
    txt = model.get_text_embeds(p, ids, atts)["last_hidden"]
    feats = model.get_features(p, emb, txt)
    cross = model.get_cross_embeds(p, emb, image_atts, text_embeds=txt, text_atts=atts)
    return (*feats, t_mlp_head(p["itm_head"], cross["last_hidden"][:, 0]))


def _spy(monkeypatch):
    calls = []
    for mod, names in ((TVit, ("fused_self_attention",)),
                       (TBert, ("fused_self_attention", "fused_cross_attention",
                                "fused_cross_attention_grouped"))):
        for name in names:
            orig = getattr(mod, name)

            def spy(*a, _orig=orig, _name=name, **kw):
                calls.append(_name)
                return _orig(*a, **kw)

            monkeypatch.setattr(mod, name, spy)
    return calls


@pytest.mark.parametrize("mode", ["w8", "w8a8"])
def test_quantized_retrieval_routes_and_matches_jax(retrieval, mode, monkeypatch):
    model, tp, batch, jforward = retrieval
    calls = _spy(monkeypatch)
    tb = [torch.from_numpy(np.asarray(x)) for x in batch]
    ref = _tforward(model, tp, *tb)
    assert set(calls) == {"fused_self_attention", "fused_cross_attention"}
    calls.clear()
    tq = TQ.quantize_params(tp, mode=mode)
    assert "kernel" not in tq["vision"]["layers"][0]["attn"]["q"]
    assert "kernel" not in tq["text"]["layers"][1]["crossattention"]["k"]
    got = _tforward(model, tq, *tb)
    assert calls == []
    want = jforward(_numpy(tq), *batch)
    for g, w, r, name in zip(got, want, ref, ("image_feat", "text_feat", "itm")):
        if mode == "w8":
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, rtol=0, err_msg=name)
        assert _cos(g.numpy(), w) > 0.999, name
        assert _cos(g.numpy(), r.numpy()) > 0.98, name


@pytest.fixture(scope="module")
def moe():
    """init_moe_ffn's layout, drawn with numpy (non-zero biases)."""
    rng = np.random.default_rng(0)

    def n(*shape, std):
        return (rng.standard_normal(shape) * std).astype(np.float32)

    params = {"router": {"kernel": n(16, 4, std=0.25)}, "wi": n(4, 16, 32, std=0.25),
              "bi": n(4, 32, std=0.1), "wo": n(4, 32, 16, std=0.18), "bo": n(4, 16, std=0.1)}
    h = np.random.default_rng(1).standard_normal((2, 12, 16)).astype(np.float32)
    return params, h


def _torch(tree):
    return jax.tree.map(lambda x: torch.from_numpy(np.array(x)), tree)


@pytest.mark.parametrize("capacity", [8.0, 4.0 / 24, 1.25])
def test_moe_matches_jax(moe, capacity):
    """No drops (capacity factor 8), one slot an expert (factor 4 / 24), and
    the default 1.25."""
    params, h = moe
    want, want_aux = jax.jit(lambda p, x: JMoE.moe_ffn(p, x, capacity_factor=capacity))(
        params, h)
    got, aux = TMoE.moe_ffn(_torch(params), torch.from_numpy(h), capacity_factor=capacity)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    np.testing.assert_allclose(float(aux), float(want_aux), atol=1e-6, rtol=0)
    zero = np.all(got.numpy().reshape(-1, 16) == 0, -1)
    np.testing.assert_array_equal(zero, np.all(np.asarray(want).reshape(-1, 16) == 0, -1))
    if capacity < 1:
        assert zero.sum() >= 24 - 4


def test_moe_gradient_matches_jax(moe):
    params, h = moe

    def jloss(p):
        out, aux = JMoE.moe_ffn(p, jnp.asarray(h), capacity_factor=2.0)
        return jnp.sum(out ** 2) + 0.01 * aux

    want = jax.jit(jax.grad(jloss))(params)
    tp = jax.tree.map(lambda x: torch.from_numpy(np.array(x)).requires_grad_(True), params)
    out, aux = TMoE.moe_ffn(tp, torch.from_numpy(h), capacity_factor=2.0)
    ((out ** 2).sum() + 0.01 * aux).backward()
    for path, w in jax.tree_util.tree_leaves_with_path(want):
        t = tp
        for k in path:
            t = t[k.key]
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=1e-5, rtol=1e-5,
                                   err_msg=str(path))
    assert float(tp["router"]["kernel"].grad.abs().sum()) > 0


def test_moe_init_shapes():
    p = TMoE.init_moe_ffn(torch.Generator().manual_seed(0), hidden=16, ffn=32, num_experts=4)
    want = jax.eval_shape(lambda k: JMoE.init_moe_ffn(k, hidden=16, ffn=32, num_experts=4),
                          jax.random.PRNGKey(0))
    assert jax.tree.map(lambda x: tuple(x.shape), _numpy(p)) == \
        jax.tree.map(lambda x: tuple(x.shape), want)


@pytest.mark.parametrize("name", ["relu", "gelu_new", "gelu", "quick_gelu"])
def test_activations_match_jax(name):
    x = np.linspace(-6, 6, 1001).astype(np.float32)
    np.testing.assert_allclose(TB.ACT2FN[name](torch.from_numpy(x)).numpy(),
                               np.asarray(JB.ACT2FN[name](jnp.asarray(x))), atol=1e-6, rtol=0)
