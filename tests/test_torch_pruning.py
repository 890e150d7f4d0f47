"""Port parity of pruning/ (hard_concrete, L0Module / XVLML0Module, the
physical export) against the JAX package, on the CPU, in f32: the same gate
params (JAX init -> bridge), the same concrete noise, the same zs.

Tolerances: the gate functions and the Lagrangian at 1e-6 (the same f32
formulas); the deterministic masks, the size accounting and the pruned trees
exactly (they slice the same numbers); the pruned forward against the gated
dense forward and against JAX's pruned forward at 1e-4, the slice
tolerance."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficientvlm_tpu import config as jcfg
from efficientvlm_tpu.models.model_retrieval import XVLMForRetrieval as JModel
from efficientvlm_tpu.models.xvlm import mlp_head_apply as j_mlp_head
from efficientvlm_tpu.pruning import export as JE
from efficientvlm_tpu.pruning import hard_concrete as jhc
from efficientvlm_tpu.pruning.l0_module import XVLML0Module as JL0
from efficientvlm_tpu_torch import config as tcfg
from efficientvlm_tpu_torch.bridge import l0_params_from_numpy, params_from_numpy
from efficientvlm_tpu_torch.evaluation import retrieval as TR
from efficientvlm_tpu_torch.models.model_retrieval import XVLMForRetrieval as TModel
from efficientvlm_tpu_torch.pruning import export as TE
from efficientvlm_tpu_torch.pruning import hard_concrete as thc
from efficientvlm_tpu_torch.pruning.l0_module import XVLML0Module as TL0

torch.set_num_threads(1)
GEOM = dict(vision_layers=2, text_layers=1, cross_layers=2, hidden_size=64,
            intermediate_size=96, num_heads=4)


def _t(x):
    return torch.from_numpy(np.array(x))


def _modules(head_group):
    kw = dict(GEOM, head_group=head_group, target_sparsity=0.25, lagrangian_warmup=10)
    return JL0(**kw), TL0(**kw)


def _loga(jm, seed=0):
    """Gate params of the JAX module's layout, drawn with numpy around its
    init means (10 for heads, logit(1 - 0.5) = 0 for FFN dims) with a spread
    that puts some gates near 0."""
    rng = np.random.default_rng(seed)
    loga = {k: ((g.get("init_mean") or 0.0) + rng.uniform(-6, 6, g["shape"])).astype(np.float32)
            for k, g in jm.groups.items()}
    return {"loga": loga, "lambda_1": np.float32(0.7), "lambda_2": np.float32(-0.3)}


def test_hard_concrete_functions_match_jax():
    rng = np.random.default_rng(0)
    loga = rng.uniform(-5, 5, 257).astype(np.float32)
    u = rng.uniform(1e-6, 1 - 1e-6, 257).astype(np.float32)
    for x in (0.0, 0.5):
        np.testing.assert_allclose(thc.cdf_qz(x, _t(loga)).numpy(),
                                   np.asarray(jhc.cdf_qz(x, jnp.asarray(loga))), atol=1e-6)
    np.testing.assert_allclose(thc.quantile_concrete(_t(u), _t(loga)).numpy(),
                               np.asarray(jhc.quantile_concrete(jnp.asarray(u),
                                                                jnp.asarray(loga))), atol=1e-6)
    np.testing.assert_allclose(thc.constrain_loga(_t(loga)).numpy(),
                               np.asarray(jhc.constrain_loga(jnp.asarray(loga))), atol=1e-6)
    for row in (loga[:12], loga[:97], np.full(6, 10.0, np.float32)):
        np.testing.assert_array_equal(thc.deterministic_z(row), jhc.deterministic_z(row))


def test_sample_z_keep_rate():
    """The port's own draw: E[z > 0] is 1 - cdf_qz(0, loga), values in [0, 1]."""
    g = torch.Generator().manual_seed(0)
    for loga in (-2.0, 0.0, 2.0):
        z = thc.sample_z(g, torch.full((20000,), loga))
        assert bool(((z >= 0) & (z <= 1)).all())
        keep = 1.0 - float(thc.cdf_qz(0.0, torch.tensor(loga)))
        assert abs(float((z > 0).float().mean()) - keep) < 0.02


@pytest.mark.parametrize("head_group", [1, 2])
def test_l0_module_matches_jax(head_group):
    jm, tm = _modules(head_group)
    jp = _loga(jm, head_group)
    tp = l0_params_from_numpy(jp, device="cpu")
    rng = np.random.default_rng(head_group)
    noise = {k: rng.uniform(1e-6, 1 - 1e-6, g["shape"]).astype(np.float32)
             for k, g in jm.groups.items()}
    jz = jm.forward_train(jp, jax.random.PRNGKey(0), noise=noise)
    tz = tm.forward_train(tp, noise=noise)
    assert set(jz) == set(tz)
    for k in jz:
        assert tuple(tz[k].shape) == jz[k].shape, k
        np.testing.assert_allclose(tz[k].numpy(), np.asarray(jz[k]), atol=1e-6, err_msg=k)

    jd, td = jm.forward_deterministic(jp), tm.forward_deterministic(tp)
    for k in jd:
        np.testing.assert_array_equal(td[k].numpy(), np.asarray(jd[k]), err_msg=k)
    assert tm.calculate_model_size(td) == jm.calculate_model_size(jd)
    assert tm.prunable_model_size == jm.prunable_model_size

    for step in (0, 4, 25):
        jl, js, jt = jm.lagrangian_regularization(jp, step)
        tl, ts, tt = tm.lagrangian_regularization(tp, step)
        np.testing.assert_allclose(float(tl), float(jl), atol=1e-6, rtol=1e-6)
        np.testing.assert_allclose(float(ts), float(js), atol=1e-6)
        np.testing.assert_allclose(float(tt), float(jt), atol=1e-6)
    np.testing.assert_allclose(float(tm.expected_model_size(tp)),
                               float(jm.expected_model_size(jp)), rtol=1e-6)


VISION = dict(vision_width=64, num_attention_heads=4, intermediate_size=96,
              num_hidden_layers=2, image_res=16, patch_size=8)
TEXT = dict(vocab_size=60, hidden_size=64, num_hidden_layers=3, num_attention_heads=4,
            intermediate_size=96, encoder_width=64, fusion_layer=1,
            max_position_embeddings=16, hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0)


@pytest.fixture(scope="module")
def export_case():
    jmod = JModel(jcfg.VisionConfig.create(**VISION), jcfg.TextConfig.create(**TEXT),
                  jcfg.Config({"embed_dim": 16}))
    jparams = jax.tree.map(np.asarray, jmod.init(jax.random.PRNGKey(0)))
    jl0, tl0 = _modules(2)
    jg = _loga(jl0, 5)
    # one whole layer's heads and FFN dropped, so None sublayers are covered
    jg["loga"]["vision_head"][1] = -8.0
    jg["loga"]["cross_intermediate"][0] = -8.0
    jzs = jl0.forward_deterministic(jg)
    tzs = tl0.forward_deterministic(l0_params_from_numpy(jg, device="cpu"))
    tmod = TModel(tcfg.VisionConfig.create(**VISION), tcfg.TextConfig.create(**TEXT),
                  tcfg.Config({"embed_dim": 16}))
    return jmod, jparams, jzs, tmod, params_from_numpy(jparams, device="cpu"), tzs


def _leaves(tree):
    return jax.tree_util.tree_leaves_with_path(
        tree, is_leaf=lambda x: x is None or isinstance(x, torch.Tensor))


@pytest.mark.parametrize("align", [False, True], ids=["no_align", "align_128"])
def test_prune_xvlm_params_matches_jax_leaf_by_leaf(export_case, align):
    jmod, jparams, jzs, tmod, tparams, tzs = export_case
    hd = 64 // 4
    jpruned = JE.prune_xvlm_params(jparams, jzs, fusion_layer=1, head_dim=hd, mxu_align=align)
    tpruned = TE.prune_xvlm_params(tparams, tzs, fusion_layer=1, head_dim=hd,
                                   align_heads=max(1, 128 // hd) if align else 1,
                                   align_intermediate=128 if align else 1)
    want, got = _leaves(jpruned), _leaves(tpruned)
    assert [p for p, _ in want] == [p for p, _ in got]
    for (path, w), (_, g) in zip(want, got):
        if w is None:
            assert g is None, path
            continue
        assert tuple(g.shape) == np.shape(w), path
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=str(path))
    assert tpruned["vision"]["layers"][1]["attn"] is None
    assert tpruned["text"]["layers"][1]["intermediate"] is None

    kw = dict(num_heads=4, intermediate_size=96, head_dim=hd, fusion_layer=1)
    jl, tl = JE.load_zs_from_params(jpruned, **kw), TE.load_zs_from_params(tpruned, **kw)
    assert set(jl) == set(tl)
    for k in jl:
        np.testing.assert_array_equal(tl[k], np.asarray(jl[k]), err_msg=k)


def test_pruned_forward_equals_gated_dense_forward(export_case):
    """The export is exact: the pruned student's retrieval forward equals the
    dense student's with the same deterministic gates, and JAX's pruned
    forward."""
    jmod, jparams, jzs, tmod, tparams, tzs = export_case
    hd = 64 // 4
    tpruned = TE.prune_xvlm_params(tparams, tzs, fusion_layer=1, head_dim=hd)
    jpruned = JE.prune_xvlm_params(jparams, jzs, fusion_layer=1, head_dim=hd)
    rng = np.random.default_rng(7)
    image = rng.standard_normal((3, 16, 16, 3)).astype(np.float32)
    ids = rng.integers(1, 60, (3, 6)).astype(np.int32)
    atts = np.ones((3, 6), np.int32)
    atts[1, 4:] = 0
    pruned = TR.retrieval_forward(tmod, tpruned, _t(image), _t(ids), _t(atts))
    gated = TR.retrieval_forward(tmod, tparams, _t(image), _t(ids), _t(atts), zs=tzs)

    @jax.jit
    def j_forward(params, image, ids, atts):
        ie, ia, _ = jmod.get_vision_embeds(params, image, impl="fused")
        te = jmod.get_text_embeds(params, ids, atts, impl="fused")["last_hidden"]
        cross = jmod.get_cross_embeds(params, ie, ia, text_embeds=te, text_atts=atts,
                                      impl="fused")
        return (*jmod.get_features(params, ie, te),
                j_mlp_head(params["itm_head"], cross["last_hidden"][:, 0]))

    ref = j_forward(jpruned, image, ids, atts)
    for p, g, r in zip(pruned, gated, ref):
        np.testing.assert_allclose(p.numpy(), g.numpy(), atol=1e-4, rtol=0)
        np.testing.assert_allclose(p.numpy(), np.asarray(r), atol=1e-4, rtol=0)


def test_forward_train_draws_from_the_generator():
    """Without noise the gates come from the generator: the same seed gives
    the same gates, another seed others."""
    _, tm = _modules(2)
    tp = tm.init(0, device="cpu")
    draw = lambda s: tm.forward_train(tp, torch.Generator().manual_seed(s))  # noqa: E731
    a, b, c = draw(1), draw(1), draw(2)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["vision_intermediate_z"], c["vision_intermediate_z"])
