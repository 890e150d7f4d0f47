"""Port parity of the retrieval pruning fine-tune against the JAX package, on
the CPU, in f32: train/distill.py, the XVLM losses, retrieval_kd_losses, the
three optimizers against optax, dropout, and one whole
make_retrieval_train_step against JAX's on the same params, batch, concrete
noise and hard negatives.

Randomness is pinned, not matched: the concrete noise goes in through
forward_train(noise=...), the hard negatives are the argmax over the same
sampling weights on both sides (sample_hard_negatives overridden), and the
dropout rates are 0 (dropout itself is checked on its statistics).

Tolerances: the losses at 1e-5 (the same f32 arithmetic in another order);
a step as tests/test_trajectory_differential.py holds one: losses rtol 2e-4,
gradients (Adam's first moments after one update, which are (1 - b1) times
the clipped gradients) rtol 5e-3 with an absolute floor of 5e-4 of the
leaf's largest gradient, and the updated params within 5e-4 relative plus
the update disagreement that gradient tolerance allows through Adam's first
step, lr * min(1, grad_tol / (|g| + eps)): Adam's first update is about lr
times the gradient's sign, so a gradient that is zero up to f32 noise may
move either way."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from efficientvlm_tpu import config as jcfg
from efficientvlm_tpu.drivers import common as JC
from efficientvlm_tpu.models.model_retrieval import XVLMForRetrieval as JModel
from efficientvlm_tpu.pruning.l0_module import L0Module as JL0Base
from efficientvlm_tpu.train import distill as JD
from efficientvlm_tpu.train import optim as JO
from efficientvlm_tpu.train import steps as JS
from efficientvlm_tpu_torch import config as tcfg
from efficientvlm_tpu_torch.bridge import params_from_numpy, train_state_from_numpy
from efficientvlm_tpu_torch.drivers import common as TC
from efficientvlm_tpu_torch.models.model_retrieval import XVLMForRetrieval as TModel
from efficientvlm_tpu_torch.ops.basic import dropout
from efficientvlm_tpu_torch.train import distill as TD
from efficientvlm_tpu_torch.train import optim as TO
from efficientvlm_tpu_torch.train import steps as TS

torch.set_num_threads(1)
LOSS_TOL = 1e-5


def _t(x):
    return torch.from_numpy(np.array(x))


def _f(x):
    return float(np.asarray(x))


def _taps(rng, n, shape):
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]


def test_distill_matches_jax():
    rng = np.random.default_rng(0)
    t_hidden, s_hidden = _taps(rng, 13, (2, 5, 8)), _taps(rng, 7, (2, 5, 8))
    t_attn = [np.abs(a) for a in _taps(rng, 12, (2, 3, 5, 5))]
    s_attn = [np.abs(a) for a in _taps(rng, 6, (2, 3, 5, 5))]
    s_attn[0][0, 0, 0, 0] = -500.0  # the <= -1e2 filter
    for is_img in (False, True):
        np.testing.assert_allclose(
            float(TD.kd_list([_t(x) for x in s_hidden], [_t(x) for x in t_hidden],
                             is_img=is_img)),
            _f(JD.kd_list(s_hidden, t_hidden, is_img=is_img)), rtol=LOSS_TOL)
    np.testing.assert_allclose(
        float(TD.kd_list([_t(x) for x in s_attn], [_t(x) for x in t_attn], is_attn=True)),
        _f(JD.kd_list(s_attn, t_attn, is_attn=True)), rtol=LOSS_TOL)
    for taps, is_attn in ((t_hidden, False), (t_attn, True)):
        want = JD.subset_taps(taps, 6, is_attn=is_attn)
        got = TD.subset_taps([_t(x) for x in taps], 6, is_attn=is_attn)
        assert [np.asarray(w).tolist() for w in want] == [g.numpy().tolist() for g in got]
    logits_s, logits_t = rng.standard_normal((6, 2)), rng.standard_normal((6, 2))
    np.testing.assert_allclose(float(TD.soft_cross_entropy(_t(logits_s), _t(logits_t))),
                               _f(JD.soft_cross_entropy(logits_s, logits_t)), rtol=LOSS_TOL)


def _kd_outputs(rng, scale=1.0):
    """A KD-mode output tree: 4 vision layers, 2 text, 2 cross, taps small."""
    hid = lambda n: [scale * x for x in _taps(rng, n, (2, 5, 8))]  # noqa: E731
    att = lambda n: [np.abs(x) for x in _taps(rng, n, (2, 2, 5, 5))]  # noqa: E731
    return {
        "hidden_dict": {"image_hidden_states": hid(5), "text_hidden_states": hid(3),
                        "itm_pos_hidden_states": hid(3), "itm_neg_hidden_states": hid(3)},
        "attention_dict": {"image_attentions": att(4), "text_attentions": att(2),
                           "itm_pos_attentions": att(2), "itm_neg_attentions": att(2)},
        "cross_attention_dict": {"itm_pos_cross_attentions": att(2),
                                 "itm_neg_cross_attentions": att(2)},
        "logits_dict": {"itm_head_logits": rng.standard_normal((6, 2)).astype(np.float32)},
    }


def test_retrieval_kd_losses_and_teacher_subset_match_jax():
    rng = np.random.default_rng(1)
    student, teacher = _kd_outputs(rng), _kd_outputs(rng, 2.0)
    teacher["hidden_dict"]["image_hidden_states"] += _taps(rng, 4, (2, 5, 8))
    teacher["attention_dict"]["image_attentions"] += _taps(rng, 4, (2, 2, 5, 5))
    ref = JS.retrieval_kd_losses(student, teacher, temperature=2.0)
    tree = lambda x: jax.tree.map(_t, x)  # noqa: E731
    got = TS.retrieval_kd_losses(tree(student), tree(teacher), temperature=2.0)
    assert set(ref) == set(got)
    for k in ref:
        np.testing.assert_allclose(float(got[k]), _f(ref[k]), rtol=LOSS_TOL, err_msg=k)
    kw = dict(vision_layers=4, text_fusion=2, cross_layers=2)
    ref_sub = JS.subset_teacher_taps(teacher, **kw)
    got_sub = TS.subset_teacher_taps(tree(teacher), **kw)
    for (pw, w), (pg, g) in zip(jax.tree_util.tree_leaves_with_path(ref_sub),
                                jax.tree_util.tree_leaves_with_path(
                                    got_sub, is_leaf=lambda x: isinstance(x, torch.Tensor))):
        assert pw == pg
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _bundle(x):
    return jax.tree.map(np.asarray, x)


def test_xvlm_losses_match_jax():
    rng = np.random.default_rng(2)
    jm = JModel(jcfg.VisionConfig.create(**VISION_S), jcfg.TextConfig.create(**TEXT_S),
                jcfg.Config({"embed_dim": 16}))
    tm = TModel(tcfg.VisionConfig.create(**VISION_S), tcfg.TextConfig.create(**TEXT_S),
                tcfg.Config({"embed_dim": 16}))
    jp = _bundle(jm.init(jax.random.PRNGKey(1)))
    tp = params_from_numpy(jp, device="cpu")
    f_i, f_t = rng.standard_normal((2, 5, 16)).astype(np.float32)
    f_i /= np.linalg.norm(f_i, axis=1, keepdims=True)
    f_t /= np.linalg.norm(f_t, axis=1, keepdims=True)
    idx = np.asarray([0, 1, 1, 2, 3])
    for i in (None, idx):
        np.testing.assert_allclose(
            float(tm.get_contrastive_loss(tp, _t(f_i), _t(f_t),
                                          idx=None if i is None else _t(i))),
            _f(jm.get_contrastive_loss(jp, f_i, f_t, idx=i)), rtol=LOSS_TOL)
    # ITM over pinned negatives (the argmax of both sides' sampling weights)
    _pin_negatives(jm, tm)
    b, t = 5, 6
    ie = rng.standard_normal((b, 5, 64)).astype(np.float32)
    te = rng.standard_normal((b, t, 64)).astype(np.float32)
    ia = np.ones((b, 5), np.int32)
    ta = np.ones((b, t), np.int32)
    ta[2, 4:] = 0
    ref = jax.jit(lambda *a: jm.get_matching_loss(jp, jax.random.PRNGKey(0), *a, idx=idx))(
        ie, ia, f_i, te, ta, f_t)
    got = tm.get_matching_loss(tp, None, _t(ie), _t(ia), _t(f_i), _t(te), _t(ta), _t(f_t),
                               idx=_t(idx))
    np.testing.assert_allclose(float(got), _f(ref), rtol=LOSS_TOL)


def _pin_negatives(jm, tm):
    """Both sides draw their hard negatives as the argmax of their own
    sampling weights, softmax(sim / temp) + 1e-5 with positives zeroed."""

    def j_pick(rng, image_feat, text_feat, *, idx=None, temp):
        sim = (image_feat @ text_feat.T).astype(jnp.float32) / temp
        idx = jnp.arange(sim.shape[0]) if idx is None else idx.reshape(-1)
        mask = idx[:, None] == idx[None, :]
        w_i2t = jnp.where(mask, 0.0, jax.nn.softmax(sim, axis=1) + 1e-5)
        w_t2i = jnp.where(mask, 0.0, jax.nn.softmax(sim.T, axis=1) + 1e-5)
        return jnp.argmax(w_t2i, axis=1), jnp.argmax(w_i2t, axis=1)

    def t_pick(generator, image_feat, text_feat, *, idx=None, temp):
        sim = (image_feat @ text_feat.t()).float() / temp
        idx = torch.arange(sim.shape[0]) if idx is None else idx.reshape(-1)
        mask = idx[:, None] == idx[None, :]
        w_i2t = torch.where(mask, 0.0, torch.softmax(sim, dim=1) + 1e-5)
        w_t2i = torch.where(mask, 0.0, torch.softmax(sim.t(), dim=1) + 1e-5)
        return w_t2i.argmax(1), w_i2t.argmax(1)

    jm.sample_hard_negatives = j_pick
    tm.sample_hard_negatives = t_pick


def test_optimizers_match_optax():
    """Three updates of each optimizer from the same gradients: the main
    AdamW with global-norm clipping (the norm above the limit), the decay
    mask, a warm-up schedule and lr_mult on a from-scratch prefix; the L0
    AdamW; the negative-lr Lagrangian AdamW (λ moves against descent)."""
    rng = np.random.default_rng(3)
    params = {"vision": {"layers": [{"attn": {"q": {"kernel": rng.standard_normal((4, 6)),
                                                     "bias": rng.standard_normal(6)}},
                                     "ln1": {"scale": rng.standard_normal(4)}}],
                         "class_embedding": rng.standard_normal(4)},
              "temp": np.asarray(0.07),
              "itm_head": {"fc1": {"kernel": rng.standard_normal((4, 2))}}}
    params = jax.tree.map(lambda x: np.asarray(x, np.float32), params)
    sched = dict(lr=3e-2, num_training_steps=10, num_warmup_steps=0.3)
    from efficientvlm_tpu.train.scheduler import create_scheduler as j_sched
    from efficientvlm_tpu_torch.train.scheduler import create_scheduler as t_sched
    j_main = JO.create_optimizer(params, lr=j_sched(**sched), weight_decay=0.01, lr_mult=2.0,
                                 init_param_paths=("itm_head",), grad_clip=1.0)
    t_main = TO.create_optimizer(params, lr=t_sched(**sched), weight_decay=0.01, lr_mult=2.0,
                                 init_param_paths=("itm_head",), grad_clip=1.0)
    assert TO.weight_decay_mask(params) == jax.tree.leaves(JO.weight_decay_mask(params))
    loga = {"a": rng.standard_normal((2, 3)).astype(np.float32)}
    lam = {"lambda_1": np.asarray(0.1, np.float32), "lambda_2": np.asarray(-0.2, np.float32)}
    cases = [(params, j_main, t_main, 3.0),
             (loga, JO.create_l0_optimizer(reg_lr=0.01), TO.create_l0_optimizer(reg_lr=0.01), 1.0),
             (lam, JO.create_lagrangian_optimizer(reg_lr=0.01),
              TO.create_lagrangian_optimizer(reg_lr=0.01), 1.0)]
    for tree, jopt, topt, gscale in cases:
        jtree, jstate, jupdate = jax.tree.map(jnp.asarray, tree), jopt.init(tree), jax.jit(
            jopt.update)
        leaves = [_t(x) for x in jax.tree.leaves(tree)]
        order = [x for x in TO.tree_leaves(jax.tree.map(_t, tree))]
        # the port walks dicts in insertion order, JAX in sorted key order
        perm = [next(i for i, y in enumerate(order) if torch.equal(y, x)) for x in leaves]
        tleaves = [order[i] for i in perm]
        tstate = topt.init(order)
        for _ in range(3):
            grads = jax.tree.map(lambda x: np.asarray(
                gscale * rng.standard_normal(np.shape(x)), np.float32), tree)
            u, jstate = jupdate(grads, jstate, jtree)
            jtree = optax.apply_updates(jtree, u)
            gl = [_t(x) for x in jax.tree.leaves(grads)]
            tg = [None] * len(order)
            for i, p in enumerate(perm):
                tg[p] = gl[i]
            topt.step(order, tg, tstate)
        for want, got in zip(jax.tree.leaves(jtree), tleaves):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-7)
    assert float(cases[2][2].lr) < 0


def test_dropout_keeps_and_scales():
    g = torch.Generator().manual_seed(0)
    x = torch.ones(200_000)
    y = dropout(x, 0.1, generator=g, train=True)
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.9) < 0.005
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / 0.9))
    assert dropout(x, 0.1, generator=g, train=False) is x
    assert dropout(x, 0.1, generator=None, train=True) is x
    assert dropout(x, 0.0, generator=g, train=True) is x


# ---------------------------------------------------------------------------
# one whole train step
# ---------------------------------------------------------------------------

VISION_S = dict(vision_width=64, num_attention_heads=4, intermediate_size=96,
                num_hidden_layers=2, image_res=16, patch_size=8)
TEXT_S = dict(vocab_size=60, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
              intermediate_size=96, encoder_width=64, fusion_layer=1,
              max_position_embeddings=16, hidden_dropout_prob=0.0,
              attention_probs_dropout_prob=0.0)
VISION_T, TEXT_T = dict(VISION_S, num_hidden_layers=4), dict(TEXT_S, num_hidden_layers=4,
                                                             fusion_layer=2)
LR, REG_LR, B1, EPS = 1e-3, 0.02, 0.9, 1e-8


def _config(mod):
    # unrolled layers: JAX's drivers default to lax.scan, which compiles
    # each scanned body even outside jit
    cfgs = [cls.create(**d, scan_layers=False) for cls, d in (
        (mod.VisionConfig, VISION_S), (mod.TextConfig, TEXT_S), (mod.VisionConfig, VISION_T),
        (mod.TextConfig, TEXT_T))]
    return mod.Config({
        "embed_dim": 16, "sparsity": 0.25, "head_gate_group": 2,
        "vision": cfgs[0], "text": cfgs[1], "teacher_vision": cfgs[2], "teacher_text": cfgs[3],
        "optimizer": {"lr": LR, "reg_learning_rate": REG_LR, "weight_decay": 0.01},
        "schedular": {"num_warmup_steps": 0},
        "L0_schedular": {"droprate_init": 0.5, "temperature": 2.0 / 3.0}})


@pytest.fixture(scope="module")
def one_step():
    from efficientvlm_tpu.drivers.retrieval import build_l0 as j_build_l0
    from efficientvlm_tpu.drivers.retrieval import build_models as j_build_models
    from efficientvlm_tpu_torch.drivers.retrieval import build_l0 as t_build_l0
    from efficientvlm_tpu_torch.drivers.retrieval import build_models as t_build_models

    jconf, tconf = _config(jcfg), _config(tcfg)
    (js, jt), (ts, tt) = j_build_models(jconf), t_build_models(tconf)
    jl0, tl0 = j_build_l0(jconf), t_build_l0(tconf)
    for m in (jl0, tl0):
        m.lagrangian_warmup = 8
    sparams = _bundle(js.init(jax.random.PRNGKey(0)))
    tparams = _bundle(jt.init(jax.random.PRNGKey(1)))
    l0p = _bundle(jl0.init(jax.random.PRNGKey(2)))
    l0p["loga"] = {k: (v + np.random.default_rng(4).uniform(-1, 1, v.shape)).astype(np.float32)
                   for k, v in l0p["loga"].items()}
    l0p["lambda_1"], l0p["lambda_2"] = np.asarray(0.5, np.float32), np.asarray(0.2, np.float32)
    jopts = JC.build_optimizers(sparams, jconf, 100)
    topts = TC.build_optimizers(sparams, tconf, 100)
    jstate = JS.init_train_state(jax.tree.map(jnp.asarray, sparams), l0p, jopts)
    tstate = train_state_from_numpy(jstate, topts, device="cpu")

    rng = np.random.default_rng(5)
    batch = {"image": rng.standard_normal((4, 16, 16, 3)).astype(np.float32),
             "text_ids": rng.integers(1, 60, (4, 8)).astype(np.int32),
             "text_atts": np.ones((4, 8), np.int32), "idx": np.asarray([0, 1, 1, 2], np.int32)}
    batch["text_ids"][1, 5:] = 0  # PAD tokens: the PAD row gets no gradient
    batch["text_atts"][1, 5:] = 0
    noise = {k: rng.uniform(1e-6, 1 - 1e-6, g["shape"]).astype(np.float32)
             for k, g in jl0.groups.items()}
    _pin_negatives(js, ts)
    _pin_negatives(jt, tt)
    jl0.forward_train = functools.partial(JL0Base.forward_train, jl0, noise=noise)

    jstep = JS.make_retrieval_train_step(js, jt, jl0, jopts, teacher_params=None,
                                         impl="fused")
    # compiled: JAX's eager autodiff over the two models is far slower
    new_jstate, jmetrics = jax.jit(jstep)(jstate, jax.tree.map(jnp.asarray, batch),
                                          jax.random.PRNGKey(9),
                                          jax.tree.map(jnp.asarray, tparams))
    tstep = TS.make_retrieval_train_step(ts, tt, tl0, topts,
                                         teacher_params=params_from_numpy(tparams, "cpu"),
                                         impl="fused")
    tbatch = {k: _t(v) for k, v in batch.items()}
    tmetrics = tstep(tstate, tbatch, None, noise=noise)
    return dict(new_jstate=new_jstate, jmetrics=jmetrics, tstate=tstate, tmetrics=tmetrics,
                l0p=l0p)


def test_train_step_losses_match_jax(one_step):
    j, t = one_step["jmetrics"], one_step["tmetrics"]
    for k in ("loss_itc", "loss_itm", "loss_text_kd", "loss_img_kd", "loss_cross_kd",
              "loss_itm_logits_kd", "loss_kd", "lagrangian_loss", "expected_sparsity",
              "target_sparsity", "loss"):
        np.testing.assert_allclose(float(t[k]), _f(j[k]), rtol=2e-4, atol=1e-6, err_msg=k)


def _first_moments(opt_state):
    """The first moments of an optax state (the ScaleByAdamState's mu)."""
    found = []

    def walk(x):
        if hasattr(x, "mu") and hasattr(x, "nu"):
            found.append(x.mu)
        elif isinstance(x, (tuple, list)):
            for y in x:
                walk(y)

    walk(opt_state)
    return found[0]


def _grad_tol(g):
    g = np.abs(np.asarray(g, np.float64))
    return 5e-3 * g + max(5e-4 * (g.max() if g.size else 0.0), 1e-8)


def test_train_step_gradients_match_jax(one_step):
    """Gradients of the params (clipped), the log-alphas and the λs, read as
    each side's Adam first moment after the step: (1 - b1) * gradient."""
    new_j, t = one_step["new_jstate"], one_step["tstate"]
    pairs = [(_first_moments(new_j.opt_state), t.opt_state["mu"], t.params),
             (_first_moments(new_j.l0_state), t.l0_state["mu"], t.loga),
             (_first_moments(new_j.lam_state), t.lam_state["mu"], t.lam)]
    for jmu, tmu, ttree in pairs:
        want = dict(jax.tree_util.tree_leaves_with_path(jmu))
        got = TO.tree_leaves_with_path(ttree)
        assert len(want) == len(got)
        for (path, _), mu in zip(got, tmu):
            key = tuple(jax.tree_util.DictKey(p) if isinstance(p, str)
                        else jax.tree_util.SequenceKey(p) for p in path)
            w = np.asarray(want[key]) / (1 - B1)
            np.testing.assert_allclose(mu.numpy() / (1 - B1), w, rtol=5e-3,
                                       atol=max(5e-4 * float(np.abs(w).max()), 1e-8),
                                       err_msg=str(path))
    # the PAD row of the word embedding got no gradient
    mu = dict(zip([p for p, _ in TO.tree_leaves_with_path(t.params)], t.opt_state["mu"]))
    assert float(mu[("text", "embeddings", "word", "embedding")][0].abs().max()) == 0.0


def test_train_step_updates_match_jax(one_step):
    """The params, log-alphas and λs after the three updates (and the loga
    clamp); λ moved against its gradient (ascent)."""
    new_j, t = one_step["new_jstate"], one_step["tstate"]
    for jtree, jopt_state, ttree, lr in ((new_j.params, new_j.opt_state, t.params, LR),
                                         (new_j.loga, new_j.l0_state, t.loga, REG_LR),
                                         (new_j.lam, new_j.lam_state, t.lam, REG_LR)):
        want = dict(jax.tree_util.tree_leaves_with_path(jtree))
        mus = dict(jax.tree_util.tree_leaves_with_path(_first_moments(jopt_state)))
        for path, got in TO.tree_leaves_with_path(ttree):
            key = tuple(jax.tree_util.DictKey(p) if isinstance(p, str)
                        else jax.tree_util.SequenceKey(p) for p in path)
            w = np.asarray(want[key], np.float64)
            g = np.abs(np.asarray(mus[key], np.float64)) / (1 - B1)
            allowed = 5e-4 * np.abs(w) + lr * np.minimum(1.0, _grad_tol(g) / (g + EPS)) + 1e-7
            err = np.abs(got.detach().numpy() - w)
            assert (err <= allowed).all(), f"{path}: max err {err.max():.3e}"
    assert t.step == 1 == int(new_j.step)
    l0p, lam = one_step["l0p"], t.lam
    g1 = float(t.lam_state["mu"][0]) / (1 - B1)
    assert (float(lam["lambda_1"].detach()) - float(l0p["lambda_1"])) * g1 > 0


# ---------------------------------------------------------------------------
# remat: true (a per-layer recompute that replays the dropout draws)
# ---------------------------------------------------------------------------


def _remat_run(remat: bool, rate: float):
    """One retrieval step's loss and gradients (the port's own init) with
    the towers' remat flag and the text dropout rates at `rate`, and the
    generator's state after it."""
    from efficientvlm_tpu_torch.drivers.retrieval import build_l0, build_models

    text = dict(TEXT_S, hidden_dropout_prob=rate, attention_probs_dropout_prob=rate)
    conf = _config(tcfg)
    conf["vision"] = tcfg.VisionConfig.create(**VISION_S, remat=remat)
    conf["text"] = tcfg.TextConfig.create(**text, remat=remat)
    conf["teacher_text"] = tcfg.TextConfig.create(**dict(TEXT_T, **{
        k: rate for k in ("hidden_dropout_prob", "attention_probs_dropout_prob")}))
    student, teacher = build_models(conf)
    l0 = build_l0(conf)
    sparams = student.init(0, device="cpu")
    opts = TC.build_optimizers(sparams, conf, 100)
    state = TS.init_train_state(sparams, l0.init(2, device="cpu"), opts)
    step = TS.make_retrieval_train_step(student, teacher, l0, opts,
                                        teacher_params=teacher.init(1, device="cpu"),
                                        impl="fused")
    rng = np.random.default_rng(5)
    batch = {"image": _t(rng.standard_normal((4, 16, 16, 3)).astype(np.float32)),
             "text_ids": _t(rng.integers(1, 60, (4, 8))), "text_atts": torch.ones(4, 8,
                                                                               dtype=torch.long),
             "idx": torch.tensor([0, 1, 1, 2])}
    gen = torch.Generator().manual_seed(3)
    teacher_out = step.teacher_forward(batch, gen)
    metrics, grads = step.loss_and_grads(state, batch, teacher_out, gen)
    return metrics, [g for group in grads for g in group], gen.get_state()


def test_remat_replays_dropout_bit_equal(monkeypatch):
    """remat: true recomputes each layer in the backward (ops/basic.remat,
    once a ViT layer and once a BERT layer) and, at dropout 0.1 on the text
    tower, gives the same loss, every gradient and the same generator state
    bit for bit: the recompute replays the generator's masks."""
    from efficientvlm_tpu_torch.models import bert as TB
    from efficientvlm_tpu_torch.models import vit as TV
    from efficientvlm_tpu_torch.ops import basic

    calls = {"vit": 0, "bert": 0}
    for mod, name in ((TV, "vit"), (TB, "bert")):
        def counted(fn, *, generators=(), name=name):
            calls[name] += 1
            return basic.remat(fn, generators=generators)

        monkeypatch.setattr(mod, "remat", counted)
    m0, g0, s0 = _remat_run(False, 0.1)
    assert calls == {"vit": 0, "bert": 0}
    m1, g1, s1 = _remat_run(True, 0.1)
    # the student's 2 ViT and 2 BERT layers (text + fusion) and the fusion
    # layer again for the ITM negatives; the teacher runs under no_grad
    assert calls["vit"] == 2 and calls["bert"] >= 3, calls
    for k in m0:
        assert torch.equal(m0[k], m1[k]), k
    assert len(g0) == len(g1)
    for a, b in zip(g0, g1):
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(a, b)
    assert torch.equal(s0, s1)
    # the dropout was live: without it the loss is another one
    m2, _, _ = _remat_run(True, 0.0)
    assert not torch.equal(m1["loss"], m2["loss"])


@pytest.mark.parametrize("tower", ["vision", "text"])
def test_remat_matches_jax_remat_forward(tower):
    """A tower with remat: true against JAX's (jax.checkpoint on its layer
    scan) at dropout 0: sum(last_hidden * w) for a fixed random w (the sum
    of squares of a post-LN output is nearly constant, its gradient f32
    noise) and its gradient of every param, f32."""
    from efficientvlm_tpu.models import bert as JB
    from efficientvlm_tpu.models import vit as JV
    from efficientvlm_tpu_torch.models import bert as TB
    from efficientvlm_tpu_torch.models import vit as TV

    rng = np.random.default_rng(8)
    if tower == "vision":
        jc = jcfg.VisionConfig.create(**VISION_S, remat=True, scan_layers=True)
        tc = tcfg.VisionConfig.create(**VISION_S, remat=True)
        params = _bundle(JV.init_vit(jax.random.PRNGKey(0), jc))
        x = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
        w = rng.standard_normal((2, 5, 64)).astype(np.float32)

        def jloss(p):
            return jnp.sum(JV.vit_apply(p, jnp.asarray(x), jc)["last_hidden"] * w)

        def tloss(p):
            return (TV.vit_apply(p, _t(x), tc, impl="fused")["last_hidden"] * _t(w)).sum()
    else:
        kw = dict(TEXT_S, num_hidden_layers=4, fusion_layer=2)
        jc = jcfg.TextConfig.create(**kw, remat=True, scan_layers=True)
        tc = tcfg.TextConfig.create(**kw, remat=True)
        params = _bundle(JB.init_bert(jax.random.PRNGKey(0), jc))
        ids = rng.integers(1, 60, (2, 8)).astype(np.int32)
        atts = np.ones((2, 8), np.int32)
        atts[1, 5:] = 0
        enc = (rng.standard_normal((2, 5, 64)) * 0.5).astype(np.float32)
        w = rng.standard_normal((2, 8, 64)).astype(np.float32)

        def jloss(p):
            return jnp.sum(JB.bert_apply(p, jnp.asarray(ids), jc, attention_mask=jnp.asarray(atts),
                                         encoder_hidden=jnp.asarray(enc))["last_hidden"] * w)

        def tloss(p):
            return (TB.bert_apply(p, _t(ids).long(), tc, attention_mask=_t(atts),
                                  encoder_hidden=_t(enc), impl="fused")["last_hidden"]
                    * _t(w)).sum()
    jl, jg = jax.jit(jax.value_and_grad(jloss))(jax.tree.map(jnp.asarray, params))
    tp = params_from_numpy(params, "cpu")
    leaves = [t.requires_grad_(True) for _, t in TO.tree_leaves_with_path(tp)]
    tl = tloss(tp)
    tg = torch.autograd.grad(tl, leaves, allow_unused=True)
    np.testing.assert_allclose(float(tl.detach()), _f(jl), rtol=1e-5, atol=1e-5)
    want = dict(jax.tree_util.tree_leaves_with_path(jg))
    # the floor is relative to the tower's largest gradient: the key
    # projection's bias has a zero gradient up to f32 noise (softmax ignores
    # a row's constant shift)
    scale = max(float(np.abs(np.asarray(v)).max()) for v in want.values())
    for (path, _), g in zip(TO.tree_leaves_with_path(tp), tg):
        key = tuple(jax.tree_util.DictKey(p) if isinstance(p, str)
                    else jax.tree_util.SequenceKey(p) for p in path)
        w = np.asarray(want[key])
        got = np.zeros_like(w) if g is None else g.numpy()
        np.testing.assert_allclose(got, w, rtol=1e-4, atol=1e-6 * scale, err_msg=str(path))


def test_jax_ignores_remat_off_its_layer_scan(monkeypatch):
    """JAX honours remat: true only on its layer scan: a stack that runs
    unrolled (scan_layers false, local attention, region batches, a pruned
    stack) traces no checkpoint and keeps every activation, silently. The
    port recomputes each layer whatever the path (ROADMAP C)."""
    from efficientvlm_tpu.models import vit as JV
    from efficientvlm_tpu_torch.models import vit as TV
    from efficientvlm_tpu_torch.ops import basic

    x = np.zeros((1, 16, 16, 3), np.float32)
    kw = dict(VISION_S, local_attn_depth=1)
    jaxprs = {}
    for scan in (True, False):
        jc = jcfg.VisionConfig.create(**dict(VISION_S, scan_layers=scan, remat=True))
        params = JV.init_vit(jax.random.PRNGKey(0), jc)
        jaxprs[scan] = str(jax.make_jaxpr(jax.grad(
            lambda p: jnp.sum(JV.vit_apply(p, jnp.asarray(x), jc)["last_hidden"])))(params))
    assert "remat" in jaxprs[True] and "remat" not in jaxprs[False]
    calls = []
    monkeypatch.setattr(TV, "remat", lambda fn, generators=(): calls.append(1) or
                        basic.remat(fn, generators=generators))
    tc = tcfg.VisionConfig.create(**kw, remat=True)
    tp = TV.init_vit(torch.Generator().manual_seed(0), tc, device="cpu")
    leaves = [t.requires_grad_(True) for _, t in TO.tree_leaves_with_path(tp)]
    out = TV.vit_apply(tp, _t(x), tc, impl="fused")["last_hidden"].sum()
    torch.autograd.grad(out, leaves, allow_unused=True)
    assert len(calls) == VISION_S["num_hidden_layers"]
