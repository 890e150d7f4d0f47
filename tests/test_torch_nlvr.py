"""Port parity of NLVR2 and visual grounding against the JAX package, on the
CPU, in f32: XVLMForNLVR (cross_forward and forward with every KD tap, dense
and gated, fused and plain), duplicate_cross_layers_for_nlvr,
XVLMForNLVRPretraining.forward_pretrain, NLVRL0Module, nlvr_kd_losses with
the teacher-tap cut, DevicePreprocess over two image keys, one whole NLVR
step against JAX's make_task_train_step (the pair-second layers' never-read
K/V leaves included), the evaluation functions, the NLVR export (the
pruned student against JAX's gated dense forward, and JAX's own export
failing there, on record), XVLMForGrounding.forward and one whole
grounding step.

Randomness is pinned, not matched: the dropout rates are 0, the concrete
noise goes in through forward_train(noise=...) on both sides, the
pretraining's negatives and labels are pinned on both sides, and the image
pipeline is fed the same draws.

Tolerances: atol 2e-5 for a module and 1e-4 for a whole forward (f32, the
same arithmetic in another order); a step as tests/test_torch_train.py holds
one: losses rtol 2e-4, gradients (Adam's first moments / (1 - b1)) rtol
5e-3 with a floor of 5e-4 of the leaf's largest gradient, the updated
params within 5e-4 relative plus what that gradient tolerance allows
through Adam's first step. Images after CLIP normalisation at 2e-5 divided
by CLIP's smallest std. The file takes about 65 s in one process."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficientvlm_tpu import config as jcfg
from efficientvlm_tpu.data import device_pipeline as JP
from efficientvlm_tpu.drivers import common as JC
from efficientvlm_tpu.drivers import grounding as JGr
from efficientvlm_tpu.drivers import nlvr as JNl
from efficientvlm_tpu.evaluation import grounding as JEv
from efficientvlm_tpu.models import model_nlvr as JM
from efficientvlm_tpu.pruning import export as JE
from efficientvlm_tpu.pruning import l0_module as JL
from efficientvlm_tpu.train import steps as JS
from efficientvlm_tpu_torch import config as tcfg
from efficientvlm_tpu_torch.bridge import params_from_numpy, train_state_from_numpy
from efficientvlm_tpu_torch.data import device_pipeline as TP
from efficientvlm_tpu_torch.drivers import common as TC
from efficientvlm_tpu_torch.drivers import grounding as TGr
from efficientvlm_tpu_torch.drivers import nlvr as TNl
from efficientvlm_tpu_torch.evaluation import grounding as TEv
from efficientvlm_tpu_torch.models import model_nlvr as TM
from efficientvlm_tpu_torch.pruning import export as TE
from efficientvlm_tpu_torch.pruning import l0_module as TL
from efficientvlm_tpu_torch.train import optim as TO
from efficientvlm_tpu_torch.train import steps as TS

torch.set_num_threads(1)
MODULE_ATOL, SLICE_ATOL = 2e-5, 1e-4
NORM_ATOL = MODULE_ATOL / min(TP.CLIP_STD)
VOCAB, RES, PATCH, T_LEN, B = 60, 16, 8, 7, 3
VISION_S = dict(vision_width=64, num_attention_heads=4, intermediate_size=96,
                num_hidden_layers=2, image_res=RES, patch_size=PATCH)
# 3 text layers, fusion at 1: the replicated stack is 1 + 2 x 2 layers (the
# teacher's 2 + 2 x 4)
TEXT_S = dict(vocab_size=VOCAB, hidden_size=64, num_hidden_layers=3, num_attention_heads=4,
              intermediate_size=96, encoder_width=64, fusion_layer=1,
              max_position_embeddings=16, hidden_dropout_prob=0.0,
              attention_probs_dropout_prob=0.0)
VISION_T = dict(VISION_S, num_hidden_layers=4)
TEXT_T = dict(TEXT_S, num_hidden_layers=6, fusion_layer=2)
HEAD_DIM, LC = 16, 2
LR, REG_LR, B1, EPS, WD = 1e-3, 0.02, 0.9, 1e-8, 0.01
TASKS = ("nlvr", "grounding")
DRIVERS = {"nlvr": (JNl, TNl), "grounding": (JGr, TGr)}


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(port, ref, atol, what=""):
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    np.testing.assert_allclose(port, np.asarray(ref), atol=atol, rtol=0, err_msg=what)


def _tree_close(got, ref, atol, path=""):
    if isinstance(ref, dict):
        assert set(got) == set(ref), path
        for k in ref:
            _tree_close(got[k], ref[k], atol, f"{path}/{k}")
    elif isinstance(ref, (list, tuple)):
        assert len(got) == len(ref), path
        for i, (g, r) in enumerate(zip(got, ref)):
            _tree_close(g, r, atol, f"{path}[{i}]")
    elif ref is None:
        assert got is None, path
    else:
        _close(got, ref, atol, path)


def _config(mod, task="nlvr"):
    # unrolled layers: JAX's drivers default to lax.scan, which compiles
    # each scanned body even outside jit
    cfgs = [cls.create(**d, scan_layers=False) for cls, d in (
        (mod.VisionConfig, VISION_S), (mod.TextConfig, TEXT_S), (mod.VisionConfig, VISION_T),
        (mod.TextConfig, TEXT_T))]
    return mod.Config({"sparsity": 0.3, "head_gate_group": 2, "vision": cfgs[0],
                       "text": cfgs[1], "teacher_vision": cfgs[2], "teacher_text": cfgs[3],
                       "optimizer": {"lr": LR, "reg_learning_rate": REG_LR,
                                     "weight_decay": WD, "lr_mult": 2},
                       "schedular": {"num_warmup_steps": 0}})


def _models(task):
    """(JAX student, teacher, port student, teacher)."""
    (js, jt), (ts, tt) = (DRIVERS[task][0].build_models(_config(jcfg, task)),
                          DRIVERS[task][1].build_models(_config(tcfg, task)))
    return js, jt, ts, tt


@functools.lru_cache(maxsize=None)
def _init_np(task, role):
    """JAX's init of the student (seed 0) or the teacher (seed 1) as numpy,
    made once a module. Callers copy what they change."""
    js, jt, _, _ = _models(task)
    model, seed = (js, 0) if role == "student" else (jt, 1)
    kw = {"with_bbox_head": True} if task == "grounding" else {}
    return jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(seed), **kw))


@functools.lru_cache(maxsize=None)
def _l0_np(task):
    """JAX's gate params (seed 2), the FFN log-alphas spread by +-1 and the
    head groups' drawn in [-3, 3], so that the deterministic gates drop
    heads; λ non-zero."""
    l0 = DRIVERS[task][0].build_l0(_config(jcfg, task))
    p = jax.tree.map(np.asarray, l0.init(jax.random.PRNGKey(2)))
    rng = np.random.default_rng(4)
    p["loga"] = {k: (rng.uniform(-3, 3, v.shape) if k.endswith("head")
                     else v + rng.uniform(-1, 1, v.shape)).astype(np.float32)
                 for k, v in p["loga"].items()}
    p["lambda_1"], p["lambda_2"] = np.asarray(0.5, np.float32), np.asarray(0.2, np.float32)
    return p


def _zs_np(task, gated: bool):
    """None (the dense model) or the stochastic gates of the spread
    log-alphas under fixed noise, emitted by JAX's module (numpy)."""
    if not gated:
        return None
    l0 = DRIVERS[task][0].build_l0(_config(jcfg, task))
    rng = np.random.default_rng(6)
    noise = {k: rng.uniform(1e-6, 1 - 1e-6, g["shape"]).astype(np.float32)
             for k, g in l0.groups.items()}
    zs = l0.forward_train({"loga": _l0_np(task)["loga"]}, jax.random.PRNGKey(0), noise=noise)
    return jax.tree.map(np.asarray, zs)


def _tzs(zs):
    return None if zs is None else {k: _t(v) for k, v in zs.items()}


def _ids(rng, n=B):
    ids = rng.integers(5, VOCAB, (n, T_LEN)).astype(np.int32)
    ids[:, 0] = 1
    atts = np.ones_like(ids)
    ids[1, 4:], atts[1, 4:] = 0, 0
    return ids, atts


def _batch(task, seed=5):
    rng = np.random.default_rng(seed)
    ids, atts = _ids(rng)
    img = lambda: rng.standard_normal((B, RES, RES, 3)).astype(np.float32)  # noqa: E731
    if task == "nlvr":
        return {"image0": img(), "image1": img(), "text_ids": ids, "text_atts": atts,
                "targets": np.array([0, 1, 1], np.int32)}
    cxcy = rng.uniform(0.3, 0.7, (B, 2))
    wh = rng.uniform(0.1, 0.5, (B, 2))
    return {"image": img(), "text_ids": ids, "text_atts": atts,
            "target_bbox": np.concatenate([cxcy, wh], 1).astype(np.float32)}


def _torch_batch(b):
    return {k: _t(v) for k, v in b.items()}


def _nlvr_forward(model, params, b, zs, **kw):
    images = TNl.images(b) if isinstance(b["image0"], torch.Tensor) else jnp.concatenate(
        [b["image0"], b["image1"]], 0)
    return model.forward(params, images, b["text_ids"], b["text_atts"], b["targets"], zs=zs,
                         **kw)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def test_nlvr_text_config_and_init():
    """The replicated stack's config (fusion + 2Lc layers), the port's init
    tree against JAX's, and the tie: the pair-second layer reads the
    pair-first layer's K/V tensors, query and output its own."""
    js, _, ts, _ = _models("nlvr")
    assert ts.text_cfg["num_hidden_layers"] == js.text_cfg["num_hidden_layers"] == 1 + 2 * LC
    assert (ts.num_text_layers, ts.num_cross_layers) == (1, LC)
    got = ts.init(0, device="cpu")
    want = _init_np("nlvr", "student")
    shapes = lambda tree: [tuple(np.shape(x)) for x in jax.tree.leaves(  # noqa: E731
        jax.tree.map(np.asarray, tree))]
    assert shapes(jax.tree.map(lambda x: x.numpy(), got)) == shapes(want)
    tied = ts._tie_cross_kv(got)["text"]["layers"]
    for a in (1, 3):
        xa, xb = tied[a]["crossattention"], tied[a + 1]["crossattention"]
        assert xb["k"] is xa["k"] and xb["v"] is xa["v"]
        assert xb["q"] is got["text"]["layers"][a + 1]["crossattention"]["q"]
    assert got["text"]["layers"][2]["crossattention"]["k"] is not tied[1]["crossattention"]["k"]


def _cross_inputs():
    rng = np.random.default_rng(8)
    e0, e1 = (rng.standard_normal((B, 5, 64)).astype(np.float32) for _ in range(2))
    a0, a1 = np.ones((B, 5), np.int32), np.ones((B, 5), np.int32)
    a0[0, 3:], a1[2, 2:] = 0, 0
    return (e0, a0, e1, a1, *_ids(rng))


@functools.lru_cache(maxsize=None)
def _nlvr_refs(gated):
    """JAX's forward in KD mode and cross_forward (numpy), made once for
    both impls."""
    js = _models("nlvr")[0]
    jp, zs = _init_np("nlvr", "student"), _zs_np("nlvr", gated)
    kw = dict(output_attentions=True, output_hidden_states=True)
    fwd = jax.jit(lambda p, bb, z: _nlvr_forward(js, p, bb, z, train=True, **kw))(
        jp, _batch("nlvr", 7), zs)
    cross = jax.jit(lambda p, z, *x: js.cross_forward(p, *x, zs=z, **kw))(jp, zs,
                                                                         *_cross_inputs())
    return jax.tree.map(np.asarray, fwd), jax.tree.map(np.asarray, cross)


@pytest.mark.parametrize("impl", ["fused", "plain"])
@pytest.mark.parametrize("gated", [False, True], ids=["dense", "gated"])
def test_nlvr_forward_matches_jax(gated, impl):
    """forward in KD mode (the loss and every tap) and in eval mode (the
    logits), and cross_forward over two different image batches with
    masked image keys."""
    ts = _models("nlvr")[2]
    tp = params_from_numpy(_init_np("nlvr", "student"), device="cpu")
    b = _batch("nlvr", 7)
    zs = _zs_np("nlvr", gated)
    kw = dict(output_attentions=True, output_hidden_states=True)
    ref, cross_ref = _nlvr_refs(gated)
    got = _nlvr_forward(ts, tp, _torch_batch(b), _tzs(zs), train=True, impl=impl, **kw)
    for key in ("loss", "hidden_dict", "attention_dict", "cross_attention_dict",
                "logits_dict"):
        _tree_close(got[key], ref[key], SLICE_ATOL, key)
    assert len(got["cross_attention_dict"]["cross_attentions"]) == 2 * LC
    logits = _nlvr_forward(ts, tp, _torch_batch(b), _tzs(zs), train=False, impl=impl)
    _close(logits, ref["logits_dict"]["cls_head_logits"], SLICE_ATOL, "eval logits")

    got = ts.cross_forward(tp, *(_t(x) for x in _cross_inputs()), zs=_tzs(zs), impl=impl,
                           **kw)
    _tree_close(got, cross_ref, SLICE_ATOL, "cross_forward")
    # image0's masked keys get no weight in the even layers, image1's in the odd
    assert float(got["cross_attentions"][0][0, :, :, 3:].abs().max()) == 0.0
    assert float(got["cross_attentions"][1][2, :, :, 2:].abs().max()) == 0.0


def test_duplicate_cross_layers_matches_jax():
    sd = {f"text_encoder.encoder.layer.{i}.crossattention.self.key.weight": np.full(2, i)
          for i in range(4)}
    sd.update({"text_encoder.embeddings.word_embeddings.weight": np.zeros(3),
               "text_encoder.encoder.layer.1.output.dense.bias": np.ones(2)})
    ref, got = JM.duplicate_cross_layers_for_nlvr(sd, 2), TM.duplicate_cross_layers_for_nlvr(sd, 2)
    assert set(got) == set(ref) and len(got) == 2 + 2 + 2 * 2
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert got["text_encoder.encoder.layer.5.crossattention.self.key.weight"][0] == 3


PINNED = dict(neg_idx=np.array([2, 3, 0, 1]), labels=np.array([0, 1, 2, 1]))


def _pretrain_inputs():
    rng = np.random.default_rng(9)
    image = rng.standard_normal((4, RES, RES, 3)).astype(np.float32)
    return (image, *_ids(rng, 4))


@functools.lru_cache(maxsize=None)
def _pretrain_ref():
    """(JAX's params, its loss) with its draws patched to PINNED."""
    conf = _config(jcfg)
    jm = JM.XVLMForNLVRPretraining(*JC.model_configs(conf), conf)
    jp = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(3)))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "categorical",
                   lambda key, logits, axis=-1: jnp.asarray(PINNED["neg_idx"]))
        mp.setattr(jax.random, "randint",
                   lambda key, shape, lo, hi: jnp.asarray(PINNED["labels"]))
        loss = jax.jit(lambda p, *x: jm.forward_pretrain(p, *x, rng=jax.random.PRNGKey(0)))(
            jp, *_pretrain_inputs())
    return jp, np.asarray(loss)


@pytest.mark.parametrize("impl", ["fused", "plain"])
def test_nlvr_pretraining_loss_matches_jax(impl):
    """forward_pretrain with the hard negatives and the 3-way labels pinned
    on both sides (JAX's draws patched, the port's through noise=); the
    generator's own draws are a derangement and labels in [0, 3)."""
    tconf = _config(tcfg)
    tm = TM.XVLMForNLVRPretraining(*TC.model_configs(tconf), tconf)
    jp, ref = _pretrain_ref()
    tp = params_from_numpy(jp, device="cpu")
    assert set(tm.init(0, device="cpu")) == set(jp) == {"vision", "text", "ta_head",
                                                       "vision_proj"}
    args = tuple(_t(x) for x in _pretrain_inputs())
    pinned = {k: _t(v) for k, v in PINNED.items()}
    got = tm.forward_pretrain(tp, *args, noise=pinned, impl=impl)
    _close(got, ref, SLICE_ATOL, "loss")
    hidden, pred, labels = tm.pair_forward(tp, *args, noise=pinned, impl=impl)
    assert hidden.shape == (*args[1].shape, tm.text_cfg["hidden_size"])
    assert pred.shape == (args[1].shape[0], 3) and bool((labels == pinned["labels"]).all())
    drawn = tm.forward_pretrain(tp, *args, generator=torch.Generator().manual_seed(0),
                                impl=impl)
    assert torch.isfinite(drawn)
    feat = torch.nn.functional.normalize(torch.randn(8, 5, generator=torch.Generator()), dim=-1)
    neg_idx, lab = tm.draw_pairs(torch.Generator().manual_seed(1), feat)
    assert bool((neg_idx != torch.arange(8)).all()) and bool(((lab >= 0) & (lab < 3)).all())


@pytest.mark.parametrize("head_group", [1, 2])
def test_nlvr_l0_module_matches_jax(head_group):
    """NLVRL0Module: the groups over the doubled cross stack, their order and
    sizes, stochastic gates from the same noise, deterministic gates, the
    Lagrangian and the size accounting."""
    kw = dict(vision_layers=2, text_layers=1, cross_layers=LC, hidden_size=64,
              intermediate_size=96, num_heads=4, vision_hidden_size=64,
              vision_intermediate_size=96, vision_num_heads=4, head_group=head_group,
              target_sparsity=0.3, lagrangian_warmup=4)
    jm, tm = JL.NLVRL0Module(**kw), TL.NLVRL0Module(**kw)
    assert list(tm.groups) == list(jm.groups)
    for name, g in jm.groups.items():
        assert tm.groups[name]["shape"] == g["shape"]
        assert tm.groups[name]["params_per_dim"] == g["params_per_dim"]
    assert tm.prunable_model_size == jm.prunable_model_size
    assert tm.groups["cross_head"]["shape"] == (4 * LC, 4 // head_group)
    assert tm.groups["cross_intermediate"]["shape"] == (2 * LC, 96)
    rng = np.random.default_rng(3)
    loga = {k: rng.uniform(-3, 3, g["shape"]).astype(np.float32) for k, g in jm.groups.items()}
    noise = {k: rng.uniform(1e-6, 1 - 1e-6, g["shape"]).astype(np.float32)
             for k, g in jm.groups.items()}
    tloga = {k: _t(v) for k, v in loga.items()}
    ref = jm.forward_train({"loga": loga}, jax.random.PRNGKey(0), noise=noise)
    got = tm.forward_train({"loga": tloga}, noise=noise)
    _tree_close(got, ref, 1e-6, "forward_train")
    assert tuple(got["cross_head_z"].shape) == (2 * LC, 2, 4)
    ref_det = jm.forward_deterministic({"loga": loga})
    got_det = tm.forward_deterministic({"loga": tloga})
    _tree_close(got_det, ref_det, 0.0, "forward_deterministic")
    lam = {"lambda_1": np.float32(0.3), "lambda_2": np.float32(-0.2)}
    for step in (1, 8):
        ref_l = jm.lagrangian_regularization({"loga": loga, **lam}, step)
        got_l = tm.lagrangian_regularization(
            {"loga": tloga, **{k: torch.tensor(v) for k, v in lam.items()}}, step)
        for g, r in zip(got_l, ref_l):
            _close(torch.as_tensor(g), r, 1e-6, f"lagrangian at step {step}")
    assert tm.calculate_model_size(got_det) == jm.calculate_model_size(ref_det)


# ---------------------------------------------------------------------------
# the KD and the step
# ---------------------------------------------------------------------------


def _kd_taps(rng, vision, text, cross, scale=1.0):
    hid = lambda n: [scale * rng.standard_normal((2, 5, 8)).astype(np.float32)  # noqa: E731
                     for _ in range(n)]
    att = lambda n: [np.abs(rng.standard_normal((2, 2, 5, 5))).astype(np.float32)  # noqa
                     for _ in range(n)]
    return {"hidden_dict": {"image_hidden_states": hid(vision + 1),
                            "text_hidden_states": hid(text + 1)},
            "attention_dict": {"image_attentions": att(vision), "text_attentions": att(text)},
            "cross_attention_dict": {"cross_attentions": att(cross)},
            "logits_dict": {"cls_head_logits": rng.standard_normal((2, 2)).astype(np.float32)}}


def test_nlvr_kd_losses_and_teacher_cut_match_jax():
    """nlvr_kd_losses against JAX's over the whole teacher tree (the 6 + 12
    replicated stack onto 3 + 6, split at the student's fusion layer 3),
    then over the tree cut as build_step's teacher forward cuts it, one to
    one; the cut keeps the teacher's cross maps 1, 3, ..., 11 (each student
    image0 layer meets a teacher image1 layer, as in JAX)."""
    rng = np.random.default_rng(2)
    tree = lambda x: jax.tree.map(_t, x)  # noqa: E731
    student, teacher = _kd_taps(rng, 6, 9, 6), _kd_taps(rng, 12, 18, 12, 2.0)
    ref = JS.nlvr_kd_losses(student, teacher, fusion_layer_s=3, temperature=2.0)
    kd = lambda s, t: TS.nlvr_kd_losses(s, t, fusion_layer_s=3, temperature=2.0)  # noqa
    got = kd(tree(student), tree(teacher))
    assert set(got) == set(ref)
    for k in ref:
        _close(got[k], ref[k], MODULE_ATOL, k)
    cut = TS.subset_teacher_taps(tree(teacher), vision_layers=6, text_fusion=3, cross_layers=6,
                                 by_key={"text_hidden_states": 9, "text_attentions": 9})
    for d, k in (("hidden_dict", "text_hidden_states"), ("attention_dict", "text_attentions"),
                 ("cross_attention_dict", "cross_attentions"),
                 ("hidden_dict", "image_hidden_states")):
        assert len(cut[d][k]) == len(student[d][k]), k
    for i, x in enumerate(cut["cross_attention_dict"]["cross_attentions"]):
        np.testing.assert_array_equal(x.numpy(), teacher["cross_attention_dict"][
            "cross_attentions"][2 * i + 1])
    again = kd(tree(student), cut)
    for k in ref:
        _close(again[k], got[k], 0.0, k)


def test_nlvr_step_teacher_forward_cuts_to_the_student():
    """build_step's teacher forward (eval mode, every tap) cut to the
    student's depths gives the KD the full teacher tree gives."""
    _, _, ts, tt = _models("nlvr")
    tconf = _config(tcfg)
    step = TNl.build_step(tconf, ts, tt, TNl.build_l0(tconf), None,
                          teacher_params=params_from_numpy(_init_np("nlvr", "teacher"),
                                                           device="cpu"))
    tb = _torch_batch(_batch("nlvr"))
    sp = params_from_numpy(_init_np("nlvr", "student"), device="cpu")
    kw = dict(output_attentions=True, output_hidden_states=True)
    with torch.no_grad():
        cut = step.teacher_forward(tb)
        full = _nlvr_forward(tt, step.teacher_params, tb, None, train=False, **kw)
        s_out = _nlvr_forward(ts, sp, tb, None, train=True, **kw)
    assert len(full["cross_attention_dict"]["cross_attentions"]) == 8
    assert len(cut["cross_attention_dict"]["cross_attentions"]) == 2 * LC
    want, got = step.kd_fn(s_out, full), step.kd_fn(s_out, cut)
    for k in want:
        _close(got[k], want[k], 0.0, k)


def _jax_step(task, js, jt, jl0, jopts):
    """JAX's make_task_train_step wired as the JAX drivers wire it."""
    if task == "nlvr":
        fusion = js.num_text_layers
        kw = dict(output_attentions=True, output_hidden_states=True)

        def student_forward(params, zs, batch, rng):
            return _nlvr_forward(js, params, batch, zs, rng=rng, train=True, **kw)

        def teacher_forward(params, batch, rng):
            return _nlvr_forward(jt, params, batch, None, rng=rng, train=False, impl="fused",
                                 **kw)

        return JS.make_task_train_step(
            student_forward, teacher_forward,
            lambda s, t: JS.nlvr_kd_losses(s, t, fusion_layer_s=fusion), jl0, jopts,
            teacher_params=None, task_weight=0.8, kd_weight=0.2)

    def student_forward(params, zs, batch, rng):
        loss_bbox, loss_giou = js.forward(params, batch["image"], batch["text_ids"],
                                          batch["text_atts"], target_bbox=batch["target_bbox"],
                                          zs=zs, rng=rng, train=True)
        return {"loss": loss_bbox + loss_giou, "loss_bbox": loss_bbox, "loss_giou": loss_giou}

    return JS.make_task_train_step(student_forward, lambda p, b, r: {},
                                   lambda s, t: {"loss_kd": jnp.zeros(())}, jl0, jopts,
                                   teacher_params={}, task_weight=1.0, kd_weight=0.0)


@functools.lru_cache(maxsize=None)
def _one_step(task):
    """JAX's jitted step and the port's (the drivers' build_step) from one
    state, batch and concrete noise."""
    jd, td = DRIVERS[task]
    jconf, tconf = _config(jcfg, task), _config(tcfg, task)
    js, jt, ts, tt = _models(task)
    jl0, tl0 = jd.build_l0(jconf), td.build_l0(tconf)
    for m in (jl0, tl0):
        m.lagrangian_warmup = 8
    sparams, l0p = _init_np(task, "student"), _l0_np(task)
    jopts = JC.build_optimizers(sparams, jconf, 100,
                                init_param_paths=("cls_head",) if task == "nlvr" else ())
    topts = td.build_optimizers(sparams, tconf, 100)
    jstate = JS.init_train_state(jax.tree.map(jnp.asarray, sparams), l0p, jopts)
    tstate = train_state_from_numpy(jstate, topts, device="cpu")
    before = jax.tree.map(np.array, sparams)
    rng = np.random.default_rng(8)
    noise = {k: rng.uniform(1e-6, 1 - 1e-6, g["shape"]).astype(np.float32)
             for k, g in jl0.groups.items()}
    jl0.forward_train = functools.partial(JL.L0Module.forward_train, jl0, noise=noise)
    b = _batch(task)
    jstep = _jax_step(task, js, jt, jl0, jopts)
    tp_np = _init_np(task, "teacher") if task == "nlvr" else {}
    # compiled: JAX's eager autodiff over the two models is far slower
    new_jstate, jmetrics = jax.jit(jstep)(jstate, jax.tree.map(jnp.asarray, b),
                                          jax.random.PRNGKey(9),
                                          jax.tree.map(jnp.asarray, tp_np))
    tstep = td.build_step(tconf, ts, tt, tl0, topts,
                          teacher_params=params_from_numpy(tp_np, device="cpu"))
    tb = _torch_batch(b)
    t_out = tstep.teacher_forward(tb)
    tmetrics, grads = tstep.loss_and_grads(tstate, tb, t_out, None, noise=noise)
    tstep.apply(tstate, grads)
    return dict(new_jstate=new_jstate, jmetrics=jmetrics, tstate=tstate, tmetrics=tmetrics,
                l0p=l0p, grads=grads, before=before)


@pytest.mark.parametrize("task", TASKS)
def test_task_step_losses_match_jax(task):
    run = _one_step(task)
    j, t = run["jmetrics"], run["tmetrics"]
    assert set(t) == set(j)
    for k in j:
        np.testing.assert_allclose(float(t[k]), float(np.asarray(j[k])), rtol=2e-4, atol=1e-6,
                                   err_msg=k)
    if task == "grounding":
        assert float(t["loss_kd"]) == 0.0
        assert float(t["loss"]) == pytest.approx(float(t["loss_task"] + t["lagrangian_loss"]))


def _first_moments(opt_state):
    found = []

    def walk(x):
        if hasattr(x, "mu") and hasattr(x, "nu"):
            found.append(x.mu)
        elif isinstance(x, (tuple, list)):
            for y in x:
                walk(y)

    walk(opt_state)
    return found[0]


def _key(path):
    return tuple(jax.tree_util.DictKey(p) if isinstance(p, str) else jax.tree_util.SequenceKey(p)
                 for p in path)


def _grad_tol(g):
    g = np.abs(np.asarray(g, np.float64))
    return 5e-3 * g + max(5e-4 * (g.max() if g.size else 0.0), 1e-8)


def _trees(run):
    """(JAX tree, JAX optimizer state, port tree, port moments, lr) of the
    params, the log-alphas and the λs."""
    new_j, t = run["new_jstate"], run["tstate"]
    return [(new_j.params, new_j.opt_state, t.params, t.opt_state["mu"], LR),
            (new_j.loga, new_j.l0_state, t.loga, t.l0_state["mu"], REG_LR),
            (new_j.lam, new_j.lam_state, t.lam, t.lam_state["mu"], REG_LR)]


@pytest.mark.parametrize("task", TASKS)
def test_task_step_gradients_match_jax(task):
    """Gradients (clipped) of the params, log-alphas and λs, read as each
    side's Adam first moment after the step."""
    run = _one_step(task)
    for jtree, jopt_state, ttree, tmu, _ in _trees(run):
        want = dict(jax.tree_util.tree_leaves_with_path(_first_moments(jopt_state)))
        got = TO.tree_leaves_with_path(ttree)
        assert len(want) == len(got)
        for (path, _), mu in zip(got, tmu):
            w = np.asarray(want[_key(path)]) / (1 - B1)
            np.testing.assert_allclose(mu.numpy() / (1 - B1), w, rtol=5e-3,
                                       atol=max(5e-4 * float(np.abs(w).max()), 1e-8),
                                       err_msg=str(path))


@pytest.mark.parametrize("task", TASKS)
def test_task_step_updates_match_jax(task):
    """The params, log-alphas and λs after the updates (cls_head at lr_mult
    on NLVR), λ_1 ascending its gradient."""
    run = _one_step(task)
    for jtree, jopt_state, ttree, _, lr in _trees(run):
        want = dict(jax.tree_util.tree_leaves_with_path(jtree))
        mus = dict(jax.tree_util.tree_leaves_with_path(_first_moments(jopt_state)))
        for path, got in TO.tree_leaves_with_path(ttree):
            lr_leaf = lr * (2 if task == "nlvr" and path[0] == "cls_head" else 1)
            w = np.asarray(want[_key(path)], np.float64)
            g = np.abs(np.asarray(mus[_key(path)], np.float64)) / (1 - B1)
            allowed = (5e-4 * np.abs(w) + lr_leaf * np.minimum(1.0, _grad_tol(g) / (g + EPS))
                       + 1e-7)
            err = np.abs(got.detach().numpy() - w)
            assert (err <= allowed).all(), f"{path}: max err {err.max():.3e}"
    t = run["tstate"]
    assert t.step == 1 == int(run["new_jstate"].step)
    g1 = float(t.lam_state["mu"][0]) / (1 - B1)
    assert (float(t.lam["lambda_1"].detach()) - float(run["l0p"]["lambda_1"])) * g1 > 0


def test_nlvr_step_never_read_kv_leaves():
    """The pair-second layers' own cross K/V: no gradient (None on the
    port, zeros in JAX), so only weight decay moves them (the kernels by
    lr x wd x w, the biases not at all); the pair-first layers' K/V carry
    both layers' gradients."""
    run = _one_step("nlvr")
    t = run["tstate"]
    paths = [p for p, _ in TO.tree_leaves_with_path(t.params)]
    grads = dict(zip(paths, run["grads"][0]))
    mu = dict(zip(paths, t.opt_state["mu"]))
    new_j = dict(jax.tree_util.tree_leaves_with_path(run["new_jstate"].params))
    dense = run["before"]
    for a in (1, 3):
        for kv in ("k", "v"):
            for leaf in ("kernel", "bias"):
                second = ("text", "layers", a + 1, "crossattention", kv, leaf)
                first = ("text", "layers", a, "crossattention", kv, leaf)
                assert grads[second] is None and float(mu[second].abs().max()) == 0.0
                assert float(grads[first].abs().max()) > 0
                w0 = dense["text"]["layers"][a + 1]["crossattention"][kv][leaf]
                decay = (1 - LR * WD) if leaf == "kernel" else 1.0
                got = dict(TO.tree_leaves_with_path(t.params))[second].detach().numpy()
                np.testing.assert_allclose(got, w0 * decay, rtol=1e-6, atol=1e-9,
                                           err_msg=str(second))
                np.testing.assert_allclose(got, np.asarray(new_j[_key(second)]), rtol=1e-6,
                                           atol=1e-9, err_msg=str(second))


# ---------------------------------------------------------------------------
# preprocessing
# ---------------------------------------------------------------------------


def test_device_preprocess_over_two_image_keys():
    """DevicePreprocess(image_keys=("image0", "image1")) draws image0's
    pipeline, then image1's, from the generator (as preprocess_train on the
    same draws), each held to JAX's per-sample composition (crop, flip, two
    smooth ops, normalise); other keys pass through; NLVR's build_step with
    device_preprocess wraps both keys."""
    rng = np.random.default_rng(11)
    n, h, w, out = 3, 30, 26, 16
    batch = {k: _t(rng.integers(0, 256, (n, h, w, 3)).astype(np.uint8))
             for k in ("image0", "image1")}
    batch["text_ids"] = _t(np.arange(4))
    pre = TC.DevicePreprocess(None, out, image_keys=TNl.IMAGE_KEYS)
    got = pre.preprocess(batch, torch.Generator().manual_seed(3))
    g = torch.Generator().manual_seed(3)
    drawn = [TP.sample_train_params(g, n, h, w) for _ in range(2)]
    assert torch.equal(got["text_ids"], batch["text_ids"])
    for k, d in zip(TNl.IMAGE_KEYS, drawn):
        _close(got[k], TP.preprocess_train(batch[k], out, params=d), 0.0, k)
    assert not torch.equal(got["image0"], got["image1"])
    jops = JP.make_randaug_ops(0.7)
    mean, std = jnp.asarray(JP.CLIP_MEAN), jnp.asarray(JP.CLIP_STD)
    for k, d in zip(TNl.IMAGE_KEYS, drawn):
        d = dict(d, ops=torch.tensor([[3, 9, 1], [5, 6, 7]]), flip=torch.tensor([True, False,
                                                                                  True]))
        mine = TP.preprocess_train(batch[k], out, params=d)
        for i in range(n):
            x0, y0, cw, ch = (int(t[i]) for t in d["box"])
            img = jnp.asarray(batch[k][i].numpy(), jnp.float32)
            ys = y0 + (jnp.arange(out) * ch) // out
            xs = x0 + (jnp.arange(out) * cw) // out
            img = JP._resize(img[ys][:, xs], (out, out))
            if bool(d["flip"][i]):
                img = img[:, ::-1]
            for r in range(2):
                img = jops[int(d["ops"][r, i])](img, jnp.float32(float(d["signs"][r, i])))
            _close(mine[i], (img / 255.0 - mean) / std, NORM_ATOL, f"{k} sample {i}")
    seen = {}
    conf = _config(tcfg)
    conf.update(device_preprocess=True, image_res=out)
    step = TNl.build_step(conf, *_models("nlvr")[2:], None, None, teacher_params=None)
    assert isinstance(step, TC.DevicePreprocess) and step.image_keys == TNl.IMAGE_KEYS
    step.step = lambda state, b, generator, **kw: seen.update(b, **kw)
    step(None, dict(batch), torch.Generator().manual_seed(0), noise="n")
    assert all(seen[k].dtype == torch.float32 and tuple(seen[k].shape) == (n, out, out, 3)
               for k in TNl.IMAGE_KEYS) and seen["noise"] == "n"
    assert TC.DevicePreprocess(None, out).image_keys == ("image",)


# ---------------------------------------------------------------------------
# evaluation
# ---------------------------------------------------------------------------


def test_evaluation_functions_match_jax():
    """nlvr_accuracy, compute_iou_xywh and grounding_eval_bbox on the same
    numpy inputs (a split with no results, a result of an unknown split,
    touching and disjoint boxes)."""
    rng = np.random.default_rng(12)
    logits, targets = rng.standard_normal((50, 2)), rng.integers(0, 2, 50)
    assert TEv.nlvr_accuracy(logits, targets) == JEv.nlvr_accuracy(logits, targets)
    for b1, b2 in (([0, 0, 2, 2], [1, 1, 2, 2]), ([0, 0, 1, 1], [1, 0, 1, 1]),
                   ([0, 0, 1, 1], [3, 3, 1, 1]), ([0, 0, 0, 0], [0, 0, 0, 0])):
        assert TEv.compute_iou_xywh(b1, b2) == JEv.compute_iou_xywh(b1, b2)
    results, boxes, splits = [], {}, {}
    for i in range(40):
        cx, cy, w, h = rng.uniform(0.2, 0.8, 4) * [1, 1, 0.5, 0.5]
        results.append({"ref_id": i, "pred": [cx, cy, w, h], "width": 640, "height": 480})
        boxes[i] = [(cx - w / 2) * 640 + rng.normal(0, 30), (cy - h / 2) * 480, w * 640,
                    h * 480 * rng.uniform(0.5, 1.5)]
        splits[i] = ("val", "testA", "other")[i % 3]
    want = JEv.grounding_eval_bbox(results, boxes, splits)
    assert TEv.grounding_eval_bbox(results, boxes, splits) == want
    assert 0 < want["val"] < 100 and want["testB"] == 0.0


@pytest.mark.parametrize("task", TASKS)
def test_predict_matches_the_eval_forward(task):
    """drivers' predict: NLVR's logits of the 2B batch, grounding's boxes,
    against JAX's eval forward (the gated student)."""
    js, _, ts, _ = _models(task)
    jp = _init_np(task, "student")
    tp = params_from_numpy(jp, device="cpu")
    zs = _zs_np(task, True)
    b = _batch(task, 13)
    got = DRIVERS[task][1].predict(ts, tp, _torch_batch(b), zs=_tzs(zs))
    if task == "nlvr":
        ref = _nlvr_forward(js, jp, b, zs, train=False)
        assert TEv.nlvr_accuracy(got.numpy(), b["targets"]) == JEv.nlvr_accuracy(ref,
                                                                                 b["targets"])
    else:
        ref = js.forward(jp, b["image"], b["text_ids"], b["text_atts"], zs=zs, train=False)
        assert bool(((got > 0) & (got < 1)).all())
    _close(got, ref, SLICE_ATOL, "predict")


# ---------------------------------------------------------------------------
# the NLVR export
# ---------------------------------------------------------------------------


def _pair_gates(which: str):
    """Gates (numpy, emitted shapes) whose two layers of every replicated pair
    differ: head gates of 0 or 0.5-1 with different kept counts within each
    pair ("heads"), FFN rows that all differ ("ffn"), or both with the
    vision and text gates ("all")."""
    rng = np.random.default_rng(14)

    def gate(shape, keep):
        z = np.where(rng.uniform(0, 1, shape) < keep, rng.uniform(0.5, 1.0, shape), 0.0)
        return z.astype(np.float32)

    zs = {}
    if which in ("heads", "all"):
        ch = np.zeros((2 * LC, 2, 4), np.float32)
        for ci in range(2 * LC):
            for j in range(2):
                n_keep = (1, 3)[(ci + j) % 2]  # different counts within each pair
                keep = rng.permutation(4)[:n_keep]
                ch[ci, j, keep] = rng.uniform(0.5, 1.0, n_keep)
        zs["cross_head_z"] = ch
    if which in ("ffn", "all"):
        zs["cross_intermediate_z"] = gate((2 * LC, 96), 0.6)
    if which == "all":
        zs.update(vision_head_z=gate((2, 4), 0.7), vision_intermediate_z=gate((2, 96), 0.7),
                  text_head_z=gate((1, 4), 0.7), text_intermediate_z=gate((1, 96), 0.7))
    return zs


@pytest.mark.parametrize("which", ["heads", "ffn", "all"])
def test_pruned_nlvr_student_matches_jax_gated_dense(which):
    """prune_xvlm_params(nlvr=True) -> the pruned student's eval logits and
    training loss against JAX's gated dense forward(zs=) at 1e-4, with gates
    that differ within every replicated pair; the pruned tree is marked
    untied and its layers keep their own head counts."""
    js, _, ts, _ = _models("nlvr")
    jp = _init_np("nlvr", "student")
    zs = _pair_gates(which)
    pruned = TE.prune_xvlm_params(params_from_numpy(jp, device="cpu"), _tzs(zs),
                                  fusion_layer=1, head_dim=HEAD_DIM, nlvr=True)
    assert TM.UNTIED in pruned["text"]
    if "cross_head_z" in zs:
        heads = [lp["crossattention"]["k"]["kernel"].shape[1] // HEAD_DIM
                 for lp in pruned["text"]["layers"][1:]]
        assert heads == [int((zs["cross_head_z"][ci, 1] > 0).sum()) for ci in range(2 * LC)]
        assert heads[0] != heads[1]
    b = _batch("nlvr", 15)
    tb = _torch_batch(b)
    for train in (False, True):
        ref = _nlvr_forward(js, jp, b, zs, train=train)
        got = _nlvr_forward(ts, pruned, tb, None, train=train)
        _close(got, ref, SLICE_ATOL, f"train={train}")


def test_nlvr_load_zs_from_params():
    """load_zs_from_params(nlvr=True) over the pruned tree: the head counts
    of every layer and the FFN widths of the layer pairs in rows [0, Lc) of
    cross_intermediate_z, rows [Lc, 2Lc) zero; the other groups as JAX's
    reading of the same shapes."""
    jp = _init_np("nlvr", "student")
    zs = _pair_gates("all")
    pruned = TE.prune_xvlm_params(params_from_numpy(jp, device="cpu"), _tzs(zs),
                                  fusion_layer=1, head_dim=HEAD_DIM, nlvr=True)
    kw = dict(num_heads=4, intermediate_size=96, head_dim=HEAD_DIM, fusion_layer=1)
    got = TE.load_zs_from_params(pruned, nlvr=True, **kw)
    as_np = jax.tree.map(lambda x: x.numpy(), {k: pruned[k] for k in ("vision",)})
    as_np["text"] = {"layers": [jax.tree.map(lambda x: x.numpy(), lp)
                                for lp in pruned["text"]["layers"]]}
    want = JE.load_zs_from_params(as_np, **kw)
    assert set(got) == set(want)
    for k in want:
        if k != "cross_intermediate_z":
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    counts = (zs["cross_head_z"] > 0).sum(-1)
    np.testing.assert_array_equal(got["cross_head_z"].sum(-1), counts)
    ffn = got["cross_intermediate_z"]
    assert ffn.shape == (2 * LC, 96) and float(ffn[LC:].sum()) == 0.0
    np.testing.assert_array_equal(ffn[:LC].sum(-1), (zs["cross_intermediate_z"][:LC] > 0).sum(-1))


@pytest.mark.parametrize("which", ["heads", "ffn"])
def test_jax_nlvr_export_differs_from_its_gated_forward(which):
    """On record: JAX's own export of NLVR (export.prune_xvlm_params, the
    path scripts/export_pruned.py takes) is not its gated dense model when
    the layers of a pair keep different heads or FFN units. With head gates
    its pruned forward raises (the pair-second layer's queries meet the
    pair-first layer's sliced K/V: a TypeError at a reshape under jit, a
    ValueError at an einsum eagerly); with FFN gates alone it differs by more
    than 1e-4 (it slices replicated layer ci by row ci, the forward reads
    row ci // 2)."""
    js = _models("nlvr")[0]
    jp = _init_np("nlvr", "student")
    zs = _pair_gates(which)
    pruned = JE.prune_xvlm_params(jp, zs, fusion_layer=1, head_dim=HEAD_DIM)
    b = _batch("nlvr", 15)
    if which == "heads":
        with pytest.raises((TypeError, ValueError)):
            _nlvr_forward(js, pruned, b, None, train=False)
        return
    err = np.abs(np.asarray(_nlvr_forward(js, pruned, b, None, train=False))
                 - np.asarray(_nlvr_forward(js, jp, b, zs, train=False))).max()
    assert err > SLICE_ATOL


# ---------------------------------------------------------------------------
# grounding
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("impl", ["fused", "plain"])
@pytest.mark.parametrize("gated", [False, True], ids=["dense", "gated"])
def test_grounding_forward_matches_jax(gated, impl):
    """XVLMForGrounding.forward: (loss_bbox, loss_giou) in training and the
    boxes in eval mode."""
    js, _, ts, _ = _models("grounding")
    jp = _init_np("grounding", "student")
    assert set(ts.init(0, device="cpu")) == set(jp)  # the bbox head included
    tp = params_from_numpy(jp, device="cpu")
    b = _batch("grounding", 16)
    zs = _zs_np("grounding", gated)
    args = (b["image"], b["text_ids"], b["text_atts"])
    targs = tuple(_t(x) for x in args)
    ref = js.forward(jp, *args, target_bbox=b["target_bbox"], zs=zs, train=True)
    got = ts.forward(tp, *targs, target_bbox=_t(b["target_bbox"]), zs=_tzs(zs), train=True,
                     impl=impl)
    for g, r, what in zip(got, ref, ("loss_bbox", "loss_giou")):
        _close(g, r, SLICE_ATOL, what)
    coords = ts.forward(tp, *targs, zs=_tzs(zs), train=False, impl=impl)
    _close(coords, js.forward(jp, *args, zs=zs, train=False), SLICE_ATOL, "coords")
    assert tuple(coords.shape) == (B, 4)
