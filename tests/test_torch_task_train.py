"""Port parity of the stage-2 pruning fine-tune of VQA and captioning against
the JAX package, on the CPU, in f32: the LM loss with label smoothing, the
decoder's training forward, XVLMForCaptioning.forward / forward_logits,
XVLMForVQA.forward_train, VQAL0Module, vqa_kd_losses and
captioning_kd_losses with the teacher-tap cut, one whole VQA and one whole
captioning step against JAX's make_task_train_step (and a stop_prune step),
the decoder-aware export and load_zs_from_params, the pruned student
against the gated dense one, vqa_collate and preprocess_train without the
flip.

Randomness is pinned, not matched: the dropout rates are 0, the concrete
noise goes in through forward_train(noise=...) on both sides, and the image
pipeline is fed the same draws.

Tolerances: atol 2e-5 for a module and 1e-4 for a whole forward (f32, the
same arithmetic in another order); a step as tests/test_torch_train.py holds
one: losses rtol 2e-4, gradients (Adam's first moments / (1 - b1)) rtol
5e-3 with a floor of 5e-4 of the leaf's largest gradient, the updated
params within 5e-4 relative plus what that gradient tolerance allows
through Adam's first step. Images after CLIP normalisation at 2e-5 divided
by CLIP's smallest std."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficientvlm_tpu import config as jcfg
from efficientvlm_tpu.data import datasets as JDS
from efficientvlm_tpu.data import device_pipeline as JP
from efficientvlm_tpu.drivers import captioning as JCap
from efficientvlm_tpu.drivers import common as JC
from efficientvlm_tpu.drivers import vqa as JVqa
from efficientvlm_tpu.models import bert as JB
from efficientvlm_tpu.pruning import export as JE
from efficientvlm_tpu.pruning import l0_module as JL
from efficientvlm_tpu.train import steps as JS
from efficientvlm_tpu_torch import config as tcfg
from efficientvlm_tpu_torch.bridge import params_from_numpy, train_state_from_numpy
from efficientvlm_tpu_torch.data import collate as TCol
from efficientvlm_tpu_torch.data import device_pipeline as TP
from efficientvlm_tpu_torch.drivers import captioning as TCap
from efficientvlm_tpu_torch.drivers import common as TC
from efficientvlm_tpu_torch.drivers import vqa as TVqa
from efficientvlm_tpu_torch.models import bert as TB
from efficientvlm_tpu_torch.pruning import export as TE
from efficientvlm_tpu_torch.pruning import l0_module as TL
from efficientvlm_tpu_torch.train import optim as TO
from efficientvlm_tpu_torch.train import steps as TS

torch.set_num_threads(1)
MODULE_ATOL, SLICE_ATOL = 2e-5, 1e-4
NORM_ATOL = MODULE_ATOL / min(TP.CLIP_STD)
VOCAB, RES, PATCH, Q_LEN, A_LEN, C_LEN = 60, 16, 8, 6, 5, 8
VISION_S = dict(vision_width=64, num_attention_heads=4, intermediate_size=96,
                num_hidden_layers=2, image_res=RES, patch_size=PATCH)
TEXT_S = dict(vocab_size=VOCAB, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
              intermediate_size=96, encoder_width=64, fusion_layer=1,
              max_position_embeddings=16, hidden_dropout_prob=0.0,
              attention_probs_dropout_prob=0.0)
VISION_T = dict(VISION_S, num_hidden_layers=4)
TEXT_T = dict(TEXT_S, num_hidden_layers=4, fusion_layer=2)
LR, REG_LR, B1, EPS = 1e-3, 0.02, 0.9, 1e-8
TASKS = ("vqa", "captioning")
DRIVERS = {"vqa": (JVqa, TVqa), "captioning": (JCap, TCap)}


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
    else:
        _close(got, ref, atol, path)


def _config(mod, task):
    # unrolled layers: JAX's drivers default to lax.scan, which compiles
    # each scanned body even outside jit
    cfgs = [cls.create(**d, scan_layers=False) for cls, d in (
        (mod.VisionConfig, VISION_S), (mod.TextConfig, TEXT_S), (mod.VisionConfig, VISION_T),
        (mod.TextConfig, TEXT_T))]
    conf = {"sparsity": 0.3, "head_gate_group": 2, "vision": cfgs[0], "text": cfgs[1],
            "teacher_vision": cfgs[2], "teacher_text": cfgs[3],
            "optimizer": {"lr": LR, "reg_learning_rate": REG_LR, "weight_decay": 0.01,
                          "lr_mult": 2},
            "schedular": {"num_warmup_steps": 0}}
    if task == "vqa":
        conf.update(num_dec_layers=1, teacher_num_dec_layers=2)
    else:
        conf.update(label_smoothing=0.1, prompt_length=2)
    return mod.Config(conf)


@functools.lru_cache(maxsize=None)
def _init_np(task, role):
    """JAX's init of the student (seed 0) or the teacher (seed 1) as numpy,
    made once a module (JAX's eager init takes seconds a tree). Callers copy
    what they change."""
    student, teacher = DRIVERS[task][0].build_models(_config(jcfg, task))
    model, seed = (student, 0) if role == "student" else (teacher, 1)
    return jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(seed)))


@functools.lru_cache(maxsize=None)
def _l0_np(task):
    """JAX's gate params (seed 2), the FFN log-alphas spread by +-1 and the
    head groups' drawn in [-3, 3] in place of their init of 10, so that the
    deterministic gates drop heads; λ non-zero."""
    l0 = DRIVERS[task][0].build_l0(_config(jcfg, task))
    p = jax.tree.map(np.asarray, l0.init(jax.random.PRNGKey(2)))
    rng = np.random.default_rng(4)
    p["loga"] = {k: (rng.uniform(-3, 3, v.shape) if k.endswith("head")
                     else v + rng.uniform(-1, 1, v.shape)).astype(np.float32)
                 for k, v in p["loga"].items()}
    p["lambda_1"], p["lambda_2"] = np.asarray(0.5, np.float32), np.asarray(0.2, np.float32)
    return p


def _models(task):
    """(JAX student, teacher, port student, teacher)."""
    (js, jt), (ts, tt) = (DRIVERS[task][0].build_models(_config(jcfg, task)),
                          DRIVERS[task][1].build_models(_config(tcfg, task)))
    return js, jt, ts, tt


def _vqa_batch(rng):
    """3 questions with 2, 1 and 3 answers through vqa_collate: 8 answer
    rows, the last 2 weight-0 copies of the first; a padded question and
    padded answers."""
    samples = []
    for n_ans in (2, 1, 3):
        q = rng.integers(5, VOCAB, Q_LEN)
        answers = [list(rng.integers(5, VOCAB, A_LEN)) for _ in range(n_ans)]
        w = rng.uniform(0.2, 1.0, n_ans)
        samples.append((rng.standard_normal((RES, RES, 3)).astype(np.float32), q,
                        answers, list(w / w.sum())))
    images, questions, answers, weights, k_index = TCol.vqa_collate(samples)
    q_ids, a_ids = np.stack(questions).astype(np.int32), np.asarray(answers, np.int32)
    a_ids[:, 0] = 1  # every answer starts with one token, as [CLS]
    q_atts, a_atts = np.ones_like(q_ids), np.ones_like(a_ids)
    q_ids[1, 4:], q_atts[1, 4:] = 0, 0
    a_ids[[0, 3], 3:], a_atts[[0, 3], 3:] = 0, 0
    return {"image": images, "q_ids": q_ids, "q_atts": q_atts, "a_ids": a_ids,
            "a_atts": a_atts, "weights": weights, "k_index": k_index}


def _caption_batch(rng):
    ids = rng.integers(5, VOCAB, (3, C_LEN)).astype(np.int32)
    ids[:, 0] = 1
    atts = np.ones_like(ids)
    ids[1, 5:], atts[1, 5:] = 0, 0
    return {"image": rng.standard_normal((3, RES, RES, 3)).astype(np.float32),
            "caption_ids": ids, "caption_atts": atts}


def _batch(task, seed=5):
    rng = np.random.default_rng(seed)
    return _vqa_batch(rng) if task == "vqa" else _caption_batch(rng)


def _torch_batch(b):
    return {k: _t(v) for k, v in b.items()}


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


def _forward(task, model, params, batch, zs, **kw):
    if task == "vqa":
        return model.forward_train(params, *(batch[k] for k in (
            "image", "q_ids", "q_atts", "a_ids", "a_atts", "weights", "k_index")), zs=zs, **kw)
    return model.forward(params, batch["image"], batch["caption_ids"], batch["caption_atts"],
                         zs=zs, **kw)


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
@pytest.mark.parametrize("reduction", ["mean", "none"])
def test_lm_loss_matches_jax(smoothing, reduction):
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((3, 7, 11)).astype(np.float32) * 3
    labels = rng.integers(0, 11, (3, 7)).astype(np.int32)
    labels[0, :3] = -100
    labels[2, 5:] = -100
    ref = JB.lm_loss(logits, labels, label_smoothing=smoothing, reduction=reduction)
    got = TB.lm_loss(_t(logits), _t(labels), label_smoothing=smoothing, reduction=reduction)
    assert tuple(got.shape) == tuple(np.shape(ref))
    _close(got, ref, MODULE_ATOL)


@pytest.mark.parametrize("impl", ["fused", "plain"])
def test_decoder_training_forward_matches_jax(impl):
    """bert_apply(is_decoder=True, train=True) with every tap: the causal +
    padding self-attention (the plain core, as in JAX) and the
    cross-attention over key-masked encoder states."""
    cfg = dict(TEXT_S, num_hidden_layers=2, fusion_layer=0)
    jc, tc = jcfg.TextConfig.create(**cfg), tcfg.TextConfig.create(**cfg)
    jp = jax.tree.map(np.asarray, JB.init_bert(jax.random.PRNGKey(3), jc))
    rng = np.random.default_rng(1)
    ids = rng.integers(5, VOCAB, (4, A_LEN)).astype(np.int32)
    atts = np.ones_like(ids)
    ids[2, 3:], atts[2, 3:] = 0, 0
    enc = rng.standard_normal((4, Q_LEN, 64)).astype(np.float32)
    enc_atts = np.ones((4, Q_LEN), np.int32)
    enc_atts[1, 4:] = 0
    kw = dict(mode="multi_modal", is_decoder=True, output_attentions=True,
              output_hidden_states=True, train=True)
    ref = JB.bert_apply(jp, ids, jc, attention_mask=atts, encoder_hidden=enc,
                        encoder_attention_mask=enc_atts, **kw)
    got = TB.bert_apply(params_from_numpy(jp, device="cpu"), _t(ids), tc,
                        attention_mask=_t(atts), encoder_hidden=_t(enc),
                        encoder_attention_mask=_t(enc_atts), generator=torch.Generator(),
                        impl=impl, **kw)
    for key in ("last_hidden", "hidden_states", "attentions", "cross_attentions"):
        _tree_close(got[key], ref[key], MODULE_ATOL, key)
    assert len(got["cross_attentions"]) == 2
    # causal: no query attends to a later key; the masked encoder keys get 0
    assert float(torch.triu(got["attentions"][0][0, 0], 1).abs().max()) == 0.0
    assert float(got["cross_attentions"][0][1, :, :, 4:].abs().max()) == 0.0


@pytest.mark.parametrize("gated", [False, True], ids=["dense", "gated"])
@pytest.mark.parametrize("task", TASKS)
def test_task_forward_matches_jax(task, gated):
    """XVLMForVQA.forward_train / XVLMForCaptioning.forward in KD mode: the
    loss and every tap; captioning's forward_logits; VQA's weight-0 pad
    answers add nothing to the loss."""
    js, _, ts, _ = _models(task)
    jp = _init_np(task, "student")
    tp = params_from_numpy(jp, device="cpu")
    b = _batch(task, 7)
    zs = _zs_np(task, gated)
    tzs = None if zs is None else {k: _t(v) for k, v in zs.items()}
    kw = dict(output_attentions=True, output_hidden_states=True)
    ref = jax.jit(lambda p, bb, z: _forward(task, js, p, bb, z, **kw))(jp, b, zs)
    got = _forward(task, ts, tp, _torch_batch(b), tzs, train=True, **kw)
    for key in ("loss", "hidden_dict", "attention_dict", "cross_attention_dict",
                "logits_dict"):
        _tree_close(got[key], ref[key], SLICE_ATOL, key)
    if task == "captioning":
        ref_logits = js.forward_logits(jp, b["image"], b["caption_ids"], b["caption_atts"],
                                       zs=zs)
        got_logits = ts.forward_logits(tp, _t(b["image"]), _t(b["caption_ids"]),
                                       _t(b["caption_atts"]), zs=tzs)
        _close(got_logits, ref_logits, SLICE_ATOL, "forward_logits")
        _close(got_logits, got["logits_dict"]["logits"], 0.0, "logits")
    else:
        real = b["weights"] > 0
        assert (~real).sum() == 2
        cut = dict(b, a_ids=b["a_ids"][real], a_atts=b["a_atts"][real],
                   weights=b["weights"][real], k_index=b["k_index"][real])
        _close(_forward(task, ts, tp, _torch_batch(cut), tzs), got["loss"], MODULE_ATOL,
               "loss without the pad answers")


@pytest.mark.parametrize("head_group", [1, 2])
def test_vqa_l0_module_matches_jax(head_group):
    """VQAL0Module: the groups, their order and sizes, stochastic gates
    from the same noise, deterministic gates, the Lagrangian and the size
    accounting."""
    kw = dict(vision_layers=2, text_layers=1, cross_layers=1, hidden_size=64,
              intermediate_size=96, num_heads=4, vision_hidden_size=64,
              vision_intermediate_size=96, vision_num_heads=4, head_group=head_group,
              target_sparsity=0.3, lagrangian_warmup=4)
    jm, tm = JL.VQAL0Module(**kw), TL.VQAL0Module(**kw)
    assert list(tm.groups) == list(jm.groups) and "decoder_head" in tm.groups
    for name, g in jm.groups.items():
        assert tm.groups[name]["shape"] == g["shape"]
        assert tm.groups[name]["params_per_dim"] == g["params_per_dim"]
    assert tm.prunable_model_size == jm.prunable_model_size
    assert tm.groups["decoder_head"]["shape"] == (2, 4 // head_group)
    rng = np.random.default_rng(3)
    loga = {k: rng.uniform(-3, 3, g["shape"]).astype(np.float32) for k, g in jm.groups.items()}
    noise = {k: rng.uniform(1e-6, 1 - 1e-6, g["shape"]).astype(np.float32)
             for k, g in jm.groups.items()}
    tloga = {k: _t(v) for k, v in loga.items()}
    ref = jm.forward_train({"loga": loga}, jax.random.PRNGKey(0), noise=noise)
    got = tm.forward_train({"loga": tloga}, noise=noise)
    _tree_close(got, ref, 1e-6, "forward_train")
    assert tuple(got["decoder_head_z"].shape) == (1, 2, 4)
    ref_det, got_det = jm.forward_deterministic({"loga": loga}), tm.forward_deterministic(
        {"loga": tloga})
    _tree_close(got_det, ref_det, 0.0, "forward_deterministic")
    lam = {"lambda_1": np.float32(0.3), "lambda_2": np.float32(-0.2)}
    for step in (1, 8):
        ref_l = jm.lagrangian_regularization({"loga": loga, **lam}, step)
        got_l = tm.lagrangian_regularization({"loga": tloga, **{k: torch.tensor(v) for k, v in
                                                                lam.items()}}, step)
        for g, r in zip(got_l, ref_l):
            _close(torch.as_tensor(g), r, 1e-6, f"lagrangian at step {step}")
    assert tm.calculate_model_size(got_det) == jm.calculate_model_size(ref_det)


def _kd_taps(rng, vision, text, cross, dec, dec_cross, scale=1.0):
    """A VQA / captioning KD tree of random taps (hidden [2,5,8], maps
    [2,2,5,5]); text 0 leaves the question stack out (captioning)."""
    hid = lambda n: [scale * rng.standard_normal((2, 5, 8)).astype(np.float32)  # noqa: E731
                     for _ in range(n)]
    att = lambda n: [np.abs(rng.standard_normal((2, 2, 5, 5))).astype(np.float32)  # noqa
                     for _ in range(n)]
    tree = {"hidden_dict": {"image_hidden_states": hid(vision + 1),
                            "decoder_hidden_states": hid(dec + 1)},
            "attention_dict": {"image_attentions": att(vision), "decoder_attentions": att(dec)},
            "cross_attention_dict": {"decoder_cross_attentions": att(dec_cross)},
            "logits_dict": {"logits": rng.standard_normal((2, 5, 11)).astype(np.float32)}}
    if text:
        tree["hidden_dict"]["text_hidden_states"] = hid(text + 1)
        tree["attention_dict"]["text_attentions"] = att(text)
        tree["cross_attention_dict"]["cross_attentions"] = att(cross)
    return tree


@pytest.mark.parametrize("task", TASKS)
def test_kd_losses_and_teacher_cut_match_jax(task):
    """vqa_kd_losses / captioning_kd_losses against JAX's over the whole
    teacher tree (12-layer text stack onto 6, the VQA question stack split
    at the student's fusion layer 3), then the same losses over the tree cut
    by build_step's teacher forward (subset_teacher_taps with by_key), one
    to one."""
    rng = np.random.default_rng(2)
    tree = lambda x: jax.tree.map(_t, x)  # noqa: E731
    if task == "vqa":
        student = _kd_taps(rng, 6, 6, 3, 3, 3)
        teacher = _kd_taps(rng, 12, 12, 6, 6, 6, 2.0)
        ref = JS.vqa_kd_losses(student, teacher, fusion_layer_s=3, fusion_layer_t=6,
                               temperature=2.0)
        kd = lambda s, t: TS.vqa_kd_losses(s, t, fusion_layer_s=3, temperature=2.0)  # noqa
        by_key = {"text_hidden_states": 6, "text_attentions": 6, "decoder_hidden_states": 3,
                  "decoder_attentions": 3, "decoder_cross_attentions": 3}
    else:
        student = _kd_taps(rng, 6, 0, 0, 6, 3)
        teacher = _kd_taps(rng, 12, 0, 0, 12, 6, 2.0)
        ref = JS.captioning_kd_losses(student, teacher, temperature=2.0)
        kd = lambda s, t: TS.captioning_kd_losses(s, t, temperature=2.0)  # noqa: E731
        by_key = {"decoder_hidden_states": 6, "decoder_attentions": 6}
    got = kd(tree(student), tree(teacher))
    assert set(got) == set(ref)
    for k in ref:
        _close(got[k], ref[k], MODULE_ATOL, k)
    cut = TS.subset_teacher_taps(tree(teacher), vision_layers=6, text_fusion=3, cross_layers=3,
                                 by_key=by_key)
    for d, k in (("hidden_dict", "image_hidden_states"), ("hidden_dict", "decoder_hidden_states"),
                 ("cross_attention_dict", "decoder_cross_attentions")):
        assert len(cut[d][k]) == len(student[d][k]), k
    again = kd(tree(student), cut)
    for k in ref:
        _close(again[k], got[k], 0.0, k)


@pytest.mark.parametrize("task", TASKS)
def test_step_teacher_forward_cuts_to_the_student(task):
    """build_step's teacher forward (eval mode, every tap) cut to the
    student's depths gives the KD the full teacher tree gives."""
    _, _, ts, tt = _models(task)
    tconf = _config(tcfg, task)
    step = DRIVERS[task][1].build_step(
        tconf, ts, tt, DRIVERS[task][1].build_l0(tconf), None,
        teacher_params=params_from_numpy(_init_np(task, "teacher"), device="cpu"))
    tb = _torch_batch(_batch(task))
    sp = params_from_numpy(_init_np(task, "student"), device="cpu")
    kw = dict(output_attentions=True, output_hidden_states=True)
    with torch.no_grad():
        cut = step.teacher_forward(tb)
        full = _forward(task, tt, step.teacher_params, tb, None, train=False, **kw)
        s_out = _forward(task, ts, sp, tb, None, train=True, **kw)
    assert len(cut["hidden_dict"]["decoder_hidden_states"]) == len(
        s_out["hidden_dict"]["decoder_hidden_states"])
    want, got = step.kd_fn(s_out, full), step.kd_fn(s_out, cut)
    for k in want:
        _close(got[k], want[k], 0.0, k)


# ---------------------------------------------------------------------------
# one whole step
# ---------------------------------------------------------------------------


def _jax_step(task, js, jt, jl0, jopts, frozen_zs=None):
    """JAX's make_task_train_step wired as the JAX drivers wire it."""
    if task == "vqa":
        fusion = js.text_cfg["fusion_layer"]
        kd = lambda s, t: JS.vqa_kd_losses(  # noqa: E731
            s, t, fusion_layer_s=fusion, fusion_layer_t=jt.text_cfg["fusion_layer"])
        weights = (0.6, 0.4)
    else:
        kd, weights = JS.captioning_kd_losses, (0.7, 0.3)
    kw = dict(output_attentions=True, output_hidden_states=True)
    if task == "captioning":
        kw.update(pad_token_id=0, prompt_length=2)

    def student_forward(params, zs, batch, rng):
        return _forward(task, js, params, batch, zs, rng=rng, train=True, **kw)

    def teacher_forward(params, batch, rng):
        return _forward(task, jt, params, batch, None, rng=rng, train=False, impl="fused", **kw)

    return JS.make_task_train_step(student_forward, teacher_forward, kd, jl0, jopts,
                                   teacher_params=None, task_weight=weights[0],
                                   kd_weight=weights[1], frozen_zs=frozen_zs)


@functools.lru_cache(maxsize=None)
def _one_step(task, frozen: bool = False):
    """JAX's jitted step and the port's (drivers' build_step) from one state,
    batch and concrete noise; with frozen, stop_prune with the
    deterministic gates of the spread log-alphas."""
    jd, td = DRIVERS[task]
    jconf, tconf = _config(jcfg, task), _config(tcfg, task)
    js, jt, ts, tt = _models(task)
    jl0, tl0 = jd.build_l0(jconf), td.build_l0(tconf)
    for m in (jl0, tl0):
        m.lagrangian_warmup = 8
    sparams, tparams, l0p = _init_np(task, "student"), _init_np(task, "teacher"), _l0_np(task)
    jopts = JC.build_optimizers(sparams, jconf, 100)
    topts = TC.build_optimizers(sparams, tconf, 100)
    jstate = JS.init_train_state(jax.tree.map(jnp.asarray, sparams), l0p, jopts)
    tstate = train_state_from_numpy(jstate, topts, device="cpu")
    rng = np.random.default_rng(8)
    noise = {k: rng.uniform(1e-6, 1 - 1e-6, g["shape"]).astype(np.float32)
             for k, g in jl0.groups.items()}
    jl0.forward_train = functools.partial(JL.L0Module.forward_train, jl0, noise=noise)
    frozen_zs = jl0.forward_deterministic({"loga": l0p["loga"]}) if frozen else None
    b = _batch(task)
    jstep = _jax_step(task, js, jt, jl0, jopts, frozen_zs)
    # compiled: JAX's eager autodiff over the two models is far slower
    new_jstate, jmetrics = jax.jit(jstep)(jstate, jax.tree.map(jnp.asarray, b),
                                          jax.random.PRNGKey(9),
                                          jax.tree.map(jnp.asarray, tparams))
    before = None
    if frozen:
        before = [[t.detach().clone() if isinstance(t, torch.Tensor) else t
                   for t in TO.tree_leaves(x)] for x in (tstate.loga, tstate.lam,
                                                          tstate.l0_state, tstate.lam_state)]
    tstep = td.build_step(
        tconf, ts, tt, tl0, topts, teacher_params=params_from_numpy(tparams, device="cpu"),
        frozen_zs=None if frozen_zs is None else {k: _t(v) for k, v in frozen_zs.items()})
    tmetrics = tstep(tstate, _torch_batch(b), None, noise=noise)
    return dict(new_jstate=new_jstate, jmetrics=jmetrics, tstate=tstate, tmetrics=tmetrics,
                l0p=l0p, before=before)


STEP_CASES = [("vqa", False), ("captioning", False), ("vqa", True)]
STEP_IDS = ["vqa", "captioning", "vqa_stop_prune"]


@pytest.mark.parametrize("task,frozen", STEP_CASES, ids=STEP_IDS)
def test_task_step_losses_match_jax(task, frozen):
    run = _one_step(task, frozen)
    j, t = run["jmetrics"], run["tmetrics"]
    assert set(t) == set(j)
    for k in j:
        np.testing.assert_allclose(float(t[k]), float(np.asarray(j[k])), rtol=2e-4, atol=1e-6,
                                   err_msg=k)
    assert (float(t["lagrangian_loss"]) == 0.0) == frozen


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


def _trees(run, frozen):
    """(JAX tree, JAX optimizer state, port tree, port moments, lr) of the
    params, and without stop_prune of the log-alphas and the λs."""
    new_j, t = run["new_jstate"], run["tstate"]
    out = [(new_j.params, new_j.opt_state, t.params, t.opt_state["mu"], LR)]
    if not frozen:
        out += [(new_j.loga, new_j.l0_state, t.loga, t.l0_state["mu"], REG_LR),
                (new_j.lam, new_j.lam_state, t.lam, t.lam_state["mu"], REG_LR)]
    return out


@pytest.mark.parametrize("task,frozen", STEP_CASES, ids=STEP_IDS)
def test_task_step_gradients_match_jax(task, frozen):
    """Gradients (clipped) of the params, log-alphas and λs, read as each
    side's Adam first moment after the step; the PAD row of the word
    embeddings got none."""
    run = _one_step(task, frozen)
    for jtree, jopt_state, ttree, tmu, _ in _trees(run, frozen):
        want = dict(jax.tree_util.tree_leaves_with_path(_first_moments(jopt_state)))
        got = TO.tree_leaves_with_path(ttree)
        assert len(want) == len(got)
        for (path, _), mu in zip(got, tmu):
            w = np.asarray(want[_key(path)]) / (1 - B1)
            np.testing.assert_allclose(mu.numpy() / (1 - B1), w, rtol=5e-3,
                                       atol=max(5e-4 * float(np.abs(w).max()), 1e-8),
                                       err_msg=str(path))
    t = run["tstate"]
    mu = dict(zip([p for p, _ in TO.tree_leaves_with_path(t.params)], t.opt_state["mu"]))
    assert float(mu[("text_decoder", "embeddings", "word", "embedding")][0].abs().max()) == 0.0


@pytest.mark.parametrize("task,frozen", STEP_CASES, ids=STEP_IDS)
def test_task_step_updates_match_jax(task, frozen):
    """The params (and without stop_prune the log-alphas and λs) after the
    updates; with stop_prune the log-alphas, λs and both of their optimizer
    states are bit-identical to before the step."""
    run = _one_step(task, frozen)
    for jtree, jopt_state, ttree, _, lr in _trees(run, frozen):
        want = dict(jax.tree_util.tree_leaves_with_path(jtree))
        mus = dict(jax.tree_util.tree_leaves_with_path(_first_moments(jopt_state)))
        for path, got in TO.tree_leaves_with_path(ttree):
            w = np.asarray(want[_key(path)], np.float64)
            g = np.abs(np.asarray(mus[_key(path)], np.float64)) / (1 - B1)
            allowed = 5e-4 * np.abs(w) + lr * np.minimum(1.0, _grad_tol(g) / (g + EPS)) + 1e-7
            err = np.abs(got.detach().numpy() - w)
            assert (err <= allowed).all(), f"{path}: max err {err.max():.3e}"
    t = run["tstate"]
    assert t.step == 1 == int(run["new_jstate"].step)
    if frozen:
        after = [TO.tree_leaves(x) for x in (t.loga, t.lam, t.l0_state, t.lam_state)]
        for b, a in zip(run["before"], after):
            assert len(a) == len(b)
            assert all(torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
                       for x, y in zip(a, b))
    else:
        g1 = float(t.lam_state["mu"][0]) / (1 - B1)
        assert (float(t.lam["lambda_1"].detach()) - float(run["l0p"]["lambda_1"])) * g1 > 0


# ---------------------------------------------------------------------------
# the export
# ---------------------------------------------------------------------------


def _det_zs(task):
    l0 = DRIVERS[task][0].build_l0(_config(jcfg, task))
    return jax.tree.map(np.asarray, l0.forward_deterministic({"loga": _l0_np(task)["loga"]}))


@pytest.mark.parametrize("task", TASKS)
def test_export_and_load_zs_match_jax(task):
    """prune_xvlm_params leaf by leaf (the VQA answer decoder by its
    decoder_* gates at fusion 0, the captioning decoder by the text / cross
    gates), the gates' drops really slicing; load_zs_from_params with
    decoder_groups against JAX's."""
    jp, zs = _init_np(task, "student"), _det_zs(task)
    assert any(float(z.min()) == 0.0 for k, z in zs.items() if k.endswith("head_z"))
    fusion, head_dim = TEXT_S["fusion_layer"], 16
    ref = JE.prune_xvlm_params(jp, zs, fusion_layer=fusion, head_dim=head_dim)
    got = TE.prune_xvlm_params(params_from_numpy(jp, device="cpu"),
                               {k: _t(v) for k, v in zs.items()}, fusion_layer=fusion,
                               head_dim=head_dim)

    def walk(g, r, path):
        if r is None:
            assert g is None, path
        elif isinstance(r, dict):
            assert set(g) == set(r), path
            for k in r:
                walk(g[k], r[k], f"{path}/{k}")
        elif isinstance(r, (list, tuple)):
            assert len(g) == len(r), path
            for i, (gi, ri) in enumerate(zip(g, r)):
                walk(gi, ri, f"{path}[{i}]")
        else:
            assert tuple(g.shape) == np.shape(r), path
            _close(g, r, 0.0, path)

    walk(got, ref, "")
    dec = [lp.get(k) for lp in got["text_decoder"]["layers"]
           for k in ("attention", "crossattention")]
    assert any(a is not None and a["q"]["kernel"].shape[1] < 64 for a in dec)
    kw = dict(num_heads=4, intermediate_size=96, head_dim=head_dim, fusion_layer=fusion,
              decoder_groups=task == "vqa")
    for tree in (ref, {k: v for k, v in ref.items() if k != "text"}):
        want = JE.load_zs_from_params(tree, **kw)
        have = TE.load_zs_from_params(got if tree is ref else
                                      {k: v for k, v in got.items() if k != "text"}, **kw)
        assert set(have) == set(want)
        for k in want:
            np.testing.assert_array_equal(have[k], np.asarray(want[k]), err_msg=k)
    assert ("decoder_head_z" in have) == (task == "vqa")


@pytest.mark.parametrize("task", TASKS)
def test_pruned_forward_matches_gated_dense(task):
    """The exported student against the dense student under the same
    deterministic zs: the task loss and logits; VQA's ranked answers too."""
    _, _, ts, _ = _models(task)
    zs = {k: _t(v) for k, v in _det_zs(task).items()}
    dense = params_from_numpy(_init_np(task, "student"), device="cpu")
    pruned = TE.prune_xvlm_params(dense, zs, fusion_layer=TEXT_S["fusion_layer"], head_dim=16)
    tb = _torch_batch(_batch(task, 9))
    kw = dict(output_attentions=True, output_hidden_states=True, train=False)
    with torch.no_grad():
        gated, cut = _forward(task, ts, dense, tb, zs, **kw), _forward(task, ts, pruned, tb,
                                                                       None, **kw)
        _close(cut["loss"], gated["loss"], SLICE_ATOL, "loss")
        _close(cut["logits_dict"]["logits"], gated["logits_dict"]["logits"], SLICE_ATOL,
               "logits")
        if task == "vqa":
            args = (tb["image"], tb["q_ids"], tb["q_atts"], tb["a_ids"], tb["a_atts"])
            ids_g, probs_g = ts.forward_eval(dense, *args, k=3, zs=zs)
            ids_p, probs_p = ts.forward_eval(pruned, *args, k=3)
            _close(probs_p, probs_g, SLICE_ATOL, "topk probs")
            assert torch.equal(ids_p, ids_g)
        else:
            prompt = tb["caption_ids"][:, :2]
            g = ts.generate(dense, tb["image"], prompt, max_length=6, min_length=2, zs=zs)
            p = ts.generate(pruned, tb["image"], prompt, max_length=6, min_length=2)
            assert torch.equal(g, p)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_shards", [1, 2])
def test_vqa_collate_matches_jax(n_shards):
    rng = np.random.default_rng(10)
    samples = [(rng.standard_normal((2, 2, 3)).astype(np.float32), f"q{i}",
                [f"a{i}.{j}" for j in range(n)], list(rng.uniform(0, 1, n)))
               for i, n in enumerate((3, 1, 10, 2))]
    for pad_multiple in (1, 8):
        ref = JDS.vqa_collate(samples, pad_multiple=pad_multiple, n_shards=n_shards)
        got = TCol.vqa_collate(samples, pad_multiple=pad_multiple, n_shards=n_shards)
        np.testing.assert_array_equal(got[0], ref[0])
        assert got[1] == ref[1] and got[2] == ref[2]
        np.testing.assert_array_equal(got[3], ref[3])
        np.testing.assert_array_equal(got[4], ref[4])
        assert got[4].dtype == np.int64 and len(got[2]) % (pad_multiple * n_shards) == 0
    with pytest.raises(ValueError, match="shards"):
        TCol.vqa_collate(samples[:3], n_shards=2)


def test_preprocess_train_without_flip_matches_jax():
    """preprocess_train(hflip=False) against JAX's per-sample composition on
    the same draws (crop, the two ops, normalise; no flip), and
    randaug=False leaves the crop alone; the flags draw the same numbers.
    The VQA step wraps preprocessing without the flip."""
    rng = np.random.default_rng(11)
    n, h, w, out = 4, 30, 26, 16
    pixels = rng.integers(0, 256, (n, h, w, 3)).astype(np.uint8)
    params = TP.sample_train_params(torch.Generator().manual_seed(0), n, h, w)
    params["flip"] = torch.ones(n, dtype=torch.bool)  # a flip would show
    params["ops"] = torch.tensor([[3, 9, 1, 11], [5, 6, 7, 8]])  # no threshold ops
    got = TP.preprocess_train(_t(pixels), out, params=params, hflip=False)
    crop_only = TP.preprocess_train(_t(pixels), out, params=params, hflip=False, randaug=False)
    jops = JP.make_randaug_ops(0.7)
    mean, std = jnp.asarray(JP.CLIP_MEAN), jnp.asarray(JP.CLIP_STD)
    for i in range(n):
        x0, y0, cw, ch = (int(t[i]) for t in params["box"])
        img = jnp.asarray(pixels[i], jnp.float32)
        ys = y0 + (jnp.arange(out) * ch) // out
        xs = x0 + (jnp.arange(out) * cw) // out
        img = JP._resize(img[ys][:, xs], (out, out))
        _close(crop_only[i], (img / 255.0 - mean) / std, NORM_ATOL, f"crop {i}")
        for r in range(2):
            img = jops[int(params["ops"][r, i])](img, jnp.float32(float(params["signs"][r, i])))
        _close(got[i], (img / 255.0 - mean) / std, NORM_ATOL, f"sample {i}")
    a = TP.preprocess_train(_t(pixels), out, generator=torch.Generator().manual_seed(3),
                            hflip=False)
    b = TP.preprocess_train(_t(pixels), out, generator=torch.Generator().manual_seed(3),
                            params=None)
    drawn = TP.sample_train_params(torch.Generator().manual_seed(3), n, h, w)
    _close(b, TP.preprocess_train(_t(pixels), out, params=drawn), 0.0, "same draws")
    _close(a, TP.preprocess_train(_t(pixels), out, params=drawn, hflip=False), 0.0, "no flip")
    seen = {}
    conf = _config(tcfg, "vqa")
    conf.update(device_preprocess=True, image_res=out)
    step = TVqa.build_step(conf, *_models("vqa")[2:], None, None, teacher_params=None)
    assert isinstance(step, TC.DevicePreprocess) and not step.hflip and step.randaug
    step.step = lambda state, batch, generator, **kw: seen.update(batch, **kw)
    step(None, {"image": _t(pixels)}, torch.Generator().manual_seed(0), noise="n")
    assert seen["image"].dtype == torch.float32 and seen["noise"] == "n"
