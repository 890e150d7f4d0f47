"""Port parity of general distillation (stage 1) against the JAX package, on
the CPU, in f32: the box ops, the ViT's region (local-attention) path, the
MLM and bbox losses, XVLMForPretrain.forward (general and region batches,
every loss and every KD tap), gd_kd_losses, one whole GD step (general and
region) and one plain pretrain step, and the device image pipeline's ops.

Randomness is pinned, not matched: the dropout rates are 0 and both sides
draw their hard negatives as the argmax of their own sampling weights; the
image pipeline is fed the same crop boxes, flips, ops and signs.

Region batches, and a difference the port keeps on purpose: JAX's
XVLM.get_vision_embeds returns the full-attention image rows ungathered, so
its bbox head fails when a batch has more texts than images. The port
gathers each text's image row (idx_to_group_img) as the reference does. At
n_img = n_txt with idx_to_group_img = arange the two agree as they are; at
2 images / 3 texts the port is compared with a JAX subclass, defined here,
that gathers the same way.

Tolerances: atol 2e-5 for a module and 1e-4 for a whole forward (f32, the
same arithmetic in another order); a step as tests/test_torch_train.py holds
one: losses rtol 2e-4, gradients (Adam's first moments / (1 - b1)) rtol
5e-3 with a floor of 5e-4 of the leaf's largest gradient, the updated
params within 5e-4 relative plus what that gradient tolerance allows
through Adam's first step. The image ops are compared on the 0..1 scale the
pipeline normalises from (value / 255) at atol 2e-5, and normalised
images at that tolerance divided by CLIP's smallest std."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficientvlm_tpu import config as jcfg
from efficientvlm_tpu.data import device_pipeline as JP
from efficientvlm_tpu.drivers import common as JC
from efficientvlm_tpu.drivers import gd as JG
from efficientvlm_tpu.models import box_ops as JB
from efficientvlm_tpu.models import vit as JV
from efficientvlm_tpu.models.model_pretrain import XVLMForPretrain as JModel
from efficientvlm_tpu.ops import basic as JO
from efficientvlm_tpu.train import steps as JS
from efficientvlm_tpu_torch import config as tcfg
from efficientvlm_tpu_torch.bridge import params_from_numpy
from efficientvlm_tpu_torch.data import device_pipeline as TP
from efficientvlm_tpu_torch.drivers import common as TC
from efficientvlm_tpu_torch.drivers import gd as TG
from efficientvlm_tpu_torch.models import box_ops as TB
from efficientvlm_tpu_torch.models import vit as TV
from efficientvlm_tpu_torch.models.model_pretrain import XVLMForPretrain as TModel
from efficientvlm_tpu_torch.ops import basic as TO
from efficientvlm_tpu_torch.train import optim as TOpt
from efficientvlm_tpu_torch.train import steps as TS

torch.set_num_threads(1)
MODULE_ATOL, SLICE_ATOL = 2e-5, 1e-4
# the image tolerance on the 0..1 scale carried through CLIP's / std
NORM_ATOL = MODULE_ATOL / min(TP.CLIP_STD)
VOCAB, T_LEN, RES, PATCH = 100, 8, 32, 8
N_TOK = (RES // PATCH) ** 2 + 1
VISION_S = dict(vision_width=64, num_attention_heads=4, intermediate_size=96,
                num_hidden_layers=2, local_attn_depth=1, image_res=RES, patch_size=PATCH)
TEXT_S = dict(vocab_size=VOCAB, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
              intermediate_size=96, encoder_width=64, fusion_layer=1,
              max_position_embeddings=16, hidden_dropout_prob=0.0,
              attention_probs_dropout_prob=0.0)
VISION_T = dict(VISION_S, num_hidden_layers=4, local_attn_depth=2)
TEXT_T = dict(TEXT_S, num_hidden_layers=4, fusion_layer=2)
LR, B1, EPS = 1e-3, 0.9, 1e-8


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(port, ref, atol, what=""):
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    np.testing.assert_allclose(port, np.asarray(ref), atol=atol, rtol=0, err_msg=what)


def _config(mod, temp=0.07):
    # unrolled layers: JAX's drivers default to lax.scan, which compiles
    # each scanned body even outside jit
    cfgs = [cls.create(**d, scan_layers=False) for cls, d in (
        (mod.VisionConfig, VISION_S), (mod.TextConfig, TEXT_S), (mod.VisionConfig, VISION_T),
        (mod.TextConfig, TEXT_T))]
    return mod.Config({
        "embed_dim": 16, "temp": temp, "vision": cfgs[0], "text": cfgs[1],
        "teacher_vision": cfgs[2], "teacher_text": cfgs[3],
        "optimizer": {"lr": LR, "weight_decay": 0.01, "lr_mult": 2},
        "schedular": {"num_warmup_steps": 0}})


class JGathered(JModel):
    """JAX's model with the reference's gather of each text's full image row
    (what the port's get_vision_embeds does)."""

    def get_vision_embeds(self, params, image, *, idx_to_group_img=None, **kw):
        out = super().get_vision_embeds(params, image, idx_to_group_img=idx_to_group_img, **kw)
        if idx_to_group_img is None:
            return out
        embeds, atts, full, _, extra = out
        full = jnp.take(full, idx_to_group_img, axis=0)
        return embeds, atts, full, jnp.ones(full.shape[:2], jnp.int32), extra


def _pin_negatives(jm, tm):
    """Both sides take the argmax of their own sampling weights."""

    def j_pick(rng, image_feat, text_feat, *, idx=None, temp):
        sim = (image_feat @ text_feat.T).astype(jnp.float32) / temp
        mask = jnp.eye(sim.shape[0], dtype=bool)
        w_i2t = jnp.where(mask, 0.0, jax.nn.softmax(sim, axis=1) + 1e-5)
        w_t2i = jnp.where(mask, 0.0, jax.nn.softmax(sim.T, axis=1) + 1e-5)
        return jnp.argmax(w_t2i, axis=1), jnp.argmax(w_i2t, axis=1)

    def t_pick(generator, image_feat, text_feat, *, idx=None, temp):
        sim = (image_feat @ text_feat.t()).float() / temp
        mask = torch.eye(sim.shape[0], dtype=torch.bool)
        w_i2t = torch.where(mask, 0.0, torch.softmax(sim, dim=1) + 1e-5)
        w_t2i = torch.where(mask, 0.0, torch.softmax(sim.t(), dim=1) + 1e-5)
        return w_t2i.argmax(1), w_i2t.argmax(1)

    jm.sample_hard_negatives = j_pick
    tm.sample_hard_negatives = t_pick


def _batch(rng, n_img, idx=None):
    """A general batch of n_img images and texts, or with idx (the image of
    each text) a region batch: patch-box masks, boxes, is_image."""
    n_txt = n_img if idx is None else len(idx)
    ids = rng.integers(5, VOCAB, (n_txt, T_LEN)).astype(np.int32)
    atts = np.ones((n_txt, T_LEN), np.int32)
    ids[1, 6:], atts[1, 6:] = 0, 0  # a padded text
    masked = ids.copy()
    pos = np.zeros((n_txt, 3), np.int32)
    labels = np.full((n_txt, 3), -100, np.int32)
    for i in range(n_txt):
        n = 3 if i % 2 == 0 else 2  # rows with fewer masks pad with -100
        p = rng.choice(np.arange(1, 6), n, replace=False)
        pos[i, :n], labels[i, :n], masked[i, p] = p, ids[i, p], 3
    batch = {"image": rng.standard_normal((n_img, RES, RES, 3)).astype(np.float32),
             "text_ids": ids, "text_atts": atts, "text_ids_masked": masked,
             "masked_pos": pos, "masked_ids": labels}
    if idx is not None:
        g = RES // PATCH
        image_atts = np.zeros((n_txt, N_TOK), np.int32)
        image_atts[:, 0] = 1
        for i in range(n_txt):
            x0, y0 = rng.integers(0, g - 1, 2)
            grid = np.zeros((g, g), np.int32)
            grid[y0:y0 + 2, x0:x0 + 2] = 1
            image_atts[i, 1:] = grid.reshape(-1)
        c = rng.uniform(0.3, 0.7, (n_txt, 2))
        wh = rng.uniform(0.1, 0.4, (n_txt, 2))
        batch.update(image_atts=image_atts, idx_to_group_img=np.asarray(idx, np.int32),
                     target_bbox=np.concatenate([c, wh], 1).astype(np.float32),
                     is_image=(np.arange(n_txt) % 3 == 2).astype(np.int32))
    return batch


@functools.lru_cache(maxsize=None)
def _init_np(role):
    """JAX's init of the student (seed 0) or the teacher (seed 1) as numpy,
    bbox head included, made once a module: JAX's eager init compiles each
    of its ops and takes seconds a tree. Callers copy what they change."""
    student, teacher = JG.build_models(_config(jcfg))
    model, seed = (student, 0) if role == "student" else (teacher, 1)
    return jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(seed), with_bbox_head=True))


def _init_params(role, temp):
    return dict(_init_np(role), temp=np.asarray(temp, np.float32))


def _models(jcls=JModel):
    jconf, tconf = _config(jcfg), _config(tcfg)
    (jvs, jts), (tvs, tts) = JC.model_configs(jconf), TC.model_configs(tconf)
    jm, tm = jcls(jvs, jts, jconf), TModel(tvs, tts, tconf)
    jp = _init_params("student", 0.07)
    _pin_negatives(jm, tm)
    return jm, jp, tm, params_from_numpy(jp, device="cpu")


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------


def test_box_ops_match_jax():
    rng = np.random.default_rng(0)
    cxcywh = np.concatenate([rng.uniform(0.2, 0.8, (5, 2)), rng.uniform(0.05, 0.5, (5, 2))],
                            1).astype(np.float32)
    xyxy = np.asarray(JB.box_cxcywh_to_xyxy(cxcywh))
    _close(TB.box_cxcywh_to_xyxy(_t(cxcywh)), xyxy, MODULE_ATOL)
    _close(TB.box_xyxy_to_cxcywh(_t(xyxy)), JB.box_xyxy_to_cxcywh(xyxy), MODULE_ATOL)
    _close(TB.box_area(_t(xyxy)), JB.box_area(xyxy), MODULE_ATOL)
    other = xyxy[::-1].copy()
    for port, ref in zip(TB.box_iou(_t(xyxy), _t(other)), JB.box_iou(xyxy, other)):
        _close(port, ref, MODULE_ATOL)
    _close(TB.generalized_box_iou(_t(xyxy), _t(other)), JB.generalized_box_iou(xyxy, other),
           MODULE_ATOL)


@pytest.mark.parametrize("impl", ["fused", "plain"])
@pytest.mark.parametrize("n_img,idx", [(3, [0, 1, 2]), (2, [0, 0, 1])],
                         ids=["equal", "2img_3txt"])
def test_vit_region_path_matches_jax(impl, n_img, idx):
    """last_hidden (the region rows), full_atts_hidden, every hidden state
    (B rows before the gather, n_txt + B after) and every map."""
    rng = np.random.default_rng(1)
    cfg = dict(VISION_S, num_hidden_layers=3)
    jcfg_v, tcfg_v = jcfg.VisionConfig.create(**cfg), tcfg.VisionConfig.create(**cfg)
    jp = jax.tree.map(np.asarray, JV.init_vit(jax.random.PRNGKey(3), jcfg_v))
    b = _batch(rng, n_img, idx)
    kw = dict(output_attentions=True, output_hidden_states=True)
    ref = JV.vit_apply(jp, b["image"], jcfg_v, idx_to_group_img=b["idx_to_group_img"],
                       image_atts=b["image_atts"], **kw)
    got = TV.vit_apply(params_from_numpy(jp, device="cpu"), _t(b["image"]), tcfg_v,
                       idx_to_group_img=_t(b["idx_to_group_img"]).long(),
                       image_atts=_t(b["image_atts"]), impl=impl, **kw)
    n_txt = len(idx)
    assert tuple(got["last_hidden"].shape) == (n_txt, N_TOK, 64)
    assert [h.shape[0] for h in got["hidden_states"]] == [n_img] * 3 + [n_txt + n_img]
    for key in ("last_hidden", "full_atts_hidden"):
        _close(got[key], ref[key], MODULE_ATOL, key)
    for key in ("hidden_states", "attentions"):
        assert len(got[key]) == len(ref[key])
        for i, (g, r) in enumerate(zip(got[key], ref[key])):
            _close(g, r, MODULE_ATOL, f"{key}[{i}]")
    # the region maps give masked patches no weight
    masked = np.concatenate([b["image_atts"], np.ones((n_img, N_TOK), np.int32)]) == 0
    assert float(got["attentions"][-1].permute(0, 3, 1, 2)[torch.from_numpy(masked)].abs()
                 .max()) == 0.0


def test_vit_region_batch_needs_local_layers():
    cfg = tcfg.VisionConfig.create(**dict(VISION_S, local_attn_depth=0))
    params = TV.init_vit(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(ValueError, match="local_attn_depth"):
        TV.vit_apply(params, torch.zeros(1, RES, RES, 3), cfg,
                     idx_to_group_img=torch.zeros(1, dtype=torch.long),
                     image_atts=torch.ones(1, N_TOK))


def test_mlm_and_bbox_losses_match_jax():
    """get_mlm_loss (the multi_modal pass over the masked text, its taps),
    predict_bbox and get_bbox_loss with is_image, and the whole-batch
    degenerate-box switch."""
    jm, jp, tm, tp = _models()
    rng = np.random.default_rng(2)
    b = _batch(rng, 3)
    ie = rng.standard_normal((3, N_TOK, 64)).astype(np.float32)
    ia = np.ones((3, N_TOK), np.int32)
    ia[2, 10:] = 0
    kw = dict(output_attentions=True, output_hidden_states=True)
    ref_loss, ref = jm.get_mlm_loss(jp, b["text_ids_masked"], b["text_atts"], ie, ia,
                                    b["masked_pos"], b["masked_ids"], **kw)
    loss, got = tm.get_mlm_loss(tp, _t(b["text_ids_masked"]), _t(b["text_atts"]), _t(ie),
                                _t(ia), _t(b["masked_pos"]), _t(b["masked_ids"]).long(), **kw)
    _close(loss, ref_loss, MODULE_ATOL, "loss_mlm")
    _close(got["logits"], ref["logits"], MODULE_ATOL, "mlm logits")
    for key in ("hidden_states", "attentions", "cross_attentions"):
        for g, r in zip(got[key], ref[key], strict=True):
            _close(g, r, MODULE_ATOL, key)

    te = rng.standard_normal((3, T_LEN, 64)).astype(np.float32)
    coord = tm.predict_bbox(tp, _t(ie), _t(te), _t(b["text_atts"]))
    ref_coord = jm.predict_bbox(jp, ie, te, b["text_atts"])
    _close(coord, ref_coord, MODULE_ATOL, "coord")
    target = np.asarray([[0.5, 0.5, 0.2, 0.3], [0.4, 0.6, 0.3, 0.1], [0.3, 0.3, 0.1, 0.2]],
                        np.float32)
    degenerate = target.copy()
    degenerate[1, 2] = -0.1  # x1 < x0: the batch's GIoU loss is 0
    for tgt in (target, degenerate):
        for is_image in (None, np.asarray([0, 1, 0], np.int32), np.ones(3, np.int32)):
            ref_l = jm.get_bbox_loss(ref_coord, tgt, is_image=is_image)
            got_l = tm.get_bbox_loss(coord, _t(tgt),
                                     is_image=None if is_image is None else _t(is_image))
            for g, r in zip(got_l, ref_l):
                _close(g, r, MODULE_ATOL, "bbox losses")
    assert float(tm.get_bbox_loss(coord, _t(degenerate))[1]) == 0.0


def _forward_keys(region):
    keys = ["text_ids_masked", "masked_pos", "masked_ids"]
    if region:
        keys += ["image_atts", "idx_to_group_img", "target_bbox", "is_image"]
    return keys


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


@pytest.mark.parametrize("case", ["general", "region_equal", "region_2img_3txt"])
def test_pretrain_forward_matches_jax(case):
    """XVLMForPretrain.forward in KD mode: every loss and every tap."""
    region = case != "general"
    jm, jp, tm, tp = _models(JGathered if case == "region_2img_3txt" else JModel)
    rng = np.random.default_rng(3)
    idx = {"general": None, "region_equal": [0, 1, 2], "region_2img_3txt": [0, 0, 1]}[case]
    b = _batch(rng, 2 if case == "region_2img_3txt" else 3, idx)
    keys = _forward_keys(region)
    kw = dict(output_attentions=True, output_hidden_states=True, ret_bbox_loss=region)
    ref = jm.forward(jp, b["image"], b["text_ids"], b["text_atts"],
                     **{k: b[k] for k in keys}, **kw)
    tb = {k: _t(v) for k, v in b.items()}
    for k in ("masked_ids", "idx_to_group_img"):
        if k in tb:
            tb[k] = tb[k].long()
    got = tm.forward(tp, tb["image"], tb["text_ids"], tb["text_atts"],
                     **{k: tb[k] for k in keys}, **kw)
    assert set(got["loss"]) == set(ref["loss"]) == (
        {"loss_itc", "loss_itm", "loss_mlm"} | ({"loss_bbox", "loss_giou"} if region else set()))
    for key in ("loss", "hidden_dict", "attention_dict", "cross_attention_dict", "logits_dict"):
        _tree_close(got[key], ref[key], SLICE_ATOL, key)
    for v in got["loss"].values():
        assert np.isfinite(float(v))


def test_region_forward_without_targets_skips_the_bbox_head():
    """A region forward without target_bbox (the GD teacher's) runs no bbox
    head and leaves every other loss and tap as the full forward gives
    them; GDTrainStep.teacher_forward's taps equal gd_teacher_taps of the
    full forward."""
    student, teacher = TG.build_models(_config(tcfg))
    tp = teacher.init(1, device="cpu", with_bbox_head=True)
    b = _batch(np.random.default_rng(4), 3, [0, 1, 2])
    tb = {k: _t(v) for k, v in b.items()}
    for k in ("masked_ids", "idx_to_group_img"):
        tb[k] = tb[k].long()
    kw = dict(output_attentions=True, output_hidden_states=True, ret_bbox_loss=True)
    args = (tp, tb["image"], tb["text_ids"], tb["text_atts"])
    gen = lambda: torch.Generator().manual_seed(0)  # noqa: E731  the same hard negatives
    full = teacher.forward(*args, **{k: tb[k] for k in _forward_keys(True)}, **kw,
                           generator=gen())
    cut = teacher.forward(*args, **{k: tb[k] for k in _forward_keys(True)
                                    if k not in ("target_bbox", "is_image")}, **kw,
                          generator=gen())
    assert set(cut["loss"]) == {"loss_itc", "loss_itm", "loss_mlm"}
    assert not any(k.startswith("bbox") for d in ("hidden_dict", "attention_dict",
                                                  "cross_attention_dict") for k in cut[d])
    for key in ("loss", "hidden_dict", "attention_dict", "cross_attention_dict",
                "logits_dict"):
        ref = {k: v for k, v in full[key].items() if not k.startswith(("bbox", "loss_bbox",
                                                                       "loss_giou"))}
        _tree_close(cut[key], ref, 0.0, key)
    vc, tc = student.vision_cfg, student.text_cfg
    layers = dict(vision_layers=vc["num_hidden_layers"], text_fusion=tc["fusion_layer"],
                  cross_layers=tc["num_hidden_layers"] - tc["fusion_layer"],
                  text_layers=tc["num_hidden_layers"])
    step = TS.make_gd_train_step(student, teacher, None, teacher_params=tp, with_bbox=True)
    _tree_close(step.teacher_forward(tb, gen()), TS.gd_teacher_taps(full, **layers), 0.0,
                "taps")


def _kd_tree(rng, scale=1.0, vision=3, text=2, layers=4):
    hid = lambda n, t=5: [scale * rng.standard_normal((2, t, 8)).astype(np.float32)  # noqa
                          for _ in range(n)]
    att = lambda n: [np.abs(rng.standard_normal((2, 2, 5, 5))).astype(np.float32)  # noqa
                     for _ in range(n)]
    cross = layers - text
    return {
        "hidden_dict": {"image_hidden_states": hid(vision + 1), "text_hidden_states": hid(text + 1),
                        "itm_pos_hidden_states": hid(cross + 1),
                        "itm_neg_hidden_states": hid(cross + 1),
                        "mlm_hidden_states": hid(layers + 1)},
        "attention_dict": {"image_attentions": att(vision), "text_attentions": att(text),
                           "itm_pos_attentions": att(cross), "itm_neg_attentions": att(cross),
                           "mlm_attentions": att(layers)},
        "logits_dict": {"itm_head_logits": rng.standard_normal((6, 2)).astype(np.float32),
                        "mlm_logits": rng.standard_normal((2, 3, 11)).astype(np.float32)},
    }


def test_gd_kd_losses_and_teacher_taps_match_jax():
    rng = np.random.default_rng(4)
    student = _kd_tree(rng, vision=7, text=2, layers=4)
    teacher = _kd_tree(rng, 2.0, vision=14, text=4, layers=8)
    tree = lambda x: jax.tree.map(_t, x)  # noqa: E731
    ref = JS.gd_kd_losses(student, teacher, temperature=2.0)
    got = TS.gd_kd_losses(tree(student), tree(teacher), temperature=2.0)
    assert set(ref) == set(got)
    for k in ref:
        _close(got[k], ref[k], MODULE_ATOL, k)
    # the cut teacher tree gives the same losses, one to one
    cut = TS.gd_teacher_taps(dict(tree(teacher), cross_attention_dict={}), vision_layers=7,
                             text_fusion=2, cross_layers=2, text_layers=4)
    assert len(cut["hidden_dict"]["image_hidden_states"]) == 8
    assert len(cut["attention_dict"]["mlm_attentions"]) == 4
    again = TS.gd_kd_losses(tree(student), cut, temperature=2.0)
    for k in ref:
        _close(again[k], ref[k], MODULE_ATOL, k)
    # a region tap that meets an entry of another batch is refused
    student["hidden_dict"]["image_hidden_states"][3] = np.zeros((3, 5, 8), np.float32)
    with pytest.raises(ValueError, match="KD entry"):
        TS.gd_kd_losses(tree(student), tree(teacher))


# ---------------------------------------------------------------------------
# one whole step
# ---------------------------------------------------------------------------


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


def _run_steps(kind):
    """JAX's jitted step and the port's on the same params and batch:
    (JAX state, JAX metrics, port state, port metrics)."""
    distill, region = kind != "pretrain", kind == "gd_region"
    jconf, tconf = _config(jcfg, temp=0.6), _config(tcfg, temp=0.6)
    (js, jt), (ts, tt) = JG.build_models(jconf), TG.build_models(tconf)
    for jm, tm in ((js, ts), (jt, tt)):
        _pin_negatives(jm, tm)
    sparams, tparams = _init_params("student", 0.6), _init_params("teacher", 0.6)
    jopt = JC.build_optimizers(sparams, jconf, 100)[0]
    topt = TC.build_optimizers(sparams, tconf, 100)[0]
    # a region batch of one text per image: JAX's bbox head needs that
    b = _batch(np.random.default_rng(5), 3, [0, 1, 2] if region else None)
    jbatch = jax.tree.map(jnp.asarray, b)
    if distill:
        jstep = JS.make_gd_train_step(js, jt, jopt, teacher_params=None, with_bbox=region,
                                      impl="fused")
    else:
        jstep = JS.make_pretrain_train_step(js, jopt, impl="fused")
    jstate = (jax.tree.map(jnp.asarray, sparams), jopt.init(sparams), jnp.asarray(0))
    # compiled: JAX's eager autodiff over the two models is far slower
    new_jstate, jmetrics = jax.jit(jstep)(jstate, jbatch, jax.random.PRNGKey(9),
                                          jax.tree.map(jnp.asarray, tparams))
    tstate = TS.init_pretrain_state(params_from_numpy(sparams, device="cpu"), topt)
    tstep = TG.build_step(tconf, ts, topt, teacher=tt if distill else None,
                          teacher_params=params_from_numpy(tparams, device="cpu"),
                          with_bbox=region)
    tb = {k: _t(v) for k, v in b.items()}
    for k in ("masked_ids", "idx_to_group_img"):
        if k in tb:
            tb[k] = tb[k].long()
    tmetrics = tstep(tstate, tb)
    return new_jstate, jmetrics, tstate, tmetrics


@pytest.fixture(scope="module", params=["gd_general", "gd_region", "pretrain"])
def one_step(request):
    return request.param, _run_steps(request.param)


def test_step_losses_match_jax(one_step):
    kind, (_, jmetrics, _, tmetrics) = one_step
    assert set(jmetrics) == set(tmetrics)
    for k in jmetrics:
        np.testing.assert_allclose(float(tmetrics[k]), float(jmetrics[k]), rtol=2e-4, atol=1e-6,
                                   err_msg=f"{kind} {k}")
    if kind != "pretrain":  # the losses sit at chance at init
        assert abs(float(tmetrics["loss_itm"]) - np.log(2)) < 0.1
        assert abs(float(tmetrics["loss_mlm"]) - np.log(VOCAB)) < 0.5


def test_step_gradients_match_jax(one_step):
    """The clipped gradients, read as each side's Adam first moment after
    the step: (1 - b1) * gradient."""
    kind, (new_j, _, t, _) = one_step
    want = dict(jax.tree_util.tree_leaves_with_path(_first_moments(new_j[1])))
    got = TOpt.tree_leaves_with_path(t.params)
    assert len(want) == len(got)
    for (path, _), mu in zip(got, t.opt_state["mu"]):
        w = np.asarray(want[_key(path)]) / (1 - B1)
        np.testing.assert_allclose(mu.numpy() / (1 - B1), w, rtol=5e-3,
                                   atol=max(5e-4 * float(np.abs(w).max()), 1e-8),
                                   err_msg=f"{kind} {path}")
    mu = dict(zip([p for p, _ in got], t.opt_state["mu"]))
    assert float(mu[("text", "embeddings", "word", "embedding")][0].abs().max()) == 0.0
    if kind == "gd_region":
        assert float(mu[("bbox_head", "fc2", "kernel")].abs().max()) > 0


def test_step_updates_match_jax(one_step):
    """The params after the update and the temperature clamp (temp starts
    at 0.6, above the clamp's 0.5)."""
    kind, (new_j, _, t, _) = one_step
    want = dict(jax.tree_util.tree_leaves_with_path(new_j[0]))
    mus = dict(jax.tree_util.tree_leaves_with_path(_first_moments(new_j[1])))
    for path, got in TOpt.tree_leaves_with_path(t.params):
        w = np.asarray(want[_key(path)], np.float64)
        g = np.abs(np.asarray(mus[_key(path)], np.float64)) / (1 - B1)
        allowed = 5e-4 * np.abs(w) + LR * np.minimum(1.0, _grad_tol(g) / (g + EPS)) + 1e-7
        err = np.abs(got.detach().numpy() - w)
        assert (err <= allowed).all(), f"{kind} {path}: max err {err.max():.3e}"
    assert float(t.params["temp"].detach()) == pytest.approx(0.5) and t.step == 1 == int(new_j[2])


# ---------------------------------------------------------------------------
# the device image pipeline
# ---------------------------------------------------------------------------

OPS = ["identity", "autocontrast", "equalize", "rotate", "solarize", "color", "contrast",
       "brightness", "sharpness", "shear_x", "shear_y", "translate_x", "translate_y",
       "posterize"]


def _image(rng, n=1, h=20, w=24):
    return rng.integers(0, 256, (n, h, w, 3)).astype(np.uint8)


@pytest.mark.parametrize("op", OPS)
def test_randaugment_op_matches_jax(op):
    """Each op at magnitude 7, both signs, on 0..255 images (a low-contrast
    one too, for autocontrast and equalize)."""
    rng = np.random.default_rng(6)
    imgs = np.concatenate([_image(rng, 2), (_image(rng, 1) // 4 + 60)]).astype(np.float32)
    k = OPS.index(op)
    jop = JP.make_randaug_ops(0.7)[k]
    top = TP.make_randaug_ops(0.7)[k]
    for sign in (1.0, -1.0):
        ref = np.stack([np.asarray(jop(jnp.asarray(im), jnp.float32(sign))) for im in imgs])
        got = top(_t(imgs), torch.full((len(imgs),), sign))
        _close(got / 255.0, ref / 255.0, MODULE_ATOL, f"{op} sign {sign}")


def test_crop_resize_given_a_box_matches_jax():
    """JAX's random_resized_crop from a key, and the port's crop_resize on
    the box that key draws (the draw written out as JAX takes it)."""
    rng = np.random.default_rng(7)
    img = _image(rng, 1, 37, 41)[0].astype(np.float32)
    h, w, out = 37, 41, 16
    for seed in range(4):
        key = jax.random.PRNGKey(seed)
        ref = JP.random_resized_crop(key, jnp.asarray(img), out)
        k1, k2, k3, k4 = jax.random.split(key, 4)
        area = h * w * jax.random.uniform(k1, minval=0.5, maxval=1.0)
        aspect = jnp.exp(jax.random.uniform(k2, minval=jnp.log(0.75), maxval=jnp.log(4 / 3)))
        cw = jnp.clip(jnp.sqrt(area * aspect), 8, w).astype(jnp.int32)
        ch = jnp.clip(jnp.sqrt(area / aspect), 8, h).astype(jnp.int32)
        x0 = jax.random.randint(k3, (), 0, jnp.maximum(w - cw, 1))
        y0 = jax.random.randint(k4, (), 0, jnp.maximum(h - ch, 1))
        box = tuple(torch.tensor([int(v)]) for v in (x0, y0, cw, ch))
        got = TP.crop_resize(_t(img)[None], box, out)[0]
        _close(got / 255.0, np.asarray(ref) / 255.0, MODULE_ATOL, f"seed {seed}")


@pytest.mark.parametrize("size", [(224, 224), (17, 30), (50, 12)],
                         ids=["shrink", "mixed", "grow"])
def test_resize_and_preprocess_eval_match_jax(size):
    """jax.image.resize's antialiased Keys bicubic, shrinking, growing and
    both at once; preprocess_eval at 257 -> 224."""
    rng = np.random.default_rng(8)
    if size == (224, 224):
        pixels = _image(rng, 2, 257, 257)
        _close(TP.preprocess_eval(_t(pixels), 224), JP.preprocess_eval(pixels, 224),
               NORM_ATOL, "preprocess_eval")
        return
    img = _image(rng, 1, 31, 23)[0].astype(np.float32)
    ref = JP._resize(jnp.asarray(img), size)
    _close(TP.resize(_t(img)[None], size)[0] / 255.0, np.asarray(ref) / 255.0, MODULE_ATOL)


def test_preprocess_train_matches_jax_composition():
    """preprocess_train on drawn params against JAX's per-sample pipeline
    (crop, flip, the two ops, normalise) composed from its own functions on
    the same draws. Ops that threshold a value (equalize, solarize,
    posterize) are not drawn after a geometric op: a last-digit difference
    there may cross a threshold."""
    rng = np.random.default_rng(9)
    n, h, w, out = 6, 40, 36, 16
    pixels = _image(rng, n, h, w)
    params = TP.sample_train_params(torch.Generator().manual_seed(0), n, h, w)
    smooth = [0, 1, 3, 5, 6, 7, 8, 9, 10, 11, 12]
    params["ops"] = torch.tensor([[3, 9, 1, 11, 0, 12], [5, 6, 7, 8, 10, 1]])
    assert all(int(k) in smooth for k in params["ops"].reshape(-1))
    got = TP.preprocess_train(_t(pixels), out, params=params)
    jops = JP.make_randaug_ops(0.7)
    mean, std = jnp.asarray(JP.CLIP_MEAN), jnp.asarray(JP.CLIP_STD)
    for i in range(n):
        x0, y0, cw, ch = (int(t[i]) for t in params["box"])
        img = jnp.asarray(pixels[i], jnp.float32)
        ys = y0 + (jnp.arange(out) * ch) // out
        xs = x0 + (jnp.arange(out) * cw) // out
        img = JP._resize(img[ys][:, xs], (out, out))
        if bool(params["flip"][i]):
            img = img[:, ::-1]
        for r in range(2):
            img = jops[int(params["ops"][r, i])](img, jnp.float32(float(params["signs"][r, i])))
        ref = (img / 255.0 - mean) / std
        _close(got[i], ref, NORM_ATOL, f"sample {i}")


def test_device_preprocess_wraps_the_general_step():
    """build_step with device_preprocess takes uint8 images: the generator
    draws the pipeline first, the step then sees normalised f32 images."""
    seen = {}
    conf = tcfg.Config({"device_preprocess": True, "image_res": 16})
    step = TG.build_step(conf, None, None, teacher=None)
    assert isinstance(step, TG.DevicePreprocess)
    step.step = lambda state, batch, generator: seen.update(batch)
    pixels = torch.randint(0, 256, (2, 19, 19, 3), dtype=torch.uint8)
    step(None, {"image": pixels}, torch.Generator().manual_seed(0))
    assert seen["image"].dtype == torch.float32 and tuple(seen["image"].shape) == (2, 16, 16, 3)
    region = TG.build_step(conf, None, None, teacher=None, with_bbox=True)
    assert not isinstance(region, TG.DevicePreprocess)


# ---------------------------------------------------------------------------
# the dense bias rounding (a known difference from JAX)
# ---------------------------------------------------------------------------


def _ulp(x):
    """The bf16 ulp at |x| (8 significant bits); 2^-133 at 0 (the smallest
    subnormal step, negligible here)."""
    x = np.abs(np.asarray(x, np.float64))
    return np.exp2(np.floor(np.log2(np.maximum(x, 2.0 ** -126))) - 7)


def test_dense_bias_rounding_is_bounded_in_bf16():
    """The port's dense adds the bias inside F.linear and rounds once; JAX's
    rounds x @ W to bf16 and then adds the bias in bf16. With s = x @ W
    exact and y either result:
      JAX:  r = bf16(s), |r - s| <= ulp(s) / 2;  y_j = bf16(r + b),
            |y_j - (r + b)| <= ulp(y_j) / 2;
      port: y_p = bf16(s' + b) with s' the f32 sum, |s' - s| <= K 2^-24
            sum|x||W| (K terms), |y_p - (s' + b)| <= ulp(y_p) / 2;
    so |y_j - y_p| <= ulp(s) / 2 + ulp(max|y|) + K 2^-24 sum|x||W| per
    element, where ulp(max|y|) covers both final roundings."""
    rng = np.random.default_rng(10)
    k, n = 256, 96
    x = rng.standard_normal((64, k)).astype(np.float32)
    p = {"kernel": (rng.standard_normal((k, n)) * k ** -0.5).astype(np.float32),
         "bias": (rng.standard_normal(n) * 2).astype(np.float32)}
    ref = np.asarray(JO.dense(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                              dtype=jnp.bfloat16).astype(jnp.float32), np.float64)
    got = TO.dense({k_: _t(v) for k_, v in p.items()}, _t(x),
                   dtype=torch.bfloat16).float().numpy().astype(np.float64)
    xb = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32), np.float64)
    wb = np.asarray(jnp.asarray(p["kernel"], jnp.bfloat16).astype(jnp.float32), np.float64)
    s = xb @ wb
    bound = (_ulp(s) / 2 + _ulp(np.maximum(np.abs(ref), np.abs(got)))
             + k * 2.0 ** -24 * (np.abs(xb) @ np.abs(wb)))
    err = np.abs(got - ref)
    assert (err <= bound).all(), f"max err / bound {(err / bound).max():.3f}"
    assert err.max() > 0  # the two do round differently
