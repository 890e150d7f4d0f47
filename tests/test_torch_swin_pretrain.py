"""X-VLM-base's Swin tower and its pretraining path in the port against the
plain reference (benchmark/reference/swin.py and xvlm_pretrain.py), on the
CPU in f32 at a small size, on seeded random weights at the benchmark's
scales (benchmark/params.py):

- models/swin.swin_apply: a 2-stage tower whose first stage shifts and
  whose second stage's window is the whole grid, and a 3-stage one whose
  last grid is smaller than the window (the bias table's central block);
- the region form: region rows and full rows, the [CLS] of a region of one
  patch (that patch's token), of the whole image (the plain mean) and of
  a region in between;
- XVLM.get_vision_embeds with Swin region batches: the five-tuple, the
  region mask handed on as the fusion's image_atts;
- a general and a region PretrainTrainStep: each loss term and every
  gradient, the hard negatives taken from the port as the reference takes
  them, the dropout streams line up draw for draw;
- drivers/gd.train_steps: the interleave, the per-step generators, the
  streams drawn in order, the saves and the preemption; gd.main with
  use_swin on the synthetic corpus."""

import numpy as np
import pytest
import torch

from benchmark import params as BP
from benchmark.drivers import pretrain_train as PT
from benchmark.reference import swin as RS
from benchmark.reference import xvlm as R
from benchmark.reference import xvlm_pretrain as RP
from efficientvlm_tpu_torch import config as tcfg
from efficientvlm_tpu_torch.drivers import common as TDC
from efficientvlm_tpu_torch.drivers import gd as TG
from efficientvlm_tpu_torch.models import swin as TSw
from efficientvlm_tpu_torch.models.model_pretrain import XVLMForPretrain
from efficientvlm_tpu_torch.train.optim import create_optimizer, tree_leaves
from efficientvlm_tpu_torch.train.steps import init_pretrain_state, make_pretrain_train_step
from efficientvlm_tpu_torch.utils.logger import MetricLogger
from tests.test_torch_driver_gd import _args, _config, _restore_sigterm, corpus  # noqa: F401

torch.set_num_threads(1)
# 8 x 8 grid in windows of 4 shifted by 2, then a 4 x 4 grid in one window
TWO = dict(image_res=32, patch_size=4, embed_dim=16, depths=[2, 2], num_heads=[2, 4],
           window_size=4, mlp_ratio=4.0, vision_width=32)
# the last stage's 2 x 2 grid under a window of 4: the table's central block
THREE = dict(image_res=32, patch_size=4, embed_dim=8, depths=[2, 2, 1], num_heads=[1, 2, 4],
             window_size=4, mlp_ratio=4.0, vision_width=32)
TEXT = dict(vocab_size=1200, hidden_size=32, num_hidden_layers=4, fusion_layer=2,
            num_attention_heads=4, intermediate_size=64, hidden_act="gelu",
            hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1,
            max_position_embeddings=32, type_vocab_size=2, layer_norm_eps=1e-12,
            pad_token_id=0, encoder_width=32)
CFG = {"vision": TWO, "text": TEXT, "embed_dim": 16, "temp": 0.07, "image_res": 32,
       "patch_size": 8, "max_tokens": 12, "mask_prob": 0.25, "max_masks": 3,
       "images": {"batch_size": 4},
       "regions": {"batch_size": 6, "max_images": 3, "max_regions": 5, "iter_perc": 0.5},
       "optimizer": {"lr": 1e-3, "weight_decay": 0.01},
       "schedular": {"num_warmup_steps": 0}}
TRAFFIC = {"captions": {"words_min": 2, "words_mean": 5.0, "tokens_over_words": 3},
           "region_captions": {"words_min": 1, "words_mean": 2.0, "tokens_over_words": 2},
           "shipped_res": 36}


def _images(n, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal((n, 32, 32, 3))
                            .astype(np.float32))


def _swin_params(vision, seed=1):
    return BP.materialize(PT.swin_layout(vision), seed, "cpu")


@pytest.mark.parametrize("vision", [TWO, THREE], ids=["two_stages", "three_stages"])
def test_swin_tower_matches_reference(vision):
    params, img = _swin_params(vision), _images(2)
    got = TSw.swin_apply(params, img, tcfg.Config(vision))["last_hidden"]
    want = RS.swin(R.F32(), params, img, vision)
    last = (32 // 4 // 2 ** (len(vision["depths"]) - 1)) ** 2
    assert got.shape == want.shape == (2, 1 + last, 32)
    torch.testing.assert_close(got, want, rtol=0, atol=2e-5)


def _region_atts(kind):
    """image_atts [3, 1 + 16] of three texts on a 4 x 4 region grid."""
    atts = torch.zeros(3, 17, dtype=torch.int32)
    atts[:, 0] = 1
    if kind == "one_patch":
        atts[0, 1 + 5] = atts[1, 1 + 0] = atts[2, 1 + 15] = 1
    elif kind == "whole_image":
        atts[:] = 1
    else:
        atts[0, 1:9] = atts[1, 1 + 6] = atts[2, 1:] = 1
    return atts


@pytest.mark.parametrize("kind", ["one_patch", "whole_image", "mixed"])
def test_region_rows_match_reference(kind):
    params, img = _swin_params(TWO), _images(2, 3)
    idx, atts = torch.tensor([1, 0, 1]), _region_atts(kind)
    out = TSw.swin_apply(params, img, tcfg.Config(TWO), idx_to_group_img=idx, image_atts=atts)
    full, region = RS.swin(R.F32(), params, img, TWO, idx_to_group_img=idx, image_atts=atts)
    torch.testing.assert_close(out["full_atts_hidden"], full, rtol=0, atol=2e-5)
    torch.testing.assert_close(out["last_hidden"], region, rtol=0, atol=2e-5)
    rows = out["last_hidden"]
    torch.testing.assert_close(rows[:, 1:], out["full_atts_hidden"][idx, 1:], rtol=0, atol=0)
    if kind == "one_patch":  # the [CLS] of a region of one patch is that patch's token
        for r, p in enumerate((5, 0, 15)):
            torch.testing.assert_close(rows[r, 0], rows[r, 1 + p], rtol=0, atol=1e-6)
    if kind == "whole_image":
        torch.testing.assert_close(rows[:, 0], out["full_atts_hidden"][idx, 0], rtol=0,
                                   atol=1e-6)


@pytest.mark.parametrize("window,table_window", [(4, None), (2, 4), (7, None)],
                         ids=["window4", "clamped2of4", "window7"])
def test_rel_bias_gather_is_the_index(window, table_window):
    """The one-hot product reads each bias entry exactly, as indexing the
    table by _rel_pos_index does, and its backward sums the same entries."""
    tw = table_window or window
    table = torch.randn((2 * tw - 1) ** 2, 3, generator=torch.Generator().manual_seed(window))
    table.requires_grad_(True)
    index = torch.from_numpy(TSw._rel_pos_index(window, table_window).reshape(-1))
    gather = TSw._rel_gather_on(window, table_window, torch.device("cpu"))
    got, want = gather @ table, table[index]
    assert torch.equal(got, want)
    cot = torch.randn(got.shape, generator=torch.Generator().manual_seed(7))
    g_got, = torch.autograd.grad(got, table, cot)
    g_want, = torch.autograd.grad(want, table, cot)
    # sums of up to w^2 unit cotangents in another order: f32 rounding apart
    torch.testing.assert_close(g_got, g_want, rtol=1e-5, atol=1e-5)


def test_region_rows_refuse_a_mask_of_another_grid():
    with pytest.raises(ValueError, match="image_atts"):
        TSw.swin_apply(_swin_params(TWO), _images(1), tcfg.Config(TWO),
                       idx_to_group_img=torch.tensor([0]), image_atts=torch.ones(1, 50))


def _model():
    config = tcfg.Config({"use_swin": True, "embed_dim": 16, "temp": 0.07})
    return XVLMForPretrain(tcfg.Config(TWO), tcfg.TextConfig.create(**TEXT), config)


def test_get_vision_embeds_takes_swin_region_batches():
    model = _model()
    params = BP.materialize(PT.layout(CFG), 2, "cpu")
    img, idx, atts = _images(2, 4), torch.tensor([0, 1, 1]), _region_atts("mixed")
    region, image_atts, full, full_atts, _ = model.get_vision_embeds(
        params, img, idx_to_group_img=idx, image_atts=atts)
    want_full, want_region = RS.swin(R.F32(), params["vision"], img, TWO,
                                     idx_to_group_img=idx, image_atts=atts)
    torch.testing.assert_close(region, want_region, rtol=0, atol=2e-5)
    torch.testing.assert_close(full, want_full[idx], rtol=0, atol=2e-5)
    assert torch.equal(image_atts, atts) and image_atts.dtype == torch.int32
    assert full_atts.shape == (3, 17) and bool((full_atts == 1).all())


def _batch(region: bool):
    g = torch.Generator().manual_seed(7)
    if region:
        return PT.region_batch(CFG, TRAFFIC, g, "cpu")
    return dict(PT.general_batch(CFG, TRAFFIC, g, "cpu"), image=_images(4, 5))


@pytest.mark.parametrize("region", [False, True], ids=["general", "region"])
def test_pretrain_step_matches_reference(region):
    """PretrainTrainStep.loss_and_grads in f32 against the reference's
    forward and autograd from the same weights, batch and generator."""
    model = _model()
    params = BP.materialize(PT.layout(CFG), 3, "cpu")
    state = init_pretrain_state(params, create_optimizer(params, lr=1e-3))
    step = make_pretrain_train_step(model, None, with_bbox=region, dtype=None)
    drawn = []
    orig = model.sample_hard_negatives
    model.sample_hard_negatives = lambda *a, **kw: drawn.append(orig(*a, **kw)) or drawn[-1]
    batch = _batch(region)
    metrics, grads = step.loss_and_grads(state, batch, torch.Generator().manual_seed(11))

    ref_params = BP.materialize(PT.layout(CFG), 3, "cpu")
    leaves = tree_leaves(ref_params)
    for x in leaves:
        x.requires_grad_(True)
    terms = RP.forward(R.F32(), ref_params, CFG, batch, drawn[0],
                       torch.Generator().manual_seed(11), region=region)
    assert set(terms) == {k for k in metrics if k != "loss"}
    assert ("loss_bbox" in terms) == region
    for k, v in terms.items():
        assert abs(float(metrics[k]) - float(v.detach())) <= 2e-5 * abs(float(v.detach())), k
    want = torch.autograd.grad(sum(terms.values()), leaves, allow_unused=True)
    names = [n for n, _ in RP.leaves_with_paths(ref_params)]
    # leaves whose gradient is 0 in exact arithmetic (the key biases, under
    # the softmax) hold f32 noise: an absolute floor at 1e-4 of the median
    floor = 1e-4 * float(torch.stack([w.norm() for w in want if w is not None]).median())
    for name, x, g, w in zip(names, leaves, grads, want):
        g = torch.zeros_like(x) if g is None else g
        w = torch.zeros_like(x) if w is None else w
        assert float((g - w).norm()) <= 1e-4 * float(w.norm()) + floor, name
    neg_image, neg_text = drawn[0]
    own = torch.arange(neg_image.shape[0])
    assert not bool((neg_image == own).any() or (neg_text == own).any())


def test_region_batch_masks_are_the_datasets():
    """The benchmark's region boxes give, by the port's own rule
    (RegionTextDataset.get_image_attns), the image_atts they carry."""
    from efficientvlm_tpu_torch.data.datasets import RegionTextDataset

    batch = _batch(True)
    ds = RegionTextDataset.__new__(RegionTextDataset)
    ds.patch_size, ds.num_patch = 8, 4
    for atts, box, whole in zip(batch["image_atts"], batch["target_bbox"], batch["is_image"]):
        cx, cy, w, h = (float(v) * 32 for v in box)
        want = ds.get_image_attns(cx - w / 2, cy - h / 2, w, h)
        assert np.array_equal(atts.numpy(), want) or bool(whole)
        assert 1 <= int(atts[1:].sum()) <= 16
    # 6 of 3 images' 5 rows each: 6 / 5 whole-image captions, rounded, on distinct images
    whole = batch["idx_to_group_img"][batch["is_image"] == 1]
    assert whole.numel() == 1 and whole.unique().numel() == whole.numel()
    assert int(torch.bincount(batch["idx_to_group_img"]).max()) <= 5


class _Step:
    def __init__(self, kind, log):
        self.kind, self.log = kind, log

    def __call__(self, state, batch, generator):
        self.log.append((self.kind, batch, float(torch.rand((), generator=generator))))
        return {"loss": torch.tensor(float(len(self.log)))}


def test_train_steps_follows_the_interleave():
    """train_steps: step i draws the next batch of the stream its kind
    names and the generator step_generator(seed, 0, i); every ckpt_freq
    steps a save; the metrics logged one step late, all of them."""
    log, saves, logged = [], [], []
    logger = MetricLogger()
    logger.update = lambda **kw: logged.append(kw["loss"])
    general, region = iter(range(100)), iter(range(100, 200))
    out = TG.train_steps(range(10, 30), None, general, region, _Step("g", log),
                         _Step("r", log), seed=42, iter_perc=0.5, device="cpu", logger=logger,
                         prof=PT.NoProfiler(), save=lambda done, preempted: saves.append(
                             (done, preempted)), ckpt_freq=7)
    kinds = ["r" if TG.is_region_step(42, i, 0.5) else "g" for i in range(10, 30)]
    assert [k for k, _, _ in log] == kinds
    assert out["region_steps"] == [i for i in range(10, 30) if kinds[i - 10] == "r"]
    assert [b for k, b, _ in log if k == "g"] == list(range(kinds.count("g")))
    assert [b for k, b, _ in log if k == "r"] == list(range(100, 100 + kinds.count("r")))
    draws = [float(torch.rand((), generator=TDC.step_generator(42, 0, i, "cpu")))
             for i in range(10, 30)]
    assert [d for _, _, d in log] == draws
    assert saves == [(14, False), (21, False), (28, False)]
    assert logged == [float(i) for i in range(1, 21)]


def test_train_steps_saves_and_exits_when_preempted(monkeypatch):
    log, saves = [], []
    calls = iter([False, False, True])
    monkeypatch.setattr(TDC, "preempted", lambda: next(calls))
    with pytest.raises(SystemExit) as exc:
        TG.train_steps(range(5), None, iter(range(9)), None, _Step("g", log), None, seed=0,
                       iter_perc=0.5, device="cpu", logger=MetricLogger(),
                       prof=PT.NoProfiler(), save=lambda done, preempted: saves.append(
                           (done, preempted)))
    assert exc.value.code == 0 and len(log) == 3 and saves == [(3, True)]


def test_main_pretrains_the_swin_model(corpus, tmp_path, monkeypatch):  # noqa: F811
    """gd.main, task pretrain, with use_swin: both streams through the Swin
    tower (region steps 2 and 3 of 5), finite losses, the state stepped."""
    text = dict(_config(corpus)["text"], encoder_width=32)
    config = _config(corpus, use_swin=True, vision=tcfg.Config(TWO), text=tcfg.Config(text))
    losses = []
    orig = TG.train_steps

    def recorded(*a, **kw):
        update = kw["logger"].update
        kw["logger"].update = lambda **m: losses.append(m) or update(**m)
        return orig(*a, **kw)

    monkeypatch.setattr(TG, "train_steps", recorded)
    out = TG.main(_args(tmp_path, task="pretrain_4m_base"), config)
    assert out["region_steps"] == [2, 3] and out["state"].step == 5
    assert "stages" in out["state"].params["vision"]
    assert len(losses) == 5 and all(np.isfinite(m["loss"]) for m in losses)
    assert "loss_bbox" in losses[2] and "loss_bbox" not in losses[0]
