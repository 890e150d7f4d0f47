"""General distillation's loop on the CPU (efficientvlm_tpu_torch
drivers/gd.py main, drivers/common.stream_state / load_stream_state, the
CLI's gd_4m_small and pretrain_4m_small), against the JAX package where
JAX has the function:

- the interleave: step i is a region step exactly when JAX's GD makes it
  one (default_rng((seed, i)).random() < iter_perc, efficientvlm_tpu/
  drivers/gd.py:186-189);
- main against the general and region steps (build_step) applied by hand,
  in that order, to the two streams' batches with the same per-step
  generators: loss by loss and the final state, exactly; with the host's
  pretraining transform and with device_preprocess; the periodic
  snapshots, their rotation and log.txt;
- a run preempted after step 2 of 5 and resumed: the batches after the cut
  (masks, drawn captions, region crops) and the final state bit-equal to
  the uninterrupted run's, both streams' generators restored;
- JAX's gap: its resume restores the cursor alone, so the stream it
  resumes draws masks and augmentations the uninterrupted stream did not.

The corpus (two JSONL shards of base64 JPEGs: 8 image-text records, some
with caption lists, and 8 region records with elements) and the YAML
(configs/tests/Pretrain_synth.yaml with its paths, f32 compute) are
written into a temporary directory."""

import base64
import io
import json
import os
import signal

import numpy as np
import pytest
import torch
from PIL import Image

from efficientvlm_tpu import config as jcfg
from efficientvlm_tpu.data.datasets import PretrainImageTextDataset as JStream
from efficientvlm_tpu.data.tokenizer import build_tokenizer as j_tokenizer
from efficientvlm_tpu_torch import config as tcfg
from efficientvlm_tpu_torch import run as TRUN
from efficientvlm_tpu_torch.data.tokenizer import build_tokenizer
from efficientvlm_tpu_torch.drivers import common as TDC
from efficientvlm_tpu_torch.drivers import gd as TG
from efficientvlm_tpu_torch.train import checkpoint as TC
from efficientvlm_tpu_torch.train import steps as TS
from efficientvlm_tpu_torch.train.steps import init_pretrain_state
from efficientvlm_tpu_torch.utils import logger as TL

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED, STEPS, CUT = 42, 5, 2
WORDS = "dog cat tree car house bird boat sky park road table chair".split()


def _jpeg(rng, size) -> str:
    buf = io.BytesIO()
    Image.fromarray(np.uint8(rng.rand(size, size, 3) * 255)).save(buf, format="JPEG")
    return base64.b64encode(buf.getvalue()).decode()


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The YAML path of the two shards' corpus."""
    root = tmp_path_factory.mktemp("gd")
    rng = np.random.RandomState(0)
    (root / "general").mkdir()
    (root / "regions").mkdir()

    def caption(i):
        return f"a {WORDS[i % 12]} and the {WORDS[(5 * i) % 12]} photo number {i}"

    with open(root / "general" / "part0.jsonl", "w") as f:
        for i in range(8):
            cap = [caption(i), caption(i + 20), caption(i + 40)] if i % 2 else caption(i)
            f.write(json.dumps({"binary": _jpeg(rng, 40), "caption": cap}) + "\n")
    with open(root / "regions" / "part0.jsonl", "w") as f:
        for i in range(8):
            f.write(json.dumps({
                "binary": _jpeg(rng, 64), "caption": [caption(i), caption(i + 9)],
                "elems": [{"bb": [4, 4, 28, 28], "caption": f"a {WORDS[i % 12]} left"},
                          {"bb": [24 + i, 20, 30, 36],
                           "caption": [f"the {WORDS[(i + 1) % 12]}", f"one {WORDS[i % 12]}"],
                           "attributes": "small"}]}) + "\n")
    with open(os.path.join(ROOT, "configs/tests/Pretrain_synth.yaml")) as f:
        text = f.read().replace("/tmp/synth_pt_regions", str(root / "regions")).replace(
            "/tmp/synth_pt", str(root / "general"))
    path = root / "gd.yaml"
    path.write_text(text + "compute_dtype: f32\n")
    return str(path)


def _config(corpus, **extra):
    config = tcfg.load_task_config(corpus, repo_root=ROOT)
    config.update(extra)
    return config


def _args(out, **extra):
    return tcfg.Config({"seed": SEED, "output_dir": str(out), "device": "cpu",
                        "task": "gd_4m_small", "max_steps": STEPS, **extra})


def _flat(tree, prefix=""):
    if hasattr(tree, "__dataclass_fields__"):
        tree = {k: getattr(tree, k) for k in tree.__dataclass_fields__}
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _flat(sub, f"{prefix}/{key}").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree) for k, v in _flat(sub, f"{prefix}/{i}").items()}
    if isinstance(tree, torch.Tensor):
        return {prefix: tree.detach().numpy()}
    return {prefix: np.asarray(tree)}


def _assert_bit_equal(a, b):
    fa, fb = _flat(a), _flat(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        assert np.array_equal(fa[k], fb[k], equal_nan=True), k


@pytest.fixture(autouse=True)
def _restore_sigterm():
    before = signal.getsignal(signal.SIGTERM)
    yield
    signal.signal(signal.SIGTERM, before)
    TDC._PREEMPT.clear()


@pytest.fixture()
def recorded(monkeypatch):
    """Each GD step's call: its batch (numpy copies, as the step got it) and
    its metrics (floats), in order; after flag_after calls, SIGTERM."""
    rec = {"batches": [], "metrics": [], "flag_after": 0}
    orig = TS.GDTrainStep.__call__

    def call(self, state, batch, generator=None):
        rec["batches"].append({k: v.detach().numpy().copy() for k, v in batch.items()})
        out = orig(self, state, batch, generator)
        rec["metrics"].append({k: float(v) for k, v in out.items()})
        if rec["flag_after"] and len(rec["metrics"]) == rec["flag_after"]:
            os.kill(os.getpid(), signal.SIGTERM)
        return out

    monkeypatch.setattr(TS.GDTrainStep, "__call__", call)
    return rec


def jax_region_step(seed: int, step: int, iter_perc: float) -> bool:
    """JAX's interleave, as efficientvlm_tpu/drivers/gd.py:186-189 writes
    it."""
    return np.random.default_rng((seed, step)).random() < iter_perc


@pytest.mark.parametrize("iter_perc", [0.0, 0.3, 0.5, 1.0])
def test_interleave_matches_jax(iter_perc):
    for seed in (0, 42, 7):
        got = [TG.is_region_step(seed, i, iter_perc) for i in range(300)]
        assert got == [bool(jax_region_step(seed, i, iter_perc)) for i in range(300)]


def _by_hand(config, steps):
    """The general and region steps applied by hand in JAX's interleave over
    the two streams, with main's inits and per-step generators: (metrics
    per step, region steps, state)."""
    tok = build_tokenizer("")
    general, region, perc = TG.build_streams(config, tok, SEED)
    student, teacher = TG.build_models(config)
    params = student.init(0, device="cpu", with_bbox_head=True)
    tparams = teacher.init(1, device="cpu", with_bbox_head=True)
    opt = TDC.build_optimizers(params, config, TG.total_steps(config))[0]
    state = init_pretrain_state(params, opt)
    kw = dict(teacher=teacher, teacher_params=tparams)
    steps_by_kind = {False: TG.build_step(config, student, opt, **kw),
                     True: TG.build_step(config, student, opt, with_bbox=True, **kw)}
    streams = {False: iter(general.batches()),
               True: iter(region.batches(config["regions"]["max_images"]))}
    metrics, kinds = [], []
    for i in range(steps):
        kind = bool(jax_region_step(SEED, i, perc))
        kinds.append(kind)
        m = steps_by_kind[kind](state, TG.to_device(next(streams[kind]), "cpu"),
                                TDC.step_generator(SEED, 0, i, "cpu"))
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, [i for i, k in enumerate(kinds) if k], state


@pytest.mark.parametrize("device_preprocess", [False, True], ids=["host", "device_preprocess"])
def test_main_adds_nothing_to_the_steps(device_preprocess, corpus, tmp_path, monkeypatch):
    """main (5 steps, general and region interleaved) logs, loss by loss and
    exactly, what the two held steps give applied by hand in JAX's order to
    the streams' batches with the same per-step generators, and ends in the
    same state; every ckpt_frequent_step (2) steps a snapshot (the last
    ckpt_keep_last 1 kept) and a log.txt line with JAX's keys; at the end
    the final snapshot and the full state with both streams' state."""
    logged = []
    orig = TL.MetricLogger.update

    def update(self, **kw):
        logged.append(dict(kw))
        return orig(self, **kw)

    monkeypatch.setattr(TL.MetricLogger, "update", update)
    config = _config(corpus, device_preprocess=device_preprocess, ckpt_keep_last=1)
    out = TG.main(_args(tmp_path), config)
    monkeypatch.setattr(TL.MetricLogger, "update", orig)
    want, region_steps, state = _by_hand(_config(corpus, device_preprocess=device_preprocess),
                                         STEPS)
    assert out["region_steps"] == region_steps == [2, 3]
    assert logged == want
    assert "loss_bbox" in want[2] and "loss_bbox" not in want[0] and "loss_kd" in want[0]
    _assert_bit_equal(out["state"], state)
    assert out["state"].step == STEPS
    names = sorted(n for n in os.listdir(tmp_path) if n.endswith(".ckpt"))
    assert names == ["model_state_step_4.ckpt", "model_state_step_final.ckpt",
                     "training_state_latest.ckpt"]
    with open(tmp_path / "log.txt") as f:
        lines = [json.loads(x) for x in f]
    assert [x["step"] for x in lines] == [2, 4]
    assert {"train_loss", "train_loss_itc", "train_loss_itm", "train_loss_mlm",
            "train_loss_kd"} <= set(lines[0])
    assert all(k == "step" or k.startswith("train_") for x in lines for k in x)
    saved = TC.load_pytree(str(tmp_path / "training_state_latest.ckpt"))
    assert saved["extra"]["step"] == STEPS
    assert set(saved["extra"]["general_stream"]) == (
        {"epoch", "file", "line", "rng", "mask_rng"}
        | (set() if device_preprocess else {"transform_rng"}))
    assert "transform_rng" in saved["extra"]["region_stream"]


def test_preempt_and_resume_is_bit_exact(corpus, tmp_path, recorded):
    """SIGTERM after step 2 of 5: the full state is saved with the step and
    both streams' cursors and generators, main exits 0; --resume runs steps
    3-5 on the very batches the uninterrupted run had (the masks, the
    captions drawn from lists, the region crops and their boxes) and ends in
    a state bit-equal to its."""
    whole = TG.main(_args(tmp_path / "whole"), _config(corpus))
    whole_batches = recorded["batches"][:]
    recorded["batches"].clear()
    recorded["metrics"].clear()
    TDC.install_preemption_handler()
    recorded["flag_after"] = CUT
    with pytest.raises(SystemExit) as exc:
        TG.main(_args(tmp_path / "cut"), _config(corpus))
    assert exc.value.code == 0 and len(recorded["metrics"]) == CUT
    saved = TC.load_pytree(str(tmp_path / "cut" / "training_state_latest.ckpt"))
    assert saved["extra"]["step"] == CUT and saved["state"]["step"] == CUT
    assert saved["extra"]["general_stream"]["rng"]["bit_generator"] == "PCG64"
    TDC.install_preemption_handler()  # a new process starts unflagged
    recorded["flag_after"] = 0
    resumed = TG.main(_args(tmp_path / "cut", resume=True), _config(corpus))
    assert resumed["region_steps"] == [2, 3] and resumed["steps"] == STEPS - CUT
    after = recorded["batches"][CUT:]
    assert len(after) == STEPS - CUT
    for got, want in zip(after, whole_batches[CUT:]):
        assert sorted(got) == sorted(want)
        for k in want:
            assert np.array_equal(got[k], want[k]), k
    _assert_bit_equal(resumed["state"], whole["state"])


def _general_batches(stream, n):
    it = stream.batches()
    return [next(it) for _ in range(n)]


def test_jax_resume_redraws_the_stream(corpus):
    """JAX's GD restores the streams' cursors alone (efficientvlm_tpu/
    drivers/gd.py:98-117) into streams built afresh, so their generators
    start again from the seed: the batches after its resume are not the
    uninterrupted stream's (other masks and augmentations of the same
    records). The port's stream_state carries the generators: its resumed
    stream gives the uninterrupted batches exactly."""
    jconfig = jcfg.load_task_config(corpus, repo_root=ROOT)
    jtok = j_tokenizer("")
    whole = JStream(jconfig, jconfig["train_file"], jtok, seed=SEED)
    want = _general_batches(whole, 4)
    first = JStream(jconfig, jconfig["train_file"], jtok, seed=SEED)
    _general_batches(first, 2)
    cursor = first.stream.state_dict()
    resumed = JStream(jconfig, jconfig["train_file"], jtok, seed=SEED)
    resumed.stream.load_state_dict(cursor)
    got = _general_batches(resumed, 2)
    masks_differ = any(not np.array_equal(g["text_ids_masked"], w["text_ids_masked"])
                       for g, w in zip(got, want[2:]))
    images_differ = any(not np.array_equal(g["image"], w["image"]) for g, w in zip(got, want[2:]))
    assert masks_differ and images_differ

    config = _config(corpus)
    tok = build_tokenizer("")
    port_whole = _general_batches(TG.build_streams(config, tok, SEED)[0], 4)
    cut = TG.build_streams(config, tok, SEED)[0]
    _general_batches(cut, 2)
    saved = TDC.stream_state(cut)
    fresh = TG.build_streams(config, tok, SEED)[0]
    TDC.load_stream_state(fresh, saved)
    for g, w in zip(_general_batches(fresh, 2), port_whole[2:]):
        for k in w:
            assert np.array_equal(g[k], w[k]), k
    # uninterrupted, the two packages' streams give the same texts and masks
    for p, j in zip(port_whole, want):
        for k in ("text_ids", "text_atts", "text_ids_masked", "masked_pos", "masked_ids"):
            assert np.array_equal(p[k], j[k]), k


def test_pretrain_task_runs_without_a_teacher(corpus, tmp_path):
    """--task pretrain_4m_small through the CLI: the same loop, no teacher,
    no KD."""
    out = TRUN.main(["--task", "pretrain_4m_small", "--config", corpus, "--device", "cpu",
                     "--output_dir", str(tmp_path), "--max_steps", "3"])
    assert out["state"].step == 3 and out["region_steps"] == [2]
    with open(tmp_path / "log.txt") as f:
        line = json.loads(f.readline())
    assert line["step"] == 2 and "train_loss_mlm" in line and "train_loss_kd" not in line


def test_student_chkpt_comes_before_checkpoint(corpus, tmp_path):
    """--student_chkpt names the student's init ahead of --checkpoint (the
    reference's GD launch); the step-0 state holds the file's params."""
    config = _config(corpus)
    student = TG.build_models(config)[0]
    params = student.init(5, device="cpu", with_bbox_head=True)
    TC.save_pytree(str(tmp_path / "student.ckpt"), params)
    out = TG.main(_args(tmp_path / "out", max_steps=None, checkpoint="missing.th",
                        student_chkpt=str(tmp_path / "student.ckpt"), resume=False),
                  _config(corpus, schedular={"epochs": 0}))
    assert out["state"].step == 0
    _assert_bit_equal(out["state"].params, params)


def test_main_runs_on_the_card_by_default(corpus, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    args = _args(tmp_path)
    del args["device"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TG.main(args, _config(corpus))
