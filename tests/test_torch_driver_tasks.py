"""The fine-tunes' loops on the CPU (efficientvlm_tpu_torch drivers/vqa.py,
captioning.py, nlvr.py and grounding.py main and evaluation, data/utils
collect_result, the CLI's routing), against the JAX package where JAX has
the function:

- main against the held step (each driver's build_step) applied by hand
  to the same batches with the same per-step generators: loss by loss and
  the final state, exactly;
- a preempted epoch (SIGTERM after batch 2 of 4) and --resume: the final
  state bit-equal to the uninterrupted run's;
- --evaluate from a native snapshot (its stored gates) and from a
  params-only export (no gates) against JAX's evaluation on the same params
  and gates: VQA answers equal; captions equal and coco_caption_eval equal;
  NLVR logits within 1e-4 and the accuracy equal (the export against JAX's
  gated forward: JAX's NLVR export is not its gated model, ROADMAP C);
  grounding boxes within 1e-4 and grounding_eval_bbox equal;
- VQA's --stop_prune_epoch in the loop: from that epoch the step runs with
  frozen_zs, forward_deterministic of the gates at that epoch;
- collect_result against JAX's; every task name of the CLI reaching its
  driver's main.

The corpus (8 JPEGs of 40 x 40 and each task's annotations) and the YAMLs
(configs/tests/<task>_synth.yaml with its paths, num_workers 0, f32
compute) are written into a temporary directory."""

import functools
import json
import os
import signal
import stat

import numpy as np
import pytest
import torch
from PIL import Image

from efficientvlm_tpu import config as jcfg
from efficientvlm_tpu.data import datasets as JDS
from efficientvlm_tpu.data import utils as JU
from efficientvlm_tpu.data.tokenizer import build_tokenizer as j_tokenizer
from efficientvlm_tpu.data.transforms import ImageTransform as JTransform
from efficientvlm_tpu.drivers import captioning as JCap
from efficientvlm_tpu.drivers import grounding as JGr
from efficientvlm_tpu.drivers import nlvr as JNl
from efficientvlm_tpu.drivers import vqa as JVqa
from efficientvlm_tpu.evaluation import caption_metrics as JCM
from efficientvlm_tpu.evaluation import grounding as JEG
from efficientvlm_tpu.utils import io as JIO
from efficientvlm_tpu_torch import config as tcfg
from efficientvlm_tpu_torch.data import utils as TU
from efficientvlm_tpu_torch.data.collate import vqa_collate
from efficientvlm_tpu_torch.data.datasets import (CaptioningTrainDataset, GroundingBboxDataset,
                                                  NLVRDataset, SimpleLoader, VQADataset)
from efficientvlm_tpu_torch.data.tokenizer import build_tokenizer
from efficientvlm_tpu_torch.data.transforms import ImageTransform
from efficientvlm_tpu_torch.drivers import captioning as TCap
from efficientvlm_tpu_torch.drivers import common as TDC
from efficientvlm_tpu_torch.drivers import grounding as TGr
from efficientvlm_tpu_torch.drivers import nlvr as TNl
from efficientvlm_tpu_torch.drivers import vqa as TVqa
from efficientvlm_tpu_torch.pruning.export import prune_xvlm_params
from efficientvlm_tpu_torch.train import checkpoint as TC
from efficientvlm_tpu_torch.train import steps as TS
from efficientvlm_tpu_torch.train.steps import init_train_state
from efficientvlm_tpu_torch.utils import io as TIO
from efficientvlm_tpu_torch.utils import logger as TL

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED, N_IMG = 42, 8
TASKS = ("vqa", "captioning", "nlvr", "grounding")
PORT = {"vqa": TVqa, "captioning": TCap, "nlvr": TNl, "grounding": TGr}
JAX = {"vqa": JVqa, "captioning": JCap, "nlvr": JNl, "grounding": JGr}
YAML = {"vqa": "VQA", "captioning": "Captioning", "nlvr": "NLVR", "grounding": "Grounding"}
WORDS = "dog cat tree car house bird boat sky park road table chair".split()


def _write_corpus(root: str) -> dict:
    """Each task's files under root and its YAML; returns {task: yaml path}."""
    rng = np.random.RandomState(0)
    imgs = os.path.join(root, "imgs")
    os.makedirs(imgs)
    for i in range(N_IMG):
        Image.fromarray(np.uint8(rng.rand(40, 40, 3) * 255)).save(os.path.join(imgs, f"{i}.jpg"))

    def dump(name, obj):
        path = os.path.join(root, name)
        with open(path, "w") as f:
            json.dump(obj, f)
        return path

    def caption(i):
        return f"a {WORDS[(3 * i) % len(WORDS)]} photo of the {WORDS[i % len(WORDS)]} {i}"

    answers = ["dog", "cat", "two", "red", "left side"]
    files = {
        "vqa": {"train_file": [dump("vqa_train.json", [
                    {"image": f"{i}.jpg", "question": f"what is on the {WORDS[i]} {i}?",
                     "answer": [answers[i % 5], answers[(i + 1) % 5], answers[i % 5]],
                     "question_id": i} for i in range(N_IMG)])],
                "test_file": [dump("vqa_test.json", [
                    {"image": f"{i}.jpg", "question": f"what is this {WORDS[i]}?",
                     "question_id": 100 + i} for i in range(N_IMG // 2)])],
                "answer_list": dump("answers.json", answers), "vqa_root": imgs},
        "captioning": {"train_file": [dump("cap_train.json", [
                           {"image": f"{i}.jpg", "caption": caption(i), "image_id": f"im{i}"}
                           for i in range(N_IMG)])],
                       "val_file": dump("cap_val.json", [{"image": f"{i}.jpg"}
                                                         for i in range(N_IMG // 2)]),
                       "val_gt_file": dump("cap_gt.json", [
                           {"image_id": i, "caption": c} for i in range(N_IMG // 2)
                           for c in (caption(i), caption(i + 1))]),
                       "image_root": imgs},
        "nlvr": {"train_file": [dump("nlvr_train.json", [
                     {"images": [f"{i}.jpg", f"{(i + 3) % N_IMG}.jpg"],
                      "sentence": f"two {WORDS[i]} images {i}",
                      "label": "True" if i % 2 else "False"}
                     for i in range(N_IMG)])],
                 "val_file": dump("nlvr_val.json", [
                     {"images": [f"{i}.jpg", f"{i + 1}.jpg"], "sentence": f"a {WORDS[i]} left",
                      "label": i % 2 == 0} for i in range(N_IMG // 2)]),
                 "test_file": dump("nlvr_test.json", [
                     {"images": [f"{i + 2}.jpg", f"{i}.jpg"], "sentence": f"the {WORDS[i + 1]}",
                      "label": "True" if i < 2 else "False"} for i in range(N_IMG // 2)]),
                 "image_root": imgs},
        "grounding": {"train_file": [dump("ground.json", [
                          {"image": f"{i}.jpg", "text": f"the {WORDS[i]} on the "
                           + ("left" if i % 3 == 0 else "top"),
                           "bbox": [2 + i, 3, 20, 18 + i], "ref_id": i} for i in range(N_IMG)])],
                      "test_file": [os.path.join(root, "ground.json")],
                      "ref_boxes": dump("refs.json", {
                          str(i): {"bbox": [2 + i, 3, 20, 18 + i],
                                   "split": ("val", "testA", "testB")[i % 3]}
                          for i in range(N_IMG)}),
                      "image_root": imgs},
    }
    out = {}
    import yaml

    for task, paths in files.items():
        with open(os.path.join(ROOT, f"configs/tests/{YAML[task]}_synth.yaml")) as f:
            cfg = yaml.safe_load(f)
        cfg.update(paths, num_workers=0, compute_dtype="f32")
        out[task] = os.path.join(root, f"{task}.yaml")
        with open(out[task], "w") as f:
            yaml.safe_dump(cfg, f)
    return out


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return _write_corpus(str(tmp_path_factory.mktemp("tasks")))


def _config(corpus, task, **extra):
    config = tcfg.load_task_config(corpus[task], repo_root=ROOT)
    config.update(extra)
    return config


def _args(out, **extra):
    return tcfg.Config({"seed": SEED, "output_dir": str(out), "device": "cpu", **extra})


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


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_numpy_tree(v) for v in tree]
    return tree.numpy() if isinstance(tree, torch.Tensor) else tree


@pytest.fixture(autouse=True)
def _restore_sigterm():
    """main installs no handler, but the preemption tests send SIGTERM to
    this process: put SIGTERM's handler back and clear the flag after each
    test."""
    before = signal.getsignal(signal.SIGTERM)
    yield
    signal.signal(signal.SIGTERM, before)
    TDC._PREEMPT.clear()


@functools.lru_cache(maxsize=None)
def _trained(yaml_path: str, task: str, out: str):
    """main's uninterrupted epoch of a task (4 steps), run once a module:
    (its return, the metrics it logged)."""
    calls = []
    orig = TL.MetricLogger.update

    def update(self, **kw):
        calls.append(dict(kw))
        return orig(self, **kw)

    TL.MetricLogger.update = update
    try:
        config = tcfg.load_task_config(yaml_path, repo_root=ROOT)
        result = PORT[task].main(_args(out), config)
    finally:
        TL.MetricLogger.update = orig
    return result, calls


@pytest.fixture()
def trained(corpus, tmp_path_factory):
    cache = {}

    def get(task):
        if task not in cache:
            out = str(tmp_path_factory.getbasetemp() / f"trained-{task}")
            cache[task] = (*_trained(corpus[task], task, out), out)
        return cache[task]
    return get


# ---------------------------------------------------------------------------
# the loop against the step by hand
# ---------------------------------------------------------------------------


def _train_set(task, config, tok):
    """(dataset, collate_fn or None, make_batch) as each main builds them."""
    res = config["image_res"]
    if task == "vqa":
        ds = VQADataset(config["train_file"], ImageTransform.train_wohflip(res, seed=SEED),
                        config["vqa_root"], "", split="train", seed=SEED)
        return ds, vqa_collate
    if task == "captioning":
        return CaptioningTrainDataset(config["train_file"], ImageTransform.train(res, seed=SEED),
                                      config["image_root"], prompt=config["prompt"],
                                      max_words=config["max_tokens"]), None
    if task == "nlvr":
        return NLVRDataset(config["train_file"], ImageTransform.train(res, seed=SEED),
                           config["image_root"]), None
    return GroundingBboxDataset(config["train_file"], ImageTransform.box(res, seed=SEED),
                                config["image_root"], image_res=res, mode="train",
                                careful_hflip=True, seed=SEED), None


def _by_hand(task, config):
    """The held step (build_step) applied by hand over the loader's batches
    with main's inits and per-step generators: (metrics per step, state)."""
    mod = PORT[task]
    tok = build_tokenizer("")
    if task == "captioning":
        config["prompt_length"] = len(tok([config["prompt"]])["input_ids"][0]) - 1
        config["pad_token_id"] = tok.pad_token_id
    student, teacher = mod.build_models(config)
    l0 = mod.build_l0(config)
    ds, collate = _train_set(task, config, tok)
    loader = SimpleLoader(ds, batch_size=config["batch_size_train"], shuffle=True,
                          drop_last=True, collate_fn=collate)
    l0.lagrangian_warmup = len(loader)
    params = student.init(0, device="cpu")
    opts = mod.build_optimizers(params, config, len(loader))
    state = init_train_state(params, l0.init(2, device="cpu"), opts)
    tparams = None if task == "grounding" else teacher.init(1, device="cpu")
    step = mod.build_step(config, student, teacher, l0, opts, teacher_params=tparams)
    loader.set_epoch(0)
    metrics = []
    for i, items in enumerate(loader):
        m = step(state, mod.make_batch(items, tok, config, "cpu"),
                 TDC.step_generator(SEED, 0, i, "cpu"))
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, state


@pytest.mark.parametrize("task", TASKS)
def test_main_adds_nothing_to_the_step(task, corpus, trained):
    """main on the CPU (8 images, 4 steps) logs, loss by loss and exactly,
    what the held step gives applied by hand to the same batches with the
    same per-step generators, and ends in the same state; log.txt carries
    JAX's keys; the task's files are written."""
    out, logged_calls, out_dir = trained(task)
    want, state = _by_hand(task, _config(corpus, task))
    assert logged_calls == want and len(want) == 4
    _assert_bit_equal(out["state"], state)
    assert out["state"].step == 4 and out["epochs"][0]["steps"] == 4
    with open(os.path.join(out_dir, "log.txt")) as f:
        lines = [json.loads(x) for x in f]
    extra = {"vqa": {"eval_result_file"}, "captioning": {"Bleu_4", "CIDEr"},
             "nlvr": {"val_acc", "test_acc"}, "grounding": set()}[task]
    keys = set().union(*lines)
    assert {"epoch", "train_loss", "train_loss_task", "train_lagrangian_loss"} | extra <= keys
    files = {"vqa": ["model_state_step_0.ckpt", "vqa_result_epoch0.json"],
             "captioning": ["model_state_step_0.ckpt"], "nlvr": ["model_state_step_best.ckpt"],
             "grounding": []}[task]
    for name in files + ["training_state_latest.ckpt", "config.json"]:
        assert os.path.exists(os.path.join(out_dir, name)), name
    if task == "vqa":
        with open(os.path.join(out_dir, "vqa_result_epoch0.json")) as f:
            assert [r["question_id"] for r in json.load(f)] == [100, 101, 102, 103]


@pytest.mark.parametrize("task", TASKS)
def test_preempt_and_resume_is_bit_exact(task, corpus, trained, tmp_path, monkeypatch):
    """SIGTERM after batch 2 of 4: the full state is saved with the batch
    cursor and main exits 0; --resume finishes the epoch in a state
    bit-equal to the uninterrupted run's."""
    whole = trained(task)[0]["state"]
    TDC.install_preemption_handler()
    calls = []
    orig = TS.TaskTrainStep.__call__

    def flagging(self, *a, **kw):
        out = orig(self, *a, **kw)
        calls.append(1)
        if len(calls) == 2:
            os.kill(os.getpid(), signal.SIGTERM)
        return out

    monkeypatch.setattr(TS.TaskTrainStep, "__call__", flagging)
    with pytest.raises(SystemExit) as exc:
        PORT[task].main(_args(tmp_path), _config(corpus, task))
    assert exc.value.code == 0 and len(calls) == 2
    saved = TC.load_pytree(str(tmp_path / "training_state_latest.ckpt"))
    assert saved["extra"] == {"epoch": -1, "batches_done": 2, "preempted": True}
    TDC.install_preemption_handler()  # a new process starts unflagged
    resumed = PORT[task].main(_args(tmp_path, resume=True), _config(corpus, task))
    assert len(calls) == 4 and resumed["epochs"][0]["steps"] == 2
    _assert_bit_equal(resumed["state"], whole)


def test_vqa_stop_prune_in_the_loop(corpus, tmp_path, monkeypatch):
    """--stop_prune_epoch 1 over 2 epochs: epoch 0 trains the gates; at
    epoch 1 the step is rebuilt once with frozen_zs =
    forward_deterministic of the gates as epoch 0 left them, and from there
    the gates, λ and their optimizer states stay as they are and the
    Lagrangian is 0."""
    built, seen = [], {}
    orig_build, orig_call = TVqa.build_step, TS.TaskTrainStep.__call__

    def build(*a, frozen_zs=None, **kw):
        built.append(frozen_zs)
        return orig_build(*a, frozen_zs=frozen_zs, **kw)

    def call(self, state, batch, generator=None, **kw):
        if self.frozen_zs is not None and "loga" not in seen:
            seen["loga"] = {k: v.clone() for k, v in state.loga.items()}
            seen["l0_state"] = _flat(state.l0_state)
        out = orig_call(self, state, batch, generator, **kw)
        seen.setdefault("lagrangian", []).append((self.frozen_zs is not None,
                                                  float(out["lagrangian_loss"])))
        return out

    monkeypatch.setattr(TVqa, "build_step", build)
    monkeypatch.setattr(TS.TaskTrainStep, "__call__", call)
    config = _config(corpus, "vqa")
    config["schedular"]["epochs"] = 2
    out = TVqa.main(_args(tmp_path, stop_prune_epoch=1), config)
    assert len(built) == 2 and built[0] is None
    want = TVqa.build_l0(config).forward_deterministic({"loga": seen["loga"]})
    assert sorted(built[1]) == sorted(want)
    assert all(torch.equal(built[1][k], want[k]) for k in want)
    state = out["state"]
    assert all(torch.equal(state.loga[k], seen["loga"][k]) for k in seen["loga"])
    assert [f for f, _ in seen["lagrangian"]] == [False] * 4 + [True] * 4
    assert all(v == 0.0 for f, v in seen["lagrangian"] if f)
    assert any(v != 0.0 for f, v in seen["lagrangian"] if not f)
    assert _flat(state.l0_state).keys() == seen["l0_state"].keys()
    for k, v in _flat(state.l0_state).items():
        assert np.array_equal(v, seen["l0_state"][k]), k


def test_vqa_gates_agree_with_jax_on_the_shipped_config():
    """The port's build_l0 passes decoder_layers=num_dec_layers where JAX's
    leaves the default (the cross depth): on the shipped VQA_480.yaml the two
    are equal (3 and 3), and so are the gate groups."""
    path = os.path.join(ROOT, "configs/x-vlm-small-ft/VQA_480.yaml")
    config = tcfg.load_task_config(path, repo_root=ROOT)
    text = TDC.model_configs(config)[1]
    assert config["num_dec_layers"] == text["num_hidden_layers"] - text["fusion_layer"] == 3
    port = TVqa.build_l0(config)
    ref = JVqa.build_l0(jcfg.load_task_config(path, repo_root=ROOT))
    assert list(port.groups) == list(ref.groups)
    for name, g in ref.groups.items():
        assert port.groups[name]["shape"] == g["shape"], name
        assert port.groups[name]["params_per_dim"] == g["params_per_dim"], name


# ---------------------------------------------------------------------------
# --evaluate against JAX's evaluation
# ---------------------------------------------------------------------------


def _snapshot(task, out_dir):
    name = {"vqa": "model_state_step_0.ckpt", "captioning": "model_state_step_0.ckpt",
            "nlvr": "model_state_step_best.ckpt", "grounding": "training_state_latest.ckpt"}[task]
    return os.path.join(out_dir, name)


def _export(task, config, ckpt, path):
    """A params-only export of the snapshot's trained gates."""
    model, gates = TC.extract_model_and_gates(TC.load_pytree(ckpt))
    zs = PORT[task].build_l0(config).forward_deterministic({"loga": gates["loga"]})
    fusion = TDC.model_configs(config)[1]["fusion_layer"]
    TC.save_pytree(path, prune_xvlm_params(model, zs, fusion_layer=fusion, head_dim=8,
                                           nlvr=task == "nlvr"))
    return zs


def _jax_eval(task, corpus, params, zs, monkeypatch):
    """JAX's evaluation over the same files: VQA / captioning results, NLVR
    (logits, accuracy), grounding results."""
    jconfig = jcfg.load_task_config(corpus[task], repo_root=ROOT)
    jconfig["attn_impl"] = "xla"
    jmodel = JAX[task].build_models(jconfig)[0]
    res = jconfig["image_res"]
    tf = JTransform.test(res)
    if task == "vqa":
        ds = JDS.VQADataset(jconfig["test_file"], tf, jconfig["vqa_root"], "", split="test",
                            answer_list=jconfig["answer_list"])
    elif task == "captioning":
        ds = JDS.CaptioningEvalDataset(jconfig["val_file"], tf, jconfig["image_root"])
    elif task == "nlvr":
        ds = JDS.NLVRDataset(jconfig["test_file"], tf, jconfig["image_root"])
    else:
        ds = JDS.GroundingBboxDataset(jconfig["test_file"], tf, jconfig["image_root"],
                                      image_res=res, mode="test")
    loader = JDS.SimpleLoader(ds, batch_size=jconfig["batch_size_test"])
    zs = None if zs is None else {k: v.numpy() for k, v in zs.items()}
    fn = JAX[task].evaluation if task in ("vqa", "captioning") else JAX[task].evaluate
    seen = []
    if task == "nlvr":
        orig = JNl.nlvr_accuracy
        monkeypatch.setattr(JNl, "nlvr_accuracy", lambda p, t: seen.append(p) or orig(p, t))
    out = fn(jmodel, params, loader, j_tokenizer(""), jconfig, zs=zs)
    return (seen[-1], out) if task == "nlvr" else out


@pytest.mark.parametrize("source", ["snapshot", "export"])
@pytest.mark.parametrize("task", TASKS)
def test_evaluate_matches_jax(task, source, corpus, trained, tmp_path, monkeypatch):
    """main --evaluate from a native snapshot (its stored gates) and from a
    params-only export (no gates: the dense program of the pruned params)
    against JAX's evaluation on the same params and gates."""
    config = _config(corpus, task)
    ckpt = _snapshot(task, trained(task)[2])
    zs_trained = None
    if source == "export":
        zs_trained = _export(task, config, ckpt, str(tmp_path / "pruned.ckpt"))
        ckpt = str(tmp_path / "pruned.ckpt")
    mod, got = PORT[task], {}
    fn_name = "evaluation" if task in ("vqa", "captioning") else "evaluate"
    orig = getattr(mod, fn_name)

    def recording(model, params, *a, zs=None, **kw):
        got.update(params=params, zs=zs)
        return orig(model, params, *a, zs=zs, **kw)

    monkeypatch.setattr(mod, fn_name, recording)
    logits = []
    if task == "nlvr":
        orig_acc = TNl.nlvr_accuracy
        monkeypatch.setattr(TNl, "nlvr_accuracy", lambda p, t: logits.append(p) or orig_acc(p, t))
    result = mod.main(_args(tmp_path / "eval", evaluate=True, checkpoint=ckpt), config)
    if source == "export":
        assert got["zs"] is None
    else:
        loga = TC.extract_model_and_gates(TC.load_pytree(ckpt))[1]["loga"]
        want = mod.build_l0(config).forward_deterministic({"loga": loga})
        assert sorted(got["zs"]) == sorted(want)
        assert all(torch.equal(got["zs"][k], want[k]) for k in want)

    if task == "nlvr" and source == "export":
        # JAX's NLVR export is not its gated model (ROADMAP C): the pruned
        # student is held to JAX's gated forward of the snapshot
        dense = TC.extract_model_and_gates(TC.load_pytree(_snapshot(task, trained(task)[2])))[0]
        ref_logits, ref = _jax_eval(task, corpus, _numpy_tree(dense), zs_trained, monkeypatch)
    else:
        ref = _jax_eval(task, corpus, _numpy_tree(got["params"]), got["zs"], monkeypatch)
        if task == "nlvr":
            ref_logits, ref = ref
    if task == "vqa":
        assert result["results"] == ref and len(ref) == N_IMG // 2
        with open(tmp_path / "eval" / "vqa_result_rank0.json") as f:
            assert [json.loads(x) for x in f] == ref
    elif task == "captioning":
        assert result["results"] == ref and len(ref) == N_IMG // 2
        with open(config["val_gt_file"]) as f:
            gt = json.load(f)
        assert TCap.coco_caption_eval(gt, result["results"]) == JCM.coco_caption_eval(gt, ref)
    elif task == "nlvr":
        np.testing.assert_allclose(logits[-1], ref_logits, atol=1e-4, rtol=0)
        assert result["test_acc"] == ref
    else:
        assert [r["ref_id"] for r in result["results"]] == [r["ref_id"] for r in ref]
        for a, b in zip(result["results"], ref):
            assert (a["width"], a["height"]) == (b["width"], b["height"])
            np.testing.assert_allclose(a["pred"], b["pred"], atol=1e-4, rtol=0)
        with open(config["ref_boxes"]) as f:
            gt = json.load(f)
        want = JEG.grounding_eval_bbox(ref, {int(k): v["bbox"] for k, v in gt.items()},
                                       {int(k): v["split"] for k, v in gt.items()})
        assert {k: result[k] for k in want} == want


def test_captioning_epoch_metrics_match_jax(corpus, trained):
    """The epoch's coco_caption_eval (log.txt) is JAX's metric of the
    epoch's captions."""
    out, _, out_dir = trained("captioning")
    with open(_config(corpus, "captioning")["val_gt_file"]) as f:
        gt = json.load(f)
    ep = out["epochs"][0]
    assert ep["metrics"] == JCM.coco_caption_eval(gt, ep["results"])
    with open(os.path.join(out_dir, "log.txt")) as f:
        line = json.loads(f.readline())
    assert {k: line[k] for k in ep["metrics"]} == ep["metrics"]


# ---------------------------------------------------------------------------
# collect_result
# ---------------------------------------------------------------------------


def _fake_hdfs(tmp_path):
    """An hdfs CLI (a local script over tmp_path/hdfs_store) for hcopy's put
    and get."""
    backing = tmp_path / "hdfs_store"
    backing.mkdir(parents=True)
    fake = tmp_path / "hdfs"
    fake.write_text(f"""#!/usr/bin/env python3
import os, shutil, sys
root = {str(backing)!r}
def local(p):
    return os.path.join(root, p.replace("hdfs://", "").lstrip("/"))
cmd = sys.argv[2]
if cmd == "-put":
    dst = local(sys.argv[-1])
    os.makedirs(os.path.dirname(dst), exist_ok=True)
    shutil.copy(sys.argv[-2], dst)
elif cmd == "-get":
    shutil.copy(local(sys.argv[-2]), sys.argv[-1])
""")
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    return backing, str(fake)


@pytest.mark.parametrize("case", ["merged", "remove_duplicate", "save_result", "hdfs"])
def test_collect_result_matches_jax(case, tmp_path, monkeypatch):
    """The merged list, remove_duplicate, the file save_result writes and
    the hdfs:// copies, against JAX's collect_result on the same records."""
    records = [{"image_id": i % 3, "caption": f"a caption {i}"} for i in range(7)]
    kw = {"merged": {}, "remove_duplicate": {"remove_duplicate": "image_id"},
          "save_result": {"save_result": True, "remove_duplicate": "image_id"},
          "hdfs": {"save_result": True}}[case]
    outs = []
    for name, fn, io_mod in (("port", TU.collect_result, TIO), ("jax", JU.collect_result, JIO)):
        wdir = tmp_path / name
        if case == "hdfs":
            backing, fake = _fake_hdfs(tmp_path / name / "fs")
            monkeypatch.setattr(io_mod, "HDFS_BIN", fake)
            kw["hdfs_wdir"] = "hdfs://ns/results/"
        out = fn(records, "caption_result", str(wdir), rank=0, world_size=1, **kw)
        if kw.get("save_result"):
            assert out == str(wdir / "caption_result.json")
            with open(out) as f:
                out = f.read()
        if case == "hdfs":
            out = (out, sorted(os.listdir(backing / "ns/results")),
                   (backing / "ns/results/caption_result.json").read_text())
        with open(wdir / "caption_result_rank0.json") as f:
            outs.append((out, f.read()))
    assert outs[0] == outs[1]
    if case == "remove_duplicate":
        assert [r["image_id"] for r in outs[0][0]] == [0, 1, 2]


def test_collect_result_refuses_processes():
    """Above one process the merge needs the ranks' process group
    (tests/test_torch_ddp.py merges over two); without one it refuses."""
    with pytest.raises(RuntimeError, match="process group"):
        TU.collect_result([], "x", "/nonexistent", rank=0, world_size=2)


@pytest.mark.parametrize("task", TASKS)
def test_main_runs_on_the_card_by_default(task, corpus, tmp_path):
    """Given no device, main resolves cuda: without a GPU it raises."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    args = _args(tmp_path)
    del args["device"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PORT[task].main(args, _config(corpus, task))
