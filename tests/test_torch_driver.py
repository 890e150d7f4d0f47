"""The retrieval fine-tune's driver loop on the CPU (efficientvlm_tpu_torch
drivers/common.py, drivers/retrieval.py, run.py, the optimizer wrappers of
train/optim.py), against the JAX package where JAX has the function:

- MultiSteps / ApplyIfFinite against optax.MultiSteps / apply_if_finite
  step by step (f32, rtol 1e-6), and resolve_warmup;
- the loop's batches against JAX's SimpleLoader + tokenizer on the same
  files and seed (ids exact, images within 1e-6);
- main against the held retrieval step applied by hand (exactly, loss by
  loss), preemption and --resume (bit-equal), gradient accumulation and
  the skip of non-finite updates in the loop;
- evaluate from an imported .th, the best snapshot and a params-only
  export against JAX's evaluate on the same params and gates (recalls
  equal, score matrices within 1e-4);
- the CLI: itr_coco on the CPU, every other task name routed to its
  driver's main, --scst reaching captioning's main.

The corpus (16 JPEGs of 40 x 40, one caption each; 4 validation images x 2
captions) and the YAML (configs/tests/Retrieval_synth.yaml with its paths,
num_workers 0, f32 compute) are written into a temporary directory."""

import json
import multiprocessing as mp
import os
import re
import signal
import time

import numpy as np
import optax
import pytest
import torch
from PIL import Image

import efficientvlm_tpu.evaluation.retrieval as JR
from efficientvlm_tpu import config as jcfg
from efficientvlm_tpu.data.datasets import RetrievalEvalDataset as JEvalDS
from efficientvlm_tpu.data.datasets import RetrievalTrainDataset as JTrainDS
from efficientvlm_tpu.data.datasets import SimpleLoader as JLoader
from efficientvlm_tpu.data.tokenizer import build_tokenizer as j_tokenizer
from efficientvlm_tpu.data.transforms import ImageTransform as JTransform
from efficientvlm_tpu.drivers import common as JDC
from efficientvlm_tpu.drivers import retrieval as JDR
from efficientvlm_tpu.train import optim as JO
from efficientvlm_tpu.utils import logger as JL
from efficientvlm_tpu.utils import params as JP
from efficientvlm_tpu_torch import config as tcfg
from efficientvlm_tpu_torch import run as TRUN
from efficientvlm_tpu_torch.data.datasets import SimpleLoader
from efficientvlm_tpu_torch.data.tokenizer import build_tokenizer
from efficientvlm_tpu_torch.drivers import common as TDC
from efficientvlm_tpu_torch.drivers import retrieval as TDR
from efficientvlm_tpu_torch.evaluation import retrieval as TR
from efficientvlm_tpu_torch.pruning.export import prune_xvlm_params
from efficientvlm_tpu_torch.train import checkpoint as TC
from efficientvlm_tpu_torch.train import optim as TO
from efficientvlm_tpu_torch.train import profiler as TPROF
from efficientvlm_tpu_torch.train import steps as TS
from efficientvlm_tpu_torch.train.steps import init_train_state, make_retrieval_train_step
from efficientvlm_tpu_torch.utils import dist as TD
from efficientvlm_tpu_torch.utils import logger as TL
from efficientvlm_tpu_torch.utils import params as TP

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 42


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """{"yaml": path, "root": dir} of the tiny retrieval corpus."""
    root = str(tmp_path_factory.mktemp("itr"))
    os.makedirs(os.path.join(root, "imgs"))
    rng = np.random.RandomState(0)
    for i in range(16):
        Image.fromarray(np.uint8(rng.rand(40, 40, 3) * 255)).save(
            os.path.join(root, "imgs", f"{i}.jpg"))
    words = ["dog", "cat", "photo", "red", "a", "two", "in", "the"]
    with open(os.path.join(root, "train.json"), "w") as f:
        json.dump([{"image": f"{i}.jpg", "image_id": f"im{i // 2}",
                    "caption": " ".join(words[(i + j) % 8] for j in range(2 + i % 5))}
                   for i in range(16)], f)
    with open(os.path.join(root, "val.json"), "w") as f:
        json.dump([{"image": f"{i}.jpg", "caption": [f"a dog {i}", f"photo {i} cat"]}
                   for i in range(4)], f)
    with open(os.path.join(ROOT, "configs/tests/Retrieval_synth.yaml")) as f:
        text = f.read().replace("/tmp/synth_itr", root)
    path = os.path.join(root, "itr.yaml")
    with open(path, "w") as f:
        f.write(text + "num_workers: 0\ncompute_dtype: f32\n")
    return {"yaml": path, "root": root}


def _config(corpus, **extra):
    config = tcfg.load_task_config(corpus["yaml"], repo_root=ROOT)
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


@pytest.fixture(autouse=True)
def _restore_sigterm():
    """main installs the preemption handler in this process: put SIGTERM's
    handler back and clear the flag after each test."""
    before = signal.getsignal(signal.SIGTERM)
    yield
    signal.signal(signal.SIGTERM, before)
    TDC._PREEMPT.clear()


@pytest.fixture()
def logged(monkeypatch):
    """Every MetricLogger.update call's values, in order."""
    calls = []
    orig = TL.MetricLogger.update

    def update(self, **kw):
        calls.append(dict(kw))
        return orig(self, **kw)

    monkeypatch.setattr(TL.MetricLogger, "update", update)
    return calls


# ---------------------------------------------------------------------------
# the optimizer wrappers (C2)
# ---------------------------------------------------------------------------

N_STEPS, NAN_AT = 7, 1  # the second gradient set holds a NaN


def _grad_sets(leaves):
    rng = np.random.default_rng(3)
    sets = [[rng.standard_normal(x.shape).astype(np.float32) for x in leaves]
            for _ in range(N_STEPS)]
    sets[NAN_AT][1][0] = np.nan
    return sets


def _pair(kind):
    """(port optimizer, optax optimizer, params) of one wrapper case, both
    over AdamW with a schedule, weight decay and clipping."""
    rng = np.random.default_rng(4)
    params = {"w": rng.standard_normal((3, 4)).astype(np.float32),
              "b": rng.standard_normal(4).astype(np.float32)}
    sched = lambda t: 1e-2 * (1.0 - 0.05 * t)  # noqa: E731
    kw = dict(lr=sched, weight_decay=0.1, grad_clip=1.0)
    port_p = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    port, ref = TO.create_optimizer(port_p, **kw), JO.create_optimizer(params, **kw)
    if kind in ("apply_if_finite", "both"):
        port, ref = TO.ApplyIfFinite(port, 2), optax.apply_if_finite(ref, max_consecutive_errors=2)
    if kind in ("multisteps", "both"):
        port, ref = TO.MultiSteps(port, 3), optax.MultiSteps(ref, every_k_schedule=3)
    return port, ref, port_p, params


def _optax_step(ref, params, grads, state):
    g = dict(zip(("w", "b"), grads))  # the port's leaf order
    upd, state = ref.update(g, state, params)
    return optax.apply_updates(params, upd), state


@pytest.mark.parametrize("kind", ["multisteps", "apply_if_finite", "both"])
def test_wrappers_match_optax(kind):
    """7 gradient sets, the second holding a NaN, through MultiSteps (k 3),
    ApplyIfFinite (n 2) and the two as build_optimizers wires them
    (MultiSteps outermost), against optax step by step. Where they part,
    optax multiplies a NaN by 0: MultiSteps alone, optax's second
    micro-step returns 0 x the inner update of a NaN mean, which puts NaN in
    the params a step before the window's update does (the port leaves them
    as they are until then); in the composition optax restarts its
    accumulator as 0 x the NaN mean, so the NaN stays and the second window
    is rejected too, where the port zeroes it and the update goes through
    (step 6)."""
    port, ref, port_p, params = _pair(kind)
    leaves = TO.tree_leaves(port_p)
    state, ref_state = port.init(leaves), ref.init(params)
    for i, grads in enumerate(_grad_sets(leaves)):
        before = [x.clone() for x in leaves]
        port.step(leaves, [torch.from_numpy(g) for g in grads], state)
        params, ref_state = _optax_step(ref, params, grads, ref_state)
        if kind == "multisteps" and i == NAN_AT:
            assert all(torch.equal(a, b) for a, b in zip(before, leaves))
            assert all(np.isnan(np.asarray(v)).all() for v in params.values())
            continue
        if kind == "both" and i == 5:
            assert all(np.array_equal(a.numpy(), np.asarray(params[k]))
                       for a, k in zip(before, ("w", "b")))  # optax: rejected again
            assert all(torch.isfinite(x).all() and not torch.equal(a, x)
                       for a, x in zip(before, leaves))
            return
        for k in params:
            np.testing.assert_allclose(port_p[k].numpy(), np.asarray(params[k]), rtol=1e-6,
                                       atol=1e-7, equal_nan=True,
                                       err_msg=f"{kind} step {i + 1} {k}")
    if kind == "apply_if_finite":
        assert state["total_notfinite"] == int(ref_state.total_notfinite) == 1
        assert state["inner"]["count"] == 6
    if kind == "multisteps":
        assert state["gradient_step"] == int(ref_state.gradient_step) == 2
        assert state["mini_step"] == int(ref_state.mini_step) == 1
        assert state["inner"]["count"] == 2


def test_accumulation_survives_a_save_in_the_middle(tmp_path):
    """A save after 4 micro-steps (one into the second window) and a restore
    into a fresh state: the next 3 steps as the uninterrupted run's,
    bit-equal."""
    runs = []
    for restart in (False, True):
        port, _, port_p, _ = _pair("both")
        leaves = TO.tree_leaves(port_p)
        state = port.init(leaves)
        sets = _grad_sets(leaves)
        sets[NAN_AT][1][0] = 0.5
        for i, grads in enumerate(sets):
            if restart and i == 4:
                TC.save_pytree(str(tmp_path / "opt.ckpt"), {"p": port_p, "s": state})
                port2, _, fresh_p, _ = _pair("both")
                saved = TC.load_pytree(str(tmp_path / "opt.ckpt"))
                port_p = TC.restore_pytree_like(fresh_p, saved["p"])
                state = TC.restore_pytree_like(port2.init(TO.tree_leaves(fresh_p)), saved["s"])
                leaves, port = TO.tree_leaves(port_p), port2
                assert state["mini_step"] == 1
            port.step(leaves, [torch.from_numpy(g) for g in grads], state)
        runs.append((port_p, state))
    _assert_bit_equal(*runs)


@pytest.mark.parametrize("warmup", [0, 0.1, 0.5, 100, 7])
@pytest.mark.parametrize("accum", [1, 2, 4])
def test_resolve_warmup_matches_jax(warmup, accum):
    assert TDC.resolve_warmup(warmup, accum) == JDC.resolve_warmup(warmup, accum)


# ---------------------------------------------------------------------------
# the utilities: one process, parameter counts, the metric logger
# ---------------------------------------------------------------------------


def test_dist_is_one_process(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert TD.init_distributed_mode() == {"rank": 0, "world_size": 1, "num_devices": 1,
                                          "local_devices": 1}
    assert TD.get_rank() == 0 and TD.get_world_size() == 1 and TD.is_main_process()
    # a launch of two processes without torchrun's other variables refuses
    # to wait for peers that were never started
    monkeypatch.setenv("WORLD_SIZE", "2")
    for k in ("RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(ValueError, match="RANK, MASTER_ADDR, MASTER_PORT"):
        TD.init_distributed_mode()


def test_parameter_counts_match_jax(corpus):
    params = TDR.build_models(_config(corpus))[0].init(0, device="cpu", with_bbox_head=True)
    ref = _numpy_tree(params)
    assert TP.calculate_parameters(params) == JP.calculate_parameters(ref)
    assert TP.count_all_parameters(params) == JP.count_all_parameters(ref)
    lines = []
    TP.log_all_parameters(params, print_fn=lines.append)
    assert lines[-1].startswith("total: ") and len(lines) == len(TO.tree_leaves(params)) + 1


def test_metric_logger_prints_jax_lines(capsys):
    """log_every over the same items and values prints JAX's lines (times
    aside)."""
    out = []
    for module in (TL, JL):
        logger = module.MetricLogger()
        for i in logger.log_every(range(5), 2, header="Train Epoch: [0]"):
            logger.update(loss=1.0 / (i + 1), loss_itc=0.5 * i)
        out.append(re.sub(r"(eta|time|data|Total time): \S+", r"\1: T", capsys.readouterr().out))
    assert out[0] == out[1] and out[0].count("Train Epoch: [0] [") == 3


# ---------------------------------------------------------------------------
# the loop
# ---------------------------------------------------------------------------


def test_batches_match_jax(corpus):
    """The loop's batches (build_datasets + SimpleLoader + make_batch)
    against JAX's SimpleLoader + tokenizer on the same files and seed."""
    config = _config(corpus)
    train_ds, _, _ = TDR.build_datasets(config, SEED)
    tok = build_tokenizer(config.get("text_encoder", ""))
    loader = SimpleLoader(train_ds, batch_size=4, shuffle=True, drop_last=True)
    jconfig = jcfg.load_task_config(corpus["yaml"], repo_root=ROOT)
    jds = JTrainDS(jconfig["train_file"], JTransform.train(32, seed=SEED), jconfig["image_root"],
                   max_words=jconfig["max_tokens"])
    jtok = j_tokenizer(jconfig.get("text_encoder", ""))
    jloader = JLoader(jds, batch_size=4, shuffle=True, drop_last=True)
    n = 0
    for items, (images, captions, idx) in zip(loader, jloader):
        batch = TDR.make_batch(items, tok, config, "cpu")
        want = jtok(list(captions), padding="longest", truncation=True, max_length=12)
        assert batch["text_ids"].dtype == torch.int64
        assert np.array_equal(batch["text_ids"].numpy(), np.asarray(want["input_ids"]))
        assert np.array_equal(batch["text_atts"].numpy(), np.asarray(want["attention_mask"]))
        assert np.array_equal(batch["idx"].numpy(), np.asarray(idx))
        np.testing.assert_allclose(batch["image"].numpy(), images, atol=1e-6, rtol=0)
        n += 1
    assert n == len(loader) == 4


def _by_hand(corpus, config):
    """The held retrieval step applied by hand over main's batches, with
    main's inits and per-step generators: (metrics per step, state)."""
    student, teacher = TDR.build_models(config)
    l0 = TDR.build_l0(config)
    train_ds, _, _ = TDR.build_datasets(config, SEED)
    loader = SimpleLoader(train_ds, batch_size=4, shuffle=True, drop_last=True)
    l0.lagrangian_warmup = len(loader)
    params = student.init(0, device="cpu")
    opts = TDC.build_optimizers(params, config, len(loader))
    state = init_train_state(params, l0.init(2, device="cpu"), opts)
    step = make_retrieval_train_step(student, teacher, l0, opts,
                                     teacher_params=teacher.init(1, device="cpu"))
    tok = build_tokenizer("")
    loader.set_epoch(0)
    metrics = []
    for i, items in enumerate(loader):
        m = step(state, TDR.make_batch(items, tok, config, "cpu"),
                 TDC.step_generator(SEED, 0, i, "cpu"))
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, state


def test_the_step_draws_every_negative_from_its_generator(corpus):
    """The retrieval step's teacher draws its hard negatives from the step's
    generator too (it drew them from torch's global generator, so neither a
    seeded run nor a resumed one could repeat them): the same generator seed
    gives the same losses whatever the global generator's state."""
    config = _config(corpus)
    student, teacher = TDR.build_models(config)
    l0 = TDR.build_l0(config)
    train_ds, _, _ = TDR.build_datasets(config, SEED)
    items = next(iter(SimpleLoader(train_ds, batch_size=4)))
    batch = TDR.make_batch(items, build_tokenizer(""), config, "cpu")
    tparams = teacher.init(1, device="cpu")
    seen = []
    for global_seed in (0, 1):
        params = student.init(0, device="cpu")
        opts = TDC.build_optimizers(params, config, 4)
        step = make_retrieval_train_step(student, teacher, l0, opts, teacher_params=tparams)
        torch.manual_seed(global_seed)
        seen.append({k: float(v) for k, v in step(
            init_train_state(params, l0.init(2, device="cpu"), opts), batch,
            torch.Generator().manual_seed(5)).items()})
    assert seen[0] == seen[1]


def test_main_adds_nothing_to_the_step(corpus, tmp_path, logged):
    """main on the CPU (16 images, 4 steps) logs, loss by loss and exactly,
    what the held step gives applied by hand to the same batches with the
    same per-step generators, and ends in the same state; log.txt carries
    JAX's keys; the full state and the best snapshot are written."""
    out = TDR.main(_args(tmp_path / "out"), _config(corpus))
    want, state = _by_hand(corpus, _config(corpus))
    assert logged == want
    _assert_bit_equal(out["state"], state)
    assert out["state"].step == 4 and out["epochs"][0]["steps"] == 4
    with open(tmp_path / "out" / "log.txt") as f:
        lines = [json.loads(x) for x in f]
    keys = set(lines[0])
    assert {"epoch", "train_loss", "train_loss_itc", "train_loss_kd", "val_r_mean",
            "val_txt_r1", "val_img_r10", "sparsity"} <= keys
    assert all(k in ("epoch", "sparsity") or k.startswith(("train_", "val_")) for k in keys)
    assert lines[-1] == {"best_epoch": 0, "best_r_mean": out["best_r_mean"]}
    assert 0.0 <= lines[0]["val_r_mean"] <= 100.0
    for name in ("training_state_latest.ckpt", "model_state_step_best.ckpt", "config.json"):
        assert os.path.exists(tmp_path / "out" / name), name


def test_preempt_and_resume_is_bit_exact(corpus, tmp_path, monkeypatch):
    """SIGTERM after batch 2 of 4: the full state is saved with the batch
    cursor and main exits 0; --resume finishes the epoch in a state
    bit-equal to an uninterrupted run's."""
    whole = TDR.main(_args(tmp_path / "whole"), _config(corpus))["state"]
    TDC.install_preemption_handler()
    calls = []
    orig = TS.RetrievalTrainStep.__call__

    def flagging(self, *a, **kw):
        out = orig(self, *a, **kw)
        calls.append(1)
        if len(calls) == 2:
            os.kill(os.getpid(), signal.SIGTERM)
        return out

    monkeypatch.setattr(TS.RetrievalTrainStep, "__call__", flagging)
    with pytest.raises(SystemExit) as exc:
        TDR.main(_args(tmp_path / "cut"), _config(corpus))
    assert exc.value.code == 0 and len(calls) == 2
    saved = TC.load_pytree(str(tmp_path / "cut" / "training_state_latest.ckpt"))
    assert saved["extra"] == {"epoch": -1, "batches_done": 2, "preempted": True}
    assert saved["state"]["step"] == 2
    TDC.install_preemption_handler()  # a new process starts unflagged
    resumed = TDR.main(_args(tmp_path / "cut", resume=True), _config(corpus))
    assert len(calls) == 4 and resumed["epochs"][0]["steps"] == 2
    _assert_bit_equal(resumed["state"], whole)


def test_step_profiler_writes_a_trace(corpus, tmp_path):
    """profile_dir in the config: StepProfiler traces steps 2-3 of the loop
    with torch.profiler and writes a Chrome trace with the step's ops."""
    trace = tmp_path / "trace"
    TDR.main(_args(tmp_path / "out"), _config(corpus, profile_dir=str(trace),
                                                profile_start_step=1, profile_num_steps=2))
    with open(trace / "trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "aten::mm" in names or "aten::addmm" in names
    assert {"evlm.loop.step", "evlm.step.student", "evlm.step.backward"} <= names


def test_main_records_the_loop_and_step_spans(corpus, tmp_path):
    """main under profiler.recording (16 images, 4 steps): each of
    evlm.loop.batch, .step and .after once a step, evlm.loop.wait once a
    step and once more for the loader's end; inside each evlm.loop.step the
    teacher, the student and the apply in turn, and inside the student the
    gates' two ranges and the backward."""
    with TPROF.recording() as log:
        out = TDR.main(_args(tmp_path / "out"), _config(corpus))
    steps = out["epochs"][0]["steps"]
    assert steps == 4
    loop = [(i, n) for i, (n, _, _, _) in enumerate(log) if n.startswith("evlm.loop.")]
    assert [n for _, n in loop] == (["evlm.loop.wait", "evlm.loop.batch", "evlm.loop.step",
                                     "evlm.loop.after"] * steps + ["evlm.loop.wait"])
    assert len({log[i][1] for i, _ in loop}) == 1  # all under one parent

    def children(i):
        return [(j, log[j][0]) for j in range(len(log)) if log[j][1] == i]

    for i, name in loop:
        if name != "evlm.loop.step":
            continue
        parts = children(i)
        assert [n for _, n in parts] == ["evlm.step.teacher", "evlm.step.student",
                                         "evlm.step.apply"]
        student = parts[1][0]
        assert [n for _, n in children(student)] == ["evlm.step.gates", "evlm.step.gates",
                                                     "evlm.step.backward"]
    assert "evlm.eval.rerank" in {n for n, _, _, _ in log}  # the epoch's validation


def test_a_forked_child_still_dies_of_sigterm():
    """A process forked after the handler is installed (as a fork-based
    worker pool forks) inherits it; SIGTERM must still end it, or the
    pool's terminate() waits forever. The launcher's own process only
    flags."""
    flag = TDC.install_preemption_handler()
    child = mp.get_context("fork").Process(target=time.sleep, args=(60,))
    child.start()
    time.sleep(0.5)
    child.terminate()
    child.join(timeout=20)
    assert child.exitcode == -signal.SIGTERM
    os.kill(os.getpid(), signal.SIGTERM)
    assert flag.wait(timeout=5)


def test_gradient_accumulation_in_the_loop(corpus, tmp_path):
    """GRAD_ACCUMULATE_STEPS 2 over 4 batches: TrainState.step counts the
    calls (4, as JAX's state.step + 1), the optimizers' inner counts the
    updates (2)."""
    config = _config(corpus, accelerator={"GRAD_ACCUMULATE_STEPS": 2})
    state = TDR.main(_args(tmp_path), config)["state"]
    assert state.step == 4
    for opt_state in (state.opt_state, state.l0_state, state.lam_state):
        assert opt_state["inner"]["count"] == 2 and opt_state["mini_step"] == 0
        assert opt_state["gradient_step"] == 2


def test_skip_nonfinite_in_the_loop(corpus, tmp_path, monkeypatch):
    """skip_nonfinite_updates 2, the third batch's KD loss made NaN: the
    step's loss is NaN and its update leaves the params, the log-alphas and
    their optimizer states as they were (λ's gradient, (s - t) and (s -
    t)², stays finite and λ steps, as in JAX); the error counted."""
    config = _config(corpus, skip_nonfinite_updates=2)
    orig_kd, orig_call = TS.retrieval_kd_losses, TS.RetrievalTrainStep.__call__
    calls, seen = [], {}
    parts = ("params", "loga", "opt_state", "l0_state")

    def poisoned(*a, **kw):
        out = orig_kd(*a, **kw)
        if len(calls) == 3:
            out["loss_kd"] = out["loss_kd"] * float("nan")
        return out

    def recording(self, state, batch, generator=None, **kw):
        calls.append(1)
        if len(calls) == 3:
            seen["before"] = {k: _flat(getattr(state, k)) for k in parts}
            seen["lam_count"] = state.lam_state["inner"]["count"]
        out = orig_call(self, state, batch, generator, **kw)
        if len(calls) == 3:
            seen["after"] = {k: _flat(getattr(state, k)) for k in parts}
            seen["loss"] = float(out["loss"])
            seen["lam_count_after"] = state.lam_state["inner"]["count"]
        return out

    monkeypatch.setattr(TS, "retrieval_kd_losses", poisoned)
    monkeypatch.setattr(TS.RetrievalTrainStep, "__call__", recording)
    state = TDR.main(_args(tmp_path), config)["state"]
    assert np.isnan(seen["loss"])
    counters = ("/notfinite_count", "/last_finite", "/total_notfinite")
    for part, leaves in seen["before"].items():
        changed = [k for k in leaves if k not in counters
                   and not np.array_equal(leaves[k], seen["after"][part][k], equal_nan=True)]
        assert not changed, (part, changed)
    assert seen["lam_count_after"] == seen["lam_count"] + 1
    assert state.opt_state["total_notfinite"] == state.l0_state["total_notfinite"] == 1
    assert state.opt_state["notfinite_count"] == 0 and state.lam_state["total_notfinite"] == 0
    assert state.opt_state["inner"]["count"] == 3 and state.step == 4
    assert all(np.isfinite(v).all() for v in _flat(state.params).values())


# ---------------------------------------------------------------------------
# evaluate against JAX's
# ---------------------------------------------------------------------------


def _student_th(corpus, tmp_path):
    config = _config(corpus)
    student, _ = TDR.build_models(config)
    params = student.init(5, device="cpu")
    sd = TC.xvlm_state_dict_from_params(params, fusion_layer=2)
    path = str(tmp_path / "student.th")
    torch.save({"model": sd}, path)
    return path


def _capture(monkeypatch, module):
    """The (score_i2t, score_t2i) of each itm_eval call of `module`."""
    seen = []
    orig = module.itm_eval

    def itm_eval(s_i2t, s_t2i, *rest):
        seen.append((np.asarray(s_i2t), np.asarray(s_t2i)))
        return orig(s_i2t, s_t2i, *rest)

    monkeypatch.setattr(module, "itm_eval", itm_eval)
    return seen


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_numpy_tree(v) for v in tree]
    return tree.numpy() if isinstance(tree, torch.Tensor) else tree


@pytest.mark.parametrize("source", ["th", "best-snapshot", "export"])
def test_evaluate_matches_jax(corpus, tmp_path, monkeypatch, source):
    """main --evaluate from an imported .th (the seeded gates'
    forward_deterministic), from the best snapshot (its stored gates) and
    from a params-only export (no gates: the dense program) against JAX's
    evaluate on the same params and gates: recalls equal, score matrices
    within 1e-4."""
    config = _config(corpus)
    if source == "th":
        ckpt = _student_th(corpus, tmp_path)
    else:
        TDR.main(_args(tmp_path / "train"), config)
        ckpt = str(tmp_path / "train" / "model_state_step_best.ckpt")
        if source == "export":
            model, gates = TC.extract_model_and_gates(TC.load_pytree(ckpt))
            zs = TDR.build_l0(config).forward_deterministic({"loga": gates["loga"]})
            TC.save_pytree(str(tmp_path / "pruned.ckpt"),
                           prune_xvlm_params(model, zs, fusion_layer=2, head_dim=8))
            ckpt = str(tmp_path / "pruned.ckpt")
    got = {}
    orig = TDR.evaluate

    def recording(model, params, loader, ds, tok, cfg, *, zs=None, dtype=None):
        got.update(params=params, zs=zs)
        return orig(model, params, loader, ds, tok, cfg, zs=zs, dtype=dtype)

    monkeypatch.setattr(TDR, "evaluate", recording)
    port_scores = _capture(monkeypatch, TR)
    results = TDR.main(_args(tmp_path / "eval", evaluate=True, checkpoint=ckpt), config)
    if source == "export":
        assert got["zs"] is None
    elif source == "best-snapshot":
        loga = TC.load_pytree(ckpt)["l0"]["loga"]
        want = TDR.build_l0(config).forward_deterministic({"loga": loga})
        assert sorted(got["zs"]) == sorted(want)
        assert all(torch.equal(got["zs"][k], want[k]) for k in want)

    jconfig = jcfg.load_task_config(corpus["yaml"], repo_root=ROOT)
    jconfig["attn_impl"] = "xla"
    jstudent, _ = JDR.build_models(jconfig)
    jds = JEvalDS(jconfig["test_file"], JTransform.test(32), jconfig["image_root"])
    jax_scores = _capture(monkeypatch, JR)
    zs = None if got["zs"] is None else {k: v.numpy() for k, v in got["zs"].items()}
    ref = JDR.evaluate(jstudent, _numpy_tree(got["params"]), JLoader(jds, batch_size=4), jds,
                       j_tokenizer(""), jconfig, zs=zs)
    assert {k: float(v) for k, v in results.items()} == {k: float(v) for k, v in ref.items()}
    for a, b in zip(port_scores[-1], jax_scores[-1]):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=0)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def test_cli_runs_itr_coco_on_the_cpu(corpus, tmp_path):
    out = TRUN.main(["--task", "itr_coco", "--config", corpus["yaml"], "--device", "cpu",
                     "--output_dir", str(tmp_path / "cli"), "--seed", "0", "--lr", "2e-3"])
    assert out["state"].step == 4 and 0.0 <= out["best_r_mean"] <= 100.0
    with open(tmp_path / "cli" / "config.json") as f:
        dumped = json.load(f)
    assert dumped["args"]["seed"] == 0 and dumped["args"]["device"] == "cpu"
    assert dumped["config"]["optimizer"]["lr"] == 2e-3


ROUTES = {"gd_4m_small": "gd", "pretrain_4m_base": "gd", "pretrain_4m_small": "gd",
          "vqa_480": "vqa", "nlvr": "nlvr", "nlvr_domain": "nlvr",
          "coco_captioning": "captioning", "coco_capt_domain": "captioning",
          "grounding": "grounding"}


@pytest.mark.parametrize("task", sorted(ROUTES))
def test_cli_names_the_roadmap_item_of_a_task_not_ported(task, tmp_path, monkeypatch):
    """Every task name but itr_coco reaches its driver's main, as run.py
    routes it (ROADMAP A3 is done: no task names a loop still to port), with
    its shipped YAML and the CLI's flags; main is replaced by a recorder."""
    import importlib

    module = importlib.import_module(f"efficientvlm_tpu_torch.drivers.{ROUTES[task]}")
    calls = []
    monkeypatch.setattr(module, "main", lambda args, config: calls.append((args, config)) or "ran")
    assert TRUN.main(["--task", task, "--device", "cpu", "--output_dir", str(tmp_path),
                      "--seed", "0"]) == "ran"
    (args, config), = calls
    assert args["task"] == task and args["seed"] == 0 and args["device"] == "cpu"
    assert config["text_encoder"] == "data/bert-base-uncased"
    assert TRUN.TASK_DRIVERS[task] == ROUTES[task]


def test_cli_scst_names_roadmap_a4(tmp_path, monkeypatch):
    """--scst (captioning's self-critical sequence training, ROADMAP A4,
    ported since) reaches the captioning driver's main with the flag set;
    its loop, scst_train, is held in tests/test_torch_scst.py."""
    from efficientvlm_tpu_torch.drivers import captioning as TCap

    calls = []
    monkeypatch.setattr(TCap, "main", lambda args, config: calls.append(args) or "ran")
    assert TRUN.main(["--task", "coco_captioning", "--scst", "--device", "cpu",
                      "--output_dir", str(tmp_path)]) == "ran"
    assert calls[0]["scst"] is True and calls[0]["task"] == "coco_captioning"


def test_main_runs_on_the_card_by_default(corpus, tmp_path):
    """Given no device, main resolves cuda: without a GPU it raises."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    args = _args(tmp_path)
    del args["device"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TDR.main(args, _config(corpus))
