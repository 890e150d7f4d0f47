"""The retrieval evaluation cell at a tiny size on the CPU: its reference
against the port (the only file that imports both), a whole run that
comes out correct, and runs with the timed path broken underneath, and
the control in the program's place, that come out not correct. A run
without a card fails and prints no result."""

import argparse
import json

import numpy as np
import pytest
import torch

from benchmark import run as H
from benchmark.reference import retrieval_eval as C
from benchmark.reference import xvlm as ref

ARGS = ["--workload", "itr-eval-k256", "--seed", "4294967311", "--seconds", "0.2"]


def driver():
    return H.load_file(H.os.path.join(H.HERE, "drivers", "retrieval_eval.py"),
                       "benchmark_driver_retrieval_eval")


def ctx(spec, seed=7):
    return H.Context(argparse.Namespace(seed=seed, seconds=0.0, trace=0,
                                        workload="itr-eval-k256"), spec, "cpu")


def test_reference_matches_the_port_in_f32(eval_spec):
    """The port's plain f32 path over its export against the reference's
    gated dense forward: the gates exactly, features and ITM scores to f32
    rounding."""
    from efficientvlm_tpu_torch.evaluation import retrieval as R

    cell = driver().EvalCell(ctx(eval_spec))
    got_gates = ref.gates({k: v.numpy() for k, v in cell.loga.items()}, cell.cfg)
    from efficientvlm_tpu_torch.drivers import retrieval as DR

    port_zs = DR.build_l0(driver().port_config(cell.cfg)).forward_deterministic(
        {"loga": cell.loga})
    assert np.array_equal(port_zs["vision_head_z"].numpy(), got_gates["vision_head"])
    assert np.array_equal(port_zs["cross_head_z"].numpy(), got_gates["cross_head"])
    assert np.array_equal(port_zs["text_intermediate_z"].numpy(), got_gates["text_ffn"])
    n = 6  # the first six images with their first six captions, pair by pair
    image = torch.as_tensor(cell.images[:n])
    ids, atts = torch.as_tensor(cell.ids[:n]), torch.as_tensor(cell.atts[:n])
    with torch.no_grad():
        img_f, txt_f, itm = R.retrieval_forward(cell.student, cell.pruned, image, ids, atts,
                                                dtype=None, impl="plain")
    ev = ref.Evaluation(ref.F32(), cell.dense, cell.cfg, cell.loga, cell.images[:n],
                        cell.ids[:n], cell.atts[:n], device="cpu")
    assert torch.allclose(img_f, ev.image_feat, atol=2e-5)
    assert torch.allclose(txt_f, ev.text_feat, atol=2e-5)
    scores = ev.scores(np.arange(n), np.arange(n))
    assert np.allclose(itm[:, 1].numpy(), scores, atol=1e-4 * max(1.0, np.abs(scores).max()))


def test_sound_run_is_correct(eval_spec):
    code, res = H.run(ARGS, device="cpu", spec=eval_spec)
    assert code == 0 and res["correct"] is True and res["failed"] == 0
    assert set(res["metrics"]) == {"eval_pairs_per_s", "setup_s"}
    assert list(res)[-1] == "checks"
    for c in res["checks"].values():
        assert c["value"] <= c["limit"]


def test_traced_run_reports_its_per_layer_metrics(eval_spec):
    code, res = H.run(ARGS[:-1] + ["0.2", "--trace", "1"], device="cpu", spec=eval_spec)
    assert code == 0 and res["correct"] is True
    assert {"eval_stage_s.encode", "eval_stage_s.rerank", "mfu.eval"} <= set(res["metrics"])
    assert "breakdown" in res and res["device"]["window_s"] > 0


def _half_left_out(out):
    r = out.shape[0]
    out[r // 2:] = out[:r // 2].mean()
    return out


def _altered(out):
    out[:, 0] += 0.5
    return out


@pytest.mark.parametrize("fault", [_half_left_out, _altered], ids=["half_batch", "altered"])
def test_broken_timed_path_is_not_correct(eval_spec, monkeypatch, fault):
    from efficientvlm_tpu_torch.evaluation import retrieval as R

    orig = R.itm_rerank_scores
    monkeypatch.setattr(R, "itm_rerank_scores", lambda *a, **k: fault(orig(*a, **k)))
    code, res = H.run(ARGS, device="cpu", spec=eval_spec)
    assert code == 0 and res["correct"] is False


def test_altered_features_are_not_correct(eval_spec, monkeypatch):
    from efficientvlm_tpu_torch.evaluation import retrieval as R

    orig = R.encode_images

    def shifted(*a, **k):
        feats, embeds = orig(*a, **k)
        embeds = embeds.copy()
        embeds[-1] = embeds[0]
        return feats, embeds

    monkeypatch.setattr(R, "encode_images", shifted)
    code, res = H.run(ARGS, device="cpu", spec=eval_spec)
    assert code == 0 and res["correct"] is False


@pytest.mark.parametrize("seed", [3, 4, 5])
def test_control_fails_a_limit(eval_spec, seed):
    """The fp8 reference in the program's place fails one of the numbers
    whose limits are committed."""
    numbers = driver().readings(ctx(eval_spec, seed), "control")
    limits = eval_spec["limits"]
    assert any(numbers[k] > lim["limit"] for k, lim in limits.items())


def test_sampled_rows_cover_both_directions_and_passes():
    rows = C.sample_rows(1, 3, 10, 50, 8, 20)
    assert {d for _, d, _ in rows} == {"i2t", "t2i"} and len(rows) == 28
    assert {p for p, _, _ in rows} == {0, 1, 2}
    assert len(set(rows)) == len(rows)


def test_no_card_no_result(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert H.main(ARGS) != 0
    assert capsys.readouterr().out == ""


def test_on_the_card(cuda, tmp_path):
    """One short run of the cell at its size on the card: a result line,
    correct, on the GPU it names."""
    import subprocess
    import sys

    out = subprocess.run([sys.executable, "-m", "benchmark.run", *ARGS[:-1], "5"],
                         cwd=H.ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True and res["device"]["platform"] == "gpu"


def test_no_result_beside_the_benchmark_alone(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    files (no program beside them), a run exits non-zero with no result."""
    import shutil
    import subprocess
    import sys

    shutil.copy(H.os.path.join(H.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(H.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "-m", "benchmark.run", *ARGS], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_the_window_runs_evaluate_itself(eval_spec, monkeypatch):
    """Each pass of the window is a call of drivers/retrieval.evaluate, and
    what the check compares is what that call's retrieval_scores returned."""
    from efficientvlm_tpu_torch.drivers import retrieval as DR
    from efficientvlm_tpu_torch.evaluation import retrieval as R

    import functools

    def counted(f, log):
        return functools.wraps(f)(lambda *a, **k: log.append(1) or f(*a, **k))

    calls, scored = [], []
    monkeypatch.setattr(DR, "evaluate", counted(DR.evaluate, calls))
    monkeypatch.setattr(R, "retrieval_scores", counted(R.retrieval_scores, scored))
    code, res = H.run(ARGS, device="cpu", spec=eval_spec)
    assert code == 0 and res["correct"] is True
    assert len(calls) >= 1 and len(scored) == len(calls)
    assert res["attempted"] == len(calls) * (8 * 8 + 16 * 8)
