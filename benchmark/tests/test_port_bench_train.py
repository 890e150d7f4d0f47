"""The retrieval pruning fine-tune cell at a tiny size on the CPU: the
reference follows the port's steps to f32 rounding when the port computes
in f32 (the generator streams line up draw for draw), a whole run comes out
correct, and runs with the timed path broken underneath, and the control
in the program's place, come out not correct.

The whole runs compute in f32: at widths of 64 and 4 pairs a step bf16's
rounding reads larger than at the cell's size, against which the limits
are set, while the f32 program follows the reference to f32 rounding, so
that every fault stands out against the committed limits."""

import argparse

import pytest

from benchmark import run as H

ARGS = ["--workload", "itr-prune-b24", "--seed", "8589934597", "--seconds", "0.5"]


def driver():
    return H.load_file(H.os.path.join(H.HERE, "drivers", "retrieval_train.py"),
                       "benchmark_driver_retrieval_train")


def ctx(spec, seed=11):
    return H.Context(argparse.Namespace(seed=seed, seconds=0.0, trace=0,
                                        workload="itr-prune-b24"), spec, "cpu")


def test_reference_follows_the_port_in_f32(f32_spec):
    got = driver().readings(ctx(f32_spec))
    assert got["loss_gap_all_steps"] < 1e-5 and got["grad_gap_worst"] < 1e-4
    assert got["gate_grad_gap_worst"] < 1e-4 and got["gate_change_gap_worst"] < 1e-4
    assert got["first_update_flips"] == 0 and got["negatives_positive"] == 0


@pytest.fixture
def f32_spec(train_spec):
    train_spec["config"]["compute_dtype"] = "f32"
    return train_spec


def test_sound_run_is_correct(f32_spec):
    train_spec = f32_spec
    code, res = H.run(ARGS, device="cpu", spec=train_spec)
    assert code == 0 and res["correct"] is True and res["failed"] == 0
    assert set(res["metrics"]) == {"train_samples_per_s", "setup_s"}
    assert list(res)[-1] == "checks"


def test_traced_run_reports_its_per_layer_metrics(f32_spec):
    train_spec = f32_spec
    code, res = H.run(ARGS + ["--trace", "1"], device="cpu", spec=train_spec)
    assert code == 0 and res["correct"] is True and "mfu.train" in res["metrics"]
    assert "breakdown" in res


def _unchanged(monkeypatch):
    from efficientvlm_tpu_torch.train import steps

    monkeypatch.setattr(steps.RetrievalTrainStep, "apply", lambda self, state, grads: state)


def _half_batch(monkeypatch):
    from efficientvlm_tpu_torch.train import steps

    orig = steps.RetrievalTrainStep.__call__

    def half(self, state, batch, generator=None, **kw):
        return orig(self, state, {k: v[:v.shape[0] // 2] for k, v in batch.items()},
                    generator, **kw)

    monkeypatch.setattr(steps.RetrievalTrainStep, "__call__", half)


def _altered(monkeypatch):
    from efficientvlm_tpu_torch.models import xvlm

    from benchmark.tools import faults

    orig = xvlm.mlp_head_apply

    def head(params, x, **kw):
        out = orig(params, x, **kw)
        return faults.swap_positives(out) if out.shape[-1] == 2 else out

    monkeypatch.setattr(xvlm, "mlp_head_apply", head)


@pytest.mark.parametrize("plant", [_unchanged, _half_batch, _altered],
                         ids=["unchanged", "half_batch", "altered"])
def test_broken_timed_path_is_not_correct(f32_spec, monkeypatch, plant):
    plant(monkeypatch)
    code, res = H.run(ARGS, device="cpu", spec=f32_spec)
    assert code == 0 and res["correct"] is False


@pytest.mark.parametrize("seed", [3, 4, 5])
def test_control_fails_a_limit(train_spec, seed):
    numbers = driver().readings(ctx(train_spec, seed), "control")
    limits = train_spec["limits"]
    assert any(numbers[k] > lim["limit"] for k, lim in limits.items())
