"""ZeRO-1 of the port (parallel/zero.py, `zero1: true` through
drivers/common.build_train_step), held to what tests/test_zero.py holds of
JAX's: the moments sharded and the params replicated, the step equal to the
replicated data-parallel step of the same step function, and a save /
restore round trip.

Two gloo ranks (tests/torch_ranks.py: parallel_check --parts zero1) run the
retrieval pruning step (multihost_check's tiny towers, pinned noise and
negatives, dropout 0) for three steps over world batches of 4, data
parallel and with ZeRO-1 from one init, twice: from the port's seeded
init (the checks against the port's own data-parallel step) and from JAX's
(--init), where ZeRO-1 is held to JAX's replicated step on the same init
and batches (JAX's step under shard_map over two devices,
tests/jax_pruning_ref.py), as test_zero.py holds JAX's ZeRO-1 to its
replicated step. The rules of the shard dims are held to JAX's
_moment_spec in this process.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import jax_pruning_ref as J  # noqa: E402
from torch_ranks import load, spawn_check  # noqa: E402

torch.set_num_threads(1)
STEPS, WORLD_BATCH = 3, 4  # parallel_check.TINY's


@pytest.fixture(scope="module")
def jax_init():
    return J.jax_init()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("zero1"))
    spawn_check(2, out, ["zero1"])
    return [load(out, "zero1", r) for r in range(2)]


@pytest.fixture(scope="module")
def jax_ranks(tmp_path_factory, jax_init):
    out = str(tmp_path_factory.mktemp("zero1_jax"))
    spawn_check(2, out, ["zero1"], init=J.write_port_init(os.path.join(out, "init.ckpt"),
                                                          jax_init))
    return [load(out, "zero1", r) for r in range(2)]


@pytest.mark.parametrize("shape", [(64, 96), (96, 64), (3, 8), (7, 5), (8,), (), (4, 4, 2),
                                   (1, 16), (6, 6)])
@pytest.mark.parametrize("n", [2, 8])
def test_shard_dim_is_jaxs_moment_spec(shape, n):
    """The largest dim that divides by n, ties to the first, 1-D and scalar
    leaves replicated: JAX's _moment_spec."""
    from efficientvlm_tpu.parallel.zero import _moment_spec
    from efficientvlm_tpu_torch.parallel.zero import moment_shard_dim

    spec = tuple(_moment_spec(np.zeros(shape), n))
    want = next((i for i, a in enumerate(spec) if a is not None), None)
    assert moment_shard_dim(shape, n) == want


def test_zero1_specs_shard_moments_only():
    """Params, log-alphas and λs replicated; more than 10 of the main
    AdamW's moment leaves sharded (JAX's test, on its 8 devices)."""
    from efficientvlm_tpu_torch.drivers import common
    from efficientvlm_tpu_torch.drivers.retrieval import build_l0, build_models
    from efficientvlm_tpu_torch.parallel import multihost_check as M
    from efficientvlm_tpu_torch.parallel.zero import zero1_state_specs
    from efficientvlm_tpu_torch.train.steps import init_train_state

    config = M.tiny_config()
    student, _ = build_models(config)
    l0 = build_l0(config)
    params = student.init(0, device="cpu")
    state = init_train_state(params, l0.init(2, device="cpu"),
                             common.build_optimizers(params, config, 10))
    specs = zero1_state_specs(state, 8)
    assert specs["params"] is None and specs["loga"] is None and specs["lam"] is None
    assert sum(d is not None for d in specs["opt_state"]) > 10
    assert all(d is None for d in specs["lam_state"])  # λ1, λ2 are scalars


def test_zero1_matches_replicated_step(ranks):
    """Three ZeRO-1 steps end where the replicated data-parallel steps end:
    params and log-alphas within test_zero.py's atol 2e-5 / rtol 2e-4,
    every metric of every step within atol 1e-4 / rtol 1e-3."""
    a = ranks[0]
    for k in (k for k in a if k.startswith("zero1/")):
        want = a[k.replace("zero1/", "dp/", 1)]
        if "/metric/" in k:
            np.testing.assert_allclose(a[k], want, atol=1e-4, rtol=1e-3, err_msg=k)
        elif k.split("/")[1] in ("params", "loga", "lam"):
            np.testing.assert_allclose(a[k], want, atol=2e-5, rtol=2e-4, err_msg=k)


def test_zero1_matches_jax_replicated_step(jax_ranks, jax_init):
    """Three ZeRO-1 steps against JAX's replicated data-parallel step from
    the same init over the same world batches: every metric of every step
    within 1e-4 relative, the final params, log-alphas and λs within 1e-4
    plus the disagreement the gradient tolerance lets through Adam
    (test_torch_ddp's rule for the replicated port step); the ranks end
    bit-equal."""
    metrics, states, moments = J.run_steps(jax_init, STEPS, WORLD_BATCH, devices=2)
    a, b = jax_ranks
    assert all(np.array_equal(a[k], b[k]) for k in a if k.startswith("zero1/"))
    assert len(a["zero1/metric/loss"]) == STEPS
    for k in metrics[0]:
        want = np.asarray([m[k] for m in metrics])
        np.testing.assert_allclose(a[f"zero1/metric/{k}"], want, rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    J.assert_leaves_match(a, "zero1/", states[-1], moments)


def test_zero1_ranks_end_bit_equal(ranks):
    a, b = ranks
    assert sorted(a) == sorted(b)
    for k in a:
        if k != "report":
            assert np.array_equal(a[k], b[k]), k


def test_zero1_moments_are_sharded(ranks):
    """Each rank holds its slices only: per-rank moment bytes well under the
    replicated ones (test_zero.py's 0.6), the data-parallel state's equal;
    the driver's sync records nothing (C1)."""
    rep = ranks[0]["report"]
    z, d = rep["zero1_moment_bytes"], rep["dp_moment_bytes"]
    assert rep["zero1_sharded"]
    assert z["per_device_bytes"] < 0.6 * z["replicated_bytes"], z
    assert z["replicated_bytes"] == d["replicated_bytes"] == d["per_device_bytes"]
    assert rep["zero1_calls_recorded"] == rep["dp_calls_recorded"] == 0


def test_zero1_wrappers_agree_across_ranks(ranks):
    """ApplyIfFinite inside ZeRO-1: a NaN in one rank's slice skips the
    update on both ranks (the leaf stays all ones), the next finite step
    goes through; MultiSteps(2) applies once in two steps, the same on
    both ranks."""
    w0, w1 = ranks[0]["report"]["wrappers"], ranks[1]["report"]["wrappers"]
    assert w0 == w1
    assert w0["skip/0"] == [1.0] * 24
    assert all(x < 1.0 for x in w0["skip/1"])
    assert w0["accumulate/0"] == [1.0] * 24
    assert all(x < 1.0 for x in w0["accumulate/1"])


def test_zero1_save_restore_roundtrip(ranks):
    """The default backend gathers the sharded moments into one file from
    rank 0; it restores bit-exact into a sharded template (each rank its
    slices) and into a whole one (the gathered moments)."""
    for r in ranks:
        assert r["report"]["msgpack_exact"] and r["report"]["msgpack_whole_exact"]
