"""The sharded full-state backend of the port (train/sharded_io.py,
`checkpoint_backend: orbax`), held to what tests/test_orbax_ckpt.py holds
of JAX's orbax backend: a round trip through drivers/common's
save_full_state / restore_full_state, a background save joined by
wait_for_saves, ZeRO-1 moments written by each rank as its own slices and
restored as slices, and the default single-file backend unchanged.

The one-process cases run here on the tiny retrieval state; the ZeRO-1
case runs on two gloo ranks (tests/torch_ranks.py: parallel_check --parts
zero1,sharded), whose directory is read back here. The retrieval driver's
loop runs with `zero1: true` and `checkpoint_backend: orbax` on two gloo
ranks (this file as their worker, `python tests/test_torch_sharded_ckpt.py
<dir>`): two epochs uninterrupted, then preempted at the end of the first
and resumed, bit-equal.
"""

import json
import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_ranks import ROOT, free_port, load, spawn_check  # noqa: E402

from efficientvlm_tpu_torch.drivers import common  # noqa: E402

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# the driver's ranks (run as subprocesses of this file)


def _driver_worker(out: str) -> None:
    """Two epochs of the retrieval loop with ZeRO-1 and the sharded backend,
    then the same preempted at the end of the first epoch and resumed; each
    run's final state dumped."""
    from efficientvlm_tpu_torch import config as tcfg
    from efficientvlm_tpu_torch.drivers import retrieval
    from efficientvlm_tpu_torch.parallel import zero
    from efficientvlm_tpu_torch.parallel.multihost_check import _flat
    from efficientvlm_tpu_torch.train import steps
    from efficientvlm_tpu_torch.utils import dist

    torch.set_num_threads(1)
    config = tcfg.load_task_config(os.path.join(out, "itr.yaml"), repo_root=ROOT)

    def args(name, **kw):
        return tcfg.Config({"seed": 42, "output_dir": os.path.join(out, name), "device": "cpu",
                            "epoch": 2, **kw})

    def dump(name, state):
        state = zero.gather_moments(state)
        np.savez(os.path.join(out, f"{name}.rank{dist.get_rank()}.npz"),
                 **_flat(state.params, "params/"), **_flat(state.loga, "loga/"),
                 **_flat(state.opt_state["mu"], "mu/"))

    whole = retrieval.main(args("whole"), config)
    dump("whole", whole["state"])
    common.install_preemption_handler()
    orig = steps.RetrievalTrainStep.__call__
    calls = []

    def flagging(self, *a, **kw):
        calls.append(1)
        if len(calls) == 2:  # this rank's last batch of the first epoch
            common._PREEMPT.set()
        return orig(self, *a, **kw)

    steps.RetrievalTrainStep.__call__ = flagging
    try:
        retrieval.main(args("cut"), config)
    except SystemExit as e:
        assert e.code == 0
    steps.RetrievalTrainStep.__call__ = orig
    common.install_preemption_handler()  # a new process starts unflagged
    resumed = retrieval.main(args("cut", resume=True), config)
    assert [e["steps"] for e in resumed["epochs"]] == [0, 2], resumed["epochs"]
    dump("resumed", resumed["state"])


if __name__ == "__main__":
    _driver_worker(sys.argv[1])
    sys.exit(0)


# ---------------------------------------------------------------------------
# the test's side


def _state():
    from efficientvlm_tpu_torch.drivers.retrieval import build_l0, build_models
    from efficientvlm_tpu_torch.parallel import multihost_check as M
    from efficientvlm_tpu_torch.train.steps import init_train_state

    config = M.tiny_config()
    student, _ = build_models(config)
    params = student.init(0, device="cpu")
    state = init_train_state(params, build_l0(config).init(2, device="cpu"),
                             common.build_optimizers(params, config, 10))
    g = torch.Generator().manual_seed(1)
    for t in state.opt_state["mu"] + state.opt_state["nu"]:  # moments that are not zeros
        t.copy_(torch.rand(t.shape, generator=g))
    state.opt_state["count"] = 4
    return state


def _equal(a, b) -> bool:
    from efficientvlm_tpu_torch.parallel.parallel_check import _state_exact

    return _state_exact(a, b)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("sharded"))
    spawn_check(2, out, ["zero1", "sharded"])
    return out, [load(out, "zero1", r) for r in range(2)]


def test_sharded_roundtrip_through_common(tmp_path):
    state = _state()
    extra = {"epoch": np.int64(3), "batches_done": 7, "note": "mid-run"}
    common.save_full_state(str(tmp_path), state, extra, backend="orbax")
    assert os.path.isdir(tmp_path / common.SHARDED_DIR)
    assert not os.path.exists(tmp_path / "training_state_latest.ckpt")
    new_state, new_extra = common.restore_full_state(str(tmp_path), _state())
    assert _equal(state, new_state)
    # the JSON round trip: numpy ints come back as plain ints
    assert new_extra["epoch"] == 3 and isinstance(new_extra["epoch"], int)
    assert new_extra["batches_done"] == 7 and new_extra["note"] == "mid-run"


def test_sharded_background_save(tmp_path):
    """The state is copied before save_full_state returns: updating it in
    place afterwards (as AdamW does) does not reach the file; the write
    runs on the default backend's one background thread."""
    state = _state()
    common.save_full_state(str(tmp_path), state, {"step": 5}, backend="orbax", background=True)
    assert common._PENDING_SAVE is not None and common._PENDING_COMMIT is not None
    saved = _state()
    for t in state.opt_state["mu"]:
        t.add_(1.0)
    common.wait_for_saves()
    new_state, extra = common.restore_full_state(str(tmp_path), _state())
    assert _equal(saved, new_state) and not _equal(state, new_state)
    assert extra["step"] == 5
    assert not os.path.exists(str(tmp_path / common.SHARDED_DIR) + ".tmp")


def test_sharded_zero1_moments_on_disk(ranks):
    """Two ranks with ZeRO-1: each rank's file holds its own slices only
    (half of each sharded leaf), rank 0's replicated file holds the rest
    with the slices left out; the state restores bit-exact into a fresh
    whole template (cut to slices), after a background save too, and the
    next step from the restored state equals the uninterrupted one."""
    out, dumps = ranks
    for d in dumps:
        rep = d["report"]
        assert rep["sharded_exact"] and rep["background_exact"] and rep["next_step_exact"]
        assert rep["sharded_extra"] == {"epoch": 3, "note": "sync"}
        assert rep["sharded_bytes"] > 0
    path = os.path.join(out, "ckpt", common.SHARDED_DIR)
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["world"] == 2 and manifest["sharded"]
    rep_tree = torch.load(os.path.join(path, "replicated.pt"), weights_only=True)
    shards = [torch.load(os.path.join(path, f"shards.rank{r}.pt"), weights_only=True)
              for r in range(2)]
    assert sorted(shards[0]) == sorted(shards[1]) == sorted(manifest["sharded"])
    dims = rep_tree["opt_state"]["zero1_dims"]
    for key in manifest["sharded"]:
        field, *inner, i = key.split("/")
        node = rep_tree[field]
        for k in inner:
            node = node[k]
        assert node[int(i)] is None  # not in rank 0's replicated file
        d = dims[int(i)] if field == "opt_state" else None
        a, b = shards[0][key], shards[1][key]
        assert a.shape == b.shape
        if d is not None:
            full = torch.cat([a, b], d)
            assert full.shape[d] == 2 * a.shape[d]
    assert dumps[0]["report"]["sharded_exact"] == dumps[1]["report"]["sharded_exact"]


def test_msgpack_backend_still_default(tmp_path):
    from efficientvlm_tpu_torch.config import Config

    assert common.checkpoint_backend(Config({})) == "msgpack"
    state = _state()
    common.save_full_state(str(tmp_path), state, {"epoch": 1})
    assert os.path.exists(tmp_path / "training_state_latest.ckpt")
    assert not os.path.exists(tmp_path / common.SHARDED_DIR)
    new_state, extra = common.restore_full_state(str(tmp_path), _state())
    assert _equal(state, new_state) and int(extra["epoch"]) == 1


def test_the_newer_state_wins(tmp_path):
    """Both backends left a state: restore_full_state takes the newer (a run
    that switched backends must not resume a stale one), as JAX's does."""
    state = _state()
    common.save_full_state(str(tmp_path), state, {"epoch": 1}, backend="orbax")
    common.save_full_state(str(tmp_path), state, {"epoch": 2}, backend="msgpack")
    os.utime(tmp_path / "training_state_latest.ckpt", (1e9, 1e9))
    assert common.restore_full_state(str(tmp_path), _state())[1]["epoch"] == 1
    os.utime(tmp_path / common.SHARDED_DIR, (1e9 - 10, 1e9 - 10))
    assert int(common.restore_full_state(str(tmp_path), _state())[1]["epoch"]) == 2


def _write_corpus(root: str) -> None:
    """tests/test_torch_driver.py's tiny retrieval corpus (16 JPEGs of 40 x
    40, one caption each; 4 validation images x 2 captions) and its YAML,
    with zero1, the sharded backend, no loader workers and f32."""
    from PIL import Image

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
    with open(os.path.join(root, "itr.yaml"), "w") as f:
        f.write(text + "num_workers: 0\ncompute_dtype: f32\nzero1: true\n"
                "checkpoint_backend: orbax\n")


def test_driver_resumes_zero1_from_the_sharded_backend(tmp_path):
    """`zero1: true` and `checkpoint_backend: orbax` through the retrieval
    driver on two gloo ranks: each epoch's full state goes to
    training_state_latest.shards/ (a file of slices a rank), a run preempted
    at the end of its first epoch and resumed ends bit-equal to the
    uninterrupted run (params, log-alphas, the main AdamW's first moments),
    and the two ranks agree."""
    out = str(tmp_path)
    _write_corpus(out)
    env = {k: v for k, v in os.environ.items() if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK")}
    env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()), WORLD_SIZE="2",
               OMP_NUM_THREADS="1", PYTHONPATH=ROOT + os.pathsep + env.get("PYTHONPATH", ""))
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), out],
                              env=dict(env, RANK=str(r), LOCAL_RANK=str(r)), cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              preexec_fn=lambda: signal.signal(signal.SIGTERM, signal.SIG_DFL))
             for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)[-4000:]
    shards = os.path.join(out, "cut", common.SHARDED_DIR)
    assert sorted(os.listdir(shards)) == ["manifest.json", "replicated.pt", "shards.rank0.pt",
                                          "shards.rank1.pt"]
    assert not os.path.exists(os.path.join(out, "cut", "training_state_latest.ckpt"))
    runs = {(name, r): dict(np.load(os.path.join(out, f"{name}.rank{r}.npz")))
            for name in ("whole", "resumed") for r in range(2)}
    a = runs[("whole", 0)]
    assert any(k.startswith("mu/") for k in a)
    for other in (runs[("whole", 1)], runs[("resumed", 0)], runs[("resumed", 1)]):
        assert sorted(other) == sorted(a)
        for k in a:
            assert np.array_equal(other[k], a[k]), k
