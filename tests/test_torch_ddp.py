"""Data parallelism of the port (utils/dist.py, drivers/common.build_train_step,
parallel/multihost_check.py, the cross-rank collect_result, meters,
preemption flag and retrieval scores) on the CPU over two gloo processes.

The two ranks are subprocesses of this file (`python tests/test_torch_ddp.py
<dir>` under torchrun's environment variables), each with SIGTERM's default
action, one torch thread and a timeout of 90 s. Each rank first runs the
collectives' cases, then multihost_check's retrieval pruning step (tiny
towers, 3 steps over a world batch of 4, 2 rows a rank) from JAX's init.

Held:
- the ranks' final params, log-alphas and λs bit-equal;
- the ranks against one process over the same world batches: every metric
  of every step and the step-1 gradients within 1e-5 (relative to each
  group's largest gradient), the final leaves within 1e-4 (Adam's
  normalised first steps at lr 1e-3 turn 1e-7 gradient differences into
  parameter differences of up to about 2e-5);
- the ranks against JAX's raw make_retrieval_train_step(axis_name="data")
  under shard_map over two devices, as data_parallel_step wraps it, with the
  same noise and the same pinned negatives: metrics within 1e-4 relative,
  the final leaves within 1e-4;
- all_gather_with_grad's forward and gradient against jax.lax.all_gather's
  (tiled) under shard_map; collect_result across ranks against JAX's
  single-process merge of the same records; the meters' global averages;
  preempted_sync when one rank alone is flagged; sum_over_ranks of the
  rank-sharded retrieval scores against one process's scores;
- a driver-built GradientSync records no call (C1), a recording one its
  last RECORD_WINDOW.
"""

import json
import os
import signal
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import jax_pruning_ref as J  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS, WORLD_BATCH = 3, 4


# ---------------------------------------------------------------------------
# the rank's side (run as a subprocess)
# ---------------------------------------------------------------------------


def _gather_inputs():
    rs = np.random.RandomState(3)
    return rs.standard_normal((4, 5)).astype(np.float32), \
        rs.standard_normal((4, 5)).astype(np.float32)


def _collectives(out: str) -> dict:
    """The collectives' cases of this rank."""
    from efficientvlm_tpu_torch.config import Config
    from efficientvlm_tpu_torch.data.utils import collect_result
    from efficientvlm_tpu_torch.drivers import common
    from efficientvlm_tpu_torch.drivers.retrieval import sum_over_ranks
    from efficientvlm_tpu_torch.utils import dist as D
    from efficientvlm_tpu_torch.utils.logger import MetricLogger

    rank, world = D.get_rank(), D.get_world_size()
    res = {}
    x, w = _gather_inputs()
    local = torch.from_numpy(x[rank * 2:(rank + 1) * 2]).requires_grad_(True)
    full = D.all_gather_with_grad(local, D.dist.group.WORLD)
    # a loss that reads every gathered row, weighted differently on each rank
    loss = ((full * torch.from_numpy(w)) ** 2).sum() * (rank + 1)
    loss.backward()
    res["gathered"] = full.detach().numpy().tolist()
    res["grad"] = local.grad.numpy().tolist()

    records = [{"image_id": (3 * rank + i) % 4, "caption": f"r{rank} c{i}"} for i in range(3)]
    res["collect"] = collect_result(records, "caption_result", out, remove_duplicate="image_id")
    res["collect_file"] = collect_result(records, "caption_file", out, save_result=True)

    logger = MetricLogger()
    for v in range(rank + 2):
        logger.update(loss=float(v + 10 * rank))
    logger.synchronize_between_processes()
    res["meter"] = [logger.meters["loss"].count, logger.meters["loss"].total,
                    logger.meters["loss"].global_avg]

    common._PREEMPT.clear()
    res["preempt_none"] = common.preempted_sync()
    if rank == 1:
        common._PREEMPT.set()
    res["preempt_one"] = common.preempted_sync()
    common._PREEMPT.clear()

    # C1: a driver's sync (build_train_step's) records nothing however many
    # steps it averages; a recording one keeps its last RECORD_WINDOW calls
    class _Stub:
        data_parallel = None

    sync = common.build_train_step(_Stub(), Config()).data_parallel
    recording = D.GradientSync(record=True)
    for i in range(3 * D.RECORD_WINDOW):
        for s_ in (sync, recording):
            s_({"loss": torch.tensor(float(i))}, [torch.ones(3)])
    res["c1"] = [type(sync).__name__, len(sync.calls), len(recording.calls), D.RECORD_WINDOW]

    rs = np.random.RandomState(5)
    scores = np.full((7, 9), -100.0, np.float32)
    step = 7 // world + 1
    rows = np.arange(rank * step, min(7, (rank + 1) * step))
    scores[rows] = rs.standard_normal((7, 9)).astype(np.float32)[rows]
    res["summed"] = sum_over_ranks(scores).tolist()
    return res


def _scst(out: str, rank: int) -> None:
    """--scst through the CLI on this rank's shard; the final params and the
    epoch's record dumped."""
    from efficientvlm_tpu_torch import run as RUN
    from efficientvlm_tpu_torch.parallel.multihost_check import _flat

    res = RUN.main(["--task", "coco_captioning", "--scst", "--config",
                    os.path.join(out, "scst.yaml"), "--output_dir", os.path.join(out, "scst"),
                    "--device", "cpu", "--seed", "3"])
    np.savez(os.path.join(out, f"scst.rank{rank}.npz"), **_flat(res["state"].params, ""),
             rewards=np.asarray(res["reward_history"], np.float64),
             steps=np.asarray([e["steps"] for e in res["epochs"]]))


def _worker(out: str) -> None:
    torch.set_num_threads(1)
    from efficientvlm_tpu_torch.parallel import multihost_check as M
    from efficientvlm_tpu_torch.utils import dist as D

    D.init_distributed_mode(device="cpu")
    res = _collectives(out)
    with open(os.path.join(out, f"collectives.rank{D.get_rank()}.json"), "w") as f:
        json.dump(res, f)
    _scst(out, D.get_rank())
    M.run(width="tiny", steps=STEPS, world_batch_size=WORLD_BATCH, device="cpu",
          init=os.path.join(out, "init.ckpt"), out=os.path.join(out, "dp.npz"))


if __name__ == "__main__":
    _worker(sys.argv[1])
    sys.exit(0)


# ---------------------------------------------------------------------------
# the test's side
# ---------------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _scst_yaml(out: str) -> None:
    """<out>/scst.yaml: configs/tests/Captioning_synth.yaml over 4 images
    and 12 captions, f32, K = 2, 3 images a rank's step: two steps an epoch
    on each of two ranks."""
    import yaml
    from PIL import Image

    imgs = os.path.join(out, "imgs")
    os.makedirs(imgs)
    rng = np.random.RandomState(0)
    for i in range(4):
        Image.fromarray(np.uint8(rng.rand(40, 40, 3) * 255)).save(os.path.join(imgs, f"{i}.jpg"))
    words = "dog cat tree car house bird".split()
    # "picture of" in two images' captions only: the prompt's n-grams earn a
    # reward there, so the advantages are not all zero
    train = [{"image": f"{i}.jpg", "image_id": f"im{i}",
              "caption": (f"a picture of the {words[(i + j) % 6]}" if i < 2
                          else f"a {words[(i + j) % 6]} near the {words[i]}")}
             for i in range(4) for j in range(3)]
    with open(os.path.join(out, "scst_train.json"), "w") as f:
        json.dump(train, f)
    with open(os.path.join(out, "scst_val.json"), "w") as f:
        json.dump([{"image": "0.jpg"}], f)
    with open(os.path.join(ROOT, "configs/tests/Captioning_synth.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg.update(train_file=[os.path.join(out, "scst_train.json")],
               val_file=os.path.join(out, "scst_val.json"), image_root=imgs, num_workers=0,
               compute_dtype="f32", scst_sample_n=2, batch_size_train_scst=3, max_length=8,
               min_length=2)
    with open(os.path.join(out, "scst.yaml"), "w") as f:
        yaml.safe_dump(cfg, f)


@pytest.fixture(scope="module")
def jax_init():
    """JAX's models, gates and optimizers for the tiny towers, and their
    seeded init as numpy trees."""
    return J.jax_init()


@pytest.fixture(scope="module")
def runs(tmp_path_factory, jax_init):
    """The two gloo ranks and one process, from JAX's init."""
    from efficientvlm_tpu_torch.parallel import multihost_check as M

    out = str(tmp_path_factory.mktemp("ddp"))
    _scst_yaml(out)
    J.write_port_init(os.path.join(out, "init.ckpt"), jax_init)
    env = {k: v for k, v in os.environ.items() if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK")}
    env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()), WORLD_SIZE="2",
               OMP_NUM_THREADS="1", PYTHONPATH=ROOT + os.pathsep + env.get("PYTHONPATH", ""))
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), out],
                              env=dict(env, RANK=str(r), LOCAL_RANK=str(r)), cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              preexec_fn=lambda: signal.signal(signal.SIGTERM, signal.SIG_DFL))
             for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=90)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)[-4000:]
    one = M.run(width="tiny", steps=STEPS, world_batch_size=WORLD_BATCH, device="cpu",
                init=os.path.join(out, "init.ckpt"))
    ranks = [dict(np.load(os.path.join(out, f"dp.rank{r}.npz"))) for r in range(2)]
    coll = []
    for r in range(2):
        with open(os.path.join(out, f"collectives.rank{r}.json")) as f:
            coll.append(json.load(f))
    return dict(out=out, one=one, ranks=ranks, coll=coll, logs=logs)


def _leaves(dump):
    return {k: v for k, v in dump.items() if k.split("/")[0] in ("params", "loga", "lam")}


def test_ranks_end_bit_equal(runs):
    a, b = runs["ranks"]
    assert sorted(a) == sorted(b)
    for k in a:
        if k != "report":
            assert np.array_equal(a[k], b[k]), k
    report = json.loads(str(a["report"]))
    assert report["world"] == 2 and report["backend"] == "gloo" and report["local_batch"] == 2
    assert len(report["allreduce_bytes"]) == STEPS and report["allreduce_bytes"][0] > 0


def test_ranks_agree_with_one_process(runs):
    a, one = runs["ranks"][0], runs["one"]
    for k in (k for k in one if k.startswith("metric/")):
        np.testing.assert_allclose(a[k], one[k], rtol=1e-5, atol=1e-7, err_msg=k)
    np.testing.assert_allclose(a["metric/loss_itc"][0], np.log(WORLD_BATCH), rtol=1e-2)
    for group in ("params", "loga", "lam"):
        keys = [k for k in one if k.startswith(f"grad1/{group}/")]
        scale = max(np.abs(one[k]).max() for k in keys)
        for k in keys:
            np.testing.assert_allclose(a[k], one[k], rtol=0, atol=1e-5 * scale, err_msg=k)
    for k, v in _leaves(one).items():
        np.testing.assert_allclose(a[k], v, rtol=0, atol=1e-4, err_msg=k)


def test_ranks_match_jax_shard_map(runs, jax_init):
    """Every metric of every step within 1e-4 relative; the final leaves
    within 1e-4 plus the update disagreement the gradients' tolerance lets
    through Adam (jax_pruning_ref.update_allowance: with lr 1e-3, an entry
    whose step-1 gradient is 2e-8 against its leaf's 4e-5 moves by 8e-4
    when its sign turns)."""
    metrics, states, moments = J.run_steps(jax_init, STEPS, WORLD_BATCH, devices=2)
    a = runs["ranks"][0]
    for k in metrics[0]:
        want = np.asarray([m[k] for m in metrics])
        np.testing.assert_allclose(a[f"metric/{k}"], want, rtol=1e-4, atol=1e-6, err_msg=k)
    J.assert_leaves_match(a, "", states[-1], moments)


def test_all_gather_gradient_matches_jax(runs):
    """The gathered rows and each rank's gradient against jax.lax.all_gather
    (tiled) under shard_map over two devices, with the same rank-weighted
    loss."""
    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import Mesh, PartitionSpec as P

    x, w = _gather_inputs()
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("data",))

    def per_rank(xs):
        def loss(v):
            full = jax.lax.all_gather(v, "data", tiled=True)
            return ((full * w) ** 2).sum() * (jax.lax.axis_index("data") + 1)

        return jax.grad(loss)(xs)

    grads = jax.jit(shard_map(per_rank, mesh=mesh, in_specs=P("data"), out_specs=P("data"),
                              check_vma=False))(jnp.asarray(x))
    for r, res in enumerate(runs["coll"]):
        np.testing.assert_array_equal(np.asarray(res["gathered"], np.float32), x)
        np.testing.assert_allclose(np.asarray(res["grad"]), np.asarray(grads)[2 * r:2 * r + 2],
                                   rtol=1e-6, atol=1e-6)


def test_collect_result_across_ranks_matches_jax(runs, tmp_path):
    from efficientvlm_tpu.data import utils as JU

    r0, r1 = runs["coll"]
    assert r1["collect"] is None and r1["collect_file"] is None
    records = [{"image_id": (3 * r + i) % 4, "caption": f"r{r} c{i}"}
               for r in range(2) for i in range(3)]
    want = JU.collect_result(records, "caption_result", str(tmp_path), rank=0, world_size=1,
                             remove_duplicate="image_id")
    assert r0["collect"] == want and [x["image_id"] for x in want] == [0, 1, 2, 3]
    with open(r0["collect_file"]) as f:
        assert json.load(f) == records
    for r in range(2):
        with open(os.path.join(runs["out"], f"caption_result_rank{r}.json")) as f:
            assert [json.loads(line)["caption"] for line in f] == [f"r{r} c{i}" for i in range(3)]


def test_meters_and_preemption_agree_across_ranks(runs):
    """Rank 0 logged 0, 1 and rank 1 logged 10, 11, 12: both hold the
    world's count 5, total 34; one rank's flag is every rank's."""
    for res in runs["coll"]:
        assert res["meter"] == [5, 34.0, 34.0 / 5]
        assert res["preempt_none"] is False and res["preempt_one"] is True


def test_rank_sharded_scores_sum_to_one_process(runs):
    """Each rank's rows of a score matrix summed over the ranks: every row
    is the filling rank's scores shifted by (world - 1) x -100, so the
    recalls are one process's."""
    from efficientvlm_tpu_torch.evaluation import retrieval as R

    full = np.random.RandomState(5).standard_normal((7, 9)).astype(np.float32)
    txt2img = [j % 7 for j in range(9)]
    img2txt = [[j for j in range(9) if j % 7 == i] for i in range(7)]
    for res in runs["coll"]:
        summed = np.asarray(res["summed"], np.float32)
        np.testing.assert_array_equal(summed, full - 100.0)
        assert R.itm_eval(summed, summed.T.copy(), txt2img, img2txt) == \
            R.itm_eval(full, full.T.copy(), txt2img, img2txt)


def test_scst_across_ranks(runs):
    """--scst on two ranks (each its half of the records, two grad steps):
    the grad step averages over the ranks, so the final params are
    bit-equal though the ranks sampled different images."""
    a, b = (dict(np.load(os.path.join(runs["out"], f"scst.rank{r}.npz"))) for r in range(2))
    assert list(a["steps"]) == list(b["steps"]) == [2]
    assert np.isfinite(a["rewards"]).all() and np.isfinite(b["rewards"]).all()
    # each rank's logged rewards are its own samples'; some are not zero
    assert not np.array_equal(a["rewards"], b["rewards"])
    assert np.abs(np.concatenate([a["rewards"], b["rewards"]])).max() > 0
    params = [k for k in a if k not in ("rewards", "steps")]
    assert params and all(np.array_equal(a[k], b[k]) for k in params)


def test_a_driver_sync_keeps_a_bounded_record(runs):
    """C1: the GradientSync a driver's step gets records no call, however
    many steps it averages (it used to keep every step's entry and CUDA
    events); a recording sync (multihost_check's) keeps the last
    RECORD_WINDOW."""
    for coll in runs["coll"]:
        name, driver_calls, recording_calls, window = coll["c1"]
        assert name == "GradientSync" and driver_calls == 0
        assert recording_calls == window


@pytest.mark.parametrize("case", ["zero1", "orbax", "vision_seq_axis", "text_seq_axis"])
def test_the_second_part_of_distribution_still_raises(case):
    """ZeRO-1, the sharded checkpoint backend and the sequence axis (a tower
    config's act_partition) no longer raise: in one process each reaches its
    implementation, which is then the plain program, as in JAX (ZeRO-1 a
    no-op, a sequence axis of size 1); the backend is selected."""
    from efficientvlm_tpu_torch.config import Config, TextConfig, VisionConfig
    from efficientvlm_tpu_torch.drivers import common
    from efficientvlm_tpu_torch.models import bert, vit

    g = torch.Generator().manual_seed(0)
    if case == "zero1":
        step = type("Step", (), {"data_parallel": None})()
        assert common.build_train_step(step, Config({"zero1": True})) is step
        assert step.data_parallel is None
    elif case == "orbax":
        config = Config({"checkpoint_backend": "orbax"})
        common.setup(Config({}), config)
        assert common.checkpoint_backend(config) == "orbax"
        with pytest.raises(ValueError, match="checkpoint_backend"):
            common.setup(Config({}), Config({"checkpoint_backend": "zarr"}))
    elif case == "vision_seq_axis":
        kw = dict(vision_width=32, num_hidden_layers=1, num_attention_heads=4, image_res=16,
                  patch_size=8)
        plain = VisionConfig.create(**kw)
        cfg = VisionConfig({**plain, "act_partition": ["data", "seq"]})
        params = vit.init_vit(g, plain, device="cpu")
        x = torch.rand(2, 16, 16, 3, generator=g)
        assert torch.equal(vit.vit_apply(params, x, cfg)["last_hidden"],
                           vit.vit_apply(params, x, plain)["last_hidden"])
    else:
        plain = TextConfig.create(hidden_size=32, num_hidden_layers=1, num_attention_heads=4,
                                  vocab_size=50)
        cfg = TextConfig({**plain, "act_partition": ["data", "seq"]})
        params = bert.init_bert(g, plain, device="cpu")
        ids = torch.randint(1, 50, (2, 4), generator=g)
        assert torch.equal(bert.bert_apply(params, ids, cfg, mode="text")["last_hidden"],
                           bert.bert_apply(params, ids, plain, mode="text")["last_hidden"])
