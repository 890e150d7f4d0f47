"""Tensor parallelism of the port (parallel/sharding.py): the rules against
JAX's (parallel/sharding._spec_for), and the target JAX names in
__graft_entry__.py (its dp x tp pass): the whole three-optimizer retrieval
pruning step with student and teacher tensor-sharded, here at tp 2 over two
gloo ranks (tests/torch_ranks.py: parallel_check --parts tp,vocab) against
the same step on one rank's whole params and against JAX's unsharded step
(tests/jax_pruning_ref.py, one device, the whole batch), all three from
JAX's init (--init) over the same batches.

Held against JAX: every loss of three steps within 1e-4 relative; the
step-1 gradients, read as the first moments after the step ((1 - b1) x
the clipped gradient; the shards gathered), within
tests/test_torch_train.py's gradient tolerance; the params after one step
and the params, log-alphas and λs after three within 1e-4 plus the
disagreement that tolerance lets through Adam (test_torch_ddp's rule).

Held against one rank: the ranks bit-equal; every loss of three steps within 1e-5 relative
and the step-1 gradients (the shards gathered) within 1e-5 of each group's
largest gradient (the same f32 arithmetic in another order); the params
after one step within 1e-6 plus the disagreement the gradient tolerance
lets through Adam's first update (tests/test_torch_train.py's rule: an
entry whose gradient is zero up to f32 noise may move by up to 2 lr);
a vocab-parallel embedding lookup and MLM loss against the unsharded ones.
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
LR = {"params": 1e-3, "loga": 1e-2, "lam": 1e-2}  # multihost_check.tiny_config's
STEPS, BATCH = 3, 4  # parallel_check.TINY's


@pytest.fixture(scope="module")
def jax_init():
    return J.jax_init()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, jax_init):
    out = str(tmp_path_factory.mktemp("tp"))
    spawn_check(2, out, ["tp", "vocab"], init=J.write_port_init(os.path.join(out, "init.ckpt"),
                                                                jax_init))
    return {part: [load(out, part, r) for r in range(2)] for part in ("tp", "vocab")}


@pytest.fixture(scope="module")
def jax_run(jax_init):
    return J.run_steps(jax_init, STEPS, BATCH, devices=1)


def _tree():
    from efficientvlm_tpu_torch.config import TextConfig, VisionConfig
    from efficientvlm_tpu_torch.models.xvlm import init_xvlm

    v = VisionConfig.create(vision_width=32, num_attention_heads=4, intermediate_size=64,
                            num_hidden_layers=2, image_res=16, patch_size=8)
    t = TextConfig.create(vocab_size=50, hidden_size=32, num_hidden_layers=4, fusion_layer=2,
                          num_attention_heads=4, intermediate_size=64, encoder_width=32)
    return init_xvlm(torch.Generator().manual_seed(0), v, t, embed_dim=16, device="cpu")


def test_partition_rules_follow_jaxs():
    """Every kernel and table of a transformer layer and the vocab leaves
    shard on JAX's dim; the column layers' biases shard with their kernels;
    the heads outside the layers (ITM, projections) stay replicated."""
    from efficientvlm_tpu.parallel.sharding import _spec_for
    from efficientvlm_tpu_torch.parallel.sharding import param_partition_specs
    from efficientvlm_tpu_torch.train.optim import path_str, tree_leaves_with_path

    tree, checked = _tree(), 0
    specs = param_partition_specs(tree)
    for p, t in tree_leaves_with_path(tree):
        path = path_str(p)
        got = specs
        for k in p:
            got = got[k]
        if "layers" in path.split("/") or "word" in path or "/cls/" in path:
            if t.ndim >= 2:
                spec = tuple(_spec_for(path, np.zeros(t.shape)))
                want = next((i for i, a in enumerate(spec) if a is not None), None)
                assert got == want, path
                checked += 1
            elif path.endswith("bias") and (path.endswith("cls/decoder/bias") or path.split(
                    "/")[-2] in ("q", "k", "v", "fc1", "intermediate")):
                assert got == 0, path
            else:
                assert got is None, path
        else:
            assert got is None, path
    assert checked > 20


def test_gate_groups_stay_on_one_rank():
    from efficientvlm_tpu_torch.parallel.sharding import check_heads

    check_heads(12, 2, 2)
    with pytest.raises(ValueError, match="heads"):
        check_heads(12, 2, 4)
    with pytest.raises(ValueError, match="heads"):
        check_heads(6, 4, 1)


def test_tp_ranks_end_bit_equal(ranks):
    a, b = ranks["tp"]
    for k in a:
        if k != "report":
            assert np.array_equal(a[k], b[k]), k


def test_tp_losses_match_one_rank(ranks):
    a = ranks["tp"][0]
    keys = [k for k in a if k.startswith("tp/metric/")]
    assert len(keys) >= 10
    for k in keys:
        want = a[k.replace("tp/", "one/", 1)]
        np.testing.assert_allclose(a[k], want, rtol=1e-5, atol=1e-7, err_msg=k)
    assert len(a["tp/metric/loss"]) == 3


def test_tp_step1_gradients_match_one_rank(ranks):
    """The gradients of the params (the shards gathered), the log-alphas
    (summed over the ranks: each head's from its owner) and the λs."""
    a = ranks["tp"][0]
    for group in ("params", "loga", "lam"):
        keys = [k for k in a if k.startswith(f"one/grad1/{group}/")]
        assert keys, group
        scale = max(float(np.abs(a[k]).max()) for k in keys)
        for k in keys:
            np.testing.assert_allclose(a[k.replace("one/", "tp/", 1)], a[k], rtol=0,
                                       atol=1e-5 * scale, err_msg=k)


def test_tp_params_after_a_step_match_one_rank(ranks):
    from efficientvlm_tpu_torch.parallel import multihost_check as M
    from efficientvlm_tpu_torch.drivers.retrieval import build_models
    from efficientvlm_tpu_torch.train.optim import tree_leaves_with_path

    a = ranks["tp"][0]
    student, _ = build_models(M.tiny_config())
    # the dump's leaves in the state's tree order, the order of the gradients
    paths = [k[len("one/step1/params/"):] for k in a if k.startswith("one/step1/params/")]
    assert sorted(paths) == sorted("/".join(map(str, p)) for p, _ in tree_leaves_with_path(
        student.init(0, device="cpu")))
    for j, path in enumerate(paths):
        want, got = a[f"one/step1/params/{path}"], a[f"tp/step1/params/{path}"]
        # a leaf no loss reads (the MLM head) has no gradient: weight decay alone
        g = np.abs(a.get(f"one/grad1/params/{j}", np.zeros_like(want))).astype(np.float64)
        tol = 5e-3 * g + max(5e-4 * g.max(), 1e-8)
        allowed = 1e-6 + 2 * LR["params"] * np.minimum(1.0, tol / (g + 1e-8))
        err = np.abs(got - want)
        assert (err <= allowed).all(), f"{path}: max err {err.max():.3e}"


def test_tp_losses_match_jax(ranks, jax_run):
    metrics = jax_run[0]
    a = ranks["tp"][0]
    assert len(a["tp/metric/loss"]) == STEPS
    for k in metrics[0]:
        want = np.asarray([m[k] for m in metrics])
        np.testing.assert_allclose(a[f"tp/metric/{k}"], want, rtol=1e-4, atol=1e-6, err_msg=k)


def test_tp_step1_gradients_match_jax(ranks, jax_run):
    """The clipped step-1 gradients of the params (the shards gathered),
    the log-alphas and the λs, as each side's first moment over 1 - b1,
    within 1e-5 of each group's largest gradient (test_torch_ddp's rule for
    the same f32 arithmetic in another order: a leaf whose gradient is a
    cancellation, as the projections' biases under the features' L2 norm,
    carries f32 noise of its own size)."""
    moments = jax_run[2][0]
    a = ranks["tp"][0]
    for group, opt in (("params", "opt"), ("loga", "l0"), ("lam", "lam")):
        assert moments[opt], group
        scale = max(float(np.abs(mu).max()) for mu in moments[opt].values()) / (1 - J.B1)
        for name, mu in moments[opt].items():
            np.testing.assert_allclose(a[f"tp/mu1/{group}/{name}"] / (1 - J.B1), mu / (1 - J.B1),
                                       rtol=0, atol=1e-5 * scale, err_msg=f"{group}/{name}")


def test_tp_params_match_jax(ranks, jax_run):
    """The params after one step, and the params, log-alphas and λs after
    three."""
    _, states, moments = jax_run
    a = ranks["tp"][0]
    J.assert_leaves_match(a, "tp/step1/", states[0], moments[:1], groups=("params",))
    J.assert_leaves_match(a, "tp/", states[-1], moments)


def test_vocab_parallel_embedding_and_mlm_loss(ranks):
    """The word lookup over vocab shards and the MLM loss over vocab-sharded
    logits give the unsharded loss, and the gradients of the table, the
    decoder and the head's transform (gathered)."""
    for d in ranks["vocab"]:
        np.testing.assert_allclose(d["loss"], d["ref_loss"], rtol=1e-6)
        for k in ("word", "decoder", "dense"):
            scale = float(np.abs(d[f"ref_{k}"]).max())
            np.testing.assert_allclose(d[k], d[f"ref_{k}"], rtol=0, atol=1e-5 * scale,
                                       err_msg=k)


@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a CUDA device")
def test_fused_attention_runs_a_ranks_six_heads():
    """A tp rank's fused self- and cross-attention: 6 of the 12 heads (an
    attention width of 384 under a model width of 768) on the kernels,
    against their plain versions at the same bf16 inputs."""
    from efficientvlm_tpu_torch.ops import fused_mha as F
    from efficientvlm_tpu_torch.ops.attention import init_attention

    g = torch.Generator(device="cuda").manual_seed(0)
    full = init_attention(g, 768, 12, device="cuda")
    local = {k: {"kernel": v["kernel"][:, :384] if k != "out" else v["kernel"][:384],
                 "bias": v["bias"][:384] if k != "out" else v["bias"]} for k, v in full.items()}
    x = torch.randn(4, 40, 768, generator=g, device="cuda").bfloat16()
    enc = torch.randn(4, 577, 768, generator=g, device="cuda").bfloat16()
    for got, want in (
            (F.fused_self_attention(local, x, num_heads=6),
             F.self_attention_plain(local, x, torch.zeros(4, 40, device="cuda"),
                                    torch.ones(6, device="cuda"), 6)),
            (F.fused_cross_attention(local, x, enc, num_heads=6),
             F.cross_attention_plain(local, x, enc, torch.zeros(4, 577, device="cuda"),
                                     torch.ones(6, device="cuda"), 6))):
        err = float((got.float() - want.float()).abs().max())
        assert err <= 4 * 2 ** -8 * float(want.float().abs().max()), err
