"""The sequence axis, the pipeline and expert parallelism of the port, each
held to its JAX test on that test's inputs, over four gloo ranks
(tests/torch_ranks.py: parallel_check --parts sp,pipeline,ep, fed the
params and inputs JAX's tests draw):

- tests/test_seq_axis.py: the ViT and the BERT (text and fusion layers)
  forwards with act_partition, the tokens sharded over the four ranks (the
  ViT's 17 tokens padded to 20), equal JAX's unsharded forwards within
  2e-5, and the port's unsharded ones;
- tests/test_pipeline.py: the 4-layer BERT stack pipelined over four stages
  (one layer each, 2 microbatches) and over two stages (each pair of
  ranks, 4 microbatches and 1) equals JAX's sequential stack: the forward
  within 2e-5, the gradients of sum(out ** 2) within rtol 5e-4 / atol 5e-5;
- tests/test_moe.py::test_moe_expert_parallel_sharding: moe_ffn with its 4
  experts over the four ranks (each rank 6 of the 24 tokens) equals JAX's
  moe_ffn, output and aux loss within rtol 1e-5 / atol 1e-6, at JAX's
  capacity factor 2 and at 0.5, where tokens are dropped.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_ranks import load, spawn_check  # noqa: E402

torch.set_num_threads(1)
CAPACITIES = (2.0, 0.5)


def _np(tree):
    import jax

    return jax.tree.map(lambda a: np.array(a, dtype=np.asarray(a).dtype), tree)


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """JAX's tests' params and inputs, JAX's unsharded results, and the four
    ranks' dumps."""
    import jax
    import jax.numpy as jnp

    from efficientvlm_tpu.config import TextConfig, VisionConfig
    from efficientvlm_tpu.models import bert as JB
    from efficientvlm_tpu.models import vit as JV
    from efficientvlm_tpu.ops.moe import init_moe_ffn, moe_ffn
    from efficientvlm_tpu_torch.bridge import params_from_numpy
    from efficientvlm_tpu_torch.train import checkpoint as TC

    vcfg = VisionConfig.create(vision_width=64, num_attention_heads=4, intermediate_size=96,
                               num_hidden_layers=2, image_res=32, patch_size=8)
    tcfg = TextConfig.create(vocab_size=60, hidden_size=64, num_hidden_layers=4, fusion_layer=2,
                             num_attention_heads=4, intermediate_size=96, encoder_width=64,
                             max_position_embeddings=32, hidden_dropout_prob=0.0,
                             attention_probs_dropout_prob=0.0)
    vp = JV.init_vit(jax.random.PRNGKey(0), vcfg)
    imgs = jax.random.normal(jax.random.PRNGKey(1), (8, 32, 32, 3)) * 0.1
    bp = JB.init_bert(jax.random.PRNGKey(0), tcfg)
    ids = jax.random.randint(jax.random.PRNGKey(1), (8, 16), 0, 60)
    atts = jnp.ones((8, 16), jnp.int32).at[0, 12:].set(0)
    enc = jax.random.normal(jax.random.PRNGKey(2), (8, 6, 64)) * 0.1
    enc_atts = jnp.ones((8, 6), jnp.int32)
    want = {"vit": JV.vit_apply(vp, imgs, vcfg)["last_hidden"],
            "bert": JB.bert_apply(bp, ids, tcfg, attention_mask=atts, encoder_hidden=enc,
                                  encoder_attention_mask=enc_atts)["last_hidden"]}

    pcfg = TextConfig.create(vocab_size=64, hidden_size=64, num_hidden_layers=4,
                             num_attention_heads=4, intermediate_size=128, encoder_width=64,
                             fusion_layer=4, max_position_embeddings=16,
                             hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    layers = [JB.init_bert_layer(k, pcfg, i)
              for i, k in enumerate(jax.random.split(jax.random.PRNGKey(0), 4))]
    x = jax.random.normal(jax.random.PRNGKey(1), (8, 12, 64))
    bias = (1.0 - jnp.ones((8, 12)).at[:, -3:].set(0)[:, None, None, :]) * -1e9
    stacked = jax.tree.map(lambda *a: jnp.stack(a), *layers)

    def seq(st):
        def body(c, p):
            return JB.bert_layer_apply(p, c, pcfg, bias=bias)[0], None

        return jax.lax.scan(body, x, st)[0]

    want["pp_out"] = jax.jit(seq)(stacked)
    want["pp_grad"] = jax.jit(jax.grad(lambda st: jnp.sum(seq(st) ** 2)))(stacked)

    moe = init_moe_ffn(jax.random.PRNGKey(0), hidden=16, ffn=32, num_experts=4)
    h = jax.random.normal(jax.random.PRNGKey(1), (2, 12, 16))
    for i, cf in enumerate(CAPACITIES):
        out, aux = jax.jit(lambda p, a, cf=cf: moe_ffn(p, a, capacity_factor=cf))(moe, h)
        want[f"ep_out/{i}"], want[f"ep_aux/{i}"] = out, aux

    out = str(tmp_path_factory.mktemp("sp_pp_ep"))
    inputs = {"vit": _np(vp), "images": _np(imgs), "bert": _np(bp),
              "ids": np.asarray(ids, np.int64), "atts": np.asarray(atts, np.int64),
              "enc": _np(enc), "enc_atts": np.asarray(enc_atts, np.int64),
              "layers": [_np(lp) for lp in layers], "x": _np(x), "bias": _np(bias),
              "moe": _np(moe), "h": _np(h), "capacity": np.asarray(CAPACITIES, np.float32)}
    TC.save_pytree(os.path.join(out, "inputs.ckpt"), params_from_numpy(inputs, "cpu"))
    spawn_check(4, out, ["sp", "pipeline", "ep"], inputs=os.path.join(out, "inputs.ckpt"))
    dumps = {p: [load(out, p, r) for r in range(4)] for p in ("sp", "pipeline", "ep")}
    return {"want": _np(want), "dumps": dumps, "stacked": stacked}


@pytest.mark.parametrize("tower", ["vit", "bert"])
def test_seq_sharded_forward_matches_unsharded(case, tower):
    want = case["want"][tower]
    for d in case["dumps"]["sp"]:
        np.testing.assert_allclose(d[tower], want, atol=2e-5)
        np.testing.assert_allclose(d[tower], d[f"ref_{tower}"], atol=1e-6)


def _grad_paths(stacked):
    """JAX's gradient leaves keyed by path, in the port's leaf order (the
    dumps' "grad/<j>")."""
    import jax

    from efficientvlm_tpu_torch.train.optim import tree_leaves_with_path

    port = [tuple(p) for p, _ in tree_leaves_with_path(_np(stacked))]
    jax_paths = {tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path): leaf
                 for path, leaf in jax.tree_util.tree_leaves_with_path(stacked)}
    return [jax_paths[p] for p in port]


@pytest.mark.parametrize("schedule", ["all", "pairs", "pairs_m1"])
def test_pipeline_matches_sequential(case, schedule):
    """The forward on every rank; the gradients summed over a pipeline's
    stages (each stage holds its own layers' gradients)."""
    dumps, want = case["dumps"]["pipeline"], case["want"]
    for d in dumps:
        np.testing.assert_allclose(d[f"{schedule}/out"], want["pp_out"], rtol=2e-5, atol=2e-5)
    grads = _grad_paths(_np(want["pp_grad"]))
    stages = [dumps] if schedule == "all" else [dumps[:2], dumps[2:]]
    for group in stages:
        for j, w in enumerate(grads):
            got = sum(d[f"{schedule}/grad/{j}"] for d in group)
            np.testing.assert_allclose(got, np.asarray(w), rtol=5e-4, atol=5e-5, err_msg=str(j))


@pytest.mark.parametrize("i", range(len(CAPACITIES)))
def test_moe_expert_parallel_sharding(case, i):
    want = case["want"]
    for d in case["dumps"]["ep"]:
        np.testing.assert_allclose(d[f"{i}/out"], np.asarray(want[f"ep_out/{i}"]).reshape(-1, 16),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(float(d[f"{i}/aux"]), float(want[f"ep_aux/{i}"]), rtol=1e-5)
    if i == 1:  # capacity 0.5 drops tokens: their rows are zero
        assert (np.abs(case["dumps"]["ep"][0]["1/out"]).sum(-1) == 0).any()


def test_expert_parallelism_is_forward_only():
    from efficientvlm_tpu_torch.ops import moe as MOE

    params = MOE.init_moe_ffn(torch.Generator().manual_seed(0), hidden=8, ffn=16,
                              num_experts=2)
    params["wi"].requires_grad_(True)
    with pytest.raises(NotImplementedError, match="forward only"):
        MOE.moe_ffn_ep(params, torch.zeros(4, 8))


@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a CUDA device")
def test_seq_block_attention_on_the_kernel():
    """A token block's self-attention is the fused cross kernel over the
    gathered tokens with the padding masked: at 577 tokens in two blocks of
    289 (one padded key), it equals the fused self-attention's rows."""
    from efficientvlm_tpu_torch.ops import fused_mha as F
    from efficientvlm_tpu_torch.ops.attention import init_attention

    g = torch.Generator(device="cuda").manual_seed(0)
    p = init_attention(g, 768, 12, device="cuda")
    x = torch.randn(2, 577, 768, generator=g, device="cuda").bfloat16()
    full = F.fused_self_attention(p, x, num_heads=12)
    padded = torch.cat([x, x.new_zeros(2, 1, 768)], 1)
    kb = torch.zeros(2, 578, device="cuda")
    kb[:, -1] = -1e9
    for r in range(2):
        block = F.fused_cross_attention(p, padded[:, r * 289:(r + 1) * 289], padded,
                                        num_heads=12, key_bias=kb)
        rows = slice(r * 289, min((r + 1) * 289, 577))
        n = rows.stop - rows.start
        err = float((block[:, :n].float() - full[:, rows].float()).abs().max())
        assert err <= 4 * 2 ** -8 * float(full.float().abs().max()), err
