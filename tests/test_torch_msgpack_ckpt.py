"""The port reads the JAX package's own `.ckpt` files (flax msgpack,
efficientvlm_tpu/train/checkpoint.save_pytree), decoded without flax
(train/checkpoint.decode_flax_msgpack): files written here by JAX's own
writers, read by the port and compared leaf by leaf.

- a snapshot (JAX's Checkpointer: {"model", "l0", "epoch"}), a full state
  (JAX's common.save_full_state: the TrainState with its optax states and
  the driver's extra) and a physically pruned export (JAX's
  prune_xvlm_params);
- a bfloat16 leaf, a leaf forced through flax's chunked form (JAX's
  MAX_CHUNK_SIZE lowered on the JAX side only) and numpy scalars;
- the drivers' loaders take them: maybe_load_params, load_eval_params and
  native_eval_gates give the stored params and the gates of
  forward_deterministic, and one retrieval forward (the towers, the
  fusion layers and the ITC features) from the snapshot equals JAX's from
  the same file; restore_full_state refuses a JAX full state (its optax
  moments do not resume in the port).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficientvlm_tpu.config import Config as JConfig
from efficientvlm_tpu.config import TextConfig as JText
from efficientvlm_tpu.config import VisionConfig as JVision
from efficientvlm_tpu.drivers import common as JC
from efficientvlm_tpu.models.model_retrieval import XVLMForRetrieval as JModel
from efficientvlm_tpu.pruning.export import prune_xvlm_params
from efficientvlm_tpu.pruning.l0_module import XVLML0Module as JL0
from efficientvlm_tpu.train import checkpoint as JCK
from efficientvlm_tpu.train.steps import init_train_state
from efficientvlm_tpu_torch.config import Config, TextConfig, VisionConfig
from efficientvlm_tpu_torch.drivers import common as TC
from efficientvlm_tpu_torch.models.model_retrieval import XVLMForRetrieval as TModel
from efficientvlm_tpu_torch.pruning.l0_module import XVLML0Module as TL0
from efficientvlm_tpu_torch.train import checkpoint as TCK

torch.set_num_threads(1)
VISION = dict(vision_width=32, num_attention_heads=4, intermediate_size=64, num_hidden_layers=2,
              image_res=16, patch_size=8)
TEXT = dict(vocab_size=50, hidden_size=32, num_hidden_layers=4, fusion_layer=2,
            num_attention_heads=4, intermediate_size=64, encoder_width=32,
            max_position_embeddings=16, hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0)
L0 = dict(vision_layers=2, text_layers=2, cross_layers=2, hidden_size=32, intermediate_size=64,
          num_heads=4, target_sparsity=0.25)


def _np(tree):
    return jax.tree.map(lambda a: np.array(a, dtype=np.asarray(a).dtype), tree)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """JAX's files and the trees JAX wrote into them."""
    root = str(tmp_path_factory.mktemp("jax_ckpt"))
    model = JModel(JVision.create(**VISION, scan_layers=False),
                   JText.create(**TEXT, scan_layers=False), JConfig({"embed_dim": 16}))
    params = _np(model.init(jax.random.PRNGKey(0)))
    l0 = JL0(**L0)
    l0p = _np(l0.init(jax.random.PRNGKey(1)))
    rng = np.random.default_rng(3)
    l0p["loga"] = {k: (v + rng.uniform(-2, 2, v.shape)).astype(np.float32)
                   for k, v in l0p["loga"].items()}
    snapshot = {"model": params, "l0": l0p, "epoch": 3}
    path = JCK.Checkpointer(root).save_checkpoint(3, snapshot, step_mode=False)
    opts = JC.build_optimizers(params, JConfig({"optimizer": {"lr": 1e-4}}), 100)
    state = init_train_state(jax.tree.map(jnp.asarray, params), l0p, opts)
    JC.save_full_state(root, state, {"epoch": np.int64(5), "batches_done": 7})
    zs = l0.forward_deterministic(l0p)
    pruned = _np(prune_xvlm_params(params, zs, fusion_layer=2, head_dim=8))
    JCK.save_pytree(os.path.join(root, "pruned.ckpt"), pruned)
    # a bf16 leaf and one over the (lowered) chunk size, numpy scalars
    import flax.serialization as fs

    odd = {"bf16": jnp.asarray(rng.standard_normal((3, 5)), jnp.bfloat16),
           "big": rng.standard_normal((40, 30)).astype(np.float32),
           "count": np.int64(9), "scale": np.float32(0.5), "flag": np.bool_(True),
           "ints": np.arange(6, dtype=np.int32).reshape(2, 3)}
    chunk = fs.MAX_CHUNK_SIZE
    fs.MAX_CHUNK_SIZE = 1024  # the 4,800-byte leaf goes out in 5 chunks
    try:
        JCK.save_pytree(os.path.join(root, "odd.ckpt"), odd)
    finally:
        fs.MAX_CHUNK_SIZE = chunk
    return dict(root=root, snapshot=path, full=os.path.join(root, "training_state_latest.ckpt"),
                pruned=os.path.join(root, "pruned.ckpt"), odd=os.path.join(root, "odd.ckpt"),
                params=params, l0p=l0p, pruned_tree=pruned, odd_tree=_np(odd), zs=_np(zs),
                model=model, l0=l0)


def _assert_tree_equal(got, want, path=""):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            _assert_tree_equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_tree_equal(g, w, f"{path}/{i}")
    else:
        w = np.asarray(want)
        g = got.float().numpy() if torch.is_tensor(got) and got.dtype == torch.bfloat16 else (
            got.numpy() if torch.is_tensor(got) else np.asarray(got))
        assert g.shape == w.shape, path
        np.testing.assert_array_equal(g, w.astype(np.float32) if w.dtype.name == "bfloat16"
                                      else w, err_msg=path)


def test_the_port_tells_the_formats_apart(files, tmp_path):
    own = str(tmp_path / "own.ckpt")
    TCK.save_pytree(own, {"w": torch.ones(2)})
    assert not TCK.is_msgpack(own)
    for key in ("snapshot", "full", "pruned", "odd"):
        assert TCK.is_msgpack(files[key]), key


def test_snapshot_and_export_read_leaf_by_leaf(files):
    tree = TCK.load_params(files["snapshot"])
    _assert_tree_equal(tree["model"], files["params"], "model")
    _assert_tree_equal(tree["l0"], files["l0p"], "l0")
    assert int(tree["epoch"]) == 3
    _assert_tree_equal(TCK.load_params(files["pruned"]), files["pruned_tree"], "pruned")
    TCK.clear_load_memo()


def test_bf16_chunked_and_scalar_leaves(files):
    odd = TCK.load_pytree(files["odd"])
    assert odd["bf16"].dtype == torch.bfloat16
    assert odd["ints"].dtype == torch.int32
    _assert_tree_equal(odd, files["odd_tree"])


def test_full_state_gives_params_gates_and_epoch(files):
    tree = TCK.load_params(files["full"])
    params, gates = TCK.extract_model_and_gates(tree)
    _assert_tree_equal(params, files["params"], "params")
    _assert_tree_equal(gates["loga"], files["l0p"]["loga"], "loga")
    assert int(tree["extra"]["epoch"]) == 5 and int(tree["extra"]["batches_done"]) == 7
    TCK.clear_load_memo()
    with pytest.raises(ValueError, match="JAX run's full state"):
        TC.restore_full_state(files["root"], object())


def _port():
    model = TModel(VisionConfig.create(**VISION), TextConfig.create(**TEXT),
                   Config({"embed_dim": 16}))
    return model, TL0(**L0)


@pytest.mark.parametrize("key", ["snapshot", "full", "pruned"])
def test_the_drivers_loaders_take_jax_files(files, key):
    """maybe_load_params (the --evaluate path), load_eval_params (infer and
    serve) and native_eval_gates give the stored params and, where the file
    stores log-alphas, JAX's forward_deterministic gates."""
    model, l0 = _port()
    args = Config({"checkpoint": files[key]})
    params = TC.maybe_load_params(model, args, Config(), lambda: None, device="cpu")
    want = files["pruned_tree"] if key == "pruned" else files["params"]
    _assert_tree_equal(params, want)
    gates = TC.native_eval_gates(l0, args, Config(), device="cpu")
    p2, zs = TC.load_eval_params(model, l0, files[key], None, "cpu")
    _assert_tree_equal(p2, want)
    if key == "pruned":
        assert gates is None and zs is None
    else:
        for k, v in files["zs"].items():
            np.testing.assert_array_equal(np.asarray(gates[k]), v, err_msg=k)
            np.testing.assert_array_equal(np.asarray(zs[k]), v, err_msg=k)


def test_a_retrieval_forward_from_a_jax_snapshot(files):
    """The towers, the fusion layers (gated) and the ITC features from the
    snapshot, against JAX's from the same file, f32."""
    jtree = JCK.load_pytree(files["snapshot"])
    jparams = jax.tree.map(jnp.asarray, JCK._relist(jtree["model"]))
    jzs = files["l0"].forward_deterministic({"loga": files["l0p"]["loga"]})
    model, l0 = _port()
    args = Config({"checkpoint": files["snapshot"]})
    tparams = TC.maybe_load_params(model, args, Config(), lambda: None, device="cpu")
    tzs = TC.native_eval_gates(l0, args, Config(), device="cpu")
    rng = np.random.default_rng(6)
    image = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
    ids = rng.integers(1, 50, (2, 8)).astype(np.int32)
    atts = np.ones((2, 8), np.int32)
    atts[1, 6:] = 0
    jm, tm = files["model"], model
    jv, jva, _ = jm.get_vision_embeds(jparams, jnp.asarray(image), zs=jzs)
    jt = jm.get_text_embeds(jparams, jnp.asarray(ids), jnp.asarray(atts), zs=jzs)["last_hidden"]
    jx = jm.get_cross_embeds(jparams, jv, jva, text_embeds=jt, text_atts=jnp.asarray(atts),
                             zs=jzs)["last_hidden"]
    jf = jm.get_features(jparams, jv, jt)
    with torch.no_grad():
        tv, tva, _ = tm.get_vision_embeds(tparams, torch.from_numpy(image), zs=tzs)
        tt = tm.get_text_embeds(tparams, torch.from_numpy(ids).long(), torch.from_numpy(atts),
                                zs=tzs)["last_hidden"]
        tx = tm.get_cross_embeds(tparams, tv, tva, text_embeds=tt,
                                 text_atts=torch.from_numpy(atts), zs=tzs)["last_hidden"]
        tf = tm.get_features(tparams, tv, tt)
    for got, want in ((tv, jv), (tt, jt), (tx, jx), (tf[0], jf[0]), (tf[1], jf[1])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
