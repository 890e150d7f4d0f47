"""Port parity of checkpoint import and the native files
(efficientvlm_tpu_torch/train/checkpoint.py, config.load_task_config)
against the JAX package, on the CPU.

A tiny X-VLM (width 32, 12 vision and 12 text layers) is written in the
reference's keys with torch.save and read by both packages' loaders: every
leaf is equal exactly, except the positional table under a resize, where
the port follows the reference's F.interpolate bicubic (held to JAX's own
numpy copy of it, evaluation.grounding.resize_bicubic, within 1e-5) and
JAX's jax.image.resize differs (a recorded deviation)."""

import glob
import os
import stat

import numpy as np
import pytest
import torch

from efficientvlm_tpu import config as jcfg
from efficientvlm_tpu.evaluation.grounding import resize_bicubic
from efficientvlm_tpu.models import vit as JV
from efficientvlm_tpu.train import checkpoint as JC
from efficientvlm_tpu_torch import config as tcfg
from efficientvlm_tpu_torch.drivers import common as TDC
from efficientvlm_tpu_torch.models.vit import interpolate_pos_embed
from efficientvlm_tpu_torch.models.xvlm import XVLM
from efficientvlm_tpu_torch.train import checkpoint as TC
from efficientvlm_tpu_torch.train import optim as TO
from efficientvlm_tpu_torch.train.steps import TrainState

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WIDTH, RES, PATCH = 32, 32, 8  # 16 patches + CLS


def _model(vision_layers=12, text_layers=12, res=RES):
    vcfg = tcfg.VisionConfig.create(vision_width=WIDTH, num_attention_heads=4,
                                    intermediate_size=64, num_hidden_layers=vision_layers,
                                    image_res=res, patch_size=PATCH)
    tcfg_ = tcfg.TextConfig.create(vocab_size=50, hidden_size=WIDTH,
                                   num_hidden_layers=text_layers, num_attention_heads=4,
                                   intermediate_size=64, encoder_width=WIDTH,
                                   max_position_embeddings=40)
    return XVLM(vcfg, tcfg_, tcfg.Config({"embed_dim": 16}))


@pytest.fixture(scope="module")
def reference_file(tmp_path_factory):
    """(path, params): a 12L / 12L tiny X-VLM with the bbox head, in the
    reference's keys inside a {"model": ...} container."""
    params = _model().init(0, device="cpu", with_bbox_head=True)
    sd = TC.xvlm_state_dict_from_params(params, fusion_layer=6)
    path = str(tmp_path_factory.mktemp("ckpt") / "xvlm.th")
    torch.save({"model": sd, "epoch": 3}, path)
    return path, params


def _flat(tree, prefix=""):
    """{path: numpy leaf} over nested dicts / lists (JAX arrays or tensors)."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _flat(sub, f"{prefix}/{key}").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree) for k, v in _flat(sub, f"{prefix}/{i}").items()}
    if isinstance(tree, torch.Tensor):
        return {prefix: tree.detach().numpy()}
    return {prefix: np.asarray(tree)}


def _assert_trees_equal(port, jax_tree, *, skip=()):
    a, b = _flat(port), _flat(jax_tree)
    assert sorted(a) == sorted(b)
    for k in a:
        if k not in skip:
            assert a[k].dtype == np.float32 and a[k].shape == b[k].shape, k
            assert np.array_equal(a[k], b[k]), k


def _np_sd(sd):
    return {k: v.numpy() for k, v in sd.items()}


@pytest.mark.parametrize("layers", [(12, 12), (6, 6)], ids=["12L", "6L-mapped"])
@pytest.mark.parametrize("num_patches", [None, 36], ids=["same-res", "resized"])
def test_xvlm_state_dict_loads_as_jax_does(reference_file, layers, num_patches):
    path, _ = reference_file
    kw = dict(vision_layers=layers[0], text_layers=layers[1], fusion_layer=layers[1] // 2,
              num_patches=num_patches, with_bbox_head=True)
    port = TC.xvlm_params_from_state_dict(TC.load_torch_state_dict(path), device="cpu", **kw)
    ref = JC.xvlm_params_from_state_dict(JC.load_torch_state_dict(path), **kw)
    pos = "/vision/pos_embed/embedding"
    _assert_trees_equal(port, ref, skip=(pos,) if num_patches else ())
    assert all(t.device.type == "cpu" for t in TO.tree_leaves(port))
    if layers == (6, 6):  # the mapper: target layer i is checkpoint layer 2i + 1
        full = TC.xvlm_params_from_state_dict(TC.load_torch_state_dict(path), device="cpu",
                                              **dict(kw, vision_layers=12, text_layers=12,
                                                     fusion_layer=6))
        for i in range(6):
            assert torch.equal(port["vision"]["layers"][i]["attn"]["q"]["kernel"],
                               full["vision"]["layers"][2 * i + 1]["attn"]["q"]["kernel"])
            assert torch.equal(port["text"]["layers"][i]["output"]["kernel"],
                               full["text"]["layers"][2 * i + 1]["output"]["kernel"])
    if num_patches:
        table = TC.load_torch_state_dict(path)["vision_encoder.pos_embed.weight"].numpy()
        grid = resize_bicubic(table[1:].reshape(4, 4, WIDTH), 6, 6).reshape(36, WIDTH)
        got = port["vision"]["pos_embed"]["embedding"].numpy()
        assert got.shape == (37, WIDTH) and np.array_equal(got[0], table[0])
        np.testing.assert_allclose(got[1:], grid, atol=1e-5, rtol=0)


@pytest.mark.parametrize("sizes", [(14, 24), (24, 30), (24, 14)])
def test_pos_embed_resize_is_the_references_not_jaxs(sizes):
    """The port resizes as the reference's F.interpolate(bicubic,
    align_corners=False) does (JAX's own numpy copy within 1e-5); JAX's
    interpolate_pos_embed (jax.image.resize: a = -0.5, antialiased when it
    shrinks) differs from it by more than 1e-2, the deviation the port does
    not copy."""
    n_old, n_new = sizes
    table = np.random.default_rng(n_old + n_new).standard_normal(
        (n_old * n_old + 1, 8)).astype(np.float32)
    got = interpolate_pos_embed(torch.from_numpy(table), n_new * n_new).numpy()
    ref = resize_bicubic(table[1:].reshape(n_old, n_old, 8), n_new, n_new).reshape(-1, 8)
    np.testing.assert_allclose(got[1:], ref, atol=1e-5, rtol=0)
    assert np.array_equal(got[0], table[0])
    jax_resized = np.asarray(JV.interpolate_pos_embed(table, n_new * n_new))
    assert np.abs(jax_resized[1:] - ref).max() > 1e-2


def test_loaders_place_on_the_card_by_default(reference_file):
    """Given no device, a loader places on cuda: without a GPU it raises."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default placement succeeds")
    sd = TC.load_torch_state_dict(reference_file[0])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TC.xvlm_params_from_state_dict(sd, vision_layers=12, text_layers=12, fusion_layer=6)


def test_hf_clip_vision_remap():
    rng = np.random.default_rng(1)
    hf = {"vision_model.embeddings.patch_embedding.weight": rng.standard_normal((8, 3, 4, 4)),
          "vision_model.embeddings.position_embedding.weight": rng.standard_normal((5, 8)),
          "vision_model.embeddings.position_ids": np.arange(5)[None],
          "vision_model.embeddings.class_embedding": rng.standard_normal(8),
          "vision_model.pre_layrnorm.weight": rng.standard_normal(8),
          "vision_model.encoder.layers.0.mlp.fc1.weight": rng.standard_normal((16, 8)),
          "text_model.embeddings.token_embedding.weight": rng.standard_normal((9, 8))}
    port = TC.convert_hf_clip_vision({k: torch.from_numpy(v) for k, v in hf.items()})
    ref = JC.convert_hf_clip_vision(hf)
    assert sorted(port) == sorted(ref) == sorted(
        ["patch_embed.weight", "pos_embed.weight", "class_embedding", "pre_layrnorm.weight",
         "encoder.layers.0.mlp.fc1.weight"])
    for k in ref:
        assert np.array_equal(port[k].numpy(), ref[k])


@pytest.mark.parametrize("bias_key", ["cls.predictions.bias", "cls.predictions.decoder.bias"])
def test_plain_bert_import(reference_file, bias_key):
    """A plain BERT (the `bert.` prefix, no cross-attention, the MLM head's
    decoder bias under either key): the prefix strip, the cross-attention
    from copies of the self-attention (storage of their own), the head."""
    full = TC.load_torch_state_dict(reference_file[0])
    bert = {}
    for k, v in TC.split_by_prefix(full, "text_encoder.").items():
        if "crossattention" in k:
            continue
        if k == "cls.predictions.decoder.bias":
            k = bias_key
        bert[k if k.startswith("cls.") else f"bert.{k}"] = v
    for layers, fusion in ((12, 6), (6, 3)):
        port = TC.bert_params_from_state_dict(bert, layers, fusion, cross_from_self_init=True,
                                              device="cpu")
        ref = JC.bert_params_from_state_dict(_np_sd(bert), layers, fusion,
                                             cross_from_self_init=True)
        _assert_trees_equal(port, ref)
        layer = port["layers"][fusion]
        assert layer["crossattention"]["q"]["kernel"].data_ptr() != \
            layer["attention"]["q"]["kernel"].data_ptr()
        assert "bias" in port["cls"]["decoder"]


def _small_sd():
    """A 2L vision / 4L text (fusion 2) X-VLM in the reference's keys."""
    return TC.xvlm_state_dict_from_params(_model(2, 4).init(1, device="cpu"), fusion_layer=2)


@pytest.mark.parametrize("stored", [False, True], ids=["from-cross", "stored-decoder"])
def test_vqa_import(stored):
    sd = _small_sd()
    if stored:  # a VQA-shaped checkpoint: decoder keys that differ from every text layer
        for k, v in list(sd.items()):
            for src, dst in (("text_encoder.encoder.layer.2.", "text_decoder.bert.encoder.layer.0."),
                             ("text_encoder.encoder.layer.3.", "text_decoder.bert.encoder.layer.1."),
                             ("text_encoder.cls.", "text_decoder.cls."),
                             ("text_encoder.embeddings.", "text_decoder.bert.embeddings.")):
                if k.startswith(src):
                    sd[k.replace(src, dst)] = v + (7.0 if "embeddings" not in src else 0.0)
    kw = dict(vision_layers=2, text_layers=4, fusion_layer=2, num_dec_layers=2, num_patches=16,
              use_stored_decoder=stored)
    port = TC.vqa_params_from_state_dict(sd, device="cpu", **kw)
    _assert_trees_equal(port, JC.vqa_params_from_state_dict(_np_sd(sd), **kw))
    shift = 7.0 if stored else 0.0
    assert torch.equal(port["text_decoder"]["layers"][0]["attention"]["q"]["kernel"],
                       sd["text_encoder.encoder.layer.2.attention.self.query.weight"].t() + shift)


@pytest.mark.parametrize("case", ["encoder-only", "both", "both-capt-pretrain", "decoder-only"])
def test_captioning_import(case):
    sd = _small_sd()
    dec = {k.replace("text_encoder.", "text_decoder."): v + 3.0
           for k, v in sd.items() if k.startswith("text_encoder.")}
    if case != "encoder-only":
        sd = {**sd, **dec}
    if case == "decoder-only":
        sd = {k: v for k, v in sd.items() if not k.startswith("text_encoder.")}
    kw = dict(vision_layers=2, text_layers=4, fusion_layer=2,
              load_capt_pretrain=case == "both-capt-pretrain")
    port = TC.captioning_params_from_state_dict(sd, device="cpu", **kw)
    _assert_trees_equal(port, JC.captioning_params_from_state_dict(_np_sd(sd), **kw))
    from_decoder = case in ("both-capt-pretrain", "decoder-only")
    want = sd[("text_decoder." if from_decoder else "text_encoder.")
              + "encoder.layer.0.attention.self.query.weight"].t()
    assert torch.equal(port["text_decoder"]["layers"][0]["attention"]["q"]["kernel"], want)


@pytest.mark.parametrize("pretrain", [False, True], ids=["x-vlm", "nlvr-domain-pretrain"])
def test_nlvr_import(pretrain):
    sd = _small_sd()
    rng = np.random.default_rng(2)
    sd["cls_head.0.weight"] = torch.from_numpy(rng.standard_normal((64, 32)).astype(np.float32))
    sd["cls_head.0.bias"] = torch.zeros(64)
    sd["cls_head.1.weight"], sd["cls_head.1.bias"] = torch.ones(64), torch.zeros(64)
    sd["cls_head.3.weight"], sd["cls_head.3.bias"] = torch.ones(2, 64), torch.zeros(2)
    sd["ta_head.weight"], sd["ta_head.bias"] = torch.ones(3, 32), torch.zeros(3)
    if pretrain:  # the text stack stored replicated already
        text = TC.split_by_prefix(sd, "text_encoder.")
        from efficientvlm_tpu_torch.models.model_nlvr import duplicate_cross_layers_for_nlvr

        sd = {**{k: v for k, v in sd.items() if not k.startswith("text_encoder.")},
              **{f"text_encoder.{k}": v
                 for k, v in duplicate_cross_layers_for_nlvr(text, 2).items()}}
    kw = dict(vision_layers=2, text_layers=4, fusion_layer=2, load_nlvr_pretrain=pretrain)
    port = TC.nlvr_params_from_state_dict(sd, device="cpu", **kw)
    _assert_trees_equal(port, JC.nlvr_params_from_state_dict(_np_sd(sd), **kw))
    layers = port["text"]["layers"]
    assert len(layers) == 6 and "cls_head" in port and "ta_head" in port
    assert torch.equal(layers[2]["attention"]["q"]["kernel"], layers[3]["attention"]["q"]["kernel"])
    assert layers[2]["attention"]["q"]["kernel"].data_ptr() != \
        layers[3]["attention"]["q"]["kernel"].data_ptr()


def test_state_dict_round_trip_and_jax_export(reference_file):
    """The port's tree -> xvlm_state_dict_from_params -> the port's tree is
    the identity, and the state dict is JAX's (from the same params
    bridged) key for key and value for value."""
    path, params = reference_file
    sd = TC.xvlm_state_dict_from_params(params, fusion_layer=6)
    back = TC.xvlm_params_from_state_dict(sd, vision_layers=12, text_layers=12, fusion_layer=6,
                                          with_bbox_head=True, device="cpu")
    _assert_trees_equal(back, params)
    jparams = JC.xvlm_params_from_state_dict(JC.load_torch_state_dict(path), vision_layers=12,
                                             text_layers=12, fusion_layer=6, with_bbox_head=True)
    ref = JC.xvlm_state_dict_from_params(jparams, fusion_layer=6)
    assert sorted(sd) == sorted(ref)
    for k in ref:
        assert np.array_equal(sd[k].numpy(), np.asarray(ref[k])), k


def test_checkpointer_names_and_rotation(tmp_path):
    tree = {"w": torch.arange(4.0)}
    ck = TC.Checkpointer(str(tmp_path / "run"), keep_last=2)
    for step in (10, 20, 30, 40):
        ck.save_checkpoint(step, tree)
    ck.save_checkpoint("final", tree)
    ck.save_checkpoint(1, tree, step_mode=False, training_states={"step": 40})
    names = sorted(os.listdir(tmp_path / "run"))
    assert names == ["model_state_epoch_1.ckpt", "model_state_step_30.ckpt",
                     "model_state_step_40.ckpt", "model_state_step_final.ckpt",
                     "training_state_latest.ckpt"]
    assert ck.load_latest() == {"step": 40}
    assert torch.equal(TC.load_pytree(str(tmp_path / "run/model_state_step_40.ckpt"))["w"],
                       tree["w"])


def test_checkpointer_hdfs_path(tmp_path, monkeypatch):
    """hdfs:// directories stream through the hdfs CLI (faked by a local
    script, as tests/test_checkpoint.py fakes it for JAX)."""
    from efficientvlm_tpu_torch.utils import io as uio

    backing = tmp_path / "hdfs_store"
    backing.mkdir()
    fake = tmp_path / "hdfs"
    fake.write_text(f"""#!/usr/bin/env python3
import os, shutil, sys
root = {str(backing)!r}
def local(p):
    return os.path.join(root, p.replace("hdfs://", "").lstrip("/"))
cmd = sys.argv[2]
if cmd == "-mkdir":
    os.makedirs(local(sys.argv[-1]), exist_ok=True)
elif cmd == "-test":
    sys.exit(0 if os.path.exists(local(sys.argv[-1])) else 1)
elif cmd == "-put":
    dst = local(sys.argv[-1])
    os.makedirs(os.path.dirname(dst), exist_ok=True)
    with open(dst, "wb") as f:
        shutil.copyfileobj(sys.stdin.buffer, f)
elif cmd == "-text":
    with open(local(sys.argv[-1]), "rb") as f:
        shutil.copyfileobj(f, sys.stdout.buffer)
""")
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(uio, "HDFS_BIN", str(fake))
    params = {"layers": [{"k": torch.randn(3, 2)}, {"k": torch.randn(3, 2)}]}
    ck = TC.Checkpointer("hdfs://ns/ckpts/run1")
    assert (backing / "ns/ckpts/run1").is_dir()
    ck.save_checkpoint(3, {"model": params}, training_states={"step": 3})
    assert ck.load_latest()["step"] == 3
    restored = TC.load_pytree("hdfs://ns/ckpts/run1/model_state_step_3.ckpt")
    for a, b in zip(params["layers"], restored["model"]["layers"]):
        assert torch.equal(a["k"], b["k"])


def test_extract_model_and_gates_and_the_load_memo(tmp_path):
    params = {"layers": [{"w": torch.randn(2, 2)}]}
    loga = {"vision_head": torch.randn(2, 4)}
    lam = {"lambda_1": torch.tensor(0.5), "lambda_2": torch.tensor(-0.5)}
    payloads = {
        "export": (params, None),
        "snapshot": ({"model": params, "l0": {"loga": loga, **lam}, "epoch": 2},
                     {"loga": loga, **lam}),
        "full": ({"state": {"params": params, "loga": loga, "lam": lam, "step": 5},
                  "extra": {"epoch": 0}}, {"loga": loga, **lam}),
        "gd": ({"state": [params, {"count": 1}, 7], "extra": {}}, None),
    }
    for name, (payload, gates) in payloads.items():
        path = str(tmp_path / f"{name}.ckpt")
        TC.save_pytree(path, payload)
        model, got = TC.extract_model_and_gates(TC.load_params(path))
        assert torch.equal(model["layers"][0]["w"], params["layers"][0]["w"]), name
        if gates is None:
            assert got is None, name
        else:
            assert torch.equal(got["loga"]["vision_head"], loga["vision_head"])
            assert float(got["lambda_2"]) == -0.5
        jmodel, jgates = JC.extract_model_and_gates(
            TC.load_params(path))  # the same rule in JAX's function
        assert (jgates is None) == (gates is None), name
    path = str(tmp_path / "full.ckpt")
    first = TC.load_params(path)
    assert TC.load_params(path) is first  # the memo
    TC.clear_load_memo()
    assert TC.load_params(path) is not first
    TC.clear_load_memo()


def _train_state(seed: int):
    g = torch.Generator().manual_seed(seed)
    params = {"a": torch.randn(3, 4, generator=g), "layers": [{"b": torch.randn(5, generator=g)}]}
    loga = {"vision_head": torch.randn(2, 4, generator=g)}
    lam = {"lambda_1": torch.tensor(0.25), "lambda_2": torch.tensor(-0.5)}
    opts = TDC.build_optimizers(params, tcfg.Config({
        "optimizer": {"lr": 1e-2}, "accelerator": {"GRAD_ACCUMULATE_STEPS": 2},
        "skip_nonfinite_updates": 2}), 10)
    state = TrainState(params=params, loga=loga, lam=lam,
                       opt_state=opts[0].init(TO.tree_leaves(params)),
                       l0_state=opts[1].init(TO.tree_leaves(loga)),
                       lam_state=opts[2].init(TO.tree_leaves(lam)), step=0)
    return state, opts


def test_full_state_round_trip(tmp_path, monkeypatch):
    """save_full_state / restore_full_state of a whole TrainState (params,
    log-alphas, λ, all three optimizers' moments, counts, accumulators and
    error counts): bit-equal, synchronous and in the background (the save
    thread is stopped after, so no thread outlives the test)."""
    monkeypatch.setattr(TDC, "_SAVE_EXECUTOR", None)
    state, opts = _train_state(0)
    for i in range(3):  # moments, counts and a half-full accumulator
        for opt, tree, key in ((opts[0], state.params, "opt_state"), (opts[1], state.loga,
                                                                      "l0_state"),
                               (opts[2], state.lam, "lam_state")):
            leaves = TO.tree_leaves(tree)
            opt.step(leaves, [torch.randn_like(x) for x in leaves], getattr(state, key))
        state.step += 1
    for background in (False, True):
        out = str(tmp_path / f"bg{background}")
        os.makedirs(out)
        TDC.save_full_state(out, state, {"epoch": 4, "batches_done": 7}, background=background)
        TDC.wait_for_saves()
        template, _ = _train_state(1)
        restored, extra = TDC.restore_full_state(out, template)
        assert extra == {"epoch": 4, "batches_done": 7}
        assert restored.step == 3 and restored.opt_state["mini_step"] == 1
        assert restored.opt_state["inner"]["inner"]["count"] == 1
        a, b = _flat(restored.__dict__), _flat(state.__dict__)
        assert sorted(a) == sorted(b)
        for k in a:
            assert np.array_equal(a[k], b[k]), k
    assert TDC.restore_full_state(str(tmp_path / "none"), state) is None
    TDC._SAVE_EXECUTOR.shutdown(wait=True)


def _config_files():
    return sorted(glob.glob(os.path.join(ROOT, "configs", "**", "*.yaml"), recursive=True))


@pytest.mark.parametrize("path", _config_files(), ids=lambda p: os.path.relpath(p, ROOT))
def test_load_task_config_matches_jax(path):
    port = tcfg.load_task_config(path, repo_root=ROOT).to_dict()
    ref = jcfg.load_task_config(path, repo_root=ROOT).to_dict()
    assert port == ref
    assert isinstance(tcfg.load_task_config(path, repo_root=ROOT)["text"], tcfg.TextConfig)
