"""Port parity of the other vision towers against the JAX package, on the
CPU, in f32:

- models/deit.py: deit_apply (impl "fused", whose flash core runs its plain
  version on CPU tensors, and "plain"), with head / FFN gates and the
  attention maps, within 1e-5 of JAX's;
- models/swin.py: swin_apply at shifted windows, a window clamped to a
  smaller grid (the bias table's central block) and patch merging, within
  1e-5; its window partition / reverse and shifted-window mask equal JAX's;
- the loaders: interpolate_relative_pos_embed (scipy's spline on both sides)
  within 1e-6, swin_params_from_state_dict and deit_params_from_state_dict
  (the 12 -> 6 mapper, the fused qkv split) leaf for leaf equal to JAX's;
  the DeiT positional resize is the reference's bicubic
  (models/vit.interpolate_pos_embed), as for the CLIP tower, not JAX's;
- xvlm.vision_encoder_dispatch: XVLM and XVLMForRetrieval take the tower
  the config selects (init structure, get_vision_embeds against JAX's XVLM
  within 1e-5, the retrieval forward), a region batch refuses the DeiT
  tower and takes the Swin tower's region rows, and the driver's maybe_load_params fills the vision subtree from
  config["vision"]["ckpt"] as JAX's alt_vision_params_from_file does."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficientvlm_tpu import config as jcfg
from efficientvlm_tpu.models import deit as JD
from efficientvlm_tpu.models import swin as JSw
from efficientvlm_tpu.models.xvlm import XVLM as JXVLM
from efficientvlm_tpu.train import checkpoint as JC
from efficientvlm_tpu_torch import config as tcfg
from efficientvlm_tpu_torch.bridge import params_from_numpy
from efficientvlm_tpu_torch.drivers import common as TDC
from efficientvlm_tpu_torch.evaluation.retrieval import retrieval_forward
from efficientvlm_tpu_torch.models import deit as TD
from efficientvlm_tpu_torch.models import swin as TSw
from efficientvlm_tpu_torch.models import vit as TV
from efficientvlm_tpu_torch.models.model_retrieval import XVLMForRetrieval
from efficientvlm_tpu_torch.models.xvlm import XVLM as TXVLM, vision_encoder_dispatch
from efficientvlm_tpu_torch.train import checkpoint as TC
from tests.test_alt_encoder_ckpt import make_deit_sd, make_swin_sd

torch.set_num_threads(1)
DEIT = dict(vision_width=32, num_attention_heads=4, intermediate_size=64, num_hidden_layers=2,
            image_res=16, patch_size=8)
SWIN = dict(image_res=64, patch_size=4, embed_dim=16, depths=(2, 2, 1), num_heads=(2, 4, 8),
            window_size=8)
TEXT = dict(vocab_size=40, hidden_size=32, num_hidden_layers=2, fusion_layer=1,
            num_attention_heads=4, intermediate_size=64, encoder_width=32,
            max_position_embeddings=16, hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0)


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_numpy(v) for v in tree]
    return tree.numpy()


def _close(got, want, atol, what=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=atol, rtol=0,
                               err_msg=what)


def _tree_equal(got, want, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _tree_equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _tree_equal(g, w, f"{path}/{i}")
    else:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=path)


def _images(n, res, seed=0):
    return np.random.default_rng(seed).standard_normal((n, res, res, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def deit():
    cfg = tcfg.VisionConfig.create(**DEIT)
    tp = TD.init_deit(torch.Generator().manual_seed(0), cfg, "cpu")
    return cfg, jcfg.VisionConfig.create(**DEIT), tp, _numpy(tp)


@pytest.mark.parametrize("impl", ["fused", "plain"])
@pytest.mark.parametrize("gated", [False, True])
def test_deit_forward_matches_jax(deit, impl, gated):
    cfg, jc, tp, jp = deit
    img = _images(2, 16)
    kw = {}
    if gated:
        rng = np.random.default_rng(3)
        kw = dict(head_z=rng.uniform(0.2, 1, (2, 4)).astype(np.float32),
                  mlp_z=rng.uniform(0, 1, (2, 64)).astype(np.float32))
    want = jax.jit(lambda p, x, kw: JD.deit_apply(p, x, jc, output_attentions=gated,
                                                  output_hidden_states=gated, **kw))(jp, img, kw)
    got = TD.deit_apply(tp, torch.from_numpy(img), cfg, output_attentions=gated,
                        output_hidden_states=gated, impl=impl,
                        **{k: torch.from_numpy(v) for k, v in kw.items()})
    _close(got["last_hidden"], want["last_hidden"], 1e-5)
    assert got["last_hidden"].shape == (2, 5, 32)
    if gated:
        for g, w in zip(got["attentions"] + got["hidden_states"],
                        want["attentions"] + want["hidden_states"]):
            _close(g, w, 1e-5)


@pytest.fixture(scope="module")
def swin():
    cfg = TSw.swin_config(**SWIN)
    tp = TSw.init_swin(torch.Generator().manual_seed(0), cfg, "cpu")
    return cfg, JSw.swin_config(**SWIN), tp, _numpy(tp)


def test_swin_forward_matches_jax(swin):
    """64 px / patch 4, window 8: stage 0 (16 x 16) shifts its odd block,
    stage 1 (8 x 8) covers the grid (no shift), stage 2 (4 x 4) clamps the
    window to 4 against the 8-window bias table."""
    cfg, jc, tp, jp = swin
    img = _images(2, 64, 1)
    want = jax.jit(lambda p, x: JSw.swin_apply(p, x, jc))(jp, img)
    got = TSw.swin_apply(tp, torch.from_numpy(img), cfg)
    assert got["last_hidden"].shape == (2, 1 + 16, 64) == want["last_hidden"].shape
    _close(got["last_hidden"], want["last_hidden"], 1e-5)


def test_swin_window_helpers_match_jax():
    x = np.random.default_rng(4).standard_normal((2, 8, 8, 3)).astype(np.float32)
    wins = TSw.window_partition(torch.from_numpy(x), 4)
    np.testing.assert_array_equal(wins.numpy(), np.asarray(JSw._window_partition(x, 4)))
    np.testing.assert_array_equal(TSw.window_reverse(wins, 4, 8, 8).numpy(), x)
    np.testing.assert_array_equal(TSw.shift_mask(8, 8, 4, 2), JSw._shift_mask(8, 8, 4, 2))
    for w, tw in ((4, None), (4, 7)):
        np.testing.assert_array_equal(TSw._rel_pos_index(w, tw), JSw._rel_pos_index(w, tw))


def test_relative_bias_resize_matches_jax():
    src = np.random.default_rng(5).standard_normal((49, 3)).astype(np.float32)
    for dst in (121, 169, 49):
        got = TC.interpolate_relative_pos_embed(torch.from_numpy(src), dst)
        want = np.asarray(JC.interpolate_relative_pos_embed(src, dst))
        assert got.shape == want.shape == (dst, 3)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


def test_swin_loader_matches_jax():
    """A window-4 checkpoint into a window-6 model: every table resized."""
    sd = make_swin_sd()
    kw = dict(depths=(2, 2), window_size=6)
    want = JC.swin_params_from_state_dict({k: v.numpy() for k, v in sd.items()}, **kw)
    got = TC.swin_params_from_state_dict(sd, device="cpu", **kw)
    _tree_equal(got, want)
    assert got["stages"][0]["blocks"][0]["rel_bias"].shape == (121, 2)


@pytest.mark.parametrize("layers", [2, 6])
def test_deit_loader_matches_jax(layers):
    """2 blocks into 2, and 12 blocks into 6 (the reference's mapper)."""
    sd = make_deit_sd(layers=12 if layers == 6 else 2)
    want = JC.deit_params_from_state_dict({k: v.numpy() for k, v in sd.items()}, layers,
                                          num_patches=16)
    got = TC.deit_params_from_state_dict(sd, layers, num_patches=16, device="cpu")
    _tree_equal(got, want)


def test_deit_loader_resizes_positions_as_the_reference():
    sd = make_deit_sd(n_pos=17)
    got = TC.deit_params_from_state_dict(sd, 2, num_patches=64, device="cpu")
    want = TV.interpolate_pos_embed(sd["pos_embed"][0], 64)
    np.testing.assert_array_equal(got["pos_embed"]["embedding"].numpy(), want.numpy())


@pytest.mark.parametrize("tower", ["deit", "swin", "clip"])
def test_dispatch_matches_jax(tower):
    """XVLM(config) inits and applies the selected tower; its image embeds
    against JAX's XVLM on the same tree."""
    flags = {"deit": {"use_deit": True}, "swin": {"use_swin": True}, "clip": {}}[tower]
    if tower == "swin":
        tv, jv = TSw.swin_config(**SWIN), JSw.swin_config(**SWIN)
        res = 64
    else:
        tv, jv = tcfg.VisionConfig.create(**DEIT), jcfg.VisionConfig.create(**DEIT)
        res = 16
    init, apply = vision_encoder_dispatch(tcfg.Config(flags))
    assert apply.__module__.endswith({"deit": "deit", "swin": "swin", "clip": "vit"}[tower])
    model = TXVLM(tv, tcfg.TextConfig.create(**TEXT), tcfg.Config({"embed_dim": 8, **flags}))
    tp = model.init(0, device="cpu")
    jmodel = JXVLM(jv, jcfg.TextConfig.create(**TEXT), jcfg.Config({"embed_dim": 8, **flags}))
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
    assert jax.tree.structure(shapes) == jax.tree.structure(jax.tree.map(lambda x: 0,
                                                                        _numpy(tp)))
    img = _images(2, res, 2)
    want = jax.jit(lambda p, x: jmodel.get_vision_embeds(p, x)[0])(_numpy(tp), img)
    got = model.get_vision_embeds(tp, torch.from_numpy(img))[0]
    _close(got, want, 1e-5)
    if tower == "deit":
        with pytest.raises(ValueError, match="region"):
            model.get_vision_embeds(tp, torch.from_numpy(img),
                                    idx_to_group_img=torch.tensor([0, 1]),
                                    image_atts=torch.ones(2, got.shape[1]))
    elif tower == "swin":  # region rows over whole-image masks are the full rows
        idx = torch.tensor([1, 0, 1])
        region, atts, full, full_atts, _ = model.get_vision_embeds(
            tp, torch.from_numpy(img), idx_to_group_img=idx,
            image_atts=torch.ones(3, got.shape[1]))
        assert region.shape == full.shape == (3,) + got.shape[1:]
        assert atts.dtype == full_atts.dtype == torch.int32
        torch.testing.assert_close(full, got[idx], rtol=0, atol=0)
        torch.testing.assert_close(region, got[idx], rtol=0, atol=1e-6)


def test_retrieval_model_runs_the_selected_tower():
    model = XVLMForRetrieval(TSw.swin_config(**SWIN),
                             tcfg.TextConfig.create(**{**TEXT, "encoder_width": 64}),
                             tcfg.Config({"embed_dim": 8, "use_swin": True}))
    tp = model.init(0, device="cpu")
    assert "stages" in tp["vision"]
    ids = torch.randint(3, 40, (2, 6), generator=torch.Generator().manual_seed(0))
    out = retrieval_forward(model, tp, torch.from_numpy(_images(2, 64)), ids,
                            torch.ones(2, 6, dtype=torch.int32))
    for v in out.values() if isinstance(out, dict) else out:
        assert torch.isfinite(torch.as_tensor(v)).all()


def test_maybe_load_params_reads_the_tower_file(tmp_path):
    """use_deit with config vision.ckpt and no --checkpoint: the vision
    subtree is the file's, as JAX's alt_vision_params_from_file reads it."""
    sd = make_deit_sd()
    path = str(tmp_path / "deit.pth")
    torch.save({"model": sd}, path)
    vcfg = tcfg.VisionConfig.create(**{**DEIT, "image_res": 32})
    config = tcfg.Config({"use_deit": True, "vision": {"ckpt": path}, "embed_dim": 8})
    model = TXVLM(vcfg, tcfg.TextConfig.create(**TEXT), config)
    params = TDC.maybe_load_params(model, tcfg.Config({}), config,
                                   lambda: model.init(0, device="cpu"), device="cpu")
    want = JC.alt_vision_params_from_file(path, jcfg.Config({"use_deit": True}),
                                          jcfg.VisionConfig.create(**{**DEIT, "image_res": 32}))
    _tree_equal(params["vision"], want)
