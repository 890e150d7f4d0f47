"""Port parity of the two translation models and their checkpoint loader
against the JAX package, on the CPU, in f32 (JAX's impl="xla", the port's
default "fused", whose wrappers run their plain versions on CPU tensors):

- XVLMForCrossGeneration and TextTranslater: the decoder config (its own
  vocabulary, fusion 0, num_dec_layers deep, K/V width the text width), the
  target LM loss with label smoothing (pads and BOS masked) within 1e-4, and
  greedy and 2-beam generation, token ids equal;
- crossgen_params_from_state_dict on a reference-keyed state dict, both
  sides given the same `fresh` tree through the bridge: leaf for leaf equal
  (the decoder from text layers fusion + i, its word embeddings and head
  fresh), with matched cross widths and with a width mismatch (the
  decoder's cross K/V stay fresh)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficientvlm_tpu import config as jcfg
from efficientvlm_tpu.models import model_generation as JM
from efficientvlm_tpu.train import checkpoint as JC
from efficientvlm_tpu_torch import config as tcfg
from efficientvlm_tpu_torch.bridge import params_from_numpy
from efficientvlm_tpu_torch.models import model_generation as TM
from efficientvlm_tpu_torch.models.xvlm import XVLM as TXVLM
from efficientvlm_tpu_torch.train import checkpoint as TC

torch.set_num_threads(1)
VISION = dict(vision_width=24, num_attention_heads=4, intermediate_size=48,
              num_hidden_layers=2, image_res=16, patch_size=8)
TEXT = dict(vocab_size=40, hidden_size=32, num_hidden_layers=4, num_attention_heads=4,
            intermediate_size=64, encoder_width=24, max_position_embeddings=32,
            hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
MODEL = {"decoder_vocab_size": 55, "num_dec_layers": 2, "label_smoothing": 0.1}
BOS, EOS, PAD = 1, 2, 0


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _models(kind, vision=VISION, text=TEXT):
    jc, tc = jcfg.Config(MODEL), tcfg.Config(MODEL)
    if kind == "crossgen":
        return (JM.XVLMForCrossGeneration(jcfg.VisionConfig.create(**vision),
                                          jcfg.TextConfig.create(**text), jc),
                TM.XVLMForCrossGeneration(tcfg.VisionConfig.create(**vision),
                                          tcfg.TextConfig.create(**text), tc))
    return (JM.TextTranslater(jcfg.TextConfig.create(**text), jc),
            TM.TextTranslater(tcfg.TextConfig.create(**text), tc))


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(2)
    image = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
    src_ids = rng.integers(3, 40, (2, 6))
    src_atts = np.ones((2, 6), np.int32)
    src_atts[1, 4:] = 0
    tgt_ids = rng.integers(3, 55, (2, 7))
    tgt_ids[:, 0] = BOS
    tgt_ids[1, 5:] = PAD
    return image, src_ids, src_atts, tgt_ids, (tgt_ids != PAD).astype(np.int32)


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_numpy(v) for v in tree]
    return tree.numpy()


@pytest.fixture(scope="module", params=["crossgen", "translater"])
def pair(request):
    """Both models over one tree: the port's seeded init (its structure and
    shapes are JAX's init's, test_decoder_config), as numpy for JAX."""
    jm, tm = _models(request.param)
    tp = tm.init(0, device="cpu")
    return request.param, jm, tm, _numpy(tp), tp


def _t(x):
    return torch.from_numpy(np.array(x))


def test_decoder_config(pair):
    kind, jm, tm, _, tp = pair
    for key in ("fusion_layer", "num_hidden_layers", "encoder_width", "vocab_size",
                "hidden_size"):
        assert tm.decoder_cfg[key] == jm.decoder_cfg[key], key
    assert tm.decoder_cfg["vocab_size"] == 55 and tm.decoder_cfg["fusion_layer"] == 0
    assert len(tp["text_decoder"]["layers"]) == 2 and ("vision" in tp) == (kind == "crossgen")
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(1))
    assert jax.tree.structure(shapes) == jax.tree.structure(jax.tree.map(lambda x: 0, _numpy(tp)))
    for want, got in zip(jax.tree.leaves(shapes), jax.tree.leaves(_numpy(tp))):
        assert tuple(want.shape) == got.shape


def test_loss_matches_jax(pair, batch):
    _, jm, tm, jp, tp = pair
    want = jax.jit(lambda p, *b: jm.forward(p, *b))(jp, *batch)
    got = tm.forward(tp, *(_t(x) for x in batch))
    np.testing.assert_allclose(float(got), float(want), atol=1e-4, rtol=0)


@pytest.mark.parametrize("beams", [1, 2])
def test_generate_matches_jax(pair, batch, beams):
    _, jm, tm, jp, tp = pair
    image, src_ids, src_atts = batch[:3]
    kw = dict(bos_id=BOS, eos_id=EOS, pad_id=PAD, max_length=7, min_length=3, num_beams=beams)
    want = jax.jit(lambda p, x, i, a: jm.generate(p, x, i, a, **kw))(jp, image, src_ids, src_atts)
    stats = {}
    got = tm.generate(tp, _t(image), _t(src_ids), _t(src_atts), stats=stats, **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.shape == (2, 7) and int(got.max()) < 55 and stats["decoder_calls"] >= 2


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


@pytest.mark.parametrize("widths", ["matched", "mismatched"])
def test_loader_matches_jax(widths):
    """A 4-layer X-VLM (fusion 2) checkpoint into the 2-layer-decoder
    cross-generation model; with matched widths (vision 32 = text 32) the
    cross K/V copy, else (vision 24) they stay fresh."""
    vision = VISION if widths == "mismatched" else {**VISION, "vision_width": 32,
                                                     "intermediate_size": 64}
    text = TEXT if widths == "mismatched" else {**TEXT, "encoder_width": 32}
    src = TXVLM(tcfg.VisionConfig.create(**vision), tcfg.TextConfig.create(**text),
                tcfg.Config({"embed_dim": 8}))
    sd = TC.xvlm_state_dict_from_params(src.init(7, device="cpu"), fusion_layer=2)
    sd_np = {k: v.numpy() for k, v in sd.items()}
    _, tm = _models("crossgen", vision, text)
    fresh = _numpy(tm.init(1, device="cpu"))
    kw = dict(vision_layers=2, text_layers=4, fusion_layer=2, num_dec_layers=2)
    want = JC.crossgen_params_from_state_dict(sd_np, fresh, **kw)
    got = TC.crossgen_params_from_state_dict(sd, params_from_numpy(fresh, device="cpu"),
                                             device="cpu", **kw)
    _tree_equal(got, want)
    k_got = got["text_decoder"]["layers"][0]["crossattention"]["k"]["kernel"].numpy()
    k_fresh = fresh["text_decoder"]["layers"][0]["crossattention"]["k"]["kernel"]
    assert np.array_equal(k_got, k_fresh) == (widths == "mismatched")
    np.testing.assert_array_equal(got["text_decoder"]["embeddings"]["word"]["embedding"].numpy(),
                                  fresh["text_decoder"]["embeddings"]["word"]["embedding"])
