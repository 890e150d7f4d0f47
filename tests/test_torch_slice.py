"""Port parity for the whole retrieval-evaluation slice against the JAX
package, on the CPU, at atol 1e-4 in f32: the same params (JAX init ->
params_from_numpy) and the same inputs through retrieval_forward, the i2t
(grouped) and t2i (expanded) rerank chunks, and retrieval_scores + itm_eval.

Width 128 and 122 image tokens (44 px / patch 4) put the JAX side on its
fused kernels (interpret mode); 22 candidates x 12 text tokens >= 256 rows
put its grouped rerank on the grouped kernel."""

import jax
import numpy as np
import pytest
import torch

from efficientvlm_tpu import config as jcfg
from efficientvlm_tpu.evaluation import retrieval as JR
from efficientvlm_tpu.models.model_retrieval import XVLMForRetrieval as JModel
from efficientvlm_tpu.models.xvlm import mlp_head_apply as j_mlp_head
from efficientvlm_tpu_torch import config as tcfg
from efficientvlm_tpu_torch.bridge import params_from_numpy
from efficientvlm_tpu_torch.evaluation import retrieval as TR
from efficientvlm_tpu_torch.models.model_retrieval import XVLMForRetrieval as TModel

torch.set_num_threads(1)
ATOL = 1e-4
VISION = dict(vision_width=128, num_attention_heads=2, intermediate_size=256,
              num_hidden_layers=2, image_res=44, patch_size=4)
TEXT = dict(vocab_size=100, hidden_size=128, num_hidden_layers=4, num_attention_heads=2,
            intermediate_size=256, encoder_width=128, fusion_layer=2,
            max_position_embeddings=16, hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0)
T_LEN, S_LEN = 12, 122


@pytest.fixture(scope="module")
def models():
    jm = JModel(jcfg.VisionConfig.create(**VISION), jcfg.TextConfig.create(**TEXT),
                jcfg.Config({"embed_dim": 32}))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = TModel(tcfg.VisionConfig.create(**VISION), tcfg.TextConfig.create(**TEXT),
                tcfg.Config({"embed_dim": 32}))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, tm, tp


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _close(port, ref, atol=ATOL):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), atol=atol, rtol=0)


def _text(rng, n):
    ids = rng.integers(1, 100, (n, T_LEN)).astype(np.int32)
    atts = np.ones((n, T_LEN), np.int32)
    atts[::3, T_LEN - 4:] = 0  # padded texts
    return ids, atts


def test_retrieval_forward_matches_jax(models):
    jm, jp, tm, tp = models
    rng = np.random.default_rng(0)
    image = rng.standard_normal((2, 44, 44, 3)).astype(np.float32)
    ids, atts = _text(rng, 2)

    ie, ia, _ = jm.get_vision_embeds(jp, image, impl="fused")
    te = jm.get_text_embeds(jp, ids, atts, impl="fused")["last_hidden"]
    ref_if, ref_tf = jm.get_features(jp, ie, te)
    cross = jm.get_cross_embeds(jp, ie, ia, text_embeds=te, text_atts=atts, impl="fused")
    ref_itm = j_mlp_head(jp["itm_head"], cross["last_hidden"][:, 0])

    image_feat, text_feat, itm = TR.retrieval_forward(tm, tp, _t(image), _t(ids), _t(atts))
    for port, ref in ((image_feat, ref_if), (text_feat, ref_tf), (itm, ref_itm)):
        _close(port, ref)


@pytest.mark.parametrize("grouped", [True, False], ids=["i2t_grouped", "t2i_expanded"])
def test_itm_rerank_scores_match_jax(models, grouped):
    jm, jp, tm, tp = models
    rng = np.random.default_rng(1)
    rows, k = 2, 22
    img = rng.standard_normal((rows if grouped else rows * k, S_LEN, 128)).astype(np.float32)
    txt = rng.standard_normal((rows * k, T_LEN, 128)).astype(np.float32)
    _, atts = _text(rng, rows * k)
    ref = JR.itm_rerank_scores(jm, jp, img, txt, atts, rows, k, impl="fused")
    out = TR.itm_rerank_scores(tm, tp, _t(img), _t(txt), _t(atts), rows, k)
    assert out.shape == (rows, k)
    _close(out, ref)


def test_retrieval_scores_and_itm_eval_match_jax(models):
    jm, jp, tm, tp = models
    rng = np.random.default_rng(2)
    n_img, per = 4, 6
    n_txt = n_img * per
    image_feats = rng.standard_normal((n_img, S_LEN, 128)).astype(np.float32)
    text_feats = rng.standard_normal((n_txt, T_LEN, 128)).astype(np.float32)
    _, text_atts = _text(rng, n_txt)
    image_embeds = rng.standard_normal((n_img, 32)).astype(np.float32)
    text_embeds = rng.standard_normal((n_txt, 32)).astype(np.float32)
    args = (image_feats, image_embeds, text_feats, text_atts, text_embeds)
    kw = dict(k_test=22, rows_per_call=2)

    ref_i2t, ref_t2i = JR.retrieval_scores(jm, jp, *args, impl="fused", **kw)
    i2t, t2i = TR.retrieval_scores(tm, tp, *args, **kw)
    _close(i2t, ref_i2t)
    _close(t2i, ref_t2i)
    txt2img = np.arange(n_txt) // per
    img2txt = [list(range(i * per, (i + 1) * per)) for i in range(n_img)]
    assert TR.itm_eval(i2t, t2i, txt2img, img2txt) == JR.itm_eval(ref_i2t, ref_t2i,
                                                                   txt2img, img2txt)


def test_encoders_match_jax(models):
    jm, jp, tm, tp = models
    rng = np.random.default_rng(3)
    ids, atts = _text(rng, 5)
    images = [rng.standard_normal((2, 44, 44, 3)).astype(np.float32) for _ in range(2)]
    ref = JR.encode_texts(jm, jp, ids, atts, batch_size=4, impl="fused")
    out = TR.encode_texts(tm, tp, ids, atts, batch_size=4)
    for port, r in zip(out, ref):
        _close(port, r)
    ref = JR.encode_images(jm, jp, images, impl="fused")
    out = TR.encode_images(tm, tp, images)
    for port, r in zip(out, ref):
        _close(port, r)


def test_gated_encoders_match_jax(models):
    """Continuous L0 gates (zs) through every encoder: the ViT gates its FFN
    between fc1 and the activation, BERT after it; continuous gates tell
    the two orders apart."""
    jm, jp, tm, tp = models
    rng = np.random.default_rng(4)
    u = lambda *s: rng.uniform(0.1, 1.0, s).astype(np.float32)
    zs = {"vision_head_z": u(2, 2), "vision_intermediate_z": u(2, 256),
          "vision_head_layer_z": u(2), "text_head_z": u(2, 2),
          "text_intermediate_z": u(2, 256), "cross_head_z": u(2, 2, 2),
          "cross_intermediate_z": u(2, 256)}
    tzs = {k: _t(v) for k, v in zs.items()}
    image = rng.standard_normal((2, 44, 44, 3)).astype(np.float32)
    ids, atts = _text(rng, 2)

    ie, ia, _ = jm.get_vision_embeds(jp, image, zs=zs, impl="fused")
    te = jm.get_text_embeds(jp, ids, atts, zs=zs, impl="fused")["last_hidden"]
    ce = jm.get_cross_embeds(jp, ie, ia, text_embeds=te, text_atts=atts, zs=zs,
                             impl="fused")["last_hidden"]
    tie, tia, _ = tm.get_vision_embeds(tp, _t(image), zs=tzs)
    tte = tm.get_text_embeds(tp, _t(ids), _t(atts), zs=tzs)["last_hidden"]
    tce = tm.get_cross_embeds(tp, tie, tia, text_embeds=tte, text_atts=_t(atts),
                              zs=tzs)["last_hidden"]
    for port, ref in ((tie, ie), (tte, te), (tce, ce)):
        _close(port, ref)


def test_entry_points_refuse_to_fall_back_to_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None resolves to it")
    model = TModel(tcfg.VisionConfig.create(**VISION), tcfg.TextConfig.create(**TEXT))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_numpy({"w": np.zeros(2, np.float32)})
    assert model.init(0, device="cpu")["itm_head"]["fc1"]["kernel"].device.type == "cpu"
