"""Port parity for the generation slice against the JAX package, on the CPU,
in f32: the decoder (cached decode, precomputed cross K/V, position offsets;
logits atol 1e-4), greedy and beam generation (equal token ids), VQA answer
ranking (equal answer ids, probs atol 1e-5) and captioning generate. The JAX
side runs impl="xla" unless a test says otherwise; the port runs its default
impl="fused", whose kernels fall back to nothing: on CPU tensors the
wrappers run their plain versions."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficientvlm_tpu import config as jcfg
from efficientvlm_tpu import generation as JG
from efficientvlm_tpu.models import bert as JB
from efficientvlm_tpu.models import model_generation as JM
from efficientvlm_tpu_torch import config as tcfg
from efficientvlm_tpu_torch import generation as TG
from efficientvlm_tpu_torch.bridge import params_from_numpy
from efficientvlm_tpu_torch.models import bert as TB
from efficientvlm_tpu_torch.models import model_generation as TM
from efficientvlm_tpu_torch.ops import attention as TA
from efficientvlm_tpu_torch.ops import flash_attention as TF
from efficientvlm_tpu_torch.ops import fused_mha as TFM
from efficientvlm_tpu_torch.ops.patch_embed import fused_patch_embed

torch.set_num_threads(1)
TEXT = dict(vocab_size=40, hidden_size=32, num_hidden_layers=4, num_attention_heads=4,
            intermediate_size=64, encoder_width=24, max_position_embeddings=32,
            hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
VISION = dict(vision_width=24, num_attention_heads=4, intermediate_size=48,
              num_hidden_layers=2, image_res=16, patch_size=8)
EOS, PAD = 2, 0
WRAPPERS = (fused_patch_embed, TFM.fused_self_attention, TFM.fused_cross_attention,
            TFM.fused_cross_attention_grouped, TF.flash_attention, TF.flash_attention_grouped)


@pytest.fixture(autouse=True)
def launch_counts_stay_zero():
    """CPU tensors run the plain versions: no wrapper counts a launch."""
    for w in WRAPPERS:
        w.launches = 0
    yield
    assert [w.launches for w in WRAPPERS] == [0] * len(WRAPPERS)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def decoder():
    """A 4-layer decoder (fusion at 2) over 2 encoder rows of 5 states, the
    second with a masked tail, and JAX's uncached logits over 6 tokens."""
    cfg = jcfg.TextConfig.create(**TEXT)
    jp = JB.init_bert(jax.random.PRNGKey(0), cfg, with_mlm_head=True)
    rng = np.random.default_rng(0)
    enc = rng.standard_normal((2, 5, 24)).astype(np.float32)
    atts = np.ones((2, 5), np.int32)
    atts[1, 3:] = 0
    ids = np.array([[1, 7, 3, 11, 5, 9], [1, 9, 4, 6, 8, 12]])
    ref = _logits_j(jp, cfg, ids, enc, atts)
    return cfg, jp, tcfg.TextConfig.create(**TEXT), params_from_numpy(_np(jp), device="cpu"), \
        enc, atts, ids, ref


@functools.partial(jax.jit, static_argnames=("cfg",))
def _jit_logits(jp, cfg, ids, enc, atts, position_offset):
    out = JB.bert_apply(jp, ids, cfg, encoder_hidden=enc, encoder_attention_mask=atts,
                        mode="multi_modal", is_decoder=True, position_offset=position_offset)
    return JB.mlm_head_apply(jp["cls"], out["last_hidden"], cfg)


def _logits_j(jp, cfg, ids, enc, atts, position_offset=0):
    return np.asarray(_jit_logits(jp, _Hashable(cfg), jnp.asarray(ids), jnp.asarray(enc),
                                  jnp.asarray(atts), position_offset))


class _Hashable(jcfg.TextConfig):
    """A config usable as a static jit argument."""

    def __hash__(self):
        return hash(tuple(sorted(self.items())))


def _logits_t(tp, cfg, ids, enc, atts, **kw):
    out = TB.bert_apply(tp, _t(ids), cfg, encoder_hidden=_t(enc),
                        encoder_attention_mask=_t(atts), mode="multi_modal",
                        is_decoder=True, **kw)
    return TB.mlm_head_apply(tp["cls"], out["last_hidden"], cfg), out["cache"]


@pytest.mark.parametrize("impl", ["fused", "plain"])
def test_cached_decode_matches_uncached_and_jax(decoder, impl):
    """Prefill 3 prompt tokens into a cache of 8 rows at index 0, then 3
    single-token steps at position_offset = cur_len: the logits of every
    position equal the uncached full-sequence forward, in the port and in
    JAX."""
    _, _, cfg, tp, enc, atts, ids, ref = decoder
    full, _ = _logits_t(tp, cfg, ids, enc, atts, impl=impl)
    np.testing.assert_allclose(full.numpy(), ref, atol=1e-4, rtol=0)

    cache = TB.init_bert_cache(tp, cfg, 2, 8)
    kv = TB.precompute_cross_kv(tp, cfg, _t(enc))
    logits, cache = _logits_t(tp, cfg, ids[:, :3], enc, atts, cache=cache, cross_kv=kv,
                              impl=impl)
    assert cache[0]["self"]["index"] == 3
    np.testing.assert_allclose(logits.numpy(), ref[:, :3], atol=1e-4, rtol=0)
    for pos in range(3, 6):
        logits, cache = _logits_t(tp, cfg, ids[:, pos:pos + 1], enc, atts, cache=cache,
                                  cross_kv=kv, position_offset=pos, impl=impl)
        np.testing.assert_allclose(logits[:, 0].numpy(), ref[:, pos], atol=1e-4, rtol=0)


@pytest.mark.parametrize("impl", ["fused", "plain"])
def test_precompute_cross_kv_matches_recompute(decoder, impl):
    jcfg_, jp, cfg, tp, enc, atts, ids, ref = decoder
    kv = TB.precompute_cross_kv(tp, cfg, _t(enc))
    assert len(kv) == cfg["num_hidden_layers"] - cfg["fusion_layer"]
    jkv = JB.precompute_cross_kv(jp, jcfg_, jnp.asarray(enc))
    for port, jref in zip(kv, jkv):
        for name in ("k", "v"):
            np.testing.assert_allclose(port[name].numpy(), np.asarray(jref[name]), atol=1e-5)
    pre, _ = _logits_t(tp, cfg, ids, enc, atts, cross_kv=kv, impl=impl)
    plain, _ = _logits_t(tp, cfg, ids, enc, atts, impl=impl)
    np.testing.assert_allclose(pre.numpy(), plain.numpy(), atol=1e-5, rtol=0)
    np.testing.assert_allclose(pre.numpy(), ref, atol=1e-4, rtol=0)


def test_position_offset_is_applied(decoder):
    jcfg_, jp, cfg, tp, enc, atts, _, _ = decoder
    ids = np.array([[1, 7], [1, 9]])
    ref = _logits_j(jp, jcfg_, ids, enc, atts, position_offset=5)
    out, _ = _logits_t(tp, cfg, ids, enc, atts, position_offset=5)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4, rtol=0)
    at_zero, _ = _logits_t(tp, cfg, ids, enc, atts)
    assert np.abs(out.numpy() - at_zero.numpy()).max() > 1e-3


def test_cache_with_grouped_or_precomputed_kv_is_an_error(decoder):
    _, _, cfg, tp, enc, *_ = decoder
    p = tp["layers"][3]["crossattention"]
    cache = TA.init_decode_cache(2, 4, 8, 8)
    kv = TA.project_kv(p, _t(enc), num_heads=4)
    with pytest.raises(ValueError, match="mutually exclusive"):
        TA.multi_head_attention(p, torch.zeros(2, 1, 32), num_heads=4, cache=cache,
                                precomputed_kv=kv)
    with pytest.raises(ValueError, match="mutually exclusive"):
        TA.multi_head_attention(p, torch.zeros(4, 1, 32), _t(enc), num_heads=4, cache=cache,
                                kv_groups=2)


GEN_CASES = {
    # name: (num_beams, repetition_penalty, min_length)
    "greedy": (1, 1.0, 0),
    "greedy_rep_penalty": (1, 1.3, 4),
    "beam2_fast_path": (2, 1.0, 0),
    "beam3_fast_path_min_length": (3, 1.0, 6),
    "beam3_full_vocab_rep_penalty": (3, 1.3, 0),
}


@pytest.mark.parametrize("name", sorted(GEN_CASES))
def test_generate_matches_jax(decoder, name):
    """Tokens equal to JAX's; the beams share the unexpanded encoder rows."""
    beams, penalty, min_len = GEN_CASES[name]
    jcfg_, jp, cfg, tp, enc, atts, *_ = decoder
    prompt, max_len = np.array([[1, 7], [1, 9]]), 10
    kw = dict(max_length=max_len, eos_id=EOS, pad_id=PAD, min_length=min_len,
              repetition_penalty=penalty)
    jfn = JG.make_bert_decode_fn(jp, jcfg_, encoder_hidden=jnp.asarray(enc),
                                 encoder_atts=jnp.asarray(atts))
    jcache = JB.init_bert_cache(jp, jcfg_, 2 * beams, max_len)
    tfn = TG.make_bert_decode_fn(tp, cfg, encoder_hidden=_t(enc), encoder_atts=_t(atts))
    tcache = TB.init_bert_cache(tp, cfg, 2 * beams, max_len)
    stats = {}
    if beams == 1:
        ref, ref_lp = jax.jit(lambda c: JG.generate_no_beam(jfn, c, jnp.asarray(prompt),
                                                            **kw))(jcache)
        out, lp = TG.generate_no_beam(tfn, tcache, _t(prompt), stats=stats, **kw)
        np.testing.assert_allclose(lp.numpy(), np.asarray(ref_lp), atol=1e-4, rtol=0)
    else:
        ref = jax.jit(lambda c: JG.generate_beam(jfn, c, jnp.asarray(prompt), num_beams=beams,
                                                 **kw))(jcache)
        out = TG.generate_beam(tfn, tcache, _t(prompt), num_beams=beams, stats=stats, **kw)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert 1 < stats["decoder_calls"] <= max_len - prompt.shape[1] + 1


def test_sampling_waits_for_the_scst_slice(decoder):
    _, _, cfg, tp, enc, atts, *_ = decoder
    tfn = TG.make_bert_decode_fn(tp, cfg, encoder_hidden=_t(enc), encoder_atts=_t(atts))
    with pytest.raises(NotImplementedError):
        TG.generate_no_beam(tfn, TB.init_bert_cache(tp, cfg, 2, 6), torch.ones(2, 1).long(),
                            max_length=6, eos_id=EOS, pad_id=PAD, do_sample=True)


def test_helpers_match_jax():
    x = np.array([[1.0, 3.0, 3.0, 2.0, 3.0, -1e9, -1e9], [-1e9] * 7], np.float32)
    for k in (3, 5):
        vals, idx = TG.top_k(_t(x), k)
        ref_vals, ref_idx = jax.lax.top_k(jnp.asarray(x), k)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
        np.testing.assert_array_equal(vals.numpy(), np.asarray(ref_vals))
    logits = np.array([[2.0, 1.0, 0.0, -1.0], [0.5, -2.0, 1.5, 0.0]], np.float32)
    toks, valid = np.array([[0, 1, 3], [2, 2, 0]]), np.array([[1.0, 1.0, 0.0]], np.float32)
    np.testing.assert_allclose(
        TG.apply_repetition_penalty(_t(logits), _t(toks), _t(valid), 2.0).numpy(),
        np.asarray(JG.apply_repetition_penalty(logits, toks, valid, 2.0)))
    np.testing.assert_allclose(TG.top_p_filter(_t(logits), 0.7).numpy(),
                               np.asarray(JG.top_p_filter(jnp.asarray(logits), 0.7)))
    rng = np.random.default_rng(3)
    lg = rng.standard_normal((3, 5, 11)).astype(np.float32)
    labels = rng.integers(0, 11, (3, 5))
    labels[1, 3:] = -100
    for red in ("none", "mean"):
        np.testing.assert_allclose(
            TB.lm_loss(_t(lg), _t(labels), reduction=red).numpy(),
            np.asarray(JB.lm_loss(jnp.asarray(lg), jnp.asarray(labels), reduction=red)),
            atol=1e-5)


def _numpy_params(shapes, rng):
    """Params for a JAX init tree's shapes, made with numpy: LayerNorm scales
    near 1, everything else N(0, 0.05)."""
    def leaf(path, s):
        x = rng.standard_normal(s.shape).astype(np.float32)
        return 1.0 + 0.1 * x if path[-1].key == "scale" else 0.05 * x
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _models(kind, text=TEXT, config=None, seed=3):
    """The JAX and the port model, and the same params for both: numpy
    leaves for JAX, params_from_numpy of them for the port."""
    config = config or {}
    jm = getattr(JM, kind)(jcfg.VisionConfig.create(**VISION), jcfg.TextConfig.create(**text),
                           jcfg.Config(config))
    tm = getattr(TM, kind)(tcfg.VisionConfig.create(**VISION), tcfg.TextConfig.create(**text),
                           tcfg.Config(config))
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    jp = _numpy_params(shapes, np.random.default_rng(seed))
    return jm, jp, tm, params_from_numpy(jp, device="cpu"), shapes


@pytest.mark.parametrize("kind", ["XVLMForCaptioning", "XVLMForVQA"])
def test_init_and_bridge_carry_the_jax_tree(kind):
    """The port's init and params_from_numpy give the JAX tree leaf by leaf:
    the MLM head ("cls") and every decoder layer included."""
    jm, jp, tm, tp, shapes = _models(kind, config={"num_dec_layers": 2})
    flat_j = jax.tree_util.tree_flatten_with_path(shapes)[0]
    flat_init = jax.tree_util.tree_flatten_with_path(tm.init(0, device="cpu"))[0]
    flat_bridge = jax.tree_util.tree_flatten_with_path(tp)[0]
    assert any(p[0].key == "text_decoder" and p[1].key == "cls" for p, _ in flat_j)
    for flat in (flat_init, flat_bridge):
        assert [jax.tree_util.keystr(p) for p, _ in flat] == \
            [jax.tree_util.keystr(p) for p, _ in flat_j]
        assert [tuple(x.shape) for _, x in flat] == [tuple(x.shape) for _, x in flat_j]
    for (_, port), (_, ref) in zip(flat_bridge, jax.tree_util.tree_flatten_with_path(jp)[0]):
        np.testing.assert_array_equal(port.numpy(), ref)


@pytest.mark.parametrize("beams", [1, 3], ids=["greedy", "beam3"])
def test_captioning_generate_matches_jax(beams):
    jm, jp, tm, tp, _ = _models("XVLMForCaptioning")
    rng = np.random.default_rng(4)
    image = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
    prompt = np.array([[1, 5, 7], [1, 5, 7]])
    kw = dict(max_length=9, min_length=4, num_beams=beams, eos_id=EOS, pad_id=PAD)
    ref = jax.jit(lambda p, i, pr: jm.generate(p, i, pr, **kw))(jp, image, prompt)
    stats = {}
    out = tm.generate(tp, _t(image), _t(prompt), stats=stats, **kw)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert stats["decoder_calls"] >= 2


def _answers(rng, n, ta, vocab, first_tokens):
    """n answers of ta tokens ([CLS] + words + pad) whose first word comes
    from a few tokens only: equal first-token probabilities are the rule."""
    ids = rng.integers(3, vocab, (n, ta))
    ids[:, 0] = 1
    ids[:, 1] = rng.choice(first_tokens, n)
    atts = np.ones((n, ta), np.int32)
    atts[::3, ta - 1] = 0
    ids[::3, ta - 1] = PAD
    return ids, atts


def test_vqa_forward_eval_matches_jax():
    jm, jp, tm, tp, _ = _models("XVLMForVQA", config={"pad_token_id": PAD, "num_dec_layers": 2})
    assert tm.decoder_cfg == dict(jm.decoder_cfg)
    rng = np.random.default_rng(5)
    image = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
    q_ids = rng.integers(3, 40, (2, 6))
    q_atts = np.ones((2, 6), np.int32)
    q_atts[1, 4:] = 0
    a_ids, a_atts = _answers(rng, 12, 4, 40, [5, 9, 17])
    ref_ids, ref_probs = jax.jit(functools.partial(jm.forward_eval, k=5))(
        jp, image, q_ids, q_atts, a_ids, a_atts)
    ids, probs = tm.forward_eval(tp, _t(image), _t(q_ids), _t(q_atts), _t(a_ids), _t(a_atts),
                                 k=5)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ref_ids))
    np.testing.assert_allclose(probs.numpy(), np.asarray(ref_probs), atol=1e-5, rtol=0)


def test_rank_answer_matches_jax_on_its_grouped_kernel():
    """Question length 120 and k * answer length = 256 put the JAX scoring
    call's cross-attention on flash_attention_grouped (Pallas)."""
    text = {**TEXT, "hidden_size": 64, "num_attention_heads": 2, "encoder_width": 24}
    jm, jp, tm, tp, _ = _models("XVLMForVQA", text=text,
                                config={"pad_token_id": PAD, "num_dec_layers": 2})
    rng = np.random.default_rng(6)
    k, ta = 64, 4
    states = rng.standard_normal((2, 120, 64)).astype(np.float32)
    q_atts = np.ones((2, 120), np.int32)
    q_atts[1, 90:] = 0
    a_ids, a_atts = _answers(rng, 80, ta, 40, [5, 9, 17, 23])
    args = (jnp.asarray(states), jnp.asarray(q_atts), jnp.asarray(a_ids), jnp.asarray(a_atts))
    rank = jax.jit(lambda p, *a: jm.rank_answer(p, *a, k, impl="fused"))
    assert "pallas_call" in str(jax.make_jaxpr(rank)(jp, *args))
    ref_ids, ref_probs = rank(jp, *args)
    ids, probs = tm.rank_answer(tp, _t(states), _t(q_atts), _t(a_ids), _t(a_atts), k)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ref_ids))
    np.testing.assert_allclose(probs.numpy(), np.asarray(ref_probs), atol=1e-5, rtol=0)


def test_generation_models_refuse_to_fall_back_to_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None resolves to it")
    for kind in ("XVLMForCaptioning", "XVLMForVQA"):
        model = getattr(TM, kind)(tcfg.VisionConfig.create(**VISION),
                                  tcfg.TextConfig.create(**TEXT))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            model.init(0)
        assert model.init(0, device="cpu")["text_decoder"]["cls"]["decoder"]["kernel"] \
            .device.type == "cpu"
