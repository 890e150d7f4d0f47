"""The port's CUDA kernels against their plain versions, on the card, in
bf16, at small shapes; each wrapper counts one launch per call. The device
kernels under the attention sublayers, the FFN sublayer and the patch
embedding (gemm_bias and its GELU, gemm_ln, attn_core, attn_wgmma)
are also held on their own at the main path's shapes and ragged edges, and
the shape rules that keep a shape on an older route are checked on both
sides by the kernels the profiler sees.
Imports no jax, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Without a CUDA device every test skips."""

import numpy as np
import pytest
import torch

from efficientvlm_tpu_torch.kernels import bindings as K
from efficientvlm_tpu_torch.ops import attention as A
from efficientvlm_tpu_torch.ops import flash_attention as FA
from efficientvlm_tpu_torch.ops import fused_ffn as FF
from efficientvlm_tpu_torch.ops import fused_mha as F
from efficientvlm_tpu_torch.ops.patch_embed import fused_patch_embed, patch_embed_plain

pytestmark = pytest.mark.cuda


@pytest.fixture
def rnd():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator(device="cuda")
    g.manual_seed(0)

    def r(*shape, std=1.0, mean=0.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=g, device="cuda") * std + mean).to(dtype)
    return r


def _attn(r, d, a, de=None):
    de = de or d
    w = lambda i, o: {"kernel": r(i, o, std=i ** -0.5), "bias": r(o, std=0.1)}
    return {"q": w(d, a), "k": w(de, a), "v": w(de, a), "out": w(a, d)}


def _mask(b, s):
    m = torch.ones(b, s, dtype=torch.int32, device="cuda")
    m[1:, s - s // 3:] = 0
    return m


def _close(out, ref):
    out, ref = out.float(), ref.float()
    torch.cuda.synchronize()
    assert out.shape == ref.shape
    assert torch.isfinite(out).all()
    # 4 bf16 ulps at the output's largest magnitude (see chip_smoke.phase_kernels)
    assert (out - ref).abs().max().item() <= 4 * 2 ** -8 * ref.abs().max().item()


def _agree(wrapper, run, plain):
    before = wrapper.launches
    out = run()
    assert wrapper.launches == before + 1
    _close(out, plain())


def test_patch_embed(rnd):
    d, p = 128, 16
    pp = {"patch_embed": {"kernel": rnd(p, p, 3, d, std=(p * p * 3) ** -0.5)},
          "class_embedding": rnd(d), "pos_embed": {"embedding": rnd(5, d)},
          "pre_ln": {"scale": rnd(d, std=0.1, mean=1.0), "bias": rnd(d, std=0.1)}}
    img = rnd(3, 32, 32, 3)
    _agree(fused_patch_embed, lambda: fused_patch_embed(pp, img, patch_size=p),
           lambda: patch_embed_plain(pp, img, patch_size=p))


@pytest.mark.parametrize("a,heads", [(128, 2), (64, 1)], ids=["square", "rect"])
def test_self_attention(rnd, a, heads):
    prm, x, mask = _attn(rnd, 128, a), rnd(3, 37, 128), _mask(3, 37)
    hz = torch.rand(heads, device="cuda") + 0.2
    kb = F._key_bias(3, 37, mask, None, x.device)
    _agree(F.fused_self_attention,
           lambda: F.fused_self_attention(prm, x, num_heads=heads, mask=mask, head_z=hz),
           lambda: F.self_attention_plain(prm, x, kb, hz, heads))


def test_cross_attention(rnd):
    prm, x, enc, mask = _attn(rnd, 128, 128, 192), rnd(3, 9, 128), rnd(3, 70, 192), _mask(3, 70)
    hz = torch.rand(2, device="cuda") + 0.2
    kb = F._key_bias(3, 70, mask, None, x.device)
    _agree(F.fused_cross_attention,
           lambda: F.fused_cross_attention(prm, x, enc, num_heads=2, mask=mask, head_z=hz),
           lambda: F.cross_attention_plain(prm, x, enc, kb, hz, 2))


@pytest.mark.parametrize("with_ln", [True, False], ids=["ln", "no_ln"])
def test_grouped_cross_attention(rnd, with_ln):
    prm, x, enc, mask = _attn(rnd, 128, 128, 192), rnd(6, 9, 128), rnd(2, 70, 192), _mask(2, 70)
    hz = torch.rand(2, device="cuda") + 0.2
    ln = {"scale": rnd(128, mean=1.0, std=0.1, dtype=torch.float32),
          "bias": rnd(128, std=0.1, dtype=torch.float32)} if with_ln else None
    kb = F._key_bias(2, 70, mask, None, x.device)
    _agree(F.fused_cross_attention_grouped,
           lambda: F.fused_cross_attention_grouped(prm, x, enc, num_heads=2, kv_groups=3,
                                                   mask=mask, head_z=hz, ln_params=ln),
           lambda: F.cross_attention_grouped_plain(prm, x, enc, kb, hz, 2, 3, ln))


GEMM = {
    # name: (M, N, K, out_f32, with bias, row_add period or 0)
    "vit_qkv_fused_n2304": (18464, 2304, 768, False, True, 0),
    "vit_out_n768": (18464, 768, 768, False, True, 0),
    "fusion_q_m1280": (1280, 768, 768, False, True, 0),
    "rect_a512_n512": (18464, 512, 768, False, True, 0),
    "rect_a512_k512": (1280, 768, 512, False, True, 0),
    "five_heads_n320_no_bias": (1280, 320, 768, False, False, 0),
    "five_heads_k320": (18464, 768, 320, False, True, 0),
    "patch_f32_row_add_576": (18464, 768, 768, True, True, 576),
}


@pytest.mark.parametrize("name", sorted(GEMM))
def test_gemm_bias(rnd, name):
    m, n, k, out_f32, with_bias, period = GEMM[name]
    a, b = rnd(m, k), rnd(k, n, std=k ** -0.5)
    bias = rnd(n, std=0.1, dtype=torch.float32) if with_bias else None
    row_add = rnd(period, n, dtype=torch.float32) if period else None
    out = K.gemm_bias(a, b, bias, row_add, out_f32=out_f32)
    assert out.dtype == (torch.float32 if out_f32 else torch.bfloat16)
    _close(out, F.gemm_bias_plain(a, b, bias, row_add, out_f32))


ATTN = {
    # name: (batch, Tq, S, heads, dh); row 1 of "last_tile_only" sees only
    # the keys of the last 64-key tile
    "vit_t577_dh64": (2, 577, 577, 4, 64),
    "fusion_tq40_s577": (4, 40, 577, 4, 64),
    "grouped_tq10240_s577": (2, 10240, 577, 2, 64),
    "vqa_vit_t901_dh128": (2, 901, 901, 2, 128),
    "question_t25_dh32": (4, 25, 25, 4, 32),
    "decode_tq1_s40": (3, 1, 40, 4, 64),
    "last_tile_only_s577": (2, 40, 577, 2, 64),
    "last_tile_only_s901_dh128": (2, 128, 901, 2, 128),
}


@pytest.mark.parametrize("name", sorted(ATTN))
def test_attn_core(rnd, name):
    b, tq, s, h, dh = ATTN[name]
    q, k, v = rnd(b * tq, h * dh), rnd(b * s, h * dh), rnd(b * s, h * dh)
    mask = _mask(b, s)
    if name.startswith("last_tile_only"):
        mask[1] = 0
        mask[1, (s - 1) // 64 * 64:] = 1
    kb = F._key_bias(b, s, mask, None, q.device)
    hz = torch.rand(h, device="cuda") + 0.2
    _close(K.attn_core(q, k, v, kb, hz, batch=b, tq=tq, s=s),
           F.attn_core_plain(q, k, v, kb, hz, batch=b, tq=tq, s=s))


GEMM_LN = {
    # name: (M, N, K, residual, row_add period or 0, (group, stride, offset)
    # or None, vector dtype); M ragged against the 128-row tile, and with a
    # row mapping the images' boundaries fall inside row tiles
    "d768_cluster6_residual": (1000, 768, 768, True, 0, None, torch.float32),
    "d768_patch_rows_196_pos": (3 * 196, 768, 768, False, 196, (196, 197, 1), torch.bfloat16),
    "d768_residual_and_rows": (700, 768, 512, True, 100, (100, 103, 2), torch.bfloat16),
    "d128_cluster1_residual": (300, 128, 192, True, 0, None, torch.bfloat16),
    "d128_cluster1_pos_mapping": (50, 128, 768, False, 25, (25, 26, 1), torch.float32),
    "d1024_cluster8_plain": (333, 1024, 256, False, 0, None, torch.float32),
}


@pytest.mark.parametrize("name", sorted(GEMM_LN))
def test_gemm_ln(rnd, name):
    m, n, k, with_res, period, mapping, vdt = GEMM_LN[name]
    a, b = rnd(m, k), rnd(k, n, std=k ** -0.5)
    vec = dict(bias=rnd(n, std=0.1, dtype=vdt),
               row_add=rnd(period, n, std=0.5, dtype=vdt) if period else None,
               residual=rnd(m, n) if with_res else None)
    gamma, beta = rnd(n, mean=1.0, std=0.1, dtype=vdt), rnd(n, std=0.1, dtype=vdt)
    kw = {}
    if mapping:
        group, stride, offset = mapping
        rows = (m - 1) // group * stride + offset + group
        kw = dict(group=group, out_group_stride=stride, out_offset=offset)
        out, ref = (torch.zeros(rows, n, dtype=torch.bfloat16, device="cuda") for _ in range(2))
    else:
        out = ref = None
    got = K.gemm_ln(a, b, gamma, beta, 1e-5, out=out, **vec, **kw)
    _close(got, F.gemm_ln_plain(a, b, gamma, beta, 1e-5, out=ref, **vec, **kw))


def test_gemm_ln_widths_in_any_order(rnd):
    """Each width launches with its own cluster's shared memory, whatever
    width ran before it in the process: 1024 (8 blocks), 768, then 1024."""
    for n in (1024, 768, 1024):
        a, b = rnd(300, 256), rnd(256, n, std=256 ** -0.5)
        gamma, beta, res = rnd(n, mean=1.0, std=0.1), rnd(n, std=0.1), rnd(300, n)
        _close(K.gemm_ln(a, b, gamma, beta, 1e-5, residual=res),
               F.gemm_ln_plain(a, b, gamma, beta, 1e-5, residual=res))


def _kernel_names(fn):
    """Names of the device kernels fn launches (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.key for e in prof.key_averages() if e.device_type.name == "CUDA"
            for _ in range(e.count)]


@pytest.mark.parametrize("d", [768, 200], ids=["d768_cluster_epilogue", "d200_separate_ln"])
def test_grouped_ln_route_follows_the_width_rule(rnd, d):
    """D a multiple of 128 (up to 1024) normalises in gemm_ln's epilogue:
    four device launches (Q, K/V, core, output). Other widths keep gemm_bias
    into f32 + residual_layernorm, and never take gemm_ln. The key bias is
    the f32 [Bk, S] one models/bert.py passes (a 0/1 mask would add the
    launches that turn it into one)."""
    prm, x, enc = _attn(rnd, d, 128, 192), rnd(6, 9, d), rnd(2, 70, 192)
    kb = F._key_bias(2, 70, _mask(2, 70), None, x.device)
    ln = {"scale": rnd(d, mean=1.0, std=0.1), "bias": rnd(d, std=0.1)}
    run = lambda: F.fused_cross_attention_grouped(prm, x, enc, num_heads=2, kv_groups=3,
                                                  key_bias=kb, ln_params=ln)
    names = _kernel_names(run)
    fused = K.gemm_ln_fits(d)
    assert fused == (d == 768)
    assert any("gemm_ln_kernel" in n for n in names) == fused
    assert any("residual_layernorm" in n for n in names) == (not fused)
    assert any("attn_wgmma_kernel" in n for n in names)
    if fused:
        assert len(names) == 4, names
    _close(run(), F.cross_attention_grouped_plain(prm, x, enc, kb, torch.ones(2, device="cuda"),
                                                  2, 3, ln))


@pytest.mark.parametrize("res,p,d", [(384, 16, 768), (224, 16, 768), (32, 8, 128),
                                     (48, 16, 200)],
                         ids=["384_p16_576_patches", "224_p16_196_patches", "32_p8",
                              "d200_im2col_route"])
def test_patch_embed_one_launch(rnd, res, p, d):
    """The gather + gemm_ln route in one device launch, CLS rows included;
    a width outside gemm_ln's rule takes the im2col route."""
    n = (res // p) ** 2
    pp = {"patch_embed": {"kernel": rnd(p, p, 3, d, std=(p * p * 3) ** -0.5),
                          "bias": rnd(d, std=0.1)},
          "class_embedding": rnd(d, std=0.5), "pos_embed": {"embedding": rnd(n + 1, d, std=0.5)},
          "pre_ln": {"scale": rnd(d, std=0.1, mean=1.0), "bias": rnd(d, std=0.1)}}
    img = rnd(3, res, res, 3)
    run = lambda: fused_patch_embed(pp, img, patch_size=p)
    names = _kernel_names(run)
    if K.gemm_ln_fits(d):
        assert len(names) == 1 and "gemm_ln_kernel" in names[0], names
    else:
        assert any("residual_layernorm" in n for n in names)
    _agree(fused_patch_embed, run, lambda: patch_embed_plain(pp, img, patch_size=p))


def test_patch_embed_refuses_a_patch_the_gather_cannot_read(rnd):
    pp = {"patch_embed": {"kernel": rnd(4, 4, 3, 128)}, "class_embedding": rnd(128),
          "pos_embed": {"embedding": rnd(17, 128)},
          "pre_ln": {"scale": rnd(128), "bias": rnd(128)}}
    assert not K.patch_gather_fits(4)
    with pytest.raises(ValueError, match="patch 4"):
        fused_patch_embed(pp, rnd(2, 16, 16, 3), patch_size=4)


WGMMA = {
    # name: (batch, Tq, S, heads, key bias: from a 0/1 mask, an arbitrary
    # f32 bias over the mask's, or none); the i2t rerank folds 256 texts x 40
    # tokens into 10,240 query rows per image
    "rerank_tq10240_s577_mask": (4, 10240, 577, 12, "mask"),
    "rerank_tq10240_s577_key_bias": (4, 10240, 577, 12, "key_bias"),
    "ragged_s145_key_bias": (3, 200, 145, 2, "key_bias"),
    "s901_more_tiles_than_stages": (2, 300, 901, 2, "mask"),
    "rect_a512_h8": (4, 1000, 577, 8, "mask"),
    "no_bias_tq1": (5, 1, 70, 2, None),
    "last_tile_only_s577": (2, 129, 577, 2, "last_tile_only"),
}


@pytest.mark.parametrize("name", sorted(WGMMA))
def test_attn_wgmma(rnd, name):
    b, tq, s, h, terms = WGMMA[name]
    q, k, v = rnd(b * tq, h * 64), rnd(b * s, h * 64), rnd(b * s, h * 64)
    mask = _mask(b, s)
    if terms == "last_tile_only":  # row 1 sees only the keys of the last 128-key tile
        mask[1] = 0
        mask[1, (s - 1) // 128 * 128:] = 1
    hz = torch.rand(h, device="cuda") + 0.2
    kb = F._key_bias(b, s, mask if terms else None, None, q.device)
    if terms == "key_bias":
        kb = kb + rnd(b, s, dtype=torch.float32)
    gates = hz.to(torch.bfloat16) if terms == "mask" else hz  # read as stored
    got = K.attn_wgmma(q, k, v, kb, gates, batch=b, tq=tq, s=s)
    _close(got, F.attn_core_plain(q, k, v, kb, gates.float(), batch=b, tq=tq, s=s))


@pytest.mark.parametrize("dh", [64, 32], ids=["dh64_wgmma", "dh32_attn_core"])
def test_grouped_core_follows_the_head_dim_rule(rnd, dh):
    """The grouped sublayer takes the wgmma core at head dim 64 only."""
    h = 128 // dh
    prm, x, enc, mask = _attn(rnd, 128, 128, 192), rnd(6, 9, 128), rnd(2, 70, 192), _mask(2, 70)
    hz = torch.rand(h, device="cuda") + 0.2
    run = lambda: F.fused_cross_attention_grouped(prm, x, enc, num_heads=h, kv_groups=3,
                                                  mask=mask, head_z=hz)
    names = _kernel_names(run)
    assert K.wgmma_core_fits(dh, True) == (dh == 64)
    assert any("attn_wgmma_kernel" in n for n in names) == (dh == 64)
    assert any("attn_core_kernel" in n for n in names) == (dh != 64)
    kb = F._key_bias(2, 70, mask, None, x.device)
    _close(run(), F.cross_attention_grouped_plain(prm, x, enc, kb, hz, h, 3))


def _bank_case(rnd, b, tq, n, s, d, a, heads):
    """A cross sublayer's params, queries [b, tq, d], n images [n, s, d],
    their K/V bank and per-row image indices with repeats (int32 [b])."""
    prm, x, enc = _attn(rnd, d, a), rnd(b, tq, d), rnd(n, s, d)
    bank = F.project_kv_rows(prm, enc)
    g = torch.Generator(device="cuda")
    g.manual_seed(1)
    rows = torch.randint(0, n, (b,), generator=g, device="cuda", dtype=torch.int32)
    rows[-1] = rows[0]
    hz = torch.rand(heads, device="cuda") + 0.2
    return prm, x, enc, bank, rows, hz


def test_cross_attention_bank(rnd):
    prm, x, enc, bank, rows, hz = _bank_case(rnd, 6, 9, 3, 70, 128, 128, 2)
    mask = _mask(6, 70)
    kb = F._key_bias(6, 70, mask, None, x.device)
    _agree(F.fused_cross_attention_bank,
           lambda: F.fused_cross_attention_bank(prm, x, bank["k"], bank["v"], rows, num_heads=2,
                                                mask=mask, head_z=hz),
           lambda: F.cross_attention_bank_plain(prm, x, bank["k"], bank["v"], rows, kb, hz, 2))


@pytest.mark.parametrize("a,heads", [(768, 12), (320, 5)], ids=["a768_h12", "a320_h5"])
def test_cross_attention_bank_equals_gathered_rows(rnd, a, heads):
    """At the t2i rerank's shapes (40 text tokens, 577 image tokens, width
    768; a pruned width of 5 heads) the bank form is bit-equal to #3 over
    the gathered image rows: the same projections, the same core."""
    prm, x, enc, bank, rows, hz = _bank_case(rnd, 48, 40, 8, 577, 768, a, heads)
    kb = torch.zeros(48, 577, device="cuda")
    out = F.fused_cross_attention_bank(prm, x, bank["k"], bank["v"], rows, num_heads=heads,
                                       key_bias=kb, head_z=hz)
    ref = F.fused_cross_attention(prm, x, enc[rows.long()], num_heads=heads, key_bias=kb,
                                  head_z=hz)
    torch.cuda.synchronize()
    assert torch.equal(out, ref)
    assert torch.equal(bank["k"][rows.long()].reshape(-1, a),
                       K.gemm_bias(enc[rows.long()].reshape(-1, 768),
                                   prm["k"]["kernel"], prm["k"]["bias"]))


def test_attention_bank_refuses_bad_rows(rnd):
    """The binding refuses kv_rows of another dtype, shape or device without
    reading them; a row outside the bank reads nothing: its output row is
    NaN and every other row is what in-range rows give."""
    prm, x, enc, bank, rows, hz = _bank_case(rnd, 4, 9, 3, 70, 128, 128, 2)
    kb = torch.zeros(4, 70, device="cuda")
    run = lambda r: K.fused_attention_bank(  # noqa: E731
        x.reshape(-1, 128), bank["k"].reshape(-1, 128), bank["v"].reshape(-1, 128), r,
        F._weights(prm, ("q", "out")), kb, hz, heads=2, batch=4, tq=9, s=70)
    with pytest.raises(TypeError, match="int32"):
        run(rows.long())
    with pytest.raises(ValueError, match="4 rows"):
        run(rows[:3].clone())
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        run(rows.cpu())
    good = run(torch.tensor([0, 1, 2, 2], dtype=torch.int32, device="cuda")).reshape(4, 9, 128)
    bad = run(torch.tensor([0, 3, 2, -1], dtype=torch.int32, device="cuda")).reshape(4, 9, 128)
    torch.cuda.synchronize()
    assert bad[[1, 3]].isnan().all()
    assert torch.equal(bad[[0, 2]], good[[0, 2]])


# The first 16 hex digits of sha256 over attn_core's output bits on
# _attn_core_inputs, as the unindexed core computed them before it had an
# indexed form (H100 80GB HBM3)
ATTN_CORE_DIGESTS = {"vit_b2_t577": "e6de0c060209a36b", "fusion_b4_tq40_s577": "ecdbad0b0a3e0a8e"}


def _attn_core_digest(b, tq, s, h):
    """attn_core's output digest on inputs drawn on the CPU from a seeded
    generator (the same bits on any card), at heads of 64."""
    import hashlib

    g = torch.Generator().manual_seed(1000 * b + tq)
    r = lambda *shape: torch.randn(shape, generator=g).to(torch.bfloat16).cuda()  # noqa: E731
    q, k, v = r(b * tq, h * 64), r(b * s, h * 64), r(b * s, h * 64)
    kb = F._key_bias(b, s, _mask(b, s), None, q.device)
    hz = (torch.rand(h, generator=g) + 0.2).cuda()
    out = K.attn_core(q, k, v, kb, hz, batch=b, tq=tq, s=s)
    return hashlib.sha256(out.view(torch.int16).cpu().numpy().tobytes()).hexdigest()[:16]


@pytest.mark.parametrize("b,tq,s,h", [(2, 577, 577, 12), (4, 40, 577, 12)],
                         ids=["vit_b2_t577", "fusion_b4_tq40_s577"])
def test_attn_core_unindexed_form_is_unchanged(rnd, request, b, tq, s, h):
    """attn_core without kv_rows gives the bits it gave before the indexed
    form was added, at the ViT's and the fusion layers' shapes."""
    case = request.node.callspec.id
    assert _attn_core_digest(b, tq, s, h) == ATTN_CORE_DIGESTS[case]


def test_misaligned_operands_raise(rnd):
    """TMA needs 16-byte aligned operands: the bindings refuse others."""
    buf = rnd(64 * 128 + 1)
    a = buf[1:].view(64, 128)  # contiguous, 2 bytes off
    with pytest.raises(ValueError, match="16-byte aligned"):
        K.gemm_bias(a, rnd(128, 64))
    with pytest.raises(ValueError, match="16-byte aligned"):
        K.attn_core(a, rnd(64, 128), rnd(64, 128), torch.zeros(1, 64, device="cuda"),
                    torch.ones(2, device="cuda"), batch=1, tq=64, s=64)


def _heads_view(r, b, t, h, dh, std=1.0):
    """[B,H,T,dh] as the projection gives it: a view of [B,T,H*dh]."""
    return r(b, t, h * dh, std=std).view(b, t, h, dh).transpose(1, 2)


def _flash_bias(kind, b, tq, tk):
    if kind == "vector":
        return A.make_attention_bias(_mask(b, tk))
    if kind == "vector_broadcast":
        return A.make_attention_bias(_mask(1, tk))
    if kind == "matrix":
        return A.causal_bias(tq, tk, device="cuda") + A.make_attention_bias(_mask(b, tk))
    if kind == "matrix_broadcast":
        return A.causal_bias(tq, tk, offset=tk - tq, device="cuda")
    if kind == "all_masked_split":  # the whole first split of every row masked
        m = torch.ones(b, tk, dtype=torch.int32, device="cuda")
        m[:, :FA.split_keys(b * 2, tk)] = 0
        return A.make_attention_bias(m)
    if kind == "last_split_only":  # row 1 sees only the last key, in the ragged last split
        m = _mask(b, tk)
        m[1] = 0
        m[1, tk - 1] = 1
        return A.make_attention_bias(m)
    raise ValueError(kind)


FLASH = {
    # name: (B, H, Tq, Tk, dh, bias); q is the projection's strided view,
    # unscaled, with scale = dh ** -0.5
    "key_vector_masked_tail": (3, 2, 37, 70, 64, "vector"),
    "matrix_causal_padding": (3, 2, 6, 6, 64, "matrix"),
    "decode_tq1_partly_filled_cache": (6, 2, 1, 20, 64, "decode"),
    "prefill_tq4_cache20": (6, 2, 4, 20, 32, "decode"),
    "tq1_over_image_keys": (2, 2, 1, 145, 128, "vector"),
    # split-KV: 145 keys in a split of 128 and a ragged one of 17
    "split_ragged_last_dh32": (2, 2, 1, 145, 32, "vector"),
    "split_ragged_last_dh64": (2, 3, 1, 145, 64, "vector"),
    "split_all_masked_split": (2, 2, 1, 145, 64, "all_masked_split"),
    "split_last_split_only": (2, 2, 1, 145, 64, "last_split_only"),
    "split_tq4_matrix_broadcast": (2, 2, 4, 145, 64, "matrix_broadcast"),
    # small problems: 9 and 15 (b, h) pairs, not a multiple of 4 warps a block
    "small_9_pairs_vector_broadcast": (3, 3, 1, 25, 64, "vector_broadcast"),
    "small_15_pairs_matrix_dh128": (5, 3, 6, 6, 128, "matrix"),
    "small_matrix_broadcast_dh32": (3, 5, 6, 6, 32, "matrix_broadcast"),
    # enough units that every warp walks several of them
    "many_units_matrix": (512, 12, 6, 6, 64, "matrix"),
    "many_units_split": (64, 12, 1, 577, 64, "vector"),
}


@pytest.mark.parametrize("name", sorted(FLASH))
def test_flash_attention(rnd, name):
    b, h, tq, tk, dh, kind = FLASH[name]
    q, k, v = _heads_view(rnd, b, tq, h, dh), rnd(b, h, tk, dh), rnd(b, h, tk, dh)
    if kind == "decode":  # 7 of the cache's slots written, the rest zero and masked
        bias = A.decode_bias(tk, 7 - tq, q_len=tq, device="cuda")
        k[:, :, 7:] = 0
        v[:, :, 7:] = 0
    else:
        bias = _flash_bias(kind, b, tq, tk)
    scale = dh ** -0.5
    if "split" in name:  # the case runs the split-KV path
        assert FA.split_keys(b * h * -(-tq // 16), tk) < tk
    _agree(FA.flash_attention, lambda: FA.flash_attention(q, k, v, bias=bias, scale=scale),
           lambda: FA.flash_attention_plain(q, k, v, bias, scale))
    out = FA.flash_attention(q, k, v, bias=bias, scale=scale)
    assert out.transpose(1, 2).is_contiguous()  # merging the heads is a view


def test_flash_attention_splits_reset_their_tickets(rnd):
    """Three launches through the split path give one result, and the
    kernel leaves every ticket of the cached buffer at 0."""
    q, k, v = _heads_view(rnd, 4, 1, 12, 64), rnd(4, 12, 577, 64), rnd(4, 12, 577, 64)
    bias = A.make_attention_bias(_mask(4, 577))
    assert FA.split_keys(4 * 12, 577) < 577
    outs = [FA.flash_attention(q, k, v, bias=bias, scale=0.125) for _ in range(3)]
    torch.cuda.synchronize()
    assert all(torch.equal(outs[0], o) for o in outs[1:])
    assert int(K._WORKSPACE[(q.device.index, K._stream(q))][1].abs().sum()) == 0


def test_flash_attention_splits_on_two_streams(rnd):
    """Split launches queued on two streams at once each merge through the
    tickets and workspace of their own stream, and agree with the plain
    version."""
    shapes = [(16, 12, 577), (4, 12, 577)]
    runs = []
    for b, h, tk in shapes:
        q, k, v = _heads_view(rnd, b, 1, h, 64), rnd(b, h, tk, 64), rnd(b, h, tk, 64)
        bias = A.make_attention_bias(_mask(b, tk))
        assert FA.split_keys(b * h, tk) < tk
        runs.append((q, k, v, bias))
    streams = [torch.cuda.Stream() for _ in shapes]
    torch.cuda.synchronize()
    outs = [[] for _ in shapes]
    for _ in range(8):  # interleaved, so that the two streams' launches overlap
        for (q, k, v, bias), st, out in zip(runs, streams, outs):
            with torch.cuda.stream(st):
                out.append(FA.flash_attention(q, k, v, bias=bias, scale=0.125))
    torch.cuda.synchronize()
    for (q, k, v, bias), st, out in zip(runs, streams, outs):
        for o in out:
            _close(o, FA.flash_attention_plain(q, k, v, bias, 0.125))
        assert int(K._WORKSPACE[(q.device.index, st.cuda_stream)][1].abs().sum()) == 0


@pytest.mark.parametrize("bk,g,tq,s,dh", [(4, 3, 1, 145, 64), (2, 128, 6, 25, 64),
                                          (2, 3, 4, 70, 64), (3, 3, 1, 577, 32),
                                          (2, 3, 4, 145, 128), (3, 128, 6, 25, 32),
                                          (64, 128, 6, 25, 64)],
                         ids=["g3_tq1_split", "g128_tq6", "g3_tq4", "g3_s577_dh32",
                              "g3_tq4_split_dh128", "g128_tq6_dh32", "g128_many_units"])
def test_flash_attention_grouped(rnd, bk, g, tq, s, dh):
    h = 2
    q, k, v = _heads_view(rnd, bk * g, tq, h, dh), rnd(bk, h, s, dh), rnd(bk, h, s, dh)
    for bias in (A.make_attention_bias(_mask(bk, s)), A.make_attention_bias(_mask(1, s))):
        _agree(FA.flash_attention_grouped,
               lambda: FA.flash_attention_grouped(q, k, v, kv_groups=g, bias=bias,
                                                  scale=dh ** -0.5),
               lambda: FA.flash_attention_grouped_plain(q, k, v, g, bias, dh ** -0.5))


def test_flash_attention_refuses_bad_operands(rnd):
    q, k = rnd(2, 2, 3, 64), rnd(2, 2, 9, 64)
    buf = rnd(2 * 2 * 3 * 64 + 1)
    with pytest.raises(ValueError, match="16-byte aligned"):  # 2 bytes off
        FA.flash_attention(buf[1:].view(2, 2, 3, 64), k, k)
    odd = rnd(2, 3, 2 * 64 + 4)[..., :128].view(2, 3, 2, 64).transpose(1, 2)
    with pytest.raises(ValueError, match="multiples of 8"):  # a row stride of 132
        FA.flash_attention(odd, k, k)
    with pytest.raises(ValueError, match="contiguous columns"):
        FA.flash_attention(rnd(2, 2, 64, 3).transpose(2, 3), k, k)
    with pytest.raises(ValueError, match="flash attention: q"):  # a wrong head dim
        FA.flash_attention(q, rnd(2, 2, 9, 32), rnd(2, 2, 9, 32))
    with pytest.raises(TypeError, match="float32"):
        FA.flash_attention(q, k, k, bias=torch.zeros(2, 1, 1, 9, device="cuda",
                                                     dtype=torch.bfloat16))


def test_cuda_tensors_never_fall_back(rnd):
    prm, x = _attn(rnd, 128, 128), rnd(2, 5, 128).float()
    with pytest.raises(TypeError, match="bfloat16"):
        F.fused_self_attention(prm, x, num_heads=2)
    q = rnd(2, 2, 3, 64).float()
    with pytest.raises(TypeError, match="bfloat16"):
        FA.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="one key vector per group"):
        FA.flash_attention_grouped(rnd(4, 2, 3, 64), rnd(2, 2, 3, 64), rnd(2, 2, 3, 64),
                                   kv_groups=2, bias=torch.zeros(4, 1, 1, 3, device="cuda"))


# --------------------------------------------------------------------------
# the training slice: probs forms, differentiable forms, crop, train step
# --------------------------------------------------------------------------


def _probs_close(probs, ref, mask, same_inputs=False):
    """Maps within 4 bf16 ulps of the largest probability, and entry by
    entry within 1e-6 + rtol * |ref| (chip_smoke.phase_probs' rule): rtol
    1e-4 where the core and its plain version read the same bf16 q, k and v
    (`same_inputs`), 2^-5 for a sublayer (q and k come out of the
    projections rounded to bf16 in another summation order); rows summing
    to 1 within f32 rounding, masked keys exactly 0."""
    probs, ref = probs.float(), ref.float()
    torch.cuda.synchronize()
    assert probs.shape == ref.shape
    diff = (probs - ref).abs()
    assert diff.max().item() <= 4 * 2 ** -8 * ref.abs().max().item()
    rtol = 1e-4 if same_inputs else 2 ** -5
    assert bool((diff <= 1e-6 + rtol * ref.abs()).all())
    del diff
    assert (probs.sum(-1) - 1).abs().max().item() <= 1e-4
    assert bool((probs.masked_select(mask[:, None, None, :] == 0) == 0).all())


@pytest.mark.parametrize("heads", [2, 4, 6, 8, 10, 12])
@pytest.mark.parametrize("kind", ["self", "cross"])
def test_probs_forms_at_the_exported_head_counts(rnd, kind, heads):
    """#2 and #3 with return_probs at every head count the export gives with
    head_gate_group 2 (A 128-768), masked key tails; counted as probs
    launches, the non-probs count unchanged."""
    a, b, t = 64 * heads, 5, 40
    s = t if kind == "self" else 77
    prm, x, enc = _attn(rnd, 768, a), rnd(b, t, 768), rnd(b, s, 768)
    mask = _mask(b, s)
    hz = torch.rand(heads, device="cuda") + 0.2
    kb = F._key_bias(b, s, mask, None, x.device)
    wrapper = F.fused_self_attention if kind == "self" else F.fused_cross_attention
    before = (wrapper.launches, wrapper.probs_launches)
    if kind == "self":
        out, probs = F.fused_self_attention(prm, x, num_heads=heads, mask=mask, head_z=hz,
                                            return_probs=True)
        ref, ref_probs = F.self_attention_plain(prm, x, kb, hz, heads, return_probs=True)
    else:
        out, probs = F.fused_cross_attention(prm, x, enc, num_heads=heads, mask=mask, head_z=hz,
                                             return_probs=True)
        ref, ref_probs = F.cross_attention_plain(prm, x, enc, kb, hz, heads, return_probs=True)
    assert (wrapper.launches, wrapper.probs_launches) == (before[0], before[1] + 1)
    _close(out, ref)
    _probs_close(probs, ref_probs, mask)


def test_attn_core_probs_form_at_the_vit_shape(rnd):
    """The core alone at 577 keys (an odd S: the last key of each row is a
    4-byte store) with masked tails."""
    b, s, h = 2, 577, 12
    q, k, v = rnd(b * s, h * 64), rnd(b * s, h * 64), rnd(b * s, h * 64)
    mask = _mask(b, s)
    kb = F._key_bias(b, s, mask, None, q.device)
    hz = torch.rand(h, device="cuda") + 0.2
    out, probs = K.attn_core(q, k, v, kb, hz, batch=b, tq=s, s=s, probs=True)
    ref, ref_probs = F.attn_core_plain(q, k, v, kb, hz, batch=b, tq=s, s=s, probs=True)
    _close(out, ref)
    _probs_close(probs, ref_probs, mask, same_inputs=True)


def _region_mask(b, s):
    """A region batch's key mask: every row keeps key 0 (CLS) and one
    contiguous run of keys, of another length and place per row."""
    m = torch.zeros(b, s, dtype=torch.int32, device="cuda")
    m[:, 0] = 1
    for i in range(b):
        start = 1 + (7 * i) % max(1, s - 1)
        m[i, start:start + 3 + 11 * i] = 1
    return m


PROBS = {
    # name: (batch, Tq, S, heads, key mask); the probs core at head dim 64
    # over S on each side of a key tile and of a 32-key half, Tq not a
    # multiple of the rule's rows, 2-12 heads, masked tails or region masks
    "s1_tq5_h2": (3, 5, 1, 2, "mask"),
    "s40_tq40_h12": (4, 40, 40, 12, "mask"),
    "s63_tq70_h2": (3, 70, 63, 2, "mask"),
    "s64_tq33_h4": (3, 33, 64, 4, "mask"),
    "s65_tq100_h6": (2, 100, 65, 6, "mask"),
    "s197_tq197_h12_region": (4, 197, 197, 12, "region"),
    "s577_tq577_h2": (2, 577, 577, 2, "mask"),
    "s577_tq40_h8": (3, 40, 577, 8, "mask"),
    "s901_tq901_h2": (1, 901, 901, 2, "mask"),
    "s901_tq40_h10": (2, 40, 901, 10, "mask"),
    "s2944_staging_limit": (1, 37, 2944, 2, "mask"),
}


def _probs_inputs(rnd, b, tq, s, h, masks):
    q, k, v = rnd(b * tq, h * 64), rnd(b * s, h * 64), rnd(b * s, h * 64)
    mask = _region_mask(b, s) if masks == "region" else _mask(b, s)
    kb = F._key_bias(b, s, mask, None, q.device)
    return q, k, v, kb, torch.rand(h, device="cuda") + 0.2, mask


@pytest.mark.parametrize("name", sorted(PROBS))
def test_attn_probs(rnd, name):
    """The probs core against attn_core_plain(probs=True): the output within
    4 bf16 ulps, the maps by _probs_close's rule; one attn_probs route."""
    b, tq, s, h, masks = PROBS[name]
    q, k, v, kb, hz, mask = _probs_inputs(rnd, b, tq, s, h, masks)
    assert K.probs_tile(64, tq, s)[0] > 0
    before = dict(K.probs_routes)
    out, probs = K.attn_core(q, k, v, kb, hz, batch=b, tq=tq, s=s, probs=True)
    assert K.probs_routes == {**before, "attn_probs": before["attn_probs"] + 1}
    ref, ref_probs = F.attn_core_plain(q, k, v, kb, hz, batch=b, tq=tq, s=s, probs=True)
    _close(out, ref)
    _probs_close(probs, ref_probs, mask, same_inputs=True)


@pytest.mark.parametrize("s,tq,rows,warps", [(577, 577, 16, 4), (577, 577, 32, 5),
                                             (197, 197, 64, 2), (901, 300, 16, 5),
                                             (40, 200, 64, 1), (257, 300, 128, 1)])
def test_attn_probs_at_other_tiles(rnd, s, tq, rows, warps):
    """Tiles other than the rule's (rows a block, warps a 16-row group), as
    the tile sweep of scripts/torch_probs_bench.py times them, give the same
    result."""
    q, k, v, kb, hz, mask = _probs_inputs(rnd, 2, tq, s, 3, "mask")
    out, probs = K._attn_probs_tile(q, k, v, kb, hz, 2, tq, s, rows, warps)
    ref, ref_probs = F.attn_core_plain(q, k, v, kb, hz, batch=2, tq=tq, s=s, probs=True)
    _close(out, ref)
    _probs_close(probs, ref_probs, mask, same_inputs=True)


@pytest.mark.parametrize("b,tq,s,h", [(8, 901, 901, 12), (48, 40, 577, 12)])
def test_attn_probs_repeated_launches(rnd, b, tq, s, h):
    """Twenty launches back to back at the VQA ViT's and the fusion layers'
    shapes (four consumer warps a 16-row group, many tiles each, every SM
    busy): the rings hand each slot to its class's warps in order, so no
    launch faults and the last one still agrees."""
    q, k, v, kb, hz, mask = _probs_inputs(rnd, b, tq, s, h, "mask")
    for _ in range(20):
        out, probs = K.attn_probs(q, k, v, kb, hz, batch=b, tq=tq, s=s)
    ref, ref_probs = F.attn_core_plain(q, k, v, kb, hz, batch=b, tq=tq, s=s, probs=True)
    _close(out, ref)
    _probs_close(probs, ref_probs, mask, same_inputs=True)


@pytest.mark.parametrize("s", [577, 197, 41])
def test_attn_probs_writes_no_pad_column(rnd, s):
    """The C entry over a maps buffer filled with NaN: every key of every
    row is written, and the pad columns past S (up to the pitch) keep their
    NaN: TMA clips each box at S."""
    b, tq, h = 2, 50, 2
    q, k, v, kb, hz, mask = _probs_inputs(rnd, b, tq, s, h, "mask")
    pitch = -(-s // 4) * 4
    maps = torch.full((b, h, tq, pitch), float("nan"), device="cuda")
    out = torch.empty_like(q)
    rows, warps = K.probs_tile(64, tq, s)
    rc = K.library().evlm_attn_probs(q.data_ptr(), k.data_ptr(), v.data_ptr(), kb.data_ptr(),
                                     hz.data_ptr(), out.data_ptr(), maps.data_ptr(), pitch, b, tq,
                                     s, h, rows, warps, 0, 0.125, K._stream(q))
    assert rc == 0
    torch.cuda.synchronize()
    assert torch.isfinite(maps[..., :s]).all()
    assert torch.isnan(maps[..., s:]).all() and maps.shape[-1] - s == (-s) % 4
    ref, ref_probs = F.attn_core_plain(q, k, v, kb, hz, batch=b, tq=tq, s=s, probs=True)
    _close(out, ref)
    _probs_close(maps[..., :s], ref_probs, mask, same_inputs=True)


@pytest.mark.parametrize("dh", [32, 128])
def test_two_sweep_probs_route_at_other_head_dims(rnd, dh):
    """Head dims 32 and 128 keep attn_core's two-sweep probs form, counted
    as that route."""
    b, tq, s, h = 2, 70, 145, 2
    q, k, v = rnd(b * tq, h * dh), rnd(b * s, h * dh), rnd(b * s, h * dh)
    mask = _mask(b, s)
    kb = F._key_bias(b, s, mask, None, q.device)
    hz = torch.rand(h, device="cuda") + 0.2
    assert K.probs_tile(dh, tq, s) == (0, 0)
    before = dict(K.probs_routes)
    out, probs = K.attn_core(q, k, v, kb, hz, batch=b, tq=tq, s=s, probs=True)
    assert K.probs_routes == {**before, "attn_core": before["attn_core"] + 1}
    ref, ref_probs = F.attn_core_plain(q, k, v, kb, hz, batch=b, tq=tq, s=s, probs=True)
    _close(out, ref)
    _probs_close(probs, ref_probs, mask, same_inputs=True)


@pytest.mark.parametrize("kind,dh", [("self", 64), ("cross", 64), ("self", 32)])
def test_probs_sublayer_launches_the_probs_core(rnd, kind, dh):
    """#2p / #3p at head dim 64 run attn_probs inside their three / four
    device launches, and never attn_core; at head dim 32 attn_core's
    two-sweep form."""
    h, b, t = 128 // dh, 3, 20
    s = 37 if kind == "cross" else t
    prm, x, enc = _attn(rnd, 128, 128), rnd(b, t, 128), rnd(b, s, 128)
    kb = F._key_bias(b, s, _mask(b, s), None, x.device)  # as the models pass it
    if kind == "self":
        run = lambda: F.fused_self_attention(prm, x, num_heads=h, key_bias=kb, return_probs=True)
    else:
        run = lambda: F.fused_cross_attention(prm, x, enc, num_heads=h, key_bias=kb,
                                              return_probs=True)
    names = _kernel_names(run)
    probs_core = dh == 64
    assert any("attn_probs_kernel" in n for n in names) == probs_core
    assert any("attn_core_kernel" in n for n in names) == (not probs_core)
    assert len(names) == (3 if kind == "self" else 4), names


def test_launch_set_up_in_any_order(rnd):
    """Each kernel raises its shared memory limit once per device to the most
    any launch asks for: attn_probs at 16 rows over 40 keys, then at the
    staging limit (2,944 keys, 227 KB), then small again; attn_core from one warp to
    eight and back; gemm_bias and attn_wgmma at a small shape."""
    for s in (40, 2944, 40):
        q, k, v, kb, hz, mask = _probs_inputs(rnd, 1, 16, s, 2, "mask")
        out, probs = K.attn_probs(q, k, v, kb, hz, batch=1, tq=16, s=s)
        ref, ref_probs = F.attn_core_plain(q, k, v, kb, hz, batch=1, tq=16, s=s, probs=True)
        _close(out, ref)
        _probs_close(probs, ref_probs, mask, same_inputs=True)
    for tq in (16, 577, 16):
        q, k, v, kb, hz, _ = _probs_inputs(rnd, 2, tq, 70, 2, "mask")
        _close(K.attn_core(q, k, v, kb, hz, batch=2, tq=tq, s=70),
               F.attn_core_plain(q, k, v, kb, hz, batch=2, tq=tq, s=70))
        _close(K.attn_wgmma(q, k, v, kb, hz, batch=2, tq=tq, s=70),
               F.attn_core_plain(q, k, v, kb, hz, batch=2, tq=tq, s=70))
    a, w = rnd(50, 64), rnd(64, 72, std=0.125)
    _close(K.gemm_bias(a, w), F.gemm_bias_plain(a, w))


def _grad_agree(run_kernel, run_plain, inputs, cotangents):
    """The differentiable form's gradients against the plain version's own
    autograd on the same bf16 inputs: its backward recomputes that version,
    so they agree to within 1e-5 of the largest gradient (the recompute runs
    the same ops; only reduction order may differ)."""
    grads = []
    for run in (run_kernel, run_plain):
        for t in inputs:
            t.grad = None
        outs = run()
        torch.autograd.backward(list(outs), cotangents[:len(outs)])
        grads.append([t.grad.float().clone() for t in inputs])
    torch.cuda.synchronize()
    for g, r in zip(*grads):
        assert torch.isfinite(g).all()
        assert (g - r).abs().max().item() <= 1e-5 * max(r.abs().max().item(), 1e-30)


@pytest.mark.parametrize("kind", ["self", "cross"])
def test_differentiable_attention_forms(rnd, kind):
    """#2 / #3 differentiable, with probs: every weight and bias (f32
    masters), hidden, the encoder hidden and head_z."""
    d, b, t, h = 256, 3, 40, 4
    s = t if kind == "self" else 77
    prm = {n: {kk: v.float().requires_grad_(True) for kk, v in p.items()}
           for n, p in _attn(rnd, d, d).items()}
    x, enc = rnd(b, t, d).requires_grad_(True), rnd(b, s, d).requires_grad_(True)
    hz = (torch.rand(h, device="cuda") + 0.2).requires_grad_(True)
    mask = _mask(b, s)
    kb = F._key_bias(b, s, mask, None, x.device)
    ins = [x, hz] + [prm[n][kk] for n in prm for kk in prm[n]] + ([enc] if kind == "cross" else [])
    cts = [rnd(b, t, d), torch.randn(b, h, t, s, device="cuda")]
    before = F.fused_self_attention.probs_launches + F.fused_cross_attention.probs_launches
    if kind == "self":
        kern = lambda: F.fused_self_attention(prm, x, num_heads=h, mask=mask, head_z=hz,  # noqa
                                              return_probs=True, differentiable=True)
        plain = lambda: F.self_attention_plain(prm, x, kb, hz, h, return_probs=True)  # noqa
    else:
        kern = lambda: F.fused_cross_attention(prm, x, enc, num_heads=h, mask=mask,  # noqa
                                               head_z=hz, return_probs=True,
                                               differentiable=True)
        plain = lambda: F.cross_attention_plain(prm, x, enc, kb, hz, h,  # noqa: E731
                                                return_probs=True)
    _grad_agree(kern, plain, ins, cts)
    assert F.fused_self_attention.probs_launches + F.fused_cross_attention.probs_launches == \
        before + 1
    with pytest.raises(RuntimeError, match="requires grad"):  # the kernel without a backward
        F.fused_self_attention(prm, x, num_heads=h, mask=mask, head_z=hz)


def test_differentiable_patch_embed(rnd):
    d, p, res = 256, 16, 64
    n = (res // p) ** 2
    pp = {"patch_embed": {"kernel": rnd(p, p, 3, d, std=(p * p * 3) ** -0.5).float()},
          "class_embedding": rnd(d, std=0.5).float(),
          "pos_embed": {"embedding": rnd(n + 1, d, std=0.5).float()},
          "pre_ln": {"scale": rnd(d, std=0.1, mean=1.0).float(), "bias": rnd(d, std=0.1).float()}}
    leaves = [pp["patch_embed"]["kernel"], pp["class_embedding"], pp["pos_embed"]["embedding"],
              pp["pre_ln"]["scale"], pp["pre_ln"]["bias"]]
    for t in leaves:
        t.requires_grad_(True)
    img = rnd(3, res, res, 3)
    before = fused_patch_embed.launches
    _grad_agree(lambda: (fused_patch_embed(pp, img, patch_size=p, dtype=torch.bfloat16,
                                           differentiable=True),),
                lambda: (patch_embed_plain(pp, img, patch_size=p, dtype=torch.bfloat16),),
                leaves, [rnd(3, n + 1, d)])
    assert fused_patch_embed.launches == before + 1


def test_patch_embed_crops_an_image_the_patch_does_not_tile(rnd):
    """392 x 388 at patch 16: the gather reads the 24 x 24 patches of the
    top-left 384 x 384 in place (388 * 3 % 8 != 0, so from a cropped copy)
    and 392 x 392 in place (the rows are whole 16-byte pieces)."""
    d, p = 768, 16
    pp = {"patch_embed": {"kernel": rnd(p, p, 3, d, std=(p * p * 3) ** -0.5)},
          "class_embedding": rnd(d, std=0.5), "pos_embed": {"embedding": rnd(577, d, std=0.5)},
          "pre_ln": {"scale": rnd(d, std=0.1, mean=1.0), "bias": rnd(d, std=0.1)}}
    for hw in ((392, 388), (392, 392)):
        img = rnd(2, *hw, 3)
        out = fused_patch_embed(pp, img, patch_size=p)
        assert tuple(out.shape) == (2, 577, d)
        _close(out, patch_embed_plain(pp, img, patch_size=p))
        _close(out, patch_embed_plain(pp, img[:, :384, :384].contiguous(), patch_size=p))


def _train_setup(impl, dtype, seed=0):
    """A 2L/2L student and a 4L/4L teacher at width 256 (4 heads of 64),
    64 px images at patch 16, batch 6 x 12 tokens, with the slice's gates
    and optimizers; the hard negatives pinned to a fixed derangement."""
    from efficientvlm_tpu_torch.config import Config, TextConfig, VisionConfig
    from efficientvlm_tpu_torch.drivers.common import build_optimizers
    from efficientvlm_tpu_torch.drivers.retrieval import build_l0, build_models
    from efficientvlm_tpu_torch.train.steps import init_train_state, make_retrieval_train_step

    v = dict(vision_width=256, num_attention_heads=4, intermediate_size=512, image_res=64,
             patch_size=16)
    t = dict(vocab_size=500, hidden_size=256, num_attention_heads=4, intermediate_size=512,
             encoder_width=256, max_position_embeddings=64)
    config = Config({
        "embed_dim": 64, "sparsity": 0.25, "head_gate_group": 2,
        "vision": VisionConfig.create(**v, num_hidden_layers=2),
        "text": TextConfig.create(**t, num_hidden_layers=2),
        "teacher_vision": VisionConfig.create(**v, num_hidden_layers=4),
        "teacher_text": TextConfig.create(**t, num_hidden_layers=4),
        "optimizer": {"lr": 3e-5, "reg_learning_rate": 0.01, "weight_decay": 0.01},
        "schedular": {"num_warmup_steps": 0}})
    student, teacher = build_models(config)
    for m in (student, teacher):
        m.sample_hard_negatives = lambda g, i, t_, *, idx=None, temp: (  # noqa: E731
            (torch.arange(len(i), device=i.device) + 2) % len(i),
            (torch.arange(len(i), device=i.device) + 3) % len(i))
    l0 = build_l0(config)
    params = student.init(seed, device="cuda")
    opts = build_optimizers(params, config, 100)
    state = init_train_state(params, l0.init(seed, device="cuda"), opts)
    step = make_retrieval_train_step(student, teacher, l0, opts,
                                     teacher_params=teacher.init(seed + 1, device="cuda"),
                                     dtype=dtype, impl=impl)
    g = torch.Generator(device="cuda").manual_seed(seed)
    batch = {"image": torch.randn(6, 64, 64, 3, generator=g, device="cuda"),
             "text_ids": torch.randint(1, 500, (6, 12), generator=g, device="cuda"),
             "text_atts": torch.ones(6, 12, dtype=torch.int32, device="cuda"),
             "idx": torch.tensor([0, 1, 1, 2, 3, 4], device="cuda")}
    batch["text_atts"][1, 8:] = 0
    if dtype is not None:
        batch["image"] = batch["image"].to(dtype)
    noise = {k: torch.rand(gr["shape"], generator=g, device="cuda") * 0.99 + 0.005
             for k, gr in l0.groups.items()}
    return step, state, batch, noise


def test_two_train_steps_kernel_path_against_plain_path(rnd):
    """Two steps from one state on the kernel path and on the plain path
    (bf16 compute), and on the plain path in f32: per-step launch counts,
    finite metrics, and each loss of the kernel path within 3x the plain
    bf16 path's largest relative distance from f32 compute over the steps."""
    from efficientvlm_tpu_torch.train.optim import tree_leaves

    runs = {}
    for name, impl, dtype in (("kernel", "fused", torch.bfloat16),
                              ("plain", "plain", torch.bfloat16), ("f32", "plain", None)):
        step, state, batch, noise = _train_setup(impl, dtype)
        gen = torch.Generator(device="cuda").manual_seed(1)
        metrics = []
        for _ in range(2):
            c = (fused_patch_embed.launches, F.fused_self_attention.probs_launches,
                 F.fused_cross_attention.probs_launches)
            metrics.append({k: float(v) for k, v in step(state, batch, gen, noise=noise).items()})
            now = (fused_patch_embed.launches, F.fused_self_attention.probs_launches,
                   F.fused_cross_attention.probs_launches)
            got = tuple(a - b for a, b in zip(now, c))
            # teacher 4 ViT + 2 text + 2x2 fusion self, student 2 ViT; teacher 2x2 cross
            assert got == ((2, 12, 4) if impl == "fused" else (0, 0, 0)), got
        runs[name] = (metrics, state)
        assert all(np.isfinite(v) for m in metrics for v in m.values())
        assert all(bool(torch.isfinite(t).all()) for t in tree_leaves(state.params))
    # the yardstick: the plain bf16 path's largest relative distance from f32
    # over every loss of both steps (one scalar's own distance may cancel)
    f32, kern, plain = (runs[n][0] for n in ("f32", "kernel", "plain"))
    rel = max(abs(plain[i][k] - f32[i][k]) / max(abs(f32[i][k]), 1e-3)
              for i in range(2) for k in f32[i])
    for i in range(2):
        for k in f32[i]:
            assert abs(kern[i][k] - plain[i][k]) <= 3 * rel * max(abs(f32[i][k]), 1e-3), (k, rel)
    assert runs["kernel"][1].step == 2


@pytest.mark.parametrize("heads", [2, 4, 6, 8, 10, 12])
def test_grouped_cross_attention_at_the_exported_head_counts(rnd, heads):
    """#4 at every head count the export gives with head_gate_group 2."""
    a, bk, g, t, s = 64 * heads, 2, 8, 40, 77
    prm, x, enc = _attn(rnd, 768, a), rnd(bk * g, t, 768), rnd(bk, s, 768)
    mask, hz = _mask(bk, s), torch.rand(heads, device="cuda") + 0.2
    ln = {"scale": rnd(768, std=0.1, mean=1.0), "bias": rnd(768, std=0.1)}
    kb = F._key_bias(bk, s, mask, None, x.device)
    _agree(F.fused_cross_attention_grouped,
           lambda: F.fused_cross_attention_grouped(prm, x, enc, num_heads=heads, kv_groups=g,
                                                   key_bias=kb, head_z=hz, ln_params=ln),
           lambda: F.cross_attention_grouped_plain(prm, x, enc, kb, hz, heads, g, ln))


# ---------------------------------------------------------------------------
# general distillation's shapes: 224 px (197 tokens), region batches, the
# ITM-negative fusion pass at batch 256, and the device image pipeline
# ---------------------------------------------------------------------------


def _region_mask(b, s, seed=0):
    """Key masks of a region batch's local layers: every row keeps the CLS
    key; rows 0, 3, 6, ... keep all keys (the full images), the others a
    box of 1-12 patches of the 14 x 14 grid."""
    g = torch.Generator().manual_seed(seed)
    m = torch.zeros(b, s, dtype=torch.int32)
    m[:, 0] = 1
    side = int(round((s - 1) ** 0.5))
    for i in range(b):
        if i % 3 == 0:
            m[i] = 1
            continue
        h, w = (int(x) for x in torch.randint(1, 4, (2,), generator=g))
        y0, x0 = (int(x) for x in torch.randint(0, side - 3, (2,), generator=g))
        grid = torch.zeros(side, side, dtype=torch.int32)
        grid[y0:y0 + h, x0:x0 + w] = 1
        m[i, 1:] = grid.reshape(-1)
    return m.cuda()


def test_patch_embed_gather_at_224(rnd):
    """#1's gather form at the GD batch: 128 images of 224 x 224, patch 16."""
    d, p = 768, 16
    pp = {"patch_embed": {"kernel": rnd(p, p, 3, d, std=(p * p * 3) ** -0.5)},
          "class_embedding": rnd(d, std=0.5), "pos_embed": {"embedding": rnd(197, d, std=0.5)},
          "pre_ln": {"scale": rnd(d, std=0.1, mean=1.0), "bias": rnd(d, std=0.1)}}
    img = rnd(128, 224, 224, 3)
    _agree(fused_patch_embed, lambda: fused_patch_embed(pp, img, patch_size=p),
           lambda: patch_embed_plain(pp, img, patch_size=p))


@pytest.mark.parametrize("rows,region", [(128, False), (176, True)],
                         ids=["vit_b128", "region_local_b176"])
def test_self_attention_training_forms_at_197_tokens(rnd, rows, region):
    """#2's probs form and its differentiable form at S = 197 (the maps'
    rows padded to 200 floats), 12 heads; the region case with the local
    layers' key masks (some rows keep only the CLS key and a few patches)."""
    d, h, s = 768, 12, 197
    mask = _region_mask(rows, s) if region else _mask(rows, s)
    prm, x = _attn(rnd, d, d), rnd(rows, s, d)
    hz = torch.rand(h, device="cuda") + 0.2
    kb = F._key_bias(rows, s, mask, None, x.device)
    before = F.fused_self_attention.probs_launches
    out, probs = F.fused_self_attention(prm, x, num_heads=h, mask=mask, head_z=hz,
                                        return_probs=True)
    assert F.fused_self_attention.probs_launches == before + 1
    ref, ref_probs = F.self_attention_plain(prm, x, kb, hz, h, return_probs=True)
    _close(out, ref)
    _probs_close(probs, ref_probs, mask)
    del probs, ref_probs
    master = {n: {kk: v.float().requires_grad_(True) for kk, v in p.items()}
              for n, p in prm.items()}
    xg, hg = x.clone().requires_grad_(True), hz.clone().requires_grad_(True)
    ins = [xg, hg] + [master[n][kk] for n in master for kk in master[n]]
    cts = [rnd(rows, s, d), torch.randn(rows, h, s, s, device="cuda")]
    _grad_agree(lambda: F.fused_self_attention(master, xg, num_heads=h, mask=mask, head_z=hg,
                                               return_probs=True, differentiable=True),
                lambda: F.self_attention_plain(master, xg, kb, hg, h, return_probs=True),
                ins, cts)


def test_cross_attention_probs_at_the_itm_negative_pass(rnd):
    """#3's probs form at [256, 40] x [256, 197], the key bias of region
    masks on half of the rows."""
    d, h, b, t, s = 768, 12, 256, 40, 197
    mask = torch.cat([_region_mask(b // 2, s, seed=1),
                      torch.ones(b // 2, s, dtype=torch.int32, device="cuda")])
    prm, x, enc = _attn(rnd, d, d), rnd(b, t, d), rnd(b, s, d)
    hz = torch.rand(h, device="cuda") + 0.2
    kb = F._key_bias(b, s, mask, None, x.device)
    before = F.fused_cross_attention.probs_launches
    out, probs = F.fused_cross_attention(prm, x, enc, num_heads=h, key_bias=kb, head_z=hz,
                                         return_probs=True)
    assert F.fused_cross_attention.probs_launches == before + 1
    ref, ref_probs = F.cross_attention_plain(prm, x, enc, kb, hz, h, return_probs=True)
    _close(out, ref)
    _probs_close(probs, ref_probs, mask)


def test_self_attention_training_forms_at_the_vqa_vit(rnd):
    """#2's probs form and its differentiable form at the VQA fine-tune's
    ViT, [8, 901] at 480 px (the maps' rows padded to 904 floats), 12
    heads, a masked key tail on the later rows."""
    d, h, b, s = 768, 12, 8, 901
    mask = _mask(b, s)
    prm, x = _attn(rnd, d, d), rnd(b, s, d)
    hz = torch.rand(h, device="cuda") + 0.2
    kb = F._key_bias(b, s, mask, None, x.device)
    before = F.fused_self_attention.probs_launches
    out, probs = F.fused_self_attention(prm, x, num_heads=h, mask=mask, head_z=hz,
                                        return_probs=True)
    assert F.fused_self_attention.probs_launches == before + 1
    ref, ref_probs = F.self_attention_plain(prm, x, kb, hz, h, return_probs=True)
    _close(out, ref)
    _probs_close(probs, ref_probs, mask)
    del probs, ref_probs
    master = {n: {kk: v.float().requires_grad_(True) for kk, v in p.items()}
              for n, p in prm.items()}
    xg, hg = x.clone().requires_grad_(True), hz.clone().requires_grad_(True)
    ins = [xg, hg] + [master[n][kk] for n in master for kk in master[n]]
    cts = [rnd(b, s, d), torch.randn(b, h, s, s, device="cuda")]
    _grad_agree(lambda: F.fused_self_attention(master, xg, num_heads=h, mask=mask, head_z=hg,
                                               return_probs=True, differentiable=True),
                lambda: F.self_attention_plain(master, xg, kb, hg, h, return_probs=True),
                ins, cts)


@pytest.mark.parametrize("b,t,s", [(8, 40, 901), (40, 20, 40)],
                         ids=["question_fusion_b8_t40_s901", "answer_decoder_b40_t20_s40"])
def test_cross_attention_probs_at_the_vqa_shapes(rnd, b, t, s):
    """#3's probs form at the VQA fine-tune's shapes: the question fusion
    over the 480 px image and the answer decoder over the gathered question
    states, whose key masks are the questions' padding (lengths 4-40)."""
    d, h = 768, 12
    g = torch.Generator().manual_seed(2)
    lens = torch.randint(4, s + 1, (b,), generator=g)
    lens[0] = s
    mask = (torch.arange(s)[None] < lens[:, None]).to(torch.int32).cuda()
    prm, x, enc = _attn(rnd, d, d), rnd(b, t, d), rnd(b, s, d)
    hz = torch.rand(h, device="cuda") + 0.2
    kb = F._key_bias(b, s, mask, None, x.device)
    before = F.fused_cross_attention.probs_launches
    out, probs = F.fused_cross_attention(prm, x, enc, num_heads=h, key_bias=kb, head_z=hz,
                                         return_probs=True)
    assert F.fused_cross_attention.probs_launches == before + 1
    ref, ref_probs = F.cross_attention_plain(prm, x, enc, kb, hz, h, return_probs=True)
    _close(out, ref)
    _probs_close(probs, ref_probs, mask)


def test_preprocess_train_on_the_card_matches_the_cpu(rnd):
    """preprocess_train on a CUDA batch against its CPU run on the same draws
    (drawn once from a CPU generator): the crop gathers, the affine ops'
    bilinear taps and the resize agree to f32 rounding (atol 1e-4 in
    normalised units); the thresholding ops (equalize, solarize,
    posterize) are drawn only in the first round, on integral pixels."""
    from efficientvlm_tpu_torch.data import device_pipeline as P

    n = 32
    pixels = torch.randint(0, 256, (n, 257, 257, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(0))
    params = P.sample_train_params(torch.Generator().manual_seed(1), n, 257, 257)
    params["ops"][0] = torch.arange(n) % P.N_OPS
    params["ops"][1] = torch.tensor([0, 1, 3, 5, 6, 7, 8, 9, 10, 11, 12])[torch.arange(n) % 11]
    cpu = P.preprocess_train(pixels, 224, params=params)
    on_card = P.preprocess_train(pixels.cuda(), 224,
                                 params={k: tuple(t.cuda() for t in v) if isinstance(v, tuple)
                                         else v.cuda() for k, v in params.items()})
    assert on_card.is_cuda and on_card.dtype == torch.float32
    assert (on_card.cpu() - cpu).abs().max().item() <= 1e-4


@pytest.mark.parametrize("form", ["eval", "probs"])
def test_cross_attention_reads_tied_kv(rnd, form):
    """#3 over a params dict whose K/V are another layer's tensors (NLVR's
    pair-second layer) gives what it gives over copies of them, bit for bit,
    in the eval form and the probs form."""
    d, h, b, t, s = 256, 4, 3, 40, 77
    first, second = _attn(rnd, d, d), _attn(rnd, d, d)
    tied = {**second, "k": first["k"], "v": first["v"]}
    copied = {**second, "k": {k: v.clone() for k, v in first["k"].items()},
              "v": {k: v.clone() for k, v in first["v"].items()}}
    x, enc, mask = rnd(b, t, d), rnd(b, s, d), _mask(b, s)
    hz = torch.rand(h, device="cuda") + 0.2
    kw = dict(num_heads=h, mask=mask, head_z=hz, return_probs=form == "probs")
    got, want = (F.fused_cross_attention(p, x, enc, **kw) for p in (tied, copied))
    for g, w in zip(*((o,) if form == "eval" else o for o in (got, want))):
        assert torch.equal(g, w)
    kb = F._key_bias(b, s, mask, None, x.device)
    ref = F.cross_attention_plain(tied, x, enc, kb, hz, h, return_probs=form == "probs")
    _close(got if form == "eval" else got[0], ref if form == "eval" else ref[0])


def test_cross_attention_training_form_sums_tied_kv_gradients(rnd):
    """Two cross layers sharing one K/V (an NLVR pair over image0 and
    image1), each through #3's differentiable probs form: the shared K/V get
    the sum of both layers' gradients, as two copies' gradients add up, and
    the whole matches the plain versions' own autograd; the pair-second
    layer's own K/V are never read."""
    d, h, b, t, s = 256, 4, 3, 40, 77
    master = lambda p: {n: {k: v.float().requires_grad_(True) for k, v in w.items()}  # noqa
                        for n, w in p.items()}
    first, second = master(_attn(rnd, d, d)), master(_attn(rnd, d, d))
    x = rnd(b, t, d).requires_grad_(True)
    enc0, enc1, mask = rnd(b, s, d), rnd(b, s, d), _mask(b, s)
    hz = torch.rand(h, device="cuda") + 0.2
    kb = F._key_bias(b, s, mask, None, x.device)
    cts = [rnd(b, t, d), torch.randn(b, h, t, s, device="cuda")] * 2

    def pair(kernel: bool, kv_second: dict):
        second_view = {**second, **kv_second}
        outs = []
        for prm, enc in ((first, enc0), (second_view, enc1)):
            if kernel:
                outs += F.fused_cross_attention(prm, x, enc, num_heads=h, mask=mask, head_z=hz,
                                                return_probs=True, differentiable=True)
            else:
                outs += F.cross_attention_plain(prm, x, enc, kb, hz, h, return_probs=True)
        return outs

    shared = [first[n][k] for n in ("k", "v") for k in ("kernel", "bias")]
    own = [second[n][k] for n in ("k", "v") for k in ("kernel", "bias")]
    ins = [x] + shared + [second[n][k] for n in ("q", "out") for k in ("kernel", "bias")]
    tie = {"k": first["k"], "v": first["v"]}
    _grad_agree(lambda: pair(True, tie), lambda: pair(False, tie), ins, cts)
    tied_grads = [t.grad.clone() for t in shared]
    assert all(t.grad is None for t in own)
    copies = {n: {k: v.detach().clone().requires_grad_(True) for k, v in first[n].items()}
              for n in ("k", "v")}
    for t in shared:
        t.grad = None
    torch.autograd.backward(pair(True, copies), cts)
    for g, t, c in zip(tied_grads, shared,
                       [copies[n][k] for n in ("k", "v") for k in ("kernel", "bias")]):
        summed = t.grad + c.grad
        assert (g - summed).abs().max().item() <= 1e-5 * summed.abs().max().item()


NLVR_SHAPES = {
    # name: (kind, batch, Tq, S); 12 heads at width 768, masked key tails
    "nlvr_vit_b32_t577": ("self", 32, 577, 577),
    "nlvr_text_b16_t40": ("self", 16, 40, 40),
    "nlvr_cross_b16_tq40_s577": ("cross", 16, 40, 577),
    "grounding_text_b16_t30": ("self", 16, 30, 30),
    "grounding_cross_b16_tq30_s577": ("cross", 16, 30, 577),
}


@pytest.mark.parametrize("name", sorted(NLVR_SHAPES))
def test_attention_at_the_nlvr_and_grounding_shapes(rnd, name):
    """#2 / #3 in the eval form and the probs form at the NLVR and
    grounding paths' shapes, against their plain versions."""
    kind, b, t, s = NLVR_SHAPES[name]
    d, h = 768, 12
    prm, x, enc, mask = _attn(rnd, d, d), rnd(b, t, d), rnd(b, s, d), _mask(b, s)
    hz = torch.rand(h, device="cuda") + 0.2
    kb = F._key_bias(b, s, mask, None, x.device)
    if kind == "self":
        wrapper = F.fused_self_attention
        run = lambda probs: F.fused_self_attention(prm, x, num_heads=h, mask=mask,  # noqa
                                                   head_z=hz, return_probs=probs)
        plain = lambda probs: F.self_attention_plain(prm, x, kb, hz, h,  # noqa: E731
                                                     return_probs=probs)
    else:
        wrapper = F.fused_cross_attention
        run = lambda probs: F.fused_cross_attention(prm, x, enc, num_heads=h,  # noqa: E731
                                                    mask=mask, head_z=hz, return_probs=probs)
        plain = lambda probs: F.cross_attention_plain(prm, x, enc, kb, hz, h,  # noqa: E731
                                                      return_probs=probs)
    _agree(wrapper, lambda: run(False), lambda: plain(False))
    before = wrapper.probs_launches
    out, probs = run(True)
    assert wrapper.probs_launches == before + 1
    ref, ref_probs = plain(True)
    _close(out, ref)
    _probs_close(probs, ref_probs, mask)


# ---------------------------------------------------------------------------
# the slice of sampling, the other towers, int8 and MoE, on the card
# ---------------------------------------------------------------------------


def test_sampling_draws_from_the_card_generator(rnd):
    """generate_no_beam(do_sample=True) over a fixed logits table on the
    card: two generators seeded alike give the same tokens, the top_p
    filter's excluded tokens never come, and greedy ignores the generator."""
    from efficientvlm_tpu_torch import generation as G

    table = torch.full((12, 12), -4.0, device="cuda")
    table[:, 3:6] = torch.tensor([2.0, 1.5, 1.0], device="cuda")

    def decode_fn(tokens, cache, offset):
        return table[tokens], cache

    prompt = torch.ones(64, 1, dtype=torch.long, device="cuda")

    def draw(seed, **kw):
        g = torch.Generator(device="cuda").manual_seed(seed)
        return G.generate_no_beam(decode_fn, [], prompt, max_length=8, eos_id=2, pad_id=0,
                                  generator=g, **kw)[0]

    a, b = draw(1, do_sample=True, top_p=0.9), draw(1, do_sample=True, top_p=0.9)
    assert torch.equal(a, b) and ((a[:, 1:] >= 3) & (a[:, 1:] <= 5)).all()
    assert len(torch.unique(a[:, 1:])) > 1
    assert torch.equal(draw(1), draw(2)) and (draw(1)[:, 1:] == 3).all()


def test_deit_attention_launches_flash(rnd):
    """A DeiT layer at 224 px (Tq = Tk = 197, head dim 64) under
    impl="fused": one flash_attention launch, the output held to the plain
    path's."""
    from efficientvlm_tpu_torch.bridge import cast_floating
    from efficientvlm_tpu_torch.config import VisionConfig
    from efficientvlm_tpu_torch.models import deit as D

    cfg = VisionConfig.create(vision_width=128, num_attention_heads=2, intermediate_size=256,
                              num_hidden_layers=1, image_res=224, patch_size=16)
    params = cast_floating(D.init_deit(torch.Generator(device="cuda").manual_seed(0), cfg,
                                       "cuda"), torch.bfloat16)
    image = rnd(2, 224, 224, 3)
    before = FA.flash_attention.launches
    with torch.inference_mode():
        out = D.deit_apply(params, image, cfg, dtype=torch.bfloat16)["last_hidden"]
        ref = D.deit_apply(params, image, cfg, dtype=torch.bfloat16, impl="plain")["last_hidden"]
    assert FA.flash_attention.launches == before + 1 and out.shape == (2, 197, 128)
    torch.cuda.synchronize()
    assert (out.float() - ref.float()).abs().max().item() <= 0.05 * ref.float().abs().max().item()


@pytest.mark.parametrize("rows", [5, 40])
def test_int8_product_on_the_card(rnd, rows):
    """w8a8's dense on the card (torch._int_mm, rows padded to at least 32)
    against the same arithmetic on the CPU."""
    from efficientvlm_tpu_torch.ops.quant import dense_quantized, quantize_dense

    p = {"kernel": rnd(256, 384, std=0.05, dtype=torch.float32),
         "bias": rnd(384, std=0.1, dtype=torch.float32)}
    q = quantize_dense(p, mode="w8a8")
    x = rnd(rows, 256, dtype=torch.float32)
    got = dense_quantized(q, x)
    want = dense_quantized({k: v.cpu() for k, v in q.items()}, x.cpu())
    assert got.shape == (rows, 384)
    assert (got.cpu() - want).abs().max().item() <= 1e-4 * want.abs().max().item() + 1e-5


def test_moe_on_the_card(rnd):
    from efficientvlm_tpu_torch.ops.moe import init_moe_ffn, moe_ffn

    params = init_moe_ffn(torch.Generator(device="cuda").manual_seed(0), hidden=64, ffn=128,
                          num_experts=4, device="cuda")
    h = rnd(2, 24, 64, dtype=torch.float32)
    out, aux = moe_ffn(params, h, capacity_factor=0.5)
    cpu = {k: ({kk: vv.cpu() for kk, vv in v.items()} if isinstance(v, dict) else v.cpu())
           for k, v in params.items()}
    want, want_aux = moe_ffn(cpu, h.cpu(), capacity_factor=0.5)
    assert (out.cpu() - want).abs().max().item() <= 1e-4 * want.abs().max().item()
    assert abs(aux.item() - want_aux.item()) <= 1e-5
    assert torch.equal(out.cpu().abs().sum(-1) == 0, want.abs().sum(-1) == 0)


# --------------------------------------------------------------------------
# the FFN sublayer (ops/fused_ffn.py): gemm_bias's activations, then gemm_ln
# --------------------------------------------------------------------------


def _ffn_layer(r, d, i):
    """One BERT FFN sublayer's params as the export stores them (f32)."""
    f32 = torch.float32
    return {"intermediate": {"kernel": r(d, i, std=d ** -0.5, dtype=f32),
                             "bias": r(i, std=0.5, dtype=f32)},
            "output": {"kernel": r(i, d, std=i ** -0.5, dtype=f32), "bias": r(d, std=0.5, dtype=f32)},
            "output_ln": {"scale": r(d, mean=1.0, std=0.1, dtype=f32),
                          "bias": r(d, std=0.1, dtype=f32)}}


def _ffn_twin(lp, h, act="gelu"):
    """fused_ffn_plain over the op's prepared (padded bf16) weights."""
    w1, b1, w2 = FF.prepared(lp["intermediate"], lp["output"])
    ln = lp["output_ln"]
    return FF.fused_ffn_plain(h.reshape(-1, h.shape[-1]), w1, b1, w2, lp["output"]["bias"],
                              ln["scale"], ln["bias"], 1e-12, act=act).reshape(h.shape)


def _ffn(lp, h, **kw):
    return FF.ffn_sublayer(lp, h, **{"act": "gelu", "eps": 1e-12, "dtype": torch.bfloat16, **kw})


FFN = {
    # name: (rows, D, I): the rerank chunk's 40,960 rows at the export's
    # widths (align_intermediate=1), the teacher's aligned width at its b24
    # step's rows, a caption beam step (48 rows of one token)
    "rerank_m40960_i2244": (40960, 768, 2244),
    "rerank_m40960_i2332": (40960, 768, 2332),
    "teacher_m528_i3072": (528, 768, 3072),
    "decode_m48_i2244": (48, 768, 2244),
}


@pytest.mark.parametrize("name", sorted(FFN))
def test_fused_ffn(rnd, name):
    m, d, i = FFN[name]
    lp, h = _ffn_layer(rnd, d, i), rnd(1, m, d)
    before = dict(FF.ffn_calls)
    out = _ffn(lp, h)
    assert FF.ffn_calls == {"fused": before["fused"] + 1, "plain": before["plain"]}
    assert out.shape == h.shape and out.dtype == torch.bfloat16
    _close(out, _ffn_twin(lp, h))


def test_gemm_bias_gelu(rnd):
    """The GELU instance of gemm_bias against its plain version, at ragged
    rows and the export's padded width, and against torch's own F.gelu over
    cuBLAS's product (the layer's plain path); other activations raise."""
    import torch.nn.functional as Fn

    m, n, k = 1000, 2248, 768
    a, b = rnd(m, k), rnd(k, n, std=k ** -0.5)
    bias = rnd(n, std=0.5, dtype=torch.float32)
    out = K.gemm_bias(a, b, bias, act="gelu")
    _close(out, F.gemm_bias_plain(a, b, bias, act="gelu"))
    _close(out, Fn.gelu(torch.addmm(bias.to(torch.bfloat16), a, b)))
    with pytest.raises(ValueError, match="activation"):
        K.gemm_bias(a, b, bias, act="relu")


def test_fused_ffn_launches_two_kernels_and_no_library_gemm(rnd):
    """A call that meets the rule: gemm_bias with its GELU and gemm_ln, the
    port's own kernels only (the f32 vectors are read as stored and the
    prepared weights are reused), counted as fused."""
    lp, h = _ffn_layer(rnd, 768, 2244), rnd(2, 40, 768)
    before, launches = FF.ffn_calls["fused"], K.fused_ffn.launches
    names = _kernel_names(lambda: _ffn(lp, h))
    assert FF.ffn_calls["fused"] == before + 2 and K.fused_ffn.launches == launches + 2
    assert len(names) == 2, names
    assert any("gemm_bias_kernel" in n for n in names), names
    assert any("gemm_ln_kernel" in n for n in names), names
    assert all("evlm" in n for n in names), names


@pytest.mark.parametrize("d", [768, 200], ids=["d768_gemm_ln", "d200_plain"])
def test_fused_ffn_follows_the_width_rule(rnd, d):
    """Hidden widths that fit gemm_ln_fits normalise in gemm_ln's epilogue;
    others run the layer's plain path (no kernel of the fused form, counted
    as plain); both agree with the plain twin."""
    lp, h = _ffn_layer(rnd, d, 300), rnd(3, 37, d)
    fits = K.gemm_ln_fits(d)
    assert fits == (d == 768)
    before = dict(FF.ffn_calls)
    names = _kernel_names(lambda: _ffn(lp, h))
    fused = FF.ffn_calls["fused"] - before["fused"]
    assert (fused, FF.ffn_calls["plain"] - before["plain"]) == ((2, 0) if fits else (0, 2))
    assert any("gemm_ln_kernel" in n for n in names) == fits
    assert any("gemm_bias_kernel" in n for n in names) == fits
    _close(_ffn(lp, h), _ffn_twin(lp, h))


@pytest.mark.parametrize("case", ["train", "mlp_z", "graded"])
def test_fused_ffn_bypassed_where_it_cannot_serve(rnd, case):
    """Training, FFN gates and autograd through the call keep the plain
    path: no kernel of the fused form runs, the calls count as plain."""
    lp, h = _ffn_layer(rnd, 768, 2244), rnd(2, 40, 768)
    kw = {}
    if case == "train":
        kw["train"] = True
    elif case == "mlp_z":
        kw["mlp_z"] = torch.rand(2244, device="cuda")
    else:
        lp["output"]["kernel"].requires_grad_(True)
    before = dict(FF.ffn_calls)
    names = _kernel_names(lambda: _ffn(lp, h, **kw))
    assert FF.ffn_calls == {"fused": before["fused"], "plain": before["plain"] + 2}
    assert not any("gemm_bias_kernel" in n or "gemm_ln_kernel" in n for n in names), names


GEMM_BIAS_CASES = {"vit_qkv_m18464_n2304_k768": (18464, 2304, 768, False, torch.float32),
                   "i2t_out_f32_m40960_n768_k768": (40960, 768, 768, True, torch.float32),
                   "bf16_bias_m1000_n320_k512": (1000, 320, 512, False, torch.bfloat16)}


@pytest.mark.parametrize("case", sorted(GEMM_BIAS_CASES))
def test_gemm_bias_without_activation(rnd, case):
    """The projections' instance (no activation, the default) against its
    plain version: bf16 and f32 out, f32 and bf16 vectors."""
    m, n, k, out_f32, vdt = GEMM_BIAS_CASES[case]
    a, b = rnd(m, k), rnd(k, n, std=k ** -0.5)
    bias = rnd(n, std=0.1, dtype=vdt)
    out = K.gemm_bias(a, b, bias, out_f32=out_f32)
    assert out.dtype == (torch.float32 if out_f32 else torch.bfloat16)
    _close(out, F.gemm_bias_plain(a, b, bias, out_f32=out_f32))
