"""The C entries of csrc/ and their Python bindings, checked on the CPU.

- Every `extern "C"` entry has a ctypes signature in kernels/build.py with
  the same number and kinds of arguments (a mismatch would pass pointers as
  32-bit ints on the card and fail only there).
- The bare kernel bindings refuse CPU tensors before anything is built.
- fused_mha.cu splits a sublayer into gemm_bias launches and one attention
  core launch (Q/K/V in one launch for self-attention, K/V in one for cross,
  the group folded into the query rows for grouped cross), and with the
  grouped sublayer's LayerNorm ends in gemm_ln (the residual + post-LN in
  the output projection's epilogue); patch_embed.cu is gemm_ln gathering
  the patches from the image, with the positional rows, the row mapping
  behind each CLS row and the CLS rows. The plain versions of those kernels
  (attn_core_plain stands for both attention cores: they compute the same
  function), composed the same way, give the JAX fused kernels' result
  (Pallas interpret mode off the TPU) at atol 3e-5 in f32.
- The shape rules that choose between device kernels, on both sides.
"""

import os
import re

import jax
import numpy as np
import pytest
import torch

from efficientvlm_tpu.ops import attention as JA
from efficientvlm_tpu.ops import pallas_fused_mha as JF
from efficientvlm_tpu.ops.pallas_patch_embed import fused_patch_embed as j_patch_embed
from efficientvlm_tpu_torch.bridge import params_from_numpy
from efficientvlm_tpu_torch.kernels import bindings
from efficientvlm_tpu_torch.kernels.build import CSRC, SIGNATURES
from efficientvlm_tpu_torch.ops import fused_mha as TF
from efficientvlm_tpu_torch.ops import patch_embed as TP

torch.set_num_threads(1)
ATOL = 3e-5


def _c_entries():
    """{name: [ctypes kind per parameter]} of every extern "C" entry."""
    entries = {}
    for name in sorted(os.listdir(CSRC)):
        with open(os.path.join(CSRC, name)) as f:
            src = f.read()
        for fn, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src):
            kinds = []
            for p in params.split(","):
                p = p.strip()
                kinds.append("P" if "*" in p else "F" if p.startswith("float") else "I")
            entries[fn] = kinds
    return entries


def _kind(ctype):
    return {"c_void_p": "P", "c_int": "I", "c_float": "F"}[ctype.__name__]


def test_signatures_match_the_c_entries():
    entries = _c_entries()
    assert set(entries) == set(SIGNATURES)
    for fn, kinds in entries.items():
        assert [_kind(t) for t in SIGNATURES[fn]] == kinds, fn


def test_bare_kernel_bindings_refuse_cpu_tensors():
    x = torch.zeros(8, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        bindings.gemm_bias(x, torch.zeros(64, 64, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        bindings.attn_core(x, x, x, torch.zeros(1, 8), torch.ones(2), batch=1, tq=8, s=8)
    with pytest.raises(ValueError, match="multiples of 8"):
        bindings.gemm_bias(x, torch.zeros(64, 60, dtype=torch.bfloat16))
    w = torch.zeros(64, 128, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        bindings.gemm_ln(x, w, torch.ones(128), torch.zeros(128), 1e-5)
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        bindings.attn_wgmma(x, x, x, torch.zeros(1, 8), torch.ones(1), batch=1, tq=8, s=8)
    q = torch.zeros(8, 128, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        bindings.attn_probs(q, q, q, torch.zeros(1, 8), torch.ones(2), batch=1, tq=8, s=8)
    with pytest.raises(ValueError, match="rows a block"):
        bindings._attn_probs_tile(q, q, q, torch.zeros(1, 8), torch.ones(2), 1, 8, 8, 24, 1)
    with pytest.raises(ValueError, match="rows a block"):
        bindings._attn_probs_tile(q, q, q, torch.zeros(1, 8), torch.ones(2), 1, 8, 8, 64, 5)
    with pytest.raises(ValueError, match="heads of 64"):
        bindings.attn_probs(x, x, x, torch.zeros(1, 8), torch.ones(2), batch=1, tq=8, s=8)
    with pytest.raises(ValueError, match="a multiple of 128"):
        bindings.gemm_ln(x, torch.zeros(64, 200, dtype=torch.bfloat16), torch.ones(200),
                         torch.zeros(200), 1e-5)


def _params(seed, d, heads, de=None):
    p = jax.tree.map(np.asarray, JA.init_attention(jax.random.PRNGKey(seed), d, heads,
                                                   kv_width=de))
    rng = np.random.default_rng(seed)
    for n in p:  # non-zero biases, so every bias add is checked
        p[n]["bias"] = rng.standard_normal(p[n]["bias"].shape).astype(np.float32) * 0.1
    return p


def _compose(tp, x, enc, kb, hz, *, batch, tq, s, self_attn, ln=None):
    """The launches of fused_mha.cu, with the kernels' plain versions."""
    gemm = TF.gemm_bias_plain
    if self_attn:  # one launch, three GEMMs over x
        q, k, v = (gemm(x, tp[n]["kernel"], tp[n]["bias"]) for n in ("q", "k", "v"))
    else:  # Q over x, then K and V in one launch over the image rows
        q = gemm(x, tp["q"]["kernel"], tp["q"]["bias"])
        k, v = (gemm(enc, tp[n]["kernel"], tp[n]["bias"]) for n in ("k", "v"))
    ctx = TF.attn_core_plain(q, k, v, kb, hz, batch=batch, tq=tq, s=s)
    if ln is not None:  # gemm_ln: the residual x and the post-LN in the epilogue
        return TF.gemm_ln_plain(ctx, tp["out"]["kernel"], ln["scale"], ln["bias"], 1e-12,
                                bias=tp["out"]["bias"], residual=x)
    return gemm(ctx, tp["out"]["kernel"], tp["out"]["bias"])


def _patch_embed_case():
    """patch_embed.cu as gemm_ln composes it: the gathered patches (the
    plain im2col) @ w + bias + pos[1 + n] (row_add of period Np), each image's
    rows placed behind its CLS row (group Np, stride Np + 1, offset 1), and
    the CLS rows LN(cls + pos[0]); against the JAX fused kernel. Patch 8:
    the CUDA gather's smallest."""
    rng = np.random.default_rng(5)
    d, p, res, b = 128, 8, 24, 2
    n = (res // p) ** 2
    params = {
        "patch_embed": {"kernel": rng.standard_normal((p, p, 3, d)).astype(np.float32) * 0.05,
                        "bias": rng.standard_normal(d).astype(np.float32) * 0.1},
        "class_embedding": rng.standard_normal(d).astype(np.float32),
        "pos_embed": {"embedding": rng.standard_normal((n + 1, d)).astype(np.float32)},
        "pre_ln": {"scale": rng.uniform(0.5, 1.5, d).astype(np.float32),
                   "bias": rng.standard_normal(d).astype(np.float32)},
    }
    images = rng.standard_normal((b, res, res, 3)).astype(np.float32)
    ref = j_patch_embed(params, images, patch_size=p, vision_width=d)
    tp = params_from_numpy(params, device="cpu")
    patches = TP._im2col(torch.from_numpy(images), p, torch.float32).reshape(b * n, -1)
    out = torch.full((b, n + 1, d), float("nan"))
    TF.gemm_ln_plain(patches, tp["patch_embed"]["kernel"].reshape(-1, d), tp["pre_ln"]["scale"],
                     tp["pre_ln"]["bias"], 1e-5, bias=tp["patch_embed"]["bias"],
                     row_add=tp["pos_embed"]["embedding"][1:], out=out.view(-1, d), group=n,
                     out_group_stride=n + 1, out_offset=1)
    out[:, 0] = TP._cls_row(tp, 1e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


@pytest.mark.parametrize("kind", ["self", "cross", "grouped", "grouped_ln", "patch_embed"])
def test_device_kernels_compose_the_jax_sublayer(kind):
    if kind == "patch_embed":
        return _patch_embed_case()
    rng = np.random.default_rng(4)
    d, heads, t = 128, 2, 13
    de = d if kind == "self" else 192
    grouped = kind.startswith("grouped")
    bk, g = (2, 3) if grouped else (3, 1)
    s = t if kind == "self" else 70  # two key tiles, the second ragged
    p = _params(4, d, heads, None if kind == "self" else de)
    x = rng.standard_normal((bk * g, t, d)).astype(np.float32)
    enc = x if kind == "self" else rng.standard_normal((bk, s, de)).astype(np.float32)
    mask = np.ones((bk, s), np.int32)
    mask[-1, s - s // 3:] = 0
    hz = np.asarray([0.4, 0.9], np.float32)
    kw = dict(num_heads=heads, mask=mask, head_z=hz)
    ln = {"scale": rng.uniform(0.5, 1.5, d).astype(np.float32),
          "bias": rng.standard_normal(d).astype(np.float32)} if kind == "grouped_ln" else None
    if kind == "self":
        ref = JF.fused_self_attention(p, x, **kw)
    elif kind == "cross":
        ref = JF.fused_cross_attention(p, x, enc, **kw)
    else:
        ref = JF.fused_cross_attention_grouped(p, x, enc, kv_groups=g, ln_params=ln, **kw)
    tp = params_from_numpy(p, device="cpu")
    kb = TF._key_bias(bk, s, torch.from_numpy(mask), None, "cpu")
    # the grouped caller folds each group's G*T query rows into one batch row
    out = _compose(tp, torch.from_numpy(x).reshape(-1, d),
                   torch.from_numpy(enc).reshape(-1, de), kb, torch.from_numpy(hz),
                   batch=bk, tq=g * t, s=s, self_attn=kind == "self",
                   ln=None if ln is None else params_from_numpy(ln, device="cpu"))
    np.testing.assert_allclose(out.reshape(bk * g, t, d).numpy(), np.asarray(ref),
                               atol=ATOL, rtol=0)


def test_gemm_bias_plain_row_add_repeats_every_period():
    a = torch.randn(7, 16, dtype=torch.float64)
    b = torch.randn(16, 8, dtype=torch.float64)
    row_add = torch.randn(3, 8, dtype=torch.float64)
    out = TF.gemm_bias_plain(a, b, None, row_add, out_f32=True)
    ref = a.float() @ b.float() + row_add.float()[[0, 1, 2, 0, 1, 2, 0]]
    torch.testing.assert_close(out, ref, rtol=0, atol=0)


@pytest.mark.parametrize("rule,arg,fits", [
    ("gemm_ln_fits", 768, True), ("gemm_ln_fits", 128, True), ("gemm_ln_fits", 1024, True),
    ("gemm_ln_fits", 200, False), ("gemm_ln_fits", 32, False), ("gemm_ln_fits", 1152, False),
    ("wgmma_core_fits", (64, True), True), ("wgmma_core_fits", (32, True), False),
    ("wgmma_core_fits", (128, True), False), ("wgmma_core_fits", (64, False), False),
    ("patch_gather_fits", 16, True), ("patch_gather_fits", 8, True),
    ("patch_gather_fits", 4, False), ("patch_gather_fits", 14, False)])
def test_shape_rules_pick_the_device_kernel(rule, arg, fits):
    """Each rule that keeps a shape on an older route, on both sides:
    gemm_ln's cluster spans D / 128 blocks (at most 8); the wgmma core is
    the grouped sublayer's at head dim 64; the gather reads 16-byte pieces
    of a patch row (P*3 % 8 == 0)."""
    args = arg if isinstance(arg, tuple) else (arg,)
    assert getattr(bindings, rule)(*args) is fits


@pytest.mark.parametrize("head_dim,tq,s,rows,warps", [
    (64, 577, 577, 64, 3), (32, 577, 577, 0, 0), (128, 577, 577, 0, 0),
    (64, 197, 197, 128, 2), (64, 901, 901, 32, 5),
    (64, 40, 40, 48, 1), (64, 40, 577, 48, 5), (64, 40, 901, 32, 5), (64, 30, 577, 32, 5),
    (64, 16, 40, 16, 1), (64, 17, 40, 32, 1), (64, 1, 1, 16, 1),
    (64, 577, 64, 128, 1), (64, 577, 65, 128, 1), (64, 577, 256, 128, 2),
    (64, 577, 257, 128, 1), (64, 40, 197, 48, 3), (64, 577, 640, 64, 3), (64, 577, 641, 48, 5),
    (64, 577, 832, 48, 3), (64, 577, 833, 32, 5), (64, 577, 1152, 32, 4),
    (64, 577, 1153, 16, 5), (64, 37, 2944, 16, 1), (64, 37, 2945, 0, 0)])
def test_probs_tile_picks_the_probs_core(head_dim, tq, s, rows, warps):
    """The probs form takes attn_probs at head dim 64 (else attn_core's two
    sweeps), as many 16-row groups as tq needs (up to 128 rows) with at least
    8 consumer warps, each group up to 5 warps and one a key tile, at 4 key
    tiles or fewer the most warps that let two blocks share an SM; on each
    side of every limit: the head dim, tq a multiple of 16 or one row past
    it, one key tile or two (s 64 / 65), four or five (256 / 257, where two
    blocks an SM stop being preferred), the key tile counts that move the
    rows (640 / 641, 832 / 833, 1,152 / 1,153) and the staging limit (2,944
    keys in one 16-row block of one warp)."""
    assert bindings.probs_tile(head_dim, tq, s) == (rows, warps)
    if rows:
        nt = -(-s // 64)
        assert bindings.probs_tile_fits(rows, s, warps)
        assert warps <= min(bindings.PROBS_GROUP_WARPS, nt)
        assert rows // 16 * warps <= bindings.PROBS_MAX_WARPS


def test_probs_smem_counts_the_staged_rows():
    """attn_probs.cuh's smem_bytes: a row's staged f32 e (256 bytes a 64-key
    tile) and tile maxima (4 a tile), its Q (128) and its warps' (max, sum)
    (8 a warp of its group), the key bias (256 a tile), the K/V rings of 8
    KB tiles with two barriers each (one ring a warp of a group: 3 slots at
    up to 2 warps, else 2), Q's barrier, and 1,024 bytes to align."""
    for rows, s, warps, slots in ((64, 577, 3, 6), (128, 197, 2, 6), (32, 901, 5, 10),
                                  (48, 40, 1, 3), (16, 2944, 1, 3)):
        nt = -(-s // 64)
        assert bindings.probs_smem(rows, s, warps) == \
            rows * (nt * 256 + nt * 4 + 128 + 8 * warps) + nt * 256 + \
            slots * (64 * 64 * 2 + 16) + 8 + 1024
    assert not bindings.probs_tile_fits(16, 2945, 1)
    assert not bindings.probs_tile_fits(48, 577, 6)  # 18 warps
    assert not bindings.probs_tile_fits(24, 577, 1)


def test_gemm_ln_plain_places_rows_behind_each_group_head():
    a, b = torch.randn(7, 16, dtype=torch.float64), torch.randn(16, 8, dtype=torch.float64)
    gamma, beta = torch.rand(8) + 0.5, torch.randn(8)
    dense = TF.gemm_ln_plain(a, b, gamma, beta, 1e-5)
    out = torch.zeros(3 * 5, 8, dtype=torch.float64)
    TF.gemm_ln_plain(a, b, gamma, beta, 1e-5, out=out, group=3, out_group_stride=5, out_offset=1)
    placed = [1, 2, 3, 6, 7, 8, 11]
    torch.testing.assert_close(out[placed], dense, rtol=0, atol=0)
    assert not out[[0, 4, 5, 9, 10, 12, 13, 14]].any()


def test_small_vectors_are_passed_as_stored():
    bf = torch.zeros(4, dtype=torch.bfloat16)
    assert bindings.as_stored(bf) is bf
    assert bindings.as_stored(torch.zeros(4, dtype=torch.float16)).dtype == torch.float32
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        bindings._vecs([("bias", torch.zeros(4, dtype=torch.float16), (4,))])
