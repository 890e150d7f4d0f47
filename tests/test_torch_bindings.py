"""The C entries of csrc/ and their Python bindings, checked on the CPU.

- Every `extern "C"` entry has a ctypes signature in kernels/build.py with
  the same number and kinds of arguments (a mismatch would pass pointers as
  32-bit ints on the card and fail only there).
- The bare kernel bindings refuse CPU tensors before anything is built.
- fused_mha.cu splits a sublayer into gemm_bias launches and one attn_core
  launch (Q/K/V in one launch for self-attention, K/V in one for cross, the
  group folded into the query rows for grouped cross); the plain versions of
  those two kernels, composed the same way, give the JAX fused kernels'
  result (Pallas interpret mode off the TPU) at atol 3e-5 in f32.
"""

import os
import re

import jax
import numpy as np
import pytest
import torch

from efficientvlm_tpu.ops import attention as JA
from efficientvlm_tpu.ops import pallas_fused_mha as JF
from efficientvlm_tpu_torch.bridge import params_from_numpy
from efficientvlm_tpu_torch.kernels import bindings
from efficientvlm_tpu_torch.kernels.build import CSRC, SIGNATURES
from efficientvlm_tpu_torch.ops import fused_mha as TF

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


def _params(seed, d, heads, de=None):
    p = jax.tree.map(np.asarray, JA.init_attention(jax.random.PRNGKey(seed), d, heads,
                                                   kv_width=de))
    rng = np.random.default_rng(seed)
    for n in p:  # non-zero biases, so every bias add is checked
        p[n]["bias"] = rng.standard_normal(p[n]["bias"].shape).astype(np.float32) * 0.1
    return p


def _compose(tp, x, enc, kb, hz, *, batch, tq, s, self_attn):
    """The launches of fused_mha.cu, with the kernels' plain versions."""
    gemm = TF.gemm_bias_plain
    if self_attn:  # one launch, three GEMMs over x
        q, k, v = (gemm(x, tp[n]["kernel"], tp[n]["bias"]) for n in ("q", "k", "v"))
    else:  # Q over x, then K and V in one launch over the image rows
        q = gemm(x, tp["q"]["kernel"], tp["q"]["bias"])
        k, v = (gemm(enc, tp[n]["kernel"], tp[n]["bias"]) for n in ("k", "v"))
    ctx = TF.attn_core_plain(q, k, v, kb, hz, batch=batch, tq=tq, s=s)
    return gemm(ctx, tp["out"]["kernel"], tp["out"]["bias"])


@pytest.mark.parametrize("kind", ["self", "cross", "grouped"])
def test_device_kernels_compose_the_jax_sublayer(kind):
    rng = np.random.default_rng(4)
    d, heads, t = 128, 2, 13
    de = d if kind == "self" else 192
    bk, g = (2, 3) if kind == "grouped" else (3, 1)
    s = t if kind == "self" else 70  # two key tiles, the second ragged
    p = _params(4, d, heads, None if kind == "self" else de)
    x = rng.standard_normal((bk * g, t, d)).astype(np.float32)
    enc = x if kind == "self" else rng.standard_normal((bk, s, de)).astype(np.float32)
    mask = np.ones((bk, s), np.int32)
    mask[-1, s - s // 3:] = 0
    hz = np.asarray([0.4, 0.9], np.float32)
    kw = dict(num_heads=heads, mask=mask, head_z=hz)
    if kind == "self":
        ref = JF.fused_self_attention(p, x, **kw)
    elif kind == "cross":
        ref = JF.fused_cross_attention(p, x, enc, **kw)
    else:
        ref = JF.fused_cross_attention_grouped(p, x, enc, kv_groups=g, **kw)
    tp = params_from_numpy(p, device="cpu")
    kb = TF._key_bias(bk, s, torch.from_numpy(mask), None, "cpu")
    # the grouped caller folds each group's G*T query rows into one batch row
    out = _compose(tp, torch.from_numpy(x).reshape(-1, d),
                   torch.from_numpy(enc).reshape(-1, de), kb, torch.from_numpy(hz),
                   batch=bk, tq=g * t, s=s, self_attn=kind == "self")
    np.testing.assert_allclose(out.reshape(bk * g, t, d).numpy(), np.asarray(ref),
                               atol=ATOL, rtol=0)


def test_gemm_bias_plain_row_add_repeats_every_period():
    a = torch.randn(7, 16, dtype=torch.float64)
    b = torch.randn(16, 8, dtype=torch.float64)
    row_add = torch.randn(3, 8, dtype=torch.float64)
    out = TF.gemm_bias_plain(a, b, None, row_add, out_f32=True)
    ref = a.float() @ b.float() + row_add.float()[[0, 1, 2, 0, 1, 2, 0]]
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
