"""The port's CUDA kernels against their plain versions, on the card, in
bf16, at small shapes; each wrapper counts one launch per call. Imports no
jax, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Without a CUDA device every test skips."""

import pytest
import torch

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


def _agree(wrapper, run, plain):
    before = wrapper.launches
    out = run().float()
    assert wrapper.launches == before + 1
    ref = plain().float()
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    # 4 bf16 ulps at the output's largest magnitude (see chip_smoke.phase_kernels)
    assert (out - ref).abs().max().item() <= 4 * 2 ** -8 * ref.abs().max().item()


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


def test_cuda_tensors_never_fall_back(rnd):
    prm, x = _attn(rnd, 128, 128), rnd(2, 5, 128).float()
    with pytest.raises(TypeError, match="bfloat16"):
        F.fused_self_attention(prm, x, num_heads=2)
