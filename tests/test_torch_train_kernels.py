"""Port parity of the training forms of TPU kernels #1-#3 against the JAX
package, on the CPU, in f32: `return_probs=True` / `differentiable=True` of
fused_self_attention and fused_cross_attention and the differentiable
fused_patch_embed, against JAX's custom_vjp forms (Pallas in interpret
mode) through jax.vjp with the same cotangents on the output and on the
maps. Width 128 with 2 heads, so the JAX dispatchers take their kernels.
Also: the autograd Functions that wrap the CUDA kernels, run here with the
kernel call replaced by its plain version (their backward plumbing is
otherwise reached only on the card), the ViT's crop of an image whose sides
the patch does not tile (against JAX's VALID-convolution path), and the
routing that keeps an operand under autograd away from a kernel without a
backward. Tolerances: 2e-5 on outputs and probabilities, 3e-5 on gradients
(scaled by the largest gradient where those exceed 1), as the kernel parity
tests hold the forwards."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficientvlm_tpu import config as jcfg
from efficientvlm_tpu.models import vit as JV
from efficientvlm_tpu.ops import attention as JA
from efficientvlm_tpu.ops import pallas_fused_mha as JF
from efficientvlm_tpu.ops.pallas_patch_embed import fused_patch_embed as j_patch_embed
from efficientvlm_tpu_torch import config as tcfg
from efficientvlm_tpu_torch.bridge import params_from_numpy
from efficientvlm_tpu_torch.models import vit as TV
from efficientvlm_tpu_torch.ops import attention as TA
from efficientvlm_tpu_torch.ops import fused_mha as TF
from efficientvlm_tpu_torch.ops import patch_embed as TP

torch.set_num_threads(1)
OUT_ATOL, GRAD_ATOL = 2e-5, 3e-5
LEAVES = [(n, l) for n in ("q", "k", "v", "out") for l in ("kernel", "bias")]


def _t(x, grad=False):
    return torch.from_numpy(np.array(x, np.float32)).requires_grad_(grad)


def _close(port, ref, atol):
    ref = np.asarray(ref)
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(port.detach().numpy(), ref, atol=atol * scale, rtol=0)


def _attn(seed, d, h, kv_width=None):
    p = jax.tree.map(np.asarray, JA.init_attention(jax.random.PRNGKey(seed), d, h,
                                                   kv_width=kv_width))
    rng = np.random.default_rng(seed)
    for n in p:
        p[n]["bias"] = rng.standard_normal(p[n]["bias"].shape).astype(np.float32) * 0.1
    return p


def _mask(b, s):
    m = np.ones((b, s), np.int32)
    m[-1, s - s // 3:] = 0
    return m


def _torch_params(p):
    return {n: {l: _t(p[n][l], grad=True) for l in ("kernel", "bias")} for n in p}


@pytest.mark.parametrize("kind", ["self", "cross"])
def test_training_forms_match_jax_vjp(kind):
    """Outputs, maps and the gradients of every weight, bias, hidden, encoder
    hidden and head_z, with cotangents on both outputs."""
    rng = np.random.default_rng(11)
    d, de, b, t = 128, 192, 2, 9
    s = t if kind == "self" else 13
    p = _attn(11, d, 2, kv_width=None if kind == "self" else de)
    x = rng.standard_normal((b, t, d)).astype(np.float32)
    enc = rng.standard_normal((b, s, de)).astype(np.float32)
    mask = _mask(b, s)
    hz = np.asarray([0.4, 0.9], np.float32)
    ct_out = rng.standard_normal((b, t, d)).astype(np.float32)
    ct_probs = rng.standard_normal((b, 2, t, s)).astype(np.float32)

    def jf(params, hidden, e, z):
        if kind == "self":
            return JF.fused_self_attention(params, hidden, num_heads=2, mask=mask, head_z=z,
                                           return_probs=True, differentiable=True)
        return JF.fused_cross_attention(params, hidden, e, num_heads=2, mask=mask, head_z=z,
                                        return_probs=True, differentiable=True)

    (ref_out, ref_probs), vjp = jax.vjp(jf, p, jnp.asarray(x), jnp.asarray(enc),
                                       jnp.asarray(hz))
    g_p, g_x, g_e, g_z = vjp((jnp.asarray(ct_out), jnp.asarray(ct_probs)))

    tp, tx, te, tz = _torch_params(p), _t(x, True), _t(enc, True), _t(hz, True)
    if kind == "self":
        out, probs = TF.fused_self_attention(tp, tx, num_heads=2, mask=_t(mask), head_z=tz,
                                             return_probs=True, differentiable=True)
    else:
        out, probs = TF.fused_cross_attention(tp, tx, te, num_heads=2, mask=_t(mask),
                                              head_z=tz, return_probs=True,
                                              differentiable=True)
    _close(out, ref_out, OUT_ATOL)
    _close(probs, ref_probs, OUT_ATOL)
    assert probs.dtype == torch.float32 and tuple(probs.shape) == (b, 2, t, s)
    torch.autograd.backward([out, probs], [_t(ct_out), _t(ct_probs)])
    for n, l in LEAVES:
        _close(tp[n][l].grad, g_p[n][l], GRAD_ATOL)
    _close(tx.grad, g_x, GRAD_ATOL)
    _close(tz.grad, g_z, GRAD_ATOL)
    if kind == "cross":
        _close(te.grad, g_e, GRAD_ATOL)


def _patch_params(rng, d, p, n):
    return {
        "patch_embed": {"kernel": rng.standard_normal((p, p, 3, d)).astype(np.float32) * 0.1},
        "class_embedding": rng.standard_normal(d).astype(np.float32),
        "pos_embed": {"embedding": rng.standard_normal((n + 1, d)).astype(np.float32)},
        "pre_ln": {"scale": rng.uniform(0.5, 1.5, d).astype(np.float32),
                   "bias": rng.standard_normal(d).astype(np.float32)},
    }


def test_patch_embed_training_form_matches_jax_vjp():
    rng = np.random.default_rng(12)
    d, p, res = 128, 4, 16
    n = (res // p) ** 2
    params = _patch_params(rng, d, p, n)
    images = rng.standard_normal((2, res, res, 3)).astype(np.float32)
    ct = rng.standard_normal((2, n + 1, d)).astype(np.float32)
    ref, vjp = jax.vjp(lambda prm, img: j_patch_embed(prm, img, patch_size=p, vision_width=d),
                       params, jnp.asarray(images))
    g_p, g_img = vjp(jnp.asarray(ct))

    tp = jax.tree.map(lambda a: _t(a, True), params)
    timg = _t(images, True)
    out = TP.fused_patch_embed(tp, timg, patch_size=p, differentiable=True)
    _close(out, ref, OUT_ATOL)
    out.backward(_t(ct))
    for ref_g, got in zip(jax.tree.leaves(g_p), jax.tree.leaves(
            jax.tree.map(lambda a: a.grad, tp, is_leaf=lambda a: isinstance(a, torch.Tensor)))):
        _close(got, ref_g, GRAD_ATOL)
    _close(timg.grad, g_img, GRAD_ATOL)


@pytest.mark.parametrize("kind", ["self", "cross", "self_no_gates"])
def test_attention_function_backward_plumbing(kind, monkeypatch):
    """_AttentionFn (the wrapper's CUDA training form) with its kernel call
    replaced by the plain version: the gradients it returns through its
    recompute equal plain autograd's, for every input that needs one."""
    torch.manual_seed(0)
    d, b, t, s, h = 128, 2, 7, 11, 2
    cross = kind == "cross"

    def fake_kernel(params, hidden, enc, kb2, head_z, num_heads, return_probs):
        with torch.no_grad():
            return TF.cross_attention_plain(params, hidden, hidden if enc is None else enc, kb2,
                                            TF._gates(num_heads, head_z, hidden.device),
                                            num_heads, return_probs)

    monkeypatch.setattr(TF, "_attention_cuda", fake_kernel)
    leaves = [torch.randn(d, d) * 0.1 if l == "kernel" else torch.randn(d) * 0.1
              for _, l in LEAVES]
    x, enc = torch.randn(b, t, d), torch.randn(b, s, d)
    kb2 = TF._key_bias(b, s if cross else t, torch.from_numpy(_mask(b, s if cross else t)),
                       None, "cpu")
    hz = None if kind == "self_no_gates" else torch.tensor([0.3, 0.8])
    ct = [torch.randn(b, t, d), torch.randn(b, h, t, s if cross else t)]

    def run(fn):
        ins = [a.clone().requires_grad_(True) for a in leaves]
        xi = x.clone().requires_grad_(True)
        ei = enc.clone().requires_grad_(True) if cross else None
        zi = None if hz is None else hz.clone().requires_grad_(True)
        outs = fn(ins, xi, ei, zi)
        torch.autograd.backward(list(outs), ct)
        return outs, [a.grad for a in ins] + [xi.grad] + ([ei.grad] if cross else []) + (
            [] if zi is None else [zi.grad])

    got_outs, got = run(lambda ins, xi, ei, zi: TF._AttentionFn.apply(h, True, kb2, zi, xi, ei,
                                                                      *ins))
    ref_outs, ref = run(lambda ins, xi, ei, zi: TF.cross_attention_plain(
        TF._tree(ins), xi, xi if ei is None else ei, kb2, TF._gates(h, zi, "cpu"), h, True))
    for a, r in zip(list(got_outs) + got, list(ref_outs) + ref):
        torch.testing.assert_close(a, r, atol=1e-6, rtol=1e-5)


def test_patch_embed_function_backward_plumbing(monkeypatch):
    """_PatchEmbedFn with its kernel call replaced by the plain version: its
    gradients (no patch bias, as the CLIP ViT has) equal plain autograd's."""
    rng = np.random.default_rng(13)
    d, p, res = 128, 4, 12
    params = _patch_params(rng, d, p, (res // p) ** 2)
    monkeypatch.setattr(TP, "_patch_embed_cuda", lambda prm, img, ps, eps, dt: (
        TP.patch_embed_plain(prm, img, patch_size=ps, eps=eps, dtype=dt)))
    ct = _t(rng.standard_normal((2, 10, d)))
    img = _t(rng.standard_normal((2, res, res, 3)))

    def run(fn):
        tp = jax.tree.map(lambda a: _t(a, True), params)
        out = fn(tp)
        out.backward(ct)
        return out, [tp["patch_embed"]["kernel"].grad, tp["class_embedding"].grad,
                     tp["pos_embed"]["embedding"].grad, tp["pre_ln"]["scale"].grad,
                     tp["pre_ln"]["bias"].grad]

    got_out, got = run(lambda tp: TP._PatchEmbedFn.apply(
        p, 1e-5, torch.float32, img, *[tp[n] if l is None else tp[n].get(l)
                                       for n, l in TP._LEAVES]))
    ref_out, ref = run(lambda tp: TP.patch_embed_plain(tp, img, patch_size=p))
    for a, r in zip([got_out] + got, [ref_out] + ref):
        torch.testing.assert_close(a, r, atol=1e-6, rtol=1e-5)


def test_vit_crops_an_image_the_patch_does_not_tile():
    """40 x 36 at patch 8: JAX's vit_apply runs its VALID convolution (the
    fused stage takes tiled images only) and adds pos[:1+20]; the port crops
    to 40 x 32 and takes the same rows, on its fused path."""
    vision = dict(vision_width=64, num_attention_heads=2, intermediate_size=128,
                  num_hidden_layers=1, image_res=40, patch_size=8)
    jv = jcfg.VisionConfig.create(**vision)
    jp = jax.tree.map(np.asarray, JV.init_vit(jax.random.PRNGKey(3), jv))
    images = np.random.default_rng(14).standard_normal((2, 40, 36, 3)).astype(np.float32)
    ref = jax.jit(lambda p, x: JV.vit_apply(p, x, jv, impl="fused")["last_hidden"])(jp, images)
    out = TV.vit_apply(params_from_numpy(jp, device="cpu"), _t(images),
                       tcfg.VisionConfig.create(**vision), impl="fused")["last_hidden"]
    assert tuple(out.shape) == (2, 1 + 5 * 4, 64)
    _close(out, ref, OUT_ATOL)


def test_no_kernel_without_a_backward_under_autograd():
    """multi_head_attention(impl="fused") takes the flash core only when it
    computes all that is asked: no probs, no active dropout, no autograd."""
    q = torch.zeros(1, 1, 2, 32)
    g = torch.Generator().manual_seed(0)
    assert TA._kernel_core("fused", False, 0.0, False, None, q)
    assert not TA._kernel_core("plain", False, 0.0, False, None, q)
    assert not TA._kernel_core("fused", True, 0.0, False, None, q)
    assert not TA._kernel_core("fused", False, 0.1, True, g, q)
    assert TA._kernel_core("fused", False, 0.1, True, None, q)  # no generator: no dropout
    assert not TA._kernel_core("fused", False, 0.0, False, None, q.requires_grad_(True))
    with torch.no_grad():
        assert TA._kernel_core("fused", False, 0.0, False, None, q)
