"""The FFN sublayer of a post-LN BERT layer,
LN(h + dropout(act(h @ W1 + b1) [* mlp_z] @ W2 + b2)), as one call.

No TPU kernel of the JAX package has this shape: JAX leaves the FFN to XLA,
which fuses the activation, the residual and the LayerNorm around its
GEMMs. `ffn_sublayer` is what models/bert.bert_layer_apply runs for its FFN
block. Where the fused form can compute all that a call asks for (the rule
is `plain_reason`: inference, no FFN gates, no tensor parallelism, float
weights, bf16, a hidden width gemm_ln normalises (bindings.gemm_ln_fits),
BERT's GELU (the epilogue's one activation, bindings.ACTIVATIONS), no
autograd through the call, CUDA tensors) it runs
bindings.fused_ffn (csrc/fused_ffn.cu): gemm_bias with the activation in
its epilogue, then gemm_ln with the residual and the post-LN in its
epilogue, two launches. A CUDA call that meets the rule launches them or
raises. Every other call, and every call on the CPU, runs the plain path:
dense -> act -> [mlp_z] -> dense -> dropout -> add -> layer_norm, as the
layer did before, so the CPU tests hold it to JAX unchanged.

The fused form's weights are prepared once per weight tensor and not at
every call (`prepared`): bf16 copies of W1 [D, I] and W2 [I, D], and b1 as
stored (bf16 or f32), with I zero-padded to a multiple of PAD (64). The export
keeps JAX's widths (pruning/export.py, align_intermediate=1: I = 2,244 and
2,332 in the retrieval evaluation), rows of which TMA cannot read; a padded
unit computes act(0 + 0) = 0 against a zero row of W2, so the function is
the same. A copy lives as long as its source tensor and is made again when
the source changes in place (its version counter) or its storage moves; an
inference tensor, which keeps no version counter, is copied at every call.

The arithmetic of the fused form (its plain twin is `fused_ffn_plain`):
both products accumulate in f32; b1 and the activation are applied in f32
and the intermediate is rounded to bf16 once; b2 and the residual h are
added to the second product in f32 (the plain path rounds the product to
bf16 before the add); the LayerNorm's statistics are f32; bf16 out.

`ffn_calls` counts the calls by the path they took ("fused", "plain").
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.utils.weak import WeakIdKeyDictionary

from ..kernels import bindings
from ..parallel.sharding import tp_enter, tp_exit, tp_group, tp_row, tp_slice
from .attention import graded
from .basic import ACT2FN, dense, dropout, layer_norm
from .fused_mha import gemm_bias_plain, gemm_ln_plain

BF16, F32 = torch.bfloat16, torch.float32
# I is padded to a multiple of 64: rows of whole 128-byte lines, which the
# GEMMs' 128-byte-swizzled TMA boxes read. TMA itself needs only 8 (16-byte
# rows), but on the H100 (chip_smoke.phase_ffn, the rerank's 40,960 rows)
# I = 2,244 took 0.751 ms padded to 2,304 against 0.873 ms at 2,248; 128
# gave 64's times at 2,332 and was 2% slower at 3,000
PAD = 64

ffn_calls = {"fused": 0, "plain": 0}


def padded_width(i: int) -> int:
    return -(-i // PAD) * PAD


def _padded(t: torch.Tensor, dim: int, width: int, dtype) -> torch.Tensor:
    """t as `dtype`, contiguous, with dimension `dim` zero-padded to `width`."""
    if t.shape[dim] == width:
        return t.to(dtype).contiguous()
    shape = list(t.shape)
    shape[dim] = width
    out = t.new_zeros(shape, dtype=dtype)
    out.narrow(dim, 0, t.shape[dim]).copy_(t)
    return out


_W1, _B1, _W2 = WeakIdKeyDictionary(), WeakIdKeyDictionary(), WeakIdKeyDictionary()


def _cached(cache: WeakIdKeyDictionary, src: torch.Tensor, make) -> torch.Tensor:
    """make(src), kept while src lives and is unchanged: the same version
    counter, storage and shape. A result that is src itself is not kept (no
    copy to save, and the cache must hold no reference to its key)."""
    if src.is_inference():
        return make(src)
    stamp = (src._version, src.data_ptr(), tuple(src.shape))
    hit = cache.get(src)
    if hit is not None and hit[0] == stamp:
        return hit[1]
    out = make(src)
    if out.data_ptr() != src.data_ptr():
        cache[src] = (stamp, out)
    return out


def prepared(inter: dict, output: dict) -> tuple:
    """(W1 [D, Ip] bf16, b1 [Ip] as stored or None, W2 [Ip, D] bf16) of an
    FFN's params {"kernel", "bias"} x 2, Ip = padded_width(I), made once per
    source tensor (see the module note)."""
    ip = padded_width(inter["kernel"].shape[1])
    w1 = _cached(_W1, inter["kernel"], lambda t: _padded(t, 1, ip, BF16))
    b = inter.get("bias")
    b1 = None if b is None else _cached(
        _B1, b, lambda t: _padded(t, 0, ip, t.dtype if t.dtype in (BF16, F32) else F32))
    w2 = _cached(_W2, output["kernel"], lambda t: _padded(t, 0, ip, BF16))
    return w1, b1, w2


def plain_reason(lp: dict, h: torch.Tensor, *, act: str, mlp_z=None, train: bool = False,
                 dtype=None, impl: str = "fused") -> Optional[str]:
    """Why the FFN sublayer of layer params `lp` over h takes the plain
    path, or None when it fuses. Reads the inputs only; the device last, so
    that on the CPU each other reason shows."""
    if impl != "fused":
        return "impl"
    if train:
        return "train"
    if mlp_z is not None:
        return "mlp_z"
    if tp_group() is not None:
        return "tensor_parallel"
    if bindings.ACTIVATIONS.get(act, 0) == 0:
        return "activation"
    if "kernel" not in lp["intermediate"] or "kernel" not in lp["output"]:
        return "quantized"
    if h.dtype != BF16 or dtype not in (None, BF16):
        return "dtype"
    if not bindings.gemm_ln_fits(h.shape[-1]):
        return "width"
    if graded(h, lp["intermediate"], lp["output"], lp["output_ln"]):
        return "graded"
    if not h.is_cuda:
        return "device"
    return None


def fused_ffn_plain(x, w1, b1, w2, b2, gamma, beta, eps: float, *, act: str):
    """Plain version of bindings.fused_ffn: gemm_bias_plain with the
    activation (f32, rounded to x's dtype once), then gemm_ln_plain with b2
    and the residual x (f32 sums and statistics, rounded to x's dtype)."""
    inter = gemm_bias_plain(x, w1, b1, act=act)
    return gemm_ln_plain(inter, w2, gamma, beta, eps, bias=b2, residual=x)


def ffn_sublayer(lp: dict, h: torch.Tensor, *, act: str, eps: float, mlp_z=None,
                 dropout_rate: float = 0.0, train: bool = False, generator=None, dtype=None,
                 impl: str = "fused") -> torch.Tensor:
    """The FFN block of a post-LN BERT layer over lp's "intermediate",
    "output" and "output_ln": LN(h + dropout(act(h @ W1 + b1) [* mlp_z] @
    W2 + b2)), in h's dtype; act names ops/basic.ACT2FN's activation. The
    fused form where plain_reason finds nothing against it, else the plain
    path (see the module note)."""
    if plain_reason(lp, h, act=act, mlp_z=mlp_z, train=train, dtype=dtype, impl=impl) is None:
        w1, b1, w2 = prepared(lp["intermediate"], lp["output"])
        ln = lp["output_ln"]
        out = bindings.fused_ffn(h.reshape(-1, h.shape[-1]).contiguous(), w1, b1, w2,
                                 bindings.as_stored(lp["output"].get("bias")),
                                 bindings.as_stored(ln["scale"]), bindings.as_stored(ln["bias"]),
                                 eps, act=act)
        ffn_calls["fused"] += 1
        return out.reshape(h.shape)
    ffn_calls["plain"] += 1
    inter = ACT2FN[act](dense(lp["intermediate"], tp_enter(h), dtype=dtype))
    if mlp_z is not None:
        inter = inter * tp_slice(mlp_z).to(inter.dtype)
    out = dropout(tp_exit(dense(tp_row(lp["output"]), inter, dtype=dtype)), dropout_rate,
                  generator=generator, train=train)
    return layer_norm(lp["output_ln"], h + out, eps=eps)
