"""Post-training int8 quantization for serving (port of
efficientvlm_tpu/ops/quant.py). Both modes are symmetric per output channel:

- ``w8``: weight-only; the int8 kernel is dequantized into the compute dtype
  and the product runs as a float matmul, so the activations keep their
  precision.
- ``w8a8``: the weights int8 and the activations quantized per row at run
  time (abs-max in bf16, as JAX's pipeline does); the int8 x int8 -> int32
  product is `torch._int_mm` (cuBLASLt's int8 GEMM on the card), its rows
  padded to a multiple of 8 and at least 32, which the card's int8 GEMM
  requires.

Format: `quantize_params` rewrites each eligible dense dict {"kernel" [in,
out], "bias"?} into {"kernel_q8" | "kernel_q8a8": int8, "scale": f32 [out],
"bias"?}; the key names carry the mode. `ops.basic.dense` recognises the
format, so every plain forward runs quantized; the fused attention
sublayers, whose kernels read bf16 weights, step aside for a quantized layer
(`is_fusable`). LayerNorms, embeddings, the patch embedding and small heads
stay float.
"""

from __future__ import annotations

import torch

QUANT_KEYS = ("kernel_q8", "kernel_q8a8")


def quantize_dense(p: dict, *, mode: str = "w8") -> dict:
    """Per-output-channel symmetric int8 quantization of one dense dict."""
    if mode not in ("w8", "w8a8"):
        raise ValueError(f"mode {mode!r}: 'w8' or 'w8a8'")
    k = p["kernel"].float()
    amax = k.abs().amax(0)
    scale = torch.where(amax > 0, amax, torch.ones_like(amax)) / 127.0
    kq = torch.clamp(torch.round(k / scale), -127, 127).to(torch.int8)
    out = {("kernel_q8a8" if mode == "w8a8" else "kernel_q8"): kq, "scale": scale}
    if "bias" in p:
        out["bias"] = p["bias"]
    return out


def quantize_params(params, *, mode: str = "w8", min_dim: int = 256):
    """The tree with every 2-D dense kernel whose smaller side is at least
    `min_dim` quantized (the guard keeps tiny heads, such as the 2-way ITM
    output, in float)."""

    def walk(node):
        if isinstance(node, dict):
            k = node.get("kernel")
            if isinstance(k, torch.Tensor) and k.ndim == 2 and min(k.shape) >= min_dim:
                return quantize_dense(node, mode=mode)
            return {key: walk(v) for key, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return node

    return walk(params)


def is_fusable(attn_params: dict) -> bool:
    """Whether an attention block's projections are float (the fused
    sublayer kernels read bf16 weights; int8 ones run the plain path)."""
    return all("kernel" in attn_params[name] for name in ("q", "k", "v", "out"))


def out_width(p: dict) -> int:
    """A dense dict's output width, quantized or not."""
    for key in ("kernel",) + QUANT_KEYS:
        if key in p:
            return p[key].shape[1]
    raise KeyError("a dense dict holds kernel, kernel_q8 or kernel_q8a8")


def _int8_matmul(xq: torch.Tensor, kq: torch.Tensor) -> torch.Tensor:
    """xq [M, K] int8 @ kq [K, N] int8 -> int32, exact."""
    m = xq.shape[0]
    rows = max(32, -(-m // 8) * 8)
    if rows != m:
        xq = torch.cat([xq, xq.new_zeros(rows - m, xq.shape[1])], 0)
    return torch._int_mm(xq, kq.contiguous())[:m]


def dense_quantized(params: dict, x: torch.Tensor, *, dtype=None) -> torch.Tensor:
    """A quantized dense dict applied to x (ops.basic.dense calls it)."""
    out_dtype = dtype or (x.dtype if x.is_floating_point() else torch.float32)
    if "kernel_q8a8" in params:
        kq, w_scale = params["kernel_q8a8"], params["scale"]
        lead = x.shape[:-1]
        x2 = x.reshape(-1, x.shape[-1])
        if x2.dtype == torch.float32:
            x2 = x2.to(torch.bfloat16)
        amax = x2.abs().amax(1, keepdim=True)
        x_scale = torch.maximum(amax, torch.tensor(1e-6, dtype=x2.dtype, device=x2.device)) / 127.0
        xq = torch.clamp(torch.round(x2 / x_scale), -127, 127).to(torch.int8)
        acc = _int8_matmul(xq, kq)
        y = acc.float() * x_scale.float() * w_scale.float()[None, :]
        y = y.reshape(*lead, -1).to(out_dtype)
    else:
        kq, w_scale = params["kernel_q8"], params["scale"]
        w = kq.to(out_dtype) * w_scale.to(out_dtype)[None, :]
        y = x.to(out_dtype) @ w
    if "bias" in params:
        y = y + params["bias"].to(y.dtype)
    return y


def quantized_bytes(params) -> dict:
    """Parameter storage: the tree's bytes, and what they would be with every
    int8 leaf in f32."""
    q = f = 0

    def walk(node):
        nonlocal q, f
        if isinstance(node, dict):
            for v in node.values():
                walk(v)
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v)
        elif isinstance(node, torch.Tensor):
            n = node.numel() * node.element_size()
            q += n
            f += node.numel() * 4 if node.dtype == torch.int8 else n

    walk(params)
    return {"quantized_bytes": int(q), "float32_bytes": int(f)}
