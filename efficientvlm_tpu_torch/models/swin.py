"""Swin Transformer, an alternative vision tower (port of
efficientvlm_tpu/models/swin.py; the reference's models/swin_transformer.py,
Swin-B): windowed self-attention with a relative-position bias, shifted
windows on odd blocks, patch merging between stages.

Plain PyTorch, as JAX's is plain XLA (no TPU kernel serves it): window
partition and reverse are reshapes and transposes; the shifted-window mask
and the relative-position index are host constants; the attention core is
f32 scores and softmax, the probabilities cast to the compute dtype before
P.V. The output is the last stage's tokens after the final LayerNorm with
their mean prepended as the [CLS] surrogate.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import Config
from ..ops.basic import dense, gelu, init_dense, init_layer_norm, layer_norm
from .deit import patchify


def swin_config(*, image_res: int = 224, patch_size: int = 4, embed_dim: int = 128,
                depths=(2, 2, 18, 2), num_heads=(4, 8, 16, 32), window_size: int = 7,
                mlp_ratio: float = 4.0) -> Config:
    """Swin-B by default (224 px, window 7); vision_width is the last
    stage's width."""
    return Config(dict(image_res=image_res, patch_size=patch_size, embed_dim=embed_dim,
                       depths=list(depths), num_heads=list(num_heads), window_size=window_size,
                       mlp_ratio=mlp_ratio, vision_width=embed_dim * 2 ** (len(depths) - 1)))


def _rel_pos_index(window: int, table_window: int | None = None) -> np.ndarray:
    """Indices [w*w, w*w] into a (2*tw-1)^2 bias table for a window of w;
    tw > w when the window was clamped to a smaller resolution (the offsets
    address the table's central block)."""
    tw = table_window or window
    coords = np.stack(np.meshgrid(np.arange(window), np.arange(window), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0) + (tw - 1)
    return (rel[..., 0] * (2 * tw - 1) + rel[..., 1]).astype(np.int64)


def init_swin(generator: torch.Generator, cfg: Config, device=None) -> dict:
    e, p, w = cfg["embed_dim"], cfg["patch_size"], cfg["window_size"]

    def randn(*shape):
        return torch.randn(shape, generator=generator, device=device) * 0.02

    params: dict = {"patch_embed": {"kernel": randn(p, p, 3, e),
                                    "bias": torch.zeros(e, device=device)},
                    "patch_norm": init_layer_norm(e, device), "stages": [],
                    "norm": init_layer_norm(cfg["vision_width"], device)}
    dim = e
    for si, (depth, nh) in enumerate(zip(cfg["depths"], cfg["num_heads"])):
        hidden = int(dim * cfg["mlp_ratio"])
        stage: dict = {"blocks": [{
            "ln1": init_layer_norm(dim, device),
            "qkv": init_dense(generator, dim, dim * 3, device=device),
            "proj": init_dense(generator, dim, dim, device=device),
            "rel_bias": randn((2 * w - 1) ** 2, nh),
            "ln2": init_layer_norm(dim, device),
            "fc1": init_dense(generator, dim, hidden, device=device),
            "fc2": init_dense(generator, hidden, dim, device=device),
        } for _ in range(depth)]}
        if si < len(cfg["depths"]) - 1:
            stage["downsample"] = {
                "reduction": init_dense(generator, 4 * dim, 2 * dim, bias=False, device=device),
                "norm": init_layer_norm(4 * dim, device)}
            dim *= 2
        params["stages"].append(stage)
    return params


def window_partition(x: torch.Tensor, w: int) -> torch.Tensor:
    """[B, H, W, C] -> [B * H/w * W/w, w*w, C]."""
    b, h, wd, c = x.shape
    x = x.reshape(b, h // w, w, wd // w, w, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, w * w, c)


def window_reverse(wins: torch.Tensor, w: int, h: int, wd: int) -> torch.Tensor:
    """window_partition's inverse: [B * H/w * W/w, w*w, C] -> [B, H, W, C]."""
    b = wins.shape[0] // ((h // w) * (wd // w))
    x = wins.reshape(b, h // w, wd // w, w, w, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, wd, -1)


def shift_mask(h: int, wd: int, w: int, shift: int) -> np.ndarray:
    """The shifted windows' mask [nW, w*w, w*w]: -100 between tokens of
    different regions of the rolled image, 0 within one."""
    img = np.zeros((h, wd))
    cnt = 0
    for hs in (slice(0, -w), slice(-w, -shift), slice(-shift, None)):
        for ws in (slice(0, -w), slice(-w, -shift), slice(-shift, None)):
            img[hs, ws] = cnt
            cnt += 1
    wins = img.reshape(h // w, w, wd // w, w).transpose(0, 2, 1, 3).reshape(-1, w * w)
    return np.where(wins[:, None, :] != wins[:, :, None], -100.0, 0.0).astype(np.float32)


def window_attention(bp: dict, x: torch.Tensor, nh: int, w: int, mask, dtype,
                     table_window: int | None = None) -> torch.Tensor:
    """Self-attention within each window [nW_total, w*w, C] with the
    relative-position bias and, for shifted windows, `mask`."""
    nw, n, c = x.shape
    qkv = dense(bp["qkv"], x, dtype=dtype).reshape(nw, n, 3, nh, c // nh)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    scores = (q * (c // nh) ** -0.5).float() @ k.float().transpose(-1, -2)
    index = torch.from_numpy(_rel_pos_index(w, table_window).reshape(-1)).to(x.device)
    bias = bp["rel_bias"][index].reshape(n, n, nh).permute(2, 0, 1)
    scores = scores + bias[None].float()
    if mask is not None:
        nm = mask.shape[0]
        scores = (scores.reshape(nw // nm, nm, nh, n, n)
                  + torch.from_numpy(mask).to(x.device)[None, :, None]).reshape(nw, nh, n, n)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = (probs @ v).transpose(1, 2).reshape(nw, n, c)
    return dense(bp["proj"], out, dtype=dtype)


def swin_apply(params: dict, images: torch.Tensor, cfg: Config, *, dtype=None,
               **_ignored) -> dict:
    """[B,H,W,3] -> {"last_hidden" [B, 1+N, vision_width]} with the tokens'
    mean prepended as the [CLS] surrogate (no taps, no gates)."""
    w = cfg["window_size"]
    x = patchify(images, params["patch_embed"]["kernel"], params["patch_embed"]["bias"], dtype)
    b, gh, gw, c = x.shape
    x = layer_norm(params["patch_norm"], x.reshape(b, gh * gw, c), eps=1e-5).reshape(
        b, gh, gw, c)
    for si, stage in enumerate(params["stages"]):
        nh = cfg["num_heads"][si]
        # a window that covers the whole grid is clamped to it and never
        # shifted (the reference's SwinTransformerBlock), stage by stage
        w_eff = min(w, gh, gw)
        for bi, bp in enumerate(stage["blocks"]):
            shift = 0 if (bi % 2 == 0 or min(gh, gw) <= w) else w_eff // 2
            h_ = layer_norm(bp["ln1"], x, eps=1e-5)
            mask = None
            if shift:
                h_ = torch.roll(h_, (-shift, -shift), dims=(1, 2))
                mask = shift_mask(gh, gw, w_eff, shift)
            wins = window_attention(bp, window_partition(h_, w_eff), nh, w_eff, mask, dtype,
                                    table_window=w if w_eff < w else None)
            h_ = window_reverse(wins, w_eff, gh, gw)
            if shift:
                h_ = torch.roll(h_, (shift, shift), dims=(1, 2))
            x = x + h_
            h_ = layer_norm(bp["ln2"], x, eps=1e-5)
            x = x + dense(bp["fc2"], gelu(dense(bp["fc1"], h_, dtype=dtype)), dtype=dtype)
        if "downsample" in stage:
            x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2],
                           x[:, 1::2, 1::2]], -1)
            x = layer_norm(stage["downsample"]["norm"], x, eps=1e-5)
            x = dense(stage["downsample"]["reduction"], x, dtype=dtype)
            gh, gw = gh // 2, gw // 2
    c = x.shape[-1]
    seq = layer_norm(params["norm"], x.reshape(b, gh * gw, c), eps=1e-5)
    return {"last_hidden": torch.cat([seq.mean(1, keepdim=True), seq], 1),
            "hidden_states": None, "attentions": None}
