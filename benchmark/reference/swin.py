"""Plain PyTorch reference of X-VLM-base's vision tower, Swin-B (Liu et al.,
arXiv:2103.14030; as X-VLM builds it, github.com/zengyan-97/X-VLM
models/swin_transformer.py with configs/config_swinB_224.json), in f32
with TF32 off (reference/xvlm.exact_f32), its matrix products through
`num` (reference/xvlm.F32, or the fp8 control reference/xvlm.Fp8). It
imports nothing of the port.

- patch embedding: a stride-p convolution (HWIO kernel, bias) as a product
  over flattened patches, then LayerNorm (eps 1e-5 throughout);
- each stage: blocks of pre-LN windowed self-attention (qkv with bias, q
  scaled by dh^-1/2, + the relative-position bias table [(2w-1)^2, heads]
  read by the relative index, + -100 between tokens of different regions
  of the rolled grid on shifted blocks, softmax, proj) and a pre-LN MLP
  (exact GELU, ratio 4); odd blocks roll the grid by -w/2 first and back
  after; where the grid is no larger than the window, the window is the
  grid and never shifts;
- patch merging between stages: the 2 x 2 neighbours concatenated as
  (0,0), (1,0), (0,1), (1,1), LayerNorm over 4C, a linear map to 2C
  without bias;
- the last stage's tokens after a final LayerNorm, their mean in front as
  [CLS] (X-VLM's average pool);
- a region batch (idx_to_group_img [n_txt], image_atts [n_txt, 1 + N]):
  each text's image's tokens gathered, and in front of them their mean
  weighted by image_atts[:, 1:] (X-VLM's Swin forward).

Departures from the published description:
- stochastic depth: X-VLM builds the tower with drop_path_rate 0.1; the
  tower here and the port's have none (every block runs whole in every
  step);
- where the window is clamped to a smaller grid, X-VLM builds that block's
  bias table at the clamped window; the tree here keeps the configured
  window's table and reads its central block (what a published table
  resized to the block gives). At 224 px no window of Swin-B is clamped.

Where gradients are taken, each block is recomputed in the backward
(torch.utils.checkpoint): the same function and gradients, in the memory
of one block, so that the f32 tower at b128 fits beside the rest.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from benchmark.reference import xvlm as R

SHIFT_MASK = -100.0  # the additive score between tokens of different regions


def rel_index(window: int, table_window: int, device) -> torch.Tensor:
    """[w*w, w*w] indices into a (2*tw - 1)^2 table: for tokens a, b of a
    window, (row_a - row_b + tw - 1) * (2 tw - 1) + (col_a - col_b + tw - 1)."""
    rows = torch.arange(window, device=device).repeat_interleave(window)
    cols = torch.arange(window, device=device).repeat(window)
    dr = rows[:, None] - rows[None, :] + table_window - 1
    dc = cols[:, None] - cols[None, :] + table_window - 1
    return dr * (2 * table_window - 1) + dc


def shifted_mask(h: int, w: int, window: int, shift: int, device) -> torch.Tensor:
    """[nW, w*w, w*w]: SHIFT_MASK between two tokens of a window that lie in
    different regions of the rolled grid, 0 within one region."""
    labels = np.zeros((h, w), np.int64)
    bands = lambda n: [(0, n - window), (n - window, n - shift), (n - shift, n)]  # noqa: E731
    k = 0
    for r0, r1 in bands(h):
        for c0, c1 in bands(w):
            labels[r0:r1, c0:c1] = k
            k += 1
    lab = torch.as_tensor(labels, device=device)
    lab = lab.reshape(h // window, window, w // window, window).permute(0, 2, 1, 3)
    lab = lab.reshape(-1, window * window)
    return torch.where(lab[:, :, None] == lab[:, None, :], 0.0, SHIFT_MASK)


def windows(x: torch.Tensor, window: int) -> torch.Tensor:
    """[B, H, W, C] -> [B * nW, w*w, C], windows in row-major order."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // window, window, w // window, window, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, window * window, c)


def unwindows(x: torch.Tensor, window: int, h: int, w: int) -> torch.Tensor:
    b = x.shape[0] // ((h // window) * (w // window))
    x = x.reshape(b, h // window, w // window, window, window, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, w, -1)


def attention(num, bp, x, heads: int, window: int, table_window: int, mask):
    """Windowed self-attention over [nW_total, w*w, C]."""
    nw, n, c = x.shape
    dh = c // heads
    qkv = R.linear(num, x, bp["qkv"]).reshape(nw, n, 3, heads, dh).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0] * dh ** -0.5, qkv[1], qkv[2]
    scores = num.mm(q, k.transpose(-1, -2))
    idx = rel_index(window, table_window, x.device).reshape(-1)
    bias = bp["rel_bias"].float()[idx].reshape(n, n, heads).permute(2, 0, 1)
    scores = scores + bias[None]
    if mask is not None:
        nm = mask.shape[0]
        scores = (scores.reshape(nw // nm, nm, heads, n, n) + mask[None, :, None]).reshape(
            nw, heads, n, n)
    out = num.mm(torch.softmax(scores, -1), v).transpose(1, 2).reshape(nw, n, c)
    return R.linear(num, out, bp["proj"])


def block(num, bp, x, heads: int, window: int, shift: int, table_window: int):
    """One Swin block over the grid [B, H, W, C]."""
    b, h, w, c = x.shape
    y = R.ln(x, bp["ln1"], 1e-5)
    mask = None
    if shift:
        y = torch.roll(y, (-shift, -shift), (1, 2))
        mask = shifted_mask(h, w, window, shift, x.device)
    y = unwindows(attention(num, bp, windows(y, window), heads, window, table_window, mask),
                  window, h, w)
    if shift:
        y = torch.roll(y, (shift, shift), (1, 2))
    x = x + y
    y = F.gelu(R.linear(num, R.ln(x, bp["ln2"], 1e-5), bp["fc1"]))
    return x + R.linear(num, y, bp["fc2"])


def merge(num, dp, x):
    x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]], -1)
    return R.linear(num, R.ln(x, dp["norm"], 1e-5), dp["reduction"])


def tokens(num, p, images, vcfg):
    """images [B, H, W, 3] -> the last stage's normalised tokens [B, N, C]."""
    ps, e = vcfg["patch_size"], vcfg["embed_dim"]
    b, hh, ww, c = images.shape
    gh, gw = hh // ps, ww // ps
    x = images[:, :gh * ps, :gw * ps].float().reshape(b, gh, ps, gw, ps, c)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, gh, gw, ps * ps * c)
    x = num.mm(x.reshape(-1, ps * ps * c), p["patch_embed"]["kernel"].float().reshape(-1, e))
    x = x.reshape(b, gh, gw, e) + p["patch_embed"]["bias"].float()
    x = R.ln(x, p["patch_norm"], 1e-5)
    w = vcfg["window_size"]
    for si, stage in enumerate(p["stages"]):
        heads = vcfg["num_heads"][si]
        win = min(w, gh, gw)
        for bi, bp in enumerate(stage["blocks"]):
            shift = win // 2 if bi % 2 == 1 and min(gh, gw) > w else 0
            if x.requires_grad:
                x = torch.utils.checkpoint.checkpoint(block, num, bp, x, heads, win, shift, w,
                                                      use_reentrant=False)
            else:
                x = block(num, bp, x, heads, win, shift, w)
        if "downsample" in stage:
            x = merge(num, stage["downsample"], x)
            gh, gw = gh // 2, gw // 2
    return R.ln(x.reshape(b, gh * gw, x.shape[-1]), p["norm"], 1e-5)


def full_rows(seq: torch.Tensor) -> torch.Tensor:
    """[B, 1 + N, C]: the tokens behind their mean."""
    return torch.cat([seq.mean(1, keepdim=True), seq], 1)


def region_rows(seq: torch.Tensor, idx_to_group_img, image_atts) -> torch.Tensor:
    """[n_txt, 1 + N, C]: each text's image's tokens behind their mean
    weighted by image_atts[:, 1:]."""
    rows = seq[idx_to_group_img]
    wts = image_atts[:, 1:].float()[:, :, None]
    return torch.cat([((wts * rows).sum(1) / wts.sum(1))[:, None], rows], 1)


def swin(num, p, images, vcfg, *, idx_to_group_img=None, image_atts=None):
    """The full rows [B, 1 + N, C]; with a region batch (full rows, region
    rows [n_txt, 1 + N, C])."""
    seq = tokens(num, p, images, vcfg)
    if idx_to_group_img is None:
        return full_rows(seq)
    return full_rows(seq), region_rows(seq, idx_to_group_img, image_atts)
