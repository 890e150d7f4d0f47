"""Image preprocessing on the device (port of
efficientvlm_tpu/data/device_pipeline.py): the host decodes to uint8 only;
random-resized crop, horizontal flip, RandAugment (n = 2 ops at magnitude
7, drawn from the reference's 10 unless told otherwise) and CLIP
normalisation run on the images' device, over the whole batch at once.

Randomness comes from an explicit torch.Generator (on the images' device),
drawn up front by `sample_train_params`; `preprocess_train(params=...)`
applies given draws, so two devices or the JAX package can be fed the same
ones. RandAugment's per-sample op choice groups the samples by op: one
stable sort and one read of the group sizes per round, then each op runs on
its group (no loop over samples).

Resampling follows jax.image.resize(method="bicubic") exactly, which is not
F.interpolate's bicubic: the Keys cubic with a = -0.5 (F.interpolate uses a
= -0.75), antialiased when shrinking (the kernel widened by the shrink
factor), taps outside the image dropped and each output's weights
renormalised to sum 1, outputs whose sample lies outside the image zeroed;
an axis whose size does not change is left as it is. Each axis is a dense
[out, in] product (compute_weight_mat in jax._src.image.scale).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
FILL = 128.0  # the reference's fill value of the geometric ops
MAX_LEVEL = 10.0
# make_randaug_ops' table, in its order; params["ops"] index into it
OP_NAMES = ("Identity", "AutoContrast", "Equalize", "Rotate", "Solarize", "Color", "Contrast",
            "Brightness", "Sharpness", "ShearX", "ShearY", "TranslateX", "TranslateY",
            "Posterize")
N_OPS = len(OP_NAMES)
# the ops the reference's train stacks draw from (the host RandomAugment's
# DEFAULT_AUGS): Color, Contrast, Solarize and Posterize are in the table only
DEFAULT_AUGS = ("Identity", "AutoContrast", "Equalize", "Brightness", "Sharpness", "ShearX",
                "ShearY", "TranslateX", "TranslateY", "Rotate")
RANDAUG_N, RANDAUG_M = 2, 7  # ops a sample, magnitude
# crop area fractions: the fine-tunes' train transform, and pretraining's
# (general distillation), as the host ImageTransform.train / .pretrain
CROP_SCALE, PRETRAIN_CROP_SCALE = (0.5, 1.0), (0.2, 1.0)
CROP_RATIO = (0.75, 4.0 / 3.0)


# --------------------------------------------------------------------------
# resampling
# --------------------------------------------------------------------------


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """Keys' cubic convolution kernel, a = -0.5, at |distance| x >= 0."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def cubic_weights(in_size: int, out_size: int, *, device=None) -> torch.Tensor:
    """[in_size, out_size] f32 weights of jax.image.resize's antialiased
    bicubic along one axis (scale out / in, no translation)."""
    f32 = torch.float32
    inv_scale = torch.tensor(1.0 / (out_size / in_size), dtype=f32, device=device)
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    sample = (torch.arange(out_size, dtype=f32, device=device) + 0.5) * inv_scale - 0.5
    x = (sample[None, :] - torch.arange(in_size, dtype=f32, device=device)[:, None]).abs() \
        / kernel_scale
    w = _keys_cubic(x)
    total = w.sum(0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * torch.finfo(f32).eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def resize(imgs: torch.Tensor, size) -> torch.Tensor:
    """[N, H, W, C] f32 -> [N, h, w, C], bicubic as jax.image.resize."""
    h, w = size
    if imgs.shape[1] != h:
        wh = cubic_weights(imgs.shape[1], h, device=imgs.device)
        imgs = torch.einsum("nhwc,hy->nywc", imgs, wh)
    if imgs.shape[2] != w:
        ww = cubic_weights(imgs.shape[2], w, device=imgs.device)
        imgs = torch.einsum("nywc,wx->nyxc", imgs, ww)
    return imgs


def normalize(imgs: torch.Tensor) -> torch.Tensor:
    """0..255 f32 -> CLIP-normalised."""
    mean = torch.tensor(CLIP_MEAN, dtype=torch.float32, device=imgs.device)
    std = torch.tensor(CLIP_STD, dtype=torch.float32, device=imgs.device)
    return (imgs / 255.0 - mean) / std


# --------------------------------------------------------------------------
# crop and flip
# --------------------------------------------------------------------------


def crop_resize(imgs: torch.Tensor, box, out_res: int) -> torch.Tensor:
    """[N, H, W, C] and per-sample boxes (x0, y0, cw, ch), int [N] each ->
    [N, out_res, out_res, C] f32: nearest sampling inside each box (rows y0
    + i * ch // out_res). JAX follows it with a bicubic resize to the same
    size, which is the identity, so there is none here."""
    x0, y0, cw, ch = (t.long() for t in box)
    n, h, w, c = imgs.shape
    steps = torch.arange(out_res, device=imgs.device)
    ys = y0[:, None] + steps[None] * ch[:, None] // out_res
    xs = x0[:, None] + steps[None] * cw[:, None] // out_res
    idx = (ys[:, :, None] * w + xs[:, None, :]).reshape(n, -1, 1).expand(-1, -1, c)
    out = imgs.reshape(n, h * w, c).gather(1, idx).reshape(n, out_res, out_res, c)
    return out.float()


def sample_crop(generator, n: int, h: int, w: int, *, scale=CROP_SCALE, device=None):
    """Per-sample boxes (x0, y0, cw, ch) of JAX's random_resized_crop: an
    area fraction in `scale`, a log-uniform aspect ratio in CROP_RATIO,
    sides clipped to [8, side] (one draw, no rejection loop), a uniform
    corner."""
    def uniform(lo, hi):
        return torch.rand(n, generator=generator, device=device) * (hi - lo) + lo

    area = h * w * uniform(*scale)
    aspect = torch.exp(uniform(math.log(CROP_RATIO[0]), math.log(CROP_RATIO[1])))
    cw = torch.sqrt(area * aspect).clamp(8, w).to(torch.int32)
    ch = torch.sqrt(area / aspect).clamp(8, h).to(torch.int32)
    x0 = (torch.rand(n, generator=generator, device=device)
          * (w - cw).clamp(min=1)).floor().to(torch.int32)
    y0 = (torch.rand(n, generator=generator, device=device)
          * (h - ch).clamp(min=1)).floor().to(torch.int32)
    return x0, y0, cw, ch


def flip_images(imgs: torch.Tensor, flip: torch.Tensor) -> torch.Tensor:
    """Mirror the samples whose flip [N] is True."""
    return torch.where(flip[:, None, None, None], imgs.flip(2), imgs)


# --------------------------------------------------------------------------
# RandAugment
# --------------------------------------------------------------------------


def _blend(a: torch.Tensor, b: torch.Tensor, factor: float) -> torch.Tensor:
    return (a + (b - a) * factor).clamp(0.0, 255.0)


def affine_sample(imgs: torch.Tensor, a, b, c, d, e, f) -> torch.Tensor:
    """PIL-style inverse affine map per sample: out(x, y) = img(a x + b y +
    c, d x + e y + f), bilinear, samples outside filled with FILL. a..f are
    floats or [N] tensors."""
    n, h, w, ch = imgs.shape
    dev = imgs.device

    def coef(v):
        return torch.as_tensor(v, dtype=torch.float32, device=dev).reshape(-1, 1, 1)

    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev), indexing="ij")
    gx = coef(a) * xs + coef(b) * ys + coef(c)
    gy = coef(d) * xs + coef(e) * ys + coef(f)
    gx, gy = gx.expand(n, h, w), gy.expand(n, h, w)
    x0, y0 = gx.floor(), gy.floor()
    wx, wy = gx - x0, gy - y0
    flat = imgs.reshape(n, h * w, ch)

    def tap(yi, xi):
        inside = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        idx = yi.clamp(0, h - 1).long() * w + xi.clamp(0, w - 1).long()
        v = flat.gather(1, idx.reshape(n, -1, 1).expand(-1, -1, ch)).reshape(n, h, w, ch)
        return torch.where(inside[..., None], v, torch.full_like(v, FILL))

    return (tap(y0, x0) * ((1 - wx) * (1 - wy))[..., None]
            + tap(y0, x0 + 1) * (wx * (1 - wy))[..., None]
            + tap(y0 + 1, x0) * ((1 - wx) * wy)[..., None]
            + tap(y0 + 1, x0 + 1) * (wx * wy)[..., None])


def make_randaug_ops(level: float) -> list:
    """The 14-op table (OP_NAMES) at magnitude level = m / MAX_LEVEL; each
    op maps (imgs [N,H,W,3] f32 in 0..255, sign [N] of +-1) to imgs. The
    sign flips the direction of rotate, shear and translate."""
    enh = 0.1 + 1.8 * level
    shear = 0.3 * level
    trans = 10.0 * level
    deg = 30.0 * level
    solarize_thresh = 256.0 * level
    posterize_bits = int(4 * level)

    def identity(x, sign):
        return x

    def autocontrast(x, sign):
        lo, hi = x.amin((1, 2), keepdim=True), x.amax((1, 2), keepdim=True)
        return ((x - lo) * (255.0 / (hi - lo).clamp(min=1.0))).clamp(0.0, 255.0)

    def equalize(x, sign):
        # PIL's equalize per image and channel: step = (pixels - the last
        # non-empty bin's count) // 255; lut = running sum of (step // 2,
        # hist[:-1]) // step; unchanged where step is 0
        n, h, w, c = x.shape
        vals = x.permute(0, 3, 1, 2).reshape(n * c, h * w)
        bins = vals.clamp(0, 255).long()
        hist = torch.zeros(n * c, 256, dtype=torch.long, device=x.device).scatter_add_(
            1, bins, torch.ones_like(bins))
        ar = torch.arange(256, device=x.device)
        last = torch.where(hist > 0, ar, -1).argmax(1, keepdim=True)
        step = (hist.sum(1, keepdim=True) - hist.gather(1, last)) // 255
        lut = torch.cat([step // 2, hist[:, :-1]], 1).cumsum(1) // step.clamp(min=1)
        out = torch.where(step == 0, vals, lut.clamp(0, 255).gather(1, bins).to(x.dtype))
        return out.reshape(n, c, h, w).permute(0, 2, 3, 1)

    def rotate(x, sign):
        h, w = x.shape[1], x.shape[2]
        th = (sign * deg) * (math.pi / 180.0)
        cos, sin = torch.cos(th), torch.sin(th)
        cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
        return affine_sample(x, cos, sin, cx - cos * cx - sin * cy,
                             -sin, cos, cy + sin * cx - cos * cy)

    def solarize(x, sign):
        return torch.where(x >= solarize_thresh, 255.0 - x, x)

    def color(x, sign):
        return _blend(x.mean(-1, keepdim=True), x, enh)

    def contrast(x, sign):
        return _blend(x.mean((1, 2), keepdim=True), x, enh)

    def brightness(x, sign):
        return _blend(torch.zeros_like(x), x, enh)

    def sharpness(x, sign):
        # the 3 x 3 smoothing kernel [[1,1,1],[1,5,1],[1,1,1]] / 13 over a
        # zero border, as nine shifted adds (no cuDNN, so no TF32)
        h, w = x.shape[1], x.shape[2]
        xp = F.pad(x, (0, 0, 1, 1, 1, 1))
        smooth = sum((5.0 if (dy, dx) == (1, 1) else 1.0) / 13.0 * xp[:, dy:dy + h, dx:dx + w]
                     for dy in range(3) for dx in range(3))
        return _blend(smooth, x, enh)

    def shear_x(x, sign):
        return affine_sample(x, 1.0, sign * shear, 0.0, 0.0, 1.0, 0.0)

    def shear_y(x, sign):
        return affine_sample(x, 1.0, 0.0, 0.0, sign * shear, 1.0, 0.0)

    def translate_x(x, sign):
        return affine_sample(x, 1.0, 0.0, sign * trans, 0.0, 1.0, 0.0)

    def translate_y(x, sign):
        return affine_sample(x, 1.0, 0.0, 0.0, 0.0, 1.0, sign * trans)

    def posterize(x, sign):
        mask = (255 >> (8 - posterize_bits) << (8 - posterize_bits)) if posterize_bits else 0
        return (x.clamp(0, 255).to(torch.int32) & mask).to(x.dtype)

    return [identity, autocontrast, equalize, rotate, solarize, color, contrast, brightness,
            sharpness, shear_x, shear_y, translate_x, translate_y, posterize]


def randaugment(imgs: torch.Tensor, ops: torch.Tensor, signs: torch.Tensor) -> torch.Tensor:
    """ops [rounds, N] indices into make_randaug_ops, signs [rounds, N] of
    +-1: each round applies each sample's op at magnitude RANDAUG_M, the
    samples grouped by op."""
    table = make_randaug_ops(RANDAUG_M / MAX_LEVEL)
    for op, sign in zip(ops, signs):
        order = torch.argsort(op, stable=True)
        sizes = torch.bincount(op, minlength=len(table)).tolist()  # one read a round
        out = imgs.clone()
        for fn, idx in zip(table, order.split(sizes)):
            if idx.numel():
                out[idx] = fn(imgs[idx], sign[idx])
        imgs = out
    return imgs


# --------------------------------------------------------------------------
# the pipelines
# --------------------------------------------------------------------------


def sample_train_params(generator, n: int, h: int, w: int, *, device=None, scale=CROP_SCALE,
                        augs=DEFAULT_AUGS) -> dict:
    """The draws of preprocess_train for N images of H x W, on `device` (the
    generator's): {"box": (x0, y0, cw, ch), "flip": [N] bool, "ops" /
    "signs": [RANDAUG_N, N]}. The crop's area fraction lies in `scale`; each
    op is drawn uniformly from the names `augs` and stored as its index in
    OP_NAMES."""
    device = device or generator.device
    subset = torch.tensor([OP_NAMES.index(a) for a in augs], device=device)
    return {"box": sample_crop(generator, n, h, w, scale=scale, device=device),
            "flip": torch.rand(n, generator=generator, device=device) < 0.5,
            "ops": subset[torch.randint(0, len(subset), (RANDAUG_N, n), generator=generator,
                                        device=device)],
            "signs": torch.where(torch.rand(RANDAUG_N, n, generator=generator, device=device)
                                 < 0.5, 1.0, -1.0)}


def preprocess_train(pixels: torch.Tensor, out_res: int, *,
                     generator: Optional[torch.Generator] = None,
                     params: Optional[dict] = None, hflip: bool = True,
                     randaug: bool = True, scale=CROP_SCALE, augs=DEFAULT_AUGS) -> torch.Tensor:
    """[N, H, W, 3] uint8 -> [N, out_res, out_res, 3] normalised f32 on the
    same device: crop, flip (hflip), RandAugment (randaug), CLIP normalise.
    The draws come from `params` (sample_train_params, where `scale` and
    `augs` are read) or `generator`; they are drawn whole whatever the
    flags, so a flag changes no other draw."""
    n, h, w, _ = pixels.shape
    if params is None:
        params = sample_train_params(generator, n, h, w, device=pixels.device, scale=scale,
                                     augs=augs)
    imgs = crop_resize(pixels, params["box"], out_res)
    if hflip:
        imgs = flip_images(imgs, params["flip"])
    if randaug:
        imgs = randaugment(imgs, params["ops"], params["signs"])
    return normalize(imgs)


def preprocess_eval(pixels: torch.Tensor, out_res: int) -> torch.Tensor:
    """[N, H, W, 3] uint8 -> bicubic resize to out_res, CLIP normalise."""
    return normalize(resize(pixels.float(), (out_res, out_res)))
