"""Image transforms on the host (the port's copy of
efficientvlm_tpu/data/transforms.py, after the reference's torchvision
stacks, dataset/__init__.py:19-61): pretrain = RandomResizedCrop (area 0.2-1,
bicubic) + horizontal flip + RandAugment(2, 7); train = the same at area
0.5-1; test = a bicubic resize; all CLIP-normalised to f32 HWC (NHWC once
stacked). `uint8` resizes only, and the card does the rest
(data/device_pipeline.preprocess_train).

JAX's normalize_in_graph has no counterpart: on the card
device_pipeline.normalize plays its part. PIL is imported where an image is
resized; the random ops come from the transform's own numpy Generator.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np

CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


def normalize(img) -> np.ndarray:
    """uint8 or float HWC in 0..255 -> CLIP-normalised f32 HWC."""
    x = np.asarray(img, np.float32) / 255.0
    return (x - CLIP_MEAN) / CLIP_STD


def random_resized_crop(rng: np.random.Generator, img, size: int, *,
                        scale: Tuple[float, float] = (0.5, 1.0),
                        ratio: Tuple[float, float] = (3.0 / 4.0, 4.0 / 3.0)):
    """torchvision's RandomResizedCrop, bicubic: up to 10 tries of an area
    fraction in `scale` and a log-uniform aspect ratio in `ratio`, then a
    centre crop clamped to `ratio`."""
    from PIL import Image

    w, h = img.size
    area = w * h
    log_ratio = (math.log(ratio[0]), math.log(ratio[1]))
    for _ in range(10):
        target_area = area * rng.uniform(*scale)
        aspect = math.exp(rng.uniform(*log_ratio))
        cw = int(round(math.sqrt(target_area * aspect)))
        ch = int(round(math.sqrt(target_area / aspect)))
        if 0 < cw <= w and 0 < ch <= h:
            x0 = int(rng.integers(0, w - cw + 1))
            y0 = int(rng.integers(0, h - ch + 1))
            return img.resize((size, size), Image.BICUBIC, box=(x0, y0, x0 + cw, y0 + ch))
    in_ratio = w / h
    if in_ratio < ratio[0]:
        cw, ch = w, int(round(w / ratio[0]))
    elif in_ratio > ratio[1]:
        cw, ch = int(round(h * ratio[1])), h
    else:
        cw, ch = w, h
    x0, y0 = (w - cw) // 2, (h - ch) // 2
    return img.resize((size, size), Image.BICUBIC, box=(x0, y0, x0 + cw, y0 + ch))


class ImageTransform:
    """PIL image -> f32 HWC (uint8 HWC in mode "uint8"), by preset."""

    def __init__(self, image_res: int, *, mode: str = "train",
                 scale: Optional[Tuple[float, float]] = None, hflip: bool = True,
                 randaug: bool = True, randaug_ops: Optional[list] = None,
                 seed: Optional[int] = None, native_decode: bool = False):
        self.image_res = image_res
        self.mode = mode
        self.native_decode = native_decode
        self.hflip = hflip
        self.scale = scale or ((0.2, 1.0) if mode == "pretrain" else (0.5, 1.0))
        self.rng = np.random.default_rng(seed)
        self.randaug = None
        if randaug and mode != "test":
            from .randaugment import RandomAugment

            self.randaug = RandomAugment(2, 7, augs=randaug_ops, rng=self.rng)

    @classmethod
    def pretrain(cls, image_res: int, seed=None):
        return cls(image_res, mode="pretrain", seed=seed)

    @classmethod
    def train(cls, image_res: int, seed=None):
        return cls(image_res, mode="train", seed=seed)

    @classmethod
    def train_wohflip(cls, image_res: int, seed=None):
        return cls(image_res, mode="train", hflip=False, seed=seed)

    @classmethod
    def box(cls, image_res: int, seed=None):
        """Keeps the geometry (the caller crops around a box): RandAugment's
        colour ops only."""
        return cls(image_res, mode="box", hflip=False, seed=seed,
                   randaug_ops=["Identity", "AutoContrast", "Equalize", "Brightness",
                                "Sharpness"])

    @classmethod
    def test(cls, image_res: int, native_decode: bool = False):
        """The evaluation transform: a full PIL decode and a bicubic resize;
        native_decode=True takes the DCT-scaled decode with a bilinear
        finish (data/fastjpeg.py), an approximation of it."""
        return cls(image_res, mode="test", hflip=False, randaug=False,
                   native_decode=native_decode)

    @classmethod
    def uint8(cls, image_res: int, margin: float = 1.15):
        """A square resize to margin x image_res, uint8 out: the card crops,
        flips, augments and normalises."""
        return cls(int(image_res * margin), mode="uint8", hflip=False, randaug=False)

    @property
    def native_decode_size(self) -> Optional[int]:
        """The square size a JPEG may be decoded to directly (mode "uint8",
        or "test" with native_decode); None where the transform needs the
        full image."""
        if self.mode == "uint8" or (self.mode == "test" and self.native_decode):
            return self.image_res
        return None

    def from_decoded(self, arr: np.ndarray) -> np.ndarray:
        """The rest of the pipeline on a decoded, resized uint8 HWC array."""
        if self.mode == "uint8":
            return np.asarray(arr, np.uint8)
        return normalize(arr)

    def __call__(self, img) -> np.ndarray:
        from PIL import Image

        img = img.convert("RGB")
        if self.mode == "uint8":
            img = img.resize((self.image_res, self.image_res), Image.BICUBIC)
            return np.asarray(img, np.uint8)
        if self.mode == "test":
            img = img.resize((self.image_res, self.image_res), Image.BICUBIC)
        elif self.mode != "box":  # "box": the caller cropped; the geometry stays
            img = random_resized_crop(self.rng, img, self.image_res, scale=self.scale)
            if self.hflip and self.rng.random() < 0.5:
                img = img.transpose(Image.FLIP_LEFT_RIGHT)
        if self.randaug is not None:
            img = self.randaug(img)
        return normalize(img)
