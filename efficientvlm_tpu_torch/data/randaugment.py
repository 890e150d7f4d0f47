"""RandAugment on the host over PIL images (the port's copy of
efficientvlm_tpu/data/randaugment.py): n ops drawn with replacement from
`augs`, each at magnitude m of MAX_LEVEL, a signed op's sign drawn after
its magnitude; the reference's train stacks draw from DEFAULT_AUGS.
data/device_pipeline.py applies the same ops on the card.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
from PIL import Image, ImageEnhance, ImageOps

MAX_LEVEL = 10


def _affine(img, matrix):
    return img.transform(img.size, Image.AFFINE, matrix, resample=Image.BILINEAR)


def shear_x(img, v):
    return _affine(img, (1, v, 0, 0, 1, 0))


def shear_y(img, v):
    return _affine(img, (1, 0, 0, v, 1, 0))


def translate_x(img, v):
    return _affine(img, (1, 0, v * img.size[0], 0, 1, 0))


def translate_y(img, v):
    return _affine(img, (1, 0, 0, 0, 1, v * img.size[1]))


def rotate(img, v):
    return img.rotate(v, resample=Image.BILINEAR)


def auto_contrast(img, _):
    return ImageOps.autocontrast(img)


def equalize(img, _):
    return ImageOps.equalize(img)


def solarize(img, v):
    return ImageOps.solarize(img, int(v))


def posterize(img, v):
    return ImageOps.posterize(img, max(1, int(v)))


def brightness(img, v):
    return ImageEnhance.Brightness(img).enhance(v)


def sharpness(img, v):
    return ImageEnhance.Sharpness(img).enhance(v)


def contrast(img, v):
    return ImageEnhance.Contrast(img).enhance(v)


def color(img, v):
    return ImageEnhance.Color(img).enhance(v)


def identity(img, _):
    return img


def cutout(img, v, fill=(128, 128, 128)):
    """A v-sized box (fraction of each side) at a random centre filled with
    `fill`; its position comes from an unseeded generator, as in the JAX
    package (no preset draws it)."""
    if v <= 0:
        return img
    w, h = img.size
    rng = np.random.default_rng()
    x0 = int(max(0, rng.uniform(0, w) - v * w / 2))
    y0 = int(max(0, rng.uniform(0, h) - v * h / 2))
    x1, y1 = int(min(w, x0 + v * w)), int(min(h, y0 + v * h))
    img = img.copy()
    img.paste(fill, (x0, y0, x1, y1))
    return img


# name -> (fn, value at level 0, value at MAX_LEVEL, signed: a random sign)
OPS = {
    "Identity": (identity, 0.0, 0.0, False),
    "AutoContrast": (auto_contrast, 0.0, 0.0, False),
    "Equalize": (equalize, 0.0, 0.0, False),
    "Brightness": (brightness, 0.1, 1.9, False),
    "Sharpness": (sharpness, 0.1, 1.9, False),
    "Contrast": (contrast, 0.1, 1.9, False),
    "Color": (color, 0.1, 1.9, False),
    "ShearX": (shear_x, 0.0, 0.3, True),
    "ShearY": (shear_y, 0.0, 0.3, True),
    "TranslateX": (translate_x, 0.0, 0.45, True),
    "TranslateY": (translate_y, 0.0, 0.45, True),
    "Rotate": (rotate, 0.0, 30.0, True),
    "Solarize": (solarize, 256.0, 0.0, False),
    "Posterize": (posterize, 8.0, 4.0, False),
    "Cutout": (cutout, 0.0, 0.2, False),
}

DEFAULT_AUGS = ["Identity", "AutoContrast", "Equalize", "Brightness", "Sharpness",
                "ShearX", "ShearY", "TranslateX", "TranslateY", "Rotate"]


class RandomAugment:
    def __init__(self, n: int = 2, m: int = 7, augs: Optional[List[str]] = None,
                 rng: Optional[np.random.Generator] = None):
        self.n, self.m = n, m
        self.augs = augs or DEFAULT_AUGS
        self.rng = rng or np.random.default_rng()

    def __call__(self, img):
        for oi in self.rng.choice(len(self.augs), self.n, replace=True):
            fn, lo, hi, signed = OPS[self.augs[int(oi)]]
            v = lo + (hi - lo) * (self.m / MAX_LEVEL)
            if signed and self.rng.random() < 0.5:
                v = -v
            img = fn(img, v)
        return img
