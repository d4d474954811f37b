"""RandAugment on the host with PIL (``frostnet_tpu/data/randaugment.py``).

The FrostNet ImageNet recipe trains with rand-m9 (training_commands.txt
--aa rand-m9-mstd0.5). Standard public op set
(AutoContrast/Equalize/Invert/Rotate/Posterize/Solarize/Color/Contrast/
Brightness/Sharpness/Shear/Translate), N ops of magnitude M per image.
"""
from __future__ import annotations

import numpy as np


def _enhance(img, factor, kind):
    from PIL import ImageEnhance

    return {
        "color": ImageEnhance.Color,
        "contrast": ImageEnhance.Contrast,
        "brightness": ImageEnhance.Brightness,
        "sharpness": ImageEnhance.Sharpness,
    }[kind](img).enhance(factor)


def _ops(m: float):
    """op name -> callable(img, rng). Magnitudes follow the public recipe
    (level = m/30 of the max range, random sign for signed ops)."""
    from PIL import Image, ImageOps

    frac = m / 30.0

    def signed(rng, scale):
        return (1 if rng.rand() < 0.5 else -1) * frac * scale

    return {
        "auto_contrast": lambda im, r: ImageOps.autocontrast(im),
        "equalize": lambda im, r: ImageOps.equalize(im),
        "invert": lambda im, r: ImageOps.invert(im),
        "rotate": lambda im, r: im.rotate(signed(r, 30.0)),
        "posterize": lambda im, r: ImageOps.posterize(im, max(1, 4 - int(frac * 4))),
        "solarize": lambda im, r: ImageOps.solarize(im, int(256 - frac * 256)),
        "color": lambda im, r: _enhance(im, 1.0 + signed(r, 0.9), "color"),
        "contrast": lambda im, r: _enhance(im, 1.0 + signed(r, 0.9), "contrast"),
        "brightness": lambda im, r: _enhance(im, 1.0 + signed(r, 0.9), "brightness"),
        "sharpness": lambda im, r: _enhance(im, 1.0 + signed(r, 0.9), "sharpness"),
        "shear_x": lambda im, r: im.transform(
            im.size, Image.AFFINE, (1, signed(r, 0.3), 0, 0, 1, 0)),
        "shear_y": lambda im, r: im.transform(
            im.size, Image.AFFINE, (1, 0, 0, signed(r, 0.3), 1, 0)),
        "translate_x": lambda im, r: im.transform(
            im.size, Image.AFFINE, (1, 0, signed(r, 0.45) * im.size[0], 0, 1, 0)),
        "translate_y": lambda im, r: im.transform(
            im.size, Image.AFFINE, (1, 0, 0, 0, 1, signed(r, 0.45) * im.size[1])),
    }


class RandAugment:
    """Apply ``num_ops`` random ops at magnitude ``magnitude`` (0-30)."""

    def __init__(self, num_ops: int = 2, magnitude: float = 9.0,
                 magnitude_std: float = 0.5):
        self.num_ops = num_ops
        self.magnitude = magnitude
        self.magnitude_std = magnitude_std

    @classmethod
    def from_string(cls, spec: str) -> "RandAugment":
        """Parse the timm-style spec the published recipe uses:
        'rand-m9-mstd0.5' (training_commands.txt --aa), optionally with
        '-n<ops>'."""
        parts = spec.lower().split("-")
        if parts[0] != "rand":
            raise ValueError(f"unsupported auto-augment spec {spec!r} "
                             "(only rand-* is implemented)")
        kw = {}
        for p in parts[1:]:
            if p.startswith("mstd"):
                kw["magnitude_std"] = float(p[4:])
            elif p.startswith("m"):
                kw["magnitude"] = float(p[1:])
            elif p.startswith("n"):
                kw["num_ops"] = int(p[1:])
            else:
                raise ValueError(f"unknown token {p!r} in {spec!r}")
        return cls(**kw)

    def __call__(self, img_uint8: np.ndarray, rng: np.random.RandomState) -> np.ndarray:
        from .datasets import _require_pil

        _require_pil()
        from PIL import Image

        im = Image.fromarray(img_uint8)
        for _ in range(self.num_ops):
            m = self.magnitude
            if self.magnitude_std > 0:
                m = float(np.clip(rng.normal(m, self.magnitude_std), 0, 30))
            ops = _ops(m)
            name = list(ops)[rng.randint(len(ops))]
            im = ops[name](im, rng)
        return np.asarray(im)
