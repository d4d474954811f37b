"""Style-transfer datasets (``frostnet_tpu/gan/data.py``; reference
Style_Transfer/data/*): aligned (AB side-by-side images), unaligned (two
directories), single, colorization, plus a synthetic source.

Host-side numpy, the JAX package's batches for the same seed (the same
draws in the same order). Transforms follow base_dataset.py:13-157: resize
to load_size, random crop to crop_size, random hflip, normalize to [-1, 1].
PIL is imported only by the folder datasets, and its absence is an error
that names it.
"""
from __future__ import annotations

import os
from typing import Iterator

import numpy as np


def _list_images(d):
    exts = (".jpg", ".jpeg", ".png", ".bmp")
    return sorted(os.path.join(d, f) for f in os.listdir(d)
                  if f.lower().endswith(exts))


def _transform_params(rng, load_size, crop_size):
    """One (x0, y0, flip) draw — the reference's get_params
    (base_dataset.py:13-32), drawn ONCE per aligned pair so A and B get the
    SAME crop and flip (aligned_dataset.py:49-54 'apply the same transform
    to both A and B')."""
    x0 = rng.randint(0, load_size - crop_size + 1)
    y0 = rng.randint(0, load_size - crop_size + 1)
    return x0, y0, rng.rand() < 0.5


def _require_pil():
    """Fail early, and by name, where PIL (Pillow) is missing."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("the GAN folder datasets (aligned, unaligned, single, "
                          "colorization) decode and resize images with PIL (Pillow), which "
                          "is not installed") from e
    return Image


def _load_transform(path, rng, load_size=286, crop_size=256, flip=True,
                    ab_half=None, params=None):
    Image = _require_pil()

    img = Image.open(path).convert("RGB")
    if ab_half is not None:  # aligned datasets store A|B concatenated
        w, h = img.size
        half = w // 2
        img = img.crop((0, 0, half, h)) if ab_half == "A" else img.crop((half, 0, w, h))
    img = img.resize((load_size, load_size), Image.BICUBIC)
    x0, y0, do_flip = params if params is not None else \
        _transform_params(rng, load_size, crop_size)
    arr = np.asarray(img, np.float32)[y0:y0 + crop_size, x0:x0 + crop_size] / 255.0
    if flip and do_flip:
        arr = arr[:, ::-1]
    return arr * 2.0 - 1.0


class AlignedDataset:
    """A|B concatenated pairs under root/train (data/aligned_dataset.py)."""

    def __init__(self, root, phase="train", batch_size=1, load_size=286,
                 crop_size=256, seed=0, shuffle=None, flip=None):
        _require_pil()
        self.paths = _list_images(os.path.join(root, phase))
        if not self.paths:
            raise FileNotFoundError(f"no images under {root}/{phase}")
        self.batch_size = batch_size
        self.load_size, self.crop_size = load_size, crop_size
        self.seed = seed
        # the reference tester hard-sets serial_batches + no_flip at test
        # time (test.py:43-44); default both off for non-train phases
        self.shuffle = (phase == "train") if shuffle is None else shuffle
        self.flip = (phase == "train") if flip is None else flip

    def __len__(self):
        return len(self.paths) // self.batch_size

    def __iter__(self):
        rng = np.random.RandomState(self.seed)
        order = rng.permutation(len(self.paths)) if self.shuffle \
            else np.arange(len(self.paths))
        for b in range(len(self)):
            idx = order[b * self.batch_size:(b + 1) * self.batch_size]
            # one params draw per PAIR: A|B stay pixel-aligned under the
            # random crop/flip (reference aligned_dataset.py:49-54)
            params = [_transform_params(rng, self.load_size, self.crop_size)
                      for _ in idx]
            if not self.flip:
                params = [(x0, y0, False) for x0, y0, _ in params]
            a = [_load_transform(self.paths[i], rng, self.load_size, self.crop_size,
                                 ab_half="A", params=p) for i, p in zip(idx, params)]
            bb = [_load_transform(self.paths[i], rng, self.load_size, self.crop_size,
                                  ab_half="B", params=p) for i, p in zip(idx, params)]
            yield {"A": np.stack(a).astype(np.float32),
                   "B": np.stack(bb).astype(np.float32)}


class UnalignedDataset:
    """root/trainA + root/trainB, sampled independently
    (data/unaligned_dataset.py)."""

    def __init__(self, root, phase="train", batch_size=1, load_size=286,
                 crop_size=256, seed=0):
        _require_pil()
        self.paths_a = _list_images(os.path.join(root, phase + "A"))
        self.paths_b = _list_images(os.path.join(root, phase + "B"))
        if not self.paths_a or not self.paths_b:
            raise FileNotFoundError(f"no images under {root}/{phase}A|B")
        self.batch_size = batch_size
        self.load_size, self.crop_size = load_size, crop_size
        self.seed = seed

    def __len__(self):
        return max(len(self.paths_a), len(self.paths_b)) // self.batch_size

    def __iter__(self):
        # reference protocol (unaligned_dataset.py:51-56): A iterates a
        # shuffled epoch (every A image seen once, index % A_size wrapping),
        # B is drawn at random "to avoid fixed pairs"
        rng = np.random.RandomState(self.seed)
        order_a = rng.permutation(len(self.paths_a))
        for step in range(len(self)):
            ia = [order_a[(step * self.batch_size + i) % len(self.paths_a)]
                  for i in range(self.batch_size)]
            a = [_load_transform(self.paths_a[i], rng,
                                 self.load_size, self.crop_size) for i in ia]
            b = [_load_transform(self.paths_b[rng.randint(len(self.paths_b))], rng,
                                 self.load_size, self.crop_size)
                 for _ in range(self.batch_size)]
            yield {"A": np.stack(a).astype(np.float32),
                   "B": np.stack(b).astype(np.float32)}


class SyntheticPairs:
    """Deterministic fake A/B pairs in [-1,1] for smoke/bench."""

    def __init__(self, crop_size=64, length=8, batch_size=1, seed=0):
        self.crop_size = crop_size
        self.length = length
        self.batch_size = batch_size
        self.seed = seed

    def __len__(self):
        return self.length // self.batch_size

    def __iter__(self) -> Iterator[dict]:
        rng = np.random.RandomState(self.seed)
        s = self.crop_size
        for _ in range(len(self)):
            yield {"A": np.clip(rng.randn(self.batch_size, s, s, 3) * 0.5, -1, 1).astype(np.float32),
                   "B": np.clip(rng.randn(self.batch_size, s, s, 3) * 0.5, -1, 1).astype(np.float32)}


class SingleDataset:
    """Single-direction inference dataset (data/single_dataset.py): images
    from one directory, 'A' only."""

    def __init__(self, root, batch_size=1, load_size=286, crop_size=256, seed=0):
        _require_pil()
        self.paths = _list_images(root)
        if not self.paths:
            raise FileNotFoundError(f"no images under {root}")
        self.batch_size = batch_size
        self.load_size, self.crop_size = load_size, crop_size
        self.seed = seed

    def __len__(self):
        return len(self.paths) // self.batch_size

    def __iter__(self):
        rng = np.random.RandomState(self.seed)
        for b in range(len(self)):
            a = [_load_transform(self.paths[b * self.batch_size + i], rng,
                                 self.load_size, self.crop_size, flip=False)
                 for i in range(self.batch_size)]
            yield {"A": np.stack(a).astype(np.float32),
                   "path": self.paths[b * self.batch_size]}


def apply_direction(batch: dict, direction: str) -> dict:
    """pix2pix/cyclegan ``set_input`` semantics (pix2pix_model.py:78-84,
    cycle_gan_model.py:113-118): ``BtoA`` swaps which domain is the input.
    No-op for AtoB or single-domain batches."""
    if direction not in ("AtoB", "BtoA"):
        raise ValueError(f"direction must be AtoB|BtoA, got {direction!r}")
    if direction == "BtoA" and "A" in batch and "B" in batch:
        batch = dict(batch, A=batch["B"], B=batch["A"])
    return batch


def rgb_to_lab(rgb: np.ndarray):
    """sRGB [0,1] -> CIE L*a*b* (the colorization dataset's conversion,
    data/colorization_dataset.py via skimage). Vectorized numpy (D65)."""
    r = np.where(rgb > 0.04045, ((rgb + 0.055) / 1.055) ** 2.4, rgb / 12.92)
    m = np.array([[0.4124564, 0.3575761, 0.1804375],
                  [0.2126729, 0.7151522, 0.0721750],
                  [0.0193339, 0.1191920, 0.9503041]], np.float32)
    xyz = r @ m.T
    xyz = xyz / np.array([0.95047, 1.0, 1.08883], np.float32)
    f = np.where(xyz > 0.008856, np.cbrt(xyz), 7.787 * xyz + 16.0 / 116.0)
    L = 116.0 * f[..., 1] - 16.0
    a = 500.0 * (f[..., 0] - f[..., 1])
    bb = 200.0 * (f[..., 1] - f[..., 2])
    return np.stack([L, a, bb], axis=-1)


def lab_to_rgb(lab: np.ndarray):
    """CIE L*a*b* -> sRGB [0,1] (inverse of rgb_to_lab; the reference's
    skimage color.lab2rgb path in colorization_model.py:48-63). D65."""
    L, a, b = lab[..., 0], lab[..., 1], lab[..., 2]
    fy = (L + 16.0) / 116.0
    fx = fy + a / 500.0
    fz = fy - b / 200.0

    def f_inv(t):
        return np.where(t > 6.0 / 29.0, t ** 3, 3 * (6.0 / 29.0) ** 2 * (t - 4.0 / 29.0))

    xyz = np.stack([f_inv(fx), f_inv(fy), f_inv(fz)], axis=-1)
    xyz = xyz * np.array([0.95047, 1.0, 1.08883], np.float32)
    m_inv = np.array([[3.2404542, -1.5371385, -0.4985314],
                      [-0.9692660, 1.8760108, 0.0415560],
                      [0.0556434, -0.2040259, 1.0572252]], np.float32)
    lin = xyz @ m_inv.T
    srgb = np.where(lin > 0.0031308,
                    1.055 * np.clip(lin, 0, None) ** (1 / 2.4) - 0.055,
                    12.92 * lin)
    return np.clip(srgb, 0.0, 1.0)


def colorization_to_rgb(L_norm: np.ndarray, ab_norm: np.ndarray):
    """Model-space (A = L/50-1, B = ab/110) -> RGB [0,1]
    (colorization_model.py:48-63 lab2rgb)."""
    lab = np.concatenate([(L_norm + 1.0) * 50.0, ab_norm * 110.0], axis=-1)
    return lab_to_rgb(lab)


class ColorizationDataset:
    """L-channel -> ab-channel pairs (data/colorization_dataset.py): A is
    L/50-1 (1ch), B is ab/110 (2ch)."""

    def __init__(self, root, phase="train", batch_size=1, load_size=286,
                 crop_size=256, seed=0, shuffle=None, flip=None):
        _require_pil()
        self.paths = _list_images(os.path.join(root, phase))
        if not self.paths:
            raise FileNotFoundError(f"no images under {root}/{phase}")
        self.batch_size = batch_size
        self.load_size, self.crop_size = load_size, crop_size
        self.seed = seed
        # same test protocol as AlignedDataset: serial + no flip outside
        # train (reference test.py:43-44)
        self.shuffle = (phase == "train") if shuffle is None else shuffle
        self.flip = (phase == "train") if flip is None else flip

    def __len__(self):
        return len(self.paths) // self.batch_size

    def __iter__(self):
        rng = np.random.RandomState(self.seed)
        order = rng.permutation(len(self.paths)) if self.shuffle \
            else np.arange(len(self.paths))
        for b in range(len(self)):
            As, Bs = [], []
            for i in range(self.batch_size):
                p = self.paths[order[b * self.batch_size + i]]
                rgb = (_load_transform(p, rng, self.load_size, self.crop_size,
                                       flip=self.flip) + 1) / 2
                lab = rgb_to_lab(rgb.astype(np.float32))
                As.append(lab[..., :1] / 50.0 - 1.0)
                Bs.append(lab[..., 1:] / 110.0)
            yield {"A": np.stack(As).astype(np.float32),
                   "B": np.stack(Bs).astype(np.float32)}
