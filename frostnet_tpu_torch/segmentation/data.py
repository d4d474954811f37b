"""Segmentation datasets and paired image/mask transforms
(``frostnet_tpu/segmentation/data.py``).

Host-side numpy pipelines that yield the JAX package's batches bit for bit
from the same files and seeds: ``{"image": (B, H, W, 3) float32 normalized,
"label": (B, H, W) int32}``. The train transforms are the reference's
paired RandomFlip / RandomScale / RandomCrop / Normalize (pad with 0 and
the ignore label where the scaled image is smaller than the crop). Images
are decoded and resized with PIL, imported where it is used: a dataset of
files raises an ``ImportError`` that names PIL where it is missing; the
synthetic stream needs none.
"""
from __future__ import annotations

import os
from typing import Iterator

import numpy as np

from ..data.datasets import IMAGENET_MEAN, IMAGENET_STD

CITYSCAPES_CLASSES = 19
CITYSCAPES_IGNORE = 255
# the reference's hard-coded class weights (Semantic_Segmentation/train.py:56-76)
CITYSCAPES_CLASS_WEIGHTS = np.array(
    [2.8149, 6.9850, 3.7890, 9.9428, 9.7702, 9.5111, 10.3113, 10.0264,
     4.6323, 9.5608, 7.8698, 9.5169, 10.3737, 6.6616, 10.2604, 10.2878,
     10.2898, 10.4053, 10.1381], np.float32)


def _pil_image():
    """``PIL.Image``, or an ImportError that names PIL (Pillow)."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("the segmentation datasets of files decode and resize images with "
                          "PIL (Pillow), which is not installed; SyntheticSegmentation needs "
                          "none") from e
    return Image


def _normalize(img: np.ndarray, mean, std) -> np.ndarray:
    return (img.astype(np.float32) / 255.0 - mean) / std


class PairedTransforms:
    """Train-time paired augmentation: hflip, scale jitter, crop, normalize."""

    def __init__(self, crop_size=(768, 768), scale=(0.5, 2.0), mean=IMAGENET_MEAN,
                 std=IMAGENET_STD, ignore=CITYSCAPES_IGNORE):
        self.crop_size, self.scale = crop_size, scale
        self.mean, self.std, self.ignore = mean, std, ignore

    def __call__(self, img: np.ndarray, mask: np.ndarray, rng: np.random.RandomState):
        Image = _pil_image()
        if rng.rand() < 0.5:
            img, mask = img[:, ::-1], mask[:, ::-1]
        s = rng.uniform(*self.scale)
        h, w = img.shape[:2]
        nh, nw = max(int(h * s), 1), max(int(w * s), 1)
        img = np.asarray(Image.fromarray(img).resize((nw, nh), Image.BILINEAR))
        mask = np.asarray(Image.fromarray(mask).resize((nw, nh), Image.NEAREST))
        ch, cw = self.crop_size
        if nh < ch or nw < cw:  # pad: image 0, mask the ignore label
            ph, pw = max(ch - nh, 0), max(cw - nw, 0)
            img = np.pad(img, ((0, ph), (0, pw), (0, 0)))
            mask = np.pad(mask, ((0, ph), (0, pw)), constant_values=self.ignore)
            nh, nw = img.shape[:2]
        y0 = rng.randint(0, nh - ch + 1)
        x0 = rng.randint(0, nw - cw + 1)
        img = img[y0:y0 + ch, x0:x0 + cw]
        mask = mask[y0:y0 + ch, x0:x0 + cw]
        return _normalize(img, self.mean, self.std), mask.astype(np.int32)


class SyntheticSegmentation:
    """Deterministic fake (image, mask) stream for smoke runs and the card's
    checks: ``RandomState(seed)`` draws each batch's images (``randn``) and
    then its labels (``randint(0, num_classes)``)."""

    def __init__(self, num_classes=19, crop=(96, 96), length=32, batch_size=4, seed=0):
        self.num_classes, self.crop = num_classes, crop
        self.length, self.batch_size, self.seed = length, batch_size, seed

    def __len__(self):
        return self.length // self.batch_size

    def __iter__(self) -> Iterator[dict]:
        rng = np.random.RandomState(self.seed)
        h, w = self.crop
        for _ in range(len(self)):
            yield {"image": rng.randn(self.batch_size, h, w, 3).astype(np.float32),
                   "label": rng.randint(0, self.num_classes, (self.batch_size, h, w),
                                        dtype=np.int32)}


class CityscapesSegmentation:
    """File-list Cityscapes dataset: ``root/train.txt`` (``val.txt``) lines
    of "img_path,mask_path" relative to ``root``, masks in train ids with
    255 ignored. Validation is unaugmented at the native size."""

    def __init__(self, root, train=True, crop_size=(768, 768), scale=(0.5, 2.0),
                 batch_size=16, seed=0, coarse=False):
        self.root = root
        list_path = os.path.join(root, "train.txt" if train else "val.txt")
        if not os.path.isfile(list_path):
            raise FileNotFoundError(f"{list_path} missing: place the Cityscapes file lists "
                                    "there; use SyntheticSegmentation for smoke runs")
        with open(list_path) as f:
            self.pairs = [tuple(line.strip().split(",")[:2]) for line in f if line.strip()]
        self.train, self.batch_size, self.seed = train, batch_size, seed
        self.tf = PairedTransforms(crop_size, scale)
        self.crop_size = crop_size

    def __len__(self):
        return len(self.pairs) // self.batch_size

    def _load_pair(self, img_p, mask_p, rng):
        Image = _pil_image()
        img = np.asarray(Image.open(os.path.join(self.root, img_p)).convert("RGB"))
        mask = np.asarray(Image.open(os.path.join(self.root, mask_p)))
        if self.train:
            return self.tf(img, mask, rng)
        return _normalize(img, self.tf.mean, self.tf.std), mask.astype(np.int32)

    def __iter__(self):
        rng = np.random.RandomState(self.seed)
        order = rng.permutation(len(self.pairs)) if self.train else np.arange(len(self.pairs))
        for b in range(len(self)):
            idx = order[b * self.batch_size:(b + 1) * self.batch_size]
            ims, ms = zip(*[self._load_pair(*self.pairs[i], rng) for i in idx])
            yield {"image": np.stack(ims).astype(np.float32), "label": np.stack(ms)}


class CustomSegmentation(CityscapesSegmentation):
    """A user's file-list dataset, the layout of the reference's custom
    sample: ``root/{train,val}.txt`` lines of "img.jpg, mask.png", images
    under ``root/images`` and masks under ``root/annotations`` (bare
    root-relative paths work too). Validation resizes to the crop."""

    def __init__(self, root, train=True, crop_size=(512, 512), scale=(0.5, 1.0),
                 batch_size=16, seed=0):
        super().__init__(root, train=train, crop_size=crop_size, scale=scale,
                         batch_size=batch_size, seed=seed)
        fixed = []
        for img_p, mask_p in self.pairs:
            img_p, mask_p = img_p.strip(), mask_p.strip()
            if not os.path.isfile(os.path.join(root, img_p)):
                img_p = os.path.join("images", img_p)
            if not os.path.isfile(os.path.join(root, mask_p)):
                mask_p = os.path.join("annotations", mask_p)
            for p in (img_p, mask_p):
                if not os.path.isfile(os.path.join(root, p)):
                    raise FileNotFoundError(f"{os.path.join(root, p)} from the "
                                            f"{'train' if train else 'val'} list does not exist")
            fixed.append((img_p, mask_p))
        self.pairs = fixed

    def _load_pair(self, img_p, mask_p, rng):
        if self.train:
            return super()._load_pair(img_p, mask_p, rng)
        Image = _pil_image()
        img = Image.open(os.path.join(self.root, img_p)).convert("RGB")
        mask = Image.open(os.path.join(self.root, mask_p))
        ch, cw = self.crop_size
        img = np.asarray(img.resize((cw, ch), Image.BILINEAR))
        mask = np.asarray(mask.resize((cw, ch), Image.NEAREST))
        return _normalize(img, self.tf.mean, self.tf.std), mask.astype(np.int32)


class VOCSegmentation:
    """Pascal VOC segmentation from the VOCdevkit layout, optionally with a
    COCO-as-VOC pretraining list (a file of "img,mask" pairs relative to
    its directory). Validation resizes both to the crop."""

    NUM_CLASSES = 21

    def __init__(self, root, train=True, crop_size=(512, 512), scale=(0.5, 2.0),
                 batch_size=16, seed=0, coco_list=None, year="2012"):
        base = os.path.join(root, f"VOC{year}")
        split = "train" if train else "val"
        lf = os.path.join(base, "ImageSets", "Segmentation", split + ".txt")
        if not os.path.isfile(lf):
            raise FileNotFoundError(f"{lf} missing: place the VOCdevkit there, or use "
                                    "SyntheticSegmentation for smoke runs")
        with open(lf) as f:
            ids = [line.strip() for line in f if line.strip()]
        self.pairs = [(os.path.join(base, "JPEGImages", i + ".jpg"),
                       os.path.join(base, "SegmentationClass", i + ".png")) for i in ids]
        if coco_list and os.path.isfile(coco_list):
            root_dir = os.path.dirname(coco_list)
            with open(coco_list) as f:
                self.pairs += [tuple(os.path.join(root_dir, p) for p in line.strip().split(",")[:2])
                               for line in f if line.strip()]
        self.train, self.batch_size, self.seed = train, batch_size, seed
        self.tf = PairedTransforms(crop_size, scale)

    def __len__(self):
        return len(self.pairs) // self.batch_size

    def __iter__(self):
        Image = _pil_image()
        rng = np.random.RandomState(self.seed)
        order = rng.permutation(len(self.pairs)) if self.train else np.arange(len(self.pairs))
        for b in range(len(self)):
            ims, ms = [], []
            for i in order[b * self.batch_size:(b + 1) * self.batch_size]:
                img = np.asarray(Image.open(self.pairs[i][0]).convert("RGB"))
                mask = np.asarray(Image.open(self.pairs[i][1]))
                if self.train:
                    img, mask = self.tf(img, mask, rng)
                else:
                    ch, cw = self.tf.crop_size
                    img = np.asarray(Image.fromarray(img).resize((cw, ch), Image.BILINEAR))
                    mask = np.asarray(Image.fromarray(mask).resize((cw, ch), Image.NEAREST))
                    img = _normalize(img, self.tf.mean, self.tf.std)
                    mask = mask.astype(np.int32)
                ims.append(img)
                ms.append(mask)
            yield {"image": np.stack(ims).astype(np.float32), "label": np.stack(ms)}
