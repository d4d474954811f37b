"""Detection datasets and the SSD augmentation (``frostnet_tpu/detection/data.py``).

Host numpy, batch for batch the JAX package's from the same files and
seeds: the VOC XML and COCO JSON readers, the reference's SSD train
pipeline (photometric distortions through an HSV round trip, expand with
mean fill, the random crop with its center-in-crop rule, mirror) and the
fixed-shape batches ``{"image": (B, 300, 300, 3) float32 BGR, mean
subtracted, "boxes": (B, MAX_GT, 4) point-form in [0, 1], "labels": (B,
MAX_GT) int32, "valid": (B, MAX_GT) bool}``. Images are decoded and
resized with PIL, imported where it is used (``_pil_image``): the readers
of files and ``ssd_augment`` raise an ``ImportError`` that names PIL where
it is missing; ``SyntheticDetection`` needs none.
"""
from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from typing import Iterator, List, Tuple

import numpy as np

VOC_CLASSES = (
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor")

MEANS = (104, 117, 123)  # BGR means (data/config.py:15)
MAX_GT = 50


def _pil_image():
    """``PIL.Image``, or an ImportError that names PIL (Pillow)."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("the detection datasets of files and ssd_augment decode and resize "
                          "images with PIL (Pillow), which is not installed; "
                          "SyntheticDetection needs none") from e
    return Image


def _rgb_to_hsv(img):
    """Vectorized RGB->HSV on [0,255] floats (h in [0,360), s in [0,1])."""
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    mx = img.max(-1)
    mn = img.min(-1)
    d = mx - mn
    h = np.zeros_like(mx)
    nz = d > 0
    rm, gm, bm = (mx == r) & nz, (mx == g) & nz & (mx != r), nz & (mx != r) & (mx != g)
    h[rm] = (60 * ((g - b) / np.where(d == 0, 1, d)) % 360)[rm]
    h[gm] = (60 * ((b - r) / np.where(d == 0, 1, d)) + 120)[gm]
    h[bm] = (60 * ((r - g) / np.where(d == 0, 1, d)) + 240)[bm]
    s = np.where(mx > 0, d / np.where(mx == 0, 1, mx), 0.0)
    return np.stack([h, s, mx], -1)


def _hsv_to_rgb(hsv):
    h, s, v = hsv[..., 0] % 360, np.clip(hsv[..., 1], 0, 1), hsv[..., 2]
    c = v * s
    x = c * (1 - np.abs((h / 60) % 2 - 1))
    m = v - c
    z = np.zeros_like(c)
    conds = [(h < 60), (h < 120), (h < 180), (h < 240), (h < 300), (h >= 300)]
    rgbs = [(c, x, z), (x, c, z), (z, c, x), (z, x, c), (x, z, c), (c, z, x)]
    out = np.zeros(hsv.shape, np.float32)
    done = np.zeros(c.shape, bool)
    for cond, (rr, gg, bb) in zip(conds, rgbs):
        sel = cond & ~done
        out[..., 0][sel] = rr[sel]
        out[..., 1][sel] = gg[sel]
        out[..., 2][sel] = bb[sel]
        done |= cond
    return out + m[..., None]


def _photometric(img, rng):
    """PhotometricDistort (augmentations.py:376-398): RandomBrightness, then
    either (contrast -> saturation/hue) or (saturation/hue -> contrast) via
    the HSV round trip, then RandomLightingNoise (channel swap) — the full
    reference op set with the reference's parameter ranges."""
    img = img.astype(np.float32)
    if rng.randint(2):  # RandomBrightness(delta=32)
        img += rng.uniform(-32, 32)

    def contrast(im):
        if rng.randint(2):  # RandomContrast(0.5, 1.5)
            im = im * rng.uniform(0.5, 1.5)
        return im

    def sat_hue(im):
        hsv = _rgb_to_hsv(np.clip(im, 0, 255))
        if rng.randint(2):  # RandomSaturation(0.5, 1.5)
            hsv[..., 1] *= rng.uniform(0.5, 1.5)
        if rng.randint(2):  # RandomHue(delta=18)
            hsv[..., 0] += rng.uniform(-18, 18)
        return _hsv_to_rgb(hsv)

    if rng.randint(2):  # distort order (augmentations.py PhotometricDistort)
        img = sat_hue(contrast(img))
    else:
        img = contrast(sat_hue(img))
    if rng.randint(2):  # RandomLightingNoise: random channel permutation
        img = img[..., rng.permutation(3)]
    return np.clip(img, 0, 255)


def _expand(img, boxes, rng):
    """Expand (zoom-out) with mean fill."""
    if rng.randint(2):
        return img, boxes
    h, w, c = img.shape
    ratio = rng.uniform(1, 4)
    left = rng.uniform(0, w * ratio - w)
    top = rng.uniform(0, h * ratio - h)
    out = np.zeros((int(h * ratio), int(w * ratio), c), img.dtype)
    # The working frame here is RGB; the reference fills its cv2 BGR frame
    # with MEANS so that after SubtractMeans the fill is exactly 0
    # (augmentations.py:313-328). Fill the channel-reversed means so our
    # RGB->BGR flip + subtract in ssd_augment lands on the same 0 fill.
    out[...] = MEANS[::-1]
    out[int(top):int(top) + h, int(left):int(left) + w] = img
    boxes = boxes.copy()
    boxes[:, [0, 2]] += left
    boxes[:, [1, 3]] += top
    return out, boxes


def _random_crop(img, boxes, labels, rng):
    """RandomSampleCrop (augmentations.py:208-310). NOTE: the reference's
    IoU constraint is INERT — its reject condition
    ``overlap.min() < min_iou and max_iou < overlap.max()`` can never fire
    with max_iou=inf (the well-known ssd.pytorch 'and'-for-'or' bug), so the
    effective keep rule is center-in-crop only, which is what this
    implements."""
    h, w = img.shape[:2]
    for _ in range(20):
        mode = rng.choice([0, 1, 2, 3, 4, 5])
        if mode == 0:
            return img, boxes, labels
        cw = rng.uniform(0.3 * w, w)
        ch = rng.uniform(0.3 * h, h)
        if not 0.5 <= cw / ch <= 2:
            continue
        x0 = rng.uniform(0, w - cw)
        y0 = rng.uniform(0, h - ch)
        rect = np.array([x0, y0, x0 + cw, y0 + ch])
        centers = (boxes[:, :2] + boxes[:, 2:]) / 2
        mask = ((centers[:, 0] > rect[0]) & (centers[:, 0] < rect[2]) &
                (centers[:, 1] > rect[1]) & (centers[:, 1] < rect[3]))
        if not mask.any():
            continue
        nb = boxes[mask].copy()
        nb[:, :2] = np.maximum(nb[:, :2], rect[:2]) - rect[:2]
        nb[:, 2:] = np.minimum(nb[:, 2:], rect[2:]) - rect[:2]
        return (img[int(y0):int(y0 + ch), int(x0):int(x0 + cw)], nb, labels[mask])
    return img, boxes, labels


def ssd_augment(img, boxes, labels, rng, size=300, train=True):
    """Full SSDAugmentation pipeline -> (img (size,size,3) f32 mean-sub BGR,
    boxes normalized point-form, labels)."""
    Image = _pil_image()
    img = np.asarray(img, np.float32)
    if train and len(boxes):
        img = _photometric(img, rng)
        img, boxes = _expand(img, boxes, rng)
        img, boxes, labels = _random_crop(img, boxes, labels, rng)
        if rng.randint(2):  # mirror
            img = img[:, ::-1]
            h, w = img.shape[:2]
            boxes = boxes.copy()
            boxes[:, [0, 2]] = w - boxes[:, [2, 0]]
    h, w = img.shape[:2]
    boxes = boxes / np.array([w, h, w, h], np.float32) if len(boxes) else boxes
    img = np.asarray(
        Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).resize((size, size)),
        np.float32)
    img = img[..., ::-1] - MEANS  # RGB->BGR, mean subtract (BaseTransform)
    return img.astype(np.float32), np.asarray(boxes, np.float32), labels


def pad_targets(boxes, labels, max_gt=MAX_GT):
    gb = np.zeros((max_gt, 4), np.float32)
    gl = np.zeros((max_gt,), np.int32)
    gv = np.zeros((max_gt,), bool)
    n = min(len(boxes), max_gt)
    if n:
        gb[:n] = boxes[:n]
        gl[:n] = labels[:n]
        gv[:n] = True
    return gb, gl, gv


class VOCDetection:
    """VOC07+12 dataset from the standard VOCdevkit layout
    (data/voc0712.py:26-179)."""

    def __init__(self, root, image_sets=(("2007", "trainval"), ("2012", "trainval")),
                 size=300, batch_size=32, train=True, seed=0, keep_difficult=False):
        self.root = root
        self.size = size
        self.batch_size = batch_size
        self.train = train
        self.seed = seed
        self.keep_difficult = keep_difficult
        self.ids: List[Tuple[str, str]] = []
        for year, name in image_sets:
            base = os.path.join(root, f"VOC{year}")
            lf = os.path.join(base, "ImageSets", "Main", name + ".txt")
            if not os.path.isfile(lf):
                raise FileNotFoundError(
                    f"{lf} missing — place the VOCdevkit there or use "
                    "SyntheticDetection for smoke runs.")
            with open(lf) as f:
                self.ids += [(base, line.strip()) for line in f if line.strip()]
        self.class_to_idx = {c: i for i, c in enumerate(VOC_CLASSES)}

    def __len__(self):
        return len(self.ids) // self.batch_size

    def _parse(self, base, img_id):
        """(img_path, boxes_px xyxy, labels) from the XML annotation."""
        boxes, labels = [], []
        tree = ET.parse(os.path.join(base, "Annotations", img_id + ".xml"))
        for obj in tree.iter("object"):
            difficult = int(obj.find("difficult").text) == 1
            if difficult and not self.keep_difficult:
                continue
            name = obj.find("name").text.lower().strip()
            bb = obj.find("bndbox")
            boxes.append([float(bb.find(k).text) - (1 if k in ("xmin", "ymin") else 0)
                          for k in ("xmin", "ymin", "xmax", "ymax")])
            labels.append(self.class_to_idx[name])
        return (os.path.join(base, "JPEGImages", img_id + ".jpg"),
                np.asarray(boxes, np.float32).reshape(-1, 4),
                np.asarray(labels, np.int32))

    def annotations(self):
        """All (paths, boxes, labels): the native loader's input (the XML
        parsing stays here; decode and augmentation move to the C++ pool)."""
        parsed = [self._parse(*pair) for pair in self.ids]
        return ([p for p, _, _ in parsed], [b for _, b, _ in parsed],
                [lb for _, _, lb in parsed])

    def _load(self, base, img_id, rng):
        Image = _pil_image()
        path, boxes, labels = self._parse(base, img_id)
        img = np.asarray(Image.open(path).convert("RGB"))
        return ssd_augment(img, boxes, labels, rng, self.size, self.train)

    def __iter__(self):
        rng = np.random.RandomState(self.seed)
        order = rng.permutation(len(self.ids)) if self.train else np.arange(len(self.ids))
        for b in range(len(self)):
            idx = order[b * self.batch_size:(b + 1) * self.batch_size]
            ims, gbs, gls, gvs = [], [], [], []
            for i in idx:
                img, boxes, labels = self._load(*self.ids[i], rng)
                gb, gl, gv = pad_targets(boxes, labels)
                ims.append(img); gbs.append(gb); gls.append(gl); gvs.append(gv)
            yield {"image": np.stack(ims), "boxes": np.stack(gbs),
                   "labels": np.stack(gls), "valid": np.stack(gvs)}


class SyntheticDetection:
    """Deterministic fake detection batches for smoke/bench."""

    def __init__(self, num_classes=20, size=300, length=16, batch_size=4, seed=0):
        self.num_classes = num_classes
        self.size = size
        self.length = length
        self.batch_size = batch_size
        self.seed = seed

    def __len__(self):
        return self.length // self.batch_size

    def __iter__(self) -> Iterator[dict]:
        rng = np.random.RandomState(self.seed)
        for _ in range(len(self)):
            images = rng.randn(self.batch_size, self.size, self.size, 3).astype(np.float32)
            gbs, gls, gvs = [], [], []
            for _ in range(self.batch_size):
                n = rng.randint(1, 6)
                xy = rng.rand(n, 2) * 0.6
                wh = rng.rand(n, 2) * 0.3 + 0.05
                boxes = np.concatenate([xy, np.clip(xy + wh, 0, 1)], 1).astype(np.float32)
                gb, gl, gv = pad_targets(boxes, rng.randint(0, self.num_classes, n))
                gbs.append(gb); gls.append(gl); gvs.append(gv)
            yield {"image": images, "boxes": np.stack(gbs),
                   "labels": np.stack(gls), "valid": np.stack(gvs)}


class COCODetection:
    """COCO detection from the standard layout (annotations/instances_*.json
    + images dir), parsed directly from JSON (no pycocotools dependency;
    reference Object_Detection/data/coco.py uses pycocotools). Labels are
    contiguous 0..79 in category-id order."""

    def __init__(self, root, split="train2017", size=300, batch_size=32,
                 train=True, seed=0):
        import json as _json

        ann = os.path.join(root, "annotations", f"instances_{split}.json")
        if not os.path.isfile(ann):
            raise FileNotFoundError(
                f"{ann} missing — place the COCO dataset there or use "
                "SyntheticDetection for smoke runs.")
        with open(ann) as f:
            data = _json.load(f)
        cats = sorted(c["id"] for c in data["categories"])
        self.cat_to_label = {c: i for i, c in enumerate(cats)}
        self.num_classes = len(cats)
        imgs = {im["id"]: im for im in data["images"]}
        per_img = {}
        for a in data["annotations"]:
            if a.get("iscrowd"):
                continue
            x, y, w, h = a["bbox"]
            if w <= 1 or h <= 1:
                continue
            per_img.setdefault(a["image_id"], []).append(
                (x, y, x + w, y + h, self.cat_to_label[a["category_id"]]))
        self.samples = [
            (os.path.join(root, split, imgs[i]["file_name"]), anns)
            for i, anns in per_img.items() if i in imgs]
        self.size = size
        self.batch_size = batch_size
        self.train = train
        self.seed = seed

    def __len__(self):
        return len(self.samples) // self.batch_size

    def annotations(self):
        """All (paths, boxes, labels) for the native loader."""
        paths = [p for p, _ in self.samples]
        boxes = [np.asarray([a[:4] for a in anns], np.float32).reshape(-1, 4)
                 for _, anns in self.samples]
        labels = [np.asarray([a[4] for a in anns], np.int32) for _, anns in self.samples]
        return paths, boxes, labels


    def __iter__(self):
        Image = _pil_image()
        rng = np.random.RandomState(self.seed)
        order = rng.permutation(len(self.samples)) if self.train else np.arange(len(self.samples))
        for b in range(len(self)):
            ims, gbs, gls, gvs = [], [], [], []
            for i in order[b * self.batch_size:(b + 1) * self.batch_size]:
                path, anns = self.samples[i]
                img = np.asarray(Image.open(path).convert("RGB"))
                boxes = np.asarray([a[:4] for a in anns], np.float32).reshape(-1, 4)
                labels = np.asarray([a[4] for a in anns], np.int32)
                img, boxes, labels = ssd_augment(img, boxes, labels, rng,
                                                 self.size, self.train)
                gb, gl, gv = pad_targets(boxes, labels)
                ims.append(img); gbs.append(gb); gls.append(gl); gvs.append(gv)
            yield {"image": np.stack(ims), "boxes": np.stack(gbs),
                   "labels": np.stack(gls), "valid": np.stack(gvs)}
