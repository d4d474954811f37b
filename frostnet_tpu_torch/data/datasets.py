"""Host-side datasets (``frostnet_tpu/data/datasets.py``).

Dataset iterators yield dicts of numpy batches, NHWC float32 images
normalized on the host and int32 labels, the same batches as the JAX
package's for the same seed (the same numpy draws in the same order). A
deterministic synthetic source serves smoke runs and benchmarks; the
downloaders raise with instructions instead of fetching. PIL is imported
only by the image-folder path, and its absence is an error that names it.
"""
from __future__ import annotations

import os
from typing import Iterator

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def _require_pil():
    """Fail early, and by name, where PIL (Pillow) is missing."""
    try:
        import PIL.Image  # noqa: F401
    except ImportError as e:
        raise ImportError("FolderClassification and RandAugment decode and transform "
                          "images with PIL (Pillow), which is not installed") from e


class SyntheticClassification:
    """Deterministic fake image/label stream (fixed seed per epoch).

    Mirrors the shape contract of the reference loaders
    (Classification/utils/data_functions.py:247-258) without I/O — used by
    smoke tests and throughput runs.
    """

    def __init__(self, num_classes=1000, image_size=224, length=1024,
                 batch_size=64, seed=0, dtype=np.float32):
        self.num_classes = num_classes
        self.image_size = image_size
        self.length = length
        self.batch_size = batch_size
        self.seed = seed
        self.dtype = dtype

    def __len__(self):
        return self.length // self.batch_size

    def __iter__(self) -> Iterator[dict]:
        rng = np.random.RandomState(self.seed)
        for _ in range(len(self)):
            yield {
                "image": rng.randn(
                    self.batch_size, self.image_size, self.image_size, 3
                ).astype(self.dtype),
                "label": rng.randint(
                    0, self.num_classes, (self.batch_size,), dtype=np.int32),
            }


class FolderClassification:
    """ImageFolder-style dataset: root/<class>/<image>. JPEG decode via PIL
    on host threads; resize+crop+flip+normalize (the torchvision transform
    stack at reference data_functions.py:12-209)."""

    def __init__(self, root, image_size=224, batch_size=64, train=True,
                 seed=0, mean=IMAGENET_MEAN, std=IMAGENET_STD,
                 randaugment=None):
        _require_pil()
        self.root = root
        self.image_size = image_size
        self.batch_size = batch_size
        self.train = train
        self.seed = seed
        self.mean, self.std = mean, std
        # the published recipe trains with --aa rand-m9-mstd0.5
        # (training_commands.txt); pass data.RandAugment(...) to enable
        self.randaugment = randaugment if train else None
        classes = sorted(
            d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d)))
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        self.samples = []
        for c in classes:
            cdir = os.path.join(root, c)
            for f in sorted(os.listdir(cdir)):
                if f.lower().endswith((".jpg", ".jpeg", ".png", ".bmp")):
                    self.samples.append((os.path.join(cdir, f), self.class_to_idx[c]))
        if not self.samples:
            raise ValueError(f"no images under {root}")

    @property
    def num_classes(self):
        return len(self.class_to_idx)

    def __len__(self):
        return len(self.samples) // self.batch_size

    def _load(self, path, rng):
        from PIL import Image

        img = Image.open(path).convert("RGB")
        s = self.image_size
        if self.train:
            # RandomResizedCrop-ish: random scale crop + resize + hflip
            w, h = img.size
            scale = rng.uniform(0.7, 1.0)
            cw, ch = int(w * scale), int(h * scale)
            x0 = rng.randint(0, w - cw + 1)
            y0 = rng.randint(0, h - ch + 1)
            img = img.crop((x0, y0, x0 + cw, y0 + ch)).resize((s, s))
            if self.randaugment is not None:
                img = self.randaugment(np.asarray(img, np.uint8), rng)
            arr = np.asarray(img, np.float32) / 255.0
            if rng.rand() < 0.5:
                arr = arr[:, ::-1]
        else:
            w, h = img.size
            r = int(s * 1.14)
            if w < h:
                img = img.resize((r, int(h * r / w)))
            else:
                img = img.resize((int(w * r / h), r))
            w, h = img.size
            x0, y0 = (w - s) // 2, (h - s) // 2
            img = img.crop((x0, y0, x0 + s, y0 + s))
            arr = np.asarray(img, np.float32) / 255.0
        return (arr - self.mean) / self.std

    def __iter__(self):
        rng = np.random.RandomState(self.seed)
        order = rng.permutation(len(self.samples)) if self.train else np.arange(len(self.samples))
        for b in range(len(self)):
            idx = order[b * self.batch_size:(b + 1) * self.batch_size]
            images = np.stack([self._load(self.samples[i][0], rng) for i in idx])
            labels = np.array([self.samples[i][1] for i in idx], np.int32)
            yield {"image": images.astype(np.float32), "label": labels}


def download_data(name: str, data_dir: str):
    """The reference auto-downloads datasets (data_functions.py:12-209);
    the port downloads nothing: it checks the dataset is there and explains."""
    path = os.path.join(data_dir, name)
    if not os.path.isdir(path):
        raise FileNotFoundError(
            f"dataset {name!r} not found at {path}; nothing is downloaded: "
            "place the extracted dataset there, or use "
            "--dataset synthetic for smoke runs.")
    return path


def random_resized_crop(img: np.ndarray, size: int, rng) -> np.ndarray:
    """torchvision RandomResizedCrop(size): scale (0.08,1), ratio (3/4,4/3)."""
    from PIL import Image

    h, w = img.shape[:2]
    area = h * w
    for _ in range(10):
        target = area * rng.uniform(0.08, 1.0)
        ratio = np.exp(rng.uniform(np.log(3 / 4), np.log(4 / 3)))
        cw = int(round(np.sqrt(target * ratio)))
        ch = int(round(np.sqrt(target / ratio)))
        if 0 < cw <= w and 0 < ch <= h:
            y0 = rng.randint(0, h - ch + 1)
            x0 = rng.randint(0, w - cw + 1)
            crop = img[y0:y0 + ch, x0:x0 + cw]
            return np.asarray(Image.fromarray(crop).resize(
                (size, size), Image.BILINEAR))
    return img  # fallback: central no-op when no valid crop was drawn


class CIFARClassification:
    """CIFAR-10/100 from the standard python pickle batches
    (cifar-10-batches-py/ or cifar-100-python/), matching the torchvision
    transforms the reference uses per dataset (data_functions.py:92-131):
    train = RandomResizedCrop(32) + hflip + normalize with the dataset's own
    mean/std (cifar10 std .247/.243/.261, cifar100 .2673/.2564/.2762)."""

    MEAN10 = np.array([0.4914, 0.4822, 0.4465], np.float32)
    STD10 = np.array([0.247, 0.243, 0.261], np.float32)
    MEAN100 = np.array([0.5071, 0.4865, 0.4409], np.float32)
    STD100 = np.array([0.2673, 0.2564, 0.2762], np.float32)

    def __init__(self, root, train=True, batch_size=128, seed=0, cifar100=False):
        import pickle

        sub = "cifar-100-python" if cifar100 else "cifar-10-batches-py"
        base = os.path.join(root, sub)
        if not os.path.isdir(base):
            raise FileNotFoundError(
                f"{base} missing: place the extracted CIFAR archive there "
                "(nothing is downloaded).")
        if cifar100:
            files = ["train"] if train else ["test"]
            label_key = b"fine_labels"
        else:
            files = [f"data_batch_{i}" for i in range(1, 6)] if train else ["test_batch"]
            label_key = b"labels"
        xs, ys = [], []
        for f in files:
            with open(os.path.join(base, f), "rb") as fh:
                d = pickle.load(fh, encoding="bytes")
            xs.append(d[b"data"])
            ys.append(np.asarray(d[label_key]))
        self.images = np.concatenate(xs).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        self.labels = np.concatenate(ys).astype(np.int32)
        self.train = train
        self.batch_size = batch_size
        self.seed = seed
        self.num_classes = 100 if cifar100 else 10
        self.mean = self.MEAN100 if cifar100 else self.MEAN10
        self.std = self.STD100 if cifar100 else self.STD10

    def __len__(self):
        return len(self.images) // self.batch_size

    def __iter__(self):
        rng = np.random.RandomState(self.seed)
        order = rng.permutation(len(self.images)) if self.train else np.arange(len(self.images))
        for b in range(len(self)):
            idx = order[b * self.batch_size:(b + 1) * self.batch_size]
            imgs = self.images[idx]
            if self.train:
                out = np.empty((len(idx), 32, 32, 3), np.uint8)
                for i, im in enumerate(imgs):
                    im = random_resized_crop(im, 32, rng)
                    if rng.rand() < 0.5:
                        im = im[:, ::-1]
                    out[i] = im
                imgs = out
            imgs = (imgs.astype(np.float32) / 255.0 - self.mean) / self.std
            yield {"image": imgs.astype(np.float32), "label": self.labels[idx]}


class MNISTClassification:
    """MNIST/FashionMNIST from the idx-ubyte files, 3-channel-expanded so the
    RGB conv stems apply (the reference normalizes to torchvision's MNIST
    transforms, data_functions.py mnist branch)."""

    def __init__(self, root, train=True, batch_size=128, seed=0):
        import gzip
        import struct

        prefix = "train" if train else "t10k"

        def read_idx(name):
            path = os.path.join(root, name)
            opener = gzip.open if path.endswith(".gz") else open
            if not os.path.exists(path) and os.path.exists(path + ".gz"):
                path += ".gz"
                opener = gzip.open
            if not os.path.exists(path):
                raise FileNotFoundError(f"{path} missing (nothing is downloaded).")
            with opener(path, "rb") as f:
                header = f.read(4)  # idx magic: 0, 0, dtype, ndim
                ndim = header[3]
                dims = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
                return np.frombuffer(f.read(), np.uint8).reshape(dims)

        self.images = read_idx(f"{prefix}-images-idx3-ubyte")
        self.labels = read_idx(f"{prefix}-labels-idx1-ubyte").astype(np.int32)
        self.train = train
        self.batch_size = batch_size
        self.seed = seed
        self.num_classes = 10

    def __len__(self):
        return len(self.images) // self.batch_size

    def __iter__(self):
        rng = np.random.RandomState(self.seed)
        order = rng.permutation(len(self.images)) if self.train else np.arange(len(self.images))
        for b in range(len(self)):
            idx = order[b * self.batch_size:(b + 1) * self.batch_size]
            imgs = self.images[idx].astype(np.float32) / 255.0
            imgs = (imgs - 0.1307) / 0.3081
            imgs = np.repeat(imgs[..., None], 3, axis=-1)
            yield {"image": imgs.astype(np.float32), "label": self.labels[idx]}


class SVHNClassification:
    """SVHN from the official {train,test}_32x32.mat files (MAT5, X as
    (32,32,3,N) uint8, y as (N,1) with 10 meaning digit 0 — remapped to 0
    like torchvision). Transforms follow the reference svhn branch
    (data_functions.py:163-185): train = RandomResizedCrop(32) + hflip +
    normalize; test = normalize only."""

    MEAN = np.array([0.4377, 0.4438, 0.4728], np.float32)
    STD = np.array([0.1980, 0.2010, 0.1970], np.float32)

    def __init__(self, root, train=True, batch_size=128, seed=0):
        from scipy.io import loadmat

        path = os.path.join(root, f"{'train' if train else 'test'}_32x32.mat")
        if not os.path.exists(path):
            raise FileNotFoundError(f"{path} missing: place the official SVHN .mat "
                                    "files there (nothing is downloaded).")
        mat = loadmat(path)
        self.images = np.ascontiguousarray(mat["X"].transpose(3, 0, 1, 2))
        labels = mat["y"].reshape(-1).astype(np.int32)
        self.labels = np.where(labels == 10, 0, labels)
        self.train = train
        self.batch_size = batch_size
        self.seed = seed
        self.num_classes = 10

    def __len__(self):
        return len(self.images) // self.batch_size

    def __iter__(self):
        rng = np.random.RandomState(self.seed)
        order = rng.permutation(len(self.images)) if self.train else np.arange(len(self.images))
        for b in range(len(self)):
            idx = order[b * self.batch_size:(b + 1) * self.batch_size]
            imgs = self.images[idx]
            if self.train:
                out = np.empty((len(idx), 32, 32, 3), np.uint8)
                for i, im in enumerate(imgs):
                    im = random_resized_crop(im, 32, rng)
                    if rng.rand() < 0.5:
                        im = im[:, ::-1]
                    out[i] = im
                imgs = out
            imgs = (imgs.astype(np.float32) / 255.0 - self.MEAN) / self.STD
            yield {"image": imgs.astype(np.float32), "label": self.labels[idx]}


def build_classification_dataset(name: str, data_dir: str, train: bool,
                                 image_size: int = 224, batch_size: int = 64,
                                 seed: int = 0, aa: str = ""):
    """Dataset dispatch over the reference's names (data_functions.py:12-209):
    cifar10/cifar100/svhn/mnist plus any ImageFolder layout (imagenet,
    imagenet_tiny, ILSVRC2015, ...). ``aa`` is a timm-style auto-augment
    spec ('rand-m9-mstd0.5', the published recipe's --aa) applied to the
    ImageFolder train path."""
    key = name.lower()
    root = os.path.join(data_dir, key)
    if key == "cifar10":
        return CIFARClassification(root, train, batch_size, seed)
    if key == "cifar100":
        return CIFARClassification(root, train, batch_size, seed, cifar100=True)
    if key == "svhn":
        return SVHNClassification(root, train, batch_size, seed)
    if key == "mnist":
        return MNISTClassification(root, train, batch_size, seed)
    folder = os.path.join(data_dir, name, "train" if train else "val")
    randaug = None
    if aa and train:
        from .randaugment import RandAugment
        randaug = RandAugment.from_string(aa)
    return FolderClassification(folder, image_size, batch_size, train=train,
                                seed=seed, randaugment=randaug)
