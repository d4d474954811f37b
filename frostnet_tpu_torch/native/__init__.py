"""Native (C++) data loaders (``frostnet_tpu/native``).

``native/dataloader.cpp`` is a GIL-free pool of C++ threads that decodes
JPEG and PNG with libjpeg and libpng, augments, and ships whole batches
(the reference's DataLoader worker pool, SURVEY.md §2.6). The three
loaders here wrap its three pools with the signatures and the yielded
dicts of ``frostnet_tpu/native/__init__.py``:

* :class:`NativeClassificationLoader` (``from_folder``): image-folder JPEGs,
  random-resized-crop and flip (train) or resize and center crop (eval),
  float32 normalized or raw uint8 (``output="uint8"``: the train step
  normalizes on the card, ``train/state.py::prep_image``);
* :class:`NativeSegmentationLoader` (``from_file_list``): image and mask
  pairs, flip, scale jitter, pad and crop, uint8 images and int32 labels;
* :class:`NativeDetectionLoader`: the SSD augmentation, uint8 images and
  padded boxes, labels and ``valid``.

What the port adds: each loader takes ``rank`` and ``world`` (default 0 and
1) and yields only rank ``r``'s rows of each global batch of
``batch_size``, the contiguous block ``parallel.shard_rows`` gives replica
``r``. In train mode the pool still draws the other rows' augmentation
(from the image headers), so at ``threads=1`` the ranks' blocks,
concatenated, are the ``(0, 1)`` batch. With more threads the batches'
order and which worker draws each batch's augmentation change from run to
run, as in the JAX loader. Every pass (``__iter__``) makes a new pool with
the same seed, so every epoch reads the files in the same order, as the JAX
loader does.

The shared object is built by ``g++`` at first use into
``build/frostnet_tpu_torch/`` under the repository root, beside the CUDA
kernels (``ops/cuda_build.py``), keyed by a hash of the source and the
flags and of the machine (``-march=native`` code runs only where it was
built). A failed build raises with the compiler's output: a trainer asked
for ``loader='native'`` never falls back to the PIL loader.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Iterator, Optional, Sequence

import numpy as np

SRC = Path(__file__).resolve().parent / "dataloader.cpp"
BUILD_ROOT = Path(__file__).resolve().parent.parent.parent / "build" / "frostnet_tpu_torch"
# -march=native: the resample's float math contracts into FMAs as the
# build machine's ISA allows, as the JAX package's build does
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")
LIBS = ("-ljpeg", "-lpng", "-lpthread")

_lib = None
_lib_lock = threading.Lock()


def _machine() -> str:
    """The host's name and CPU model: a ``-march=native`` build is kept per machine."""
    model = ""
    try:
        with open("/proc/cpuinfo") as f:
            model = next((line for line in f if line.startswith("model name")), "")
    except OSError:
        pass
    return f"{os.uname().nodename} {model}"


def library_path(source: Optional[Path] = None) -> Path:
    source = source or SRC
    h = hashlib.sha256(" ".join(CXX_FLAGS + LIBS).encode())
    h.update(_machine().encode())
    h.update(source.read_bytes())
    return BUILD_ROOT / f"native-{h.hexdigest()[:16]}" / "_dataloader.so"


def build(source: Optional[Path] = None) -> Path:
    """Compile ``source`` (by default ``SRC``) with g++ unless it is built;
    returns the library. Raises ``RuntimeError`` with the compiler's output
    if the build fails."""
    source = source or SRC
    out = library_path(source)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cmd = ["g++", *CXX_FLAGS, str(source), "-o", tmp, *LIBS]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError as e:
        os.unlink(tmp)
        raise RuntimeError(f"the native loader needs g++, libjpeg and libpng: {e}") from e
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"the native loader's build failed ({' '.join(cmd)}):\n"
                           f"{proc.stderr}")
    os.replace(tmp, out)
    return out


def _load_lib():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            p, i, u, ll, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_long,
                              ctypes.c_float)
            strs, ints, floats = (ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_int),
                                  ctypes.POINTER(ctypes.c_float))
            lib.fndl_create.restype = p
            lib.fndl_create.argtypes = [strs, ints, ll, i, i, i, i, u, i, floats, floats, i, i, i]
            lib.fndl_next.restype = i
            lib.fndl_next.argtypes = [p, p, ints]
            lib.fndt_create.restype = p
            lib.fndt_create.argtypes = [strs, floats, ints, ints, ll, i, i, i, i, i, u, i, i, i]
            lib.fndt_next.restype = i
            lib.fndt_next.argtypes = [p, p, p, p, p]
            lib.fnsl_create.restype = p
            lib.fnsl_create.argtypes = [strs, strs, ll, i, i, i, i, i, u, i, f, f, i, i, i]
            lib.fnsl_next.restype = i
            lib.fnsl_next.argtypes = [p, p, p]
            for pool in ("fndl", "fndt", "fnsl"):
                getattr(lib, f"{pool}_destroy").argtypes = [p]
                getattr(lib, f"{pool}_batches_per_epoch").restype = ll
                getattr(lib, f"{pool}_batches_per_epoch").argtypes = [p]
            _lib = lib
    return _lib


def _rows(batch_size: int, rank: int, world: int) -> int:
    """Rows a rank yields of each global batch."""
    if world < 1 or not 0 <= rank < world or batch_size % world:
        raise ValueError(f"rank {rank} of world {world} cannot split a batch of {batch_size} "
                         "into equal blocks")
    return batch_size // world


class NativeClassificationLoader:
    """Iterates {'image': (B,S,S,3) f32 or u8, 'label': (B,) i32} batches decoded
    and augmented by C++ worker threads; B is ``batch_size // world``."""

    def __init__(self, paths: Sequence[str], labels: Sequence[int],
                 batch_size: int = 64, image_size: int = 224,
                 threads: Optional[int] = None,
                 train: bool = True, seed: int = 0, queue_depth: int = 4,
                 mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225),
                 output: str = "float32", rank: int = 0, world: int = 1):
        if output not in ("float32", "uint8"):
            raise ValueError(f"output must be float32|uint8, got {output!r}")
        self.output = output
        self.rows = _rows(batch_size, rank, world)
        if threads is None:
            # decode threads are syscall and IO heavy: oversubscribe. Each
            # worker holds one built batch while it waits to enqueue, so the
            # pool holds up to (threads + queue_depth) batches: a float32
            # 224px batch of 256 is ~154 MB, so cap the pool there (uint8
            # batches are 4x smaller and keep the wide pool)
            threads = max(32, os.cpu_count() or 1)
            if output == "float32":
                threads = min(threads, 8)
        self.lib = _load_lib()
        self.batch_size = batch_size
        self.image_size = image_size
        self._paths = [p.encode() for p in paths]
        self._labels = np.asarray(labels, np.int32)
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        self._args = (threads, train, seed, queue_depth, self.mean, self.std, rank, world)

    @classmethod
    def from_folder(cls, root: str, **kw):
        """An image folder: one directory a class (sorted), its JPEGs sorted."""
        classes = sorted(d for d in os.listdir(root)
                         if os.path.isdir(os.path.join(root, d)))
        c2i = {c: i for i, c in enumerate(classes)}
        paths, labels = [], []
        for c in classes:
            cdir = os.path.join(root, c)
            for f in sorted(os.listdir(cdir)):
                if f.lower().endswith((".jpg", ".jpeg")):
                    paths.append(os.path.join(cdir, f))
                    labels.append(c2i[c])
        return cls(paths, labels, **kw)

    def __len__(self):
        return len(self._paths) // self.batch_size

    def __iter__(self) -> Iterator[dict]:
        threads, train, seed, qd, mean, std, rank, world = self._args
        arr = (ctypes.c_char_p * len(self._paths))(*self._paths)
        handle = self.lib.fndl_create(
            arr, self._labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            len(self._paths), self.batch_size, self.image_size, threads,
            int(train), seed, qd,
            mean.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            std.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            int(self.output == "uint8"), rank, world)
        dtype = np.uint8 if self.output == "uint8" else np.float32
        try:
            s = self.image_size
            while True:
                images = np.empty((self.rows, s, s, 3), dtype)
                labels = np.empty((self.rows,), np.int32)
                ok = self.lib.fndl_next(
                    handle, images.ctypes.data_as(ctypes.c_void_p),
                    labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
                if not ok:
                    return
                yield {"image": images, "label": labels}
        finally:
            self.lib.fndl_destroy(handle)


class NativeSegmentationLoader:
    """Paired (image, mask) loader: PNG/JPEG decode, synchronized hflip +
    scale-jitter + pad + crop (image bilinear, mask nearest — the reference
    data_transforms.py:18-166 pipeline), raw uint8 RGB out.

    Yields {'image': (B,H,W,3) u8, 'label': (B,H,W) i32} with B
    ``batch_size // world``; eval (train=False) whole-frame-resizes to
    crop_size (identity at the native resolution)."""

    def __init__(self, img_paths: Sequence[str], mask_paths: Sequence[str],
                 crop_size=(768, 768), batch_size: int = 16,
                 threads: Optional[int] = None, train: bool = True,
                 seed: int = 0, queue_depth: int = 4, scale=(0.5, 2.0),
                 ignore: int = 255, rank: int = 0, world: int = 1):
        if len(img_paths) != len(mask_paths):
            raise ValueError("img_paths and mask_paths must pair up")
        self.rows = _rows(batch_size, rank, world)
        if threads is None:
            # bound the pool by batch bytes, (threads + queue_depth) batches:
            # 768^2 crops of 16 are ~38 MB, but Cityscapes' native-size eval
            # batches (1024x2048) of 16 are ~134 MB and must not fan out to
            # 32 workers
            batch_bytes = self.rows * crop_size[0] * crop_size[1] * 4
            budget = 1.5e9
            threads = max(4, min(max(32, os.cpu_count() or 1),
                                 int(budget // max(batch_bytes, 1)) - queue_depth))
        self.lib = _load_lib()
        self.batch_size = batch_size
        self.crop_size = tuple(crop_size)
        self._imgs = [p.encode() for p in img_paths]
        self._masks = [p.encode() for p in mask_paths]
        self._args = (threads, train, seed, queue_depth, scale, ignore, rank, world)

    @classmethod
    def from_file_list(cls, root: str, list_name: str, **kw):
        """``root/list_name`` lines of "img_path,mask_path" relative to root
        — the layout CityscapesSegmentation reads."""
        with open(os.path.join(root, list_name)) as f:
            pairs = [line.strip().split(",")[:2] for line in f if line.strip()]
        return cls([os.path.join(root, a) for a, _ in pairs],
                   [os.path.join(root, b) for _, b in pairs], **kw)

    def __len__(self):
        return len(self._imgs) // self.batch_size

    def __iter__(self) -> Iterator[dict]:
        threads, train, seed, qd, scale, ignore, rank, world = self._args
        img_arr = (ctypes.c_char_p * len(self._imgs))(*self._imgs)
        mask_arr = (ctypes.c_char_p * len(self._masks))(*self._masks)
        ch, cw = self.crop_size
        handle = self.lib.fnsl_create(
            img_arr, mask_arr, len(self._imgs), self.batch_size, ch, cw,
            threads, int(train), seed, qd,
            ctypes.c_float(scale[0]), ctypes.c_float(scale[1]), ignore, rank, world)
        try:
            while True:
                images = np.empty((self.rows, ch, cw, 3), np.uint8)
                masks = np.empty((self.rows, ch, cw), np.uint8)
                ok = self.lib.fnsl_next(
                    handle, images.ctypes.data_as(ctypes.c_void_p),
                    masks.ctypes.data_as(ctypes.c_void_p))
                if not ok:
                    return
                yield {"image": images, "label": masks.astype(np.int32)}
        finally:
            self.lib.fnsl_destroy(handle)


class NativeDetectionLoader:
    """SSD detection loader: JPEG/PNG decode + the train augmentation
    (photometric distort, mean-fill expand, center-rule random crop,
    mirror, squash-resize — ``detection/data.py::ssd_augment``). Emits raw
    uint8 RGB; the BGR flip and mean subtraction run on the card
    (``detection/train.py::prep_det_image``).

    Yields {'image': (B,S,S,3) u8, 'boxes': (B,M,4) f32 normalized xyxy,
    'labels': (B,M) i32, 'valid': (B,M) bool} with B ``batch_size //
    world``: the padded-target layout of VOCDetection."""

    def __init__(self, img_paths: Sequence[str], boxes, labels,
                 max_boxes: int = 50, batch_size: int = 32, size: int = 300,
                 threads: Optional[int] = None, train: bool = True,
                 seed: int = 0, queue_depth: int = 4, rank: int = 0, world: int = 1):
        if not (len(img_paths) == len(boxes) == len(labels)):
            raise ValueError("img_paths/boxes/labels must pair up")
        self.rows = _rows(batch_size, rank, world)
        if threads is None:
            threads = max(32, os.cpu_count() or 1)
        self.lib = _load_lib()
        self.batch_size = batch_size
        self.size = size
        self.max_boxes = max_boxes
        self._paths = [p.encode() for p in img_paths]
        counts = np.array([len(b) for b in boxes], np.int32)
        flat_boxes = (np.concatenate([np.asarray(b, np.float32).reshape(-1, 4)
                                      for b in boxes])
                      if counts.sum() else np.zeros((0, 4), np.float32))
        flat_labels = (np.concatenate([np.asarray(lb, np.int32).reshape(-1)
                                       for lb in labels])
                       if counts.sum() else np.zeros((0,), np.int32))
        self._counts = counts
        self._flat_boxes = np.ascontiguousarray(flat_boxes, np.float32)
        self._flat_labels = np.ascontiguousarray(flat_labels, np.int32)
        self._args = (threads, train, seed, queue_depth, rank, world)

    def __len__(self):
        return len(self._paths) // self.batch_size

    def __iter__(self) -> Iterator[dict]:
        threads, train, seed, qd, rank, world = self._args
        arr = (ctypes.c_char_p * len(self._paths))(*self._paths)
        handle = self.lib.fndt_create(
            arr, self._flat_boxes.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            self._counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            self._flat_labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            len(self._paths), self.max_boxes, self.batch_size, self.size,
            threads, int(train), seed, qd, rank, world)
        s, m = self.size, self.max_boxes
        try:
            while True:
                images = np.empty((self.rows, s, s, 3), np.uint8)
                bxs = np.empty((self.rows, m, 4), np.float32)
                lbs = np.empty((self.rows, m), np.int32)
                cnt = np.empty((self.rows,), np.int32)
                ok = self.lib.fndt_next(
                    handle, images.ctypes.data_as(ctypes.c_void_p),
                    bxs.ctypes.data_as(ctypes.c_void_p),
                    lbs.ctypes.data_as(ctypes.c_void_p),
                    cnt.ctypes.data_as(ctypes.c_void_p))
                if not ok:
                    return
                valid = np.arange(m)[None, :] < cnt[:, None]
                yield {"image": images, "boxes": bxs, "labels": lbs,
                       "valid": valid}
        finally:
            self.lib.fndt_destroy(handle)
