"""PyTorch port, the classification datasets: batches bit-equal to the JAX package's.

Each dataset is written small into ``tmp_path`` in its standard on-disk
format (CIFAR python pickles, MNIST idx files raw and gzipped, SVHN ``.mat``
files, a folder of PNGs), read by both packages with the same seed, and
every batch of an epoch compared exactly: images, labels, dtypes, shapes.
"""
import gzip
import os
import pickle
import struct

import numpy as np
import pytest
import torch

from frostnet_tpu import data as jdata
from frostnet_tpu_torch import data as tdata


def _same_batches(a, b, n_min=1):
    got, want = list(a), list(b)
    assert len(got) == len(want) >= n_min
    for g, w in zip(got, want):
        assert set(g) == set(w) == {"image", "label"}
        for k in g:
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    return got


def test_synthetic():
    kw = dict(num_classes=10, image_size=16, length=20, batch_size=4, seed=3)
    got = _same_batches(tdata.SyntheticClassification(**kw), jdata.SyntheticClassification(**kw), 5)
    assert got[0]["image"].dtype == np.float32 and got[0]["label"].dtype == np.int32


def _write_cifar(root, cifar100):
    rng = np.random.RandomState(1)
    base = os.path.join(root, "cifar-100-python" if cifar100 else "cifar-10-batches-py")
    os.makedirs(base)
    names = ["train", "test"] if cifar100 else [f"data_batch_{i}" for i in range(1, 6)] + [
        "test_batch"]
    key = b"fine_labels" if cifar100 else b"labels"
    for name in names:
        d = {b"data": rng.randint(0, 256, (6, 3 * 32 * 32)).astype(np.uint8),
             key: list(rng.randint(0, 100 if cifar100 else 10, 6))}
        with open(os.path.join(base, name), "wb") as f:
            pickle.dump(d, f)


@pytest.mark.parametrize("cifar100", [False, True], ids=["cifar10", "cifar100"])
@pytest.mark.parametrize("train", [True, False], ids=["train", "test"])
def test_cifar(tmp_path, cifar100, train):
    name = "cifar100" if cifar100 else "cifar10"
    _write_cifar(str(tmp_path / name), cifar100)
    a = tdata.build_classification_dataset(name, str(tmp_path), train, batch_size=4, seed=5)
    b = jdata.build_classification_dataset(name, str(tmp_path), train, batch_size=4, seed=5)
    assert isinstance(a, tdata.CIFARClassification) and a.num_classes == (100 if cifar100 else 10)
    _same_batches(a, b)


def _idx(arr):
    header = bytes([0, 0, 8, arr.ndim]) + struct.pack(">" + "I" * arr.ndim, *arr.shape)
    return header + arr.astype(np.uint8).tobytes()


@pytest.mark.parametrize("gz", [False, True], ids=["raw", "gz"])
def test_mnist(tmp_path, gz):
    root = tmp_path / "mnist"
    root.mkdir()
    rng = np.random.RandomState(2)
    for prefix, n in (("train", 12), ("t10k", 8)):
        files = {f"{prefix}-images-idx3-ubyte": _idx(rng.randint(0, 256, (n, 28, 28))),
                 f"{prefix}-labels-idx1-ubyte": _idx(rng.randint(0, 10, (n,)))}
        for name, blob in files.items():
            if gz:
                with gzip.open(root / (name + ".gz"), "wb") as f:
                    f.write(blob)
            else:
                (root / name).write_bytes(blob)
    for train in (True, False):
        a = tdata.build_classification_dataset("mnist", str(tmp_path), train, batch_size=4, seed=1)
        b = jdata.build_classification_dataset("mnist", str(tmp_path), train, batch_size=4, seed=1)
        assert isinstance(a, tdata.MNISTClassification)
        got = _same_batches(a, b, 2)
        assert got[0]["image"].shape == (4, 28, 28, 3)


def test_svhn(tmp_path):
    from scipy.io import savemat

    root = tmp_path / "svhn"
    root.mkdir()
    rng = np.random.RandomState(4)
    for split, n in (("train", 10), ("test", 6)):
        y = rng.randint(1, 11, (n, 1)).astype(np.uint8)  # 10 stands for the digit 0
        savemat(str(root / f"{split}_32x32.mat"),
                {"X": rng.randint(0, 256, (32, 32, 3, n)).astype(np.uint8), "y": y})
    for train in (True, False):
        a = tdata.build_classification_dataset("svhn", str(tmp_path), train, batch_size=3, seed=2)
        b = jdata.build_classification_dataset("svhn", str(tmp_path), train, batch_size=3, seed=2)
        assert isinstance(a, tdata.SVHNClassification)
        got = _same_batches(a, b, 2)
        assert all((g["label"] >= 0).all() and (g["label"] <= 9).all() for g in got)


def _write_folder(root):
    from PIL import Image

    rng = np.random.RandomState(6)
    for split in ("train", "val"):
        for c in ("cat", "dog", "emu"):
            d = root / "imagenet_tiny" / split / c
            d.mkdir(parents=True)
            for i in range(3):
                h, w = rng.randint(20, 48, 2)
                Image.fromarray(rng.randint(0, 256, (h, w, 3)).astype(np.uint8)).save(
                    d / f"{i}.png")
        (root / "imagenet_tiny" / split / "notes.txt").write_text("not a class")


@pytest.mark.parametrize("aa", ["", "rand-m9-mstd0.5", "rand-n3-m15"], ids=["plain", "m9", "n3m15"])
def test_image_folder(tmp_path, aa):
    _write_folder(tmp_path)
    for train in (True, False):
        a = tdata.build_classification_dataset("imagenet_tiny", str(tmp_path), train,
                                               image_size=16, batch_size=4, seed=7, aa=aa)
        b = jdata.build_classification_dataset("imagenet_tiny", str(tmp_path), train,
                                               image_size=16, batch_size=4, seed=7, aa=aa)
        assert isinstance(a, tdata.FolderClassification) and a.num_classes == 3
        assert (a.randaugment is not None) == bool(aa and train)
        _same_batches(a, b, 2)


def test_random_resized_crop_and_randaugment_match_jax():
    from frostnet_tpu.data.datasets import random_resized_crop as jcrop

    img = np.random.RandomState(8).randint(0, 256, (40, 30, 3)).astype(np.uint8)
    for seed in range(4):
        np.testing.assert_array_equal(
            tdata.random_resized_crop(img, 24, np.random.RandomState(seed)),
            jcrop(img, 24, np.random.RandomState(seed)))
        np.testing.assert_array_equal(
            tdata.RandAugment.from_string("rand-m9-mstd0.5-n3")(img, np.random.RandomState(seed)),
            jdata.RandAugment.from_string("rand-m9-mstd0.5-n3")(img, np.random.RandomState(seed)))
    with pytest.raises(ValueError):
        tdata.RandAugment.from_string("augmix-m5")


def test_missing_data_raise(tmp_path):
    with pytest.raises(FileNotFoundError, match="nothing is downloaded"):
        tdata.download_data("imagenet", str(tmp_path))
    (tmp_path / "here").mkdir()
    assert tdata.download_data("here", str(tmp_path)) == str(tmp_path / "here")
    for name in ("cifar10", "cifar100", "svhn", "mnist"):
        with pytest.raises(FileNotFoundError):
            tdata.build_classification_dataset(name, str(tmp_path), True)
    with pytest.raises(FileNotFoundError):
        tdata.build_classification_dataset("imagenet", str(tmp_path), True)


def test_image_folder_without_pil_names_it(tmp_path, monkeypatch):
    import builtins

    real = builtins.__import__

    def no_pil(name, *args, **kwargs):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("No module named 'PIL'")
        return real(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_pil)
    with pytest.raises(ImportError, match="PIL"):
        tdata.FolderClassification(str(tmp_path))


def test_prefetch_to_device_on_the_cpu():
    ds = tdata.SyntheticClassification(num_classes=5, image_size=8, length=12, batch_size=4, seed=1)
    got = list(tdata.prefetch_to_device(iter(ds), "cpu"))
    assert len(got) == 3
    for g, w in zip(got, ds):
        assert isinstance(g["image"], torch.Tensor) and g["image"].device.type == "cpu"
        np.testing.assert_array_equal(g["image"].numpy(), w["image"])
        np.testing.assert_array_equal(g["label"].numpy(), w["label"])

    def broken():
        yield {"image": np.zeros((1, 2, 2, 3), np.float32), "label": np.zeros(1, np.int32)}
        raise RuntimeError("loader fault")

    with pytest.raises(RuntimeError, match="loader fault"):
        list(tdata.prefetch_to_device(broken(), "cpu"))
    # a consumer that stops early leaves no worker behind
    it = tdata.prefetch_to_device(iter(tdata.SyntheticClassification(length=400, batch_size=4,
                                                                     image_size=8)), "cpu", size=1)
    next(it)
    it.close()
