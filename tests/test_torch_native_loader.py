"""The port's native C++ loaders (``frostnet_tpu_torch/native``) against
``frostnet_tpu.native`` on the same files.

Images are written here with PIL from a seed (JPEGs and PNGs of a few
sizes, gray and palette masks, boxes). Both packages' pools decode with
this machine's libjpeg and libpng, so every batch must be equal byte for
byte: classification float32 and uint8, seg images and masks, det images,
boxes, labels and ``valid``, in eval and in train mode at ``threads=1``
(with more threads which worker draws a batch's augmentation changes from
run to run, in both packages). The ``(rank, world)`` split: the ranks'
blocks of each batch, concatenated, are the ``(0, 1)`` batch. Then one CPU
step of each trainer with ``loader='native'`` on a tiny tree, and a build
that fails raises with the compiler's output instead of falling back.
"""
import os

import numpy as np
import pytest
from PIL import Image

from frostnet_tpu import native as jax_native
from frostnet_tpu_torch import native
from frostnet_tpu_torch.detection import train as det_train
from frostnet_tpu_torch.segmentation import train as seg_train
from frostnet_tpu_torch.train import classification

VOC = ("aeroplane", "bicycle", "bird")


def _image(rng, h, w):
    """A smooth random RGB image (a coarse grid upsampled: compressible,
    with edges a JPEG does not keep exactly)."""
    coarse = rng.randint(0, 256, (max(h // 8, 2), max(w // 8, 2), 3)).astype(np.uint8)
    return np.asarray(Image.fromarray(coarse).resize((w, h), Image.BILINEAR))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Classification folders, seg pairs and a VOC tree, from RandomState(0)."""
    root = tmp_path_factory.mktemp("native")
    rng = np.random.RandomState(0)
    sizes = [(40, 56), (64, 48), (33, 71), (52, 52)]
    for split in ("train", "val"):
        for c in ("cat", "dog"):
            d = root / "cls" / "tiny" / split / c
            d.mkdir(parents=True)
            for i in range(4):
                Image.fromarray(_image(rng, *sizes[i])).save(d / f"{i}.jpg", quality=90)
    seg = root / "seg"
    (seg / "images").mkdir(parents=True)
    (seg / "annotations").mkdir()
    lines = []
    for i in range(6):
        h, w = sizes[i % 4]
        img = Image.fromarray(_image(rng, h, w))
        mask = rng.randint(0, 5, (h, w)).astype(np.uint8)
        mask[: h // 4] = 255
        name = f"{i}.jpg" if i % 3 == 0 else f"{i}.png"
        if name.endswith(".jpg"):
            img.save(seg / "images" / name, quality=92)
        else:
            img.save(seg / "images" / name)
        m = Image.fromarray(mask)
        if i % 2:  # palette masks keep the index as the class
            m = m.convert("P")
        m.save(seg / "annotations" / f"{i}.png")
        lines.append(f"{name},{i}.png")
    for split in ("train", "val"):
        (seg / f"{split}.txt").write_text("\n".join(lines) + "\n")
    voc = root / "VOCdevkit" / "VOC2007"
    for sub in ("Annotations", "JPEGImages", "ImageSets/Main"):
        (voc / sub).mkdir(parents=True)
    (root / "VOCdevkit" / "VOC2012" / "ImageSets" / "Main").mkdir(parents=True)
    (root / "VOCdevkit" / "VOC2012" / "ImageSets" / "Main" / "trainval.txt").write_text("")
    ids = []
    for i in range(6):
        h, w = 60 + 7 * i, 80 - 5 * i
        Image.fromarray(_image(rng, h, w)).save(voc / "JPEGImages" / f"{i:06d}.jpg", quality=90)
        objs = ""
        for j in range(1 + i % 3):
            x0, y0 = rng.randint(1, w // 2), rng.randint(1, h // 2)
            x1, y1 = x0 + rng.randint(8, w // 2), y0 + rng.randint(8, h // 2)
            objs += (f"<object><name>{VOC[j]}</name><difficult>0</difficult><bndbox>"
                     f"<xmin>{x0}</xmin><ymin>{y0}</ymin><xmax>{x1}</xmax><ymax>{y1}</ymax>"
                     f"</bndbox></object>")
        (voc / "Annotations" / f"{i:06d}.xml").write_text(f"<annotation>{objs}</annotation>")
        ids.append(f"{i:06d}")
    (voc / "ImageSets" / "Main" / "trainval.txt").write_text("\n".join(ids) + "\n")
    (voc / "ImageSets" / "Main" / "test.txt").write_text("\n".join(ids) + "\n")
    return root


def _det_annotations(files):
    ds = det_train.VOCDetection(str(files / "VOCdevkit"), image_sets=(("2007", "trainval"),),
                                batch_size=2)
    return ds.annotations()


def _loader(pkg, kind, files, train, **kw):
    """The loader ``kind`` of ``pkg`` (the JAX or the port module) over the
    module's files, one thread."""
    if kind.startswith("cls"):
        return pkg.NativeClassificationLoader.from_folder(
            str(files / "cls" / "tiny" / "train"), batch_size=4, image_size=24, threads=1,
            train=train, seed=3, output=kind.split("-")[1], **kw)
    if kind == "seg":
        return pkg.NativeSegmentationLoader.from_file_list(
            str(files / "seg"), "train.txt", crop_size=(20, 28), batch_size=2, threads=1,
            train=train, seed=5, scale=(0.5, 1.5), **kw)
    paths, boxes, labels = _det_annotations(files)
    return pkg.NativeDetectionLoader(paths, boxes, labels, max_boxes=6, batch_size=2, size=32,
                                     threads=1, train=train, seed=7, **kw)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("kind", ["cls-float32", "cls-uint8", "seg", "det"])
def test_loaders_equal_the_jax_loaders(files, kind, train):
    want = list(_loader(jax_native, kind, files, train))
    got = list(_loader(native, kind, files, train))
    assert len(got) == len(want) >= 2
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


@pytest.mark.parametrize("kind,world", [("cls-uint8", 2), ("cls-uint8", 4), ("seg", 2),
                                        ("det", 2)])
def test_rank_blocks_concatenate_to_the_batch(files, kind, world):
    """Train mode, one thread: rank r yields rows [r B / W, (r + 1) B / W) of
    every global batch, augmented as the (0, 1) pool augments them."""
    whole = list(_loader(native, kind, files, True))
    parts = [list(_loader(native, kind, files, True, rank=r, world=world))
             for r in range(world)]
    assert all(len(p) == len(whole) for p in parts)
    for b, w in enumerate(whole):
        for k in w:
            np.testing.assert_array_equal(np.concatenate([p[b][k] for p in parts]), w[k],
                                          err_msg=f"batch {b} {k}")
    with pytest.raises(ValueError, match="equal blocks"):
        _loader(native, kind, files, True, rank=0, world=3)


def test_classification_trainer_step(files):
    """The trainer's dataset and one QAT step of its step factory on a
    native batch (uint8, normalized in the step)."""
    cfg = classification.ClassificationConfig(
        model="frostnet_quant_small_0_35", dataset="tiny", data_dir=str(files / "cls"),
        loader="native", num_classes=2, image_size=32, batch_size=4, device="cpu")
    ds = classification._build_dataset(cfg, train=True)
    assert isinstance(ds, native.NativeClassificationLoader) and ds.output == "uint8"
    batch = next(iter(ds))
    assert batch["image"].dtype == np.uint8 and batch["image"].shape == (4, 32, 32, 3)
    model = classification.create_model(cfg.model, num_classes=2, image_size=32)
    state = classification.create_train_state(model, classification._optimizer(
        cfg, classification._schedule(cfg, 1)), seed=0, device="cpu")
    m = classification.make_train_step(classification.QAT, num_classes=2)(state, batch)
    assert state.step == 1 and np.isfinite(float(m["loss"]))
    val = classification._build_dataset(cfg, train=False)
    assert len(list(val)) == len(val) == 2


def test_seg_trainer_step(files, tmp_path):
    cfg = seg_train.SegConfig(model="mobilenetv3_RE_small", dataset="custom",
                              data_dir=str(files / "seg"), loader="native", num_classes=5,
                              crop_size=32, batch_size=2, steps_per_epoch=1, fp_epochs=0,
                              epochs=1, device="cpu", save_dir=str(tmp_path))
    ds = seg_train.build_seg_dataset(cfg, True)
    assert isinstance(ds, native.NativeSegmentationLoader)
    batch = next(iter(ds))
    assert batch["image"].dtype == np.uint8 and batch["label"].shape == (2, 32, 32)
    state, res = seg_train.main(cfg)
    assert state.step == 1 and np.isfinite(res["history"][-1]["loss"])


def test_det_trainer_step(files, tmp_path):
    cfg = det_train.DetConfig(dataset="voc", data_root=str(files / "VOCdevkit"),
                              loader="native", batch_size=2, warmup_iters=1, max_iter=1,
                              device="cpu", save_dir=str(tmp_path))
    ds = det_train.build_detection_dataset(cfg, True)
    assert isinstance(ds, native.NativeDetectionLoader)
    batch = next(iter(ds))
    assert batch["image"].dtype == np.uint8 and batch["image"].shape == (2, 300, 300, 3)
    state, res = det_train.main(cfg)
    assert state.step == 1 and np.isfinite(res["history"][-1]["loss"])


def test_failed_build_raises(files, tmp_path, monkeypatch):
    """A source that does not compile raises with g++'s message, and a
    trainer asked for the native loader raises it too: no fallback."""
    bad = tmp_path / "dataloader.cpp"
    bad.write_text('#include "no_such_header.h"\n')
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "build")
    with pytest.raises(RuntimeError, match="no_such_header.h"):
        native.build(bad)
    monkeypatch.setattr(native, "SRC", bad)
    monkeypatch.setattr(native, "_lib", None)
    cfg = classification.ClassificationConfig(dataset="tiny", data_dir=str(files / "cls"),
                                              loader="native", device="cpu")
    with pytest.raises(RuntimeError, match="build failed"):
        classification._build_dataset(cfg, train=True)
    assert not native.library_path(bad).exists()
