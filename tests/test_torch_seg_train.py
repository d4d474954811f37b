"""PyTorch port, the segmentation trainer's parts and its user path.

* Metrics: the confusion matrix (ignore label, labels and predictions out
  of range) equals JAX's; ``miou_from_confusion`` is bit-equal to the
  jitted JAX function on counts up to 1e9 (float32 sums in index order).
* Losses: the weighted cross-entropy with the ignore label and the BCE
  branch (per-class ``weight``, ``pos_weight``) within ``LOSS_REL`` of the
  loss: the float32 sums over the pixels run in other orders (measured up
  to 6.8e-7 relative, 6 ulps).
* Datasets: over a temporary tree of PNGs, ``CityscapesSegmentation``,
  ``CustomSegmentation`` and ``VOCSegmentation`` (with a COCO list), train
  (paired flip / scale / crop / pad) and val, and ``SyntheticSegmentation``
  give JAX's batches bit for bit; without PIL they raise an error naming it.
* Training against the committed JAX reference
  (``testdata/seg_mobilenetv3_RE_small_train_reference.npz``, 256x256,
  batch 2: one FP32 step, two QAT steps, a QAT_FROZEN eval step) within the
  bands of ``chip_smoke.py``'s phase 8; the FP32 step's confusion matrix
  moves at most ``SEG_ARGMAX_SHARE`` of the pixels (argmax ties at a float
  ulp: 3 of 131072 pixels measured), and every step counts the same pixels.
* ``train.main`` at crop 64 on the CPU (``mobilenetv3_RE_small``, batch 2,
  one step an epoch, one FP32 and two QAT epochs): interrupted after the
  first QAT epoch and resumed, it ends bit-identical to the uninterrupted
  run (every variable, the step, the mIoUs); ``evaluate.main
  --export_int8`` on its checkpoint writes JAX's ``export_int8`` of the same
  variables array for array, and the artifact served in a fresh model gives
  the evaluator's INT8 mIoU; the CLI runs as users type it.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import few_threads, jax_variables  # noqa: F401 - a fixture
from frostnet_tpu.segmentation import data as jdata
from frostnet_tpu.utils import losses as jlosses
from frostnet_tpu.utils import metrics as jmetrics
from frostnet_tpu_torch.quant import from_jax_variables, load_int8, model_variables
from frostnet_tpu_torch.segmentation import data as tdata
from frostnet_tpu_torch.segmentation import evaluate, train
from frostnet_tpu_torch.utils import losses as tlosses
from frostnet_tpu_torch.utils import metrics as tmetrics

pytestmark = pytest.mark.usefixtures("few_threads")
LOSS_REL = 2e-6


# ---------------------------------------------------------------------------
# Metrics and losses
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("num_classes", [19, 21, 2])
def test_confusion_matrix_equals_jax(num_classes):
    rng = np.random.RandomState(num_classes)
    target = rng.randint(-1, num_classes + 2, (3, 17, 23)).astype(np.int32)
    target[rng.rand(*target.shape) < 0.1] = 255
    pred = rng.randint(-2, num_classes + 3, target.shape).astype(np.int64)
    want = np.asarray(jax.jit(lambda p, t: jmetrics.confusion_matrix(p, t, num_classes, 255))(
        jnp.asarray(pred), jnp.asarray(target)))
    got = tmetrics.confusion_matrix(torch.as_tensor(pred), torch.as_tensor(target), num_classes)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


def test_miou_bit_equal_to_jax():
    rng = np.random.RandomState(0)
    for t in range(60):
        c = (19, 21, 2)[t % 3]
        cm = rng.randint(0, 10 ** rng.randint(2, 10), (c, c)).astype(np.int64)
        cm[rng.rand(c, c) < 0.2] = 0
        if t % 4 == 0:
            cm[rng.randint(c)] = 0
            cm[:, rng.randint(c)] = 0
        cm = np.minimum(cm, 2 ** 31 - 1)
        iou, miou = jax.jit(jmetrics.miou_from_confusion)(jnp.asarray(cm, jnp.int32))
        tiou, tmiou = tmetrics.miou_from_confusion(torch.as_tensor(cm))
        np.testing.assert_array_equal(tiou.numpy(), np.asarray(iou))
        assert tmiou.dtype == torch.float32 and float(tmiou) == float(miou)


@pytest.mark.parametrize("weighted", [False, True])
def test_weighted_cross_entropy_with_ignore(weighted):
    rng = np.random.RandomState(1)
    logits = (rng.randn(2, 9, 11, 19) * 3).astype(np.float32)
    labels = rng.randint(0, 19, (2, 9, 11)).astype(np.int32)
    labels[rng.rand(*labels.shape) < 0.2] = 255
    w = tdata.CITYSCAPES_CLASS_WEIGHTS if weighted else None
    want = float(jax.jit(lambda lg, lb: jlosses.cross_entropy(
        lg, lb, class_weights=None if w is None else jnp.asarray(w), ignore_index=255))(
        jnp.asarray(logits), jnp.asarray(labels)))
    got = float(tlosses.cross_entropy(torch.as_tensor(logits), torch.as_tensor(labels),
                                      None if w is None else torch.as_tensor(w), 255))
    assert abs(got - want) <= LOSS_REL * abs(want)


def test_bce_with_logits():
    rng = np.random.RandomState(2)
    logits = (rng.randn(2, 5, 6, 19) * 4).astype(np.float32)
    labels = rng.randint(0, 19, (2, 5, 6))
    labels[0, 0, :3] = 255
    onehot = (labels[..., None] == np.arange(19)).astype(np.float32)
    w = tdata.CITYSCAPES_CLASS_WEIGHTS
    pw = rng.uniform(0.5, 2.0, 19).astype(np.float32)
    for kw in ({}, {"weight": w}, {"pos_weight": pw, "weight": w}):
        want = float(jax.jit(lambda a, b: jlosses.binary_cross_entropy_with_logits(
            a, b, **{k: jnp.asarray(v) for k, v in kw.items()}))(jnp.asarray(logits),
                                                                 jnp.asarray(onehot)))
        got = float(tlosses.binary_cross_entropy_with_logits(
            torch.as_tensor(logits), torch.as_tensor(onehot),
            **{k: torch.as_tensor(v) for k, v in kw.items()}))
        assert abs(got - want) <= LOSS_REL * abs(want), kw
    # the trainer's bce branch: ignored pixels give all-zero target rows
    got = float(train.seg_loss(torch.as_tensor(logits), torch.as_tensor(labels),
                               torch.as_tensor(w), 255, 19, "bce"))
    want = float(jlosses.binary_cross_entropy_with_logits(
        jnp.asarray(logits), jax.nn.one_hot(jnp.asarray(labels), 19), weight=jnp.asarray(w)))
    assert abs(got - want) <= LOSS_REL * abs(want)


# ---------------------------------------------------------------------------
# Datasets
# ---------------------------------------------------------------------------

def _png_tree(root, n=6):
    from PIL import Image

    rng = np.random.RandomState(3)
    lines = []
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    os.makedirs(os.path.join(root, "annotations"), exist_ok=True)
    for i in range(n):
        h, w = 40 + 7 * i, 56 - 3 * i
        img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        mask = rng.randint(0, 19, (h, w)).astype(np.uint8)
        mask[rng.rand(h, w) < 0.1] = 255
        Image.fromarray(img).save(os.path.join(root, "images", f"im{i}.png"))
        Image.fromarray(mask).save(os.path.join(root, "annotations", f"m{i}.png"))
        lines.append(f"images/im{i}.png,annotations/m{i}.png")
    for split in ("train", "val"):
        with open(os.path.join(root, f"{split}.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")
    return lines


def _voc_tree(root, n=5):
    from PIL import Image

    rng = np.random.RandomState(4)
    base = os.path.join(root, "VOC2012")
    for d in ("JPEGImages", "SegmentationClass", os.path.join("ImageSets", "Segmentation")):
        os.makedirs(os.path.join(base, d), exist_ok=True)
    ids = [f"2007_{i:06d}" for i in range(n)]
    for i, name in enumerate(ids):
        h, w = 30 + 5 * i, 44
        Image.fromarray(rng.randint(0, 256, (h, w, 3)).astype(np.uint8)).save(
            os.path.join(base, "JPEGImages", name + ".jpg"), quality=95)
        Image.fromarray(rng.randint(0, 21, (h, w)).astype(np.uint8)).save(
            os.path.join(base, "SegmentationClass", name + ".png"))
    for split in ("train", "val"):
        with open(os.path.join(base, "ImageSets", "Segmentation", split + ".txt"), "w") as f:
            f.write("\n".join(ids) + "\n")
    coco = os.path.join(root, "coco")
    os.makedirs(coco, exist_ok=True)
    Image.fromarray(rng.randint(0, 256, (50, 60, 3)).astype(np.uint8)).save(
        os.path.join(coco, "c0.png"))
    Image.fromarray(rng.randint(0, 21, (50, 60)).astype(np.uint8)).save(
        os.path.join(coco, "c0_m.png"))
    with open(os.path.join(coco, "list.txt"), "w") as f:
        f.write("c0.png,c0_m.png\n")
    return os.path.join(coco, "list.txt")


def _same_batches(a, b):
    a, b = list(a), list(b)
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert sorted(x) == sorted(y)
        for k in x:
            assert x[k].dtype == y[k].dtype and x[k].shape == y[k].shape, k
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)


@pytest.mark.parametrize("kind", ["city", "custom", "voc"])
@pytest.mark.parametrize("is_train", [True, False], ids=["train", "val"])
def test_datasets_bit_equal(tmp_path, kind, is_train):
    if kind == "voc":
        coco = _voc_tree(str(tmp_path))
        kw = dict(train=is_train, crop_size=(24, 32), batch_size=2, seed=5,
                  coco_list=coco if is_train else None)
        mine, theirs = tdata.VOCSegmentation(str(tmp_path), **kw), \
            jdata.VOCSegmentation(str(tmp_path), **kw)
    else:
        _png_tree(str(tmp_path))
        kw = dict(train=is_train, crop_size=(32, 24), batch_size=2, seed=5)
        cls = "CityscapesSegmentation" if kind == "city" else "CustomSegmentation"
        if kind == "city" and not is_train:  # Cityscapes validates at the native size
            kw["batch_size"] = 1
        mine, theirs = getattr(tdata, cls)(str(tmp_path), **kw), \
            getattr(jdata, cls)(str(tmp_path), **kw)
    assert len(mine) == len(theirs)
    _same_batches(mine, theirs)


def test_synthetic_and_constants_equal_jax():
    _same_batches(tdata.SyntheticSegmentation(19, (24, 40), 12, 4, 7),
                  jdata.SyntheticSegmentation(19, (24, 40), 12, 4, 7))
    np.testing.assert_array_equal(tdata.CITYSCAPES_CLASS_WEIGHTS, jdata.CITYSCAPES_CLASS_WEIGHTS)
    assert (tdata.CITYSCAPES_CLASSES, tdata.CITYSCAPES_IGNORE) == (19, 255)
    from frostnet_tpu.segmentation import evaluate as jevaluate
    np.testing.assert_array_equal(evaluate.CITYSCAPES_PALETTE, jevaluate.CITYSCAPES_PALETTE)
    np.testing.assert_array_equal(evaluate.CITYSCAPES_TRAINID_TO_ID,
                                  jevaluate.CITYSCAPES_TRAINID_TO_ID)
    pred = np.random.RandomState(8).randint(-2, 22, (5, 7))
    np.testing.assert_array_equal(evaluate.colorize(pred), jevaluate.colorize(pred))
    np.testing.assert_array_equal(evaluate.relabel(pred), jevaluate.relabel(pred))


def test_datasets_without_pil_name_it(tmp_path, monkeypatch):
    import builtins

    _png_tree(str(tmp_path), n=2)
    real = builtins.__import__

    def no_pil(name, *args, **kwargs):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("No module named 'PIL'")
        return real(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_pil)
    ds = tdata.CityscapesSegmentation(str(tmp_path), batch_size=1)
    with pytest.raises(ImportError, match="PIL"):
        next(iter(ds))
    next(iter(tdata.SyntheticSegmentation(19, (8, 8), 2, 1)))  # needs none


# ---------------------------------------------------------------------------
# Training against the committed JAX reference
# ---------------------------------------------------------------------------

def test_training_against_the_committed_jax_reference():
    from chip_smoke import (BN_MEAN_MEDIAN, BN_VAR_MEDIAN, FP32_LOSS_REL, OBS_MEDIAN,
                            OBS_WORST, QAT_LOSS_REL)
    from frostnet_tpu_torch.nn import FP32, QAT, QAT_FROZEN
    from frostnet_tpu_torch.optim import get_optimizer, grouped_weight_decay
    from frostnet_tpu_torch.segmentation import get_seg_model
    from frostnet_tpu_torch.train import create_train_state
    from test_torch_seg_fixture import (SEG_ARGMAX_SHARE, TRAIN, TRAIN_REFERENCE, load,
                                        train_batch)

    ref = load(TRAIN_REFERENCE)
    model = get_seg_model(TRAIN["model"])
    tx = get_optimizer("QSGD", TRAIN["lr"], weight_decay=grouped_weight_decay(TRAIN["wd"]),
                       noise_decay=1.0)
    state = create_train_state(model, tx, seed=TRAIN["seed"], device="cpu")
    w = tdata.CITYSCAPES_CLASS_WEIGHTS
    losses, cms = [], []
    for k, mode in enumerate((FP32, QAT, QAT)):
        if k == 1:
            state.start_qat()
        m = train.make_seg_train_step(mode, w, 255, 19)(state, train_batch(k))
        losses.append(float(m["loss"]))
        cms.append(m["cm"].numpy())
    cms.append(train.make_seg_eval_step(QAT_FROZEN, 19, 255)(state, train_batch(3)).numpy())
    rel = [abs(a - float(b)) / float(b) for a, b in zip(losses, ref["loss"])]
    assert rel[0] <= FP32_LOSS_REL and max(rel[1:]) <= QAT_LOSS_REL, rel
    moved = np.abs(cms[0] - ref["cm"][0]).sum() / 2
    assert moved <= SEG_ARGMAX_SHARE * ref["cm"][0].sum(), moved
    for got, want in zip(cms, ref["cm"]):
        assert got.sum() == want.sum()
    mine = {k: v.detach().numpy() for k, v in model_variables(state.model).items()}
    obs = []
    for k in ref:
        if k.endswith(".min_val"):
            hi = k.replace(".min_val", ".max_val")
            span = max(float(ref[hi] - ref[k]), 1e-6)
            obs.append(max(abs(float(mine[k] - ref[k])), abs(float(mine[hi] - ref[hi]))) / span)
    assert np.median(obs) <= OBS_MEDIAN and max(obs) <= OBS_WORST, (np.median(obs), max(obs))
    means = [float(np.max(np.abs(mine[k] - ref[k]) / np.sqrt(ref[k[:-4] + "var"])))
             for k in ref if k.endswith("/mean")]
    variances = [float(np.max(np.abs(mine[k] - ref[k]) / ref[k])) for k in ref
                 if k.endswith("/var")]
    assert np.median(means) <= BN_MEAN_MEDIAN and np.median(variances) <= BN_VAR_MEDIAN


# ---------------------------------------------------------------------------
# The user's path on the CPU
# ---------------------------------------------------------------------------

RUN = dict(model="mobilenetv3_RE_small", dataset="synthetic", crop_size=64, batch_size=2,
           steps_per_epoch=1, fp_epochs=1, epochs=2, seed=0, device="cpu")


class Interrupt(Exception):
    pass


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The uninterrupted run, and one interrupted before its second QAT
    epoch and resumed."""
    root = tmp_path_factory.mktemp("seg")
    whole = train.main(train.SegConfig(save_dir=str(root / "whole"), **RUN))
    real, calls = train._run_epoch, []

    def stop_third(*args, **kwargs):
        calls.append(1)
        if len(calls) == 3:
            raise Interrupt
        return real(*args, **kwargs)

    train._run_epoch = stop_third
    try:
        with pytest.raises(Interrupt):
            train.main(train.SegConfig(save_dir=str(root / "cut"), **RUN))
    finally:
        train._run_epoch = real
    resumed = train.main(train.SegConfig(save_dir=str(root / "cut"), resume=True, **RUN))
    return root, whole, resumed


def test_resume_is_bit_identical_to_the_uninterrupted_run(runs):
    root, (sw, rw), (sr, rr) = runs
    assert rr["resumed"] == {"qat_epoch": 1, "step": 2} and rw["resumed"] is None
    assert sw.step == sr.step == 3
    a, b = model_variables(sw.model), model_variables(sr.model)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    for key in ("qat", "int8"):
        assert rw[key]["miou"] == rr[key]["miou"]
        np.testing.assert_array_equal(rw[key]["cm"], rr[key]["cm"])
    assert [h["tag"] for h in rw["history"]] == ["fp_warmup", "qat", "qat"]
    assert [h["tag"] for h in rr["history"]] == ["qat"]
    assert rw["history"][-1]["losses"] == rr["history"][-1]["losses"]
    for f in ("checkpoint", "best", "checkpoint_meta.json", "metrics.jsonl", "arguments.json"):
        assert os.path.exists(root / "whole" / f), f
    with open(root / "whole" / "checkpoint_meta.json") as f:
        assert json.load(f)["qat_epoch"] == 2
    assert 0.0 < rw["int8"]["miou"] < 1.0 and np.isfinite(rw["history"][0]["loss"])


def test_evaluator_export_equals_jax_and_serves_its_miou(runs, tmp_path):
    from frostnet_tpu import quant as jq
    from frostnet_tpu_torch.nn import INT8
    from frostnet_tpu_torch.quant.export import unflatten_variables
    from frostnet_tpu_torch.segmentation import get_seg_model

    root = runs[0]
    artifact = str(tmp_path / "seg_int8.npz")
    out = evaluate.main(evaluate.build_parser().parse_args(
        ["--checkpoint", str(root / "whole" / "checkpoint"), "--crop_size", "64",
         "--export_int8", artifact, "--device", "cpu"]))
    assert out["export_bytes"] == os.path.getsize(artifact)
    theirs = str(tmp_path / "jax_int8.npz")
    tree = unflatten_variables({k: v.detach().numpy()
                                for k, v in model_variables(out["state"].model).items()})
    jq.export_int8(jax_variables(tree), theirs)
    with np.load(artifact) as a, np.load(theirs) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    # the artifact served in a fresh model: the evaluator's INT8 mIoU
    cfg = train.resolve_dataset_defaults(train.SegConfig(crop_size=64, batch_size=2))
    model = from_jax_variables(get_seg_model("mobilenetv3_RE_small"), load_int8(artifact))
    state = type(out["state"])(model=model, optimizer=out["state"].optimizer,
                               generator=out["state"].generator)
    served = train.evaluate_seg(state, evaluate.eval_dataset(cfg, ""), torch.device("cpu"), INT8,
                                cfg)
    assert served["miou"] == out["int8"]
    np.testing.assert_array_equal(served["cm"], out["int8_eval"]["cm"])


def test_evaluate_calibrates_without_a_checkpoint_and_saves_images(tmp_path):
    out = evaluate.main(evaluate.build_parser().parse_args(
        ["--crop_size", "32", "--batch_size", "2", "--save_images", str(tmp_path / "vis"),
         "--device", "cpu"]))
    assert 0.0 <= out["int8"] <= 1.0 and 0.0 <= out["qat"] <= 1.0
    names = sorted(os.listdir(tmp_path / "vis"))
    assert names == ["pred_0_color.png", "pred_0_labelids.png", "pred_1_color.png",
                     "pred_1_labelids.png"]


def test_cli_and_refusals(tmp_path, capsys):
    train.cli(["--device", "cpu", "--dataset", "synthetic", "--crop_size", "32",
               "--batch_size", "2", "--steps_per_epoch", "1", "--epochs", "1", "--fp_epochs",
               "1", "--save_dir", str(tmp_path / "cli")])
    out = capsys.readouterr().out
    assert "mIoU(QAT sim)=" in out and "mIoU(INT8 frozen)=" in out
    with open(tmp_path / "cli" / "arguments.json") as f:
        args = json.load(f)
    assert args["crop_size"] == 32 and args["num_classes"] == 19 and args["device"] == "cpu"
    # the native loader reads file datasets; synthetic data stays synthetic (as in JAX)
    ds = train.build_seg_dataset(train.SegConfig(loader="native", num_classes=19, crop_size=8),
                                 True)
    assert type(ds).__name__ == "SyntheticSegmentation"
    # ESPNetv2 is ported: the trainer builds it at --width_scale and runs
    _, res = train.main(train.SegConfig(model="espnetv2", width_scale=0.5, dataset="synthetic",
                                        crop_size=32, batch_size=2, steps_per_epoch=1, epochs=1,
                                        fp_epochs=0, device="cpu", save_dir=str(tmp_path / "e")))
    assert np.isfinite(res["qat"]["miou"]) and np.isfinite(res["int8"]["miou"])
    with pytest.raises(NotImplementedError, match="dequantized features"):
        train.main(train.SegConfig(model="mobilenetv2", crop_size=32, batch_size=2,
                                   steps_per_epoch=1, epochs=1, fp_epochs=0, device="cpu",
                                   save_dir=str(tmp_path / "v2")))
    cfg = train.resolve_dataset_defaults(train.SegConfig(dataset="city"))
    assert (cfg.num_classes, cfg.crop_size) == (19, 768)
    cfg = train.resolve_dataset_defaults(train.SegConfig(dataset="pascal", crop_size=320))
    assert (cfg.num_classes, cfg.crop_size) == (21, 320)
