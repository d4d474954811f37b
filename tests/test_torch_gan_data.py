"""PyTorch port, the GAN's host-side modules against the JAX package.

The image pool, the datasets (synthetic; aligned, unaligned, single and
colorization folders of PNGs written here), ``apply_direction``, the Lab
conversions, the gallery's PNGs and the FCN-score numpy functions are
numpy code that the port keeps its own copy of: each is held bit-equal to
JAX's on the same seeds (the Lab conversions within 1e-6: the port's copy
runs the same numpy expressions, measured equal).
"""
import os

import numpy as np
import pytest
import torch

from frostnet_tpu.gan import data as jdata
from frostnet_tpu.gan import eval_cityscapes as jeval
from frostnet_tpu.gan import visualizer as jvis
from frostnet_tpu.gan.image_pool import ImagePool as JaxPool
from frostnet_tpu_torch.gan import data as tdata
from frostnet_tpu_torch.gan import eval_cityscapes as teval
from frostnet_tpu_torch.gan import visualizer as tvis
from frostnet_tpu_torch.gan.image_pool import ImagePool

Image = pytest.importorskip("PIL.Image")


def _equal_batches(a, b):
    a, b = list(a), list(b)
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert sorted(x) == sorted(y)
        for k in x:
            if isinstance(x[k], np.ndarray):
                np.testing.assert_array_equal(x[k], y[k], err_msg=k)
                assert x[k].dtype == y[k].dtype
            else:
                assert x[k] == y[k]


@pytest.mark.parametrize("pool_size", [0, 3, 50])
def test_image_pool_bit_equal(pool_size):
    mine, theirs = ImagePool(pool_size, seed=4), JaxPool(pool_size, seed=4)
    rng = np.random.RandomState(0)
    for _ in range(12):
        imgs = rng.randn(2, 4, 4, 3).astype(np.float32)
        np.testing.assert_array_equal(mine.query(imgs), theirs.query(imgs))
    assert len(mine.images) == len(theirs.images) == min(pool_size, 24)


def test_synthetic_pairs_and_direction_bit_equal():
    _equal_batches(tdata.SyntheticPairs(16, 6, 2, seed=3), jdata.SyntheticPairs(16, 6, 2, seed=3))
    assert len(tdata.SyntheticPairs(256, 8, 1)) == 8
    b = next(iter(tdata.SyntheticPairs(8, 1, 1)))
    for d in ("AtoB", "BtoA"):
        _equal_batches([tdata.apply_direction(b, d)], [jdata.apply_direction(b, d)])
    assert tdata.apply_direction({"A": 1}, "BtoA") == {"A": 1}
    with pytest.raises(ValueError, match="AtoB"):
        tdata.apply_direction(b, "sideways")


def _write_png_tree(root, rng):
    def img(path, w, h):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        Image.fromarray(rng.randint(0, 256, (h, w, 3)).astype(np.uint8)).save(path)

    for i in range(3):
        img(os.path.join(root, "train", f"{i}.png"), 40, 20)   # aligned A|B
        img(os.path.join(root, "test", f"{i}.jpg"), 40, 20)
        img(os.path.join(root, "trainA", f"a{i}.png"), 22, 18)
        img(os.path.join(root, "trainB", f"b{i}.png"), 19, 23)
        img(os.path.join(root, "single", f"s{i}.png"), 21, 21)


def test_folder_datasets_bit_equal(tmp_path):
    root = str(tmp_path)
    _write_png_tree(root, np.random.RandomState(5))
    kw = dict(batch_size=1, load_size=20, crop_size=16, seed=7)
    for phase in ("train", "test"):
        _equal_batches(tdata.AlignedDataset(root, phase, **kw),
                       jdata.AlignedDataset(root, phase, **kw))
        _equal_batches(tdata.ColorizationDataset(root, phase, **kw),
                       jdata.ColorizationDataset(root, phase, **kw))
    _equal_batches(tdata.UnalignedDataset(root, "train", **kw),
                   jdata.UnalignedDataset(root, "train", **kw))
    _equal_batches(tdata.SingleDataset(os.path.join(root, "single"), **kw),
                   jdata.SingleDataset(os.path.join(root, "single"), **kw))
    os.makedirs(os.path.join(root, "val"))
    with pytest.raises(FileNotFoundError, match="no images"):
        tdata.AlignedDataset(root, "val")


def test_lab_conversions():
    rgb = np.random.RandomState(2).rand(3, 5, 7, 3).astype(np.float32)
    lab = tdata.rgb_to_lab(rgb)
    np.testing.assert_allclose(lab, jdata.rgb_to_lab(rgb), rtol=1e-6, atol=1e-6)
    back = tdata.lab_to_rgb(lab)
    np.testing.assert_allclose(back, jdata.lab_to_rgb(lab), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(back, rgb, atol=2e-3)  # a round trip
    L, ab = lab[..., :1] / 50.0 - 1.0, lab[..., 1:] / 110.0
    np.testing.assert_allclose(tdata.colorization_to_rgb(L, ab),
                               jdata.colorization_to_rgb(L, ab), rtol=1e-6, atol=1e-6)


def _read_png(path):
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def test_gallery_pngs_equal_tensor2im(tmp_path):
    """The port's PNG writer (zlib, no PIL) gives files that decode to
    ``tensor2im`` of each visual, the pixels of the JAX gallery's PIL
    writer; and the same index.html."""
    rng = np.random.RandomState(3)
    visuals = {"real_A": rng.uniform(-1.2, 1.2, (1, 9, 13, 3)).astype(np.float32),
               "fake_B": rng.uniform(-1, 1, (9, 13, 3)).astype(np.float32)}
    mine = tvis.HTMLGallery(str(tmp_path / "port"), "t")
    theirs = jvis.HTMLGallery(str(tmp_path / "jax"), "t")
    for i in range(2):
        mine.add_images(visuals, f"img{i}")
        theirs.add_images(visuals, f"img{i}")
    for name, v in visuals.items():
        got = _read_png(tmp_path / "port" / "images" / f"img1_{name}.png")
        np.testing.assert_array_equal(got, tvis.tensor2im(v))
        np.testing.assert_array_equal(got, _read_png(tmp_path / "jax" / "images" /
                                                     f"img1_{name}.png"))
        np.testing.assert_array_equal(tvis.tensor2im(v), jvis.tensor2im(v))
    assert (open(tmp_path / "port" / "index.html").read()
            == open(tmp_path / "jax" / "index.html").read())
    grey = rng.randint(0, 256, (5, 4)).astype(np.uint8)
    tvis.write_png(str(tmp_path / "g.png"), grey)
    with Image.open(tmp_path / "g.png") as im:
        np.testing.assert_array_equal(np.asarray(im), grey)
    vis = tvis.Visualizer(str(tmp_path / "vis"))
    vis.print_current_losses(1, 2, {"loss_G": 1.5})
    vis.display_current_results(visuals, 3)
    assert "loss_G: 1.500" in open(tmp_path / "vis" / "loss_log.txt").read()
    assert os.path.exists(tmp_path / "vis" / "web" / "images" / "epoch003_fake_B.png")


def test_fcn_scores_equal_jax():
    rng = np.random.RandomState(1)
    a = rng.randint(-1, 21, 5000)  # ground truth with ignored labels (-1, 19, 20)
    b = rng.randint(0, 19, 5000)
    np.testing.assert_array_equal(teval.fast_hist(a, b, 19), jeval.fast_hist(a, b, 19))
    hist = teval.fast_hist(a, b, 19)
    for x, y in zip(teval.get_scores(hist), jeval.get_scores(hist)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    with pytest.raises(ValueError, match="num_classes"):
        teval.fast_hist(a, b + 5, 19)
    pairs = [(rng.rand(8, 8, 3).astype(np.float32), rng.randint(0, 4, (8, 8)))
             for _ in range(3)]

    def predict(img):
        return (img[..., 0] * 4).astype(np.int64).clip(0, 3)

    got, want = teval.score_pairs(predict, pairs, 4), jeval.score_pairs(predict, pairs, 4)
    assert got["frames"] == want["frames"] == 3
    for k in ("mean_pixel_acc", "mean_class_acc", "mean_class_iou"):
        assert got[k] == want[k]
    np.testing.assert_array_equal(got["hist"], want["hist"])


def test_seg_predict_fn_and_cli_on_a_checkpoint(tmp_path, capsys):
    """``make_seg_predict_fn`` runs the port's seg model (argmax of its
    QAT_FROZEN logits); ``main`` scores PNG results against label PNGs
    with a trainer checkpoint."""
    from frostnet_tpu_torch.nn import QAT_FROZEN
    from frostnet_tpu_torch.optim import get_optimizer
    from frostnet_tpu_torch.segmentation import get_seg_model
    from frostnet_tpu_torch.train import create_train_state, recalibrate
    from frostnet_tpu_torch.utils.checkpoint import save_checkpoint

    model = get_seg_model("mobilenetv3_RE_small", num_classes=4)
    state = create_train_state(model, get_optimizer("QSGD", 1e-3), seed=0, device="cpu")
    rng = np.random.RandomState(0)
    recalibrate(state, [{"image": rng.randn(2, 64, 64, 3).astype(np.float32)}])
    save_checkpoint(str(tmp_path / "best"), state)
    model.eval()
    img = rng.rand(64, 64, 3).astype(np.float32)
    pred = teval.make_seg_predict_fn(model, QAT_FROZEN, (0.485, 0.456, 0.406),
                                     (0.229, 0.224, 0.225))(img)
    x = (torch.as_tensor(img) - torch.tensor((0.485, 0.456, 0.406))) / torch.tensor(
        (0.229, 0.224, 0.225))
    with torch.no_grad():
        want = model(x[None], mode=QAT_FROZEN)[0].argmax(-1).numpy()
    assert pred.shape == (64, 64) and pred.dtype == np.int32
    np.testing.assert_array_equal(pred, want)
    res, lab = tmp_path / "res", tmp_path / "lab"
    os.makedirs(res), os.makedirs(lab)
    for i in range(2):
        tvis.write_png(str(res / f"f{i}_leftImg8bit.png"),
                       rng.randint(0, 256, (64, 64, 3)).astype(np.uint8))
        Image.fromarray(rng.randint(0, 4, (32, 32)).astype(np.uint8)).save(
            lab / f"f{i}_gtFine_labelTrainIds.png")
    scores = teval.cli(["--result_dir", str(res), "--label_dir", str(lab), "--output_dir",
                        str(tmp_path / "out"), "--scorer_checkpoint", str(tmp_path / "best"),
                        "--num_classes", "4", "--device", "cpu"])
    assert scores["frames"] == 2 and scores["hist"].sum() == 2 * 32 * 32
    assert "Mean class IoU" in open(tmp_path / "out" / "evaluation_results.txt").read()
    assert "2 frames" in capsys.readouterr().out
