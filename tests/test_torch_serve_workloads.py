"""PyTorch port, ``serve`` beyond classification against the JAX server.

The artifacts are the port's: each model from its init with the BN shifts
drawn from ``N(GAN_BETA)`` (so that no ReLU map is half zeros, as at
init), its BN statistics those of one float train forward (momentum 1),
its observers from two QAT forwards in eval mode (on the folded graph that
INT8 serves), on seeded images, written by the port's ``export_int8`` (the
JAX package's layout); both servers read them.

* ``--workload seg`` (``mobilenetv3_small``, 5 classes, 64x128: the 2:1
  default width) and ``--workload gan`` (``resnet_6blocks`` at ngf 8,
  32x32): the port writes as many PNGs (zlib, no PIL) as JAX's
  ``serve.main`` writes (PIL). The seg maps' pixels are equal bit for bit.
  The GAN's pixels are equal but where the generator's float tail (a
  float32 conv and tanh after the INT8 core, held to ``GAN_TAIL_BAND`` =
  3e-5 of JAX's output, not bit for bit: ``chip_smoke.py`` phase 12 and
  ``tests/test_torch_gan_int8.py``) lands within that of a 1/255 step,
  where the truncation to uint8 gives the neighbouring level: at most one
  level off, on at most ``GAN_PIXEL_SHARE`` of the values (1 of 12,288
  measured);
* ``--source folder``: each workload's preprocessing (seg, det, gan) gives
  the arrays of JAX's ``_folder_batches``, bit for bit, over two batches of
  a folder of three PNGs (cycled);
* ``--checkpoint`` (a trainer checkpoint, restored then frozen) serves the
  logits of ``--artifact`` (the same model's export), bit for bit.
"""
import os

import numpy as np
import pytest
import torch
from PIL import Image

from _torch_port import GAN_BETA
from frostnet_tpu import serve as jax_serve
from frostnet_tpu_torch import serve
from frostnet_tpu_torch.gan import define_g
from frostnet_tpu_torch.models import create_model
from frostnet_tpu_torch.nn import FP32, QAT
from frostnet_tpu_torch.quant import export_int8
from frostnet_tpu_torch.segmentation import get_seg_model
from frostnet_tpu_torch.train import create_train_state
from frostnet_tpu_torch.utils.checkpoint import save_checkpoint


GAN_PIXEL_SHARE = 1e-3


def _calibrated(model, shape, seed=0):
    rng = np.random.RandomState(seed)
    state = create_train_state(model, None, seed=seed, device="cpu")
    with torch.no_grad():
        for name, p in sorted(model.named_parameters()):
            if name.endswith("bias_bn"):
                p.copy_(torch.as_tensor(rng.normal(*GAN_BETA, p.shape).astype(np.float32)))
        convs = [m for m in model.modules() if hasattr(m, "bn_momentum")]
        for m in convs:
            m.bn_momentum = 1.0
        model(torch.as_tensor(rng.randn(*shape).astype(np.float32)), mode=FP32, train=True)
        for m in convs:
            m.bn_momentum = 0.1
        for _ in range(2):
            model(torch.as_tensor(rng.randn(*shape).astype(np.float32)), mode=QAT)
    return state


def _pixels(d):
    names = sorted(os.listdir(d))
    return names, [np.asarray(Image.open(os.path.join(d, n))) for n in names]


@pytest.mark.parametrize("workload", ["seg", "gan"])
def test_png_outputs_match_jax(tmp_path, workload):
    if workload == "seg":
        model = get_seg_model("mobilenetv3_small", num_classes=5)
        flags = ["--model", "mobilenetv3_small", "--num_classes", "5", "--image_size", "64"]
        shape = (2, 64, 128, 3)
    else:
        model = define_g(ngf=8, netG="resnet_6blocks")
        flags = ["--model", "resnet_6blocks", "--ngf", "8", "--image_size", "32"]
        shape = (2, 32, 32, 3)
    artifact = str(tmp_path / "int8.npz")
    export_int8(_calibrated(model, shape).model, artifact)
    common = ["--workload", workload, "--artifact", artifact, "--batch_size", "2", "--iters",
              "1", "--predict_batches", "2"] + flags
    jax_serve.main(jax_serve.build_parser().parse_args(
        common + ["--output", str(tmp_path / "jax")]))
    serve.main(serve.build_parser().parse_args(
        common + ["--output", str(tmp_path / "port"), "--device", "cpu"]))
    names, want = _pixels(tmp_path / "jax")
    got_names, got = _pixels(tmp_path / "port")
    prefix = "pred" if workload == "seg" else "fake"
    assert got_names == names == [f"{prefix}_{i:05d}.png" for i in range(4)]
    moved = 0
    for n, g, w in zip(names, got, want):
        assert g.shape == w.shape == shape[1:], n
        if workload == "seg":
            np.testing.assert_array_equal(g, w, err_msg=n)
        diff = np.abs(g.astype(np.int32) - w.astype(np.int32))
        assert diff.max() <= 1, n
        moved += int((diff > 0).sum())
    assert moved <= GAN_PIXEL_SHARE * len(want) * want[0].size
    # the maps are not flat
    assert len(np.unique(np.concatenate([w.reshape(-1, 3) for w in want]), axis=0)) > 2


def test_folder_preprocessing_matches_jax(tmp_path):
    rng = np.random.RandomState(4)
    root = tmp_path / "images" / "sub"
    root.mkdir(parents=True)
    for i, (h, w) in enumerate(((40, 50), (64, 31), (17, 90))):
        Image.fromarray(rng.randint(0, 256, (h, w, 3), np.uint8)).save(root / f"im{i}.png")

    class Args:
        data_dir, batch_size, image_width = str(tmp_path / "images"), 2, None

    for workload, size, shape in (("seg", 24, (2, 24, 48, 3)), ("det", 30, (2, 30, 30, 3)),
                                  ("gan", 20, (2, 20, 20, 3))):
        args = Args()
        args.workload, args.image_size = workload, size
        mine, theirs = serve._folder_batches(args), jax_serve._folder_batches(args, shape)
        for _ in range(2):
            (a, la), (b, lb) = next(mine), next(theirs)
            assert la is lb is None and a.dtype == b.dtype == np.float32
            assert a.shape == shape, workload
            np.testing.assert_array_equal(a, b, err_msg=workload)


def test_checkpoint_serves_the_artifact_logits(tmp_path):
    name = "frostnet_quant_small_0_35"
    state = _calibrated(create_model(name, num_classes=10), (2, 32, 32, 3))
    save_checkpoint(str(tmp_path / "best"), state)
    export_int8(state.model, str(tmp_path / "int8.npz"))
    common = ["--model", name, "--num_classes", "10", "--image_size", "32", "--batch_size", "2",
              "--iters", "1", "--device", "cpu", "--fuse_int8"]
    for source, path in (("--checkpoint", "best"), ("--artifact", "int8.npz")):
        serve.main(serve.build_parser().parse_args(
            common + [source, str(tmp_path / path), "--save_logits",
                      str(tmp_path / f"{source[2:]}.npy")]))
    got, want = np.load(tmp_path / "checkpoint.npy"), np.load(tmp_path / "artifact.npy")
    assert got.shape == (2, 10) and len(np.unique(want)) > 2
    np.testing.assert_array_equal(got, want)
