"""PyTorch port, serving: ``frostnet_tpu_torch.serve`` on the CPU."""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest

from _torch_port import calibrated_gan_variables, calibrated_jax_variables
from frostnet_tpu.quant import export_int8, freeze as jax_freeze
from frostnet_tpu_torch import serve

NAME, SIZE = "frostnet_quant_small_0_35", 32


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    model, variables, _ = calibrated_jax_variables(NAME, "qnnpack", SIZE)
    path = str(tmp_path_factory.mktemp("serve") / "tiny_int8.npz")
    export_int8(variables, path)
    return model, variables, path


def test_serve_main_reports_and_writes_topk(artifact, tmp_path):
    _, _, path = artifact
    out = str(tmp_path / "top.jsonl")
    args = serve.build_parser().parse_args(
        ["--model", NAME, "--artifact", path, "--num_classes", "10", "--image_size", str(SIZE),
         "--batch_size", "2", "--iters", "2", "--device", "cpu", "--fuse_int8",
         "--output", out, "--predict_batches", "2", "--topk", "3"])
    report = serve.main(args)
    for key in ("latency_ms", "request_images_per_sec", "pipeline_images_per_sec"):
        assert key in report
    assert set(report["latency_ms"]) == {"p50", "p95", "max"}
    assert report["device"] == "cpu" and report["fuse_int8"] is True
    lines = [json.loads(l) for l in open(out)]
    assert len(lines) == 4 and all(len(r["topk"]) == 3 for r in lines)


def test_predictor_matches_jax_freeze(artifact):
    model, variables, path = artifact
    images = np.random.RandomState(5).randn(3, SIZE, SIZE, 3).astype(np.float32)
    want = np.asarray(jax_freeze(model, variables)(jnp.asarray(images)))
    for fuse in (False, True):
        pred = serve.Int8Predictor(NAME, num_classes=10, artifact=path, image_size=SIZE,
                                   fuse_int8=fuse, device="cpu")
        np.testing.assert_array_equal(pred(images).numpy(), want)
        idx, scores = pred.predict_topk(images, k=2)
        assert idx.shape == (3, 2) and (scores[:, 0] >= scores[:, 1]).all()


def test_serve_requires_an_artifact():
    # one of --artifact, --checkpoint and --program, as the JAX server asks
    with pytest.raises(ValueError, match="exactly one of artifact= / checkpoint= / program="):
        serve.main(serve.build_parser().parse_args(["--device", "cpu"]))
    with pytest.raises(ValueError):
        serve.Int8Predictor(NAME, device="cpu")


@pytest.fixture(scope="module")
def gan_artifact(tmp_path_factory):
    from frostnet_tpu.gan.networks import define_g

    variables = calibrated_gan_variables(define_g(ngf=8, netG="resnet_6blocks"), 1, SIZE)
    path = str(tmp_path_factory.mktemp("serve_gan") / "netG_int8.npz")
    export_int8(variables, path)
    return path


def test_serve_main_gan_reports(gan_artifact):
    args = serve.build_parser().parse_args(
        ["--workload", "gan", "--model", "resnet_6blocks", "--ngf", "8", "--artifact",
         gan_artifact, "--image_size", str(SIZE), "--batch_size", "2", "--iters", "2",
         "--device", "cpu"])
    report = serve.main(args)
    assert report["workload"] == "gan" and report["model"] == "resnet_6blocks"
    for key in ("batch_size", "iters", "latency_ms", "request_images_per_sec",
                "pipeline_images_per_sec"):
        assert key in report
    assert set(report["latency_ms"]) == {"p50", "p95", "max"}
    pred = serve.GanPredictor("resnet_6blocks", ngf=8, artifact=gan_artifact, image_size=SIZE,
                              device="cpu")
    out = pred(np.random.RandomState(1).uniform(-1, 1, (2, SIZE, SIZE, 3)).astype(np.float32))
    assert out.shape == (2, SIZE, SIZE, 3) and float(out.abs().max()) <= 1.0


def test_serve_gan_defaults_and_refusals(gan_artifact, tmp_path):
    with pytest.raises(SystemExit, match="serves --export_int8 artifacts"):  # no artifact
        serve.main(serve.build_parser().parse_args(["--workload", "gan", "--device", "cpu"]))
    with pytest.raises(ValueError):
        serve.GanPredictor(device="cpu")
    # the generated images as PNGs
    serve.main(serve.build_parser().parse_args(
        ["--workload", "gan", "--model", "resnet_6blocks", "--ngf", "8", "--artifact",
         gan_artifact, "--image_size", str(SIZE), "--batch_size", "2", "--iters", "1",
         "--device", "cpu", "--output", str(tmp_path / "out"), "--predict_batches", "2"]))
    assert sorted(os.listdir(tmp_path / "out")) == [f"fake_{i:05d}.png" for i in range(4)]
    args = serve.build_parser().parse_args(["--workload", "gan", "--artifact", gan_artifact])
    assert args.model is None and args.image_size is None  # resnet_9blocks at 256 in main
    assert serve._DEFAULTS["gan"] == ("resnet_9blocks", 256)
