"""The detection evaluator's export and ``serve --workload det`` of the
PyTorch port, on the CPU: ``qeval``'s ``--export_int8`` artifacts equal
JAX's ``export_int8`` of the same variables, array for array;
``serve --workload det`` serves them and writes the detections
``DetPredictor.detect`` gives; its refusals carry the JAX server's messages.
"""
import json
import os

import numpy as np
import pytest

from _torch_port import few_threads, jax_variables  # noqa: F401 - a fixture
from frostnet_tpu_torch import serve
from frostnet_tpu_torch.detection import qeval

pytestmark = pytest.mark.usefixtures("few_threads")


def test_export_equals_jax_and_serves(tmp_path):
    """The evaluator's export of the calibrated qtdsod fixture equals JAX
    ``export_int8`` array for array; ``serve --workload det`` serves it."""
    from chip_smoke import det_variables
    from frostnet_tpu import quant as jq

    fv, hv = det_variables("qtdsod")
    base = str(tmp_path / "tdsod")
    out = qeval.evaluator("qtdsod", feat_vars=fv, head_vars=hv, modes=(),
                          export_int8_path=base, device="cpu")
    assert out["export_bytes"] == sum(os.path.getsize(f"{base}_{p}.npz") for p in ("feat", "head"))
    for part, tree in (("feat", fv), ("head", hv)):
        theirs = str(tmp_path / f"jax_{part}.npz")
        jq.export_int8(jax_variables(tree), theirs)
        with np.load(f"{base}_{part}.npz") as a, np.load(theirs) as b:
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    dets = str(tmp_path / "dets.jsonl")
    rep = serve.main(serve.build_parser().parse_args(
        ["--workload", "det", "--model", "qtdsod", "--artifact", base + ".npz", "--device",
         "cpu", "--iters", "1", "--batch_size", "2", "--output", dets, "--predict_batches",
         "1"]))
    assert rep["workload"] == "det" and rep["model"] == "qtdsod"
    lines = [json.loads(x) for x in open(dets)]
    assert [r["image"] for r in lines] == [0, 1]
    pred = serve.DetPredictor("qtdsod", artifact=base, device="cpu")
    args = serve.build_parser().parse_args(["--workload", "det", "--artifact", base,
                                            "--batch_size", "2"])
    args.image_size = 300
    gen = serve._batches(args)
    for _ in range(3):  # warm-up, one latency and one pipeline request
        next(gen)
    d = pred.detect(next(gen)).numpy()
    want = [sum(int(s > 0) for c in range(1, 21) for s in d[b, c, :, 0]) for b in range(2)]
    assert [len(r["detections"]) for r in lines] == want and sum(want) > 0


def test_serve_det_refusals(tmp_path):
    parse = serve.build_parser().parse_args
    with pytest.raises(SystemExit, match="serves qssd|qtdsod"):
        serve.main(parse(["--workload", "det", "--model", "resnet18", "--artifact", "x"]))
    with pytest.raises(SystemExit, match="input size 300, got --image_size 320"):
        serve.main(parse(["--workload", "det", "--artifact", "x", "--image_size", "320"]))
    with pytest.raises(SystemExit, match="classification-only"):
        serve.main(parse(["--workload", "det", "--artifact", "x", "--fuse_int8"]))
