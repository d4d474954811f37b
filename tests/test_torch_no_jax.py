"""The PyTorch port stands alone: no JAX and nothing of frostnet_tpu.

``frostnet_tpu_torch`` and ``chip_smoke.py`` import torch and numpy only;
their entry points run on the GPU unless the caller asks for the CPU.
"""
import ast
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "frostnet_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "frostnet_tpu")


def _port_sources():
    files = [os.path.join(ROOT, "chip_smoke.py"),
             os.path.join(ROOT, "scripts", "profile_torch_serving.py"),
             os.path.join(ROOT, "scripts", "time_fake_quant.py"),
             os.path.join(ROOT, "scripts", "time_train_step.py"),
             os.path.join(ROOT, "scripts", "time_frost_block.py")]
    for dirpath, _, names in os.walk(PORT):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    return sorted(files)


def test_importing_the_port_loads_no_jax():
    code = ("import sys; import frostnet_tpu_torch, frostnet_tpu_torch.serve, "
            "frostnet_tpu_torch.gan, frostnet_tpu_torch.models, frostnet_tpu_torch.ops, "
            "frostnet_tpu_torch.train, frostnet_tpu_torch.optim, frostnet_tpu_torch.utils, "
            "frostnet_tpu_torch.data, frostnet_tpu_torch.optim.schedules, "
            "frostnet_tpu_torch.train.classification, frostnet_tpu_torch.train.evaluate, "
            "frostnet_tpu_torch.utils.checkpoint, frostnet_tpu_torch.utils.logging, "
            "frostnet_tpu_torch.segmentation, frostnet_tpu_torch.segmentation.train, "
            "frostnet_tpu_torch.segmentation.evaluate, "
            "frostnet_tpu_torch.detection, frostnet_tpu_torch.detection.train, "
            "frostnet_tpu_torch.detection.qeval, frostnet_tpu_torch.detection.evaluate, "
            "chip_smoke; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in %r); "
            "print(bad); sys.exit(1 if bad else 0)" % (FORBIDDEN,))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_import_in_source(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, f"{path}: imports {name}"


def test_entry_points_default_to_cuda():
    from frostnet_tpu_torch.models import create_model
    from frostnet_tpu_torch.optim import get_optimizer
    from frostnet_tpu_torch.quant.freeze import resolve_device
    from frostnet_tpu_torch.serve import GanPredictor, Int8Predictor
    from frostnet_tpu_torch.train import create_train_state

    artifact = os.path.join(PORT, "testdata", "frostnet_quant_large_1_0_int8.npz")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the CPU-only refusal")
    with pytest.raises(RuntimeError, match="CUDA"):
        Int8Predictor(artifact=artifact)
    with pytest.raises(RuntimeError, match="CUDA"):
        GanPredictor(artifact=os.path.join(PORT, "testdata", "resnet_9blocks_int8.npz"))
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        create_train_state(create_model("frostnet_quant_small_0_35", num_classes=10),
                           get_optimizer("QSGD", 0.04))
    # the trainer's and the evaluator's main, with their defaults
    from frostnet_tpu_torch.train import classification, evaluate
    with pytest.raises(RuntimeError, match="CUDA"):
        classification.main(classification.ClassificationConfig())
    with pytest.raises(RuntimeError, match="CUDA"):
        evaluate.main(evaluate.build_parser([]).parse_args([]))
    with pytest.raises(RuntimeError, match="CUDA"):
        classification.cli([])
    # the segmentation trainer's and evaluator's
    from frostnet_tpu_torch.segmentation import evaluate as seg_evaluate
    from frostnet_tpu_torch.segmentation import train as seg_train
    with pytest.raises(RuntimeError, match="CUDA"):
        seg_train.main(seg_train.SegConfig())
    with pytest.raises(RuntimeError, match="CUDA"):
        seg_train.cli([])
    with pytest.raises(RuntimeError, match="CUDA"):
        seg_evaluate.main(seg_evaluate.build_parser().parse_args([]))
    # the detection trainer's, evaluator's and server's
    from frostnet_tpu_torch.detection import qeval as det_qeval
    from frostnet_tpu_torch.detection import train as det_train
    from frostnet_tpu_torch.serve import DetPredictor
    with pytest.raises(RuntimeError, match="CUDA"):
        det_train.main(det_train.DetConfig())
    with pytest.raises(RuntimeError, match="CUDA"):
        det_train.cli([])
    with pytest.raises(RuntimeError, match="CUDA"):
        det_qeval.main(det_qeval.build_parser().parse_args([]))
    with pytest.raises(RuntimeError, match="CUDA"):
        DetPredictor(artifact="det")


def test_chip_smoke_refuses_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
