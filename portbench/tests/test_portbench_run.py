"""A run's result line, its refusal without a card, and the ``correct``
decision: the clean path passes; the control and each planted fault fail."""
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from portbench.core import PACKAGE
from portbench.tests import tiny

KEYS = {"correct", "attempted", "failed", "metrics", "device", "phases_s", "checks"}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("workload", [tiny.TRAIN, tiny.SERVE, tiny.SEG_TRAIN, tiny.SEG_SERVE])
@pytest.mark.parametrize("trace", [False, True])
def test_result_line(root, workload, trace):
    line = tiny.run(root, workload, trace=trace)
    assert set(line) == KEYS | ({"breakdown"} if trace else set())
    assert list(line)[-1] == "checks" and line["correct"] is True
    spec = json.loads((root.parent / "BENCHMARK.json").read_text())
    want = {m["name"] for m in spec["per_layer" if trace else "end_to_end"]
            if workload in m.get("workloads", [workload])}
    assert set(line["metrics"]) <= want
    if not trace:
        assert set(line["metrics"]) == want
    assert line["attempted"] > 0 and line["failed"] == 0
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    json.dumps(line, allow_nan=False)


def _refuses(cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(cwd))
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", tiny.TRAIN,
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=300)
    return out.returncode != 0 and out.stdout.strip() == ""


def test_refuses_without_a_card():
    assert not torch.cuda.is_available() or os.environ.get("CUDA_VISIBLE_DEVICES") == ""
    assert _refuses(PACKAGE.parent)


def test_refuses_with_only_the_benchmark(tmp_path):
    shutil.copytree(PACKAGE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(PACKAGE.parent / "BENCHMARK.json", tmp_path)
    assert _refuses(tmp_path)


def _broken_state(monkeypatch):
    from frostnet_tpu_torch.optim import gradboost

    monkeypatch.setattr(gradboost.QSGD, "step", lambda self, closure=None: None)


def _half_batch(monkeypatch):
    from frostnet_tpu_torch.train import state

    ce = state.cross_entropy

    def half(logits, labels, **kw):
        n = logits.shape[0] // 2
        return ce(logits[:n], labels[:n], **kw)

    monkeypatch.setattr(state, "cross_entropy", half)


def _seg_half_batch(monkeypatch):
    from frostnet_tpu_torch.segmentation import train

    loss = train.seg_step_loss

    def half(logits, label, *args, **kw):
        n = logits.shape[0] // 2
        return loss(logits[:n], label[:n], *args, **kw)

    monkeypatch.setattr(train, "seg_step_loss", half)


def _altered_answer(monkeypatch):
    from frostnet_tpu_torch import serve

    for cls in (serve.Int8Predictor, serve.FrozenPredictor):
        def altered(self, images, call=cls.__call__):
            out = call(self, images).clone()
            out[0] = out[0].flip(-1)
            return out

        monkeypatch.setattr(cls, "__call__", altered)


@pytest.mark.parametrize("workload,fault", [(tiny.TRAIN, _broken_state),
                                            (tiny.TRAIN, _half_batch),
                                            (tiny.SERVE, _altered_answer),
                                            (tiny.SEG_TRAIN, _broken_state),
                                            (tiny.SEG_TRAIN, _seg_half_batch),
                                            (tiny.SEG_SERVE, _altered_answer)],
                         ids=["state-unchanged", "half-batch", "altered-answer",
                              "seg-state-unchanged", "seg-half-batch", "seg-altered-answer"])
def test_a_fault_is_not_correct(root, monkeypatch, workload, fault):
    fault(monkeypatch)
    line = tiny.run(root, workload)
    assert line["correct"] is False, line["checks"]


@pytest.mark.parametrize("workload", [tiny.TRAIN, tiny.SERVE, tiny.SEG_TRAIN, tiny.SEG_SERVE])
def test_the_control_is_not_correct(root, workload):
    """The reference one precision lower in the program's place (TF32 convs
    for training, 4-bit grids for INT8 serving) reads over the cell's
    limits; the program reads within them."""
    from portbench.core import Bench

    bench = Bench(root)
    cell = bench.cell(workload, 424242, 0.0, False, torch.device("cpu"), 0.0)
    out = bench.driver(cell.traffic, cell.config).DRIVER.readings(cell, True)
    limits = cell.limits["limits"]
    control = out["control_tf32" if cell.traffic["kind"] == "train" else "control_int4"]
    assert any(control[k] > limits[k] for k in limits), control
    assert all(out["program"][k] <= limits[k] for k in limits), out["program"]
