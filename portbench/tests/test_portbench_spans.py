"""The readers of the program's spans: each tiny cell's ``--trace 1`` run
reports its new per-layer metrics, finite and above 0 (``optimizer_ms.*``,
which reads CUDA events, is left out on the CPU), a program without the
spans gives them none, and only closed ``step`` and ``request`` roots are
units: a stray root span neither counts as one nor adds to a metric."""
import math

import pytest

from portbench.spans import device_ms, host_ms, prefix_host_ms
from portbench.tests import tiny

NEW = {tiny.TRAIN: ["wrapper_host_ms.train", "forward_host_ms.train", "backward_host_ms.train",
                    "optimizer_host_ms.train"],
       tiny.SEG_TRAIN: ["wrapper_host_ms.seg_train", "forward_host_ms.seg_train",
                        "backward_host_ms.seg_train", "optimizer_host_ms.seg_train"],
       tiny.SERVE: ["wrapper_host_ms.serve", "forward_host_ms.serve", "input_host_ms.serve"],
       tiny.SEG_SERVE: ["wrapper_host_ms.serve", "forward_host_ms.serve", "input_host_ms.serve"]}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("workload", list(NEW))
def test_traced_run_reports_the_span_metrics(root, workload):
    line = tiny.run(root, workload, trace=True)
    assert line["correct"] is True
    for name in NEW[workload]:
        value = line["metrics"][name]["value"]
        assert math.isfinite(value) and value > 0, (name, value)
    assert not any(k.startswith("optimizer_ms.") for k in line["metrics"])


def test_no_records_no_metric(monkeypatch):
    from frostnet_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "session", lambda: [])
    assert host_ms(None, "step.forward") is None
    assert prefix_host_ms(None, "ops.") is None
    assert device_ms(None, "step.optimizer") is None
    monkeypatch.delattr(profiling, "session")
    assert host_ms(None, "request.input", self_time=True) is None


def test_only_step_and_request_roots_are_units():
    import torch
    from torch.profiler import ProfilerActivity, profile

    from frostnet_tpu_torch.utils.profiling import session, span

    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(2):
            with span("step"):
                with span("step.forward"):
                    with span("ops.fake_quant"):
                        torch.ones(4).sum()
        with span("ops.fake_quant"):  # a stray root between the steps
            torch.ones(4).sum()
        with span("step"):
            pass
    recs = session()
    recs[-1].end_ns = 0  # the last step left open: no unit
    inner = [r for r in recs if r.name == "ops.fake_quant" and r.parent != -1]
    steps = [r for r in recs if r.name == "step" and r.closed]
    assert len(inner) == len(steps) == 2
    assert prefix_host_ms(None, "ops.") == pytest.approx(sum(r.host_ms for r in inner) / 2)
    assert host_ms(None, "step") == pytest.approx(sum(r.host_ms for r in steps) / 2)
    forward = [r for r in recs if r.name == "step.forward"]
    assert host_ms(None, "step.forward", self_time=True) == pytest.approx(
        sum(r.host_ms for r in forward) / 2 - sum(r.host_ms for r in inner) / 2)
