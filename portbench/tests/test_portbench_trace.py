"""The trace's summary and the metric readers, on a small Chrome trace."""
import json
from pathlib import Path

import pytest

from portbench.core import Bench
from portbench.drivers.common import Measure
from portbench.trace import summarize
from portbench.tests import tiny

DATA = Path(__file__).parent / "data" / "trace_small.json"


def events():
    return json.loads(DATA.read_text())["traceEvents"]


def test_summary():
    s = summarize(events(), units=1)
    assert s.window_s == pytest.approx(1000e-6)
    assert s.busy_s == pytest.approx(500e-6)
    assert {r.op for r in s.kernels()} == {"aten::cudnn_convolution", "", "aten::add"}
    ops = dict(s.breakdown["device_ops"])
    assert ops["sm90_xmma_fprop_implicit_gemm"] == pytest.approx(200e-6)
    gaps = dict(s.breakdown["idle_gaps"])
    assert gaps["cudaStreamSynchronize"] == pytest.approx(250e-6)
    assert gaps["aten::cudnn_convolution"] == pytest.approx(100e-6)
    assert sum(gaps.values()) == pytest.approx(500e-6)


@pytest.fixture(scope="module")
def measure(tmp_path_factory):
    root = tiny.make_root(tmp_path_factory.mktemp("bench"))
    bench = Bench(root)
    cell = bench.cell(tiny.TRAIN, 1, 1.0, True, None, 0.0)
    cell.config["tables"]["32x32"]["sites"] = [["x", 0, 1000]]
    return bench, Measure(cell, summarize(events(), units=1), [0.002, 0.004], 4, 2.0, 8)


@pytest.mark.parametrize("name,value", [
    ("conv_ms.train", 0.2), ("torch_ops_ms.train", 0.1), ("launches.train", 3),
    ("idle_share.train", 50.0), ("host_ms.train", 3.0), ("h2d_ms.serve", 0.1),
    ("fake_quant_roofline.train", 100 * (9016 / 3.35e12) / 100e-6)])
def test_readers(measure, name, value):
    bench, m = measure
    assert bench.metric_reader(name)(m) == pytest.approx(value)


def test_readers_find_nothing(measure):
    bench, m = measure
    assert bench.metric_reader("frost_block_roofline.serve")(m) is None
    assert bench.metric_reader("int8_matmul_roofline.serve")(m) is None


def test_readers_on_a_recorded_trace():
    """Two served requests of ``frostnet-int8-serve`` (batch 128, the fused
    forward) recorded by ``torch.profiler`` on an H100 and cut down to the
    fields the summary reads: 18 block and 3 matmul kernels a request, each
    request's copies in and out."""
    recorded = json.loads((Path(__file__).parent / "data" / "trace_serve_h100.json").read_text())
    s = summarize(recorded["traceEvents"], units=2)
    names = [k.name for k in s.kernels()]
    assert sum("frost_block_kernel" in n for n in names) == 36
    assert sum("int8_matmul_requant_kernel" in n for n in names) == 6
    assert 0 < s.busy_s < s.window_s
    bench = Bench()
    m = Measure(bench.cell("frostnet-int8-serve", 1, 1.0, True, None, 0.0), s, [0.004], 1, 0.01, 128)
    for name in ("frost_block_roofline.serve", "int8_matmul_roofline.serve", "h2d_ms.serve",
                 "torch_ops_ms.serve", "idle_share.serve"):
        value = bench.metric_reader(name)(m)
        assert value is not None and 0 < value < 100, (name, value)
