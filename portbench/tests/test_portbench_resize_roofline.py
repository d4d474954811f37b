"""``resize_roofline.serve``: the bound of the segmentation serving cell's
three resizes from its configuration and traffic, and a reading from a
trace with and without the resize kernel."""
import pytest

from portbench.core import Bench
from portbench.drivers.common import Measure
from portbench.trace import DeviceRecord, TraceSummary

CELL = "seg-int8-serve"


def _measure(bench, kernels, units=2):
    cell = bench.cell(CELL, 1, 1.0, True, None, 0.0)
    records = [DeviceRecord(name, "kernel", "", 10.0 * i, us) for i, (name, us) in
               enumerate(kernels)]
    summary = TraceSummary(records, 1e-3, 5e-4, units, {})
    return Measure(cell, summary, [0.03], 4, 0.1, bench.traffic(cell.workload["traffic"])["batch"])


def test_bound_of_the_seg_cell():
    bench = Bench()
    metric = bench.module("metrics", "resize_roofline.serve")
    m = _measure(bench, [])
    rows = metric.resize_rows(m.tables, (512, 1024))
    assert m.batch == 8
    assert rows == [(1, 3, 32, 64, 128), (32, 64, 64, 128, 128), (64, 128, 512, 1024, 19)]
    nbytes = [metric.resize_cost(*row, m.batch) for row in rows]
    assert [round(b / 1e6, 1) for b in nbytes] == [8.4, 41.9, 323.7]
    assert round(sum(nbytes) / 1e6, 1) == 374.1
    assert round(metric.resize_bound_s(rows, m.batch) * 1e3, 4) == 0.1117


def test_reading_counts_the_kept_launches_and_finds_nothing_without_the_kernel():
    bench = Bench()
    read = bench.metric_reader("resize_roofline.serve")
    metric = bench.module("metrics", "resize_roofline.serve")
    bound_us = 1e6 * metric.resize_bound_s(
        metric.resize_rows(_measure(bench, []).tables, (512, 1024)), 8)
    name = "void (anonymous namespace)::resize_bilinear_kernel<float, true, true>(Params)"
    # two requests, three launches each, taking twice the bound in all
    six = [(name, 2 * bound_us / 3)] * 6 + [("elementwise_kernel", 50.0)]
    assert read(_measure(bench, six)) == pytest.approx(50.0)
    # the trace kept five of the six: the bound counts five sixths
    assert read(_measure(bench, six[1:])) == pytest.approx(50.0)
    assert read(_measure(bench, [("vectorized_elementwise_kernel<2>", 26.0)])) is None
    assert read(_measure(bench, six, units=0)) is None
