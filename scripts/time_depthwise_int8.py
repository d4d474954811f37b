"""Time the INT8 depthwise kernel at the depthwise convs of the served
segmentation trunk (``mobilenetv3_large``, dilated, 512x1024) at batch 8.

Runs on a machine with one CUDA card:

    python3 scripts/time_depthwise_int8.py --out build/depthwise.json

``chip_smoke.py`` phase 24 runs the same :func:`run`. The shapes are those of
the benchmark's segmentation serving cell (:func:`seg_shapes`: the rows that
its ``depthwise_roofline.serve`` metric reads, with the stride and dilation of
the port's layer of each row's name), and each shape's bound is that metric's
arithmetic (:func:`cost`). Each shape gets seeded random codes, taps and
epilogue constants (ReLU on the 0..255 grid); the kernel is first checked bit
for bit against its plain version (``depthwise_acc`` then
``requant_epilogue`` on the card), then timed:

* ``device_ms``: the summed durations of the kernel's launches that
  torch.profiler records, per call (the median of ``REPS`` calls a shape),
  and ``roofline_pct`` on it; None where the profiler records nothing (it
  stops recording after many sessions in one long process, as in
  ``chip_smoke.py``);
* ``graph_ms``: one replay of a CUDA graph of ``GRAPH_N`` launches of the
  shape, over ``GRAPH_N``, timed with CUDA events (the device's gaps between
  launches count, the host's work does not), and ``graph_roofline_pct`` on
  it; the line ``all`` replays one graph of the 15 shapes;
* ``plain_ms``: the plain version's device time per call, by the profiler
  (every kernel it launches), and its launches a call (None as above);
* ``bound_ms``: the least time, the input codes read and the output codes
  written once, the taps and 8 bytes of constants a channel, at 3.35 TB/s
  (every shape is bound by bytes: 2 operations a tap and output code against
  1,979 TOP/s is under a fiftieth of it).

Prints one line per shape and the total, then one JSON line.
"""
from __future__ import annotations

import argparse
import bisect
import functools
import json
import os
import statistics
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from frostnet_tpu_torch.ops.depthwise_int8 import (depthwise_int8,  # noqa: E402
                                                   depthwise_int8_plain, depthwise_operands)

CELL = "seg-int8-serve"
METRIC = "depthwise_roofline.serve"
BATCH = 8
REPS = 5
GRAPH_N = 10


@functools.lru_cache(maxsize=None)
def seg_cell():
    """(the metric's module, the cell's configuration, its table set, its
    batch) of the benchmark's segmentation serving cell."""
    from portbench.core import Bench

    bench = Bench()
    cell = bench.workload(CELL)
    config = bench.config(cell["config"])
    traffic = bench.traffic(cell["traffic"])
    h, w = traffic["image_size"]
    return (bench.module("metrics", METRIC), config, config["tables"][f"{h}x{w}"],
            traffic["batch"])


@functools.lru_cache(maxsize=None)
def seg_shapes():
    """(H, W, C, kernel, stride, dilation) of each depthwise conv of the
    cell's model: the input size and channels of each row that the metric
    reads, the stride and dilation of the port's layer of that row."""
    from frostnet_tpu_torch.nn import QConvBNAct
    from frostnet_tpu_torch.segmentation import get_seg_model

    metric, config, tables, _ = seg_cell()
    layers = [m for m in get_seg_model(config["model"]).modules()
              if isinstance(m, QConvBNAct) and m.depthwise]
    rows = metric.depthwise_rows(tables)
    if len(layers) != len(rows):
        raise ValueError(f"{len(rows)} depthwise rows, {len(layers)} depthwise layers")
    shapes = []
    for (hw_in, ho, wo, c, k), layer in zip(rows, layers):
        s, d = layer.strides, layer.dilation
        if (ho * s * wo * s, c, (k, k)) != (hw_in, layer.in_features, layer.kernel_size):
            raise ValueError(f"row {(hw_in, ho, wo, c, k)} does not fit its layer")
        shapes.append((ho * s, wo * s, c, k, s, d))
    return tuple(shapes)


def cost(shape, batch: int = BATCH):
    """(bytes, operations) of one shape at ``batch``: the metric's."""
    h, w, c, k, s, _ = shape
    return seg_cell()[0].depthwise_cost(h * w, -(-h // s), -(-w // s), c, k, batch)


def case(shape, seed, device, batch: int = BATCH):
    """(x, operands) of one shape: random codes, taps and constants."""
    h, w, c, k, s, d = shape
    g = torch.Generator().manual_seed(seed)
    x = torch.randint(0, 256, (batch, h, w, c), generator=g, dtype=torch.uint8)
    qw = torch.randint(-128, 128, (k, k, 1, c), generator=g, dtype=torch.int8)
    comb = 0.02 * (0.004 + 0.01 * torch.rand(c, generator=g))
    bias = torch.randn(c, generator=g)
    pad = d * (k - 1) // 2
    op = depthwise_operands(qw, comb, bias, 100, 0.1, 0, True, 0, 255, s, d, (pad, pad), device)
    return x.to(device), op


def profile_ms(fn, reps=REPS):
    """(median device ms a call, launches a call): every CUDA kernel that
    torch.profiler records over ``reps`` calls, split by call; (None, None)
    where it records none."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(reps):
            with record_function(f"call{i}"):
                fn()
            torch.cuda.synchronize()
    events = prof.events()
    starts = sorted(e.time_range.start for e in events
                    if e.name.startswith("call") and e.device_type == DeviceType.CPU)
    # the kernels (not the device-side copies of the ``call`` annotations),
    # each in the call that started before it
    kernels = {(e.name, e.time_range.start): e.time_range.elapsed_us() for e in events
               if e.device_type == DeviceType.CUDA and not e.name.startswith("call")}
    if not kernels or not starts:
        return None, None
    per, counts = [0.0] * len(starts), [0] * len(starts)
    for (_, start), us in kernels.items():
        i = bisect.bisect_right(starts, start) - 1
        if i >= 0:
            per[i] += us / 1e3
            counts[i] += 1
    return statistics.median(per), statistics.median(counts)


def graph_ms(fn, n=GRAPH_N) -> float:
    """ms of one replay of a CUDA graph of ``n`` calls of ``fn``, over ``n``."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(REPS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end))
    return best / n


def run(dev, log=print) -> dict:
    """Check and time the kernel at each shape of :func:`seg_shapes`; the
    rows and their total."""
    from portbench.costs import PEAKS, bound_s

    shapes = seg_shapes()
    cases = [case(shape, 1000 + i, dev) for i, shape in enumerate(shapes)]
    rows = []
    for shape, (x, op) in zip(shapes, cases):
        if not torch.equal(depthwise_int8(x, op), depthwise_int8_plain(x, op)):
            raise AssertionError(f"{shape}: the kernel differs from its plain version")
        dev_ms, n = profile_ms(lambda: depthwise_int8(x, op))
        plain_ms, plain_n = profile_ms(lambda: depthwise_int8_plain(x, op))
        row = {"shape": list(shape), "device_ms": dev_ms, "launches": n,
               "graph_ms": graph_ms(lambda: depthwise_int8(x, op)), "plain_ms": plain_ms,
               "plain_launches": plain_n,
               "bound_ms": 1e3 * bound_s(*cost(shape), PEAKS["int8_ops_per_s"])}
        rows.append(shares(row, "device_ms", "graph_ms"))
        log(f"{'x'.join(map(str, shape)):>20}: {text(row)}")

    def all_kernels():
        for x, op in cases:
            depthwise_int8(x, op)

    total = {k: None if any(r[k] is None for r in rows) else sum(r[k] for r in rows)
             for k in ("device_ms", "graph_ms", "plain_ms", "bound_ms", "plain_launches")}
    total["graph_all_ms"] = graph_ms(all_kernels, 1)
    shares(total, "device_ms", "graph_all_ms")
    log(f"all {len(rows)}: {text(total)} (per-shape graphs {total['graph_ms']:.4f})")
    return {"batch": BATCH, "rows": rows, "total": total}


def shares(row: dict, device: str, graph: str) -> dict:
    """``roofline_pct`` on the profiler's time (None without it) and
    ``graph_roofline_pct`` on the graph's."""
    row["roofline_pct"] = None if row[device] is None else 100.0 * row["bound_ms"] / row[device]
    row["graph_roofline_pct"] = 100.0 * row["bound_ms"] / row[graph]
    return row


def text(row: dict) -> str:
    def ms(v, digits=4):
        return "not recorded" if v is None else f"{v:.{digits}f} ms"

    graph = row.get("graph_all_ms", row["graph_ms"])
    pct = "" if row["roofline_pct"] is None else f", {row['roofline_pct']:.1f}% of the bound"
    return (f"device {ms(row['device_ms'])}{pct}; graph {ms(graph)}, "
            f"{row['graph_roofline_pct']:.1f}%; bound {ms(row['bound_ms'])}; plain "
            f"{ms(row['plain_ms'], 3)} in {row['plain_launches']} launches")


def card() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return torch.cuda.get_device_name(0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    report = {"card": card(), "torch": torch.__version__, **run(torch.device("cuda"))}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
