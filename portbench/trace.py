"""The traced stretch of a ``--trace 1`` run: ``torch.profiler`` over a few
steps or requests from the middle of the window, its Chrome trace written
under ``TMPDIR`` and read back into the records the metric readers use.

A device record keeps its kernel name, the CPU operator that launched it
(the profiler's ``External id`` link: the innermost ``aten::`` op, empty for
a launch from outside the dispatcher such as the port's ctypes wrappers),
its start and its length. The stretch is the benchmark's own
``portbench.window`` annotation, which starts and ends on a
``torch.cuda.synchronize()``, so every device record of the stretch lies
inside it.
"""
from __future__ import annotations

import contextlib
import dataclasses
import heapq
import json
import os
import tempfile
from collections import defaultdict
from typing import Dict, Iterator, List, Optional, Tuple

import torch

WINDOW = "portbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver", "python_function")


@dataclasses.dataclass
class DeviceRecord:
    name: str
    cat: str         # kernel, gpu_memcpy, gpu_memset
    op: str          # the launching CPU operator, '' where none
    start_us: float
    dur_us: float


@dataclasses.dataclass
class TraceSummary:
    """The stretch's device records, its length and its busy time."""

    records: List[DeviceRecord]
    window_s: float
    busy_s: float
    units: int                 # steps or requests inside the stretch
    breakdown: dict

    def kernels(self) -> List[DeviceRecord]:
        return [r for r in self.records if r.cat == "kernel"]


@contextlib.contextmanager
def traced_stretch(device) -> Iterator[dict]:
    """Profile the block; on exit the yielded dict holds ``summary``, a
    :class:`TraceSummary` (``units`` is set by the caller's ``box["units"]``)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    box: dict = {"units": 0}
    on_card = device.type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    if on_card:
        torch.cuda.synchronize(device)
    with profile(activities=activities) as prof:
        with record_function(WINDOW):
            yield box
            if on_card:
                torch.cuda.synchronize(device)
    fd, path = tempfile.mkstemp(suffix=".json", prefix="portbench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    box["summary"] = summarize(events, box["units"])


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def summarize(events: List[dict], units: int) -> TraceSummary:
    """Device records, busy time and the breakdown of one stretch, from the
    events of a Chrome trace that holds one ``portbench.window`` span."""
    spans = [e for e in events if e.get("name") == WINDOW and e.get("cat") == "user_annotation"]
    if not spans:
        raise RuntimeError("the trace holds no portbench.window span")
    w0 = float(spans[0]["ts"])
    w1 = w0 + float(spans[0]["dur"])
    ops: Dict[int, str] = {}
    host = []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        if cat == "cpu_op":
            ext = (e.get("args") or {}).get("External id")
            if ext is not None:
                ops[ext] = e["name"]
        if cat in HOST_CATS and e.get("name") != WINDOW:
            host.append((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), e["name"]))
    records = []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        if ts + dur < w0 or ts > w1:
            continue
        ext = (e.get("args") or {}).get("External id")
        records.append(DeviceRecord(e["name"], e["cat"], ops.get(ext, ""), ts, dur))
    busy = _union([(max(r.start_us, w0), min(r.start_us + r.dur_us, w1)) for r in records])
    busy_us = sum(b - a for a, b in busy)
    return TraceSummary(records=records, window_s=(w1 - w0) / 1e6, busy_s=busy_us / 1e6,
                        units=units, breakdown=_breakdown(records, busy, host, w0, w1))


def _breakdown(records: List[DeviceRecord], busy, host, w0: float, w1: float) -> dict:
    """The ten device operations with the most time, and idle time by what
    the host was doing: the innermost host event over each gap's middle."""
    by_op: Dict[str, float] = defaultdict(float)
    for r in records:
        by_op[r.name[:160]] += r.dur_us / 1e6
    gaps, t = [], w0
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if t < w1:
        gaps.append((t, w1))
    by_host: Dict[str, float] = defaultdict(float)
    host = sorted(host)
    active: List[Tuple[float, float, str]] = []  # a heap by end: (end, length, name)
    i = 0
    for a, b in gaps:  # in order, so their middles rise
        mid = (a + b) / 2
        while i < len(host) and host[i][0] <= mid:
            s, e, name = host[i]
            heapq.heappush(active, (e, e - s, name))
            i += 1
        while active and active[0][0] < mid:
            heapq.heappop(active)
        label = min(active, key=lambda t: t[1])[2] if active else "host: no traced event"
        by_host[label[:160]] += (b - a) / 1e6
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(by_host.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k, v] for k, v in top], "idle_gaps": [[k, v] for k, v in idle]}


def classify(summary: Optional[TraceSummary], port_kernels: Tuple[str, ...],
             library_ops: Tuple[str, ...]) -> Dict[str, List[DeviceRecord]]:
    """The stretch's kernels in three groups: ``port`` (a name holding one of
    ``port_kernels``), ``library`` (launched by one of ``library_ops``) and
    ``torch_ops`` (the rest)."""
    groups: Dict[str, List[DeviceRecord]] = {"port": [], "library": [], "torch_ops": []}
    for r in summary.kernels() if summary is not None else []:
        if any(k in r.name for k in port_kernels):
            groups["port"].append(r)
        elif r.op in library_ops:
            groups["library"].append(r)
        else:
            groups["torch_ops"].append(r)
    return groups
