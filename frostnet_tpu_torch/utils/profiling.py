"""Profiling and tracing (``frostnet_tpu/utils/profiling.py``).

* :class:`StepTimer`: steady-state step timing, synchronizing the device;
* :func:`chain_time`: a function's time per call over back-to-back calls,
  best of ``reps``: CUDA events on the card (``chip_smoke.time_ms``'s idiom,
  kept here because the package does not import ``chip_smoke``), the host
  clock for a CPU device;
* :func:`trace`: ``torch.profiler`` around a block, written as a Chrome
  trace, and :func:`load_device_trace` to read it back;
* :func:`device_memory_stats`: each card's memory in use, its peak and its
  size, from ``torch.cuda.memory_stats``.

The JAX package's ``FROSTNET_COMPILE_ONLY`` prewarm has no counterpart:
nothing here compiles.
"""
from __future__ import annotations

import contextlib
import glob
import json
import os
import time
from typing import Callable, Dict, Optional

import torch


def _sync(device) -> None:
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class StepTimer:
    """Wall-clock step timer that skips the first steps (the kernels' build
    and the launch plans) and synchronizes ``device`` around each step."""

    def __init__(self, skip_first: int = 2, device="cuda"):
        self.skip_first, self.device = skip_first, torch.device(device)
        self.count = -skip_first
        self.total = 0.0
        self._t0: Optional[float] = None

    def __enter__(self):
        _sync(self.device)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        _sync(self.device)
        dt = time.perf_counter() - self._t0
        self.count += 1
        if self.count > 0:
            self.total += dt

    @property
    def mean_s(self) -> float:
        return self.total / max(self.count, 1)


def chain_time(fn: Callable[[], object], device="cuda", iters: int = 10, reps: int = 3,
               warmup: int = 2) -> float:
    """Milliseconds per call of ``fn()``: ``iters`` calls back to back,
    best of ``reps``.

    On a CUDA device the calls are timed with CUDA events recorded around
    them on the current stream (the host enqueues ahead: the time is the
    device's span, which host work bounds where it is the longer). On the
    CPU the host clock times them: a CPU time, not a device metric.
    """
    device = torch.device(device)
    for _ in range(warmup):
        fn()
    _sync(device)
    best = float("inf")
    for _ in range(reps):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            torch.cuda.synchronize(device)
            ms = start.elapsed_time(end)
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            ms = (time.perf_counter() - t0) * 1e3
        best = min(best, ms / iters)
    return best


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block with ``torch.profiler`` (CPU and, where there is a
    card, CUDA activity) and write ``logdir/trace.json`` (Chrome format,
    readable in Perfetto). Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def load_device_trace(logdir: str):
    """The newest trace written by :func:`trace` under ``logdir``:
    ``(events, proc, threads)``, the raw ``traceEvents`` list, a ``pid ->
    process name`` map and a ``(pid, tid) -> thread name`` map; None if there
    is no trace."""
    paths = sorted(glob.glob(os.path.join(logdir, "**", "*.json"), recursive=True),
                   key=os.path.getmtime)
    if not paths:
        return None
    with open(paths[-1]) as f:
        events = json.load(f).get("traceEvents", [])
    proc: Dict = {}
    threads: Dict = {}
    for e in events:
        if e.get("ph") == "M" and e.get("name") == "process_name":
            proc[e["pid"]] = e["args"].get("name", "")
        if e.get("ph") == "M" and e.get("name") == "thread_name":
            threads[(e["pid"], e.get("tid"))] = e["args"].get("name", "")
    return events, proc, threads


def device_memory_stats() -> Dict[str, Dict]:
    """``{device: {bytes_in_use, peak_bytes_in_use, bytes_limit}}`` of each
    CUDA device (empty without one)."""
    out = {}
    for i in range(torch.cuda.device_count() if torch.cuda.is_available() else 0):
        stats = torch.cuda.memory_stats(i)
        out[f"cuda:{i}"] = {
            "bytes_in_use": stats.get("allocated_bytes.all.current"),
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak"),
            "bytes_limit": torch.cuda.get_device_properties(i).total_memory,
        }
    return out
