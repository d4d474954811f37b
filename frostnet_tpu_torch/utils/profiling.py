"""Profiling and tracing (``frostnet_tpu/utils/profiling.py``).

* :func:`span`: a named span of the program's own work, recorded only while
  a ``torch.profiler`` session runs (an event of its trace, on the kernels'
  clock, and a :class:`SpanRecord` in memory); with no session it costs one
  flag check. :func:`session` gives the latest session's records;
* :func:`chain_time`: a function's time per call over back-to-back calls,
  best of ``reps``: CUDA events on the card (``chip_smoke.time_ms``'s idiom,
  kept here because the package does not import ``chip_smoke``), the host
  clock for a CPU device;
* :func:`trace`: ``torch.profiler`` around a block, written as a Chrome
  trace, and :func:`load_device_trace` to read it back.

The program's spans, by name (``step`` and ``request`` are roots: each is
one unit of work, and a record's ``unit`` is the index of its root; a span
opened outside any, such as one on autograd's own thread, is a root of its
own and of no unit that the benchmark counts):

* ``step`` of ``train/state.py::make_train_step`` and
  ``segmentation/train.py::make_seg_train_step``: ``step.input`` (the
  batch to the device, ``prep_image``), ``step.forward`` (model and loss),
  ``step.backward`` (``zero_grad``, ``loss.backward()``),
  ``step.optimizer`` (with CUDA events) and ``step.metrics``;
* under ``step.optimizer``, ``optim/gradboost.py``'s chain:
  ``optim.flatten``, ``optim.<stage>`` for each stage, ``optim.write_back``;
* ``request`` of ``quant/freeze.py::freeze``'s predictor: ``request.input``
  (the images to the device), ``request.forward`` and, where the request
  has a post-processing step, that step's span (``request.detect`` of
  ``serve.DetPredictor``: the softmax and ``detection/nms.py::detect``,
  inside it ``det.decode`` and ``det.nms``, the latter with CUDA events);
* ``ops.fake_quant``, ``ops.int8_matmul``, ``ops.frost_block``,
  ``ops.int8_conv`` and ``ops.depthwise``: the whole call of each kernel
  wrapper.

The JAX package's ``FROSTNET_COMPILE_ONLY`` prewarm has no counterpart:
nothing here compiles.
"""
from __future__ import annotations

import contextlib
import glob
import json
import os
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch.autograd import profiler as _autograd_profiler


def _sync(device) -> None:
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


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


class SpanRecord:
    """One span of a profiler session, and the context manager that records
    it (:func:`span`): host times on ``perf_counter_ns`` (``end_ns`` 0
    while open), its index in the session's records, its enclosing span's
    (``parent``, -1 for a root) and its root's (``unit``, its own for a
    root), and the pair of timing events of a span opened with a CUDA
    ``device``."""

    __slots__ = ("name", "index", "parent", "unit", "start_ns", "end_ns", "events", "_device",
                 "_stack", "_record")

    def __init__(self, name: str, device: Optional[torch.device]):
        self.name, self._device = name, device
        self.start_ns = self.end_ns = 0
        self.events: Optional[Tuple[torch.cuda.Event, torch.cuda.Event]] = None

    def __enter__(self):
        sess = _SESSION
        self._stack = stack = sess.stacks.setdefault(threading.get_ident(), [])
        with sess.lock:  # another thread's span may open between the two
            self.index = len(sess.records)
            sess.records.append(self)
        if stack:
            self.parent, self.unit = stack[-1].index, stack[-1].unit
        else:
            self.parent, self.unit = -1, self.index
        stack.append(self)
        self._record = torch._C._profiler._RecordFunctionFast(self.name)
        self._record.__enter__()
        if self._device is not None and self._device.type == "cuda":
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record(torch.cuda.current_stream(self._device))
        self.start_ns = time.perf_counter_ns()

    def __exit__(self, *exc):
        self.end_ns = time.perf_counter_ns()
        if self.events is not None:
            self.events[1].record(torch.cuda.current_stream(self._device))
        self._stack.pop()
        self._record.__exit__(*exc)
        self._stack = self._record = None
        return False

    @property
    def closed(self) -> bool:
        return self.end_ns > 0

    @property
    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6

    def device_ms(self) -> Optional[float]:
        """Milliseconds of the device's stream between the span's two events
        (waits for the second); None for a span without them."""
        if self.events is None:
            return None
        start, end = self.events
        end.synchronize()
        return start.elapsed_time(end)


class _Session:
    """The records of one profiler session, each thread's open spans, and
    the lock under which a span takes its index and its place in the list."""

    def __init__(self):
        self.records: List[SpanRecord] = []
        self.stacks: Dict[int, List[SpanRecord]] = {}
        self.lock = threading.Lock()


_SESSION = _Session()


def _install_session_hook() -> None:
    """Start a fresh :class:`_Session` whenever a profiler session starts
    (``torch.autograd.profiler`` calls ``_run_on_profiler_start`` as it
    sets its flag). Raises where torch has no such function: without the
    hook every session's records would pile into one list."""
    start = getattr(_autograd_profiler, "_run_on_profiler_start", None)
    if start is None:
        raise RuntimeError("torch.autograd.profiler._run_on_profiler_start is missing: "
                          "the spans cannot tell one profiler session from the next")
    if getattr(start, "_starts_span_session", False):
        return

    def on_start():
        global _SESSION
        _SESSION = _Session()
        start()

    on_start._starts_span_session = True
    _autograd_profiler._run_on_profiler_start = on_start


_install_session_hook()


class _NullSpan:
    """What :func:`span` returns with no profiler running: one shared object
    that does nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


def span(name: str, device: Optional[torch.device] = None):
    """A context manager naming a span of the program's work.

    Its gate is ``torch.autograd.profiler._is_profiler_enabled``, the flag a
    ``torch.profiler`` session sets. With no session it returns one shared
    object that does nothing (the flag check is the whole cost). In a
    session the span enters the profiler's fast record function
    (``torch._C._profiler._RecordFunctionFast``: a ``cpu_op`` event of the
    Chrome trace, on the same clock as the kernels) and appends a
    :class:`SpanRecord` to :func:`session`'s list; with a CUDA ``device`` it
    also records a pair of timing events on that device's current stream at
    its bounds, resolved only when read (``SpanRecord.device_ms``). Under a
    CUDA profiler on an H100 machine's host the fast record function costs
    1-5 us a span; ``record_function`` (a ``user_annotation``) costs 11-20
    us, 2-3% of a traced FrostNet serving request at 24 spans.
    """
    if not _autograd_profiler._is_profiler_enabled:
        return _NULL_SPAN
    return SpanRecord(name, device)


def session() -> List[SpanRecord]:
    """The span records of the latest profiler session (the running one, or
    the last that ran), in the order the spans opened."""
    return _SESSION.records
