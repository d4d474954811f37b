"""PyTorch port, the program's spans (``utils/profiling.py::span``).

* With no profiler running, ``span`` returns one shared object, records
  nothing and never enters ``record_function`` or the fast record function.
* Under ``torch.profiler``, a QAT step of ``frostnet_quant_small_0_35`` at
  32x32 records ``step`` and its children (``step.input``,
  ``step.forward`` with one ``ops.fake_quant`` a site, ``step.backward``,
  ``step.optimizer`` with the optimizer chain's spans, ``step.metrics``)
  under one unit; the children cover at least 90% of the step, and the
  Chrome trace holds them by name, on the profiler's clock (``cpu_op``
  events of the fast record function).
* A frozen INT8 predictor's forward on the CPU (the fused FrostNet blocks
  and the matmul) records ``request``, ``request.input``,
  ``request.forward`` and its ``ops.*`` spans.
* A second profiler session starts a fresh ``session()``; the hook that
  starts it refuses a torch without ``_run_on_profiler_start``.
* Spans that threads open at once each take their own place in the list
  and their own thread's parent.

Only host times are read here, on the CPU: no device metric.
"""
import json
import sys
import threading

import pytest

import torch
from torch.profiler import ProfilerActivity, profile

from _torch_port import few_threads  # noqa: F401 - a fixture
from frostnet_tpu_torch.models import create_model
from frostnet_tpu_torch.nn import QAT
from frostnet_tpu_torch.optim import get_optimizer, grouped_weight_decay
from frostnet_tpu_torch.quant import freeze
from frostnet_tpu_torch.train import create_train_state, make_train_step, recalibrate
from frostnet_tpu_torch.utils import profiling
from frostnet_tpu_torch.utils.profiling import session, span

MODEL, SIZE, BATCH, CLASSES = "frostnet_quant_small_0_35", 32, 4, 10
COVERED = 0.9  # the least share of a root span its children cover


def _batch(seed):
    gen = torch.Generator().manual_seed(seed)
    return {"image": torch.randint(0, 256, (BATCH, SIZE, SIZE, 3), generator=gen,
                                   dtype=torch.uint8),
            "label": torch.randint(0, CLASSES, (BATCH,), generator=gen)}


def _qat_state(**kw):
    model = create_model(MODEL, num_classes=CLASSES, drop_rate=0.0, **kw)
    tx = get_optimizer("QSGD", 0.04, weight_decay=grouped_weight_decay(4e-5))
    return create_train_state(model, tx, seed=0, device="cpu").start_qat()


def _children(recs, i):
    return [r for r in recs if r.parent == i]


def _coverage(recs, i):
    return sum(r.host_ms for r in _children(recs, i)) / recs[i].host_ms


def test_no_profiler_no_record(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with no profiler running")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    before = list(session())
    assert not torch.autograd.profiler._is_profiler_enabled
    first, second = span("step"), span("step.optimizer", device=torch.device("cpu"))
    assert first is second
    with first:
        with second:
            pass
    assert session() == before


def test_qat_step_spans(few_threads, tmp_path):  # noqa: F811
    state = _qat_state()
    step = make_train_step(QAT, num_classes=CLASSES)
    step(state, _batch(0))  # the first call outside the session
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(state, _batch(1))
    recs = session()
    assert all(r.closed for r in recs)
    roots = [i for i, r in enumerate(recs) if r.parent == -1]
    assert [recs[i].name for i in roots] == ["step"]
    assert {r.unit for r in recs} == {roots[0]}
    by_name = {}
    for i, r in enumerate(recs):
        by_name.setdefault(r.name, []).append(i)
    assert [r.name for r in _children(recs, roots[0])] == \
        ["step.input", "step.forward", "step.backward", "step.optimizer", "step.metrics"]
    assert _coverage(recs, roots[0]) >= COVERED
    forward = by_name["step.forward"][0]
    fq = [recs[i] for i in by_name["ops.fake_quant"]]
    assert fq and all(r.parent == forward for r in fq)
    n_sites = sum(1 for n, _ in state.model.named_buffers() if n.endswith("min_val"))
    assert len(fq) == n_sites > 0
    optimizer = by_name["step.optimizer"][0]
    assert [r.name for r in _children(recs, optimizer)] == \
        ["optim.flatten", "optim.boost", "optim.decay", "optim.trace", "optim.write_back"]
    assert recs[optimizer].events is None and recs[optimizer].device_ms() is None
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("cat") == "cpu_op" and e.get("ph") == "X"]
    for r in recs:  # each span is one trace event of its name
        assert sum(e["name"] == r.name for e in events) == sum(q.name == r.name for q in recs)
    assert len([e for e in events if e["name"] == "ops.fake_quant"]) == n_sites


def test_int8_predictor_spans(few_threads):  # noqa: F811
    state = _qat_state(fuse_int8=True)
    recalibrate(state, [_batch(2)])
    fn = freeze(state.model, "cpu", image_size=SIZE)
    images = torch.randn(2, SIZE, SIZE, 3)
    fn(images)
    with profile(activities=[ProfilerActivity.CPU]):
        fn(images)
        fn(images.numpy())
    recs = session()
    roots = [i for i, r in enumerate(recs) if r.parent == -1]
    assert [recs[i].name for i in roots] == ["request", "request"]
    for root in roots:
        kids = [j for j, r in enumerate(recs) if r.parent == root]
        assert [recs[j].name for j in kids] == ["request.input", "request.forward"]
        assert _coverage(recs, root) >= COVERED
        wrappers = [r.name for r in recs if r.parent == kids[1]]
        assert wrappers and set(wrappers) == {"ops.frost_block", "ops.int8_matmul"}
        assert all(r.unit == root for r in recs[root:root + len(wrappers) + 3])


def test_a_new_session_starts_fresh():
    with profile(activities=[ProfilerActivity.CPU]):
        with span("step"):
            with span("ops.fake_quant"):
                pass
    first = session()
    assert [r.name for r in first] == ["step", "ops.fake_quant"]
    assert first[1].parent == 0 and first[1].unit == 0
    with profile(activities=[ProfilerActivity.CPU]):
        assert session() == []
        with span("request"):
            pass
    assert [r.name for r in session()] == ["request"]
    assert [r.name for r in first] == ["step", "ops.fake_quant"]
    assert profiling.span("x") is profiling.span("y")  # the session over: the null span


def test_each_thread_keeps_its_own_stack():
    threads = 2
    barrier = threading.Barrier(threads, timeout=60)

    def work(k):
        with span(f"request{k}"):
            barrier.wait()
            with span("ops.int8_matmul"):
                barrier.wait()

    with profile(activities=[ProfilerActivity.CPU]):
        ts = [threading.Thread(target=work, args=(k,)) for k in range(threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
            assert not t.is_alive()
    recs = session()
    inner = [r for r in recs if r.name == "ops.int8_matmul"]
    assert len(inner) == threads
    for r in inner:
        assert recs[r.parent].name.startswith("request") and r.unit == r.parent
    assert len({r.parent for r in inner}) == threads
    assert sum(r.parent == -1 for r in recs) == threads


def test_the_session_hook_is_required(monkeypatch):
    monkeypatch.delattr(torch.autograd.profiler, "_run_on_profiler_start")
    with pytest.raises(RuntimeError, match="_run_on_profiler_start"):
        profiling._install_session_hook()


def test_concurrent_spans_take_their_own_index():
    threads, spans = 4, 1000
    barrier = threading.Barrier(threads, timeout=60)

    def work(k):
        barrier.wait()
        for _ in range(spans):
            with span(f"request{k}"):
                with span(f"ops.int8_matmul{k}"):
                    pass

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)  # threads switch between any two bytecodes, nearly
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            ts = [threading.Thread(target=work, args=(k,)) for k in range(threads)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=60)
                assert not t.is_alive()
    finally:
        sys.setswitchinterval(interval)
    recs = session()
    assert len(recs) == threads * spans * 2
    assert [r.index for r in recs] == list(range(len(recs)))
    for r in recs:
        if r.name.startswith("ops."):
            assert recs[r.parent].name == "request" + r.name[len("ops.int8_matmul"):]
            assert r.unit == r.parent
        else:
            assert r.parent == -1 and r.unit == r.index
