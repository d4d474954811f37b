"""PyTorch port, detection serving through ``quant/freeze.py::freeze``.

``serve.DetPredictor`` freezes ``detection.models.Detector(feat, head)``
once and runs the softmax and ``detection/nms.py::detect`` inside the same
request (``freeze``'s ``post`` step). On the CPU, at 300x300 (the priors'
size) and batch 1 or 2, from a seeded and calibrated ``qssd``:

* its ``(loc, conf)`` and its detections are bit-equal to the frozen feature
  net and float head run by hand, then ``detect`` (the predictor's former
  path), at the server's and at the evaluator's thresholds;
* two replicas, each detecting its own rows, give the same detections;
* under ``torch.profiler`` a request records ``request`` with the children
  ``request.input``, ``request.forward`` and ``request.detect``, and in
  ``request.detect`` the spans ``det.decode`` and ``det.nms`` (with no CUDA
  events on the CPU), all in one unit;
* with no profiler a request records nothing;
* off the card ``utils/cuda_graphs.py::Replay`` calls its function every
  time. On the card (marker ``cuda``): the greedy pass and SSD's requests
  replayed from CUDA graphs are bit-equal to the same work issued op by op,
  request after request, and a replayed request still records its spans;
  Tiny-DSOD, its forward issued op by op, gives the same too.

Only host times are read here, on the CPU: no device metric.
"""
import numpy as np
import pytest

import torch
from torch.profiler import ProfilerActivity, profile

from _torch_port import cuda_device, few_threads  # noqa: F401 - fixtures
from frostnet_tpu_torch import serve
from frostnet_tpu_torch.detection.anchors import VOC_CFG, make_priors
from frostnet_tpu_torch.detection.models import Detector
from frostnet_tpu_torch.detection.nms import _greedy, detect
from frostnet_tpu_torch.detection.train import build_net
from frostnet_tpu_torch.nn import INT8, QAT
from frostnet_tpu_torch.quant import export_int8, from_jax_variables, load_int8, numpy_init
from frostnet_tpu_torch.quant.export import artifact_qconfig
from frostnet_tpu_torch.utils.cuda_graphs import Replay
from frostnet_tpu_torch.utils.profiling import session

SIZE = VOC_CFG["min_dim"]
SETTINGS = [dict(conf_thresh=0.25, top_k=50), dict(conf_thresh=0.01, top_k=200)]


def _images(seed, n=1):
    return torch.randn(n, SIZE, SIZE, 3, generator=torch.Generator().manual_seed(seed))


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):  # noqa: F811
    """``BASE`` of a ``qssd`` artifact: seeded weights, observers and BN
    statistics from a QAT forward in train mode (two images: torch's BN
    refuses train mode on the 1x1 source at one)."""
    return _make_artifact("qssd", tmp_path_factory.mktemp("det"))


def _make_artifact(net, where):
    threads = torch.get_num_threads()
    torch.set_num_threads(min(2, threads))
    feat, head = build_net(net, 21)
    from_jax_variables((feat, head), numpy_init((feat, head), 0))
    model = Detector(feat, head)
    with torch.no_grad():
        model(_images(10, n=2), mode=QAT, train=True)
    base = str(where / "det")
    export_int8(feat, base + "_feat")
    export_int8(head, base + "_head")
    torch.set_num_threads(threads)
    return base


@pytest.fixture(scope="module")
def pred(artifact):
    return serve.DetPredictor("qssd", artifact=artifact, device="cpu")


def _old_path(base, device=torch.device("cpu"), net="qssd", priors=None):
    """The frozen feature net and the float head run by hand, then
    ``detect`` on the softmax: the predictor's path before ``freeze``."""
    feat, head = build_net(net, 21, qconfig=artifact_qconfig(base + "_feat.npz"))
    from_jax_variables((feat, head), (load_int8(base + "_feat.npz"), load_int8(base + "_head.npz")))
    feat.to(device).eval()
    head.to(device).eval()
    feat.prepare_int8(device)
    priors = torch.as_tensor(make_priors(VOC_CFG)).to(device) if priors is None else priors

    @torch.inference_mode()
    def run(x, **kw):
        loc, conf = head(feat(x, mode=INT8))
        return (loc, conf), detect(loc, torch.softmax(conf, dim=-1), priors, **kw)

    return run


def test_freeze_path_equals_the_old_path(few_threads, artifact, pred):  # noqa: F811
    old = _old_path(artifact)
    x = _images(3)
    loc, conf = pred(x)
    for kw in SETTINGS:
        (loc_old, conf_old), dets_old = old(x, **kw)
        dets = pred.detect(x, **kw)
        assert torch.equal(loc, loc_old) and torch.equal(conf, conf_old)
        assert torch.equal(dets, dets_old)
        assert dets.shape == (1, 21, kw["top_k"], 5)
    assert bool((dets[:, 1:, :, 0] > 0).any())  # the evaluator's threshold keeps boxes
    assert pred.detect(x.numpy(), **SETTINGS[1]).equal(dets)


def test_replicas_detect_their_rows(few_threads, artifact, pred):  # noqa: F811
    """Each of two replicas detects its own row; the detections equal
    ``detect`` on the gathered logits (the former path). The float head's
    logits of one row may differ from a batch of two in the last bits (the
    CPU convolution picks its algorithm by batch), so the gathered logits are
    the replicas' own."""
    two = serve.DetPredictor("qssd", artifact=artifact, devices=["cpu", "cpu"])
    x = _images(4, n=2)
    loc, conf = two(x)
    for kw in SETTINGS:
        want = detect(loc, torch.softmax(conf, dim=-1), pred.priors, **kw)
        assert torch.equal(two.detect(x, **kw), want)
    rows = [pred(x[i:i + 1]) for i in range(2)]  # each replica's batch of one
    for k, t in enumerate((loc, conf)):
        assert torch.equal(t, torch.cat([r[k] for r in rows]))


def test_a_detect_request_records_its_spans(few_threads, pred):  # noqa: F811
    x = _images(5)
    pred.detect(x, **SETTINGS[1])
    with profile(activities=[ProfilerActivity.CPU]):
        pred.detect(x, **SETTINGS[1])
    recs = session()
    assert all(r.closed for r in recs)
    roots = [r for r in recs if r.parent == -1]
    assert [r.name for r in roots] == ["request"]
    root = roots[0].index
    assert {r.unit for r in recs} == {root}
    kids = [r for r in recs if r.parent == root]
    assert [r.name for r in kids] == ["request.input", "request.forward", "request.detect"]
    assert sum(r.host_ms for r in kids) >= 0.9 * roots[0].host_ms
    post = [r for r in recs if r.parent == kids[2].index]
    assert [r.name for r in post] == ["det.decode", "det.nms"]
    assert post[1].events is None and post[1].device_ms() is None  # no CUDA events on the CPU
    wrappers = {r.name for r in recs if r.parent == kids[1].index}
    assert wrappers == {"ops.int8_matmul", "ops.depthwise"}


def test_no_profiler_no_record(few_threads, pred, monkeypatch):  # noqa: F811

    def refuse(*args, **kwargs):
        raise AssertionError("a span recorded with no profiler running")

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    before = list(session())
    assert not torch.autograd.profiler._is_profiler_enabled
    dets = pred.detect(_images(6), **SETTINGS[0])
    assert session() == before and np.isfinite(dets.numpy()).all()


def test_replay_off_the_card_calls_its_function():
    calls = []

    def fn(x):
        calls.append(1)
        return x + 1

    step = Replay(fn)
    x = torch.zeros(3)
    with torch.inference_mode():
        assert [float(step(x)[0]) for _ in range(3)] == [1.0] * 3
    assert len(calls) == 3


@pytest.mark.cuda
def test_greedy_pass_replayed_bit_equal(cuda_device):  # noqa: F811
    """The greedy pass from its CUDA graph against the same ops issued one by
    one, on fresh candidates each call; an earlier replay's output stays as
    it was after the next replay."""
    step = Replay(_greedy)
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    outs = []
    with torch.inference_mode():
        for _ in range(4):
            cand = torch.rand((2, 3, 40, 40), generator=gen, device=cuda_device) > 0.7
            cand = torch.triu(cand, diagonal=1)
            got = step(cand)
            assert torch.equal(got, _greedy(cand))
            outs.append((got, _greedy(cand)))
    assert all(torch.equal(a, b) for a, b in outs)


@pytest.mark.cuda
def test_replayed_requests_bit_equal_to_the_old_path(cuda_device, artifact):  # noqa: F811
    """Four requests of two images on the card (a shape's first call runs
    eager, its second captures, the rest replay): logits and detections
    bit-equal to the
    frozen nets run by hand and ``detect`` issued op by op; a replayed
    request under the profiler records its spans, ``det.nms`` with its CUDA
    events."""
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    pred = serve.DetPredictor("qssd", artifact=artifact, device=cuda_device)
    old = _old_path(artifact, cuda_device)
    kw = SETTINGS[1]
    for seed in range(4):
        x = _images(20 + seed, n=2)
        dets = pred.detect(x, **kw)
        loc, conf = pred(x)
        (loc_old, conf_old), dets_old = old(x.to(cuda_device), **kw)
        assert torch.equal(loc, loc_old) and torch.equal(conf, conf_old)
        assert torch.equal(dets, dets_old)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        pred.detect(x, **kw)
    names = [r.name for r in session()]
    assert names[:3] == ["request", "request.input", "request.forward"]
    assert {"request.detect", "det.decode", "det.nms"} <= set(names)
    nms = [r for r in session() if r.name == "det.nms"][0]
    assert nms.device_ms() is not None and nms.device_ms() > 0


@pytest.mark.cuda
def test_tiny_dsod_served_bit_equal(cuda_device, tmp_path):
    """Tiny-DSOD on the card: its forward op by op (its upsampling copies
    index tables from the host), the greedy pass replayed; logits and
    detections bit-equal to the nets run by hand, request after request."""
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    base = _make_artifact("qtdsod", tmp_path)
    pred = serve.DetPredictor("qtdsod", artifact=base, device=cuda_device)
    old = _old_path(base, cuda_device, net="qtdsod", priors=pred.priors)
    for seed in range(3):
        x = _images(30 + seed, n=2)
        dets = pred.detect(x, **SETTINGS[0])
        (loc_old, conf_old), dets_old = old(x.to(cuda_device), **SETTINGS[0])
        loc, conf = pred(x)
        assert torch.equal(loc, loc_old) and torch.equal(conf, conf_old)
        assert torch.equal(dets, dets_old)
