"""The detector's plain reference against the port at 300x300 (the priors'
size; the extras need it) and batch 2 on the CPU, its tables against the
configuration, its per-row NMS against the port's masked form on hand-made
boxes, and the detection cell through the harness."""
import copy
import json
import math

import numpy as np
import pytest
import torch

from portbench.core import PACKAGE, Bench
from portbench.costs import conv_flops
from portbench.drivers import common
from portbench.drivers.serve_det import (counting_span_launches, det_checks, kept_rows,
                                         launches_by_span)
from portbench.drivers.serving import logit_gap
from portbench.reference import ssdlite_mobilenetv2 as ref
from portbench.tests import tiny

DET = json.loads((PACKAGE / "configs" / "ssdlite_mobilenetv2_voc.json").read_text())
CELL = "det-int8-serve-nms"
CPU = torch.device("cpu")
SIZE = DET["image_size"]


def _port_model():
    from frostnet_tpu_torch.detection.models import Detector
    from frostnet_tpu_torch.detection.train import build_net

    return Detector(*build_net(DET["model"], DET["arch"]["num_classes"]))


def test_names_shapes_and_count_match_the_port():
    model = _port_model()
    specs = ref.param_specs(DET["arch"])
    params = [n for n, _ in model.named_parameters()]
    assert params == [n for n, _, _ in specs][:len(params)]
    named = dict(list(model.named_parameters()) + list(model.named_buffers()))
    assert {n: tuple(t.shape) for n, t in named.items()} == {n: s for n, s, _ in specs}
    assert DET["parameters"] == sum(p.numel() for p in model.parameters()) == 4611740


def test_tables_priors_and_flops():
    from frostnet_tpu_torch.detection.anchors import VOC_CFG, make_priors

    tables = ref.shape_tables(DET["arch"], SIZE)
    assert tables == DET["tables"][f"{SIZE}x{SIZE}"]
    assert len(tables["matmuls"]) == 38  # the port's matmul launches a forward
    dw = [r for r in tables["convs"] if r[6] == r[3] > 1]
    assert len(dw) == 20 and sum(r[4] == 4 * r[3] for r in dw) == 3
    assert DET["forward_flops"][f"{SIZE}x{SIZE}"] == conv_flops(tables["convs"])
    priors = ref.make_priors(DET["arch"]["priors"])
    assert priors.shape == (DET["priors"], 4) and np.array_equal(priors, make_priors(VOC_CFG))
    assert DET["arch"]["priors"]["variance"] == VOC_CFG["variance"]
    from torch.utils.flop_counter import FlopCounterMode

    model = ref.SSDReference(DET["arch"], common.make_weights(ref.param_specs(DET["arch"]), 0, CPU))
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        model.forward_train(torch.zeros(1, SIZE, SIZE, 3), False)
    assert counter.get_total_flops() == DET["forward_flops"][f"{SIZE}x{SIZE}"]


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """The port's ``DetPredictor`` and the reference, from one set of seeded
    weights, each calibrated on the same two batches of two images."""
    from frostnet_tpu_torch import serve
    from frostnet_tpu_torch.nn import QAT
    from frostnet_tpu_torch.quant import export_int8

    weights = common.make_weights(ref.param_specs(DET["arch"]), 3, CPU)
    g = torch.Generator().manual_seed(1)
    calib = [torch.randn(2, SIZE, SIZE, 3, generator=g) for _ in range(2)]
    model = _port_model()
    common.load_weights(model, weights)
    with torch.no_grad():
        for x in calib:
            model(x, mode=QAT, train=True)
    base = str(tmp_path_factory.mktemp("det") / "det")
    export_int8(model.feat, base + "_feat.npz")
    export_int8(model.head, base + "_head.npz")
    pred = serve.DetPredictor(DET["model"], artifact=base, device="cpu")
    model_ref = ref.SSDReference(DET["arch"], weights)
    model_ref.calibrate(calib)
    model_ref.freeze()
    return pred, model_ref, torch.randn(2, SIZE, SIZE, 3, generator=g)


def test_int8_sources_match_the_port(pair):
    from frostnet_tpu_torch.nn import INT8

    pred, model_ref, x = pair
    with torch.inference_mode():
        sources = pred.feat(x, mode=INT8)
    want = model_ref.sources_int8(x)
    assert [tuple(s.shape[1:3]) for s in sources] == [(38, 38), (19, 19), (10, 10), (5, 5), (3, 3),
                                                       (1, 1)]
    for s, (q, g) in zip(sources, want):
        assert torch.equal(s, model_ref._dequant(q, g))


def test_head_logits_match_the_port(pair):
    """The same float32 convs and eval-mode BN on the same sources. The
    convolution library picks its algorithm, and so its order of summation,
    per call: a few float32 ulps of the largest logit are room for another
    choice; on this host the two come out equal."""
    pred, model_ref, x = pair
    for prog, want in zip(pred(x), model_ref.forward_int8(x)):
        assert prog.shape == want.shape
        torch.testing.assert_close(prog, want, rtol=0, atol=4 * 2 ** -23 * float(want.abs().max()))


def test_the_head_control_moves_the_head_alone(pair):
    """``head_tf32``: the trunk's sources as they were, the head's logits a
    TF32 rounding apart, well inside the logit limit of the cell."""
    _, model_ref, x = pair
    ctl = copy.copy(model_ref)
    ctl.head_tf32 = True
    for (q, g), (qc, gc) in zip(model_ref.sources_int8(x), ctl.sources_int8(x)):
        assert torch.equal(q, qc) and g == gc
    gaps = [logit_gap(c, r) for c, r in zip(ctl.forward_int8(x), model_ref.forward_int8(x))]
    assert all(1e-6 < g < 1e-2 for g in gaps), gaps


def test_detections_match_row_by_row(pair):
    pred, model_ref, x = pair
    tr = Bench().traffic(Bench().workload(CELL)["traffic"])
    dets = pred.detect(x, conf_thresh=tr["conf_thresh"], top_k=tr["top_k"])
    rows = model_ref.detect(*model_ref.forward_int8(x), tr["conf_thresh"], tr["nms_thresh"],
                            tr["top_k"])
    prog = kept_rows(dets)
    assert len(prog) == len(rows) == 2 * 20
    assert det_checks(prog, rows) == {"det_mismatch": 0.0, "det_gap": 0.0}
    assert all(np.array_equal(p, r) for p, r in zip(prog, rows))
    assert 0 < min(map(len, rows)) and max(map(len, rows)) <= tr["top_k"]


def _iou32(a, b):
    """The port's IoU of two boxes in float32 (``(area_a + area_b) - inter``)."""
    f = np.float32
    a, b = np.asarray(a, f), np.asarray(b, f)
    w = max(min(a[2], b[2]) - max(a[0], b[0]), f(0))
    h = max(min(a[3], b[3]) - max(a[1], b[1]), f(0))
    inter = w * h
    return inter / (((a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1])) - inter)


def _edge_boxes():
    """A box and two boxes beside it: the first at IoU float32's 0.45 (kept:
    the rule suppresses above it), the second at the next float32 above
    (suppressed). Found by stepping the right side one float32 at a time
    from where the IoU is 0.45, and the top by 2**-24."""
    a = [0.0, 0.0, 0.5, 0.5]
    edge, up = np.float32(0.45), np.nextafter(np.float32(0.45), np.float32(1))
    found = {}
    x2 = np.float32(0.4 / 0.45)  # the IoU is 0.4 / x2 at the top 0
    for step in range(-64, 65):
        for k in range(64):
            b = [0.1, k * 2.0 ** -24, float(x2 + np.float32(step) * np.spacing(x2)), 0.5]
            iou = _iou32(a, b)
            if iou in (edge, up):
                found.setdefault(float(iou), b)
    return a, found[float(edge)], found[float(up)]


def _port_keep(boxes, scores, top_k):
    from frostnet_tpu_torch.detection.nms import nms_fixed

    b, s, keep = nms_fixed(torch.as_tensor(boxes), torch.as_tensor(scores), 0.45, top_k)
    order = torch.sort(torch.as_tensor(scores), descending=True, stable=True).indices[:len(s)]
    return order[keep].numpy()


@pytest.mark.parametrize("case", ["at_the_edge", "one_ulp_above", "tied_scores", "top_k_among_ties"])
def test_per_row_nms_matches_the_port(case):
    a, at, above = _edge_boxes()
    far = [0.75, 0.75, 1.0, 1.0]
    boxes, scores, top_k = {
        "at_the_edge": ([a, at, far], [0.9, 0.8, 0.7], 3),
        "one_ulp_above": ([a, above, far], [0.9, 0.8, 0.7], 3),
        # equal scores: the lower index is taken first, and suppresses the other
        "tied_scores": ([above, far, a, at], [0.5, 0.6, 0.5, 0.5], 4),
        "top_k_among_ties": ([far, a, above, at, a], [0.5, 0.5, 0.5, 0.5, 0.4], 3),
    }[case]
    boxes, scores = np.asarray(boxes, np.float32), np.asarray(scores, np.float32)
    kept = ref.nms(boxes, scores, 0.45, top_k)
    assert np.array_equal(kept, _port_keep(boxes, scores, top_k))
    want = {"at_the_edge": [0, 1, 2], "one_ulp_above": [0, 2], "tied_scores": [1, 0],
            "top_k_among_ties": [0, 1]}[case]
    assert kept.tolist() == want


def test_launches_by_span():
    def x(cat, name, ts, dur, tid=1, **args):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "args": args}

    events = [x("cpu_op", "det.nms", 100, 50), x("cpu_op", "aten::add", 105, 5),
              x("cuda_runtime", "cudaLaunchKernel", 106, 1, correlation=1),
              x("cuda_runtime", "cudaLaunchKernel", 140, 1, correlation=2),
              x("cuda_runtime", "cudaLaunchKernel", 160, 1, correlation=3),
              x("cuda_runtime", "cudaLaunchKernel", 120, 1, tid=2, correlation=4),
              x("cuda_runtime", "cudaMemcpyAsync", 130, 1, correlation=5)]
    events += [x("kernel", f"k{c}", 300 + c, 1, tid=7, correlation=c) for c in (1, 2, 3, 4)]
    events.append(x("gpu_memcpy", "Memcpy HtoD", 310, 1, tid=7, correlation=5))
    assert launches_by_span(events) == {"det.nms": 2}
    assert launches_by_span(events, ("request",)) == {}


def _nms_trace():
    """One request's stretch: a ``det.nms`` span that launches two kernels,
    and one kernel launched outside it."""
    def x(cat, name, ts, dur, **args):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": 1, "args": args}

    return [x("user_annotation", "portbench.window", 0, 1000), x("cpu_op", "det.nms", 100, 50),
            x("cuda_runtime", "cudaLaunchKernel", 110, 1, correlation=1),
            x("cuda_runtime", "cudaLaunchKernel", 120, 1, correlation=2),
            x("cuda_runtime", "cudaLaunchKernel", 300, 1, correlation=3)] + \
        [x("kernel", f"k{c}", 400 + 10 * c, 5, correlation=c) for c in (1, 2, 3)]


def test_nms_launches_read_from_the_traced_summary():
    """``nms_launches.serve`` reads the launches that the driver keeps on
    the summary of ``trace.summarize``, the function ``traced_stretch``
    calls, while the run lasts, and nothing outside it."""
    from portbench import trace

    bench = Bench()
    cell = bench.cell(CELL, 1, 1.0, True, None, 0.0)
    read = bench.metric_reader("nms_launches.serve")
    with counting_span_launches():
        inside = trace.summarize(_nms_trace(), units=1)
    outside = trace.summarize(_nms_trace(), units=1)
    assert read(common.Measure(cell, inside, [0.004], 1, 0.01, 32)) == 2
    assert read(common.Measure(cell, outside, [0.004], 1, 0.01, 32)) is None


def test_the_traced_stretch_keeps_span_launches():
    """The harness's own traced stretch goes through the wrapped
    ``summarize``: on the CPU no kernel, so an empty count."""
    from frostnet_tpu_torch.utils.profiling import span
    from portbench import trace

    with counting_span_launches():
        with trace.traced_stretch(CPU) as box:
            with span("det.nms"):
                torch.ones(4).add_(1)
            box["units"] = 1
    assert box["summary"].span_launches == {}


def test_the_cell_parses():
    bench = Bench()
    cell = bench.cell(CELL, 2 ** 31 + 12345, 20.0, True, CPU, 0.0)
    assert cell.workload["chips"] == 1 and cell.config["family"] == "det"
    assert bench.driver(cell.traffic, cell.config).DRIVER.hooks.keeps_logits
    assert bench.reference(cell.config).Reference.__name__ == "SSDReference"
    e2e = {m["name"] for m in cell.e2e}
    assert e2e == {"serve_images_per_s", "serve_p95_ms", "setup_s"}
    per = {m["name"] for m in cell.per_layer}
    assert {"detect_host_ms.serve", "nms_ms.serve", "nms_launches.serve", "mfu.serve",
            "int8_matmul_roofline.serve"} <= per
    # silent or misread on a request replayed from CUDA graphs, and the depthwise
    # reader's table rows do not fit this trunk
    assert not per & {"depthwise_roofline.serve", "wrapper_host_ms.serve", "torch_ops_ms.serve"}
    assert set(cell.limits["limits"]) == {"logit_gap", "det_mismatch", "det_gap"}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A tiny copy of the benchmark whose detection cell serves 2 images a
    request at the configuration's own 300x300."""
    root = tiny.make_root(tmp_path_factory.mktemp("bench"))
    spec = json.loads((root.parent / "BENCHMARK.json").read_text())
    tr = json.loads((PACKAGE / "traffic" / "voc_det_int8_b32_300.json").read_text())
    tr.update(tiny.SMALL["serve"], batch=2, pool=2, calibration_batches=2, calibration_batch=2,
              checked_requests=2, checked_logits=2)
    (root / "traffic" / "tiny_det.json").write_text(json.dumps(tr))
    for w in spec["workloads"]:
        if w["name"] == CELL:
            w.update(config="ssdlite_mobilenetv2_voc", traffic="tiny_det")
    (root.parent / "BENCHMARK.json").write_text(json.dumps(spec))
    return root


def test_a_traced_run_is_correct(root):
    line = tiny.run(root, CELL, trace=True)
    assert line["correct"] is True, line["checks"]
    assert {k: v["value"] for k, v in line["checks"].items()} == \
        {"logit_gap": 0.0, "det_mismatch": 0.0, "det_gap": 0.0}
    host = line["metrics"]["detect_host_ms.serve"]["value"]
    assert math.isfinite(host) and host > 0
    assert "nms_ms.serve" not in line["metrics"]  # CUDA events: none on the CPU
    assert "nms_launches.serve" not in line["metrics"]  # no kernel on the CPU


def test_an_altered_answer_is_not_correct(root, monkeypatch):
    from frostnet_tpu_torch import serve

    detect = serve.DetPredictor._detect

    def altered(self, out, **kw):
        dets = detect(self, out, **kw).clone()
        dets[0, 1:, 0] = dets[0, 1:, 0].flip(-1)
        return dets

    monkeypatch.setattr(serve.DetPredictor, "_detect", altered)
    line = tiny.run(root, CELL)
    assert line["correct"] is False, line["checks"]


def test_a_program_without_the_step_is_refused(root, monkeypatch):
    from frostnet_tpu_torch import serve

    monkeypatch.delattr(serve.DetPredictor, "_detect")
    with pytest.raises(RuntimeError, match="no _detect step"):
        tiny.run(root, CELL)
