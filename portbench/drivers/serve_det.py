"""Serving traffic on a detector of the port's detection package:
``serve.DetPredictor.detect`` at the traffic's ``conf_thresh`` and
``top_k`` (the frozen INT8 feature net and the float head through
``quant/freeze.py::freeze``, then the softmax and ``detection/nms.py::detect``
inside the same request; the server suppresses at IoU 0.45, the traffic's
``nms_thresh``). The response is the ``(B, C, top_k, 5)`` detections copied
to the host, page-locked where the traffic's batches are.
``drivers/serving.py`` has the rest; what differs here:

* set-up calibrates with QAT forwards of ``detection.models.Detector`` in
  train mode (the observers and every BN's statistics, the float head's
  too) and writes the artifact as the detection evaluator does, two files
  (``BASE_feat.npz``, ``BASE_head.npz``);
* the served object keeps a reference to each request's ``(loc, conf)``
  (``DetPredictor._detect``, the request's post-processing step, sees
  them), so that the logits of the sampled requests stay on the card
  through the window as the segmenter's do. This hooks a private method
  of the program: a change that renames ``serve.DetPredictor._detect``,
  changes its arguments or fuses it into another step has to change
  :meth:`DetHooks.served_class` with it. A program without that step
  cannot run the cell: this module refuses it before set-up;
* ``correct`` compares ``logit_gap`` (loc and conf of the sampled requests)
  and, over every (image, class) row of the sampled responses,
  ``det_mismatch`` (the share of rows whose count of kept detections
  differs from the reference's) and ``det_gap`` (the worst gap of a kept
  score or box coordinate over the rows whose counts agree; NaN where none
  do). The program's rows are compacted to their kept entries (score above
  0) in order; the reference's NMS runs for the sampled responses only;
* the kernels launched inside ``det.nms`` are counted from each traced
  stretch's events by wrapping ``portbench.trace.summarize`` for the run
  (:func:`counting_span_launches`), until the trace's summary counts each
  span's launches for every cell;
* the control tool reads two controls: the 4-bit grids of the trunk and
  the float head's convs in TF32 (the reference's ``head_tf32``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import shutil
import tempfile
from collections import defaultdict
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from portbench.core import Bench, subseed
from portbench.drivers import common
from portbench.drivers.serving import Hooks, Serving, logit_gap

SPANS = ("det.nms",)  # the spans whose kernels the traced run counts


@dataclasses.dataclass
class Served:
    """What one request gives the harness: its detections and the logits
    behind them, on one device."""

    dets: torch.Tensor
    loc: torch.Tensor
    conf: torch.Tensor

    def cpu(self) -> "Served":
        return Served(self.dets.cpu(), self.loc.cpu(), self.conf.cpu())


class RefServed:
    """The reference's output for one request batch: its logits on the host
    and, worked out when first read, its kept rows."""

    def __init__(self, ref, loc: torch.Tensor, conf: torch.Tensor, traffic: dict):
        self.loc, self.conf = loc.cpu(), conf.cpu()
        self._args = (ref, loc, conf, traffic)
        self._rows: Optional[List[np.ndarray]] = None

    @property
    def dets(self) -> List[np.ndarray]:
        if self._rows is None:
            ref, loc, conf, tr = self._args
            self._rows = ref.detect(loc, conf, tr["conf_thresh"], tr["nms_thresh"], tr["top_k"])
            self._args = None
        return self._rows


def kept_rows(dets) -> List[np.ndarray]:
    """(B, C, K, 5) detections -> each image's classes 1..C-1 in turn: the
    row's kept entries (score above 0), in order; rows pass as they are."""
    if not isinstance(dets, torch.Tensor):
        return dets
    d = dets.numpy()
    return [d[b, c][d[b, c, :, 0] > 0] for b in range(d.shape[0]) for c in range(1, d.shape[1])]


def det_checks(prog: List[np.ndarray], ref: List[np.ndarray]) -> Dict[str, float]:
    """``det_mismatch`` and ``det_gap`` of two lists of kept rows."""
    agree = [(p, r) for p, r in zip(prog, ref) if len(p) == len(r)]
    gaps = [float(np.abs(p.astype(np.float64) - r).max()) for p, r in agree if len(p)]
    return {"det_mismatch": 1.0 - len(agree) / len(ref),
            "det_gap": (max(gaps) if gaps else 0.0) if agree else float("nan")}


def launches_by_span(events: List[dict], names=SPANS) -> Dict[str, int]:
    """Kernels launched inside each span of ``names``, from the events of a
    Chrome trace: a kernel whose launch call (the ``cuda_runtime`` or
    ``cuda_driver`` event of its ``correlation``) starts inside a ``cpu_op``
    event of the span's name on the same thread."""
    spans = defaultdict(list)
    launches = {}
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, args = e.get("cat"), e.get("args") or {}
        if cat == "cpu_op" and e.get("name") in names:
            spans[e.get("tid")].append((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                                        e["name"]))
        elif cat in ("cuda_runtime", "cuda_driver") and "correlation" in args:
            launches[args["correlation"]] = (e.get("tid"), float(e["ts"]))
    out: Dict[str, int] = defaultdict(int)
    for e in events:
        corr = (e.get("args") or {}).get("correlation")
        if e.get("ph") != "X" or e.get("cat") != "kernel" or corr not in launches:
            continue
        tid, ts = launches[corr]
        for a, b, name in spans.get(tid, ()):
            if a <= ts <= b:
                out[name] += 1
    return dict(out)


@contextlib.contextmanager
def counting_span_launches():
    """While the block runs, each traced stretch's summary also holds
    ``span_launches`` (:func:`launches_by_span` of its trace), which
    ``metrics/nms_launches.serve.py`` reads: ``trace.summarize`` is wrapped
    for the block's length."""
    from portbench import trace

    summarize = trace.summarize

    def with_launches(events, units):
        summary = summarize(events, units)
        summary.span_launches = launches_by_span(events)
        return summary

    trace.summarize = with_launches
    try:
        yield
    finally:
        trace.summarize = summarize


class DetHooks(Hooks):
    keeps_logits = True

    def model(self, cell):
        from frostnet_tpu_torch.detection.models import Detector
        from frostnet_tpu_torch.detection.train import build_net

        return Detector(*build_net(cell.config["model"], cell.config["arch"]["num_classes"]))

    @staticmethod
    def served_class():
        """``DetPredictor`` keeping each request's ``(loc, conf)``; raises
        where the program has no post-processing step to watch."""
        from frostnet_tpu_torch.serve import DetPredictor

        if not hasattr(DetPredictor, "_detect"):
            raise RuntimeError("serve.DetPredictor has no _detect step: this program cannot "
                               "hand the harness the logits behind its detections")

        class Kept(DetPredictor):
            kept = None

            def _detect(self, out, **kw):
                self.kept = out
                return super()._detect(out, **kw)

        return Kept

    def predictor(self, cell, base: str):
        cfg, tr = cell.config, cell.traffic
        self.pinned = tr["host_memory"] == "pinned"
        pred = self.served_class()(cfg["model"], artifact=base,
                                   num_classes=cfg["arch"]["num_classes"],
                                   dataset=cfg["dataset"], device=cell.device)

        def serve(images) -> Served:
            dets = pred.detect(images, conf_thresh=tr["conf_thresh"], top_k=tr["top_k"])
            return Served(dets, *pred.kept)

        return serve

    pinned = False  # page-locked responses: set from the traffic by :meth:`predictor`

    def respond(self, out):
        """The detections on the host, in page-locked memory where the
        traffic's batches are page-locked (torch's caching host allocator
        keeps the blocks; the copy runs at the link's rate, with no staging
        through the host's own copies)."""
        dets = out.dets
        if not isinstance(dets, torch.Tensor):
            return dets
        if self.pinned and dets.is_cuda:
            return torch.empty(dets.shape, dtype=dets.dtype, pin_memory=True).copy_(dets)
        return dets.cpu()

    def checks(self, responses, logits, ref: Dict[int, Any]) -> Dict[str, float]:
        gaps = [logit_gap(getattr(out, part), getattr(ref[k], part))
                for _, k, out in logits for part in ("loc", "conf")]
        prog, want = [], []
        for _, k, dets in responses:
            prog += kept_rows(dets)
            want += ref[k].dets
        return {"logit_gap": max(gaps), **det_checks(prog, want)}


class DetServing(Serving):
    """The serving cell of the detection family."""

    CONTROLS = {"control_int4": lambda m: dict(act=m.ACT4, weight=m.WEIGHT4),
                "control_tf32_head": lambda m: dict(head_tf32=True)}

    def run(self, cell):
        self.hooks.served_class()  # refuse a program that cannot run the cell before set-up
        with counting_span_launches():
            return super().run(cell)

    def readings(self, cell, with_control: bool) -> dict:
        """``Serving.readings`` with both controls of :attr:`CONTROLS` in the
        program's place where ``with_control``."""
        ref_mod = Bench(cell.root).reference(cell.config)
        weights = common.make_weights(ref_mod.param_specs(cell.config["arch"]),
                                      subseed(cell.seed, "weights"), cell.device)
        calib, requests = self.pools(cell)
        pred = self.build_program(cell, weights, calib)
        outs = [pred(x) for x in requests]
        responses = [(k, k, self.hooks.respond(o)) for k, o in enumerate(outs)]
        logits = [(k, k, o.cpu()) for k, o in enumerate(outs)]
        del pred, outs
        batches = dict(enumerate(requests))
        ref = self.reference_logits(cell, ref_mod, weights, calib, batches)
        out = {"program": self.hooks.checks(responses, logits, ref)}
        for name, variant in self.CONTROLS.items() if with_control else ():
            low = self.reference_logits(cell, ref_mod, weights, calib, batches, **variant(ref_mod))
            out[name] = self.hooks.checks([(k, k, self.hooks.respond(o)) for k, o in low.items()],
                                          [(k, k, o) for k, o in low.items()], ref)
        return out

    def build_program(self, cell, weights, calib):
        from frostnet_tpu_torch.nn import QAT
        from frostnet_tpu_torch.quant import export_int8

        model = self.hooks.model(cell)
        model.to(cell.device)
        common.load_weights(model, weights)
        with torch.no_grad():
            for x in calib:
                model(x, mode=QAT, train=True)
        tmp = tempfile.mkdtemp(prefix="portbench_det_")
        try:
            base = os.path.join(tmp, "det")
            export_int8(model.feat, base + "_feat.npz")
            export_int8(model.head, base + "_head.npz")
            del model
            return self.hooks.predictor(cell, base)
        finally:
            shutil.rmtree(tmp)

    def reference_logits(self, cell, ref_mod, weights, calib, batches, **variant):
        ref = ref_mod.Reference(cell.config["arch"], weights, **variant)
        with ref_mod.no_tf32():
            ref.calibrate(list(calib), subseed(cell.seed, "calibration"))
            ref.freeze()
            return {k: RefServed(ref, *ref.forward_int8(x.to(cell.device)), cell.traffic)
                    for k, x in batches.items()}


DRIVER = DetServing(DetHooks())
run = DRIVER.run
