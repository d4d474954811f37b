"""Serving traffic: what every serving cell shares.

Set-up makes the port's model from the benchmark's seeded weights,
calibrates it on seeded images (``train.state.recalibrate``: QAT forwards
in train mode), writes its INT8 artifact (``quant.export_int8``) under
``TMPDIR`` and serves it with the family's predictor of ``serve.py``. One
client sends a request, waits for the response on the host, and sends the
next: a closed loop over a pool of pageable host batches of float32 images,
as ``serve.main`` hands them. Latency is the time from the batch handed to
the predictor to the response on the host. A family's :class:`Hooks` say
what the predictor is, what a response is, and how it is judged.

``correct``: samples of the window's requests, drawn from the seed
(reservoir sampling over every request), are compared with the plain
reference's output for the same images, worked out from the same weights
and calibration images once the window has closed and the predictor is
freed.
"""
from __future__ import annotations

import os
import random
import tempfile
import time
from typing import Dict, List

import torch

from portbench.core import Bench, Cell, Outcome, subseed
from portbench.drivers import common, training


def logit_gap(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """The worst gap of a logit, over the largest reference logit."""
    scale = float(ref.abs().max())
    d = (prog.to(torch.float64) - ref.to(torch.float64)).abs().max()
    return common.gap(float(d), 0.0, scale) if torch.isfinite(prog).all() else float("nan")


class Hooks:
    """A classifier: the model the trainer builds, ``serve.Int8Predictor``;
    the response is the logits on the host, compared whole (``logit_gap``)."""

    model = training.Hooks.model

    def predictor(self, cell: Cell, artifact: str):
        from frostnet_tpu_torch.serve import Int8Predictor

        cfg = cell.config
        return Int8Predictor(cfg["model"], num_classes=cfg["arch"]["num_classes"],
                             artifact=artifact, image_size=common.geometry(cell)[0],
                             fuse_int8=cell.traffic["fuse_int8"], device=cell.device)

    def respond(self, out: torch.Tensor) -> torch.Tensor:
        return out.cpu()

    keeps_logits = False

    def checks(self, responses, logits, ref: Dict[int, torch.Tensor]) -> Dict[str, float]:
        """The compared numbers from the kept (request, pool index, response)
        and (request, pool index, logits) samples."""
        return {"logit_gap": max(logit_gap(out, ref[k]) for _, k, out in responses)}


class Serving:
    """The serving cell of one family (its :class:`Hooks`)."""

    def __init__(self, hooks: Hooks):
        self.hooks = hooks

    def pools(self, cell: Cell):
        """(calibration batches on the device, request batches on the host, in
        page-locked memory where the traffic's ``host_memory`` says
        ``pinned``)."""
        tr, dev = cell.traffic, cell.device
        gen = torch.Generator(device=dev)
        gen.manual_seed(subseed(cell.seed, "data"))
        h, w = common.geometry(cell)
        calib = torch.randn((tr["calibration_batches"], tr["calibration_batch"], h, w, 3),
                            generator=gen, device=dev)
        requests = [torch.randn((tr["batch"], h, w, 3), generator=gen, device=dev).cpu()
                    for _ in range(tr["pool"])]
        if tr["host_memory"] == "pinned" and dev.type == "cuda":
            requests = [r.pin_memory() for r in requests]
        return calib, requests

    def reference_logits(self, cell: Cell, ref_mod, weights, calib, batches: Dict[int, torch.Tensor],
                         **variant) -> Dict[int, torch.Tensor]:
        """The reference's output for each request batch: calibration, freeze
        and the integer forward (``variant`` picks a lower precision for the
        control)."""
        ref = ref_mod.Reference(cell.config["arch"], weights, **variant)
        with ref_mod.no_tf32():
            ref.calibrate(list(calib), subseed(cell.seed, "calibration"))
            ref.freeze()
            return {k: ref.forward_int8(x.to(cell.device)).cpu() for k, x in batches.items()}

    def build_program(self, cell: Cell, weights, calib):
        """The port's predictor over an artifact made from ``weights``."""
        from frostnet_tpu_torch.quant import export_int8
        from frostnet_tpu_torch.train.state import TrainState, recalibrate

        dev = cell.device
        model = self.hooks.model(cell)
        model.to(dev)
        common.load_weights(model, weights)
        state = TrainState(model=model, optimizer=None, generator=torch.Generator(device=dev))
        recalibrate(state, [{"image": x} for x in calib], seed=subseed(cell.seed, "calibration"))
        fd, path = tempfile.mkstemp(suffix=".npz", prefix="portbench_int8_")
        os.close(fd)
        try:
            export_int8(model, path)
            del state, model
            return self.hooks.predictor(cell, path)
        finally:
            os.unlink(path)

    def run(self, cell: Cell) -> Outcome:
        tr, dev, hooks = cell.traffic, cell.device, self.hooks
        phases = common.Phases(cell.started)
        ref_mod = Bench(cell.root).reference(cell.config)
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        torch.empty(1, device=dev)  # the CUDA context
        phases.mark("import_and_context")
        weights = common.make_weights(ref_mod.param_specs(cell.config["arch"]),
                                      subseed(cell.seed, "weights"), dev)
        calib, requests = self.pools(cell)
        phases.mark("weights_and_inputs")
        pred = self.build_program(cell, weights, calib)
        phases.mark("calibration_export_freeze")
        for k in range(tr["warmup_requests"]):
            hooks.respond(pred(requests[k % len(requests)]))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        setup_s = phases.mark("warmup") - cell.started

        rng = random.Random(subseed(cell.seed, "sample"))
        responses: List[tuple] = []  # (request, pool index, response on the host)
        logits: List[tuple] = []     # (request, pool index, logits on the device)

        def reservoir(kept, size, n, item):
            if len(kept) < size:
                kept.append(item)
            else:
                j = rng.randrange(n + 1)
                if j < size:
                    kept[j] = item

        def call(n):
            k = n % len(requests)
            t = time.perf_counter()
            out = pred(requests[k])
            host = time.perf_counter() - t
            resp = hooks.respond(out)
            latency = time.perf_counter() - t
            reservoir(responses, tr["checked_requests"], n, (n, k, resp))
            if hooks.keeps_logits:
                reservoir(logits, tr["checked_logits"], n, (n, k, out))
            return host, latency

        win = common.run_window(call, cell.seconds, cell.trace, dev, tr["trace_requests"])
        device = common.device_info(dev, win.summary)
        del pred
        logits = [(n, k, out.cpu()) for n, k, out in logits]
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        phases.mark("window")
        used = sorted({k for _, k, _ in responses} | {k for _, k, _ in logits})
        ref = self.reference_logits(cell, ref_mod, weights, calib, {k: requests[k] for k in used})
        phases.mark("reference")
        checks = {k: common.check(k, v, cell.limits)
                  for k, v in hooks.checks(responses, logits, ref).items()}
        if cell.trace:
            m = common.Measure(cell, win.summary, win.host_s, win.units, win.seconds, tr["batch"])
            metrics = common.per_layer(cell, m)
        else:
            lat_ms = [x * 1e3 for x in win.latency_s]
            metrics = {"serve_images_per_s": win.units * tr["batch"] / win.seconds,
                       "serve_p95_ms": common.quantile95(lat_ms), "setup_s": setup_s}
        return Outcome(checks=checks, metrics=metrics, attempted=win.units, failed=0,
                       device=device, breakdown=win.summary.breakdown if win.summary else None,
                       phases=phases.parts)

    def readings(self, cell: Cell, with_control: bool) -> dict:
        """The control tool's readings at the cell's size, no window: every
        pool batch served once against the reference, and with
        ``with_control`` the 4-bit control in the program's place."""
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
        if with_control:
            low = self.reference_logits(cell, ref_mod, weights, calib, batches,
                                        act=ref_mod.ACT4, weight=ref_mod.WEIGHT4)
            ctl_resp = [(k, k, self.hooks.respond(o)) for k, o in low.items()]
            ctl_logits = [(k, k, o) for k, o in low.items()]
            out["control_int4"] = self.hooks.checks(ctl_resp, ctl_logits, ref)
        return out
