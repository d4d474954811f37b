"""Training traffic: what every training cell shares.

The timed call is the family's train step of the port (``make_train_step``
or ``make_seg_train_step``, as the family's trainer builds it) on a
``TrainState`` whose model holds the benchmark's seeded weights and whose
optimizer is QSGD with GradBoost and ``grouped_weight_decay``. Set-up runs
the traffic's StatAssist FP32 steps, ``start_qat()``, the three QAT steps
that are checked (through the window's own call and feed) and the warm-up
steps; the window then calls the same step on the same object, cycling
through a pool of seeded uint8 batches on the device. A family's
:class:`Hooks` say how its model, step, batches, reference and loss are
made.

``correct``. A QAT step at random initialization is chaotic: two float sum
orders (cuDNN's weight gradients are not deterministic) move a later QAT
step's loss by a few tenths of a percent and a leaf's gradient by tens of
percent, as far as a lower precision does. So the reference follows the
program step by step (the instructions' provision for it):

* the FP32 stage from the seed alone: the reference runs the same FP32 steps
  from the same weights on the same batches; compared are the steps'
  losses and each leaf's change over the stage (``fp32_loss_gap``,
  ``fp32_change_gap``);
* each of the three QAT steps from the program's state before it (its
  parameters, BN statistics, observers and optimizer state; the dropout
  masks and GradBoost's noise the reference draws itself, from the seed, in
  the program's order): compared are the step's loss (``loss_gap``), each
  leaf's gradient as the optimizer got it (``grad_gap``) and each leaf's
  change (``change_gap``), the worst over the three steps.

A leaf's gap is the gap between the two norms over the larger of the
reference's norm of that leaf and of the median leaf; a change leaves out
the leaves whose reference gradient is under a thousandth of the median
leaf's (round-off moves them).
"""
from __future__ import annotations

import statistics
import time
from typing import Dict, List

import torch
import torch.nn.functional as F

from portbench.core import Bench, Cell, Outcome, subseed
from portbench.drivers import common


def _norms(ts) -> List[float]:
    return torch.stack([torch.linalg.vector_norm(t.detach().to(torch.float64))
                        for t in ts]).tolist()


def leaf_gap(prog: List[float], ref: List[float], keep=None) -> float:
    """The worst leaf's gap between two norms, over the larger of the
    reference's norm of that leaf and of the median leaf."""
    idx = list(range(len(ref))) if keep is None else keep
    med = statistics.median(ref[i] for i in idx)
    return max(common.gap(prog[i], ref[i], max(ref[i], med)) for i in idx)


def training_gaps(prog: dict, ref: dict) -> Dict[str, float]:
    """The five compared numbers of a training cell (module docstring)."""
    def losses(a, b):
        return max(common.gap(p, r, abs(r)) for p, r in zip(a, b))

    out = {"fp32_loss_gap": losses(prog["fp_losses"], ref["fp_losses"]),
           "fp32_change_gap": leaf_gap(prog["fp_change"], ref["fp_change"]),
           "loss_gap": losses(prog["losses"], ref["losses"])}
    grad, change = [], []
    for pg, rg, pc, rc in zip(prog["grad"], ref["grad"], prog["change"], ref["change"]):
        grad.append(leaf_gap(pg, rg))
        med = statistics.median(rg)
        change.append(leaf_gap(pc, rc, [i for i, r in enumerate(rg) if r >= 1e-3 * med]))
    out.update(grad_gap=max(grad), change_gap=max(change))
    return out


class Hooks:
    """A classifier of the port's model registry (``train/state.py``'s step,
    cross-entropy on uniform labels, dropout before the classifier)."""

    def model(self, cell: Cell):
        from frostnet_tpu_torch.models import create_model

        arch = cell.config["arch"]
        return create_model(cell.config["model"], num_classes=arch["num_classes"],
                            drop_rate=arch["drop_rate"])

    def steps(self, cell: Cell):
        """(FP32 step, QAT step) of the port."""
        from frostnet_tpu_torch.nn.mode import FP32, QAT
        from frostnet_tpu_torch.train.state import make_train_step

        n = cell.config["arch"]["num_classes"]
        return make_train_step(FP32, num_classes=n), make_train_step(QAT, num_classes=n)

    def labels(self, cell: Cell, gen: torch.Generator, shape) -> torch.Tensor:
        return torch.randint(0, cell.config["arch"]["num_classes"], shape[:2], generator=gen,
                             device=cell.device)

    def loss(self, cell: Cell, logits, labels) -> torch.Tensor:
        return F.cross_entropy(logits, labels)


class Training:
    """The training cell of one family (its :class:`Hooks`)."""

    def __init__(self, hooks: Hooks):
        self.hooks = hooks

    def pools(self, cell: Cell):
        """The traffic's pool of uint8 image batches and their labels, on the
        device."""
        tr, dev = cell.traffic, cell.device
        gen = torch.Generator(device=dev)
        gen.manual_seed(subseed(cell.seed, "data"))
        h, w = common.geometry(cell)
        shape = (tr["pool"], tr["batch"], h, w, 3)
        images = torch.randint(0, 256, shape, generator=gen, device=dev, dtype=torch.uint8)
        return images, self.hooks.labels(cell, gen, shape)

    def _ref_optimizer(self, cell: Cell, ref_mod, params):
        o = cell.traffic["optimizer"]
        return ref_mod.QSGDReference(params, o["lr"], o["weight_decay"], momentum=o["momentum"],
                                     clip_by=o["clip_by"], noise_decay=o["noise_decay"],
                                     noise_seed=subseed(cell.seed, "noise"))

    def _ref_step(self, cell, ref, opt, image, label, qat, gen, ref_mod, half=False) -> float:
        """One step of the reference (``half``: the loss over the first half
        of the batch alone, a fault's reading); returns its loss."""
        logits = ref.forward_train(ref_mod.prep_image(image), qat, gen)
        rows = logits.shape[0] // 2 if half else logits.shape[0]
        loss = self.hooks.loss(cell, logits[:rows], label[:rows])
        for p in ref.params:
            p.grad = None
        loss.backward()
        opt.step()
        return float(loss.detach())

    def _fp32_stage(self, cell, ref_mod, weights, images, labels, gen, half=False, **variant):
        """The reference's FP32 steps from the seeded weights: (model,
        optimizer, losses, each leaf's change)."""
        ref = ref_mod.Reference(cell.config["arch"], weights, **variant)
        opt = self._ref_optimizer(cell, ref_mod, ref.params)
        losses = [self._ref_step(cell, ref, opt, images[j], labels[j], False, gen, ref_mod, half)
                  for j in range(cell.traffic["fp32_steps"])]
        change = _norms([p - weights[n] for n, p in zip(ref.param_names, ref.params)])
        return ref, opt, losses, change

    def _qat_step(self, cell, ref_mod, images, labels, gen, k: int, ref, opt, half=False):
        """QAT step ``k`` of the reference: (loss, gradient norms, change
        norms)."""
        j = cell.traffic["fp32_steps"] + k
        before = [p.detach().clone() for p in ref.params]
        loss = self._ref_step(cell, ref, opt, images[j], labels[j], True, gen, ref_mod, half)
        return loss, _norms([p.grad for p in ref.params]), _norms(
            [p - b for p, b in zip(ref.params, before)])

    def reference_as_program(self, cell, ref_mod, weights, images, labels, half_batch=False,
                             **variant) -> dict:
        """The reference in the program's place (the control: ``tf32=True``;
        a fault: ``half_batch=True``), read as the program is: its own chain
        of FP32 and QAT steps, and its state before each QAT step."""
        gen = torch.Generator(device=cell.device)
        gen.manual_seed(subseed(cell.seed, "dropout"))
        with ref_mod.no_tf32():
            ref, opt, fp_losses, fp_change = self._fp32_stage(cell, ref_mod, weights, images,
                                                              labels, gen, half_batch, **variant)
            opt.is_warmup = False
            out = {"fp_losses": fp_losses, "fp_change": fp_change, "snapshots": [],
                   "losses": [], "grad": [], "change": []}
            for k in range(3):
                out["snapshots"].append({"weights": {n: t.detach().clone()
                                                     for n, t in ref.state.items()},
                                         "opt": opt.state()})
                loss, grad, change = self._qat_step(cell, ref_mod, images, labels, gen, k, ref,
                                                    opt, half_batch)
                out["losses"].append(loss)
                out["grad"].append(grad)
                out["change"].append(change)
        return out

    def follow(self, cell, ref_mod, weights, images, labels, prog: dict) -> dict:
        """The plain reference's readings: the FP32 stage from the seed, then
        each QAT step from ``prog``'s state before it."""
        gen = torch.Generator(device=cell.device)
        gen.manual_seed(subseed(cell.seed, "dropout"))
        noise = None
        with ref_mod.no_tf32():
            _, _, fp_losses, fp_change = self._fp32_stage(cell, ref_mod, weights, images, labels,
                                                          gen)
            out = {"fp_losses": fp_losses, "fp_change": fp_change, "losses": [], "grad": [],
                   "change": []}
            for k, snap in enumerate(prog["snapshots"]):
                ref = ref_mod.Reference(cell.config["arch"], snap["weights"])
                opt = self._ref_optimizer(cell, ref_mod, ref.params)
                opt.load(snap["opt"])
                opt.is_warmup, opt.generator = False, noise
                loss, grad, change = self._qat_step(cell, ref_mod, images, labels, gen, k, ref, opt)
                noise = opt.generator
                out["losses"].append(loss)
                out["grad"].append(grad)
                out["change"].append(change)
        return out

    def build_program(self, cell: Cell, weights):
        """(state, FP32 step, QAT step) of the port, on the benchmark's
        weights."""
        from frostnet_tpu_torch.optim import get_optimizer, grouped_weight_decay
        from frostnet_tpu_torch.train.state import TrainState

        dev, o = cell.device, cell.traffic["optimizer"]
        model = self.hooks.model(cell)
        model.to(dev)
        common.load_weights(model, weights)
        tx = get_optimizer(o["name"], o["lr"], momentum=o["momentum"],
                           weight_decay=grouped_weight_decay(o["weight_decay"]),
                           clip_by=o["clip_by"], toss_coin=True, noise_decay=o["noise_decay"],
                           seed=subseed(cell.seed, "noise"))
        gen = torch.Generator(device=dev)
        gen.manual_seed(subseed(cell.seed, "dropout"))
        state = TrainState(model=model, optimizer=tx(model.parameters()), generator=gen)
        return (state, *self.hooks.steps(cell))

    @staticmethod
    def _snapshot(state) -> dict:
        opt = state.optimizer
        st, group = opt.state.get("group0", {}), opt.param_groups[0]
        named = list(state.model.named_parameters()) + list(state.model.named_buffers())
        bufs = {k: st[k].clone() if k in st else None
                for k in ("momentum_buffer", "exp_min", "exp_max")}
        return {"weights": {n: t.detach().clone() for n, t in named},
                "opt": {**bufs, "gb_step": group["gb_step"], "restart_step": group["restart_step"]}}

    def checked_steps(self, cell: Cell, weights, images, labels):
        """The program's set-up up to the window: the FP32 steps,
        ``start_qat()``, the three checked QAT steps (the state before each,
        its loss, gradient and change, read before the next step runs), the
        warm-up steps. Returns (state, QAT step, readings, the next batch
        index)."""
        tr = cell.traffic
        state, fp_step, qat_step = self.build_program(cell, weights)
        params = list(state.model.parameters())
        names = [n for n, _ in state.model.named_parameters()]
        n_pool = images.shape[0]

        def feed(i):
            return {"image": images[i % n_pool], "label": labels[i % n_pool]}

        fp_losses = [fp_step(state, feed(i))["loss"].detach().clone()
                     for i in range(tr["fp32_steps"])]
        i = tr["fp32_steps"]
        state.start_qat()
        prog = {"fp_losses": [float(v) for v in fp_losses],
                "fp_change": _norms([p - weights[n] for n, p in zip(names, params)]),
                "snapshots": [], "losses": [], "grad": [], "change": []}
        for _ in range(3):
            prog["snapshots"].append(self._snapshot(state))
            before = [p.detach().clone() for p in params]
            prog["losses"].append(float(qat_step(state, feed(i))["loss"]))
            i += 1
            prog["grad"].append(_norms([p.grad for p in params]))
            prog["change"].append(_norms([p - b for p, b in zip(params, before)]))
            del before
        for _ in range(tr["warmup_steps"]):
            qat_step(state, feed(i))
            i += 1
        return state, qat_step, prog, i

    def run(self, cell: Cell) -> Outcome:
        tr, dev = cell.traffic, cell.device
        phases = common.Phases(cell.started)
        ref_mod = Bench(cell.root).reference(cell.config)
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        torch.empty(1, device=dev)  # the CUDA context
        phases.mark("import_and_context")
        weights = common.make_weights(ref_mod.param_specs(cell.config["arch"]),
                                      subseed(cell.seed, "weights"), dev)
        images, labels = self.pools(cell)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        phases.mark("weights_and_inputs")
        state, qat_step, prog, i = self.checked_steps(cell, weights, images, labels)
        n_pool = images.shape[0]
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        setup_s = phases.mark("checked_and_warmup_steps") - cell.started

        def call(n):
            j = (i + n) % n_pool
            t = time.perf_counter()
            qat_step(state, {"image": images[j], "label": labels[j]})
            return time.perf_counter() - t, None

        win = common.run_window(call, cell.seconds, cell.trace, dev, tr["trace_steps"])
        device = common.device_info(dev, win.summary)
        del state, qat_step
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        phases.mark("window")
        ref = self.follow(cell, ref_mod, weights, images, labels, prog)
        phases.mark("reference")
        checks = {k: common.check(k, v, cell.limits) for k, v in training_gaps(prog, ref).items()}
        if cell.trace:
            m = common.Measure(cell, win.summary, win.host_s, win.units, win.seconds, tr["batch"])
            metrics = common.per_layer(cell, m)
        else:
            rate = next(m["name"] for m in cell.e2e if m["unit"] == "images/s")
            metrics = {rate: win.units * tr["batch"] / win.seconds, "setup_s": setup_s}
        return Outcome(checks=checks, metrics=metrics, attempted=win.units, failed=0,
                       device=device, breakdown=win.summary.breakdown if win.summary else None,
                       phases=phases.parts)

    def readings(self, cell: Cell, with_control: bool) -> dict:
        """The control tool's readings at the cell's size, no window: the
        program against the reference, and with ``with_control`` the TF32
        control and the half-batch fault in the program's place."""
        ref_mod = Bench(cell.root).reference(cell.config)
        weights = common.make_weights(ref_mod.param_specs(cell.config["arch"]),
                                      subseed(cell.seed, "weights"), cell.device)
        images, labels = self.pools(cell)
        state, _, prog, _ = self.checked_steps(cell, weights, images, labels)
        del state
        out = {"program": training_gaps(prog, self.follow(cell, ref_mod, weights, images, labels,
                                                          prog))}
        if with_control:
            for name, variant in (("control_tf32", {"tf32": True}),
                                  ("fault_half_batch", {"half_batch": True})):
                low = self.reference_as_program(cell, ref_mod, weights, images, labels, **variant)
                out[name] = training_gaps(low, self.follow(cell, ref_mod, weights, images, labels,
                                                           low))
        return out
