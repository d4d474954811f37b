"""QAT training state and step factories (``frostnet_tpu/train/state.py``).

The reference's phases (FP32 warm-up -> ``is_warmup = False`` -> QAT) are
one model run in another ``mode``:

* :class:`TrainState` holds the model (parameters, BN statistics and
  observers live in it, on the device), the optimizer, the step count, the
  ``torch.Generator`` of the dropout draws and the optional parameter EMA.
  Unlike the JAX state it is updated in place: a step mutates the model's
  parameters and buffers and the optimizer's state.
* :func:`make_train_step` returns ``step(state, batch) -> metrics`` for one
  phase: on-device uint8 normalization, forward in ``mode`` with
  ``train=True`` (BN statistics and, in QAT, the observers step exactly
  once), cross-entropy, backward, the optimizer step (its lr read on the
  host from the float or the schedule at the optimizer's own count), the
  EMA, rounded as the jitted JAX step rounds it (``optim.ema_update``).
  Metrics stay on the device: nothing waits for the host.
* ``state.start_qat()`` is the StatAssist hand-off (``set_warmup``).

Data parallelism (``mesh``, ``parallel.make_mesh()`` under ``torchrun``):
each rank runs its block of the global batch's rows inside
``parallel.data_parallel(mesh)``, so the BN statistics, the activation
observers and the dropout mask are the global batch's; after the backward
one all-reduce makes the gradient the mean over ranks, before the optimizer
step; the metrics are the global batch's (the mean over ranks). The ranks
start from one state (``parallel.replicate``) and stay replicas: their
updates are bit-identical, GradBoost's noise generator is seeded alike on
every rank (``optim/gradboost.py::_draws``), and ``state.generator`` draws
the same dropout masks everywhere.

``remat`` (JAX's ``train/state.py:116-161``): each child module of the
model (FrostNet's stem, each block, the head's convs) runs under its own
``torch.utils.checkpoint`` (non-reentrant), and the backward replays it
instead of keeping its activations: one child's at a time. (One checkpoint
over the whole forward would replay it whole at the backward's start and
hold as much as the plain step.) ``True``/``"full"`` keeps nothing inside a
child; ``"conv_outs"`` keeps the conv outputs (a selective-checkpoint
policy, the counterpart of JAX's ``save_only_these_names("conv_out")``) and
replays the BN, activation and fake-quant chains. The port's BN
statistics, observers and dropout generator step in place in the forward,
so a replay (:func:`remat_forward`) runs on copies of the buffers as they
were before the step and on the generator's state before the child ran:
it recomputes the first forward's values (its qparams, its running
variance in the QAT weight fold, its mask) and steps nothing that lasts.
Under a mesh a replay's collectives (the global BN's sums, the observers'
min/max, the tensor-parallel sums) run again, in the same order on every
rank.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, Iterable, Optional, Union

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..nn.mode import QAT, QuantMode
from ..ops.requant import fma_f32
from ..optim import ema_update, set_warmup
from ..parallel.mesh import Mesh, all_reduce_gradients, cross_replica_mean, data_parallel
from ..quant.export import from_jax_variables, numpy_init
from ..quant.freeze import resolve_device
from ..utils.losses import cross_entropy
from ..utils.metrics import topk_accuracy
from ..utils.profiling import span

# the normalization of uint8 batches (data.IMAGENET_MEAN/STD of the JAX package)
_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)


def prep_image(image: torch.Tensor, mean=None, std=None) -> torch.Tensor:
    """uint8 NHWC batches are normalized on the device; float ones pass.

    ``(x / 255 - mean) / std`` as the jitted JAX step computes it: XLA turns
    each division by a constant into a multiply by its float32 reciprocal
    and contracts the first multiply with the subtraction,
    ``fma(x, f32(1/255), -mean) * f32(1/std)``.
    """
    if image.dtype != torch.uint8:
        return image
    inv255, neg_mean, inv_std = _norm_constants(
        image.device, tuple(mean if mean is not None else _IMAGENET_MEAN),
        tuple(std if std is not None else _IMAGENET_STD))
    return fma_f32(image.to(torch.float32), inv255, neg_mean) * inv_std


@functools.lru_cache(maxsize=None)
def _norm_constants(device: torch.device, mean: tuple, std: tuple):
    """(f32(1/255), -mean, f32(1/std)) on ``device``, copied there once: a
    copy from the host waits for the device, so not on every step."""
    mean = torch.tensor(mean, dtype=torch.float32)
    std = torch.tensor(std, dtype=torch.float32)
    inv255 = torch.tensor(1.0, dtype=torch.float32) / torch.tensor(255.0)
    return inv255.to(device), (-mean).to(device), (torch.ones(()) / std).to(device)


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    generator: torch.Generator
    step: int = 0
    ema: Optional[Dict[str, torch.Tensor]] = None

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    def start_qat(self) -> "TrainState":
        """StatAssist hand-off: end the FP32 warm-up phase."""
        set_warmup(self.optimizer, False)
        return self


def create_train_state(model: torch.nn.Module, tx: Optional[Callable], seed: int = 0,
                       device="cuda", variables: Optional[dict] = None,
                       ema_decay: float = 0.0) -> TrainState:
    """Fill ``model`` with ``variables`` (a JAX-keyed tree; by default
    ``numpy_init(model, seed)``), move it to ``device`` and build the
    optimizer from the factory ``tx`` (``optim.get_optimizer``; None for a
    model another state's optimizer steps, as a CycleGAN generator)."""
    device = resolve_device(device)
    from_jax_variables(model, variables if variables is not None else numpy_init(model, seed))
    model.to(device)
    optimizer = tx(model.parameters()) if tx is not None else None
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    ema = ({n: p.detach().clone() for n, p in model.named_parameters()}
           if ema_decay > 0 else None)
    return TrainState(model=model, optimizer=optimizer, generator=gen, ema=ema)


def _metrics(logits, labels, loss, num_classes):
    out = {"loss": loss.detach().to(torch.float32)}
    if logits.ndim == 2 and num_classes:
        top1, top5 = topk_accuracy(logits.detach(), labels, (1, min(5, num_classes)))
        out.update(top1=top1, top5=top5)
    return out


def _save_conv_outputs(ctx, op, *args, **kwargs):
    """The ``"conv_outs"`` policy: keep what a convolution returns (``F.conv2d``
    reaches the policy as ``aten.convolution``), replay the rest."""
    return (CheckpointPolicy.MUST_SAVE if op is torch.ops.aten.convolution.default
            else CheckpointPolicy.PREFER_RECOMPUTE)


def remat_forward(model: torch.nn.Module, image: torch.Tensor, mode: QuantMode,
                  generator: Optional[torch.Generator], remat: Union[bool, str] = False):
    """``model(image, mode, train=True, generator)``, with ``remat``
    ``True``/``"full"`` or ``"conv_outs"`` each of ``model``'s child modules
    (FrostNet's stem, each block, the head's convs) under its own
    checkpoint, so that the backward holds one child's activations at a
    time (the module docstring). A child's replay swaps every buffer of
    ``model`` for a copy of its value before the step, and the generator
    back to its state before that child ran, then restores both; the
    parent's own ops (pooling, dropout) keep their activations."""
    if not remat:
        return model(image, mode=mode, train=True, generator=generator)
    if remat not in (True, "full", "conv_outs"):
        raise ValueError(f"remat is False, True, 'full' or 'conv_outs', got {remat!r}")
    slots = [(m, name) for m in model.modules() for name, b in m._buffers.items()
             if b is not None]
    # the replays' copies are made here: no tensor op may run in a
    # checkpointed function that its first run did not (a selective policy
    # matches the replay's ops to the first run's, one by one)
    replay = [m._buffers[name].detach().clone() for m, name in slots]
    after = {}
    context = ({"context_fn": functools.partial(create_selective_checkpoint_contexts,
                                                _save_conv_outputs)}
               if remat == "conv_outs" else {})

    def checkpointed(child):
        run = child.forward

        def forward(*args, **kwargs):
            before = generator.get_state() if generator is not None else None
            calls = []

            def segment(*a, **kw):
                if not calls:
                    calls.append(1)
                    return run(*a, **kw)
                live = [m._buffers[name] for m, name in slots]
                for (m, name), t in zip(slots, replay):
                    m._buffers[name] = t
                if generator is not None:
                    generator.set_state(before)
                try:
                    return run(*a, **kw)
                finally:
                    for (m, name), t in zip(slots, live):
                        m._buffers[name] = t
                    if generator is not None:
                        generator.set_state(after["state"])

            return checkpoint(segment, *args, use_reentrant=False, **context, **kwargs)
        return forward

    children = [c for c in model.children() if any(True for _ in c.parameters())]
    own = [c.__dict__.get("forward") for c in children]  # an instance's own forward, if set
    for child in children:
        child.forward = checkpointed(child)
    try:
        out = model(image, mode=mode, train=True, generator=generator)
    finally:
        for child, fwd in zip(children, own):
            if fwd is None:
                del child.forward
            else:
                child.forward = fwd
    if generator is not None:
        after["state"] = generator.get_state()
    return out


def make_train_step(mode: QuantMode, loss_fn: Optional[Callable] = None,
                    num_classes: Optional[int] = None, label_smoothing: float = 0.0,
                    ema_decay: float = 0.0, input_mean=None, input_std=None,
                    mesh: Optional[Mesh] = None, remat: Union[bool, str] = False) -> Callable:
    """``step(state, batch) -> metrics`` for one phase.

    ``batch`` is ``{"image": (B, S, S, 3) uint8 or float, "label": (B,)}``,
    this rank's rows under a data-parallel ``mesh``; ``loss_fn(outputs,
    batch)`` overrides the cross-entropy on labels. Metrics: loss, and
    top1/top5 when ``num_classes`` is given (the global batch's).
    ``remat``: False, ``True``/``"full"`` or ``"conv_outs"``
    (:func:`remat_forward`).
    """
    if loss_fn is None:
        def loss_fn(outputs, batch):
            return cross_entropy(outputs, batch["label"], label_smoothing=label_smoothing)

    def step(state: TrainState, batch) -> Dict[str, torch.Tensor]:
        dev = state.device
        with span("step"):
            with span("step.input"):
                batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
                image = prep_image(batch["image"], input_mean, input_std)
            with span("step.forward"), data_parallel(mesh):
                logits = remat_forward(state.model, image, mode, state.generator, remat)
                loss = loss_fn(logits, batch)
            with span("step.backward"):
                with data_parallel(mesh):
                    state.optimizer.zero_grad(set_to_none=True)
                    loss.backward()
                if mesh is not None:
                    all_reduce_gradients(state.model.parameters(), mesh)
            with span("step.optimizer", device=dev):
                state.optimizer.step()
                if state.ema is not None and ema_decay > 0:
                    for name, p in state.model.named_parameters():
                        ema_update(state.ema[name], p, ema_decay)
            state.step += 1
            with span("step.metrics"):
                return cross_replica_mean(_metrics(logits, batch["label"], loss, num_classes),
                                          mesh)

    return step


def make_eval_step(mode: QuantMode, num_classes: Optional[int] = None, use_ema: bool = False,
                   input_mean=None, input_std=None) -> Callable:
    """``step(state, batch) -> metrics`` without updates (``train=False``);
    ``use_ema`` evaluates the EMA parameters."""

    @torch.no_grad()
    def step(state: TrainState, batch) -> Dict[str, torch.Tensor]:
        dev = state.device
        batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        image = prep_image(batch["image"], input_mean, input_std)
        saved = None
        if use_ema and state.ema is not None:
            saved = {n: p.detach().clone() for n, p in state.model.named_parameters()}
            for n, p in state.model.named_parameters():
                p.copy_(state.ema[n])
        try:
            logits = state.model(image, mode=mode)
        finally:
            if saved is not None:
                for n, p in state.model.named_parameters():
                    p.copy_(saved[n])
        loss = cross_entropy(logits, batch["label"])
        return _metrics(logits, batch["label"], loss, num_classes or logits.shape[-1])

    return step


@torch.no_grad()
def recalibrate(state: TrainState, batches: Iterable, mode: QuantMode = QAT, seed: int = 0,
                input_mean=None, input_std=None, mesh: Optional[Mesh] = None) -> TrainState:
    """Re-estimate the BN running statistics and the observers: forwards in
    train mode without optimizer updates (the reference's calibration
    pass, generalized to N batches); the global batch's under a
    data-parallel ``mesh``."""
    dev = state.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    for batch in batches:
        image = prep_image(torch.as_tensor(batch["image"]).to(dev), input_mean, input_std)
        with data_parallel(mesh):
            state.model(image, mode=mode, train=True, generator=gen)
    return state
