"""Pix2Pix and CycleGAN training steps (``frostnet_tpu/gan/models.py``).

The reference's updates (Style_Transfer/models/pix2pix_model.py:120-131: D,
then G with GAN + lambda * L1; cycle_gan_model.py:183-197: both generators
jointly with the cycle and identity losses, then both discriminators) as
step functions over :class:`NetState` holders (``train.TrainState``: the
model, its optimizer, the ``torch.Generator`` of its dropout draws and a
step count). Only the generators carry GradBoost and QAT; the
discriminators stay float.

The JAX steps are pure functions that keep some of their modules' state
updates and drop others. The port's modules update their BN statistics and
observers in place, so each drop is explicit here:

* pix2pix ``d_step`` runs G in train mode (its batch statistics and its
  observers' new grids act on that forward) without a gradient, and keeps
  none of G's updates (:func:`discarded_updates`); ``g_step`` then runs G
  again from the unchanged state.
* D runs in eval mode inside the generator steps (running statistics where
  it has BN, JAX's default ``train=False``; upstream PyTorch runs it in
  train mode), its parameters out of the gradient.
* D's statistics step in the JAX order: pix2pix fake then real; CycleGAN
  real then fake.
* CycleGAN's ``g_step`` keeps each generator's state after its second
  apply; the identity passes read that state and their updates are
  dropped. The gradient flows through all six generator applies and both D
  applies.
* One optimizer steps both generators (``make_joint_optimizer``): G_A's
  parameters, then G_B's, each in the JAX tree order, so that one flat
  vector lines up with JAX's (GradBoost noise, per-element EMAs).

Each step returns its metrics as device tensors; nothing waits for the host.

Under a data-parallel ``mesh`` (``parallel``; the steps' ``mesh`` argument)
each rank runs its block of the global batch's rows inside
``parallel.data_parallel``: every BN (the generators' quantized core, the
pix2pix D's) and every observer takes the global batch's statistics, and
each update's gradient is the mean over the ranks before the optimizer
step. Every loss is a mean over equal row blocks, so that mean is the
global loss's gradient; the metrics are the global batch's. The dropped
updates above are the same under the mesh: ``discarded_updates`` restores
what the global statistics stepped.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional, Sequence

import torch
from torch import nn

from ..nn.mode import QuantMode
from ..parallel import Mesh, all_reduce_gradients, cross_replica_mean, data_parallel
from ..quant.export import numpy_init
from ..train.state import TrainState, create_train_state
from ..utils.losses import l1
from .networks import gan_loss

NetState = TrainState


def tree_ordered_parameters(model: nn.Module):
    """``model``'s parameters in the JAX tree order of its params (keys
    sorted at every level)."""
    named = sorted(model.named_parameters(), key=lambda kv: tuple(kv[0].split(".")))
    return [p for _, p in named]


def make_net_state(model: nn.Module, tx: Optional[Callable], seed: int = 0, device="cuda",
                   variables: Optional[dict] = None) -> NetState:
    """``train.create_train_state`` with the GAN init: ``model`` filled with
    ``variables`` (by default ``numpy_init(model, seed, init="gan")``), on
    ``device``, its optimizer from the factory ``tx`` (None for a CycleGAN
    generator, which the joint optimizer steps). The BN statistics and
    observers start fresh, as the JAX ``make_net_state``'s do."""
    if variables is None:
        variables = numpy_init(model, seed, init="gan")
    return create_train_state(model, tx, seed, device, variables)


def make_joint_optimizer(tx: Callable, models: Sequence[nn.Module]):
    """One optimizer over several models' parameters, each model's in tree
    order, in turn (JAX's ``tx.init((gA.params, gB.params))``)."""
    return tx([p for m in models for p in tree_ordered_parameters(m)])


@contextlib.contextmanager
def discarded_updates(*models: nn.Module):
    """Run forwards whose BN-statistics and observer updates are thrown
    away: every buffer of ``models`` is restored on exit. The restore
    writes through ``.data``, so tensors that autograd saved in those
    forwards keep their version (train-mode BN saves its running
    statistics and never reads them in the backward)."""
    bufs = [b for m in models for b in m.buffers()]
    saved = torch.cat([b.detach().reshape(-1) for b in bufs]) if bufs else None
    try:
        yield
    finally:
        if bufs:
            parts = torch.split(saved, [b.numel() for b in bufs])
            torch._foreach_copy_([b.data for b in bufs],
                                 [p.view_as(b) for p, b in zip(parts, bufs)])


@contextlib.contextmanager
def no_param_grads(*models: nn.Module):
    """Keep ``models``' parameters out of the gradient (the reference's
    ``set_requires_grad(netD, False)`` around the generator update)."""
    params = [p for m in models for p in m.parameters() if p.requires_grad]
    for p in params:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p in params:
            p.requires_grad_(True)


def _device_batch(batch, dev) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v).to(dev) for k, v in batch.items() if k in ("A", "B")}


def _update(optimizer, loss: torch.Tensor, mesh: Optional[Mesh] = None) -> None:
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    if mesh is not None:
        all_reduce_gradients([p for g in optimizer.param_groups for p in g["params"]], mesh)
    optimizer.step()


def make_pix2pix_steps(mode: QuantMode, gan_mode: str = "lsgan", lambda_l1: float = 100.0,
                       mesh: Optional[Mesh] = None):
    """``(d_step, g_step)`` of one phase (pix2pix_model.py:96-131), each
    ``step(g_state, d_state, batch) -> metrics``; ``batch`` is ``{"A": (B,
    H, W, C), "B": ...}`` (this rank's rows under ``mesh``) and the
    conditional D sees ``cat(A, x)``."""

    def d_step(g_state: NetState, d_state: NetState, batch) -> Dict[str, torch.Tensor]:
        b = _device_batch(batch, d_state.device)
        with data_parallel(mesh):
            with torch.no_grad(), discarded_updates(g_state.model):
                fake_b = g_state.model(b["A"], mode, train=True, generator=g_state.generator)
            net_d = d_state.model
            pred_fake = net_d(torch.cat([b["A"], fake_b], -1), train=True)
            pred_real = net_d(torch.cat([b["A"], b["B"]], -1), train=True)
            loss = 0.5 * (gan_loss(pred_fake, False, gan_mode)
                          + gan_loss(pred_real, True, gan_mode))
            _update(d_state.optimizer, loss, mesh)
        d_state.step += 1
        return cross_replica_mean({"loss_D": loss.detach()}, mesh)

    def g_step(g_state: NetState, d_state: NetState, batch) -> Dict[str, torch.Tensor]:
        b = _device_batch(batch, g_state.device)
        with data_parallel(mesh):
            fake_b = g_state.model(b["A"], mode, train=True, generator=g_state.generator)
            with no_param_grads(d_state.model):
                pred_fake = d_state.model(torch.cat([b["A"], fake_b], -1))
            loss_gan = gan_loss(pred_fake, True, gan_mode)
            loss_l1 = l1(fake_b, b["B"]) * lambda_l1
            loss = loss_gan + loss_l1
            _update(g_state.optimizer, loss, mesh)
        g_state.step += 1
        return cross_replica_mean({"loss_G": loss.detach(), "loss_G_GAN": loss_gan.detach(),
                                   "loss_G_L1": loss_l1.detach()}, mesh)

    return d_step, g_step


def make_cyclegan_steps(mode: QuantMode, gan_mode: str = "lsgan", lambda_a: float = 10.0,
                        lambda_b: float = 10.0, lambda_idt: float = 0.5,
                        mesh: Optional[Mesh] = None):
    """``(g_step, d_step)`` of one phase (cycle_gan_model.py:128-197).

    ``g_step(gA, gB, dA, dB, batch, joint_optimizer) -> (fake_a, fake_b,
    metrics)`` updates both generators with the joint optimizer;
    ``d_step(d_state, real, fake) -> loss_D`` updates one discriminator
    against a pool-provided fake. Under ``mesh`` the fakes are this rank's
    rows (the trainer queries the pool on the global batch)."""

    def g_step(gA: NetState, gB: NetState, dA: NetState, dB: NetState, batch, joint_optimizer):
        b = _device_batch(batch, gA.device)
        real_a, real_b = b["A"], b["B"]
        net_a, net_b = gA.model, gB.model
        with data_parallel(mesh):
            fake_b = net_a(real_a, mode, train=True, generator=gA.generator)
            rec_a = net_b(fake_b, mode, train=True, generator=gB.generator)
            fake_a = net_b(real_b, mode, train=True, generator=gB.generator)
            rec_b = net_a(fake_a, mode, train=True, generator=gA.generator)
            with no_param_grads(dA.model, dB.model):
                loss_gan_a = gan_loss(dA.model(fake_b), True, gan_mode)
                loss_gan_b = gan_loss(dB.model(fake_a), True, gan_mode)
            loss_cyc_a = l1(rec_a, real_a) * lambda_a
            loss_cyc_b = l1(rec_b, real_b) * lambda_b
            loss = loss_gan_a + loss_gan_b + loss_cyc_a + loss_cyc_b
            if lambda_idt > 0:
                with discarded_updates(net_a, net_b):
                    idt_a = net_a(real_b, mode, train=True, generator=gA.generator)
                    idt_b = net_b(real_a, mode, train=True, generator=gB.generator)
                loss = loss + (l1(idt_a, real_b) * lambda_b * lambda_idt
                               + l1(idt_b, real_a) * lambda_a * lambda_idt)
            _update(joint_optimizer, loss, mesh)
        gA.step += 1
        gB.step += 1
        return fake_a.detach(), fake_b.detach(), cross_replica_mean({
            "loss_G": loss.detach(), "cyc_A": loss_cyc_a.detach(),
            "cyc_B": loss_cyc_b.detach()}, mesh)

    def d_step(d_state: NetState, real, fake) -> torch.Tensor:
        dev = d_state.device
        real, fake = torch.as_tensor(real).to(dev), torch.as_tensor(fake).to(dev).detach()
        with data_parallel(mesh):
            pred_real = d_state.model(real, train=True)
            pred_fake = d_state.model(fake, train=True)
            loss = 0.5 * (gan_loss(pred_real, True, gan_mode)
                          + gan_loss(pred_fake, False, gan_mode))
            _update(d_state.optimizer, loss, mesh)
        d_state.step += 1
        return cross_replica_mean(loss.detach().clone(), mesh)

    return g_step, d_step
