"""Checkpoint save and restore (``frostnet_tpu/utils/checkpoint.py``).

A checkpoint is a directory, as in the JAX package, holding one
``state.pt`` written by ``torch.save`` (the JAX package's orbax format is a
JAX library's). It carries everything a resume needs to continue bit for
bit as if never stopped:

* the model's parameters, BN statistics and observers, under their flat JAX
  keys (``quant.model_variables``);
* ``TrainState.step``, the EMA and the dropout generator's state;
* the optimizer: its class, each group's counters (``count``, the schedule
  and bias-correction count; ``gb_step``, ``restart_step``, ``is_warmup``),
  its state tensors (decay vector, momentum, moments, ``exp_min`` and
  ``exp_max``) and the GradBoost noise generator's state once it exists.
  A resume into the noise phase restores that generator, not a fresh seed.

:func:`save_optimizer` and :func:`restore_optimizer` write and read an
optimizer alone (CycleGAN's joint generator optimizer, ``latest_opt_G``).
"""
from __future__ import annotations

import os
from typing import Any, Dict

import torch

from ..optim.gradboost import COUNTERS
from ..quant.export import model_variables

_FILE = "state.pt"


def _cpu(t):
    return t.detach().to("cpu").clone() if isinstance(t, torch.Tensor) else t


def _optimizer_blob(opt) -> Dict[str, Any]:
    gen = getattr(opt, "generator", None)
    return {
        "class": type(opt).__name__,
        "groups": [{k: g[k] for k in COUNTERS if k in g} for g in opt.param_groups],
        "state": {k: {n: _cpu(t) for n, t in v.items()} for k, v in opt.state.items()},
        "noise_generator": None if gen is None else gen.get_state(),
    }


def _write(path: str, blob: Dict[str, Any]) -> None:
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, _FILE + ".tmp")
    torch.save(blob, tmp)
    os.replace(tmp, os.path.join(path, _FILE))


def save_checkpoint(path: str, state) -> None:
    """Write ``state`` (a ``train.TrainState``) into the directory ``path``,
    replacing what was there. A state whose ``optimizer`` is None (a
    CycleGAN generator: its optimizer is the joint one, saved with
    :func:`save_optimizer`) is written without one."""
    opt = state.optimizer
    _write(path, {
        "model": {k: _cpu(v) for k, v in model_variables(state.model).items()},
        "step": int(state.step),
        "ema": None if state.ema is None else {k: _cpu(v) for k, v in state.ema.items()},
        "generator": state.generator.get_state(),
        "optimizer": None if opt is None else _optimizer_blob(opt),
    })


def save_optimizer(path: str, optimizer) -> None:
    """Write an optimizer alone (CycleGAN's joint generator optimizer) into
    the directory ``path``."""
    _write(path, {"optimizer": _optimizer_blob(optimizer)})


def _load(path: str) -> Dict[str, Any]:
    f = os.path.join(path, _FILE)
    if not os.path.exists(f):
        raise FileNotFoundError(f"no checkpoint at {path} (expected {f})")
    return torch.load(f, map_location="cpu", weights_only=False)


def _fill_model(state, blob) -> None:
    mine = model_variables(state.model)
    saved = blob["model"]
    if set(mine) != set(saved):
        missing, extra = sorted(set(mine) - set(saved)), sorted(set(saved) - set(mine))
        raise ValueError(f"checkpoint does not match the model: missing {missing[:5]}, "
                         f"unexpected {extra[:5]}")
    with torch.no_grad():
        for k, t in mine.items():
            if tuple(saved[k].shape) != tuple(t.shape):
                raise ValueError(f"{k}: shape {tuple(saved[k].shape)} != {tuple(t.shape)}")
            t.copy_(saved[k])
    dev = state.device
    state.step = blob["step"]
    state.ema = (None if blob["ema"] is None
                 else {k: v.to(dev) for k, v in blob["ema"].items()})


def _check_optimizer(opt, saved) -> None:
    if saved is None or opt is None:
        if saved is not None or opt is not None:
            raise ValueError("checkpoint and state disagree on whether there is an optimizer")
        return
    if saved["class"] != type(opt).__name__ or len(saved["groups"]) != len(opt.param_groups):
        raise ValueError(f"checkpoint holds a {saved['class']} with {len(saved['groups'])} "
                         f"groups; the state has a {type(opt).__name__} with "
                         f"{len(opt.param_groups)} (evaluators restore with "
                         "restore_model_variables)")


def _fill_optimizer(opt, saved, dev) -> None:
    for group, counters in zip(opt.param_groups, saved["groups"]):
        group.update(counters)
    opt.state.clear()
    for k, v in saved["state"].items():
        opt.state[k] = {n: (t.to(dev) if isinstance(t, torch.Tensor) else t)
                        for n, t in v.items()}
    if saved["noise_generator"] is not None:
        opt.generator = torch.Generator(device=dev)
        opt.generator.set_state(saved["noise_generator"])
    elif hasattr(opt, "generator"):
        opt.generator = None


def restore_checkpoint(path: str, state):
    """Restore the whole of ``state`` in place from the directory ``path``
    (the resume path): the optimizer must be of the saved class with as
    many groups. Returns ``state``."""
    blob = _load(path)
    _check_optimizer(state.optimizer, blob["optimizer"])
    _fill_model(state, blob)
    if state.optimizer is not None:
        _fill_optimizer(state.optimizer, blob["optimizer"], state.device)
    state.generator.set_state(blob["generator"])
    return state


def restore_optimizer(path: str, optimizer):
    """Restore an optimizer written by :func:`save_optimizer` in place
    (the state tensors go to its parameters' device). Returns it."""
    saved = _load(path)["optimizer"]
    _check_optimizer(optimizer, saved)
    dev = optimizer.param_groups[0]["params"][0].device
    _fill_optimizer(optimizer, saved, dev)
    return optimizer


def restore_model_variables(path: str, state):
    """Restore only the model's variables (parameters, BN statistics,
    observers), the step and the EMA when the checkpoint has one, whatever
    optimizer produced it: the evaluator's load path. Returns ``state``."""
    _fill_model(state, _load(path))
    return state
