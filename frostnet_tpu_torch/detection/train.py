"""Detection QAT trainer (``frostnet_tpu/detection/train.py``; the
reference's Object_Detection/qtrainval.py flow).

Iteration-based: the FP32 warm-up for ``warmup_iters`` (two epochs' worth by
default), ``state.start_qat()`` (the StatAssist hand-off), then QAT to
``max_iter`` under the multistep schedule. One optimizer spans the feature
net and the head (QSGD with ``clip_by`` 1e-3 by default); the MultiBox loss
matches priors on the device. ``ssd300_<iter>`` checkpoints every
``save_every`` iterations and at the end; ``--resume_iter`` continues from
one, the data stream from where it stopped (the JAX trainer restarts it).
``--basenet`` loads a torchvision-format float MobileNetV2 into the qssd
trunk; ``--quant false`` trains plain FP32 throughout; uint8 batches get the
SSD BaseTransform on the device (``prep_det_image``).

Under ``torchrun`` it runs JAX's mesh, ``make_dp_mesh(batch_size)``: the
largest divisor of the batch that fits the ranks, the ranks beyond it idle
until the run ends (``parallel/``). Each rank trains on its block of each
global batch's rows, with the global batch's BN statistics and observers,
the MultiBox loss divided by the global batch's positives
(``parallel.global_normalizer``; the hard negatives are mined per image),
and rank 0 alone writes the checkpoints, ``arguments.json`` and the log.
A resume continues each rank's stream where it stopped.

Differences from the JAX trainer: ``--loader native`` (the C++ pool of
``native/``: the annotations parsed here, decode and augmentation there,
uint8 images) raises where g++, libjpeg or libpng are missing, where JAX
falls back to the Python loader with a warning. It runs on the card unless
``--device cpu`` is given.

Run: python -m frostnet_tpu_torch.detection.train --net_type qssd --dataset synthetic \\
       --max_iter 4 --warmup_iters 2
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import time
from typing import Optional

import torch

from ..data import prefetch_to_device
from ..nn import FP32, QAT
from ..nn.mode import QuantMode
from ..optim import get_optimizer, schedules
from ..parallel import (Mesh, all_reduce_gradients, data_parallel, global_normalizer,
                        make_dp_mesh, multihost, rank_rows, replicate)
from ..quant import numpy_init
from ..quant.freeze import resolve_device
from ..train.state import create_train_state
from ..utils.checkpoint import restore_checkpoint, save_checkpoint
from ..utils.logging import MetricLogger
from .anchors import CONFIGS, make_priors
from .data import MEANS, COCODetection, SyntheticDetection, VOCDetection
from .losses import multibox_loss_sums
from .models import Detector, build_ssd, join_variables, load_torch_mobilenet_v2_checkpoint
from .tdsod import build_tdsod

@dataclasses.dataclass
class DetConfig:
    net_type: str = "qssd"          # 'qssd' | 'qtdsod'
    dataset: str = "synthetic"      # 'voc' | 'coco' | 'synthetic'
    data_root: str = "./data/VOCdevkit"  # coco: the COCO root (annotations/ + splits)
    coco_split: str = "train2017"
    num_classes: Optional[int] = None    # default: the dataset config (21 voc / 201 coco)
    batch_size: int = 32
    lr: float = 1e-3
    momentum: float = 0.9
    weight_decay: float = 5e-4
    gamma: float = 0.1
    optim: str = "QSGD"
    quant: bool = True              # false: plain FP32 end to end
    loader: str = "python"          # "native": the C++ pool (native/)
    clip_by: float = 1e-3
    max_iter: Optional[int] = None      # default from the config
    warmup_iters: Optional[int] = None  # default two epochs
    save_every: int = 10000
    resume_iter: Optional[int] = None   # continue from save_dir/ssd300_<iter>
    basenet: Optional[str] = None       # torchvision float MobileNetV2 (qssd trunk)
    seed: int = 0
    save_dir: str = "./runs/detection"
    device: str = "cuda"            # "cpu" runs the kernels' plain versions


def select_config(net_type: str, dataset: str) -> dict:
    """The anchor and schedule config of (net, dataset) (``train.py:70-75``)."""
    key = "coco" if dataset == "coco" else "voc"
    return CONFIGS[f"tdsod_{key}" if net_type == "qtdsod" else key]


def build_detection_dataset(cfg: DetConfig, train: bool = True, mesh: Optional[Mesh] = None):
    """'voc' | 'coco' | 'synthetic' -> a batched detection dataset; under a
    data-parallel ``mesh`` this rank's rows of each batch."""
    if cfg.dataset == "synthetic":
        return rank_rows(SyntheticDetection((cfg.num_classes or 21) - 1, 300,
                                            cfg.batch_size * 4, cfg.batch_size, cfg.seed), mesh)
    if cfg.dataset == "coco":
        ds = COCODetection(cfg.data_root, split=cfg.coco_split, batch_size=cfg.batch_size,
                           train=train, seed=cfg.seed)
    elif cfg.dataset == "voc":
        ds = VOCDetection(cfg.data_root, batch_size=cfg.batch_size, train=train, seed=cfg.seed)
    else:
        raise ValueError(f"unknown dataset {cfg.dataset!r} (voc|coco|synthetic)")
    if cfg.loader != "native":
        return rank_rows(ds, mesh)
    from ..native import NativeDetectionLoader

    # the annotations are parsed here; decode and the SSD augmentation run
    # in the C++ pool, and the uint8 batches get the BaseTransform on the
    # device (prep_det_image)
    paths, boxes, labels = ds.annotations()
    return NativeDetectionLoader(paths, boxes, labels, batch_size=cfg.batch_size, train=train,
                                 seed=cfg.seed, rank=mesh.dp_index if mesh else 0,
                                 world=mesh.dp if mesh else 1)


def build_net(net_type: str, num_classes: int, **kw):
    """(feat, head) of ``qssd`` or ``qtdsod``."""
    if net_type not in ("qssd", "qtdsod"):
        raise ValueError(f"unknown net_type {net_type!r} (qssd|qtdsod)")
    return (build_tdsod if net_type == "qtdsod" else build_ssd)(num_classes=num_classes, **kw)


@functools.lru_cache(maxsize=None)
def _means(device: torch.device) -> torch.Tensor:
    return torch.tensor(MEANS, dtype=torch.float32).to(device)


def prep_det_image(image: torch.Tensor) -> torch.Tensor:
    """uint8 RGB batches get the SSD BaseTransform on the device, RGB -> BGR
    and the BGR means subtracted (exact in float32); float batches pass."""
    if image.dtype != torch.uint8:
        return image
    return image.to(torch.float32).flip(-1) - _means(image.device)


def multibox_step_loss(loc, conf, boxes, labels, valid, priors, mesh: Optional[Mesh] = None):
    """(loss to differentiate, loss, loss_l, loss_c) of a batch's MultiBox
    loss, divided by the global batch's positives under a data-parallel
    ``mesh``: the first ``dp`` times this rank's share (its gradient's mean
    over the ranks is the global loss's), the others the global values."""
    sum_l, sum_c, num_pos = multibox_loss_sums(loc, conf, boxes, labels, valid, priors)
    num_pos, factor = global_normalizer(num_pos, mesh)
    n = torch.clamp(num_pos, min=1.0)
    loss_l, loss_c = sum_l / n, sum_c / n
    loss = loss_l + loss_c
    if factor == 1.0:
        return loss, loss, loss_l, loss_c
    parts = mesh.all_reduce(torch.stack([loss_l.detach(), loss_c.detach()]))
    return loss * factor, parts[0] + parts[1], parts[0], parts[1]


def _det_loss(state, batch, priors, mode: QuantMode, train: bool,
              mesh: Optional[Mesh] = None):
    """:func:`multibox_step_loss` of the model's predictions on ``batch``."""
    batch = {k: torch.as_tensor(v).to(state.device) for k, v in batch.items()}
    loc, conf = state.model(prep_det_image(batch["image"]), mode=mode, train=train)
    return multibox_step_loss(loc, conf, batch["boxes"], batch["labels"], batch["valid"],
                              priors, mesh)


def make_det_train_step(mode: QuantMode, priors: torch.Tensor, mesh: Optional[Mesh] = None):
    """``step(state, batch) -> {"loss", "loss_l", "loss_c"}`` (device
    tensors): the forward in ``mode`` with ``train=True`` (the head in float),
    the MultiBox loss, backward, one optimizer step; the global batch's
    under a data-parallel ``mesh``."""

    def step(state, batch):
        with data_parallel(mesh):
            loss, total, loss_l, loss_c = _det_loss(state, batch, priors, mode, True, mesh)
            state.optimizer.zero_grad(set_to_none=True)
            loss.backward()
        if mesh is not None:
            all_reduce_gradients(state.model.parameters(), mesh)
        state.optimizer.step()
        state.step += 1
        return {"loss": total.detach(), "loss_l": loss_l.detach(), "loss_c": loss_c.detach()}

    return step


def make_det_eval_step(mode: QuantMode, priors: torch.Tensor):
    """``step(state, batch) -> {"loss", "loss_l", "loss_c"}`` without updates
    (``train=False``: running BN statistics, observers frozen unless
    ``mode`` observes)."""

    @torch.no_grad()
    def step(state, batch):
        _, loss, loss_l, loss_c = _det_loss(state, batch, priors, mode, False)
        return {"loss": loss, "loss_l": loss_l, "loss_c": loss_c}

    return step


def _cycle(ds, device, skip: int = 0):
    """The dataset's batches on ``device`` without end, starting ``skip``
    batches in (a resume continues the stream where it stopped)."""
    first = True
    while True:
        for i, batch in enumerate(prefetch_to_device(iter(ds), device)):
            if first and i < skip:
                continue
            yield batch
        first = False


def main(cfg: DetConfig):
    """Train; returns ``(state, results)``: each iteration's losses
    (``history``: tag, iteration, loss, loss_l, loss_c, wall ms) and the
    iteration a resume started at (``resumed``). A rank beyond the
    data-parallel mesh returns ``(None, {"idle": True})`` at the run's end."""
    multihost.initialize(cfg.device)  # torchrun's ranks; a no-op in one process
    mesh = make_dp_mesh(cfg.batch_size)  # JAX's mesh: the largest divisor that fits
    if not mesh.member:
        multihost.wait_for_end(mesh)
        return None, {"idle": True}
    device = resolve_device(multihost.local_device(cfg.device))
    primary = multihost.is_primary()
    os.makedirs(cfg.save_dir, exist_ok=True)
    logger = (MetricLogger(cfg.save_dir, name="det") if primary
              else MetricLogger(None, name="det", echo=False))
    logger.info(f"config: {dataclasses.asdict(cfg)}")
    if primary:
        with open(os.path.join(cfg.save_dir, "arguments.json"), "w") as f:
            json.dump(dataclasses.asdict(cfg), f, indent=2)

    det_cfg = select_config(cfg.net_type, cfg.dataset)
    priors = torch.as_tensor(make_priors(det_cfg), device=device)
    max_iter = cfg.max_iter or det_cfg["max_iter"]
    cfg.num_classes = cfg.num_classes or det_cfg["num_classes"]

    ds = build_detection_dataset(cfg, mesh=mesh)
    epoch_size = max(len(ds), 1)
    warmup_iters = cfg.warmup_iters if cfg.warmup_iters is not None else 2 * epoch_size

    feat, head = build_net(cfg.net_type, cfg.num_classes)
    schedule = schedules.multistep(cfg.lr, det_cfg["lr_steps"], cfg.gamma)
    tx = get_optimizer(cfg.optim, schedule, momentum=cfg.momentum,
                       weight_decay=cfg.weight_decay,
                       **({"clip_by": cfg.clip_by} if cfg.optim.startswith("Q") else {}))
    fv, hv = numpy_init((feat, head), cfg.seed)
    if cfg.basenet:
        if cfg.net_type != "qssd":
            raise ValueError("--basenet is the qssd MobileNetV2 trunk import")
        fv = load_torch_mobilenet_v2_checkpoint(cfg.basenet, fv)
        logger.info(f"loaded pretrained trunk from {cfg.basenet}")
    state = create_train_state(Detector(feat, head), tx, seed=cfg.seed, device=device,
                               variables=join_variables(fv, hv))

    fp_step = make_det_train_step(FP32, priors, mesh)
    qat_step = make_det_train_step(QAT if cfg.quant else FP32, priors, mesh)
    it, resumed = 0, None
    if cfg.resume_iter:
        restore_checkpoint(os.path.join(cfg.save_dir, f"ssd300_{cfg.resume_iter}"), state)
        it = resumed = cfg.resume_iter
        logger.info(f"resumed from ssd300_{it} (step {state.step})")
    replicate(state.model, mesh)  # rank 0's parameters and buffers on every rank
    logger.info(f"mesh {mesh.shape}")
    batches = _cycle(ds, device, skip=it % epoch_size)
    history = []

    def run(step_fn, tag):
        nonlocal it
        t0 = time.perf_counter()
        m = step_fn(state, next(batches))
        it += 1
        history.append({"tag": tag, "iter": it, **m, "wall_ms": (time.perf_counter() - t0) * 1e3})
        return m

    while it < warmup_iters:  # the FP32 warm-up (qtrainval.py:187-237)
        m = run(fp_step, "fp_warmup")
        if it == warmup_iters:
            logger.info(f"[warmup done @ {it}] loss={float(m['loss']):.4f}")
    state.start_qat()  # idempotent on a resume
    while it < max_iter:  # QAT (qtrainval.py:259-327)
        m = run(qat_step, "qat" if cfg.quant else "fp32")
        if it % cfg.save_every == 0 or it == max_iter:
            if primary:
                save_checkpoint(os.path.join(cfg.save_dir, f"ssd300_{it}"), state)
            logger.log_scalars({k: float(m[k]) for k in ("loss", "loss_l", "loss_c")}, step=it)
            logger.info(f"[iter {it}] loss={float(m['loss']):.4f} "
                        f"(l={float(m['loss_l']):.4f} c={float(m['loss_c']):.4f})")
    batches.close()
    for h in history:
        for k in ("loss", "loss_l", "loss_c"):
            h[k] = float(h[k])
    if history:
        logger.info(f"final loss={history[-1]['loss']:.4f}")
    logger.close()
    multihost.wait_for_end(mesh)
    return state, {"history": history, "resumed": resumed, "num_classes": cfg.num_classes}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    for f in dataclasses.fields(DetConfig):
        kind = {"int": int, "Optional[int]": int, "float": float,
                "bool": lambda v: v.lower() in ("1", "true", "yes")}.get(f.type, str)
        p.add_argument(f"--{f.name}", type=kind, default=None)
    return p


def config_from_args(args) -> DetConfig:
    cfg = DetConfig()
    for f in dataclasses.fields(DetConfig):
        v = getattr(args, f.name, None)
        if v is not None:
            setattr(cfg, f.name, v)
    return cfg


def cli(argv=None):
    main(config_from_args(build_parser().parse_args(argv)))


if __name__ == "__main__":
    cli()
