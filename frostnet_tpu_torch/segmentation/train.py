"""Segmentation QAT trainer (``frostnet_tpu/segmentation/train.py``).

The flow of the JAX trainer and of the reference's
Semantic_Segmentation/train.py: StatAssist FP32 warm-up epochs ->
``state.start_qat()`` -> QAT epochs with GradBoost (QSGD by default, the
``poly`` schedule over all ``fp_epochs + epochs``), the weighted and
ignore-aware cross-entropy (``bce`` on request), a confusion-matrix mIoU
counted on the device (``bincount``, int64; one host read an epoch), a
QAT_FROZEN validation after each QAT epoch, the ``checkpoint`` and ``best``
directories and ``checkpoint_meta.json`` (``--resume`` continues from
them) -> the dual mIoU, QAT_FROZEN and INT8 (frozen in process right before
it runs).

It runs on the card unless ``--device cpu`` is given. ``--loader native``
hands the dataset's (image, mask) file list to the C++ pool (``native/``:
uint8 images, normalized on the device); it needs g++, libjpeg and libpng
and raises where they are missing, where the JAX trainer falls back to the
Python loader.

Under ``torchrun`` it runs JAX's data-parallel mesh (``make_mesh()``, every
rank on ``dp``; ``parallel/``): each rank trains on its block of each
global batch's rows, the BN statistics, observers and dropout are the
global batch's, the CE divides by the global batch's class-weight sum
(``parallel.global_normalizer``), the confusion matrices are summed over
the ranks (int64), and rank 0 alone writes the checkpoints, their meta,
``arguments.json`` and the metric log.

Run: torchrun --nproc_per_node 2 -m frostnet_tpu_torch.segmentation.train ...

Run: python -m frostnet_tpu_torch.segmentation.train --model mobilenetv3_RE_small \\
       --dataset synthetic --crop_size 768
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Optional

import numpy as np
import torch

from ..data import prefetch_to_device
from ..nn import FP32, INT8, QAT, QAT_FROZEN
from ..nn.mode import QuantMode
from ..optim import get_lr_scheduler, get_optimizer, grouped_weight_decay
from ..parallel import (Mesh, all_reduce_gradients, cross_replica_mean, data_parallel,
                        global_normalizer, make_mesh, multihost, rank_rows, replicate)
from ..quant.freeze import resolve_device
from ..train.state import create_train_state, prep_image
from ..utils.checkpoint import restore_checkpoint, save_checkpoint
from ..utils.logging import MetricLogger
from ..utils.losses import binary_cross_entropy_with_logits, cross_entropy_sums
from ..utils.metrics import confusion_matrix, miou_from_confusion
from ..utils.profiling import span
from .data import (CITYSCAPES_CLASS_WEIGHTS, CITYSCAPES_IGNORE, CityscapesSegmentation,
                   CustomSegmentation, SyntheticSegmentation, VOCSegmentation)
from .models import get_seg_model

@dataclasses.dataclass
class SegConfig:
    model: str = "mobilenetv3_RE_small"
    dataset: str = "synthetic"       # 'city' | 'pascal' | 'custom' | 'synthetic'
    data_dir: str = "./data/cityscapes"  # pascal: the VOCdevkit root
    coco_list: Optional[str] = None  # pascal: an extra COCO-as-VOC "img,mask" list
    num_classes: Optional[int] = None  # resolved per dataset when unset
    crop_size: Optional[int] = None    # (resolve_dataset_defaults)
    batch_size: int = 16
    epochs: int = 2
    fp_epochs: int = 1
    optim: str = "QSGD"
    learning_rate: float = 0.05
    weight_decay: float = 4e-5
    clip_by: float = 1e-3
    scheduler: str = "poly"
    power: float = 0.9
    steps_per_epoch: Optional[int] = None
    seed: int = 42
    save_dir: str = "./runs/segmentation"
    ignore_index: int = CITYSCAPES_IGNORE
    loss_type: str = "ce"            # 'ce' | 'bce'
    width_scale: Optional[float] = None  # espnet/espnetv2 channel scale
    loader: str = "python"           # "native": the C++ pool (native/)
    resume: bool = False             # continue from save_dir/checkpoint
    device: str = "cuda"             # "cpu" runs the kernels' plain versions


def resolve_dataset_defaults(cfg: SegConfig) -> SegConfig:
    """Fill an unset ``num_classes`` / ``crop_size`` per dataset: pascal 21 /
    512, city 19 / 768, custom 2 / 512, synthetic 19 / 96. Values given are
    kept."""
    fills = {"pascal": (VOCSegmentation.NUM_CLASSES, 512), "city": (19, 768),
             "custom": (2, 512)}.get(cfg.dataset, (19, 96))
    if cfg.num_classes is None:
        cfg.num_classes = fills[0]
    if cfg.crop_size is None:
        cfg.crop_size = fills[1]
    return cfg


def build_seg_dataset(cfg: SegConfig, train: bool, mesh: Optional[Mesh] = None):
    """The train or validation batches; under a data-parallel ``mesh`` this
    rank's rows of each (the native pool decodes only those)."""
    crop = (cfg.crop_size, cfg.crop_size)
    if cfg.dataset == "synthetic":
        return rank_rows(SyntheticSegmentation(
            num_classes=cfg.num_classes, crop=crop,
            length=cfg.batch_size * (cfg.steps_per_epoch or 4), batch_size=cfg.batch_size,
            seed=cfg.seed + (not train)), mesh)
    if cfg.dataset == "pascal":
        ds = VOCSegmentation(cfg.data_dir, train=train, crop_size=crop,
                             batch_size=cfg.batch_size, seed=cfg.seed,
                             coco_list=cfg.coco_list if train else None)
    elif cfg.dataset == "city":
        ds = CityscapesSegmentation(cfg.data_dir, train=train, crop_size=crop,
                                    batch_size=cfg.batch_size, seed=cfg.seed)
    elif cfg.dataset == "custom":
        ds = CustomSegmentation(cfg.data_dir, train=train, crop_size=crop,
                                batch_size=cfg.batch_size, seed=cfg.seed)
    else:
        raise ValueError(f"unknown dataset {cfg.dataset!r} (city|pascal|custom|synthetic)")
    if cfg.loader != "native":
        return rank_rows(ds, mesh)
    from ..native import NativeSegmentationLoader

    # the Python dataset's (img, mask) list goes to the C++ pool: city and
    # custom pairs are root-relative, VOC's absolute. Validation: pascal
    # resizes to the crop, city evaluates at the native 1024x2048 (the
    # whole-frame resize is the identity there)
    root = cfg.data_dir if cfg.dataset in ("city", "custom") else ""
    if not train and cfg.dataset == "city":
        crop = (1024, 2048)
    return NativeSegmentationLoader([os.path.join(root, a) for a, _ in ds.pairs],
                                    [os.path.join(root, b) for _, b in ds.pairs],
                                    crop_size=crop, batch_size=cfg.batch_size, train=train,
                                    seed=cfg.seed, ignore=cfg.ignore_index,
                                    rank=mesh.dp_index if mesh else 0,
                                    world=mesh.dp if mesh else 1)


def seg_model_kwargs(cfg: SegConfig) -> dict:
    """The model's keywords, shared with the evaluator: the LR-ASPP pool
    geometry follows the dataset (city (37, 12), pascal and custom (25, 8))."""
    kw = dict(num_classes=cfg.num_classes,
              dataset="pascal" if cfg.dataset in ("pascal", "custom") else "city")
    if cfg.width_scale is not None:
        kw["s"] = cfg.width_scale
    return kw


def seg_loss(logits, label, weights, ignore_index, num_classes, loss_type="ce"):
    """The trainer's loss: the weighted CE with the ignore label, or BCE on
    one-hot targets whose ignored pixels are all-zero rows, weighted per
    class."""
    return seg_step_loss(logits, label, weights, ignore_index, num_classes, loss_type)[0]


def seg_step_loss(logits, label, weights, ignore_index, num_classes, loss_type="ce",
                  mesh: Optional[Mesh] = None):
    """(the loss this rank differentiates, the global batch's loss) of
    :func:`seg_loss`. Under a data-parallel ``mesh`` the CE's normalizer is
    the global batch's weight sum and this rank's loss is ``dp`` times its
    share, so that its gradient's mean over the ranks is the global loss's;
    BCE's elementwise mean over equal row blocks averages to the global one
    as it is."""
    if loss_type == "bce":
        onehot = (label.unsqueeze(-1) == torch.arange(num_classes, device=label.device))
        loss = binary_cross_entropy_with_logits(logits, onehot.to(logits.dtype), weight=weights)
        return loss, cross_replica_mean(loss.detach().clone(), mesh)
    num, den = cross_entropy_sums(logits, label, class_weights=weights,
                                  ignore_index=ignore_index)
    den, factor = global_normalizer(den, mesh)
    share = num / torch.clamp(den, min=1e-12)
    if factor == 1.0:
        return share, share.detach()
    return share * factor, mesh.all_reduce(share.detach().clone())


def _weights(class_weights, device):
    return None if class_weights is None else torch.as_tensor(
        np.asarray(class_weights, np.float32), device=device)


def make_seg_train_step(mode: QuantMode, class_weights, ignore_index: int, num_classes: int,
                        input_mean=None, input_std=None, loss_type: str = "ce",
                        mesh: Optional[Mesh] = None):
    """``step(state, batch) -> {"loss", "cm"}`` (device tensors) for one
    phase: forward in ``mode`` with ``train=True``, the loss, backward, the
    optimizer step, and the step's confusion matrix of the argmax. Under a
    data-parallel ``mesh`` the batch is this rank's rows, and the loss and
    the confusion matrix are the global batch's."""
    cache = {}

    def step(state, batch):
        dev = state.device
        with span("step"):
            with span("step.input"):
                if dev not in cache:
                    cache[dev] = _weights(class_weights, dev)
                batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
                image = prep_image(batch["image"], input_mean, input_std)
            with span("step.forward"), data_parallel(mesh):
                logits = state.model(image, mode=mode, train=True, generator=state.generator)
                loss, reported = seg_step_loss(logits, batch["label"], cache[dev],
                                               ignore_index, num_classes, loss_type, mesh)
            with span("step.backward"):
                with data_parallel(mesh):
                    state.optimizer.zero_grad(set_to_none=True)
                    loss.backward()
                if mesh is not None:
                    all_reduce_gradients(state.model.parameters(), mesh)
            with span("step.optimizer", device=dev):
                state.optimizer.step()
            state.step += 1
            with span("step.metrics"):
                cm = confusion_matrix(logits.detach().argmax(-1), batch["label"], num_classes,
                                      ignore_index)
                return {"loss": reported.to(torch.float32), "cm": _summed(cm, mesh)}

    return step


def _summed(cm: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """A confusion matrix summed over the data-parallel ranks (int64)."""
    return mesh.all_reduce(cm) if mesh is not None else cm


def make_seg_eval_step(mode: QuantMode, num_classes: int, ignore_index: int,
                       input_mean=None, input_std=None):
    """``step(state, batch) -> cm`` without updates (``train=False``)."""

    @torch.no_grad()
    def step(state, batch):
        dev = state.device
        batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        logits = state.model(prep_image(batch["image"], input_mean, input_std), mode=mode)
        return confusion_matrix(logits.argmax(-1), batch["label"], num_classes, ignore_index)

    return step


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def evaluate_seg(state, dataset, device, mode: QuantMode, cfg: SegConfig, max_steps=None,
                 mesh: Optional[Mesh] = None):
    """mIoU of ``mode`` over ``dataset`` (``miou``, per-class ``iou``,
    ``images_per_sec``, the confusion matrix ``cm``). INT8 freezes the
    model's current state first. Under a data-parallel ``mesh`` each rank
    evaluates its rows and the confusion matrix is summed over the ranks
    (int64: the one-process matrix, so the same mIoU bit for bit)."""
    eval_step = make_seg_eval_step(mode, cfg.num_classes, cfg.ignore_index)
    cm = torch.zeros((cfg.num_classes, cfg.num_classes), dtype=torch.int64, device=device)
    n_images = 0
    _sync(device)
    t0 = time.perf_counter()
    for i, batch in enumerate(prefetch_to_device(iter(dataset), device)):
        if max_steps is not None and i >= max_steps:
            break
        if i == 0 and mode.int8:
            state.model.eval()
            state.model.prepare_int8(device)
        cm += eval_step(state, batch)
        n_images += batch["image"].shape[0]
    cm = _summed(cm, mesh).cpu()
    _sync(device)
    iou, miou = miou_from_confusion(cm)
    replicas = mesh.dp if mesh is not None and mesh.distributed else 1
    return {"miou": float(miou), "iou": iou.numpy(), "cm": cm.numpy(),
            "images_per_sec": n_images * replicas / max(time.perf_counter() - t0, 1e-9)}


def _run_epoch(step_fn, state, dataset, device, cfg: SegConfig, replicas: int = 1):
    """One epoch: mean loss, mIoU of the train predictions, images/s (the
    device synchronized at the end; all ``replicas``' images) and each
    step's host wall ms."""
    losses, step_ms, n_images = [], [], 0
    cm = torch.zeros((cfg.num_classes, cfg.num_classes), dtype=torch.int64, device=device)
    _sync(device)
    t0 = last = time.perf_counter()
    for i, batch in enumerate(prefetch_to_device(iter(dataset), device)):
        if cfg.steps_per_epoch and i >= cfg.steps_per_epoch:
            break
        m = step_fn(state, batch)
        losses.append(m["loss"])
        cm += m["cm"]
        n_images += batch["image"].shape[0]
        now = time.perf_counter()
        step_ms.append((now - last) * 1e3)
        last = now
    losses = torch.stack(losses).cpu().tolist()
    cm = cm.cpu()
    _sync(device)
    _, miou = miou_from_confusion(cm)
    return {"loss": float(np.mean(losses)), "losses": losses, "miou": float(miou),
            "images_per_sec": n_images * replicas / max(time.perf_counter() - t0, 1e-9),
            "step_ms": step_ms}


def main(cfg: SegConfig):
    """Train and evaluate; returns ``(state, results)``: the final ``qat``
    and ``int8`` mIoU records, each epoch's summary (``history``) and, on a
    resume, what was restored (``resumed``)."""
    cfg = resolve_dataset_defaults(cfg)
    multihost.initialize(cfg.device)  # torchrun's ranks; a no-op in one process
    mesh = make_mesh()  # every rank on 'dp', as JAX's make_mesh()
    if cfg.batch_size % mesh.dp:
        raise ValueError(f"batch_size {cfg.batch_size} does not split over {mesh.dp} ranks")
    device = resolve_device(multihost.local_device(cfg.device))
    primary = multihost.is_primary()
    os.makedirs(cfg.save_dir, exist_ok=True)
    logger = (MetricLogger(cfg.save_dir, name="seg") if primary
              else MetricLogger(None, name="seg", echo=False))
    if primary:
        with open(os.path.join(cfg.save_dir, "arguments.json"), "w") as f:
            json.dump(dataclasses.asdict(cfg), f, indent=2)

    train_ds = build_seg_dataset(cfg, True, mesh)
    val_ds = build_seg_dataset(cfg, False, mesh)
    steps_per_epoch = cfg.steps_per_epoch or len(train_ds)
    total_steps = (cfg.fp_epochs + cfg.epochs) * steps_per_epoch
    model = get_seg_model(cfg.model, **seg_model_kwargs(cfg))
    sched_kw = {"power": cfg.power} if cfg.scheduler == "poly" else {}
    schedule = get_lr_scheduler(cfg.scheduler, base_lr=cfg.learning_rate,
                                total_steps=total_steps, **sched_kw)
    tx = get_optimizer(cfg.optim, schedule, weight_decay=grouped_weight_decay(cfg.weight_decay),
                       **({"clip_by": cfg.clip_by} if cfg.optim.startswith("Q") else {}))
    class_weights = CITYSCAPES_CLASS_WEIGHTS if cfg.dataset == "city" else None
    state = create_train_state(model, tx, seed=cfg.seed, device=device)

    start_epoch, best, resumed = 0, -1.0, None
    ckpt_path = os.path.join(cfg.save_dir, "checkpoint")
    meta_path = os.path.join(cfg.save_dir, "checkpoint_meta.json")
    if cfg.resume and os.path.exists(meta_path):
        restore_checkpoint(ckpt_path, state)
        with open(meta_path) as f:
            meta = json.load(f)
        start_epoch, best = meta["qat_epoch"], meta["best_miou"]
        resumed = {"qat_epoch": start_epoch, "step": int(state.step)}
    replicate(state.model, mesh)  # rank 0's parameters and buffers on every rank
    logger.info(f"mesh {mesh.shape}, device {device}")

    history = []

    def run(step_fn, tag, epoch):
        summary = _run_epoch(step_fn, state, train_ds, device, cfg, mesh.dp)
        history.append({"tag": tag, "epoch": epoch, **summary})
        logger.log_scalars({f"{tag}/loss": summary["loss"], f"{tag}/miou": summary["miou"]},
                           step=int(state.step))
        logger.info(f"[{tag} {epoch}] loss={summary['loss']:.4f} miou={summary['miou']:.4f} "
                    f"{summary['images_per_sec']:.1f} images/s")

    step_kw = dict(loss_type=cfg.loss_type, mesh=mesh)
    if resumed:
        logger.info(f"resumed from {ckpt_path} at qat epoch {start_epoch} "
                    f"(step {state.step}, best_miou {best:.4f})")
    else:
        fp_step = make_seg_train_step(FP32, class_weights, cfg.ignore_index, cfg.num_classes,
                                      **step_kw)
        for epoch in range(cfg.fp_epochs):
            run(fp_step, "fp_warmup", epoch)
    state.start_qat()  # idempotent on a resume

    qat_step = make_seg_train_step(QAT, class_weights, cfg.ignore_index, cfg.num_classes,
                                   **step_kw)
    for epoch in range(start_epoch, cfg.epochs):
        run(qat_step, "qat", epoch)
        val = evaluate_seg(state, val_ds, device, QAT_FROZEN, cfg, cfg.steps_per_epoch, mesh)
        history[-1]["val"] = val
        logger.log_scalars({"val/miou": val["miou"]}, step=int(state.step))
        logger.info(f"[val {epoch}] miou={val['miou']:.4f}")
        improved = val["miou"] > best
        best = max(best, val["miou"])
        if primary:
            save_checkpoint(ckpt_path, state)
            if improved:
                save_checkpoint(os.path.join(cfg.save_dir, "best"), state)
            with open(meta_path, "w") as f:
                json.dump({"qat_epoch": epoch + 1, "best_miou": float(best)}, f)

    qat = evaluate_seg(state, val_ds, device, QAT_FROZEN, cfg, cfg.steps_per_epoch, mesh)
    int8 = evaluate_seg(state, val_ds, device, INT8, cfg, cfg.steps_per_epoch, mesh)
    logger.info(f"mIoU(QAT sim)={qat['miou']:.4f}  mIoU(INT8 frozen)={int8['miou']:.4f}")
    logger.close()
    multihost.wait_for_end(mesh)
    return state, {"qat": qat, "int8": int8, "history": history, "resumed": resumed}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    for f in dataclasses.fields(SegConfig):
        kind = {"int": int, "Optional[int]": int, "float": float, "Optional[float]": float,
                "bool": lambda s: s.lower() in ("1", "true")}.get(f.type, str)
        p.add_argument(f"--{f.name}", type=kind, default=None)
    return p


def config_from_args(args) -> SegConfig:
    cfg = SegConfig()
    for f in dataclasses.fields(SegConfig):
        v = getattr(args, f.name, None)
        if v is not None:
            setattr(cfg, f.name, v)
    return cfg


def cli(argv=None):
    main(config_from_args(build_parser().parse_args(argv)))


if __name__ == "__main__":
    cli()
