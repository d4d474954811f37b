"""Classification QAT trainer: StatAssist FP32 warm-up, then GradBoost QAT
(``frostnet_tpu/train/classification.py``).

The flow of the JAX trainer and of the reference's Classification/train.py:
build the model, the schedule and the optimizer (grouped weight decay) ->
FP32 warm-up epochs -> ``state.start_qat()`` (``is_warmup = False``) -> QAT
epochs with the per-iteration schedule, a QAT_FROZEN validation after each,
the ``checkpoint`` and ``best`` directories and ``checkpoint_meta.json`` ->
the dual accuracy: QAT_FROZEN and INT8. The INT8 evaluation freezes the
current state in process (``prepare_int8``) right before it runs, after the
last change to weights and observers.

It runs on the card unless ``--device cpu`` is given. ``--loader native``
reads the image folders ``data_dir/dataset/{train,val}`` with the C++ pool
(``native/``: uint8 batches, normalized on the device); it needs g++,
libjpeg and libpng, and raises where they are missing (no fallback).

Data parallelism: under ``torchrun`` each rank trains on ``cuda:LOCAL_RANK``
(ranks beyond the host's cards share them, over gloo) with its block of
each global batch of ``batch_size`` rows, the state replicated from rank 0,
the global batch's BN statistics, observers and gradient (``parallel/``);
evaluation counts are all-reduced, and checkpoints,
``checkpoint_meta.json`` and the metric log come from rank 0 only.
``--mp N`` does what JAX's trainer does: a ``dp x mp`` mesh with the
parameters replicated and the rows split over ``dp`` (the ``mp`` ranks of a
``dp`` index train the same rows); the sharded tensor-parallel step is
``parallel.shard_params_for_mp``, which the trainer does not apply, as JAX's
does not.

Run: python -m frostnet_tpu_torch.train.classification --config cfg.json
     python -m frostnet_tpu_torch.train.classification --dataset synthetic --epochs 1
     torchrun --nproc_per_node 2 -m frostnet_tpu_torch.train.classification --dataset synthetic
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Optional

import torch

from ..data import SyntheticClassification, build_classification_dataset, prefetch_to_device
from ..models import create_model
from ..nn import FP32, INT8, QAT, QAT_FROZEN
from ..optim import get_lr_scheduler, get_optimizer, grouped_weight_decay, learning_rate
from ..parallel import Mesh, make_mesh, multihost, rank_rows, replicate
from ..quant.freeze import resolve_device
from ..utils.checkpoint import restore_checkpoint, save_checkpoint
from ..utils.logging import MetricLogger
from ..utils.metrics import AverageMeter
from .state import create_train_state, make_eval_step, make_train_step


def flatten_reference_json(raw: dict, aliases: dict, ignored=frozenset()) -> dict:
    """Flatten the reference's setting/*.json layout (nested ``*_config``
    sections) and normalize its key spellings and dataset names; shared by
    the trainer's ``from_json`` and the evaluator's ``-c`` loader."""
    flat = {}
    for k, v in raw.items():
        if isinstance(v, dict) and k.endswith("_config"):
            flat.update(v)
        else:
            flat[k] = v
    out = {}
    for k, v in flat.items():
        k = aliases.get(k, k)
        if k in ignored:
            continue
        if k == "dataset":
            v = {"ILSVRC2015": "imagenet"}.get(v, v)
        out[k] = v
    return out


@dataclasses.dataclass
class ClassificationConfig:
    """The knobs of the reference's setting/train.json and of the CLI."""

    model: str = "frostnet_quant_small_1_0"
    dataset: str = "synthetic"
    data_dir: str = "./data"
    loader: str = "python"       # "native": the C++ pool (native/)
    num_classes: int = 1000
    image_size: int = 224
    batch_size: int = 64
    epochs: int = 2              # QAT epochs
    fp_epochs: int = 1           # StatAssist warm-up epochs (FP_epoch)
    optim: str = "QSGD"
    learning_rate: float = 0.04
    weight_decay: float = 4e-5
    clip_by: float = 1e-3
    toss_coin: bool = True
    noise_decay: float = 1e-2
    nesterov: bool = False
    lrsch: str = "cos_lr"
    annealing: bool = False      # cyclic cos/linear restarts every restart_epoch
    restart_epoch: int = 100
    amsgrad: bool = False        # the Adam family's amsgrad variant
    warmup_epochs: int = 0
    warmup_lr: float = 1e-4
    decay_epochs: float = 30.0   # step_lr: 2.4 in the published recipe
    decay_rate: float = 0.1      # step_lr gamma: .97 in the published recipe
    aa: str = ""                 # auto-augment spec for image folders, e.g. "rand-m9-mstd0.5"
    label_smoothing: float = 0.0
    ema_decay: float = 0.0       # 0.9999 in the published recipe
    steps_per_epoch: Optional[int] = None  # cap for smoke runs
    seed: int = 42
    save_dir: str = "./runs/classification"
    log_every: int = 10
    mp: int = 1                  # the mesh's 'mp' axis: a dp x mp mesh, parameters replicated
    resume_path: Optional[str] = None  # an explicit checkpoint directory to restore
    resume: bool = False         # continue from save_dir/checkpoint
    device: str = "cuda"         # "cpu" runs the kernels' plain versions

    # reference setting/train.json key -> field
    _JSON_ALIASES = {
        "Model": "model", "FP_epoch": "fp_epochs",
        "warmup_epoch": "warmup_epochs", "dataset_name": "dataset",
    }
    _JSON_IGNORED = {"num_work", "w", "h", "ignore_idx"}  # loader knobs n/a

    @classmethod
    def from_json(cls, path):
        """Our flat JSON, or the reference's setting/train.json layout
        (nested train_config/data_config sections, Model/FP_epoch/...
        spellings, resume as a checkpoint path)."""
        with open(path) as f:
            raw = json.load(f)
        flat = flatten_reference_json(raw, cls._JSON_ALIASES, cls._JSON_IGNORED)
        known = {f.name for f in dataclasses.fields(cls)}
        out = {}
        for k, v in flat.items():
            if k == "resume" and isinstance(v, str):
                # the reference uses "" or an explicit checkpoint path
                if v:
                    out["resume_path"] = v
                v = bool(v)
            if k in known:
                out[k] = v
        return cls(**out)


def _build_dataset(cfg: ClassificationConfig, train: bool, mesh: Optional[Mesh] = None):
    """The train or val batches, this rank's rows of each under a
    data-parallel ``mesh``: the native pool decodes only those, the other
    loaders build the global batch and keep them."""
    seed = cfg.seed + (0 if train else 1)
    if cfg.dataset == "synthetic":
        ds = SyntheticClassification(
            num_classes=cfg.num_classes, image_size=cfg.image_size,
            length=cfg.batch_size * (cfg.steps_per_epoch or 8),
            batch_size=cfg.batch_size, seed=seed)
    elif cfg.loader == "native":
        from ..native import NativeClassificationLoader

        # uint8 batches: 4x less host->device traffic, normalized on the
        # device (state.prep_image); a failed build raises, no fallback
        return NativeClassificationLoader.from_folder(
            os.path.join(cfg.data_dir, cfg.dataset, "train" if train else "val"),
            batch_size=cfg.batch_size, image_size=cfg.image_size, train=train, seed=seed,
            output="uint8", rank=mesh.dp_index if mesh else 0, world=mesh.dp if mesh else 1)
    else:
        ds = build_classification_dataset(
            cfg.dataset, cfg.data_dir, train, image_size=cfg.image_size,
            batch_size=cfg.batch_size, seed=seed, aa=cfg.aa)
    return rank_rows(ds, mesh)


def _schedule(cfg: ClassificationConfig, steps_per_epoch: int):
    """The per-iteration schedule over all ``fp_epochs + epochs``."""
    total_steps = (cfg.fp_epochs + cfg.epochs) * steps_per_epoch
    warmup = dict(warmup_steps=cfg.warmup_epochs * steps_per_epoch, warmup_lr=cfg.warmup_lr)
    if cfg.lrsch in ("cos_lr", "linear_lr"):
        if cfg.annealing:  # cyclic restarts (helper_functions.py:231-249)
            warmup = dict(warmup, restart_period=cfg.restart_epoch * steps_per_epoch)
        return get_lr_scheduler(cfg.lrsch, base_lr=cfg.learning_rate, total_steps=total_steps,
                                **warmup)
    if cfg.lrsch == "step_lr":
        # the published recipe: --sched step --decay-epochs 2.4 --decay-rate .97
        return get_lr_scheduler(cfg.lrsch, base_lr=cfg.learning_rate,
                                steps_per_epoch=steps_per_epoch, decay_epochs=cfg.decay_epochs,
                                gamma=cfg.decay_rate, **warmup)
    return get_lr_scheduler(cfg.lrsch, base_lr=cfg.learning_rate, total_steps=total_steps)


def _optimizer(cfg: ClassificationConfig, schedule):
    kwargs = {}
    if cfg.optim.startswith("Q"):
        kwargs = dict(clip_by=cfg.clip_by, toss_coin=cfg.toss_coin,
                      noise_decay=cfg.noise_decay, seed=cfg.seed)
    if cfg.optim in ("SGD", "QSGD"):
        kwargs["nesterov"] = cfg.nesterov
    if cfg.optim in ("Adam", "QAdam", "AdamW", "QAdamW"):
        kwargs["amsgrad"] = cfg.amsgrad
    wd = grouped_weight_decay(cfg.weight_decay)
    return get_optimizer(cfg.optim, schedule, weight_decay=wd, **kwargs)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _meters(pending, meters):
    """Fold the device metrics of the steps since the last read into the
    meters (one host read for all of them)."""
    if not pending:
        return meters
    keys = list(pending[0][0])
    values = torch.stack([torch.stack([m[k].to(torch.float32) for k in keys])
                          for m, _ in pending]).cpu().tolist()
    for row, (_, n) in zip(values, pending):
        for k, v in zip(keys, row):
            meters.setdefault(k, AverageMeter()).update(v, n)
    pending.clear()
    return meters


def _run_epoch(step_fn, state, dataset, device, epoch, tag, logger, log_every, max_steps=None,
               replicas: int = 1):
    """One epoch of ``step_fn``; the summary has the metrics' averages,
    ``images_per_sec`` (the device synchronized at the end; all
    ``replicas``' images) and each step's host wall time in ms
    (``step_ms``)."""
    meters, pending, step_ms = {}, [], []
    _sync(device)
    t0 = last = time.perf_counter()
    n_images = 0
    for i, batch in enumerate(prefetch_to_device(iter(dataset), device)):
        if max_steps is not None and i >= max_steps:
            break
        metrics = step_fn(state, batch)
        n = batch["image"].shape[0]
        n_images += n
        pending.append((metrics, n))
        now = time.perf_counter()
        step_ms.append((now - last) * 1e3)
        last = now
        if (i + 1) % log_every == 0:
            _meters(pending, meters)
            logger.log_scalars({f"{tag}/{k}": m.avg for k, m in meters.items()},
                               step=int(state.step))
    _meters(pending, meters)
    _sync(device)
    dt = time.perf_counter() - t0
    summary = {k: m.avg for k, m in meters.items()}
    summary["images_per_sec"] = n_images * replicas / max(dt, 1e-9)
    summary["step_ms"] = step_ms
    return state, summary


def evaluate(state, dataset, device, mode, num_classes, max_steps=None, use_ema=False,
             image_size: Optional[int] = None, mesh: Optional[Mesh] = None):
    """Average metrics of ``mode`` over ``dataset`` (``images_per_sec``
    too). INT8 freezes the model's current state first (``prepare_int8``
    at ``image_size``, by default the first batch's). Under a data-parallel
    ``mesh`` each rank evaluates its rows, and the sums and counts are
    all-reduced."""
    eval_step = make_eval_step(mode, num_classes, use_ema=use_ema)
    meters, pending, n_images = {}, [], 0
    _sync(device)
    t0 = time.perf_counter()
    for i, batch in enumerate(prefetch_to_device(iter(dataset), device)):
        if max_steps is not None and i >= max_steps:
            break
        if i == 0 and mode.int8:
            state.model.eval()
            state.model.prepare_int8(device, image_size or int(batch["image"].shape[1]))
        n = batch["image"].shape[0]
        n_images += n
        pending.append((eval_step(state, batch), n))
    _meters(pending, meters)
    _sync(device)
    if mesh is not None and mesh.distributed:
        keys = sorted(meters)
        sums = torch.tensor([[meters[k].sum, meters[k].count] for k in keys] + [[n_images, 0]],
                            dtype=torch.float64, device=device)
        sums = mesh.all_reduce(sums).tolist()
        for k, (total, count) in zip(keys, sums):
            meters[k].sum, meters[k].count = total, count
        n_images = int(sums[-1][0])
    out = {k: m.avg for k, m in meters.items()}
    out["images_per_sec"] = n_images / max(time.perf_counter() - t0, 1e-9)
    return out


def main(cfg: ClassificationConfig):
    """Train and evaluate; returns ``(state, results)``: ``results`` has the
    final ``qat`` and ``int8`` metrics, each epoch's summary (``history``)
    and, on a resume, what was restored (``resumed``)."""
    multihost.initialize(cfg.device)  # torchrun's ranks; a no-op in one process
    # JAX's ('dp', 'mp') mesh: the parameters replicated, the rows over 'dp'
    # (the ranks of one dp index train the same rows, as JAX's mp pairs do)
    mesh = make_mesh(mp=cfg.mp)
    if cfg.batch_size % mesh.dp:
        raise ValueError(f"batch_size {cfg.batch_size} does not split over {mesh.dp} ranks")
    device = resolve_device(multihost.local_device(cfg.device))
    primary = multihost.is_primary()
    os.makedirs(cfg.save_dir, exist_ok=True)
    logger = MetricLogger(cfg.save_dir) if primary else MetricLogger(None, echo=False)
    if primary:
        logger.info(f"config: {dataclasses.asdict(cfg)}")

    train_ds = _build_dataset(cfg, train=True, mesh=mesh)
    val_ds = _build_dataset(cfg, train=False, mesh=mesh)
    steps_per_epoch = cfg.steps_per_epoch or len(train_ds)
    model = create_model(cfg.model, num_classes=cfg.num_classes, image_size=cfg.image_size)
    tx = _optimizer(cfg, _schedule(cfg, steps_per_epoch))
    state = create_train_state(model, tx, seed=cfg.seed, device=device, ema_decay=cfg.ema_decay)

    start_epoch, best_top1, resumed = 0, -1.0, None
    ckpt_path = os.path.join(cfg.save_dir, "checkpoint")
    meta_path = os.path.join(cfg.save_dir, "checkpoint_meta.json")
    restore_from = cfg.resume_path or ckpt_path
    restore_meta = (os.path.join(os.path.dirname(os.path.abspath(restore_from)),
                                 "checkpoint_meta.json") if cfg.resume_path else meta_path)
    if (cfg.resume or cfg.resume_path) and os.path.exists(restore_meta):
        restore_checkpoint(restore_from, state)
        with open(restore_meta) as f:
            meta = json.load(f)
        start_epoch, best_top1 = meta["qat_epoch"], meta["best_top1"]
        group = state.optimizer.param_groups[0]
        gen = getattr(state.optimizer, "generator", None)
        resumed = {"qat_epoch": start_epoch, "step": int(state.step), "count": group["count"],
                   "lr": learning_rate(group),
                   "noise_generator": None if gen is None else gen.get_state()}
    replicate(state.model, mesh)  # rank 0's parameters and buffers on every rank
    if state.ema is not None:
        replicate(state.ema, mesh)
    n_params = sum(p.numel() for p in state.model.parameters())
    logger.info(f"model {cfg.model}: {n_params / 1e6:.2f}M params, device {device}, "
                f"mesh {mesh.shape}")

    history = []
    # StatAssist FP32 warm-up (reference train.py:149-160)
    if resumed:
        logger.info(f"resumed from {restore_from} at qat epoch {start_epoch} "
                    f"(step {state.step}, best_top1 {best_top1:.4f})")
    else:
        fp_step = make_train_step(FP32, num_classes=cfg.num_classes,
                                  label_smoothing=cfg.label_smoothing, ema_decay=cfg.ema_decay,
                                  mesh=mesh)
        for epoch in range(cfg.fp_epochs):
            state, summary = _run_epoch(fp_step, state, train_ds, device, epoch, "fp_warmup",
                                        logger, cfg.log_every, cfg.steps_per_epoch, mesh.dp)
            history.append({"tag": "fp_warmup", "epoch": epoch, **summary})
            logger.info(f"[fp_warmup {epoch}] {_brief(summary)}")

    # is_warmup = False (train.py:162-163); idempotent on a resume
    state.start_qat()
    if not resumed:
        logger.info("exp_sensitivity calibration fin. -> QAT phase")

    # QAT epochs (train.py:178-236)
    qat_step = make_train_step(QAT, num_classes=cfg.num_classes,
                               label_smoothing=cfg.label_smoothing, ema_decay=cfg.ema_decay,
                               mesh=mesh)
    for epoch in range(start_epoch, cfg.epochs):
        state, summary = _run_epoch(qat_step, state, train_ds, device, epoch, "qat", logger,
                                    cfg.log_every, cfg.steps_per_epoch, mesh.dp)
        val = evaluate(state, val_ds, device, QAT_FROZEN, cfg.num_classes, cfg.steps_per_epoch,
                       mesh=mesh)
        history.append({"tag": "qat", "epoch": epoch, **summary, "val": val})
        logger.log_scalars({f"val/{k}": v for k, v in val.items() if k != "images_per_sec"},
                           step=int(state.step))
        logger.info(f"[qat {epoch}] train {_brief(summary)} val {_brief(val)}")
        improved = val.get("top1", 0.0) > best_top1
        best_top1 = max(best_top1, val.get("top1", 0.0))
        if primary:
            save_checkpoint(ckpt_path, state)
            if improved:
                save_checkpoint(os.path.join(cfg.save_dir, "best"), state)
            with open(meta_path, "w") as f:
                json.dump({"qat_epoch": epoch + 1, "best_top1": float(best_top1)}, f)

    # the dual accuracy (evaluate.py:129-138); INT8 freezes the final state
    qat_metrics = evaluate(state, val_ds, device, QAT_FROZEN, cfg.num_classes,
                           cfg.steps_per_epoch, mesh=mesh)
    int8_metrics = evaluate(state, val_ds, device, INT8, cfg.num_classes, cfg.steps_per_epoch,
                            image_size=cfg.image_size, mesh=mesh)
    logger.info(f"Accuracy(QAT sim): {_brief(qat_metrics)}")
    logger.info(f"Accuracy(INT8 frozen): {_brief(int8_metrics)}")
    logger.close()
    return state, {"qat": qat_metrics, "int8": int8_metrics, "history": history,
                   "resumed": resumed}


def _brief(summary: dict) -> dict:
    return {k: v for k, v in summary.items() if k != "step_ms"}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", "-c", type=str, default=None)
    for f in dataclasses.fields(ClassificationConfig):
        if f.type in ("int", "Optional[int]"):
            p.add_argument(f"--{f.name}", type=int, default=None)
        elif f.type == "float":
            p.add_argument(f"--{f.name}", type=float, default=None)
        elif f.type == "bool":
            p.add_argument(f"--{f.name}", type=lambda s: s.lower() in ("1", "true"),
                           default=None)
        else:
            p.add_argument(f"--{f.name}", type=str, default=None)
    return p


def config_from_args(args) -> ClassificationConfig:
    cfg = ClassificationConfig.from_json(args.config) if args.config else ClassificationConfig()
    for f in dataclasses.fields(ClassificationConfig):
        v = getattr(args, f.name, None)
        if v is not None:
            setattr(cfg, f.name, v)
    return cfg


def cli(argv=None):
    main(config_from_args(build_parser().parse_args(argv)))


if __name__ == "__main__":
    cli()
