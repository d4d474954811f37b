"""Segmentation evaluator (``frostnet_tpu/segmentation/evaluate.py``).

Restores a trainer checkpoint's model variables (``--checkpoint``) or,
without one, calibrates with one QAT train step, optionally writes the INT8
artifact (``--export_int8``, the JAX package's layout), then reports the
dual mIoU: mIoU(QAT sim) and mIoU(INT8 frozen). ``--save_images`` writes
colorized predictions and their Cityscapes label ids as PNGs (PIL).

Under ``torchrun`` it runs JAX's mesh (``make_mesh()``): each rank
evaluates its rows of each batch, the confusion matrices are summed over
the ranks (int64, so the dual mIoU is the one-process value bit for bit),
the calibration step is the data-parallel one, and rank 0 alone writes the
artifact, the PNGs and the log.

Run: python -m frostnet_tpu_torch.segmentation.evaluate --model mobilenetv3_RE_small \\
       --checkpoint runs/segmentation/best --dataset synthetic [--device cpu]
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..data import prefetch_to_device
from ..nn import INT8, QAT, QAT_FROZEN
from ..optim import get_optimizer
from ..parallel import make_mesh, multihost, rank_rows, replicate
from ..quant import export_int8
from ..quant.freeze import resolve_device
from ..train.state import create_train_state
from ..utils.checkpoint import restore_model_variables
from ..utils.logging import MetricLogger
from .data import CityscapesSegmentation, CustomSegmentation, SyntheticSegmentation, \
    VOCSegmentation, _pil_image
from .models import get_seg_model
from .train import (SegConfig, evaluate_seg, make_seg_train_step, resolve_dataset_defaults,
                    seg_model_kwargs)

# the Cityscapes train-id palette (the reference's utilities/color_map.py)
CITYSCAPES_PALETTE = np.array([
    [128, 64, 128], [244, 35, 232], [70, 70, 70], [102, 102, 156],
    [190, 153, 153], [153, 153, 153], [250, 170, 30], [220, 220, 0],
    [107, 142, 35], [152, 251, 152], [70, 130, 180], [220, 20, 60],
    [255, 0, 0], [0, 0, 142], [0, 0, 70], [0, 60, 100], [0, 80, 100],
    [0, 0, 230], [119, 11, 32]], np.uint8)

# train id -> the original Cityscapes label id (the reference's relabel)
CITYSCAPES_TRAINID_TO_ID = np.array(
    [7, 8, 11, 12, 13, 17, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 31, 32, 33], np.uint8)


def colorize(pred: np.ndarray) -> np.ndarray:
    """(H, W) train ids -> (H, W, 3) uint8 palette colors."""
    return CITYSCAPES_PALETTE[np.clip(pred, 0, len(CITYSCAPES_PALETTE) - 1)]


def relabel(pred: np.ndarray) -> np.ndarray:
    """Train ids -> submission label ids."""
    return CITYSCAPES_TRAINID_TO_ID[np.clip(pred, 0, 18)]


def eval_dataset(cfg: SegConfig, data_dir: str):
    """The evaluator's dataset: validation data, or for ``synthetic`` two
    batches from seed 1 (the trainer's validation set when it runs with
    seed 0 and two steps an epoch)."""
    if cfg.dataset == "synthetic":
        return SyntheticSegmentation(cfg.num_classes, (cfg.crop_size, cfg.crop_size),
                                     cfg.batch_size * 2, cfg.batch_size, 1)
    if cfg.dataset == "pascal":
        return VOCSegmentation(data_dir, train=False, batch_size=cfg.batch_size)
    if cfg.dataset == "custom":
        return CustomSegmentation(data_dir, train=False, crop_size=(cfg.crop_size, cfg.crop_size),
                                  batch_size=cfg.batch_size)
    return CityscapesSegmentation(data_dir, train=False, batch_size=cfg.batch_size)


def main(args):
    """Returns ``{"qat", "int8"}`` mIoUs, the two evaluation records, the
    state and, with ``--export_int8``, the artifact's size in bytes."""
    multihost.initialize(getattr(args, "device", "cuda"))  # torchrun's ranks, if any
    mesh = make_mesh()
    primary = multihost.is_primary()
    logger = MetricLogger(None, name="seg-eval", echo=primary)
    device = resolve_device(multihost.local_device(getattr(args, "device", "cuda")))
    cfg = resolve_dataset_defaults(
        SegConfig(model=args.model, dataset=args.dataset, crop_size=args.crop_size,
                  batch_size=args.batch_size, num_classes=args.num_classes,
                  width_scale=getattr(args, "width_scale", None)))
    if cfg.batch_size % mesh.dp:
        raise ValueError(f"batch_size {cfg.batch_size} does not split over {mesh.dp} ranks")
    model = get_seg_model(cfg.model, **seg_model_kwargs(cfg))
    ds = rank_rows(eval_dataset(cfg, args.data_dir), mesh)
    state = create_train_state(model, get_optimizer("QSGD", 1e-3), seed=0, device=device)
    if args.checkpoint:
        restore_model_variables(args.checkpoint, state)
    replicate(state.model, mesh)
    if not args.checkpoint:
        # calibration: one QAT train iteration (the reference's train_seg_one_iter)
        step = make_seg_train_step(QAT, None, cfg.ignore_index, cfg.num_classes, mesh=mesh)
        step(state, next(iter(prefetch_to_device(iter(ds), device))))
    out = {"state": state}
    if args.export_int8 and primary:
        out["export_bytes"] = export_int8(state.model, args.export_int8)
        logger.info(f"INT8 artifact written: {args.export_int8} "
                    f"({out['export_bytes'] / 1e6:.2f} MB)")

    qat = evaluate_seg(state, ds, device, QAT_FROZEN, cfg, mesh=mesh)
    int8 = evaluate_seg(state, ds, device, INT8, cfg, mesh=mesh)
    logger.info(f"mIoU(QAT sim)={qat['miou']:.4f}  mIoU(INT8 frozen)={int8['miou']:.4f}")
    out.update(qat=qat["miou"], int8=int8["miou"], qat_eval=qat, int8_eval=int8)

    if args.save_images and primary:
        Image = _pil_image()
        os.makedirs(args.save_images, exist_ok=True)
        batch = next(iter(prefetch_to_device(iter(ds), device)))
        with torch.no_grad():
            pred = state.model(batch["image"], mode=INT8).argmax(-1).cpu().numpy()
        for i in range(min(4, pred.shape[0])):
            Image.fromarray(colorize(pred[i])).save(
                os.path.join(args.save_images, f"pred_{i}_color.png"))
            Image.fromarray(relabel(pred[i])).save(
                os.path.join(args.save_images, f"pred_{i}_labelids.png"))
        logger.info(f"prediction PNGs -> {args.save_images}")
    multihost.wait_for_end(mesh)
    return out


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model", default="mobilenetv3_RE_small")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--dataset", default="synthetic")
    p.add_argument("--data_dir", default="./data/cityscapes")
    p.add_argument("--num_classes", type=int, default=None,
                   help="default resolved per dataset (21 pascal / 19 city)")
    p.add_argument("--crop_size", type=int, default=None,
                   help="default resolved per dataset (512 / 768; 96 synthetic)")
    p.add_argument("--batch_size", type=int, default=2)
    p.add_argument("--width_scale", type=float, default=None,
                   help="espnetv2 channel scale (the trainer's --width_scale)")
    p.add_argument("--save_images", default=None)
    p.add_argument("--export_int8", default=None, metavar="PATH",
                   help="write the converted INT8 deployment artifact (.npz)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def cli(argv=None):
    main(build_parser().parse_args(argv))


if __name__ == "__main__":
    cli()
