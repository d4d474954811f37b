"""Standalone classification evaluator (``frostnet_tpu/train/evaluate.py``).

Restores a trainer checkpoint's model variables (or, without one,
calibrates with one QAT train step), optionally swaps the EMA weights in and
recalibrates the BN statistics and observers on ``--calib_batches`` batches,
then reports the dual accuracy, Accuracy(QAT sim) and Accuracy(INT8 frozen),
the frozen INT8 model's size, can print the numeric suite's per-layer
report (``--layer_report N``, ``quant/numeric_suite.py``) and can write the
INT8 artifact (``--export_int8``, the layout of the JAX package's
``export_int8``).

Under ``torchrun`` each rank evaluates its block of every batch on
``cuda:LOCAL_RANK`` and the counts are all-reduced (QAT_FROZEN and INT8
alike); the calibration step, without a checkpoint, takes the global
batch's statistics; the reports and the artifact come from rank 0.

Run: python -m frostnet_tpu_torch.train.evaluate --model frostnet_quant_small_0_35 \\
       --checkpoint runs/classification/best --dataset synthetic [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os

import torch

from ..data import FolderClassification, SyntheticClassification, prefetch_to_device
from ..models import create_model
from ..nn import INT8, QAT, QAT_FROZEN
from ..optim import get_optimizer
from ..parallel import make_mesh, multihost, rank_rows, replicate
from ..quant import export_int8
from ..quant.freeze import resolve_device
from ..utils.checkpoint import restore_model_variables
from ..utils.logging import MetricLogger
from .classification import evaluate, flatten_reference_json
from .state import create_train_state, make_train_step, prep_image, recalibrate


def int8_model_size_bytes(model) -> int:
    """Size of the frozen INT8 parameter set: int8 conv kernels, float32
    everything else (the qnnpack state dict of the reference's
    evaluate.py:117-120)."""
    return sum(p.numel() * (1 if p.ndim == 4 else 4) for p in model.parameters())


def main(args):
    multihost.initialize(getattr(args, "device", "cuda"))  # torchrun's ranks, if any
    mesh = make_mesh()
    primary = multihost.is_primary()
    logger = MetricLogger(None, name="evaluate", echo=primary)
    device = resolve_device(multihost.local_device(getattr(args, "device", "cuda")))
    model = create_model(args.model, num_classes=args.num_classes, image_size=args.image_size)
    if args.dataset == "synthetic":
        ds = SyntheticClassification(args.num_classes, args.image_size, args.batch_size * 4,
                                     args.batch_size, 1)
    else:
        ds = FolderClassification(os.path.join(args.data_dir, args.dataset, "val"),
                                  args.image_size, args.batch_size, train=False)
    ds = rank_rows(ds, mesh)
    state = create_train_state(model, get_optimizer("QSGD", 1e-3), seed=0, device=device)
    if args.checkpoint:
        restore_model_variables(args.checkpoint, state)
    replicate(state.model, mesh)
    if not args.checkpoint:
        # calibration: one train iteration (evaluate.py:108-110)
        step = make_train_step(QAT, num_classes=args.num_classes, mesh=mesh)
        step(state, next(iter(prefetch_to_device(iter(ds), device))))
    if args.use_ema:
        if state.ema is None:
            logger.info("--use_ema requested but the checkpoint has no EMA parameters; "
                        "evaluating the raw weights")
        else:
            # calibration and evaluation must see the same weights: swap the
            # EMA in before the recalibration, so that the BN statistics, the
            # observers and the INT8 freeze describe the weights evaluated
            with torch.no_grad():
                for n, p in state.model.named_parameters():
                    p.copy_(state.ema[n])
    if args.calib_batches:
        # forward-only BN and observer re-estimation, no optimizer update
        batches = []
        for i, b in enumerate(prefetch_to_device(iter(ds), device)):
            if i >= args.calib_batches:
                break
            batches.append(b)
        recalibrate(state, batches, mesh=mesh)

    qat = evaluate(state, ds, device, QAT_FROZEN, args.num_classes, mesh=mesh)
    int8 = evaluate(state, ds, device, INT8, args.num_classes, image_size=args.image_size,
                    mesh=mesh)
    logger.info(f"Accuracy(QAT sim): top1={qat.get('top1', 0):.4f} "
                f"top5={qat.get('top5', 0):.4f}")
    logger.info(f"Accuracy(INT8 frozen): top1={int8.get('top1', 0):.4f} "
                f"top5={int8.get('top5', 0):.4f}")
    size_mb = int8_model_size_bytes(state.model) / 1e6
    logger.info(f"INT8 model size: {size_mb:.2f} MB")
    out = {"qat": qat, "int8": int8, "int8_size_mb": size_mb, "state": state}
    if args.layer_report:
        # per-layer INT8 against QAT_FROZEN (the numeric suite): when the dual
        # accuracies disagree, this names the layer responsible
        from ..quant.numeric_suite import compare_modes, format_report
        batch = next(iter(prefetch_to_device(iter(ds), device)))
        out["layer_report"] = compare_modes(state.model, prep_image(batch["image"]))
        logger.info("per-layer INT8 vs QAT_FROZEN (worst first):\n"
                    + format_report(out["layer_report"], args.layer_report))
    if args.export_int8 and primary:
        nbytes = export_int8(state.model, args.export_int8)
        logger.info(f"INT8 artifact written: {args.export_int8} ({nbytes / 1e6:.2f} MB)")
        out["export_bytes"] = nbytes
    return out


_JSON_ALIASES = {"Model": "model", "weight_name": "checkpoint", "dataset_name": "dataset"}


def _json_defaults(path):
    """The reference's setting/evaluate.json (nested test_config and
    data_config, Model/weight_name spellings) as argparse defaults; explicit
    flags still win."""
    with open(path) as f:
        raw = json.load(f)
    out = flatten_reference_json(raw, _JSON_ALIASES)
    if not out.get("checkpoint"):
        out.pop("checkpoint", None)  # weight_name "" means no checkpoint
    return out


def build_parser(argv=None) -> argparse.ArgumentParser:
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("-c", "--config", default=None,
                     help="reference-style evaluate.json (setting/*.json layout accepted)")
    cfg_args, _ = pre.parse_known_args(argv)
    p = argparse.ArgumentParser(description=__doc__, parents=[pre],
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model", default="frostnet_quant_large_1_0")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--dataset", default="synthetic")
    p.add_argument("--data_dir", default="./data")
    p.add_argument("--num_classes", type=int, default=1000)
    p.add_argument("--image_size", type=int, default=224)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--use_ema", action="store_true",
                   help="evaluate the EMA weights (swapped in before the recalibration)")
    p.add_argument("--calib_batches", type=int, default=0,
                   help="forward-only BN/observer recalibration batches before eval")
    p.add_argument("--export_int8", default=None, metavar="PATH",
                   help="write the converted INT8 deployment artifact (.npz)")
    p.add_argument("--layer_report", type=int, default=0, metavar="N",
                   help="print the numeric suite's N worst layers (INT8 vs QAT_FROZEN)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    if cfg_args.config:
        known = {a.dest for a in p._actions}
        p.set_defaults(**{k: v for k, v in _json_defaults(cfg_args.config).items()
                          if k in known})
    return p


def cli(argv=None):
    main(build_parser(argv).parse_args(argv))


if __name__ == "__main__":
    cli()
