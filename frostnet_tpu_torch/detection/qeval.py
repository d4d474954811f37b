"""Detection evaluator: VOC mAP in QAT-sim and frozen-INT8 modes
(``frostnet_tpu/detection/qeval.py:28-97``).

Builds the net, fills it with trained variables (``feat_vars`` /
``head_vars``, or ``--checkpoint`` a trainer's ``ssd300_<iter>`` directory;
without either, ``numpy_init`` from the seed as the JAX evaluator's random
init), optionally writes the INT8 artifacts ``PATH_feat.npz`` and
``PATH_head.npz`` (``--export_int8 PATH``, the JAX package's layout, read by
``serve --workload det``), then reports mAP(qat), the QAT_FROZEN forward,
and mAP(int8), the frozen INT8 feature net, each with the float head,
``detect`` and the VOC 11-point AP. It runs on the card unless ``--device
cpu`` is given.

Run: python -m frostnet_tpu_torch.detection.qeval --net_type qssd --dataset synthetic \\
       [--checkpoint runs/detection/ssd300_4] [--export_int8 runs/detection/ssd]
"""
from __future__ import annotations

import argparse

from ..nn import INT8, QAT_FROZEN
from ..optim import get_optimizer
from ..quant import export_int8, from_jax_variables, numpy_init
from ..quant.freeze import resolve_device
from ..train.state import create_train_state
from ..utils.checkpoint import restore_model_variables
from ..utils.logging import MetricLogger
from .anchors import make_priors
from .data import COCODetection, SyntheticDetection, VOCDetection
from .evaluate import evaluate_map
from .models import Detector
from .train import build_net, select_config

MODES = {"qat": QAT_FROZEN, "int8": INT8}


def eval_dataset(dataset: str, data_root: str, num_classes: int, batch_size: int):
    """The evaluator's data: synthetic (seed 1, two batches), COCO val2017 or
    VOC2007 test."""
    if dataset == "synthetic":
        return SyntheticDetection(num_classes - 1, 300, batch_size * 2, batch_size, 1)
    if dataset == "coco":
        return COCODetection(data_root, split="val2017", batch_size=batch_size, train=False)
    return VOCDetection(data_root, image_sets=(("2007", "test"),), batch_size=batch_size,
                        train=False)


def evaluator(net_type="qssd", dataset="synthetic", data_root="./data/VOCdevkit",
              num_classes=None, batch_size=4, max_batches=None, feat_vars=None,
              head_vars=None, modes=("qat", "int8"), export_int8_path=None,
              checkpoint=None, device="cuda"):
    """The reference's ``evaluator(...)`` (qtrainval.py:306-319): returns
    ``{mode: {"mAP", "ap_per_class"}}`` plus ``export_bytes`` when it
    exported. ``num_classes`` defaults from the dataset's config (21 voc /
    201 coco)."""
    logger = MetricLogger(None, name="det-eval")
    device = resolve_device(device)
    det_cfg = select_config(net_type, dataset)
    priors = make_priors(det_cfg)
    num_classes = num_classes or det_cfg["num_classes"]
    feat, head = build_net(net_type, num_classes)
    ds = eval_dataset(dataset, data_root, num_classes, batch_size)
    if checkpoint:
        state = create_train_state(Detector(feat, head), get_optimizer("QSGD", 1e-3),
                                   device=device)
        restore_model_variables(checkpoint, state)
    elif feat_vars is not None:
        from_jax_variables((feat, head), (feat_vars, head_vars))
    else:
        from_jax_variables((feat, head), numpy_init((feat, head), 0))
    feat.to(device)
    head.to(device)

    results = {}
    if export_int8_path:
        fb = export_int8(feat, export_int8_path + "_feat")
        hb = export_int8(head, export_int8_path + "_head")
        results["export_bytes"] = fb + hb
        logger.info(f"INT8 artifacts written: {export_int8_path}_feat/_head "
                    f"({(fb + hb) / 1e6:.2f} MB)")
    for name in modes:
        r = evaluate_map(feat, head, ds, priors, MODES[name], num_classes, device,
                         max_batches=max_batches)
        logger.info(f"mAP({name}) = {r['mAP']:.4f}")
        results[name] = r
    return results


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--net_type", default="qssd", choices=["qssd", "qtdsod"])
    p.add_argument("--dataset", default="synthetic")
    p.add_argument("--data_root", default="./data/VOCdevkit")
    p.add_argument("--num_classes", type=int, default=None,
                   help="defaults from the dataset config (21 voc / 201 coco)")
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--max_batches", type=int, default=None)
    p.add_argument("--checkpoint", default=None,
                   help="a trainer checkpoint directory (save_dir/ssd300_<iter>)")
    p.add_argument("--export_int8", default=None, metavar="PATH",
                   help="write the INT8 deployment artifacts (PATH_feat/_head .npz)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def main(args):
    return evaluator(args.net_type, args.dataset, args.data_root, args.num_classes,
                     args.batch_size, args.max_batches, export_int8_path=args.export_int8,
                     checkpoint=args.checkpoint, device=args.device)


def cli(argv=None):
    main(build_parser().parse_args(argv))


if __name__ == "__main__":
    cli()
