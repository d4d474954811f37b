"""Score pix2pix / CycleGAN Cityscapes outputs with a segmentation network
(``frostnet_tpu/gan/eval_cityscapes.py``; reference
Style_Transfer/scripts/eval_cityscapes/evaluate.py and util.py).

A segmentation scorer runs over the generated ``*_leftImg8bit.png`` images;
a confusion histogram against the ground-truth labels gives the FCN-score
protocol's mean pixel accuracy, mean class accuracy and mean class IoU
(:func:`fast_hist`, :func:`get_scores`: the reference's util.py:23-45,
numpy). The reference scores with a fixed Caffe FCN-8s; here the scorer is
a trained model of the port's segmentation zoo (``--scorer_model``, by
default the port's ``mobilenetv3_RE_small``, and ``--scorer_checkpoint``),
run in QAT_FROZEN on the card unless ``--device cpu``. :func:`score_pairs`
takes any ``(image, label)`` pairs in memory; ``main`` reads the PNGs
through PIL, imported only there.

Run: python -m frostnet_tpu_torch.gan.eval_cityscapes --result_dir results/ \\
       --label_dir cityscapes/gtFine/val --scorer_checkpoint runs/segmentation/best
"""
from __future__ import annotations

import argparse
import os
from typing import Dict, Iterable, Tuple

import numpy as np
import torch


def fast_hist(a: np.ndarray, b: np.ndarray, n: int) -> np.ndarray:
    """Confusion histogram (reference util.py:23-29): rows ground truth,
    columns prediction; ground-truth entries outside [0, n) are ignored."""
    k = np.where((a >= 0) & (a < n))[0]
    if np.any(b[k] >= n) or np.any(b[k] < 0):
        # labels outside [0, n) mean --num_classes does not match the scorer
        raise ValueError(
            f"prediction labels outside [0, {n}): scorer emits up to {int(b[k].max())} - "
            "pass --num_classes matching the scorer checkpoint")
    bc = np.bincount(n * a[k].astype(int) + b[k], minlength=n ** 2)
    return bc.reshape(n, n)


def get_scores(hist: np.ndarray):
    """(mean_pixel_acc, mean_class_acc, mean_class_iou, per_class_acc,
    per_class_iou) - reference util.py:32-45."""
    acc = np.diag(hist).sum() / (hist.sum() + 1e-12)
    cl_acc = np.diag(hist) / (hist.sum(1) + 1e-12)
    iu = np.diag(hist) / (hist.sum(1) + hist.sum(0) - np.diag(hist) + 1e-12)
    return acc, np.nanmean(cl_acc), np.nanmean(iu), cl_acc, iu


def score_pairs(predict_fn, pairs: Iterable[Tuple[np.ndarray, np.ndarray]],
                num_classes: int) -> Dict:
    """Accumulate the per-frame confusion histogram over (image, label)
    pairs and return the scores. ``predict_fn(image_f01) -> (H, W) int``
    segments an image given in [0, 1] RGB at the label's resolution."""
    hist = np.zeros((num_classes, num_classes), np.int64)
    n = 0
    for image, label in pairs:
        pred = np.asarray(predict_fn(image))
        hist += fast_hist(label.flatten(), pred.flatten(), num_classes)
        n += 1
    acc, macc, miou, cl_acc, cl_iou = get_scores(hist)
    return {"frames": n, "mean_pixel_acc": float(acc), "mean_class_acc": float(macc),
            "mean_class_iou": float(miou), "per_class_acc": cl_acc, "per_class_iou": cl_iou,
            "hist": hist}


def make_seg_predict_fn(model, mode, mean, std):
    """The scorer's forward on the model's device: [0, 1] RGB (H, W, 3) ->
    the (H, W) int32 argmax class map, on the host."""
    dev = next(model.parameters()).device
    mean_t = torch.tensor(mean, dtype=torch.float32, device=dev)
    std_t = torch.tensor(std, dtype=torch.float32, device=dev)

    @torch.inference_mode()
    def forward(img):
        x = (torch.as_tensor(np.asarray(img, np.float32), device=dev) - mean_t) / std_t
        logits = model(x[None], mode=mode)
        return logits[0].argmax(-1).to(torch.int32).cpu().numpy()

    return forward


def _iter_result_pairs(result_dir: str, label_dir: str):
    """Yield (generated image [0, 1] float32 at the label's size, label map)."""
    from ..data.datasets import _require_pil

    _require_pil()
    from PIL import Image

    names = sorted(f for f in os.listdir(result_dir) if f.endswith("_leftImg8bit.png"))
    if not names:
        raise FileNotFoundError(f"no *_leftImg8bit.png under {result_dir} (pix2pix test output)")
    for fname in names:
        base = fname[: -len("_leftImg8bit.png")]
        lpath = os.path.join(label_dir, base + "_gtFine_labelTrainIds.png")
        if not os.path.exists(lpath):
            continue
        label = np.asarray(Image.open(lpath), np.int64)
        img = Image.open(os.path.join(result_dir, fname)).convert("RGB")
        img = img.resize((label.shape[1], label.shape[0]), Image.BILINEAR)
        yield np.asarray(img, np.float32) / 255.0, label


def main(args):
    from ..nn import QAT_FROZEN
    from ..optim import get_optimizer
    from ..quant.freeze import resolve_device
    from ..segmentation import get_seg_model
    from ..train import create_train_state

    device = resolve_device(args.device)
    model = get_seg_model(args.scorer_model, num_classes=args.num_classes)
    state = create_train_state(model, get_optimizer("QSGD", 1e-3), seed=0, device=device)
    from ..utils.checkpoint import restore_model_variables
    restore_model_variables(args.scorer_checkpoint, state)
    model.eval()
    predict = make_seg_predict_fn(model, QAT_FROZEN, mean=(0.485, 0.456, 0.406),
                                  std=(0.229, 0.224, 0.225))
    scores = score_pairs(predict, _iter_result_pairs(args.result_dir, args.label_dir),
                         args.num_classes)
    os.makedirs(args.output_dir, exist_ok=True)
    out = os.path.join(args.output_dir, "evaluation_results.txt")
    with open(out, "w") as f:
        f.write("Mean pixel accuracy: %f\n" % scores["mean_pixel_acc"])
        f.write("Mean class accuracy: %f\n" % scores["mean_class_acc"])
        f.write("Mean class IoU: %f\n" % scores["mean_class_iou"])
        for i, (a, u) in enumerate(zip(scores["per_class_acc"], scores["per_class_iou"])):
            f.write("class %d: acc = %f, iou = %f\n" % (i, a, u))
    print(f"[eval_cityscapes] {scores['frames']} frames -> {out}")
    print(f"  mean pixel acc {scores['mean_pixel_acc']:.4f}  "
          f"mean class acc {scores['mean_class_acc']:.4f}  "
          f"mean class IoU {scores['mean_class_iou']:.4f}")
    return scores


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--result_dir", required=True,
                   help="generated *_leftImg8bit.png images (pix2pix test)")
    p.add_argument("--label_dir", required=True,
                   help="matching *_gtFine_labelTrainIds.png ground truth")
    p.add_argument("--output_dir", default="./eval_cityscapes")
    p.add_argument("--scorer_model", default="mobilenetv3_RE_small")
    p.add_argument("--scorer_checkpoint", required=True)
    p.add_argument("--num_classes", type=int, default=19)
    p.add_argument("--init_size", type=int, default=256,
                   help="kept for the JAX CLI (the port's models need no init forward)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def cli(argv=None):
    return main(build_parser().parse_args(argv))


if __name__ == "__main__":
    cli()
