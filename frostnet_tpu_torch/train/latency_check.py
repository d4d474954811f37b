"""Latency probe: FP32, fake-quant (QAT_FROZEN) and frozen-INT8 inference
(``frostnet_tpu/train/latency_check.py``).

Times ``iters`` batches back to back in each mode on the device
(``utils.profiling.chain_time``: CUDA events on the card) and reports the
model's FP32 and INT8 sizes. The default is the reference probes':
``qmobilenet_v2_ReLU`` with the ``fbgemm`` (per-channel) qconfig at batch 1.
INT8 is timed frozen (``quant.freeze``: ``prepare_int8`` once, then only the
kernels and the torch ops between them), as serving runs it and as the JAX
probe times its ``freeze`` closure. The model is the registry's numpy init,
its observers calibrated by one QAT forward on random images, so that the
INT8 grids are a calibrated model's.

Run: python -m frostnet_tpu_torch.train.latency_check --model qmobilenet_v2_ReLU
     [--seg --model mobilenetv3_large --num_classes 19] [--reps 5] [--device cpu]
"""
from __future__ import annotations

import argparse
import statistics

import numpy as np
import torch

from ..models import create_model
from ..nn import FP32, INT8, QAT_FROZEN
from ..quant import freeze, get_qconfig
from ..utils.logging import MetricLogger
from ..utils.profiling import chain_time
from .evaluate import int8_model_size_bytes
from .state import create_train_state, recalibrate


def time_mode(fn, device, iters: int = 100, reps: int = 1):
    """ms per batch of ``fn()``; with ``reps > 1``, (median, spread) over
    ``reps`` runs of ``iters`` batches."""
    samples = [chain_time(fn, device, iters=iters, reps=1, warmup=3 if r == 0 else 0)
               for r in range(reps)]
    if reps == 1:
        return samples[0]
    return statistics.median(samples), max(samples) - min(samples)


def main(args):
    logger = MetricLogger(None, name="latency")
    qconfig = get_qconfig(args.backend)
    if args.seg:
        from ..segmentation.models import get_seg_model

        model = get_seg_model(args.model, num_classes=args.num_classes, qconfig=qconfig)
    else:
        model = create_model(args.model, num_classes=args.num_classes, qconfig=qconfig,
                             image_size=args.image_size)
    state = create_train_state(model, None, seed=0, device=args.device)
    device = state.device
    rng = np.random.RandomState(0)
    shape = (args.batch_size, args.image_size, args.image_size, 3)
    recalibrate(state, [{"image": rng.randn(*shape).astype(np.float32)}])
    model.eval()
    x = torch.zeros(shape, device=device)
    size_fp = sum(p.numel() * 4 for p in model.parameters()) / 1e6
    size_int8 = int8_model_size_bytes(model) / 1e6

    def forward(mode):
        def fn():
            with torch.no_grad():
                return model(x, mode=mode)
        return fn

    fp = time_mode(forward(FP32), device, args.iters, args.reps)
    qat = time_mode(forward(QAT_FROZEN), device, args.iters, args.reps)
    frozen = freeze(model, device, image_size=args.image_size)
    int8 = time_mode(lambda: frozen(x), device, args.iters, args.reps)
    if args.reps > 1:
        (fp_ms, fp_sp), (qat_ms, qat_sp), (int8_ms, int8_sp) = fp, qat, int8
    else:
        fp_ms, qat_ms, int8_ms = fp, qat, int8
        fp_sp = qat_sp = int8_sp = 0.0
    rate = (int8_ms - fp_ms) / fp_ms * 100.0

    logger.info(f"model={args.model} backend={args.backend} batch={args.batch_size} "
                f"device={device}")
    logger.info(f"FP32:      {fp_ms:8.3f} ms/batch   size {size_fp:.2f} MB")
    logger.info(f"QAT sim:   {qat_ms:8.3f} ms/batch")
    logger.info(f"INT8:      {int8_ms:8.3f} ms/batch   size {size_int8:.2f} MB  rate {rate:+.2f}%")
    return {"device": str(device), "fp_ms": fp_ms, "qat_ms": qat_ms, "int8_ms": int8_ms,
            "rate": rate, "fp_spread": fp_sp, "qat_spread": qat_sp, "int8_spread": int8_sp,
            "fp_size_mb": size_fp, "int8_size_mb": size_int8}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model", default="qmobilenet_v2_ReLU")
    p.add_argument("--backend", default="fbgemm")
    p.add_argument("--num_classes", type=int, default=1000)
    p.add_argument("--image_size", type=int, default=224)
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--iters", type=int, default=100)
    p.add_argument("--reps", type=int, default=1,
                   help=">1 reports the median over reps with the run-to-run spread")
    p.add_argument("--seg", action="store_true",
                   help="treat --model as a segmentation model name")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def cli(argv=None):
    return main(build_parser().parse_args(argv))


if __name__ == "__main__":
    cli()
