"""Batched INT8 serving on the GPU: the registry's classifiers and the GAN generator.

Loads an INT8 artifact written by ``export_int8`` (the JAX package's or the
port's: one layout), freezes the model once on the device, and serves
batched predictions with latency reporting. ``--workload cls`` (the
default) serves a classifier (a quantized FrostNet or MobileNet),
``--workload gan`` the
pix2pix/CycleGAN ResnetGenerator
(``--model resnet_9blocks`` by default, 256x256 images). The report has the
keys of ``frostnet_tpu.serve``:

  * ``latency_ms`` and ``request_images_per_sec``: per request, with the
    logits copied back to the host every batch (what a serving process
    observes);
  * ``pipeline_images_per_sec``: batches enqueued back to back, one
    synchronisation at the end (a saturated server).

Run: python -m frostnet_tpu_torch.serve --model frostnet_quant_large_1_0 \\
       --artifact model_int8.npz --source synthetic --iters 20 [--fuse_int8]
     python -m frostnet_tpu_torch.serve --workload gan --artifact netG_int8.npz
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Iterator, Optional

import numpy as np
import torch

from .gan import define_g
from .models import create_model
from .quant import freeze, from_jax_variables, load_int8
from .quant.export import artifact_qconfig
from .quant.freeze import resolve_device

_CLS_DEFAULT = "frostnet_quant_large_1_0"
_DEFAULTS = {"cls": (_CLS_DEFAULT, 224), "gan": ("resnet_9blocks", 256)}


class Int8Predictor:
    """Frozen-INT8 classifier over an ``export_int8`` artifact."""

    def __init__(self, model_name: str = _CLS_DEFAULT, num_classes: int = 1000,
                 artifact: Optional[str] = None, image_size: int = 224,
                 fuse_int8: bool = False, device="cuda"):
        if artifact is None:
            raise ValueError("pass artifact= (an export_int8 .npz)")
        self.device = resolve_device(device)
        self.image_size = image_size
        self.model = create_model(model_name, num_classes=num_classes,
                                  qconfig=artifact_qconfig(artifact), fuse_int8=fuse_int8)
        from_jax_variables(self.model, load_int8(artifact))
        self._apply = freeze(self.model, self.device, image_size=image_size)

    def __call__(self, images) -> torch.Tensor:
        """(B, S, S, 3) float images -> (B, C) logits (a tensor on the device)."""
        return self._apply(images)

    def predict_topk(self, images, k: int = 5):
        logits = self(images).cpu().numpy()
        idx = np.argsort(-logits, axis=-1)[:, :k]
        return idx, np.take_along_axis(logits, idx, axis=-1)


class GanPredictor:
    """Frozen-INT8 ResnetGenerator over an ``export_int8`` artifact."""

    def __init__(self, net_g: str = "resnet_9blocks", ngf: int = 64,
                 artifact: Optional[str] = None, image_size: int = 256, device="cuda"):
        if artifact is None:
            raise ValueError("pass artifact= (an export_int8 .npz)")
        self.device = resolve_device(device)
        self.image_size = image_size
        self.model = define_g(ngf=ngf, netG=net_g, qconfig=artifact_qconfig(artifact))
        from_jax_variables(self.model, load_int8(artifact))
        self._apply = freeze(self.model, self.device, image_size=image_size)

    def __call__(self, images) -> torch.Tensor:
        """(B, S, S, 3) images in [-1, 1] -> (B, S, S, 3) float32 in [-1, 1]."""
        return self._apply(images)


def _batches(args) -> Iterator[np.ndarray]:
    rng = np.random.RandomState(0)
    shape = (args.batch_size, args.image_size, args.image_size, 3)
    while True:
        yield rng.randn(*shape).astype(np.float32)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(args):
    model, size = _DEFAULTS[args.workload]
    args.model = args.model or model
    args.image_size = args.image_size or size
    if args.workload == "gan":
        if args.fuse_int8 or args.output:
            raise SystemExit("--fuse_int8 and --output are classification-only; the GAN's "
                             "PNG output is not ported yet")
        pred = GanPredictor(args.model, ngf=args.ngf, artifact=args.artifact,
                            image_size=args.image_size, device=args.device)
    else:
        pred = Int8Predictor(args.model, num_classes=args.num_classes, artifact=args.artifact,
                             image_size=args.image_size, fuse_int8=args.fuse_int8,
                             device=args.device)
    gen = _batches(args)
    pred(next(gen)).cpu()  # warm-up: builds the kernels on first use

    lat = []
    for _ in range(args.iters):
        x = next(gen)
        t0 = time.perf_counter()
        pred(x).cpu()
        lat.append(time.perf_counter() - t0)
    lat_ms = np.sort(np.asarray(lat)) * 1000

    _sync(pred.device)
    t0 = time.perf_counter()
    for _ in range(args.iters):
        pred(next(gen))
    _sync(pred.device)
    pipeline_ips = args.batch_size * args.iters / (time.perf_counter() - t0)

    report = {
        "workload": args.workload,
        "model": args.model,
        "device": str(pred.device),
        "fuse_int8": bool(args.fuse_int8),
        "batch_size": args.batch_size,
        "iters": args.iters,
        "latency_ms": {"p50": round(float(np.percentile(lat_ms, 50)), 2),
                       "p95": round(float(np.percentile(lat_ms, 95)), 2),
                       "max": round(float(lat_ms[-1]), 2)},
        "request_images_per_sec": round(args.batch_size / float(np.mean(lat_ms)) * 1000, 1),
        "pipeline_images_per_sec": round(pipeline_ips, 1),
    }
    print(json.dumps(report, indent=2))

    if args.save_logits:
        # the first request batch of the synthetic source, served once more
        np.save(args.save_logits, pred(next(_batches(args))).cpu().numpy())
        print(f"[serve] logits of the first request batch -> {args.save_logits}")
    if args.output:
        with open(args.output, "w") as f:
            for _ in range(args.predict_batches):
                idx, scores = pred.predict_topk(next(gen), k=args.topk)
                for b in range(len(idx)):
                    f.write(json.dumps({"topk": idx[b].tolist(),
                                        "scores": [round(float(s), 4) for s in scores[b]]}) + "\n")
        print(f"[serve] predictions -> {args.output}")
    return report


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", choices=tuple(_DEFAULTS), default="cls",
                   help="cls: a quantized classifier; gan: the ResnetGenerator")
    p.add_argument("--model", default=None,
                   help=f"registry name (a quantized FrostNet or MobileNet), or the "
                        f"generator (resnet_6blocks, "
                        f"resnet_9blocks); default {_CLS_DEFAULT} / resnet_9blocks")
    p.add_argument("--artifact", required=True, help="export_int8 .npz")
    p.add_argument("--num_classes", type=int, default=1000)
    p.add_argument("--ngf", type=int, default=64, help="generator width (gan)")
    p.add_argument("--image_size", type=int, default=None, help="default 224 / 256")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--iters", type=int, default=30)
    p.add_argument("--source", choices=("synthetic",), default="synthetic",
                   help="request images; only synthetic is ported so far")
    p.add_argument("--fuse_int8", action="store_true",
                   help="run each Frost block as one fused CUDA kernel (FrostNet only)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--output", default=None, help="write top-k jsonl here")
    p.add_argument("--save_logits", default=None, metavar="PATH",
                   help="save the first request batch's output (.npy)")
    p.add_argument("--predict_batches", type=int, default=4)
    p.add_argument("--topk", type=int, default=5)
    return p


def cli():
    main(build_parser().parse_args())


if __name__ == "__main__":
    cli()
