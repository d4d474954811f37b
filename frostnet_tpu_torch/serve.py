"""Batched INT8 serving on the GPU: the registry's classifiers and the GAN generator.

Loads an INT8 artifact written by ``export_int8`` (the JAX package's or the
port's: one layout), freezes the model once on the device, and serves
batched predictions with latency reporting. ``--workload cls`` (the
default) serves a classifier (a quantized FrostNet or MobileNet),
``--workload gan`` the
pix2pix/CycleGAN ResnetGenerator
(``--model resnet_9blocks`` by default, 256x256 images), ``--workload det``
a detector (``--model qssd`` by default, or ``qtdsod``; 300x300): the INT8
feature net and the float head from ``BASE_feat.npz`` and ``BASE_head.npz``
(``--artifact BASE``, as ``detection.qeval --export_int8`` writes them),
then the softmax and ``detect`` (``conf_thresh`` 0.25, ``top_k`` 50) into
JSON-lines detections (``--output``). The report has the
keys of ``frostnet_tpu.serve``:

  * ``latency_ms`` and ``request_images_per_sec``: per request, with the
    logits copied back to the host every batch (what a serving process
    observes);
  * ``pipeline_images_per_sec``: batches enqueued back to back, one
    synchronisation at the end (a saturated server).

Run: python -m frostnet_tpu_torch.serve --model frostnet_quant_large_1_0 \\
       --artifact model_int8.npz --source synthetic --iters 20 [--fuse_int8]
     python -m frostnet_tpu_torch.serve --workload gan --artifact netG_int8.npz
     python -m frostnet_tpu_torch.serve --workload det --artifact runs/detection/ssd \
       --output detections.jsonl
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
_DEFAULTS = {"cls": (_CLS_DEFAULT, 224), "gan": ("resnet_9blocks", 256), "det": ("qssd", None)}


class Int8Predictor:
    """Frozen-INT8 classifier over an ``export_int8`` artifact."""

    def __init__(self, model_name: str = _CLS_DEFAULT, num_classes: int = 1000,
                 artifact: Optional[str] = None, image_size: int = 224,
                 fuse_int8: bool = False, device="cuda"):
        if artifact is None:
            raise ValueError("pass artifact= (an export_int8 .npz)")
        self.device = resolve_device(device)
        self.image_size = image_size
        self.model = create_model(model_name, num_classes=num_classes, image_size=image_size,
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


class DetPredictor:
    """SSD / Tiny-DSOD serving (``frostnet_tpu/serve.py:198-257``): the frozen
    INT8 feature net, then the float head, over ``BASE_feat.npz`` and
    ``BASE_head.npz``; :meth:`detect` adds the softmax and ``detect``."""

    def __init__(self, net_type: str = "qssd", artifact: Optional[str] = None,
                 num_classes: Optional[int] = None, dataset: str = "voc",
                 image_size: Optional[int] = None, device="cuda"):
        from .detection.anchors import make_priors
        from .detection.train import build_net, select_config

        if net_type not in ("qssd", "qtdsod"):
            raise SystemExit(f"--workload det serves qssd|qtdsod, got --model {net_type!r}")
        if not artifact:
            raise SystemExit("--workload det needs --artifact BASE (loads BASE_feat.npz + "
                             "BASE_head.npz, as written by qeval --export_int8)")
        det_cfg = select_config(net_type, dataset)
        # the priors and heads are built for the config's input size (300)
        self.image_size = det_cfg["min_dim"]
        if image_size not in (None, self.image_size):
            raise SystemExit(f"--workload det runs at the net config's input size "
                             f"{self.image_size}, got --image_size {image_size}")
        base = artifact[:-4] if artifact.endswith(".npz") else artifact
        self.device = resolve_device(device)
        self.num_classes = num_classes or det_cfg["num_classes"]
        self.feat, self.head = build_net(net_type, self.num_classes,
                                         qconfig=artifact_qconfig(base + "_feat.npz"))
        from_jax_variables((self.feat, self.head),
                           (load_int8(base + "_feat.npz"), load_int8(base + "_head.npz")))
        self.feat.to(self.device).eval()
        self.head.to(self.device).eval()
        self.feat.prepare_int8(self.device)
        self.priors = torch.as_tensor(make_priors(det_cfg), device=self.device)

    @torch.inference_mode()
    def __call__(self, images):
        """(B, 300, 300, 3) float BGR images, mean subtracted -> (loc (B, P,
        4), conf (B, P, C)) logits, tensors on the device."""
        from .nn import INT8

        x = torch.as_tensor(np.asarray(images, np.float32) if isinstance(images, np.ndarray)
                            else images).to(device=self.device, dtype=torch.float32)
        return self.head(self.feat(x, mode=INT8))

    @torch.inference_mode()
    def detect(self, images, conf_thresh: float = 0.25, top_k: int = 50) -> torch.Tensor:
        """(B, C, top_k, 5) rows (score, x1, y1, x2, y2) per class."""
        from .detection.nms import detect

        loc, conf = self(images)
        return detect(loc, torch.softmax(conf, dim=-1), self.priors, conf_thresh=conf_thresh,
                      top_k=top_k)

    def write_detections(self, path: str, images, start: int) -> None:
        """Append one JSON line per image (truncating on ``start == 0``):
        its detections above the serving threshold, as the JAX server
        writes them."""
        dets = self.detect(images).cpu().numpy()
        with open(path, "w" if start == 0 else "a") as f:
            for b in range(len(dets)):
                hits = [{"class": int(c), "score": round(float(s), 4),
                         "box": [round(float(v), 4) for v in (x1, y1, x2, y2)]}
                        for c in range(1, dets.shape[1]) for s, x1, y1, x2, y2 in dets[b, c]
                        if s > 0]
                f.write(json.dumps({"image": start + b, "detections": hits}) + "\n")


def _host(out):
    return tuple(o.cpu() for o in out) if isinstance(out, tuple) else out.cpu()


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
    if args.workload == "det":
        if args.fuse_int8 or args.save_logits:
            raise SystemExit("--fuse_int8 and --save_logits are classification-only")
        pred = DetPredictor(args.model, artifact=args.artifact,
                            num_classes=args.num_classes if args.num_classes != 1000 else None,
                            dataset=args.dataset, image_size=args.image_size,
                            device=args.device)
        args.image_size = pred.image_size
    elif args.workload == "gan":
        args.image_size = args.image_size or size
        if args.fuse_int8 or args.output:
            raise SystemExit("--fuse_int8 and --output are classification-only; the GAN's "
                             "PNG output is not ported yet")
        pred = GanPredictor(args.model, ngf=args.ngf, artifact=args.artifact,
                            image_size=args.image_size, device=args.device)
    else:
        args.image_size = args.image_size or size
        pred = Int8Predictor(args.model, num_classes=args.num_classes, artifact=args.artifact,
                             image_size=args.image_size, fuse_int8=args.fuse_int8,
                             device=args.device)
    gen = _batches(args)
    _host(pred(next(gen)))  # warm-up: builds the kernels on first use

    lat = []
    for _ in range(args.iters):
        x = next(gen)
        t0 = time.perf_counter()
        _host(pred(x))
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
    if args.output and args.workload == "det":
        for i in range(args.predict_batches):
            pred.write_detections(args.output, next(gen), i * args.batch_size)
        print(f"[serve] detections -> {args.output}")
    elif args.output:
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
                   help="cls: a quantized classifier; gan: the ResnetGenerator; det: a "
                        "detector (BASE_feat.npz + BASE_head.npz)")
    p.add_argument("--model", default=None,
                   help=f"registry name (a quantized FrostNet or MobileNet), or the "
                        f"generator (resnet_6blocks, resnet_9blocks), or the detector "
                        f"(qssd, qtdsod); default {_CLS_DEFAULT} / resnet_9blocks / qssd")
    p.add_argument("--artifact", required=True,
                   help="export_int8 .npz (det: the BASE of BASE_feat.npz, BASE_head.npz)")
    p.add_argument("--num_classes", type=int, default=1000,
                   help="det: defaults from the net config (21 voc / 201 coco)")
    p.add_argument("--dataset", choices=("voc", "coco"), default="voc",
                   help="det only: the anchor and class config the artifact was trained on")
    p.add_argument("--ngf", type=int, default=64, help="generator width (gan)")
    p.add_argument("--image_size", type=int, default=None,
                   help="default 224 / 256; det: fixed by the net config (300)")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--iters", type=int, default=30)
    p.add_argument("--source", choices=("synthetic",), default="synthetic",
                   help="request images; only synthetic is ported so far")
    p.add_argument("--fuse_int8", action="store_true",
                   help="run each Frost block as one fused CUDA kernel (FrostNet only)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--output", default=None,
                   help="write top-k (cls) or detections (det) jsonl here")
    p.add_argument("--save_logits", default=None, metavar="PATH",
                   help="save the first request batch's output (.npy)")
    p.add_argument("--predict_batches", type=int, default=4)
    p.add_argument("--topk", type=int, default=5)
    return p


def cli():
    main(build_parser().parse_args())


if __name__ == "__main__":
    cli()
