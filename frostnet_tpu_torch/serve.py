"""Batched INT8 serving on the GPU for every quantized workload
(``frostnet_tpu/serve.py``).

Loads an INT8 artifact written by ``export_int8`` (the JAX package's or the
port's: one layout), a trainer checkpoint (classification) or a serialized
program (classification, ``quant/serialize.py``), freezes the model once on
the device, and serves batched predictions with latency reporting.
``--workload`` selects the model family:

  * ``cls`` (the default): a quantized classifier's logits; top-k JSON lines
    (``--output``). ``--artifact``, ``--checkpoint`` and ``--program`` are
    the three sources, one at a time; ``--export_program`` also writes the
    serialized program of the served model.
  * ``seg``: a segmentation model (``mobilenetv3_large`` by default, built in
    bfloat16 as the JAX server builds it) at ``--image_size`` 512 and twice
    that wide unless ``--image_width`` says otherwise; per-pixel class maps,
    written as Cityscapes-palette PNGs ``pred_*.png`` into the ``--output``
    directory.
  * ``det``: a detector (``qssd`` by default, or ``qtdsod``; 300x300): the
    INT8 feature net and the float head from ``BASE_feat.npz`` and
    ``BASE_head.npz`` (``--artifact BASE``, as ``detection.qeval
    --export_int8`` writes them), then the softmax and ``detect``
    (``conf_thresh`` 0.25, ``top_k`` 50) into JSON-lines detections.
  * ``gan``: the pix2pix/CycleGAN ResnetGenerator (``resnet_9blocks`` by
    default, 256x256); generated images as ``fake_*.png``.

PNGs are written by ``gan/visualizer.py::write_png`` (zlib, no PIL).
``--source folder`` reads the images under ``--data_dir`` (PIL, imported
when asked for) with each workload's own preprocessing. The report has the
keys of ``frostnet_tpu.serve``:

  * ``latency_ms`` and ``request_images_per_sec``: per request, with the
    output copied back to the host every batch (what a serving process
    observes);
  * ``pipeline_images_per_sec``: batches enqueued back to back, one
    synchronisation at the end (a saturated server).

``--dp N`` (every workload) splits each request batch over N replicas of
the frozen model, on ``cuda:0`` to ``cuda:N-1`` (``devices=`` of the
predictors places them anywhere, two on one device too): replica ``i``
serves its contiguous block of rows, the outputs are gathered in order on
the first device. A batch that N does not divide goes over the largest
divisor that fits (``parallel.make_dp_mesh``, JAX's rule). INT8 rows are
independent, so the output equals ``--dp 1``'s.

Run: python -m frostnet_tpu_torch.serve --model frostnet_quant_large_1_0 \\
       --artifact model_int8.npz --source synthetic --iters 20 [--fuse_int8]
     python -m frostnet_tpu_torch.serve --checkpoint runs/classification/best \\
       --export_program model.pt2
     python -m frostnet_tpu_torch.serve --program model.pt2 --batch_size 128
     python -m frostnet_tpu_torch.serve --workload seg --artifact seg_int8.npz \\
       --num_classes 19 --output maps/
     python -m frostnet_tpu_torch.serve --workload gan --artifact netG_int8.npz --output fakes/
     python -m frostnet_tpu_torch.serve --workload det --artifact runs/detection/ssd \\
       --output detections.jsonl
"""
from __future__ import annotations

import argparse
import copy
import functools
import json
import os
import time
from typing import Callable, Iterator, List, Optional, Sequence

import numpy as np
import torch

from .gan import define_g
from .models import create_model
from .nn import FP32, INT8
from .parallel import make_dp_mesh, shard_rows
from .quant import freeze, from_jax_variables, load_int8
from .quant.export import artifact_qconfig
from .quant.freeze import resolve_device
from .utils.cuda_graphs import Replay
from .utils.profiling import span

_CLS_DEFAULT = "frostnet_quant_large_1_0"
_DEFAULTS = {"cls": (_CLS_DEFAULT, 224), "seg": ("mobilenetv3_large", 512),
             "gan": ("resnet_9blocks", 256), "det": ("qssd", None)}


def replica_devices(device="cuda", dp: int = 1, devices: Optional[Sequence] = None) -> list:
    """The devices of ``dp`` replicas: ``devices`` when given, else
    ``cuda:0..dp-1`` (``device`` itself ``dp`` times for the CPU)."""
    if devices is not None:
        return [resolve_device(d) for d in devices]
    device = resolve_device(device)
    if dp <= 1:
        return [device]
    if device.type != "cuda":
        return [device] * dp
    if torch.cuda.device_count() < dp:
        raise ValueError(f"--dp {dp} needs {dp} cards, this host has {torch.cuda.device_count()}")
    return [torch.device("cuda", i) for i in range(dp)]


class Replicated:
    """``fn(images)`` over replicas: ``fns[i]`` serves on ``devices[i]``.
    Each request batch is split over the largest divisor of its size that
    fits the replicas (``make_dp_mesh``), replica ``i`` takes its contiguous
    block of rows (``shard_rows``), and the outputs (a tensor or a tuple of
    tensors) are gathered in order on the first device. Keyword arguments
    go to every replica's call (``freeze``'s ``post``)."""

    def __init__(self, fns: List[Callable], devices: Sequence[torch.device]):
        self.fns, self.devices = list(fns), list(devices)

    def __call__(self, images, **kw):
        if len(self.fns) == 1:
            return self.fns[0](images, **kw)
        n = len(images)
        dp = make_dp_mesh(n, self.devices).dp
        outs = [self.fns[i](images[shard_rows(n, dp, i)], **kw) for i in range(dp)]
        first = self.devices[0]
        if isinstance(outs[0], tuple):
            return tuple(torch.cat([o[k].to(first) for o in outs]) for k in range(len(outs[0])))
        return torch.cat([o.to(first) for o in outs])


def _frozen_replicas(model, devices, image_size: int) -> Replicated:
    """``freeze`` of ``model`` on each device (copies made before the first
    freeze prepares it)."""
    models = [model] + [copy.deepcopy(model) for _ in devices[1:]]
    return Replicated([freeze(m, d, image_size=image_size) for m, d in zip(models, devices)],
                      devices)


class Int8Predictor:
    """Frozen-INT8 classifier over an ``export_int8`` artifact, a trainer
    checkpoint (restored, then frozen) or a serialized program (no model
    code: ``quant.load_serving``). Exactly one of the three. ``dp`` or
    ``devices`` replicate it (``Replicated``)."""

    def __init__(self, model_name: str = _CLS_DEFAULT, num_classes: int = 1000,
                 artifact: Optional[str] = None, checkpoint: Optional[str] = None,
                 program: Optional[str] = None, image_size: int = 224,
                 fuse_int8: bool = False, device="cuda", dp: int = 1,
                 devices: Optional[Sequence] = None):
        if sum(x is not None for x in (artifact, checkpoint, program)) != 1:
            raise ValueError("pass exactly one of artifact= / checkpoint= / program=")
        self.devices = replica_devices(device, dp, devices)
        self.device = self.devices[0]
        self.image_size = image_size
        if program is not None:
            from .quant import load_serving

            self.model = None
            self._apply = Replicated([load_serving(program, d) for d in self.devices],
                                     self.devices)
            return
        # a trainer checkpoint holds the registry's default qconfig, an
        # artifact says its own
        kw = {"qconfig": artifact_qconfig(artifact)} if artifact is not None else {}
        self.model = create_model(model_name, num_classes=num_classes, image_size=image_size,
                                  fuse_int8=fuse_int8, **kw)
        if artifact is not None:
            from_jax_variables(self.model, load_int8(artifact))
        else:
            from .train import create_train_state
            from .utils.checkpoint import restore_model_variables

            restore_model_variables(checkpoint,
                                    create_train_state(self.model, None, device=self.device))
        self._apply = _frozen_replicas(self.model, self.devices, image_size)

    def export_program(self, path: str, batch: Optional[int] = None) -> int:
        """Write the served model's serialized program to ``path``; returns
        the bytes written."""
        from .quant import export_serving

        if self.model is None:
            raise ValueError("predictor was built from a program artifact; nothing to re-export")
        return export_serving(self.model, path, image_size=self.image_size, batch=batch)

    def __call__(self, images) -> torch.Tensor:
        """(B, S, S, 3) float images -> (B, C) logits (a tensor on the device)."""
        return self._apply(images)

    def predict_topk(self, images, k: int = 5):
        logits = self(images).cpu().numpy()
        idx = np.argsort(-logits, axis=-1)[:, :k]
        return idx, np.take_along_axis(logits, idx, axis=-1)


class FrozenPredictor:
    """Frozen-INT8 serving of a non-classifier model (the segmentation model,
    the GAN generator) over an ``export_int8`` artifact; ``dp`` or
    ``devices`` replicate it."""

    def __init__(self, model, artifact: Optional[str], image_size: int, device="cuda",
                 dp: int = 1, devices: Optional[Sequence] = None):
        if artifact is None:
            raise ValueError("pass artifact= (an export_int8 .npz)")
        self.devices = replica_devices(device, dp, devices)
        self.device = self.devices[0]
        self.image_size = image_size
        self.model = model
        from_jax_variables(self.model, load_int8(artifact))
        self._apply = _frozen_replicas(self.model, self.devices, image_size)

    def __call__(self, images) -> torch.Tensor:
        """(B, H, W, 3) float images -> the model's float32 output on the device."""
        return self._apply(images)


class GanPredictor(FrozenPredictor):
    """Frozen-INT8 ResnetGenerator: (B, S, S, 3) images in [-1, 1] -> (B, S,
    S, 3) float32 in [-1, 1]."""

    def __init__(self, net_g: str = "resnet_9blocks", ngf: int = 64,
                 artifact: Optional[str] = None, image_size: int = 256, device="cuda",
                 dp: int = 1, devices: Optional[Sequence] = None):
        if artifact is None:
            raise ValueError("pass artifact= (an export_int8 .npz)")
        super().__init__(define_g(ngf=ngf, netG=net_g, qconfig=artifact_qconfig(artifact)),
                         artifact, image_size, device, dp, devices)


def seg_predictor(name: str, artifact: str, num_classes: int, image_size: int,
                  device="cuda", dp: int = 1, devices: Optional[Sequence] = None
                  ) -> FrozenPredictor:
    """The JAX server's seg model (``frostnet_tpu/serve.py`` ``_build_seg``):
    ``name`` from the seg registry, built in bfloat16 (the compute dtype of
    the quant region's float phases; the INT8 graph and the float32 tail do
    not read it), frozen over ``artifact``."""
    from .segmentation.models import get_seg_model

    devices = replica_devices(device, dp, devices)  # raises before any file is read
    model = get_seg_model(name, num_classes=num_classes, qconfig=artifact_qconfig(artifact),
                          dtype=torch.bfloat16)
    return FrozenPredictor(model, artifact, image_size, devices=devices)


class _Replayed(torch.nn.Module):
    """``model`` whose frozen INT8 forward on the card replays a CUDA graph
    captured per batch shape (``utils/cuda_graphs.py::Replay``): a
    detector's feature net and float head are some 300 launches, which the
    host took longer to issue than the card to run."""

    def __init__(self, model: torch.nn.Module):
        super().__init__()
        self.model = model
        self._replay = Replay(self._int8)

    def _int8(self, x):
        return self.model(x, mode=INT8)

    def prepare_int8(self, device, image_size: Optional[int] = None) -> None:
        self.model.prepare_int8(device, image_size)

    def forward(self, x, mode=FP32, train: bool = False):
        if mode is INT8 and not train:
            return self._replay(x)
        return self.model(x, mode=mode, train=train)


class DetPredictor:
    """SSD / Tiny-DSOD serving (``frostnet_tpu/serve.py:198-257``): the frozen
    INT8 feature net, then the float head, over ``BASE_feat.npz`` and
    ``BASE_head.npz``, as one ``freeze`` of ``detection.models.Detector``;
    :meth:`detect` adds the softmax and ``detect`` inside the request
    (``request.detect``). ``dp`` or ``devices`` replicate the two nets
    (``Replicated``); each replica detects its own rows. On the card the
    NMS's greedy pass, and SSD's forward, replay CUDA graphs, one a batch
    shape (``utils/cuda_graphs.py::Replay``), captured at a shape's second
    request."""

    def __init__(self, net_type: str = "qssd", artifact: Optional[str] = None,
                 num_classes: Optional[int] = None, dataset: str = "voc",
                 image_size: Optional[int] = None, device="cuda", dp: int = 1,
                 devices: Optional[Sequence] = None):
        from .detection.anchors import make_priors
        from .detection.models import Detector
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
        self.devices = replica_devices(device, dp, devices)
        self.device = self.devices[0]
        self.num_classes = num_classes or det_cfg["num_classes"]
        self.feat, self.head = build_net(net_type, self.num_classes,
                                         qconfig=artifact_qconfig(base + "_feat.npz"))
        from_jax_variables((self.feat, self.head),
                           (load_int8(base + "_feat.npz"), load_int8(base + "_head.npz")))
        model = Detector(self.feat, self.head)
        if net_type == "qssd":  # Tiny-DSOD's forward is not captured yet (its resize
            model = _Replayed(model)  # joins are capture-safe since the resize kernel)
        self._apply = _frozen_replicas(model, self.devices, self.image_size)
        on = [torch.as_tensor(make_priors(det_cfg)).to(d) for d in self.devices]
        self._priors = {p.device: p for p in on}  # keyed as the outputs name their device
        self.priors = on[0]

    @torch.inference_mode()
    def __call__(self, images):
        """(B, 300, 300, 3) float BGR images, mean subtracted -> (loc (B, P,
        4), conf (B, P, C)) logits, tensors on the device."""
        return self._apply(images)

    @torch.inference_mode()
    def detect(self, images, conf_thresh: float = 0.25, top_k: int = 50) -> torch.Tensor:
        """(B, C, top_k, 5) rows (score, x1, y1, x2, y2) per class."""
        step = functools.partial(self._detect, conf_thresh=conf_thresh, top_k=top_k)
        return self._apply(images, post=step)

    def _detect(self, out, conf_thresh: float, top_k: int) -> torch.Tensor:
        """The softmax and ``detect`` of one replica's ``(loc, conf)``, on its
        device, under the span ``request.detect``. The detection benchmark
        (``portbench/drivers/serve_det.py``) wraps this method to keep the
        logits behind each response."""
        from .detection.nms import detect

        loc, conf = out
        with span("request.detect"):
            return detect(loc, torch.softmax(conf, dim=-1), self._priors[loc.device],
                          conf_thresh=conf_thresh, top_k=top_k)

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


def write_seg_maps(outdir: str, logits: torch.Tensor, start: int) -> None:
    """Each image's argmax class map as a Cityscapes-palette PNG,
    ``pred_{start + i:05d}.png``."""
    from .gan.visualizer import write_png
    from .segmentation.evaluate import colorize

    os.makedirs(outdir, exist_ok=True)
    pred = logits.argmax(dim=-1).to(torch.uint8).cpu().numpy()
    for i in range(len(pred)):
        write_png(os.path.join(outdir, f"pred_{start + i:05d}.png"), colorize(pred[i]))


def write_fakes(outdir: str, images: torch.Tensor, start: int) -> None:
    """Each generated image as ``fake_{start + i:05d}.png``."""
    from .gan.visualizer import tensor2im, write_png

    os.makedirs(outdir, exist_ok=True)
    fake = images.cpu().numpy()
    for i in range(len(fake)):
        write_png(os.path.join(outdir, f"fake_{start + i:05d}.png"), tensor2im(fake[i]))


def _host(out):
    return tuple(o.cpu() for o in out) if isinstance(out, tuple) else out.cpu()


def _input_shape(args):
    """(B, H, W, 3): square but for seg, whose width is ``--image_width``, by
    default twice the height (Cityscapes' 2:1)."""
    width = (args.image_width or 2 * args.image_size) if args.workload == "seg" else None
    return (args.batch_size, args.image_size, width or args.image_size, 3)


def _list_folder_images(root: str) -> list:
    exts = (".jpg", ".jpeg", ".png", ".bmp")
    paths = []
    for dirpath, _, files in os.walk(root):
        paths.extend(os.path.join(dirpath, f) for f in files if f.lower().endswith(exts))
    if not paths:
        raise SystemExit(f"no images under {root}")
    return sorted(paths)


def _folder_batches(args) -> Iterator[tuple]:
    """``--source folder`` for the seg, det and GAN workloads, each with its
    own eval preprocessing, as the JAX server does: seg /255 then the
    ImageNet mean and std, det RGB->BGR minus the SSD BGR means, GAN a
    bicubic resize then [-1, 1]. The folder is cycled, so ``--iters`` never
    runs short."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("--source folder decodes images with PIL (Pillow), which is not "
                          "installed") from e
    from .data.datasets import IMAGENET_MEAN, IMAGENET_STD
    from .detection.data import MEANS

    _, h, w, _ = _input_shape(args)
    paths = _list_folder_images(args.data_dir)
    resample = Image.BICUBIC if args.workload == "gan" else Image.BILINEAR
    i = 0
    while True:
        imgs = []
        for _ in range(args.batch_size):
            img = Image.open(paths[i % len(paths)]).convert("RGB")
            i += 1
            arr = np.asarray(img.resize((w, h), resample), np.float32)
            if args.workload == "seg":
                arr = ((arr / 255.0 - np.asarray(IMAGENET_MEAN, np.float32))
                       / np.asarray(IMAGENET_STD, np.float32))
            elif args.workload == "det":
                arr = arr[..., ::-1] - np.asarray(MEANS, np.float32)
            else:
                arr = arr / 255.0 * 2.0 - 1.0
            imgs.append(arr)
        yield np.stack(imgs), None


def _requests(args) -> Iterator[tuple]:
    """(images, labels or None) request batches from ``--source``."""
    if args.source == "synthetic":
        rng = np.random.RandomState(0)
        while True:
            yield rng.randn(*_input_shape(args)).astype(np.float32), None
    elif args.workload != "cls":
        yield from _folder_batches(args)
    else:
        from .data import FolderClassification

        for batch in FolderClassification(args.data_dir, args.image_size, args.batch_size,
                                          train=False):
            yield batch["image"], batch["label"]


def _batches(args) -> Iterator[np.ndarray]:
    """The request images of ``--source``."""
    return (x for x, _ in _requests(args))


def _sync(devices) -> None:
    for device in devices:
        if device.type == "cuda":
            torch.cuda.synchronize(device)


def _predictor(args):
    """The workload's predictor and its ``--output`` writer ``(path, images,
    start)`` (None for cls: top-k lines)."""
    if args.workload != "cls" and (args.program or args.export_program or args.checkpoint):
        raise SystemExit("--program/--export_program/--checkpoint are classification-only; "
                         "other workloads serve --export_int8 artifacts")
    if args.workload != "cls" and not args.artifact:
        raise SystemExit(f"--workload {args.workload} serves --export_int8 artifacts; pass "
                         "--artifact (see the workload evaluator CLIs)")
    if args.workload != "cls" and args.fuse_int8:
        raise SystemExit("--fuse_int8 is classification-only")
    if args.workload == "det":
        if args.save_logits:
            raise SystemExit("--fuse_int8 and --save_logits are classification-only")
        pred = DetPredictor(args.model, artifact=args.artifact,
                            num_classes=args.num_classes if args.num_classes != 1000 else None,
                            dataset=args.dataset, image_size=args.image_size,
                            device=args.device, dp=args.dp)
        args.image_size = pred.image_size
        return pred, pred.write_detections
    if args.workload in ("gan", "seg"):
        if args.workload == "gan":
            pred = GanPredictor(args.model, ngf=args.ngf, artifact=args.artifact,
                                image_size=args.image_size, device=args.device, dp=args.dp)
            write = write_fakes
        else:
            pred = seg_predictor(args.model, args.artifact, args.num_classes, args.image_size,
                                 device=args.device, dp=args.dp)
            write = write_seg_maps
        return pred, lambda path, x, start: write(path, pred(x), start)
    if args.program and (args.fuse_int8 or args.export_program):
        raise SystemExit("--fuse_int8 and --export_program need the model: a --program "
                         "is served as it was exported")
    pred = Int8Predictor(args.model, num_classes=args.num_classes, artifact=args.artifact,
                         checkpoint=args.checkpoint, program=args.program,
                         image_size=args.image_size, fuse_int8=args.fuse_int8,
                         device=args.device, dp=args.dp)
    if args.export_program:
        size = pred.export_program(args.export_program)
        print(f"[serve] serving program -> {args.export_program} ({size / 1e6:.2f} MB)")
    return pred, None


def main(args):
    model, size = _DEFAULTS[args.workload]
    args.model = args.model or model
    if args.workload != "det":
        args.image_size = args.image_size or size
    pred, write = _predictor(args)
    gen = _requests(args)
    _host(pred(next(gen)[0]))  # warm-up: builds the kernels on first use

    lat = []
    for _ in range(args.iters):
        x, _ = next(gen)
        t0 = time.perf_counter()
        _host(pred(x))
        lat.append(time.perf_counter() - t0)
    lat_ms = np.sort(np.asarray(lat)) * 1000

    _sync(pred.devices)
    t0 = time.perf_counter()
    for _ in range(args.iters):
        pred(next(gen)[0])
    _sync(pred.devices)
    pipeline_ips = args.batch_size * args.iters / (time.perf_counter() - t0)

    report = {
        "workload": args.workload,
        "model": f"program:{args.program}" if args.program else args.model,
        "device": str(pred.device),
        "dp": len(pred.devices),
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
    if args.output and write is not None:
        for i in range(args.predict_batches):
            write(args.output, next(gen)[0], i * args.batch_size)
        print(f"[serve] predictions -> {args.output}")
    elif args.output:
        with open(args.output, "w") as f:
            for _ in range(args.predict_batches):
                x, labels = next(gen)
                idx, scores = pred.predict_topk(x, k=args.topk)
                for b in range(len(idx)):
                    rec = {"topk": idx[b].tolist(),
                           "scores": [round(float(s), 4) for s in scores[b]]}
                    if labels is not None:
                        rec["label"] = int(labels[b])
                    f.write(json.dumps(rec) + "\n")
        print(f"[serve] predictions -> {args.output}")
    return report


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", choices=tuple(_DEFAULTS), default="cls",
                   help="cls: a quantized classifier; seg: a segmentation model; det: a "
                        "detector (BASE_feat.npz + BASE_head.npz); gan: the ResnetGenerator")
    p.add_argument("--model", default=None,
                   help=f"cls: classifier registry name (default {_CLS_DEFAULT}); seg: seg "
                        f"model name (mobilenetv3_large); det: qssd|qtdsod; gan: "
                        f"resnet_9blocks|resnet_6blocks")
    p.add_argument("--artifact", default=None,
                   help="export_int8 .npz (det: the BASE of BASE_feat.npz, BASE_head.npz)")
    p.add_argument("--checkpoint", default=None, help="trainer checkpoint dir (cls)")
    p.add_argument("--program", default=None,
                   help="serialized serving program (quant.export_serving, .pt2; cls); runs "
                        "without the model code")
    p.add_argument("--export_program", default=None,
                   help="also write the served model's serialized program here (cls)")
    p.add_argument("--num_classes", type=int, default=1000,
                   help="seg: 19 for Cityscapes; det: defaults from the net config "
                        "(21 voc / 201 coco)")
    p.add_argument("--dataset", choices=("voc", "coco"), default="voc",
                   help="det only: the anchor and class config the artifact was trained on")
    p.add_argument("--image_size", type=int, default=None,
                   help="input size; defaults per workload (cls 224, seg 512 [the image "
                        "HEIGHT, width defaults to 2x], gan 256, det fixed by the net "
                        "config: 300)")
    p.add_argument("--image_width", type=int, default=None,
                   help="seg only: override the 2:1 Cityscapes aspect")
    p.add_argument("--ngf", type=int, default=64, help="generator width (gan)")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--iters", type=int, default=30)
    p.add_argument("--source", choices=("synthetic", "folder"), default="synthetic")
    p.add_argument("--data_dir", default=None, help="--source folder: the images' root")
    p.add_argument("--fuse_int8", action="store_true",
                   help="run each Frost block as one fused CUDA kernel (FrostNet only)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--dp", type=int, default=1,
                   help="replicas on cuda:0..N-1, each request batch split over them")
    p.add_argument("--output", default=None,
                   help="cls: top-k jsonl; det: detections jsonl; seg, gan: a directory of "
                        "PNGs")
    p.add_argument("--save_logits", default=None, metavar="PATH",
                   help="save the first request batch's output (.npy)")
    p.add_argument("--predict_batches", type=int, default=4)
    p.add_argument("--topk", type=int, default=5)
    return p


def cli():
    main(build_parser().parse_args())


if __name__ == "__main__":
    cli()
