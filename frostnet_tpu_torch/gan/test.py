"""Style-transfer inference (``frostnet_tpu/gan/test.py``; reference
Style_Transfer/test.py:29-84): load a generator, run its QAT_FROZEN and
frozen INT8 passes, write an HTML gallery and log each image's qat/int8
delta.

The generator is restored from a trainer checkpoint (``--checkpoint
runs/gan/latest_G``, its variables only); ``--export_int8 PATH`` writes its
INT8 artifact (``quant.export_int8``), which ``serve --workload gan``
serves. The INT8 pass is ``quant.freeze``'s frozen graph: a forward of
``resnet_9blocks`` launches the dense 3x3 conv kernel 20 times (the blocks'
and the up convs' 3x3s; 14 for ``resnet_6blocks``) and the INT8 matmul 3
times (the stem and the two strided downs, by im2col). The
gallery's PNGs are written without PIL (``visualizer.write_png``). Flows:
synthetic pairs, an aligned folder, ``--dataset single`` (one folder of
images, real/fake only) and ``--dataset colorization`` (L -> ab, shown in
RGB). ``--ngf`` (64, the JAX tester's fixed width) and ``--device`` (cuda
unless ``cpu``) are the port's additions.

Run: python -m frostnet_tpu_torch.gan.test --checkpoint runs/gan/latest_G \\
       --netG resnet_9blocks --dataset synthetic --num_test 4
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..nn import QAT_FROZEN
from ..quant import export_int8, freeze
from ..quant.freeze import resolve_device
from ..utils.checkpoint import restore_model_variables
from ..utils.logging import MetricLogger
from .data import AlignedDataset, SyntheticPairs, apply_direction
from .models import make_net_state
from .networks import define_g
from .visualizer import HTMLGallery


def _dataset(args, colorize: bool):
    if args.dataset == "synthetic":
        return SyntheticPairs(args.crop_size, args.num_test, 1, seed=1)
    if colorize:
        from .data import ColorizationDataset
        return ColorizationDataset(args.data_root, "test", 1, args.crop_size, args.crop_size,
                                   seed=1)
    if args.dataset == "single":
        from .data import SingleDataset
        return SingleDataset(args.data_root, 1, load_size=args.crop_size,
                             crop_size=args.crop_size, seed=1)
    return AlignedDataset(args.data_root, "test", 1, args.crop_size, args.crop_size, seed=1)


def main(args):
    """Returns ``{"qat", "int8"}`` (each image's outputs, numpy),
    ``"delta"`` (each image's max |qat - int8|), ``"gallery"`` and, with
    ``--export_int8``, ``"artifact_bytes"``."""
    device = resolve_device(args.device)
    logger = MetricLogger(None, name="gan-test")
    colorize = args.dataset == "colorization"
    in_nc, out_nc = (1, 2) if colorize else (3, 3)
    net_g = define_g(output_nc=out_nc, ngf=args.ngf, netG=args.netG, quantized=True,
                     input_nc=in_nc)
    g_state = make_net_state(net_g, None, 0, device)
    if args.checkpoint:
        restore_model_variables(args.checkpoint, g_state)
    out = {"qat": [], "int8": [], "delta": []}
    if args.export_int8:
        out["artifact_bytes"] = export_int8(net_g, args.export_int8)
        print(f"INT8 netG artifact written: {args.export_int8} "
              f"({out['artifact_bytes'] / 1e6:.2f} MB)")

    int8_fn = freeze(net_g, device, args.crop_size)
    gallery = HTMLGallery(os.path.join(args.results_dir, "web"), "gan test")
    with torch.inference_mode():
        for i, batch in enumerate(_dataset(args, colorize)):
            if i >= args.num_test:
                break
            batch = apply_direction(batch, args.direction)
            a = torch.as_tensor(batch["A"]).to(device)
            fake_qat = net_g(a, mode=QAT_FROZEN).cpu().numpy()
            fake_int8 = int8_fn(a).cpu().numpy()
            if colorize:
                # the reference's display (colorization_model.py:48-68): the
                # input L joined with the real and fake ab, Lab -> RGB
                from .data import colorization_to_rgb
                L = np.asarray(batch["A"])
                visuals = {"real_A": np.repeat(L, 3, axis=-1),
                           "fake_B_qat": colorization_to_rgb(L, fake_qat) * 2 - 1,
                           "fake_B_int8": colorization_to_rgb(L, fake_int8) * 2 - 1,
                           "real_B": colorization_to_rgb(L, np.asarray(batch["B"])) * 2 - 1}
            else:
                visuals = {"real_A": batch["A"], "fake_B_qat": fake_qat,
                           "fake_B_int8": fake_int8}
                if "B" in batch:  # the single dataset has no paired domain
                    visuals["real_B"] = batch["B"]
            gallery.add_images(visuals, f"img{i:04d}")
            delta = float(np.abs(fake_qat - fake_int8).max())
            out["qat"].append(fake_qat)
            out["int8"].append(fake_int8)
            out["delta"].append(delta)
            logger.info(f"[{i}] qat/int8 delta: {delta:.4f}")
    out["gallery"] = os.path.join(args.results_dir, "web", "index.html")
    logger.info(f"gallery at {out['gallery']}")
    return out


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--netG", default="resnet_6blocks")
    p.add_argument("--ngf", type=int, default=64)
    p.add_argument("--dataset", default="synthetic",
                   help="synthetic | colorization | single (one unpaired dir) | anything "
                        "else: aligned A|B")
    p.add_argument("--data_root", default="./datasets/facades")
    p.add_argument("--crop_size", type=int, default=256)
    p.add_argument("--num_test", type=int, default=4)
    p.add_argument("--direction", default="AtoB", choices=["AtoB", "BtoA"],
                   help="BtoA swaps the domains")
    p.add_argument("--results_dir", default="./results/gan")
    p.add_argument("--export_int8", default=None, metavar="PATH",
                   help="write the generator's INT8 artifact (.npz)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def cli(argv=None):
    main(build_parser().parse_args(argv))


if __name__ == "__main__":
    cli()
