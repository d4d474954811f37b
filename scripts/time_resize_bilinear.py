"""Time the bilinear resize kernel at the three resizes of the served
segmentation model (``mobilenetv3_large``, 512x1024) at batch 8.

Runs on a machine with one CUDA card:

    python3 scripts/time_resize_bilinear.py --out build/resize.json

The shapes and each one's bound come from the benchmark's segmentation
serving cell and its ``resize_roofline.serve`` metric (:func:`seg_resizes`:
the LR-ASPP gate, the head's c4 to c1, the float tail to the image). Each
shape gets seeded random float32 values; the kernel is first checked bit for
bit against its plain version on the card, then timed as
``scripts/time_depthwise_int8.py`` times its kernel: ``device_ms`` (the
profiler's kernel durations a call, the median of 5 calls) and ``graph_ms``
(one replay of a CUDA graph of 10 calls, over 10; the line ``all`` replays
one graph of the three), ``plain_ms`` and ``plain_launches`` (the plain
version's kernels a call, by the profiler), ``library_ms`` (``graph_ms`` of
``F.interpolate`` on the same tensor, a channels-last NCHW view: the same
function in one library call, which rounds otherwise, so a yardstick of time
alone), ``bound_ms`` (input read and output written once at 3.35
TB/s).

Prints one line per shape and the total, then one JSON line.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from frostnet_tpu_torch.ops.resize import resize_bilinear, resize_bilinear_plain  # noqa: E402
from scripts.time_depthwise_int8 import card, graph_ms, profile_ms, shares, text  # noqa: E402

CELL = "seg-int8-serve"
METRIC = "resize_roofline.serve"


def seg_cell():
    """(the metric's module, the cell's table set, its image size, its batch)."""
    from portbench.core import Bench

    bench = Bench()
    cell = bench.workload(CELL)
    config = bench.config(cell["config"])
    traffic = bench.traffic(cell["traffic"])
    h, w = traffic["image_size"]
    return bench.module("metrics", METRIC), config["tables"][f"{h}x{w}"], (h, w), traffic["batch"]


def seg_resizes():
    """(Hin, Win, Hout, Wout, C) of each resize the metric counts."""
    metric, tables, image, _ = seg_cell()
    return metric.resize_rows(tables, image)


def interpolate(x: torch.Tensor, size) -> torch.Tensor:
    """``F.interpolate`` of the NHWC ``x`` to ``size``, align_corners."""
    return F.interpolate(x.permute(0, 3, 1, 2), size=size, mode="bilinear", align_corners=True)


def run(dev, log=print) -> dict:
    """Check and time the kernel at each shape of :func:`seg_resizes`."""
    metric, _, _, batch = seg_cell()
    rows, cases = [], []
    for i, (h, w, ho, wo, c) in enumerate(seg_resizes()):
        g = torch.Generator().manual_seed(2000 + i)
        x = (torch.randn((batch, h, w, c), generator=g) * 3).to(dev)
        cases.append((x, (ho, wo)))
        got = resize_bilinear(x, (ho, wo))
        if not torch.equal(got.view(torch.int32), resize_bilinear_plain(x, (ho, wo)).view(torch.int32)):
            raise AssertionError(f"{(h, w, ho, wo, c)}: the kernel differs from its plain version")
        dev_ms, n = profile_ms(lambda: resize_bilinear(x, (ho, wo)))
        plain_ms, plain_n = profile_ms(lambda: resize_bilinear_plain(x, (ho, wo)))
        row = {"shape": [batch, h, w, c, ho, wo], "device_ms": dev_ms, "launches": n,
               "graph_ms": graph_ms(lambda: resize_bilinear(x, (ho, wo))), "plain_ms": plain_ms,
               "plain_launches": plain_n,
               "library_ms": graph_ms(lambda: interpolate(x, (ho, wo))),
               "bound_ms": 1e3 * metric.resize_bound_s([(h, w, ho, wo, c)], batch)}
        rows.append(shares(row, "device_ms", "graph_ms"))
        log(f"{batch}x{h}x{w}x{c} -> {ho}x{wo}: {text(row)}; F.interpolate {ms(row)}")

    def all_resizes():
        for x, size in cases:
            resize_bilinear(x, size)

    total = {k: None if any(r[k] is None for r in rows) else sum(r[k] for r in rows)
             for k in ("device_ms", "graph_ms", "plain_ms", "bound_ms", "plain_launches",
                       "library_ms")}
    total["graph_all_ms"] = graph_ms(all_resizes, 1)
    shares(total, "device_ms", "graph_all_ms")
    log(f"all {len(rows)}: {text(total)}; F.interpolate {ms(total)} "
        f"(per-shape graphs {total['graph_ms']:.4f})")
    return {"batch": batch, "rows": rows, "total": total}


def ms(row: dict) -> str:
    return f"{row['library_ms']:.4f} ms (graph)"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    report = {"card": card(), "torch": torch.__version__, **run(torch.device("cuda"))}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
