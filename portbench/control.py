"""The readings that the limits of ``correct`` are set from, on the card at a
cell's own size, with no measured window (the benchmark's runs never run
this):

* the program against the plain reference on each seed (the lower reading);
* the control: the reference itself in the program's place, computed one
  precision lower (TF32 convolutions for the float32 training step, 4-bit
  grids for the INT8 serving path), against the reference;
* for training, a planted fault: the reference with half of each batch left
  out (the mean over the rest) in the program's place. A step that returns
  its state unchanged reads 1 by the change's measure and needs no run.

The reference follows whatever is in the program's place as it follows the
program (``drivers/train_cls.py``).

    python -m portbench.control --workload <cell> --seeds 11,12,13 --control 3 \\
        [--out chiprun_out/control.jsonl]

One JSON line a seed; the control and the fault run on the first
``--control`` seeds.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from portbench.core import PACKAGE, Bench
from portbench.drivers import common


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m portbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated seeds")
    p.add_argument("--control", type=int, default=3, help="seeds that also run the control")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench.control: no CUDA card", file=sys.stderr)
        return 2
    from frostnet_tpu_torch.ops import cuda_build

    cuda_build.build()
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    bench = Bench(PACKAGE)
    dev = torch.device("cuda", 0)
    lines = []
    for n, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        cell = bench.cell(args.workload, seed, 0.0, False, dev, t)
        driver = bench.driver(cell.traffic, cell.config).DRIVER
        line = {"workload": args.workload, "seed": seed,
                **driver.readings(cell, n < args.control), "seconds": time.perf_counter() - t,
                "device": torch.cuda.get_device_name(dev), "power_limit_w": common.power_limit_w()}
        print(json.dumps(line), flush=True)
        lines.append(line)
        torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "a") as f:
            for line in lines:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
