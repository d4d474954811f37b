"""One run of one cell of the port's benchmark.

    python -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. It finds the cell in ``BENCHMARK.json`` and
its configuration, traffic and limits under ``portbench/``, makes weights
and inputs on the device from ``--seed``, sets up and warms the cell's own
shapes, measures for ``--seconds``, checks what the timed path produced
against the plain reference, and prints one JSON line last on standard
output (the compared numbers beside their limits also go last to standard
error). It runs only on an NVIDIA card: without one, or without as many as
the cell asks for, it prints no result and exits 2. The port's kernels are
built once into the checkout's ``build/`` (``ops/cuda_build.py``); every
other cache of a run stays under the checkout or its ``TMPDIR``.
"""
from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from portbench.core import PACKAGE, Bench, forbidden_modules, result_line  # noqa: E402

# caches of libraries the port might reach, inside the checkout at fixed paths
_CACHES = {"TORCH_EXTENSIONS_DIR": "build/torch_extensions", "TRITON_CACHE_DIR": "build/triton"}


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python -m portbench.run", description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def run_cell(bench: Bench, args: argparse.Namespace, device, started: float) -> dict:
    """The result line of one run of ``args.workload`` on ``device``."""
    cell = bench.cell(args.workload, args.seed, args.seconds, bool(args.trace), device, started)
    outcome = bench.driver(cell.traffic, cell.config).run(cell)
    units = {m["name"]: m["unit"] for m in cell.e2e + cell.per_layer}
    return result_line(outcome, units)


def main(argv=None) -> int:
    args = parse(argv)
    root = PACKAGE.parent
    for var, rel in _CACHES.items():
        os.environ[var] = str(root / rel)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    bench = Bench(PACKAGE)
    chips = bench.workload(args.workload)["chips"]

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    from frostnet_tpu_torch.ops import cuda_build

    cuda_build.build()  # every kernel source at once, into the checkout's build/
    line = run_cell(bench, args, torch.device("cuda", 0), STARTED)
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {found}; no result", file=sys.stderr)
        return 3
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
