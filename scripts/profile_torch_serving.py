"""Where the time goes in INT8 serving of the PyTorch port, on the GPU.

Serves the committed full-width fixture (frostnet_quant_large_1_0, qnnpack,
224x224) through ``frostnet_tpu_torch.serve.Int8Predictor``, fused and
unfused, under ``torch.profiler`` for a few forwards with device-resident
input, and reports the device time by kernel group (the port's two CUDA
kernels, the rest of the torch ops) and the device's busy and idle share of
the profiled window. Writes ``build/profile_torch_serving.json`` (or ``--out``).

Run on a machine with one CUDA card, from the repository root:

    python3 scripts/profile_torch_serving.py [--batch 8] [--iters 10]
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from frostnet_tpu_torch.serve import Int8Predictor  # noqa: E402

ARTIFACT = os.path.join(ROOT, "frostnet_tpu_torch", "testdata",
                        "frostnet_quant_large_1_0_int8.npz")


def _group(name: str) -> str:
    if "frost_block_kernel" in name:
        return "frost_block_int8 (CUDA)"
    if "int8_matmul_requant_kernel" in name:
        return "int8_matmul_requant (CUDA)"
    return "torch ops"


def _busy_us(intervals):
    busy, end = 0.0, -1.0
    for s, e in sorted(intervals):
        if e <= end:
            continue
        busy += e - max(s, end)
        end = e
    return busy


def profile_forwards(pred, x, iters):
    for _ in range(3):
        pred(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            pred(x)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        raise RuntimeError("torch.profiler recorded no device activity on this machine")
    spans = [(e.time_range.start, e.time_range.end) for e in kernels]
    window_us = max(e for _, e in spans) - min(s for s, _ in spans)
    busy_us = _busy_us(spans)
    groups = collections.defaultdict(lambda: [0.0, 0])
    names = collections.defaultdict(lambda: [0.0, 0])
    for e in kernels:
        dur = e.time_range.elapsed_us()
        groups[_group(e.name)][0] += dur / iters / 1e3
        groups[_group(e.name)][1] += 1
        names[e.name][0] += dur / iters / 1e3
        names[e.name][1] += 1
    top = sorted(names.items(), key=lambda kv: -kv[1][0])[:12]
    return {
        "iters": iters,
        "host_wall_ms_per_forward": wall_ms / iters,
        "device_window_ms_per_forward": window_us / iters / 1e3,
        "device_busy_ms_per_forward": busy_us / iters / 1e3,
        "device_idle_share_of_window": 1.0 - busy_us / window_us,
        "groups_ms_per_forward": {g: {"ms": v[0], "launches": v[1] // iters}
                                  for g, v in groups.items()},
        "top_kernels_ms_per_forward": [{"name": n[:120], "ms": v[0], "launches": v[1] // iters}
                                       for n, v in top],
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "profile_torch_serving.json"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_torch_serving: needs a CUDA device", file=sys.stderr)
        return 1
    x = torch.as_tensor(np.random.RandomState(0).randn(args.batch, 224, 224, 3)
                        .astype(np.float32), device="cuda")
    report = {"card": torch.cuda.get_device_name(0), "batch": args.batch}
    for fuse in (True, False):
        pred = Int8Predictor(artifact=ARTIFACT, fuse_int8=fuse, device="cuda")
        key = "fused" if fuse else "unfused"
        report[key] = profile_forwards(pred, x, args.iters)
        r = report[key]
        print(f"[{key} bs{args.batch}] host {r['host_wall_ms_per_forward']:.3f} ms/forward, "
              f"device busy {r['device_busy_ms_per_forward']:.3f} ms of a "
              f"{r['device_window_ms_per_forward']:.3f} ms window "
              f"(idle {100 * r['device_idle_share_of_window']:.1f}%)")
        for g, v in sorted(r["groups_ms_per_forward"].items(), key=lambda kv: -kv[1]["ms"]):
            print(f"    {g:32s} {v['ms']:.4f} ms, {v['launches']} launches")
        for k in r["top_kernels_ms_per_forward"][:6]:
            print(f"    top: {k['ms']:.4f} ms x{k['launches']} {k['name'][:90]}")
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
