"""Where the time goes in the PyTorch port on the GPU: INT8 serving or a QAT step.

Serving (the default): the committed full-width fixture
(frostnet_quant_large_1_0, qnnpack, 224x224) through
``frostnet_tpu_torch.serve.Int8Predictor``, fused and unfused, for a few
forwards with device-resident input.

Training (``--train``): the QAT train step as ``bench.py`` configures it
(bf16 compute, QSGD lr 0.04, ``grouped_weight_decay(4e-5)``, after
``start_qat``), weights from ``numpy_init(seed 0)``, a device-resident
uint8 batch; and the FP32 (StatAssist) step beside it.

Each run is traced with ``torch.profiler``; the report gives the device time
by kernel group (the port's CUDA kernels, the convolutions, the other torch
ops) and the device's busy and idle share of the profiled window. Writes
``build/profile_torch_serving.json`` or ``build/profile_torch_training.json``
(or ``--out``).

Run on a machine with one CUDA card, from the repository root:

    python3 scripts/profile_torch_serving.py [--batch 8] [--iters 10]
    python3 scripts/profile_torch_serving.py --train [--batch 128] [--iters 5]
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

_CONV_MARKS = ("conv", "wgrad", "dgrad", "fprop", "implicit", "xmma", "cudnn", "winograd",
               "depthwise", "nhwc")

ARTIFACT = os.path.join(ROOT, "frostnet_tpu_torch", "testdata",
                        "frostnet_quant_large_1_0_int8.npz")


def _group(name: str) -> str:
    if "frost_block_kernel" in name:
        return "frost_block_int8 (CUDA)"
    if "int8_matmul_requant_kernel" in name:
        return "int8_matmul_requant (CUDA)"
    if "fq_observe_kernel" in name or "fq_quantize_kernel" in name:
        return "fake_quant_observe (CUDA)"
    if any(m in name.lower() for m in _CONV_MARKS):
        return "convolutions (cuDNN)"
    return "other torch ops"


def _busy_us(intervals):
    busy, end = 0.0, -1.0
    for s, e in sorted(intervals):
        if e <= end:
            continue
        busy += e - max(s, end)
        end = e
    return busy


def profile_forwards(fn, iters):
    """Trace ``iters`` calls of ``fn`` after 3 warm-up calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device work only: user annotations (the optimizer's step range) span it
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and not e.name.startswith("Optimizer.")]
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
        "host_wall_ms_per_call": wall_ms / iters,
        "device_window_ms_per_call": window_us / iters / 1e3,
        "device_busy_ms_per_call": busy_us / iters / 1e3,
        "device_idle_share_of_window": 1.0 - busy_us / window_us,
        "groups_ms_per_call": {g: {"ms": v[0], "launches": v[1] // iters}
                               for g, v in groups.items()},
        "top_kernels_ms_per_call": [{"name": n[:120], "ms": v[0], "launches": v[1] // iters}
                                    for n, v in top],
    }


def _print(key, r):
    print(f"[{key}] host {r['host_wall_ms_per_call']:.3f} ms/call, device busy "
          f"{r['device_busy_ms_per_call']:.3f} ms of a {r['device_window_ms_per_call']:.3f} ms "
          f"window (idle {100 * r['device_idle_share_of_window']:.1f}%)")
    for g, v in sorted(r["groups_ms_per_call"].items(), key=lambda kv: -kv[1]["ms"]):
        print(f"    {g:32s} {v['ms']:.4f} ms, {v['launches']} launches")
    for k in r["top_kernels_ms_per_call"][:6]:
        print(f"    top: {k['ms']:.4f} ms x{k['launches']} {k['name'][:90]}")


def profile_training(batch, iters):
    """The FP32 and QAT train steps of the benchmarked configuration."""
    from frostnet_tpu_torch.models import create_model
    from frostnet_tpu_torch.nn import FP32, QAT
    from frostnet_tpu_torch.optim import get_optimizer, grouped_weight_decay
    from frostnet_tpu_torch.train import create_train_state, make_train_step

    model = create_model("frostnet_quant_large_1_0", num_classes=1000, dtype=torch.bfloat16)
    tx = get_optimizer("QSGD", 0.04, weight_decay=grouped_weight_decay(4e-5))
    state = create_train_state(model, tx, seed=0, device="cuda")
    rng = np.random.RandomState(100)
    data = {"image": torch.as_tensor(rng.randint(0, 256, (batch, 224, 224, 3)).astype(np.uint8),
                                     device="cuda"),
            "label": torch.as_tensor(rng.randint(0, 1000, batch), device="cuda")}
    report = {}
    step = make_train_step(FP32, num_classes=1000)
    report["fp32_step"] = profile_forwards(lambda: step(state, data), iters)
    state.start_qat()
    step = make_train_step(QAT, num_classes=1000)
    report["qat_step"] = profile_forwards(lambda: step(state, data), iters)
    return report


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--train", action="store_true", help="profile the train steps")
    ap.add_argument("--batch", type=int, default=None, help="default 8, or 128 with --train")
    ap.add_argument("--iters", type=int, default=None, help="default 10, or 5 with --train")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_torch_serving: needs a CUDA device", file=sys.stderr)
        return 1
    batch = args.batch or (128 if args.train else 8)
    iters = args.iters or (5 if args.train else 10)
    out = args.out or os.path.join(ROOT, "build", "profile_torch_training.json" if args.train
                                   else "profile_torch_serving.json")
    report = {"card": torch.cuda.get_device_name(0), "batch": batch}
    if args.train:
        report.update(profile_training(batch, iters))
        for key in ("fp32_step", "qat_step"):
            _print(f"{key} bs{batch}", report[key])
    else:
        x = torch.as_tensor(np.random.RandomState(0).randn(batch, 224, 224, 3)
                            .astype(np.float32), device="cuda")
        for fuse in (True, False):
            pred = Int8Predictor(artifact=ARTIFACT, fuse_int8=fuse, device="cuda")
            key = "fused" if fuse else "unfused"
            report[key] = profile_forwards(lambda: pred(x), iters)
            _print(f"{key} bs{batch}", report[key])
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
