"""Time the fused INT8 Frost-block kernel at the 18 blocks of frostnet_quant_large_1_0.

Runs on a machine with one CUDA card. ``--root`` names the checkout whose
``frostnet_tpu_torch`` is timed (default: this one), so two trees compare on
one card in one call, e.g. a ``git archive`` of a parent commit beside the
working tree:

    python3 scripts/time_frost_block.py --root build/parent --out build/parent.json
    python3 scripts/time_frost_block.py --out build/change.json

Each block at 224x224 (random weights from ``random_block_case``, seed = the
block's index) at batch 1, 8 and 128: ``wall_ms``, CUDA events around
back-to-back calls (the wrapper's host work included), and ``device_ms``, one
replay of a CUDA graph of the launches (the root's own ``chip_smoke.time_ms``
and ``graph_ms``), ``REPS`` calls each. Checks each block against its plain
version first. Prints the card line, then one JSON line. ``chip_smoke.py``
phase 6 takes its per-batch sums from :func:`time_blocks`.

``--serving`` also times the committed INT8 fixture served through
``Int8Predictor``, fused and unfused, at batch 8 and 128, as ``chip_smoke.py``
phase 6 times it (``time_ms`` of whole forwards on device-resident input):
the host's cost of the wrappers shows there.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import torch

BATCHES = (1, 8, 128)
REPS = 20


def time_blocks(specs, batch, time_ms, graph_ms):
    """Each ``(name, spec)`` of ``specs`` at ``batch`` through the importable
    ``frostnet_tpu_torch``, checked against its plain version, then timed with
    ``time_ms`` (wall) and ``graph_ms`` (device). Returns the rows and their
    sums."""
    from frostnet_tpu_torch.ops import frost_block as fb

    rows = []
    for i, (name, spec) in enumerate(specs):
        x, p = fb.random_block_case(spec, batch, seed=i, device="cuda")
        if not torch.equal(fb.frost_block_int8(x, p, spec), fb.frost_block_int8_plain(x, p, spec)):
            raise AssertionError(f"{name} batch {batch}: kernel != plain version")
        run = lambda: fb.frost_block_int8(x, p, spec)  # noqa: E731
        rows.append({"block": name, "wall_ms": time_ms(run, REPS), "device_ms": graph_ms(run, REPS)})
    return {"blocks": rows, "wall_ms": sum(r["wall_ms"] for r in rows),
            "device_ms": sum(r["device_ms"] for r in rows)}


def time_serving(root, time_ms):
    """ms a batch of the fixture served fused and unfused at batch 8 and 128
    (10 and 3 timed forwards after one), fused checked against unfused."""
    import numpy as np

    from frostnet_tpu_torch.serve import Int8Predictor

    artifact = os.path.join(root, "frostnet_tpu_torch", "testdata",
                            "frostnet_quant_large_1_0_int8.npz")
    preds = {fuse: Int8Predictor("frostnet_quant_large_1_0", artifact=artifact, image_size=224,
                                 fuse_int8=fuse, device="cuda") for fuse in (True, False)}
    out = {}
    for b in (8, 128):
        x = torch.as_tensor(np.random.RandomState(1).randn(b, 224, 224, 3).astype(np.float32),
                            device="cuda")
        if not torch.equal(preds[True](x), preds[False](x)):
            raise AssertionError(f"batch {b}: fused logits != unfused logits")
        for fuse in (True, False):
            out[f"bs{b}_{'fused' if fuse else 'unfused'}"] = time_ms(
                lambda: preds[fuse](x), reps=10 if fuse else 3, warmup=1)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--out", default=None)
    ap.add_argument("--serving", action="store_true")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    if not torch.cuda.is_available():
        print("time_frost_block: no CUDA device", file=sys.stderr)
        return 1
    from frostnet_tpu_torch.models import create_model
    import chip_smoke  # the root's own: its timers and card line

    card = chip_smoke.card_line()
    specs = create_model("frostnet_quant_large_1_0").block_specs(224)
    report = {"root": root, "card": card, "batches": {}}
    for batch in BATCHES:
        got = report["batches"][str(batch)] = time_blocks(specs, batch, chip_smoke.time_ms,
                                                          chip_smoke.graph_ms)
        print(f"batch {batch}: wall {got['wall_ms']:.4f} ms, device {got['device_ms']:.4f} ms; "
              + " ".join(f"{r['block']} {r['device_ms']:.4f}" for r in got["blocks"]), flush=True)
    if args.serving:
        report["serving"] = time_serving(root, chip_smoke.time_ms)
        print("serving: " + ", ".join(f"{k} {v:.4f} ms" for k, v in report["serving"].items()),
              flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    print(card)
    print(json.dumps({**{k: {"wall_ms": v["wall_ms"], "device_ms": v["device_ms"]}
                         for k, v in report["batches"].items()},
                      "serving": report.get("serving")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
