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


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--out", default=None)
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
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    print(card)
    print(json.dumps({k: {"wall_ms": v["wall_ms"], "device_ms": v["device_ms"]}
                      for k, v in report["batches"].items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
