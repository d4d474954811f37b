"""Time the bf16 QAT train step of any checkout, as ``chip_smoke.py`` phase 10 runs it.

Runs on a machine with one CUDA card. ``--root`` names the checkout whose
``frostnet_tpu_torch`` is timed (default: this one), so parent and change
alternate on one card in one call, e.g.

    for r in build/parent . . build/parent; do
        python3 scripts/time_train_step.py --root $r --out build/step.jsonl
    done

frostnet_quant_large_1_0 in bf16 from ``numpy_init(seed 0)``, QSGD lr 0.04
with ``grouped_weight_decay(4e-5)``, after ``start_qat``, on the root's
``train_batch(0, batch)`` held on the card, at each batch of ``BATCHES``:
``WARMUP`` steps, then ``REPS`` runs of ``STEPS`` steps, each run timed with
CUDA events (ms a step). Prints the card line, then one JSON line, which
``--out`` appends to a file.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import torch

BATCHES = (128, 256)
WARMUP, REPS, STEPS = 3, 3, 10


def step_ms(chip_smoke, batch_size, dev):
    """ms a QAT step at ``batch_size``, one value a run."""
    from frostnet_tpu_torch.models import create_model
    from frostnet_tpu_torch.nn import QAT
    from frostnet_tpu_torch.optim import get_optimizer, grouped_weight_decay
    from frostnet_tpu_torch.train import create_train_state, make_train_step

    model = create_model(chip_smoke.MODEL, num_classes=chip_smoke.CLASSES, dtype=torch.bfloat16)
    tx = get_optimizer("QSGD", 0.04, weight_decay=grouped_weight_decay(4e-5))
    state = create_train_state(model, tx, seed=0, device=dev)
    batch = {k: torch.as_tensor(v, device=dev)
             for k, v in chip_smoke.train_batch(0, batch_size).items()}
    state.start_qat()
    step = make_train_step(QAT, num_classes=chip_smoke.CLASSES)
    for _ in range(WARMUP):
        step(state, batch)
    return [chip_smoke.time_ms(lambda: step(state, batch), reps=STEPS, warmup=0)
            for _ in range(REPS)]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    if not torch.cuda.is_available():
        print("time_train_step: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke  # the root's own: its model name, batches, timer and card line

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    report = {"root": root, "card": chip_smoke.card_line()}
    for b in BATCHES:
        report[f"qat_ms_per_step_bs{b}"] = step_ms(chip_smoke, b, dev)
        torch.cuda.empty_cache()
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "a") as f:
            f.write(json.dumps(report) + "\n")
    print(report["card"])
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
