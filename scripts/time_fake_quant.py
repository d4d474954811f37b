"""Time the observe-and-fake-quant kernel at the 166 sites of a bf16 QAT forward.

Runs on a machine with one CUDA card. ``--root`` names the checkout whose
``frostnet_tpu_torch`` is timed (default: this one), so two trees compare on
one card in one call, e.g. a ``git archive`` of a parent commit beside the
working tree:

    python3 scripts/time_fake_quant.py --root build/parent --out build/parent.json
    python3 scripts/time_fake_quant.py --out build/change.json

The sites are those of the training step that ``chip_smoke.py`` phase 10
times: frostnet_quant_large_1_0 in bf16, ``numpy_init(seed 0)``, QSGD lr
0.04 with ``grouped_weight_decay(4e-5)``, one QAT step on ``train_batch(0)``
at batch 128, then one QAT forward on the same batch, whose 166 per-tensor
sites (x, the observer state as the site found it, the spec) are kept. Each
site is first checked against the plain version (y, mask, new state,
qparams, and the QAT_FROZEN pass), then timed:

* ``ms``: device time, the summed durations of the kernels that
  torch.profiler records (one session a bucket; per site where the trace
  holds every kernel), in all and by bucket;
* ``graph_ms``: one replay of a CUDA graph of the sites (each bucket alone,
  then all of them), timed with CUDA events: the device's gaps between
  launches count, the host's work does not;
* ``wall_ms``: CUDA events around back-to-back calls of all the sites, the
  wrappers' host work included;
* ``host_ms``: the host's clock around a pass over the sites (each bucket
  alone, then all of them), ended before the device is: the wrappers' work
  (the median of ``WALL_REPS`` passes).

Sites fall into the buckets of ``BUCKETS`` (weights, then activations by the
bytes of x); each bucket's bound is the bytes of ``chip_smoke.fq_cost`` (x
read once, y and the mask written once) over the card's memory rate. Prints
one line per bucket, the card line, then one JSON line. ``chip_smoke.py``
phase 10 takes its kernel times from :func:`time_sites`.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

BATCH = 128
MIB = 2 ** 20
BUCKETS = ("weights", "activations < 16 MiB", "activations 16-50 MiB", "activations >= 50 MiB")
PROFILE_REPS = 3
GRAPH_REPS = 3
WALL_REPS = 5


def site_bucket(x: torch.Tensor, spec) -> str:
    """The bucket of one site: weights (the symmetric weight grid), else
    activations by the bytes of x."""
    if spec.symmetric:
        return BUCKETS[0]
    nbytes = x.numel() * x.element_size()
    return BUCKETS[1] if nbytes < 16 * MIB else BUCKETS[2] if nbytes < 50 * MIB else BUCKETS[3]


def profile_sites(run, count, per_site, reps=PROFILE_REPS):
    """Device time of ``count`` sites that ``run()`` calls in order, each
    launching ``per_site`` kernels: the durations of the CUDA kernels
    torch.profiler records over ``reps`` runs. Returns (ms of each site, in
    start order, or None where the trace lacks kernels; ms of all the
    sites; kernels recorded)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            run()
        torch.cuda.synchronize()
    events = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    if not events:
        raise RuntimeError("torch.profiler recorded no device activity")
    total = sum(e.time_range.elapsed_us() for e in events) / 1e3 / reps
    if len(events) != count * per_site * reps:
        return None, total, len(events)
    ms = [0.0] * count
    for i, e in enumerate(events):
        ms[(i // per_site) % count] += e.time_range.elapsed_us() / 1e3 / reps
    return ms, total, len(events)


def host_ms(fn, reps: int = WALL_REPS) -> float:
    """The host's time to issue ``fn`` (its launches queued, not finished),
    the median of ``reps`` passes."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return sorted(times)[len(times) // 2]


def time_sites(sites, time_ms, graph_ms, fq_cost, bound):
    """The kernel over ``sites`` (``[(x, min_val, max_val, spec)]``) through
    the importable ``frostnet_tpu_torch``: per-site and per-bucket device
    time (profiler), each bucket's and the whole forward's CUDA-graph time,
    the wall time of all sites, and each bucket's bound (``fq_cost`` and
    ``bound`` from the root's ``chip_smoke``). The observer states are
    copies: the captured ones stay as they were."""
    from frostnet_tpu_torch.ops.fake_quant import fake_quant_observe

    states = [(mn.clone(), mx.clone()) for _, mn, mx, _ in sites]

    def run(idx):
        def fn():
            for i in idx:
                x, _, _, spec = sites[i]
                fake_quant_observe(x, states[i][0], states[i][1], spec)
        return fn

    every = list(range(len(sites)))
    before = fake_quant_observe.launches
    run(every[:1])()
    per_site = fake_quant_observe.launches - before
    rows, buckets = [], {}
    for i, (x, _, _, spec) in enumerate(sites):
        nbytes, nops = fq_cost(x)
        b_ms, _ = bound(nbytes, nops)
        rows.append({"site": i, "shape": list(x.shape), "dtype": str(x.dtype).replace("torch.", ""),
                     "bucket": site_bucket(x, spec), "bytes": nbytes, "bound_ms": b_ms, "ms": None})
    for name in BUCKETS:
        idx = [r["site"] for r in rows if r["bucket"] == name]
        if not idx:
            continue
        site_ms, ms, recorded = profile_sites(run(idx), len(idx), per_site)
        for i, v in zip(idx, site_ms or []):
            rows[i]["ms"] = v
        got = {"sites": len(idx), "ms": ms, "kernels_recorded": recorded,
               "kernels_expected": len(idx) * per_site * PROFILE_REPS,
               "bound_ms": sum(rows[i]["bound_ms"] for i in idx),
               "graph_ms": graph_ms(run(idx), GRAPH_REPS), "host_ms": host_ms(run(idx))}
        got["bound_share"] = got["bound_ms"] / got["ms"]
        buckets[name] = got
    nbytes = sum(r["bytes"] for r in rows)
    nops = sum(fq_cost(x)[1] for x, _, _, _ in sites)
    b_ms, b_by = bound(nbytes, nops)
    out = {"sites": len(sites), "launches_per_site": per_site,
           "ms": sum(b["ms"] for b in buckets.values()),
           "kernels_recorded": sum(b["kernels_recorded"] for b in buckets.values()),
           "kernels_expected": len(sites) * per_site * PROFILE_REPS,
           "graph_ms": graph_ms(run(every), GRAPH_REPS), "wall_ms": time_ms(run(every), WALL_REPS),
           "host_ms": host_ms(run(every)),
           "bound_ms": b_ms, "bound_by": b_by, "buckets": buckets, "per_site": rows}
    out["bound_share"] = b_ms / out["ms"]
    return out


def bucket_lines(got):
    """One line a bucket (and one where the trace lacked kernels)."""
    for name, b in got["buckets"].items():
        yield (f"{name}: {b['sites']} sites, {b['ms']:.4f} ms device, {b['graph_ms']:.4f} graph, "
               f"{b['host_ms']:.4f} host, bound {b['bound_ms']:.4f} "
               f"({100 * b['bound_share']:.1f}%)")
    if got["kernels_recorded"] != got["kernels_expected"]:
        yield (f"torch.profiler recorded {got['kernels_recorded']} of "
               f"{got['kernels_expected']} kernels: the device ms count those only")


def phase10_sites(chip_smoke, dev):
    """The 166 sites of one bf16 QAT forward at ``BATCH`` of the phase-10
    model, after one QAT step (so the observers take the moving-average
    step, as in that phase's timed steps)."""
    from frostnet_tpu_torch.models import create_model
    from frostnet_tpu_torch.nn import QAT
    from frostnet_tpu_torch.optim import get_optimizer, grouped_weight_decay
    from frostnet_tpu_torch.train import create_train_state, make_train_step, prep_image

    model = create_model(chip_smoke.MODEL, num_classes=chip_smoke.CLASSES, dtype=torch.bfloat16)
    tx = get_optimizer("QSGD", 0.04, weight_decay=grouped_weight_decay(4e-5))
    state = create_train_state(model, tx, seed=0, device=dev)
    batch = {k: torch.as_tensor(v, device=dev) for k, v in chip_smoke.train_batch(0, BATCH).items()}
    state.start_qat()
    make_train_step(QAT, num_classes=chip_smoke.CLASSES)(state, batch)
    return chip_smoke.capture_sites(state.model, prep_image(batch["image"]), QAT)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    if not torch.cuda.is_available():
        print("time_fake_quant: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke  # the root's own: its capture, checks, timers and card line

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = chip_smoke.card_line()
    sites = phase10_sites(chip_smoke, dev)
    for i, (x, mn, mx, spec) in enumerate(sites):
        chip_smoke.check_site(f"site {i} {tuple(x.shape)} {x.dtype}", x, mn, mx, spec)
    torch.cuda.synchronize()
    got = time_sites(sites, chip_smoke.time_ms, chip_smoke.graph_ms, chip_smoke.fq_cost,
                     lambda b, o: chip_smoke.bound(b, o, chip_smoke.PEAK_F32_OPS_PER_S))
    print(f"{len(sites)} sites == plain; {got['launches_per_site']} launches a site; "
          f"{got['ms']:.4f} ms device, {got['graph_ms']:.4f} graph, {got['wall_ms']:.4f} wall, "
          f"{got['host_ms']:.4f} host; "
          f"bound {got['bound_ms']:.4f} {got['bound_by']} ({100 * got['bound_share']:.1f}%)",
          flush=True)
    for line in bucket_lines(got):
        print("    " + line, flush=True)
    report = {"root": root, "card": card, "batch": BATCH, **got}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    print(card)
    print(json.dumps({k: got[k] for k in ("sites", "launches_per_site", "ms", "graph_ms",
                                          "wall_ms", "host_ms", "bound_ms")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
