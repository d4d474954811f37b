"""A tiny copy of the benchmark for CPU tests: the package's files copied
under a scratch root, each cell pointed at a small configuration (the
registry's ``frostnet_quant_small_0_35`` at 32x32 with 10 classes; the
seg registry's ``mobilenetv3_large`` at 64x128 or 64x64) and at small
copies of its traffic mix, under the cells' own names and limits."""
from __future__ import annotations

import argparse
import json
import shutil
import time
from pathlib import Path

import torch

from portbench.core import PACKAGE, Bench
from portbench.costs import conv_flops
from portbench.reference import frostnet, seg_mobilenetv3

TRAIN, SERVE = "frostnet-qat-train", "frostnet-int8-serve"
SEG_TRAIN, SEG_SERVE = "seg-qat-train", "seg-int8-serve"
SMALL = {"train": dict(batch=8, pool=6, trace_steps=1),
         "serve": dict(batch=4, pool=3, calibration_batches=4, calibration_batch=4,
                       warmup_requests=1, trace_requests=2, checked_requests=4, checked_logits=2)}


def tiny_config() -> dict:
    arch = {"stages": [[[3, 16, 1, 1, 1], [5, 24, 3, 4, 2], [3, 24, 3, 4, 1]],
                       [[5, 40, 3, 4, 2]],
                       [[5, 80, 3, 4, 2], [5, 80, 3, 4, 1], [3, 80, 3, 4, 1],
                        [5, 96, 3, 2, 1], [5, 96, 3, 4, 1], [5, 96, 3, 4, 1]],
                       [[5, 192, 6, 4, 2], [5, 192, 6, 4, 1], [5, 192, 6, 4, 1]],
                       [[5, 320, 6, 2, 1]]],
            "width_mult": 0.35, "last_channels": 1280, "num_classes": 10, "drop_rate": 0.2}
    tables = frostnet.shape_tables(arch, 32)
    return {"name": "tiny", "source": "test", "family": "cls", "reference": "frostnet",
            "model": "frostnet_quant_small_0_35", "qconfig": "qnnpack", "dtype": "float32",
            "tf32": False, "image_size": 32, "arch": arch, "reduced": [],
            "forward_flops": {"32x32": conv_flops(tables["convs"])}, "tables": {"32x32": tables}}


def tiny_seg_config() -> dict:
    cfg = json.loads((PACKAGE / "configs" / "seg_mobilenetv3_large.json").read_text())
    sizes = ((64, 128), (64, 64))
    tables = {f"{h}x{w}": seg_mobilenetv3.shape_tables(cfg["arch"], (h, w)) for h, w in sizes}
    cfg.update(name="tiny_seg", tables=tables,
               forward_flops={k: conv_flops(v["convs"]) for k, v in tables.items()})
    return cfg


def make_root(tmp: Path) -> Path:
    """A copy of the package and ``BENCHMARK.json`` under ``tmp``, its cells
    pointed at the tiny configurations and traffic; returns the package
    root of the copy."""
    root = tmp / "portbench"
    shutil.copytree(PACKAGE, root, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads((PACKAGE.parent / "BENCHMARK.json").read_text())
    for w in spec["workloads"]:
        seg = w["config"].startswith("seg")
        tr = json.loads((root / "traffic" / f"{w['traffic']}.json").read_text())
        tr.update(SMALL[tr["kind"]])
        if seg:
            tr["image_size"] = [64, 128] if tr["kind"] == "serve" else [64, 64]
            tr["batch"] = 2
        if tr["kind"] == "train":
            tr["optimizer"]["lr"] = 0.004
        w["config"] = "tiny_seg" if seg else "tiny"
        w["traffic"] = "tiny_" + w["traffic"]
        (root / "traffic" / f"{w['traffic']}.json").write_text(json.dumps(tr))
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec))
    (root / "configs" / "tiny.json").write_text(json.dumps(tiny_config()))
    (root / "configs" / "tiny_seg.json").write_text(json.dumps(tiny_seg_config()))
    return root


def run(root: Path, workload: str, seed: int = 1234567, seconds: float = 0.5,
        trace: bool = False) -> dict:
    """One CPU run of ``workload`` from the copy at ``root`` (the look for a
    card skipped): its result line."""
    from portbench.run import run_cell

    args = argparse.Namespace(workload=workload, seed=seed, seconds=seconds, trace=int(trace))
    return run_cell(Bench(root), args, torch.device("cpu"), time.perf_counter())
