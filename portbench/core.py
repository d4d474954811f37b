"""What every run shares: the files the harness finds by name, the seeds it
derives, the guard against JAX, and the result line.

The harness is driven by data. ``BENCHMARK.json`` names each cell's
configuration and traffic; the files live under this package:

* ``configs/<config>.json``: sizes, source, the frozen shape tables, the
  names of its ``family`` (the driver) and of its plain ``reference``;
* ``traffic/<traffic>.json``: the mix (``kind`` train or serve, batch,
  pools, steps, optimizer);
* ``limits/<workload>.json``: the limits of the numbers that decide
  ``correct``, with the readings they were set from;
* ``metrics/<metric>.py``: one reader a per-layer metric, ``read(m)``;
* ``drivers/<kind>_<family>.py``: ``run(cell)`` for a kind of traffic on a
  family of configurations.

A new file of any kind joins without an edit to an existing one.
"""
from __future__ import annotations

import dataclasses
import hashlib
import importlib.util
import json
import sys
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

PACKAGE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "frostnet_tpu")


@dataclasses.dataclass
class Cell:
    """One run's inputs: the workload entry, its files, and the run's
    arguments."""

    workload: dict
    config: dict
    traffic: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: Any
    started: float            # perf_counter() at the process's start
    root: Path = PACKAGE
    e2e: List[dict] = dataclasses.field(default_factory=list)
    per_layer: List[dict] = dataclasses.field(default_factory=list)


class Bench:
    """The benchmark's files under ``root`` (the package by default; a copy
    elsewhere in tests) and the ``BENCHMARK.json`` beside it."""

    def __init__(self, root: Path = PACKAGE, spec: Optional[Path] = None):
        self.root = Path(root)
        self.spec = json.loads(Path(spec or self.root.parent / "BENCHMARK.json").read_text())

    def _json(self, kind: str, name: str) -> dict:
        path = self.root / kind / f"{name}.json"
        if not path.is_file():
            raise KeyError(f"no {kind[:-1] if kind.endswith('s') else kind} file {path}")
        return json.loads(path.read_text())

    def names(self, kind: str) -> List[str]:
        """The names of the files of one kind (``configs``, ``traffic``,
        ``limits``, ``metrics``)."""
        suffix = ".py" if kind == "metrics" else ".json"
        return sorted(p.name[:-len(suffix)] for p in (self.root / kind).glob(f"*{suffix}")
                      if not p.name.startswith("_"))

    def workload(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: "
                       f"{[w['name'] for w in self.spec['workloads']]}")

    def config(self, name: str) -> dict:
        return self._json("configs", name)

    def traffic(self, name: str) -> dict:
        return self._json("traffic", name)

    def limits(self, workload: str) -> dict:
        return self._json("limits", workload)

    def module(self, kind: str, name: str):
        """The module ``<kind>/<name>.py`` under the root, loaded from its
        file (a metric's name has dots, so not by import path)."""
        path = self.root / kind / f"{name}.py"
        if not path.is_file():
            raise KeyError(f"no {kind} module {path}")
        spec = importlib.util.spec_from_file_location(f"portbench_{kind}_{name}", path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[spec.name] = mod  # dataclasses look their module up there
        spec.loader.exec_module(mod)
        return mod

    def metric_reader(self, name: str) -> Callable:
        """``read`` of ``metrics/<name>.py``."""
        return self.module("metrics", name).read

    def driver(self, traffic: dict, config: dict):
        """``drivers/<kind>_<family>.py`` of a cell's traffic and configuration."""
        return self.module("drivers", f"{traffic['kind']}_{config['family']}")

    def reference(self, config: dict):
        """``reference/<reference>.py``: the configuration's plain reference."""
        return self.module("reference", config["reference"])

    def metrics_of(self, workload: str):
        """(end-to-end, per-layer) metric entries this cell reports."""
        def has(m):
            return "workloads" not in m or workload in m["workloads"]
        e2e = [m for m in self.spec["end_to_end"] if has(m)]
        names = {m["name"] for m in e2e}
        per = [m for m in self.spec["per_layer"]
               if (workload in m["workloads"] if "workloads" in m else m["moves"] in names)]
        return e2e, per

    def cell(self, workload: str, seed: int, seconds: float, trace: bool, device,
             started: float) -> Cell:
        w = self.workload(workload)
        e2e, per = self.metrics_of(workload)
        return Cell(workload=w, config=self.config(w["config"]), traffic=self.traffic(w["traffic"]),
                    limits=self.limits(workload), seed=seed, seconds=seconds, trace=trace,
                    device=device, started=started, root=self.root, e2e=e2e, per_layer=per)


def subseed(seed: int, tag: str) -> int:
    """A 63-bit seed for one stream of a run (weights, data, noise, ...),
    from the run's ``--seed`` and the stream's name."""
    digest = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def forbidden_modules() -> List[str]:
    """Top-level names in ``sys.modules`` that the benchmark may not load:
    JAX, its libraries and the JAX package (compared whole)."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN)


@dataclasses.dataclass
class Outcome:
    """What a driver hands back: the numbers compared and their limits, the
    metrics, the device's readings, and the trace's breakdown."""

    checks: Dict[str, Dict[str, float]]
    metrics: Dict[str, float]
    attempted: int
    failed: int
    device: Dict[str, Any]
    breakdown: Optional[dict] = None
    phases: Optional[Dict[str, float]] = None

    @property
    def correct(self) -> bool:
        return all(c["value"] <= c["limit"] for c in self.checks.values())


def result_line(outcome: Outcome, units: Dict[str, str]) -> Dict[str, Any]:
    """The last line of standard output; the compared numbers come last."""
    out: Dict[str, Any] = {
        "correct": outcome.correct,
        "attempted": outcome.attempted,
        "failed": outcome.failed,
        "metrics": {k: {"value": v, "unit": units[k]} for k, v in outcome.metrics.items()},
        "device": outcome.device,
    }
    if outcome.breakdown is not None:
        out["breakdown"] = outcome.breakdown
    if outcome.phases is not None:
        out["phases_s"] = outcome.phases
    out["checks"] = outcome.checks
    return out
