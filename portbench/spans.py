"""What the readers of the program's own spans share (``*_host_ms.*``,
``optimizer_ms.*``).

The port records its spans (``frostnet_tpu_torch/utils/profiling.py::span``)
only while a ``torch.profiler`` session runs, so the records that
``profiling.session()`` keeps after the run are those of the traced
stretch, the run's one session. A unit is a closed root span named ``step``
(a training cell) or ``request`` (a serving cell); the readers take only the
records of such units, so a span opened outside them (a root of its own)
neither counts as a unit nor adds to a metric. Each reader gives ms a unit;
it returns None where the session holds no records or none of its spans (a
program without the spans, or a span without its CUDA events on the CPU)."""
from __future__ import annotations

from typing import List, Optional

UNITS = ("step", "request")  # the names of the root spans that are units


def records() -> List:
    """The records of the latest profiler session's closed units; empty
    where the program has no spans."""
    try:
        from frostnet_tpu_torch.utils.profiling import session
    except ImportError:
        return []
    recs = list(session())
    units = {r.index for r in recs if r.parent == -1 and r.name in UNITS and r.closed}
    return [r for r in recs if r.unit in units]


def _per_unit(recs, total_ms: float) -> Optional[float]:
    units = sum(1 for r in recs if r.parent == -1)
    return total_ms / units if units else None


def host_ms(m, name: str, self_time: bool = False) -> Optional[float]:
    """Host ms a unit of the spans named ``name``; with ``self_time`` less
    what their direct children cover."""
    recs = records()
    picked = {r.index for r in recs if r.name == name and r.closed}
    if not picked:
        return None
    total = sum(r.host_ms for r in recs if r.index in picked)
    if self_time:
        total -= sum(r.host_ms for r in recs if r.parent in picked and r.closed)
    return _per_unit(recs, total)


def prefix_host_ms(m, prefix: str) -> Optional[float]:
    """Host ms a unit of the outermost spans whose names start with
    ``prefix`` (a wrapper's span inside another's counts once)."""
    recs = records()
    name = {r.index: r.name for r in recs}

    def outer(r):
        return r.parent == -1 or not name[r.parent].startswith(prefix)

    picked = [r for r in recs if r.name.startswith(prefix) and r.closed and outer(r)]
    return _per_unit(recs, sum(r.host_ms for r in picked)) if picked else None


def device_ms(m, name: str) -> Optional[float]:
    """ms a unit of the device's stream between the CUDA events of the spans
    named ``name``."""
    recs = records()
    times = [r.device_ms() for r in recs if r.name == name and r.closed]
    times = [t for t in times if t is not None]
    return _per_unit(recs, sum(times)) if times else None
