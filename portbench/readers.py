"""What the per-layer metric files under ``metrics/`` share: each file names
its own constants (kernel names, launching operators, its table and peak)
and calls one of these on the run's measurements (``drivers.common.Measure``).
A reader that finds nothing to read returns None."""
from __future__ import annotations

from typing import Callable, Optional, Sequence

from portbench.costs import PEAKS
from portbench.trace import classify


def host_ms(m) -> Optional[float]:
    """Mean host ms until a call returned, over the calls outside the
    profiled stretch."""
    return 1e3 * sum(m.host_s) / len(m.host_s) if m.host_s else None


def kernels_per_unit(m) -> Optional[float]:
    """Device kernels a step or request in the stretch."""
    if m.summary is None or not m.summary.units:
        return None
    n = len(m.summary.kernels())
    return n / m.summary.units if n else None


def group_ms(m, group: str, port_kernels: Sequence[str], library_ops: Sequence[str]
             ) -> Optional[float]:
    """Device ms a unit of one group of ``trace.classify``: ``port``,
    ``library`` or ``torch_ops``."""
    if m.summary is None or not m.summary.units:
        return None
    ks = classify(m.summary, tuple(port_kernels), tuple(library_ops))[group]
    return sum(k.dur_us for k in ks) / 1e3 / m.summary.units if ks else None


def copies_ms(m, direction: str) -> Optional[float]:
    """Device ms a unit of the stretch's copies whose name holds
    ``direction`` (``HtoD``)."""
    if m.summary is None or not m.summary.units:
        return None
    cs = [r for r in m.summary.records if r.cat == "gpu_memcpy" and direction in r.name]
    return sum(r.dur_us for r in cs) / 1e3 / m.summary.units if cs else None


def idle_share(m) -> Optional[float]:
    """Percent of the stretch with no kernel, copy or memset on the card."""
    s = m.summary
    if s is None or s.window_s <= 0 or s.busy_s <= 0:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)


def roofline(m, names: Sequence[str], table: str, bound_s: Callable) -> Optional[float]:
    """Percent of its bound that a kernel reaches: ``bound_s(rows, batch)`` of
    the configuration's ``table`` for each unit of the stretch, over the
    device time of the kernels whose names hold one of ``names``. Where the
    trace kept fewer launches than the table's rows a unit, the bound counts
    the kept share."""
    s = m.summary
    if s is None or not s.units:
        return None
    ks = [k for k in s.kernels() if any(n in k.name for n in names)]
    if not ks:
        return None
    rows = m.tables[table]
    kept = min(1.0, len(ks) / (len(rows) * s.units))
    return 100.0 * bound_s(rows, m.batch) * s.units * kept / (sum(k.dur_us for k in ks) / 1e6)


def mfu(m, forwards: float, peak: str) -> Optional[float]:
    """Percent of ``PEAKS[peak]`` that the whole step or forward reaches:
    ``forwards`` times the configuration's frozen forward operations an
    image, times the images outside the stretch, over their time."""
    if m.units_outside <= 0 or m.seconds_outside <= 0:
        return None
    ops = forwards * m.forward_flops * m.batch * m.units_outside
    return 100.0 * ops / m.seconds_outside / PEAKS[peak]
