"""What the drivers share: seeded weights made on the device, the device's
readings, the numbers compared against their limits, and the per-layer
metrics read from a run's measurements."""
from __future__ import annotations

import dataclasses
import math
import shutil
import statistics
import subprocess
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from ..core import Bench, Cell
from ..trace import TraceSummary


def geometry(cell: Cell) -> Tuple[int, int]:
    """(H, W) of the cell's images: the traffic's ``image_size``, else the
    configuration's (an int is a square)."""
    size = cell.traffic.get("image_size", cell.config.get("image_size"))
    return (size, size) if isinstance(size, int) else tuple(size)


def geometry_key(cell: Cell) -> str:
    return "x".join(str(n) for n in geometry(cell))


def make_weights(specs: Sequence[Tuple[str, tuple, str]], seed: int, device) -> Dict[str, torch.Tensor]:
    """Every parameter and buffer of ``specs`` (name, shape, kind) on
    ``device`` from ``seed``: kernels kaiming-normal with fan-out (std
    ``sqrt(2 / (kh * kw * out))``) from one normal draw, BN scales and
    running variances 1, biases and running means 0, observers empty."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    kernels = [(n, s) for n, s, kind in specs if kind == "kernel"]
    draw = torch.randn(sum(math.prod(s) for _, s in kernels), generator=gen, device=device)
    out, at = {}, 0
    for n, s in kernels:
        k = math.prod(s)
        out[n] = draw[at:at + k].view(s) * math.sqrt(2.0 / (s[0] * s[1] * s[3]))
        at += k
    fill = {"ones": 1.0, "zeros": 0.0, "min": math.inf, "max": -math.inf}
    for n, s, kind in specs:
        if kind != "kernel":
            out[n] = torch.full(s, fill[kind], dtype=torch.float32, device=device)
    return out


@torch.no_grad()
def load_weights(model: torch.nn.Module, weights: Dict[str, torch.Tensor]) -> None:
    """Copy ``weights`` into ``model``'s parameters and buffers by name; every
    name must match."""
    named = dict(list(model.named_parameters()) + list(model.named_buffers()))
    if set(named) != set(weights):
        raise ValueError(f"weights do not match the model: missing "
                         f"{sorted(set(named) - set(weights))[:5]}, extra "
                         f"{sorted(set(weights) - set(named))[:5]}")
    for n, t in named.items():
        t.copy_(weights[n])


def power_limit_w(index: int = 0) -> Optional[float]:
    """The card's power limit in W, read by ``nvidia-smi`` (None where it
    cannot be read)."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return None
    try:
        out = subprocess.run([smi, "--query-gpu=power.limit", "--format=csv,noheader,nounits",
                              f"--id={index}"], capture_output=True, text=True, timeout=20)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        return None


def device_info(device, summary: Optional[TraceSummary]) -> Dict[str, Any]:
    """The result line's ``device``: the card, the count, the peak memory
    (read before the reference runs), the traced busy and window seconds."""
    info: Dict[str, Any] = {"platform": "gpu", "count": 1}
    if device.type == "cuda":
        info.update(kind=torch.cuda.get_device_name(device),
                    memory_peak_bytes=int(torch.cuda.max_memory_allocated(device)),
                    power_limit_w=power_limit_w(device.index or 0))
    else:  # the CPU rehearsal of the tests; never a result of the benchmark
        info.update(platform="cpu", kind="cpu", memory_peak_bytes=0)
    if summary is not None:
        info.update(busy_s=summary.busy_s, window_s=summary.window_s)
    return info


def check(name: str, value: float, limits: dict) -> Dict[str, float]:
    """One compared number beside its limit (a NaN reads as not met)."""
    return {"value": float(value), "limit": float(limits["limits"][name])}


def gap(a: float, b: float, scale: float) -> float:
    """``|a - b| / scale``, NaN where a number is not finite."""
    if not (math.isfinite(a) and math.isfinite(b)):
        return math.nan
    return abs(a - b) / scale if scale > 0 else (0.0 if a == b else math.inf)


class Phases:
    """Seconds of each part of a run since the last mark, from the process's
    start (``setup_s`` is their sum up to the window)."""

    def __init__(self, started: float):
        self.last, self.parts = started, {}

    def mark(self, name: str) -> float:
        now = time.perf_counter()
        self.parts[name] = now - self.last
        self.last = now
        return now


@dataclasses.dataclass
class Measure:
    """What a metric reader reads: the traced stretch, the benchmark's own
    spans, and the work of the run."""

    cell: Cell
    summary: Optional[TraceSummary]
    host_s: List[float]        # host seconds until each call returned, outside the stretch
    units_outside: int         # steps or requests timed outside the stretch
    seconds_outside: float     # their time, synchronized at both ends
    batch: int

    @property
    def tables(self) -> dict:
        """The configuration's shape tables at the cell's geometry."""
        return self.cell.config["tables"][geometry_key(self.cell)]

    @property
    def forward_flops(self) -> float:
        """The configuration's forward FLOPs an image at the cell's geometry."""
        return self.cell.config["forward_flops"][geometry_key(self.cell)]


def per_layer(cell: Cell, m: Measure) -> Dict[str, float]:
    """Each per-layer metric of the cell that its reader finds, by name."""
    bench = Bench(cell.root)
    out = {}
    for entry in cell.per_layer:
        value = bench.metric_reader(entry["name"])(m)
        if value is not None:
            out[entry["name"]] = float(value)
    return out


def quantile95(values: Sequence[float]) -> float:
    """The 95th percentile (``statistics.quantiles``' exclusive method)."""
    if len(values) < 2:
        return float(values[0]) if values else math.nan
    return statistics.quantiles(values, n=20)[18]


@dataclasses.dataclass
class Window:
    """One measured window: ``units`` steps or requests in ``seconds``
    (untraced), or the traced run's parts outside the stretch."""

    units: int
    seconds: float
    host_s: List[float]
    latency_s: List[float]
    summary: Optional[TraceSummary] = None


def run_window(call, seconds: float, trace: bool, device, stretch_units: int) -> Window:
    """Drive ``call(i) -> (host seconds until the call returned, latency
    seconds or None)`` back to back for ``seconds``, ending on a
    synchronization. With ``trace`` the middle ``stretch_units`` calls run
    under the profiler and the window's numbers are those of the two parts
    around it (each synchronized at both ends)."""
    from ..trace import traced_stretch

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    host, lat, n = [], [], 0

    def drive(t_start, length):
        nonlocal n
        while time.perf_counter() - t_start < length:
            h, l = call(n)
            n += 1
            host.append(h)
            if l is not None:
                lat.append(l)

    t0 = time.perf_counter()
    if not trace:
        drive(t0, seconds)
        sync()
        return Window(n, time.perf_counter() - t0, host, lat)
    drive(t0, seconds / 2)
    sync()
    ta = time.perf_counter()
    n1 = n
    with traced_stretch(device) as box:
        for _ in range(stretch_units):
            call(n)
            n += 1
        box["units"] = stretch_units
    tb = time.perf_counter()
    n_stretch = n
    drive(tb, seconds - (ta - t0))
    sync()
    t_end = time.perf_counter()
    return Window(n1 + (n - n_stretch), (ta - t0) + (t_end - tb), host, lat, box["summary"])
