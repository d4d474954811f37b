"""Kernels a request launched inside ``det.nms`` (``detection/nms.py::nms_fixed``),
from the device trace: a kernel counts where its launch call lies inside the
span's ``cpu_op`` event (``drivers/serve_det.py::launches_by_span``, kept on
the traced stretch's summary); the kernels of a replayed CUDA graph carry
the correlation of its ``cudaGraphLaunch``, so they count each. None where
the trace holds no such span.
Layer: detection post-processing. Moves ``serve_p95_ms``."""


def read(m):
    s = m.summary
    n = getattr(s, "span_launches", {}).get("det.nms") if s is not None else None
    return n / s.units if n and s.units else None
