"""Percent of its bound that the INT8 depthwise kernel (``ops/depthwise_int8.py``
-> ``csrc/depthwise_int8.cu``) reaches in a served forward: the least time of
the configuration's depthwise convs at the cell's batch, over the kernel's
device time. Moves ``serve_images_per_s``.

The rows are the ``convs`` rows with ``groups == cin > 1``. A row's bytes are
its input codes read and its output codes written once, its taps and 8 bytes
of epilogue constants a channel; its operations are two a tap and output
code, against the int8 peak (bytes bound every row). The input's pixels are
the "M an image" of the block's ``.expand`` row in ``matmuls``. Where the
trace kept fewer launches than the rows a request, the bound counts the kept
share of these rows."""
from portbench.costs import PEAKS, bound_s

NAMES = ("depthwise_int8_kernel",)


def depthwise_rows(tables):
    """``(Hin * Win, Ho, Wo, C, k)`` of each depthwise conv of a table set."""
    pixels = {name: m for name, m, _k, _n in tables["matmuls"]}
    return [(pixels[name[:-len("dw")] + "expand"], ho, wo, cout, k)
            for name, ho, wo, cin, cout, k, groups in tables["convs"] if groups == cin > 1]


def depthwise_cost(hw_in: int, ho: int, wo: int, c: int, k: int, batch: int):
    """(bytes, operations) of one depthwise conv at ``batch``."""
    return (batch * (hw_in * c + ho * wo * c) + k * k * c + 8 * c,
            2.0 * batch * ho * wo * c * k * k)


def depthwise_bound_s(tables, batch: int) -> float:
    """The least seconds of a forward's depthwise convs at ``batch``."""
    return sum(bound_s(*depthwise_cost(*row, batch), PEAKS["int8_ops_per_s"])
               for row in depthwise_rows(tables))


def read(m):
    s = m.summary
    if s is None or not s.units:
        return None
    ks = [k for k in s.kernels() if any(n in k.name for n in NAMES)]
    if not ks:
        return None
    kept = min(1.0, len(ks) / (len(depthwise_rows(m.tables)) * s.units))
    return (100.0 * depthwise_bound_s(m.tables, m.batch) * s.units * kept
            / (sum(k.dur_us for k in ks) / 1e6))
