"""Percent of its bound that the bilinear resize kernel (``ops/resize.py`` ->
``csrc/resize_bilinear.cu``) reaches in a served segmentation forward: the
least time of the forward's three resizes at the cell's batch, over the
kernel's device time. Moves ``serve_images_per_s``.

The resizes come from the ``convs`` rows of the LR-ASPP head and the float
tail: the gate's pooled map (``head.lr_aspp.b1_conv``'s output) to
``head.lr_aspp.b0``'s size, the head's output (``b0``'s) to c1's size
(``auxlayer``'s), and the tail's logits (``project``'s) to the image. A
resize's bytes are its float32 input read and its float32 output written
once (three operations an output value, far under the card's ridge). Where
the trace kept fewer launches than the resizes a request, the bound counts
the kept share of them."""
from portbench.costs import PEAKS
from portbench.drivers.common import geometry

NAMES = ("resize_bilinear_kernel",)
# (input row, row whose output size it is resized to, or None for the image)
RESIZES = (("head.lr_aspp.b1_conv", "head.lr_aspp.b0"), ("head.lr_aspp.b0", "auxlayer"),
           ("project", None))


def resize_rows(tables, image):
    """``(Hin, Win, Hout, Wout, C)`` of each resize of a served forward, or
    None where the table set lacks its rows."""
    convs = {name: (ho, wo, cout) for name, ho, wo, _cin, cout, _k, _g in tables["convs"]}
    if not all(src in convs and (dst is None or dst in convs) for src, dst in RESIZES):
        return None
    return [(*convs[src][:2], *(image if dst is None else convs[dst][:2]), convs[src][2])
            for src, dst in RESIZES]


def resize_cost(h_in: int, w_in: int, h_out: int, w_out: int, c: int, batch: int) -> float:
    """Bytes of one float32 resize at ``batch``: input once, output once."""
    return 4.0 * batch * c * (h_in * w_in + h_out * w_out)


def resize_bound_s(rows, batch: int) -> float:
    """The least seconds of a forward's resizes at ``batch``."""
    return sum(resize_cost(*row, batch) for row in rows) / PEAKS["hbm_bytes_per_s"]


def read(m):
    s = m.summary
    if s is None or not s.units:
        return None
    ks = [k for k in s.kernels() if any(n in k.name for n in NAMES)]
    rows = resize_rows(m.tables, geometry(m.cell))
    if not ks or not rows:
        return None
    kept = min(1.0, len(ks) / (len(rows) * s.units))
    return (100.0 * resize_bound_s(rows, m.batch) * s.units * kept
            / (sum(k.dur_us for k in ks) / 1e6))
