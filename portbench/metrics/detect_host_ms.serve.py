"""Host ms a request in ``request.detect``: the softmax and
``detection/nms.py::detect`` (the decode, the threshold, the sort and the
IoU as torch ops, the greedy pass as one CUDA graph's launch on the card),
as the host issues them. Layer: the host. Moves ``serve_p95_ms``."""
from portbench.spans import host_ms


def read(m):
    return host_ms(m, "request.detect")
