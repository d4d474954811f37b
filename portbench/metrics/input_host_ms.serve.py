"""Host ms a request in ``request.input``: ``as_tensor`` and the copy of the
images to the device, as the host issues it. Layer: the host. Moves
``serve_p95_ms``."""
from portbench.spans import host_ms


def read(m):
    return host_ms(m, "request.input")
