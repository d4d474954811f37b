"""Host ms a request in ``request.forward`` less its wrapper spans: the torch
ops between the kernels (the INT8 depthwise, the requant epilogues, the
float tail), as the host issues them. Layer: the host. Moves
``serve_images_per_s``."""
from portbench.spans import host_ms


def read(m):
    return host_ms(m, "request.forward", self_time=True)
