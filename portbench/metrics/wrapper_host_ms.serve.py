"""Host ms a request inside the kernel wrappers' spans (``ops.*``: checks,
plan lookup, allocation, the ctypes launch). Layer: the host. Moves
``serve_images_per_s``."""
from portbench.spans import prefix_host_ms


def read(m):
    return prefix_host_ms(m, "ops.")
