"""Percent of its bound that the INT8 matmul kernel (``ops/int8_matmul.py``
-> ``csrc/int8_matmul.cu``) reaches in a served forward: the least time of
the configuration's frozen (M, K, N) table at the cell's batch
(``costs.matmul_cost``, the function's own K), over the kernel's device
time. Moves ``serve_images_per_s``."""
from portbench.costs import matmul_bound_s
from portbench.readers import roofline

NAMES = ("int8_matmul_requant_kernel",)


def read(m):
    return roofline(m, NAMES, "matmuls", matmul_bound_s)
