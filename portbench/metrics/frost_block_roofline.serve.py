"""Percent of its bound that the fused Frost block kernel
(``ops/frost_block.py`` -> ``csrc/frost_block.cu``) reaches in a served
forward: the least time of the configuration's frozen block table at the
cell's batch (``costs.block_cost``), over the kernel's device time. Moves
``serve_images_per_s``."""
from portbench.costs import block_bound_s
from portbench.readers import roofline

NAMES = ("frost_block_kernel",)


def read(m):
    return roofline(m, NAMES, "blocks", block_bound_s)
