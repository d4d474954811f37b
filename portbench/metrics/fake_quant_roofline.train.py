"""Percent of its bound that the fake-quant kernel (``ops/fake_quant.py``
-> ``csrc/fake_quant.cu``) reaches in a QAT step of ``frostnet-qat-train``: the least time
of the configuration's frozen site table at the cell's batch
(``costs.fq_cost``, bytes over HBM bandwidth), over the kernel's device
time. Moves ``train_images_per_s``."""
from portbench.costs import fq_bound_s
from portbench.readers import roofline

NAMES = ("fq_observe_kernel", "fq_quantize_kernel", "fq_min_max_kernel",
         "fq_observe_reduced_kernel")


def read(m):
    return roofline(m, NAMES, "sites", fq_bound_s)
