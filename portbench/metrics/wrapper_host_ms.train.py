"""Host ms a QAT step of ``frostnet-qat-train`` inside the kernel wrappers' spans (``ops.*``:
checks, plan lookup, allocation, the ctypes launch; ``ops.fake_quant`` once
a site). Layer: the host. Moves ``train_images_per_s``."""
from portbench.spans import prefix_host_ms


def read(m):
    return prefix_host_ms(m, "ops.")
