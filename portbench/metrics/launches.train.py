"""Device kernels a QAT step of ``frostnet-qat-train`` in the profiled stretch, whatever
launched them (each is host work). Moves ``train_images_per_s``."""
from portbench.readers import kernels_per_unit as read  # noqa: F401
