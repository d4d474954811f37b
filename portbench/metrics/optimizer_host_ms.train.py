"""Host ms a QAT step of ``frostnet-qat-train`` in ``step.optimizer`` (QSGD with GradBoost:
``optim.flatten``, a span a stage, ``optim.write_back``). Layer: the host.
Moves ``train_images_per_s``."""
from portbench.spans import host_ms


def read(m):
    return host_ms(m, "step.optimizer")
