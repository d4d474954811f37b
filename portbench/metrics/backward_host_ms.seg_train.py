"""Host ms a QAT step of ``seg-qat-train`` in ``step.backward`` (``zero_grad`` and
``loss.backward()``). Layer: the host. Moves ``seg_train_images_per_s``."""
from portbench.spans import host_ms


def read(m):
    return host_ms(m, "step.backward")
