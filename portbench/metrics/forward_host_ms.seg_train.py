"""Host ms a QAT step of ``seg-qat-train`` in ``step.forward`` less its wrapper
spans: the model's torch-op and cuDNN calls and the loss, as the host
issues them. Layer: the host. Moves ``seg_train_images_per_s``."""
from portbench.spans import host_ms


def read(m):
    return host_ms(m, "step.forward", self_time=True)
