"""Device ms a QAT step of ``seg-qat-train`` between ``step.optimizer``'s CUDA events:
the stream's time from the end of the backward pass to the optimizer's last
kernel (QSGD's float64 FMA emulation among them). Layer: the torch ops of
``optim/``. Moves ``seg_train_images_per_s``."""
from portbench.spans import device_ms


def read(m):
    return device_ms(m, "step.optimizer")
