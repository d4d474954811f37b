"""Host ms a QAT step of ``seg-qat-train`` until the step call returns, unsynchronized
(the benchmark's own span), the mean over the traced run's steps outside the
profiled stretch. Layer: the host (``segmentation/train.py``,
``optim/gradboost.py``, the ctypes wrappers). Moves ``seg_train_images_per_s``."""
from portbench.readers import host_ms as read  # noqa: F401
