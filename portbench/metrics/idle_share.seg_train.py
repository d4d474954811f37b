"""Percent of the profiled stretch of ``seg-qat-train`` with no kernel, copy or memset
on the card. Moves ``seg_train_images_per_s``."""
from portbench.readers import idle_share as read  # noqa: F401
