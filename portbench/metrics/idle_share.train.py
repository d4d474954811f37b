"""Percent of the profiled stretch of ``frostnet-qat-train`` with no kernel, copy or memset
on the card. Moves ``train_images_per_s``."""
from portbench.readers import idle_share as read  # noqa: F401
