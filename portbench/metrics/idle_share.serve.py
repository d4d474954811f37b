"""Percent of the profiled stretch of a serving cell with no kernel, copy or
memset on the card. Moves ``serve_images_per_s``."""
from portbench.readers import idle_share as read  # noqa: F401
