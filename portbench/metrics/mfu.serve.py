"""Percent of the card's INT8 peak (1,979 TOP/s) that the whole served
forward reaches: the configuration's frozen forward operations an image,
times the images of the traced run's requests outside the profiled
stretch, over their time. Moves ``serve_images_per_s``."""
from portbench.readers import mfu


def read(m):
    return mfu(m, 1.0, "int8_ops_per_s")
