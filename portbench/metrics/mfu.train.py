"""Percent of the card's float32 peak (67 TFLOP/s without TF32, the
configuration's arithmetic) that the whole QAT step of ``frostnet-qat-train`` reaches: three
times the frozen forward FLOPs an image, times the images of the traced
run's steps outside the profiled stretch, over their time. Moves
``train_images_per_s``."""
from portbench.readers import mfu


def read(m):
    return mfu(m, 3.0, "float32_flops_per_s")
