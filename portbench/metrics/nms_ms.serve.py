"""Device ms a request between ``det.nms``'s CUDA events: the stream's time
from the end of the decode to the greedy NMS's last kernel
(``detection/nms.py::nms_fixed``: the stable sort, the pairwise IoU, one
masked step a candidate). Layer: detection post-processing. Moves
``serve_images_per_s``."""
from portbench.spans import device_ms


def read(m):
    return device_ms(m, "det.nms")
