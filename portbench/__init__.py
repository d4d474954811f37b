"""The benchmark of the PyTorch and CUDA port (``frostnet_tpu_torch``): ``python3 -m portbench.run``."""
