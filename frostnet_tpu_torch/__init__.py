"""frostnet_tpu_torch: the PyTorch + CUDA port of frostnet_tpu.

The JAX package ``frostnet_tpu`` stays the reference; this package imports
neither it nor JAX. The first slice is INT8 serving of the FrostNet
classifiers (``serve.py``), with hand-written CUDA kernels for Hopper
(``csrc/``) behind ``ops/``.
"""
