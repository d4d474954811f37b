"""frostnet_tpu_torch: the PyTorch + CUDA port of frostnet_tpu.

The JAX package ``frostnet_tpu`` stays the reference; this package imports
neither it nor JAX. It serves the FrostNet classifiers and the GAN
generator (``gan/``) in INT8 (``serve.py``) and trains and evaluates the
classifiers (``train/classification.py``, ``train/evaluate.py``), with
hand-written CUDA kernels for Hopper (``csrc/``) behind ``ops/``.
"""
