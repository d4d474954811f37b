"""Fake-image history buffer (``frostnet_tpu/gan/image_pool.py``; reference
Style_Transfer/util/image_pool.py:5-54).

Host-side numpy state with a seeded ``RandomState``, as in the JAX package:
the CycleGAN trainer queries it between the generator and the
discriminator steps. The draws are the JAX package's in its order (a
``rand()``, then on a swap a ``randint()``), so one seed gives the same
images in the same order.
"""
from __future__ import annotations

import numpy as np


class ImagePool:
    def __init__(self, pool_size: int = 50, seed: int = 0):
        self.pool_size = pool_size
        self.images = []
        self.rng = np.random.RandomState(seed)

    def query(self, images: np.ndarray) -> np.ndarray:
        """Per image: while the pool fills, store it and return it; then with
        probability 1/2 return a stored image and store this one in its
        place, else return it."""
        if self.pool_size == 0:
            return images
        out = []
        for img in np.asarray(images):
            if len(self.images) < self.pool_size:
                self.images.append(img.copy())
                out.append(img)
            elif self.rng.rand() > 0.5:
                i = self.rng.randint(0, self.pool_size)
                out.append(self.images[i].copy())
                self.images[i] = img.copy()
            else:
                out.append(img)
        return np.stack(out)
