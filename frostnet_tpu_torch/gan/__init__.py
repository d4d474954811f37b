"""Style-transfer (GAN) workload of the port: the generator and the
discriminators, the GAN losses, the image pool, the datasets, the pix2pix
and CycleGAN training steps (``train``, ``test`` and ``eval_cityscapes``
are the entry points)."""
from .networks import (NLayerDiscriminator, PixelDiscriminator, ResnetBlock, ResnetGenerator,
                       define_d, define_g, gan_init, gan_loss, gradient_penalty, reflection_pad)
from .image_pool import ImagePool
from .models import NetState, make_cyclegan_steps, make_net_state, make_pix2pix_steps
from .data import AlignedDataset, SyntheticPairs, UnalignedDataset, apply_direction

__all__ = [
    "ResnetGenerator", "ResnetBlock", "NLayerDiscriminator", "PixelDiscriminator", "gan_loss",
    "gradient_penalty", "define_g", "define_d", "reflection_pad", "gan_init", "ImagePool",
    "NetState", "make_net_state", "make_pix2pix_steps", "make_cyclegan_steps",
    "AlignedDataset", "UnalignedDataset", "SyntheticPairs", "apply_direction",
]
