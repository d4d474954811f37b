"""Style-transfer (GAN) models of the port: the INT8 ResnetGenerator."""
from .networks import ResnetBlock, ResnetGenerator, define_g, reflection_pad

__all__ = ["ResnetBlock", "ResnetGenerator", "define_g", "reflection_pad"]
