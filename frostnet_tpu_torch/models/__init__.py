"""Model registry: the names of the JAX package's (``frostnet_tpu/models``).

``create_model(name, **kwargs)`` mirrors ``frostnet_tpu.models.create_model``
with the JAX factories' defaults (``num_classes`` 1000, ``drop_rate`` 0.2);
keyword arguments (``num_classes``, ``qconfig``, ``drop_rate``, ``dtype``,
``width_mult``, ``fuse_int8``) go to the model. Every JAX name is here:
the 30 FrostNets, the quantized and float MobileNetV2/V3, ResNets,
ShuffleNetV2s, VGGs and AlexNets, the float-only baselines (DenseNet,
SqueezeNet, MNASNet, Inception-v3), the CIFAR models and the ESPNetv2
classifiers.
"""
from __future__ import annotations

from typing import Optional

from .frostnet import FROSTNET_SETTINGS, CascadePreExBottleneck, FrostNet, make_divisible
from .frostnet_features import FrostNetFeatures, load_torch_frostnet_checkpoint
from .mobilenetv2 import MobileNetV2, mobilenetv2_factories
from .mobilenetv3 import MobileNetV3, mobilenetv3_factories
from .resnet import BasicBlock, Bottleneck, ResNet, resnet_factories
from .shufflenetv2 import ShuffleNetV2, shufflenetv2_factories
from .vgg import VGG, AlexNet, vgg_factories
from .fp_only import DenseNet, InceptionV3, MNASNet, SqueezeNet, fp_only_factories
from .cifar import CifarAlexNet, cifar_factories

_WIDTHS = {"0_35": 0.35, "0_5": 0.5, "0_75": 0.75, "1_0": 1.0, "1_25": 1.25}


def _frostnet_factories():
    reg = {}
    for m in ("large", "base", "small"):
        for wname, w in _WIDTHS.items():
            for quant in (True, False):
                name = f"frostnet_{'quant_' if quant else ''}{m}_{wname}"

                def make(mode=m, width=w, q=quant, **kwargs):
                    kwargs.setdefault("num_classes", 1000)
                    return FrostNet(mode=mode, width_mult=width, quantized=q, **kwargs)

                reg[name] = make
    return reg


def _espnetv2(s: float):
    """An ESPNetv2 ImageNet classifier (``segmentation/espnet.py``)."""
    def make(**kwargs):
        from ..segmentation.espnet import EESPNet

        kwargs.setdefault("num_classes", 1000)
        return EESPNet(s=s, **kwargs)
    return make


_REGISTRY = {**_frostnet_factories(), **mobilenetv2_factories(), **mobilenetv3_factories(),
             **resnet_factories(), **shufflenetv2_factories(), **vgg_factories(),
             **fp_only_factories()}


def create_model(name: str, image_size: Optional[int] = None, **kwargs):
    """The model registered as ``name``; ``image_size`` (the trainer's,
    evaluator's and server's) sizes the dense head of VGG and AlexNet, and
    is ignored by the other models."""
    factory = _REGISTRY.get(name)
    if factory is None:
        raise ValueError(f"unknown model {name!r}; known: {sorted(_REGISTRY)}")
    if image_size is not None and name in _SIZED_NAMES:
        kwargs.setdefault("image_size", image_size)
    return factory(**kwargs)


_REGISTRY.update(cifar_factories(create_model))
_REGISTRY.update({f"espnetv2_s_{str(s).replace('.', '_')}": _espnetv2(s)
                  for s in (0.5, 1.0, 1.5, 2.0)})
# the models whose dense head is sized from the input (no adaptive pool)
_SIZED_NAMES = {name for name in _REGISTRY
                if name.startswith(("vgg", "qvgg", "alexnet", "qalexnet", "cifar_alexnet",
                                    "cifar_vgg"))}


def list_models(filter_substr: str = "") -> list:
    return sorted(n for n in _REGISTRY if filter_substr in n)


__all__ = ["create_model", "list_models", "FrostNet", "FrostNetFeatures",
           "load_torch_frostnet_checkpoint", "CascadePreExBottleneck", "MobileNetV2",
           "MobileNetV3", "ResNet", "BasicBlock", "Bottleneck", "ShuffleNetV2", "VGG", "AlexNet",
           "CifarAlexNet", "DenseNet", "SqueezeNet", "MNASNet", "InceptionV3",
           "FROSTNET_SETTINGS", "make_divisible"]
