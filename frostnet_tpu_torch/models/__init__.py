"""Model registry: the names of the JAX package's (``frostnet_tpu/models``).

``create_model(name, **kwargs)`` mirrors ``frostnet_tpu.models.create_model``
with the JAX factories' defaults (``num_classes`` 1000, ``drop_rate`` 0.2);
keyword arguments (``num_classes``, ``qconfig``, ``drop_rate``, ``dtype``,
``width_mult``, ``fuse_int8``) go to the model. The port has the 30
FrostNets, the quantized and float MobileNetV2/V3 and the quantized and
float ResNets (ResNet-18/34/50/101/152, ResNeXt-101 32x8d); every other JAX
name raises ``NotImplementedError`` naming its ROADMAP.md item.
"""
from __future__ import annotations

from .frostnet import FROSTNET_SETTINGS, CascadePreExBottleneck, FrostNet, make_divisible
from .mobilenetv2 import MobileNetV2, mobilenetv2_factories
from .mobilenetv3 import MobileNetV3, mobilenetv3_factories
from .resnet import BasicBlock, Bottleneck, ResNet, resnet_factories

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


_REGISTRY = {**_frostnet_factories(), **mobilenetv2_factories(), **mobilenetv3_factories(),
             **resnet_factories()}

_ITEM7 = "ROADMAP.md, Queue A item 7"
# the JAX names the port does not have yet, by family, with their ROADMAP item
_NOT_PORTED = {
    f"ShuffleNetV2 ({_ITEM7}, second)": tuple(
        f"{q}shufflenet_v2_x{w}" for q in ("", "q") for w in ("0_5", "1_0", "1_5", "2_0")),
    f"VGG and AlexNet ({_ITEM7}, third)": ("alexnet", "qalexnet") + tuple(
        f"{q}vgg{d}{bn}" for q in ("", "q") for d in (11, 13, 16, 19) for bn in ("", "_bn")),
    f"the float-only baselines of fp_only.py ({_ITEM7})": (
        "densenet121", "densenet169", "densenet201", "squeezenet1_0", "squeezenet1_1",
        "mnasnet0_5", "mnasnet1_0", "inception_v3"),
    f"the CIFAR aliases of cifar.py ({_ITEM7})": (
        "cifar_alexnet", "cifar_mobilenet_v2_ReLU", "cifar_mobilenet_v3_large_HS",
        "cifar_mobilenet_v3_small_HS", "cifar_resnet18", "cifar_resnet50", "cifar_vgg16_bn"),
    f"the ESPNetv2 classifier ({_ITEM7}, with segmentation, item 8)": tuple(
        f"espnetv2_s_{s}" for s in ("0_5", "1_0", "1_5", "2_0")),
}
_PENDING = {name: family for family, names in _NOT_PORTED.items() for name in names}


def create_model(name: str, **kwargs):
    factory = _REGISTRY.get(name)
    if factory is None:
        if name in _PENDING:
            raise NotImplementedError(f"{name!r} is not ported yet: {_PENDING[name]}")
        raise ValueError(f"unknown model {name!r}; known: {sorted(_REGISTRY)}")
    return factory(**kwargs)


def list_models(filter_substr: str = "") -> list:
    return sorted(n for n in _REGISTRY if filter_substr in n)


__all__ = ["create_model", "list_models", "FrostNet", "CascadePreExBottleneck", "MobileNetV2",
           "MobileNetV3", "ResNet", "BasicBlock", "Bottleneck", "FROSTNET_SETTINGS",
           "make_divisible"]
