"""CIFAR-sized models (``frostnet_tpu/models/cifar.py``).

``cifar_alexnet`` is AlexNet with the CIFAR stem: a 3x3 stride-1 ``conv1``
(3 -> 64, 'same': the dense conv kernel in INT8) and no pool before
``conv2``; its head is sized for 32x32 images by default. The other names
alias the ImageNet models with 10 classes by default, as the JAX registry
does.
"""
from __future__ import annotations

from ..nn import QConvBNAct, max_pool
from .vgg import AlexNet, _pooled


class CifarAlexNet(AlexNet):
    def __init__(self, num_classes: int = 10, image_size: int = 32, **kwargs):
        super().__init__(num_classes=num_classes, image_size=image_size, **kwargs)

    def _stem(self, kw):
        self.conv1 = QConvBNAct(3, 64, 3, padding=1, **kw)
        self.conv2 = QConvBNAct(64, 192, 5, padding=2, **kw)

    @staticmethod
    def _stem_size(image_size: int) -> int:
        return _pooled(image_size, 3, 2)

    def _trunk(self, x, mode, train):
        return max_pool(self.conv2(self.conv1(x, mode, train), mode, train), 3, 2)


CIFAR_ALIASES = ("qresnet18", "qresnet50", "qmobilenet_v2_ReLU", "qmobilenet_v3_large_HS",
                 "qmobilenet_v3_small_HS", "qvgg16_bn")


def cifar_factories(create_model):
    """``cifar_alexnet`` and the aliases ``cifar_<name>`` of ``CIFAR_ALIASES``
    (the ``q`` dropped) through ``create_model``, 10 classes by default."""
    reg = {"cifar_alexnet": lambda **kw: CifarAlexNet(**{"num_classes": 10, **kw})}
    for target in CIFAR_ALIASES:
        def make(t=target, **kwargs):
            kwargs.setdefault("num_classes", 10)
            return create_model(t, **kwargs)

        reg[f"cifar_{target[1:]}"] = make
    return reg
