"""Model registry: the 30 FrostNet names of the JAX package.

``create_model(name, **kwargs)`` mirrors ``frostnet_tpu.models.create_model``
for ``frostnet_{quant_}{large|base|small}_{width}``; keyword arguments
(``num_classes``, ``qconfig``, ``drop_rate``, ``dtype``, ``fuse_int8``) go to
the model. The port has the quantized ones; a float name raises in the
model's constructor.
"""
from __future__ import annotations

from .frostnet import FROSTNET_SETTINGS, CascadePreExBottleneck, FrostNet, make_divisible

_WIDTHS = {"0_35": 0.35, "0_5": 0.5, "0_75": 0.75, "1_0": 1.0, "1_25": 1.25}


def _factories():
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


_REGISTRY = _factories()


def create_model(name: str, **kwargs) -> FrostNet:
    try:
        factory = _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown model {name!r}; known: {sorted(_REGISTRY)}")
    return factory(**kwargs)


def list_models(filter_substr: str = "") -> list:
    return sorted(n for n in _REGISTRY if filter_substr in n)


__all__ = ["create_model", "list_models", "FrostNet", "CascadePreExBottleneck",
           "FROSTNET_SETTINGS", "make_divisible"]
