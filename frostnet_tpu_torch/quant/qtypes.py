"""Quantization type specs and backend presets.

A :class:`QSpec` describes the integer grid of one tensor (activation or
weight); a :class:`QConfig` bundles the activation and weight specs of a
backend. The presets are those of ``frostnet_tpu.quant.qtypes``, which mirror
``torch.ao.quantization.get_default_qat_qconfig('qnnpack'|'fbgemm')``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

# torch.finfo(torch.float32).eps: the scale floor of PyTorch's observers.
SCALE_EPS = float(torch.finfo(torch.float32).eps)


@dataclasses.dataclass(frozen=True)
class QSpec:
    """Integer grid for one tensor.

    qmin/qmax: inclusive integer range (0..255 for quint8 affine).
    symmetric: zero point fixed (0 for signed grids), scale from max|x|.
    per_channel: one (scale, zero_point) per output channel (the last axis of
      an HWIO weight).
    averaging_constant: EMA constant of the moving-average observer; None
      selects plain running min/max.
    """

    qmin: int
    qmax: int
    symmetric: bool
    per_channel: bool = False
    averaging_constant: Optional[float] = 0.01

    @property
    def unsigned(self) -> bool:
        return self.qmin >= 0

    @property
    def storage_dtype(self) -> torch.dtype:
        return torch.uint8 if self.unsigned else torch.int8


# qnnpack (mobile): per-tensor affine quint8 activations over 0..255,
# per-tensor symmetric qint8 weights.
QNNPACK_ACT = QSpec(qmin=0, qmax=255, symmetric=False, per_channel=False)
QNNPACK_WEIGHT = QSpec(qmin=-128, qmax=127, symmetric=True, per_channel=False)

# fbgemm (x86): reduce_range activations (0..127), per-channel symmetric
# qint8 weights.
FBGEMM_ACT = QSpec(qmin=0, qmax=127, symmetric=False, per_channel=False)
FBGEMM_WEIGHT = QSpec(qmin=-128, qmax=127, symmetric=True, per_channel=True)


@dataclasses.dataclass(frozen=True)
class QConfig:
    activation: QSpec
    weight: QSpec
    name: str = "custom"


QNNPACK = QConfig(activation=QNNPACK_ACT, weight=QNNPACK_WEIGHT, name="qnnpack")
FBGEMM = QConfig(activation=FBGEMM_ACT, weight=FBGEMM_WEIGHT, name="fbgemm")

_BACKENDS = {"qnnpack": QNNPACK, "fbgemm": FBGEMM}


def get_qconfig(backend: str = "qnnpack") -> QConfig:
    """Equivalent of ``get_default_qat_qconfig(backend)``."""
    try:
        return _BACKENDS[backend]
    except KeyError:
        raise ValueError(f"unknown quant backend {backend!r}; options: {list(_BACKENDS)}")
