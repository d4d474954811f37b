"""INT8 quantization core: grids, observers, BN folding, freeze and artifacts."""
from .qtypes import (
    FBGEMM,
    FBGEMM_ACT,
    FBGEMM_WEIGHT,
    QNNPACK,
    QNNPACK_ACT,
    QNNPACK_WEIGHT,
    SCALE_EPS,
    QConfig,
    QSpec,
    get_qconfig,
)
from .observer import ObserverState, calculate_qparams, init_observer
from .fake_quant import dequantize, quantize
from .folding import bn_scale_factor, fold_bn
from .qtensor import QParams, QTensor
from .export import from_jax_variables, load_int8
from .freeze import freeze

__all__ = [
    "QSpec", "QConfig", "QNNPACK", "FBGEMM", "QNNPACK_ACT", "QNNPACK_WEIGHT",
    "FBGEMM_ACT", "FBGEMM_WEIGHT", "SCALE_EPS", "get_qconfig",
    "ObserverState", "init_observer", "calculate_qparams",
    "quantize", "dequantize", "fold_bn", "bn_scale_factor",
    "QTensor", "QParams", "load_int8", "from_jax_variables", "freeze",
]
