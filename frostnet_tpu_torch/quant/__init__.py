"""Quantization core: grids, observers, fake quantization, BN folding, freeze, artifacts."""
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
from .observer import (ObserverState, batch_min_max, calculate_qparams_folded,
                       calculate_qparams_traced, init_observer, update_observer)
from .fake_quant import dequantize, fake_quantize, quantize
from .folding import bn_scale_factor, fold_bn
from .qtensor import QParams, QTensor
from .export import export_int8, from_jax_variables, load_int8, model_variables, numpy_init
from .freeze import freeze
from .serialize import export_serving, load_serving

__all__ = [
    "QSpec", "QConfig", "QNNPACK", "FBGEMM", "QNNPACK_ACT", "QNNPACK_WEIGHT",
    "FBGEMM_ACT", "FBGEMM_WEIGHT", "SCALE_EPS", "get_qconfig",
    "ObserverState", "init_observer", "batch_min_max", "update_observer",
    "calculate_qparams_folded", "calculate_qparams_traced",
    "quantize", "dequantize", "fake_quantize", "fold_bn", "bn_scale_factor",
    "QTensor", "QParams", "export_int8", "load_int8", "from_jax_variables", "model_variables",
    "numpy_init", "freeze", "export_serving", "load_serving",
]
