"""Quant-aware layers of the port: convs, observed ops, pooling and the MobileNet blocks."""
from .mode import FP32, INT8, QAT, QAT_FROZEN, QuantMode
from .quant_ops import (Observer, QAdd, QAddReLU, QCat, QMul, QuantStub, add_scalar, dequant,
                        mul_scalar, observed_standalone_act)
from .pool import avg_pool, global_avg_pool, max_pool
from .conv import QConvBNAct
from .blocks import BottleneckV3, InvertedResidual, QDense, QHsigmoid, QHswish, QSEModule

__all__ = [
    "QuantMode", "FP32", "QAT", "QAT_FROZEN", "INT8",
    "Observer", "QuantStub", "QAdd", "QAddReLU", "QCat", "QMul", "dequant", "add_scalar",
    "mul_scalar", "observed_standalone_act", "avg_pool", "global_avg_pool", "max_pool",
    "QConvBNAct", "QHswish", "QHsigmoid", "QDense", "QSEModule", "InvertedResidual", "BottleneckV3",
]
