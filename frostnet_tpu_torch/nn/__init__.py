"""Quant-ready layers of the INT8 serving port."""
from .mode import FP32, INT8, QAT, QAT_FROZEN, QuantMode
from .quant_ops import Observer, QAdd, QCat, QuantStub, dequant
from .pool import global_avg_pool
from .conv import QConvBNAct

__all__ = [
    "QuantMode", "FP32", "QAT", "QAT_FROZEN", "INT8",
    "Observer", "QuantStub", "QAdd", "QCat", "dequant",
    "global_avg_pool", "QConvBNAct",
]
