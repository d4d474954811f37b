"""The port's kernels: CUDA sources in ``csrc/``, wrappers and plain versions here.

* ``int8_matmul``: INT8 matmul with the fused requant epilogue.
* ``frost_block``: one whole INT8 Frost block.
* ``fake_quant``: observe and fake-quantize one per-tensor QAT site.
* ``int8_conv``: dense 3x3 stride-1 INT8 conv with the fused requant epilogue.
* ``depthwise_int8``: INT8 depthwise conv with the fused requant epilogue.
* ``resize_bilinear``: bilinear resize with the frozen graph's rounding.
* ``requant``: the frozen graph's requant arithmetic as plain torch ops.
"""
from .depthwise_int8 import depthwise_int8
from .fake_quant import fake_quant_observe
from .frost_block import frost_block_int8
from .int8_conv import conv3x3_s1_int8
from .int8_matmul import int8_matmul_requant
from .resize import resize_bilinear

KERNELS = {"int8_matmul_requant": int8_matmul_requant, "frost_block_int8": frost_block_int8,
           "fake_quant_observe": fake_quant_observe, "int8_conv": conv3x3_s1_int8,
           "depthwise_int8": depthwise_int8, "resize_bilinear": resize_bilinear}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}
