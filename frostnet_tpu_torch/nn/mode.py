"""Execution mode for quant-aware modules.

The same model serves every phase; the phase is a value:

  * ``FP32``       - plain float training/eval (StatAssist warm-up).
  * ``QAT``        - fake-quant forward, observers updating.
  * ``QAT_FROZEN`` - fake-quant forward, observers frozen.
  * ``INT8``       - true integer inference (torch.quantization.convert).

Every phase runs in the port.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class QuantMode:
    fake_quant: bool = False  # apply quantize-dequantize in forward
    observe: bool = False     # update observer state
    int8: bool = False        # true-integer inference path (freeze/convert)

    def __post_init__(self):
        if self.int8 and (self.fake_quant or self.observe):
            raise ValueError("int8 mode is exclusive")


FP32 = QuantMode()
QAT = QuantMode(fake_quant=True, observe=True)
QAT_FROZEN = QuantMode(fake_quant=True, observe=False)
INT8 = QuantMode(int8=True)
