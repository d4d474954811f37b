"""The yardstick's arithmetic: the H100's peaks, the least time a piece of
work can take on it, and the operations and bytes of the port's kernels,
counted from shapes (never from what an implementation happens to call).

The cost functions are those the repository's bring-up script used for its
kernel table, frozen here: each input byte read once, each output byte
written once.
"""
from __future__ import annotations

from typing import Iterable, Sequence, Tuple

# NVIDIA H100 SXM, dense, at the 700 W limit (NVIDIA's data sheet)
PEAKS = {
    "hbm_bytes_per_s": 3.35e12,
    "int8_ops_per_s": 1979e12,
    "bf16_flops_per_s": 989e12,
    "tf32_flops_per_s": 495e12,
    "float32_flops_per_s": 67e12,
}


def bound_s(nbytes: float, nops: float, peak_ops: float) -> float:
    """The least seconds: the larger of bytes over HBM bandwidth and
    operations over ``peak_ops``."""
    return max(nbytes / PEAKS["hbm_bytes_per_s"], nops / peak_ops)


def fq_cost(numel: int, element_size: int = 4) -> Tuple[float, float]:
    """(bytes, operations) of one fake-quant site: x read once, y and the
    one-byte STE mask written once, the 16-byte observer state; ~10
    operations an element."""
    return numel * (2 * element_size + 1) + 16, 10.0 * numel


def matmul_cost(m: int, k: int, n: int) -> Tuple[float, float]:
    """(bytes, operations) of one INT8 matmul of its own K: x and the weight
    read once, the zero-point term, scale and bias vectors, the uint8 output
    written once."""
    return m * k + k * n + 12 * n + m * n, 2.0 * m * n * k


def block_cost(h: int, w: int, cin: int, cout: int, k: int, stride: int, c_sq: int,
               c_e: int, has_expand: bool, batch: int) -> Tuple[float, float]:
    """(bytes, operations) of one fused INT8 Frost block: the input codes
    read and the output codes written once, every weight and epilogue
    vector once; the multiply-adds of the squeeze, expand, depthwise and
    reduce convolutions."""
    ho, wo = (h + 2 * ((k - 1) // 2) - k) // stride + 1, (w + 2 * ((k - 1) // 2) - k) // stride + 1
    k2, e = k * k, c_e
    ccat = c_sq + cin if c_sq else cin
    weights = cin * c_sq + (ccat * e if has_expand else 0) + k2 * e + e * cout
    vectors = 12 * (c_sq + (e if has_expand else 0) + e + cout)
    nbytes = batch * (h * w * cin + ho * wo * cout) + weights + vectors
    pix, opix = batch * h * w, batch * ho * wo
    nops = 2.0 * (pix * cin * c_sq + (pix * ccat * e if has_expand else 0)
                  + opix * e * k2 + opix * e * cout)
    return nbytes, nops


def conv_flops(convs: Iterable[Sequence]) -> float:
    """Forward FLOPs of ``[name, ho, wo, cin, cout, k, groups]`` rows at one
    image: two a multiply-add."""
    return sum(2.0 * ho * wo * cout * (cin // g) * k * k for _, ho, wo, cin, cout, k, g in convs)


def fq_bound_s(sites: Iterable[Sequence], batch: int) -> float:
    """The least seconds of one QAT forward's fake-quant sites at ``batch``
    (``[name, elements an image, elements fixed]`` rows)."""
    return sum(bound_s(*fq_cost(per * batch + fixed), PEAKS["float32_flops_per_s"])
               for _, per, fixed in sites)


def block_bound_s(blocks: Iterable[Sequence], batch: int) -> float:
    """The least seconds of a fused forward's Frost blocks at ``batch``."""
    return sum(bound_s(*block_cost(h, w, cin, cout, k, s, c_sq, c_e, ex, batch),
                       PEAKS["int8_ops_per_s"])
               for _, h, w, cin, cout, k, s, c_sq, c_e, ex, _res in blocks)


def matmul_bound_s(matmuls: Iterable[Sequence], batch: int) -> float:
    """The least seconds of a forward's INT8 matmuls at ``batch``
    (``[name, M an image, K, N]`` rows)."""
    return sum(bound_s(*matmul_cost(m * batch, k, n), PEAKS["int8_ops_per_s"])
               for _, m, k, n in matmuls)
