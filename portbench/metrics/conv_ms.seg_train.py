"""Device ms a QAT step of ``seg-qat-train`` of the kernels cuDNN and cuBLAS run for
the convolutions (forward and backward) and GEMMs, sorted by the CPU
operator that launched them. The names are frozen here. Moves
``seg_train_images_per_s``."""
from portbench.readers import group_ms

PORT_KERNELS = ("fq_observe_kernel", "fq_quantize_kernel", "fq_min_max_kernel",
                "fq_observe_reduced_kernel", "int8_matmul_requant_kernel", "frost_block_kernel",
                "conv3x3_s1_int8_kernel")
LIBRARY_OPS = ("aten::cudnn_convolution", "aten::convolution_backward", "aten::_convolution",
               "aten::convolution", "aten::conv2d", "aten::cudnn_convolution_transpose",
               "aten::mm", "aten::addmm", "aten::bmm", "aten::matmul", "aten::linear",
               "aten::_int_mm")


def read(m):
    return group_ms(m, "library", PORT_KERNELS, LIBRARY_OPS)
