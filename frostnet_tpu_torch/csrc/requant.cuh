// Device arithmetic shared by the port's INT8 kernels.
//
// It reproduces the frozen JAX graph bit for bit (see
// frostnet_tpu_torch/ops/requant.py for why each step is what it is):
//   * the conv epilogue is one fused multiply-add, fma(float(acc), scale, bias);
//   * requantization multiplies by a float32 reciprocal computed on the host;
//   * the residual add rounds both products and their sum on their own,
//     (qa - za) * sa + (qb - zb) * sb: in the frozen model XLA contracts
//     neither product there;
//   * rounding is round-half-to-even (rintf), never roundf.
// The sources are compiled with -fmad=false, and every product and sum below
// is written with an explicit _rn intrinsic, so nvcc contracts nothing.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ uint8_t clamp_code(float q, float qmin, float qmax) {
  return (uint8_t)__float2int_rn(fminf(fmaxf(q, qmin), qmax));
}

// int32 accumulator (zero-point term included) -> uint8 code
__device__ __forceinline__ uint8_t requant_acc(int acc, float scale, float bias,
                                               bool relu, float out_mult,
                                               float out_zp, float qmin,
                                               float qmax) {
  float y = __fmaf_rn(__int2float_rn(acc), scale, bias);
  if (relu) y = fmaxf(y, 0.0f);
  const float q = __fadd_rn(rintf(__fmul_rn(y, out_mult)), out_zp);
  return clamp_code(q, qmin, qmax);
}

// code on one grid -> code on another: rint((q - z_in) * s_in * mult) + z_out
__device__ __forceinline__ uint8_t requant_code(int q, float z_in, float s_in,
                                                float mult, float z_out,
                                                float qmax) {
  const float y = __fmul_rn(__fmul_rn(__fsub_rn((float)q, z_in), s_in), mult);
  return clamp_code(__fadd_rn(rintf(y), z_out), 0.0f, qmax);
}

// residual add of two codes: rint(((qa - za) * sa + (qb - zb) * sb) * mult)
__device__ __forceinline__ uint8_t qadd_code(int qa, float za, float sa, int qb,
                                             float zb, float sb, float mult,
                                             float z_out, float qmax) {
  const float ya = __fmul_rn(__fsub_rn((float)qa, za), sa);
  const float yb = __fmul_rn(__fsub_rn((float)qb, zb), sb);
  const float y = __fadd_rn(ya, yb);
  return clamp_code(__fadd_rn(rintf(__fmul_rn(y, mult)), z_out), 0.0f, qmax);
}
