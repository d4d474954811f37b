// Observe and fake-quantize one per-tensor QAT site: two passes over x.
//
// Replaces frostnet_tpu/ops/pallas_fake_quant.py::_fq_observe_fwd (the Pallas
// TPU kernel _fq_kernel and the custom VJP fake_quant_observe). It computes
// what the JAX train step computes at each per-tensor site through
// frostnet_tpu/nn/quant_ops.py::apply_observer, in that order:
//   1. stats pass: the batch min/max of x (compared in float32), then, in the
//      last block to finish, the observer step on the state (uninitialized
//      +-inf state snaps to the batch; else fma(c, batch - m, m), the
//      contraction XLA makes), written in place, and the traced qparams of
//      the updated state written to qparams[0..1] (scale, zero point);
//   2. quantize pass: every thread derives the traced qparams from the state
//      itself (no host round trip, no extra launch), then
//        qraw = rint(x * (1 / scale)) + zp
//        y    = (clamp(qraw, qmin, qmax) - zp) * scale   in x's dtype
//        mask = qmin <= qraw <= qmax                       the STE mask
// QAT_FROZEN runs pass 2 alone, on the frozen state. The TPU kernel instead
// takes the scale as an input and returns min/max beside y: used in one pass
// it would quantize with the previous step's scale, which is not what the
// reference computes.
//
// Traced qparams (the train step's, not freeze's): affine
//   scale = max((max(mx, 0) - min(mn, 0)) * f32(1 / (qmax - qmin)), eps)
//   zp    = clamp(qmin - rint(min(mn, 0) / scale), qmin, qmax)
// symmetric: scale = max(max(-min(mn, 0), max(mx, 0)) * f32(2 / (qmax - qmin)),
// eps), zp fixed; uninitialized state gives (1, 0). The host passes the
// float32 reciprocal. Built with -fmad=false, every operation written as an
// _rn intrinsic; min/max propagate NaN as jnp/torch do.
//
// What bounds it on an H100: bytes. Each element costs a few operations and
// 4 + 4 + 1 bytes (float32) or 2 + 2 + 1 (bf16) at the least: one read of x,
// one write of y and of the mask. This design reads x twice (the statistics
// must be final before the first element is quantized, and no whole-tensor
// grid barrier is used), 13 B/element in float32 and 7 in bf16 against 9 and
// 5. Both passes use 16-byte vector loads and grid-stride loops sized to the
// card; the cross-block reduction is one partial per block and a last-block
// finalization (threadfence + atomic ticket), which resets its ticket.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct Grid {
  float qmin, qmax, factor, eps, sym_zp;
  int symmetric;
};

__device__ __forceinline__ float nan_min(float a, float b) {
  return (a < b || a != a) ? a : b;
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

__device__ __forceinline__ void traced_qparams(float mn, float mx, const Grid& g,
                                               float* scale, float* zp) {
  const float min_neg = nan_min(mn, 0.0f), max_pos = nan_max(mx, 0.0f);
  float s, z;
  if (g.symmetric) {
    s = nan_max(__fmul_rn(nan_max(-min_neg, max_pos), g.factor), g.eps);
    z = g.sym_zp;
  } else {
    s = nan_max(__fmul_rn(__fsub_rn(max_pos, min_neg), g.factor), g.eps);
    z = __fsub_rn(g.qmin, rintf(__fdiv_rn(min_neg, s)));
    z = nan_min(nan_max(z, g.qmin), g.qmax);
  }
  if (isinf(mn)) {
    s = 1.0f;
    z = 0.0f;
  }
  *scale = s;
  *zp = z;
}

template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int kN = 4;
  using Load = float4;
  using Mask = uchar4;
  __device__ static void unpack(const Load& v, float* f) {
    f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
  }
  __device__ static Load pack(const float* f) { return make_float4(f[0], f[1], f[2], f[3]); }
  __device__ static Mask pack_mask(const uint8_t* m) { return make_uchar4(m[0], m[1], m[2], m[3]); }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  using Load = uint4;
  using Mask = uint2;
  __device__ static void unpack(const Load& v, float* f) {
    const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
    for (int i = 0; i < 8; ++i) f[i] = __bfloat162float(h[i]);
  }
  __device__ static Load pack(const float* f) {
    Load v;
    __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(&v);
#pragma unroll
    for (int i = 0; i < 8; ++i) h[i] = __float2bfloat16_rn(f[i]);
    return v;
  }
  __device__ static Mask pack_mask(const uint8_t* m) {
    Mask v;
    uint8_t* b = reinterpret_cast<uint8_t*>(&v);
#pragma unroll
    for (int i = 0; i < 8; ++i) b[i] = m[i];
    return v;
  }
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// (min, max) of the block, valid in thread 0
__device__ __forceinline__ void block_min_max(float& mn, float& mx) {
  __shared__ float smin[kThreads / 32], smax[kThreads / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    mn = nan_min(mn, __shfl_xor_sync(0xffffffffu, mn, o));
    mx = nan_max(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    smin[warp] = mn;
    smax[warp] = mx;
  }
  __syncthreads();
  if (warp == 0) {
    mn = lane < kThreads / 32 ? smin[lane] : INFINITY;
    mx = lane < kThreads / 32 ? smax[lane] : -INFINITY;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      mn = nan_min(mn, __shfl_xor_sync(0xffffffffu, mn, o));
      mx = nan_max(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    }
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fq_stats_kernel(const T* __restrict__ x, long long n, int aligned,
                float* __restrict__ state_min, float* __restrict__ state_max,
                float* __restrict__ qparams, float* __restrict__ partials,
                unsigned int* __restrict__ ticket, float c, int has_c, Grid g) {
  using V = Vec<T>;
  float mn = INFINITY, mx = -INFINITY;
  const long long tid = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long stride = (long long)gridDim.x * kThreads;
  long long done = 0;
  if (aligned) {
    const long long nv = n / V::kN;
    const typename V::Load* xv = reinterpret_cast<const typename V::Load*>(x);
    for (long long i = tid; i < nv; i += stride) {
      float f[V::kN];
      V::unpack(xv[i], f);
#pragma unroll
      for (int k = 0; k < V::kN; ++k) {
        mn = nan_min(mn, f[k]);
        mx = nan_max(mx, f[k]);
      }
    }
    done = nv * V::kN;
  }
  for (long long i = done + tid; i < n; i += stride) {
    const float f = to_f32(x[i]);
    mn = nan_min(mn, f);
    mx = nan_max(mx, f);
  }
  block_min_max(mn, mx);

  __shared__ bool last;
  if (threadIdx.x == 0) {
    partials[2 * blockIdx.x] = mn;
    partials[2 * blockIdx.x + 1] = mx;
    __threadfence();
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;

  // the last block: reduce the partials and finish on the device
  __threadfence();
  mn = INFINITY;
  mx = -INFINITY;
  for (int b = threadIdx.x; b < (int)gridDim.x; b += kThreads) {
    mn = nan_min(mn, __ldcg(partials + 2 * b));
    mx = nan_max(mx, __ldcg(partials + 2 * b + 1));
  }
  block_min_max(mn, mx);
  if (threadIdx.x == 0) {
    const float m0 = *state_min, M0 = *state_max;
    const bool uninit = isinf(m0);
    float nmin, nmax;
    if (has_c) {
      nmin = uninit ? mn : __fmaf_rn(c, __fsub_rn(mn, m0), m0);
      nmax = uninit ? mx : __fmaf_rn(c, __fsub_rn(mx, M0), M0);
    } else {
      nmin = nan_min(uninit ? mn : m0, mn);
      nmax = nan_max(uninit ? mx : M0, mx);
    }
    *state_min = nmin;
    *state_max = nmax;
    float s, z;
    traced_qparams(nmin, nmax, g, &s, &z);
    qparams[0] = s;
    qparams[1] = z;
    *ticket = 0u;
  }
}

template <typename T>
__device__ __forceinline__ float fq_one(float v, float inv, float s, float z, const Grid& g,
                                        uint8_t* m) {
  const float qraw = __fadd_rn(rintf(__fmul_rn(v, inv)), z);
  *m = (qraw >= g.qmin && qraw <= g.qmax) ? 1 : 0;
  const float q = nan_min(nan_max(qraw, g.qmin), g.qmax);
  return __fmul_rn(__fsub_rn(q, z), s);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fq_quantize_kernel(const T* __restrict__ x, T* __restrict__ y, uint8_t* __restrict__ mask,
                   long long n, int aligned, const float* __restrict__ state_min,
                   const float* __restrict__ state_max, Grid g) {
  using V = Vec<T>;
  float s, z;
  traced_qparams(*state_min, *state_max, g, &s, &z);
  const float inv = __fdiv_rn(1.0f, s);
  const long long tid = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long stride = (long long)gridDim.x * kThreads;
  long long done = 0;
  if (aligned) {
    const long long nv = n / V::kN;
    const typename V::Load* xv = reinterpret_cast<const typename V::Load*>(x);
    typename V::Load* yv = reinterpret_cast<typename V::Load*>(y);
    typename V::Mask* mv = reinterpret_cast<typename V::Mask*>(mask);
    for (long long i = tid; i < nv; i += stride) {
      float f[V::kN];
      uint8_t m[V::kN];
      V::unpack(xv[i], f);
#pragma unroll
      for (int k = 0; k < V::kN; ++k) f[k] = fq_one<T>(f[k], inv, s, z, g, &m[k]);
      yv[i] = V::pack(f);
      mv[i] = V::pack_mask(m);
    }
    done = nv * V::kN;
  }
  for (long long i = done + tid; i < n; i += stride) {
    uint8_t m;
    store(y + i, fq_one<T>(to_f32(x[i]), inv, s, z, g, &m));
    mask[i] = m;
  }
}

int blocks_for(long long n, int per_thread, int cap) {
  long long b = (n + (long long)kThreads * per_thread - 1) / ((long long)kThreads * per_thread);
  if (b < 1) b = 1;
  return (int)(b < cap ? b : cap);
}

}  // namespace

extern "C" {

// Stats pass. partials holds 2 * max_blocks floats, ticket one zeroed uint32.
int frost_fq_stats(const void* x, int is_bf16, long long n, int aligned, float* state_min,
                   float* state_max, float* qparams, float* partials, unsigned int* ticket,
                   int max_blocks, float c, int has_c, float qmin, float qmax, float factor,
                   float eps, float sym_zp, int symmetric, cudaStream_t stream) {
  const Grid g{qmin, qmax, factor, eps, sym_zp, symmetric};
  if (is_bf16) {
    const int blocks = blocks_for(n, 16, max_blocks);
    fq_stats_kernel<__nv_bfloat16><<<blocks, kThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(x), n, aligned, state_min, state_max, qparams,
        partials, ticket, c, has_c, g);
  } else {
    const int blocks = blocks_for(n, 8, max_blocks);
    fq_stats_kernel<float><<<blocks, kThreads, 0, stream>>>(
        static_cast<const float*>(x), n, aligned, state_min, state_max, qparams, partials,
        ticket, c, has_c, g);
  }
  return (int)cudaGetLastError();
}

// Quantize pass: y in x's dtype, mask one byte (0/1) per element.
int frost_fq_quantize(const void* x, void* y, uint8_t* mask, int is_bf16, long long n,
                      int aligned, const float* state_min, const float* state_max, float qmin,
                      float qmax, float factor, float eps, float sym_zp, int symmetric,
                      int max_blocks, cudaStream_t stream) {
  const Grid g{qmin, qmax, factor, eps, sym_zp, symmetric};
  if (is_bf16) {
    const int blocks = blocks_for(n, 8, max_blocks);
    fq_quantize_kernel<__nv_bfloat16><<<blocks, kThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(y), mask, n,
        aligned, state_min, state_max, g);
  } else {
    const int blocks = blocks_for(n, 4, max_blocks);
    fq_quantize_kernel<float><<<blocks, kThreads, 0, stream>>>(
        static_cast<const float*>(x), static_cast<float*>(y), mask, n, aligned, state_min,
        state_max, g);
  }
  return (int)cudaGetLastError();
}

const char* frost_fq_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
