// Observe and fake-quantize one per-tensor QAT site in one launch.
//
// Replaces frostnet_tpu/ops/pallas_fake_quant.py::_fq_observe_fwd (the Pallas
// TPU kernel _fq_kernel and the custom VJP fake_quant_observe). It computes
// what the JAX train step computes at each per-tensor site through
// frostnet_tpu/nn/quant_ops.py::apply_observer, in that order:
//   1. the batch min/max of x (compared in float32), then the observer step
//      on the state (uninitialized +-inf state snaps to the batch; else
//      fma(c, batch - m, m), the contraction XLA makes), written in place,
//      and the traced qparams of the updated state, written to qparams[0..1]
//      (scale, zero point);
//   2. with those qparams,
//        qraw = rint(x * (1 / scale)) + zp
//        y    = (clamp(qraw, qmin, qmax) - zp) * scale   in x's dtype
//        mask = qmin <= qraw <= qmax                       the STE mask
// QAT_FROZEN runs step 2 alone on the frozen state (fq_quantize_kernel). The
// TPU kernel instead takes the scale as an input and returns min/max beside
// y: used in one pass it would quantize with the previous step's scale,
// which is not what the reference computes.
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
// one write of y and of the mask. Step 2 cannot start before the statistics
// of the whole tensor are final, so x is read twice unless it stays on
// chip. The design keeps it there as far as it fits, in one launch:
//   * the host plans one of two launch shapes per site
//     (ops/fake_quant.py::plan_fake_quant):
//       (a) for small sites, one thread-block cluster of 1-16 CUDA blocks of
//           256 threads, each holding its 16 KiB or less of x in registers;
//           each block stores its partial into every block's shared memory
//           (distributed shared memory), then one barrier.cluster;
//       (b) else one persistent grid, one CUDA block of 1024 threads an SM,
//           launched cooperative (every block resident at once); each block
//           brings up to kResidentBytes of x into shared memory by bulk
//           copies (the TMA engine, one mbarrier per 32 KiB piece); what
//           does not fit on chip the blocks stream together in 64 KiB tiles
//           with 16-byte loads (kUnroll in flight a thread), taking min/max
//           only; each block stores its partial in its slot of a scratch
//           array, tagged with the launch's generation, and polls all slots
//           until every one carries the tag, which is the grid-wide barrier
//           too (grid_exchange: nothing to reset, so every launch, a CUDA
//           graph's replay too, starts ready);
//     the old state is read while x arrives;
//   * every CUDA block reduces all partials in the same order and derives the
//     same new state and qparams (each read the old state before the
//     exchange; block 0 alone writes the new state and qparams after it);
//   * the blocks quantize the streamed tiles in the reverse order of their
//     statistics read (the bytes read last, still in the 50 MB L2, first;
//     re-read and written with evict-first hints), then each its resident
//     vectors from shared memory or registers (y there stays in L2 for the
//     next layer; the mask, read in the backward pass, is evict-first).
// Sites up to ~26 MiB (132 x 208 KiB) read x from device memory once; larger
// ones re-read what did not stay in L2. x that is not 16-byte aligned (a view)
// and the ragged tail take a scalar path over the planned scalar ranges.
//
// The data-parallel route (ops/fake_quant.py::_observe_global): under a
// mesh of several replicas the observer must see the global batch's min and
// max, which no launch on one rank's rows can know. A site is then two
// launches around one all-reduce:
//   fq_min_max_kernel        this rank's min and max (a grid of CUDA blocks,
//                            16-byte loads; each block stores its partial, and
//                            the last block to arrive, by an atomic count,
//                            reduces the partials in block order) into
//                            stats = (-min, max, old min, old max): the old
//                            state is copied before any launch can step it;
//   all-reduce (MAX) of stats[0..1] on the host's stream (torch.distributed);
//   fq_observe_reduced_kernel  every thread steps the state from stats with
//                            the observer's FMA and derives the traced
//                            qparams (the same arithmetic as finish above),
//                            block 0 writes them, and the grid quantizes.
// x is read twice, once a launch (the collective sits between them); the
// route is bound by those bytes and, on one card, by the collective.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "int8_mma.cuh"

namespace cg = cooperative_groups;

namespace {

using frost_mma::bulk_load;
using frost_mma::mbar_expect_tx;
using frost_mma::mbar_init;
using frost_mma::mbar_wait;
using frost_mma::smem_u32;

constexpr int kThreads = 1024;  // observing kernel, grid shape: one CUDA block an SM
constexpr int kClusterThreads = 256;  // observing kernel, cluster shape
constexpr int kQuantThreads = 256;  // QAT_FROZEN quantize kernel
constexpr int kUnroll = 4;  // 16-byte loads in flight a thread while streaming
constexpr int kTile = kUnroll * kThreads;  // vectors of a streamed tile
constexpr int kPieceBytes = 32768;  // one bulk copy and one mbarrier each
constexpr int kResidentBytes = 212992;  // x a CUDA block holds in shared memory at most
constexpr int kPieces = (kResidentBytes + kPieceBytes - 1) / kPieceBytes;
constexpr int kMaxCluster = 16;

struct Grid {
  float qmin, qmax, factor, eps, sym_zp;
  int symmetric;
};

// One observing launch over G CUDA blocks. Vectors are 16 bytes of x (nv of
// them; 0 where x is not 16-byte aligned). Block b holds the vectors
// [b * res, (b + 1) * res) on chip (in shared memory; in registers in the
// cluster shape); the rest, [G * res, nv), is
// streamed in tiles of kTile vectors, tile k by block k % G (all blocks
// sweep x together, front to back, and back again to quantize); block b
// also owns the elements [nv * N + b * schunk, nv * N + (b + 1) * schunk) of
// the scalar range [nv * N, n) (N elements a vector). Each range is cut at
// its end.
struct Site {
  const void* x;
  void* y;
  uint8_t* mask;
  float* state_min;
  float* state_max;
  float* qparams;
  unsigned long long* slots;  // grid shape: a tagged slot a CUDA block (grid_exchange)
  unsigned int* gen;  // grid shape: the generation of the last launch
  long long n, nv, schunk;
  int res, has_c;
  float c;
  Grid g;
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
  using Mask = unsigned int;
  __device__ static void unpack(const Load& v, float* f) {
    f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
  }
  __device__ static Load pack(const float* f) { return make_float4(f[0], f[1], f[2], f[3]); }
  __device__ static Mask pack_mask(const uint8_t* m) {
    return m[0] | (m[1] << 8) | (m[2] << 16) | ((unsigned int)m[3] << 24);
  }
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

__device__ __forceinline__ float fq_one(float v, float inv, float s, float z, const Grid& g,
                                        uint8_t* m) {
  const float qraw = __fadd_rn(rintf(__fmul_rn(v, inv)), z);
  *m = (qraw >= g.qmin && qraw <= g.qmax) ? 1 : 0;
  const float q = nan_min(nan_max(qraw, g.qmin), g.qmax);
  return __fmul_rn(__fsub_rn(q, z), s);
}

template <typename T>
__device__ __forceinline__ void min_max(const typename Vec<T>::Load& v, float& mn, float& mx) {
  float f[Vec<T>::kN];
  Vec<T>::unpack(v, f);
#pragma unroll
  for (int k = 0; k < Vec<T>::kN; ++k) {
    mn = nan_min(mn, f[k]);
    mx = nan_max(mx, f[k]);
  }
}

// fake-quantize one vector of x into y and the mask at vector index i. The
// mask waits for the backward pass: its stores are evict-first in L2, as are
// y's where kEvict (the streamed part of a large x, whose y would only push
// x's last-read tiles out of L2); elsewhere y stays in L2 for its consumer.
template <typename T, bool kEvict>
__device__ __forceinline__ void fq_vec(const typename Vec<T>::Load& v, long long i, T* y,
                                       uint8_t* mask, float inv, float s, float z, const Grid& g) {
  using V = Vec<T>;
  float f[V::kN];
  uint8_t m[V::kN];
  V::unpack(v, f);
#pragma unroll
  for (int k = 0; k < V::kN; ++k) f[k] = fq_one(f[k], inv, s, z, g, &m[k]);
  typename V::Load* yv = reinterpret_cast<typename V::Load*>(y) + i;
  if (kEvict)
    __stcs(yv, V::pack(f));
  else
    *yv = V::pack(f);
  __stcs(reinterpret_cast<typename V::Mask*>(mask) + i, V::pack_mask(m));
}

// (min, max) of the CUDA block of kT threads, valid in warp 0
template <int kT>
__device__ __forceinline__ void block_min_max(float& mn, float& mx) {
  __shared__ float smin[kT / 32], smax[kT / 32];
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
    mn = lane < kT / 32 ? smin[lane] : INFINITY;
    mx = lane < kT / 32 ? smax[lane] : -INFINITY;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      mn = nan_min(mn, __shfl_xor_sync(0xffffffffu, mn, o));
      mx = nan_max(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    }
  }
  __syncthreads();
}

// The grid shape's exchange, which is its grid-wide barrier too. CUDA block
// b stores its partial in slot b (its own 128-byte line, so the polling
// spreads over L2) as two 64-bit words, (tag << 32) | the bits
// of min and (tag << 32) | the bits of max, where the tag is the launch's
// (the generation word + 1, read when the block started). An aligned 64-bit
// access is single-copy atomic, so a word that carries the tag carries this
// launch's value: warp 0 of every block polls all slots at once (relaxed
// loads, no fence) until each carries the tag, then reduces the partials in
// slot order (each lane its slots, then a butterfly: one order for every
// block). Block 0 advances the generation once it has seen every tag, after
// every block has read it; nothing needs a reset, so every launch, a CUDA
// graph's replay too, starts ready. Valid in every lane of warp 0.
constexpr int kSlotsPerLane = 5;  // up to 160 CUDA blocks
constexpr int kSlotWords = 16;  // a slot's stride: one 128-byte line (polled by every block)

__device__ __forceinline__ void grid_exchange(unsigned long long* slots, unsigned int* gen,
                                              unsigned int tag, float& mn, float& mx) {
  const int b = blockIdx.x, nb = gridDim.x, lane = threadIdx.x;
  const unsigned long long t = (unsigned long long)tag << 32;
  if (lane == 0)
    asm volatile("st.volatile.global.v2.u64 [%0], {%1, %2};\n" ::"l"(slots + kSlotWords * b),
                 "l"(t | __float_as_uint(mn)), "l"(t | __float_as_uint(mx))
                 : "memory");
  unsigned long long lo[kSlotsPerLane], hi[kSlotsPerLane];
  unsigned int todo = 0;
#pragma unroll
  for (int k = 0; k < kSlotsPerLane; ++k)
    if (lane + 32 * k < nb) todo |= 1u << k;
  while (todo) {
#pragma unroll
    for (int k = 0; k < kSlotsPerLane; ++k)
      if (todo >> k & 1u)
        asm volatile("ld.volatile.global.v2.u64 {%0, %1}, [%2];\n"
                     : "=l"(lo[k]), "=l"(hi[k])
                     : "l"(slots + kSlotWords * (lane + 32 * k))
                     : "memory");
#pragma unroll
    for (int k = 0; k < kSlotsPerLane; ++k)
      if ((todo >> k & 1u) && (lo[k] >> 32) == tag && (hi[k] >> 32) == tag) todo &= ~(1u << k);
  }
  mn = INFINITY;
  mx = -INFINITY;
#pragma unroll
  for (int k = 0; k < kSlotsPerLane; ++k) {
    if (lane + 32 * k < nb) {
      mn = nan_min(mn, __uint_as_float((unsigned int)lo[k]));
      mx = nan_max(mx, __uint_as_float((unsigned int)hi[k]));
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    mn = nan_min(mn, __shfl_xor_sync(0xffffffffu, mn, o));
    mx = nan_max(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  }
  if (b == 0 && lane == 0) *gen = tag;
}

// The observer step on the batch's (mn, mx) and the traced qparams of the
// new state (thread 0): out = (new min, new max, scale, zero point).
__device__ __forceinline__ void finish(float mn, float mx, float m0, float M0, int has_c,
                                       float c, const Grid& g, float* out) {
  const bool uninit = isinf(m0);
  float nmin, nmax;
  if (has_c) {
    nmin = uninit ? mn : __fmaf_rn(c, __fsub_rn(mn, m0), m0);
    nmax = uninit ? mx : __fmaf_rn(c, __fsub_rn(mx, M0), M0);
  } else {
    nmin = nan_min(uninit ? mn : m0, mn);
    nmax = nan_max(uninit ? mx : M0, mx);
  }
  out[0] = nmin;
  out[1] = nmax;
  traced_qparams(nmin, nmax, g, &out[2], &out[3]);
}

template <typename T, bool kCluster>
__global__ void __launch_bounds__(kCluster ? kClusterThreads : kThreads, 1)
    fq_observe_kernel(const Site s) {
  using V = Vec<T>;
  using L = typename V::Load;
  constexpr int kT = kCluster ? kClusterThreads : kThreads;
  extern __shared__ __align__(128) uint8_t resident[];  // grid shape
  __shared__ __align__(8) uint64_t bars[kPieces];
  __shared__ float old[2];  // the state before this step
  __shared__ unsigned int tag;  // grid shape: this launch's tag
  __shared__ float2 part[kMaxCluster];  // cluster shape: each rank's (min, max), pushed by it
  __shared__ float fin[4];  // new min, new max, scale, zero point

  const int tid = threadIdx.x, b = blockIdx.x, nb = gridDim.x;
  const T* x = static_cast<const T*>(s.x);
  const L* xv = static_cast<const L*>(s.x);
  const L* rv = reinterpret_cast<const L*>(resident);
  const long long v0 = min(s.nv, (long long)b * s.res), v1 = min(s.nv, v0 + s.res);
  const long long first = min(s.nv, (long long)nb * s.res) + (long long)b * kTile;  // own tile
  const long long step = (long long)nb * kTile;
  const int nres = (int)(v1 - v0);
  const int pieces = kCluster ? 0 : (nres * 16 + kPieceBytes - 1) / kPieceBytes;
  const long long e0 = min(s.n, s.nv * V::kN + b * s.schunk), e1 = min(s.n, e0 + s.schunk);

  // 1. in flight at once: the resident vectors (the cluster shape's into
  // registers, the grid shape's by thread 0's bulk copies), the old state
  // and the generation (warp 1: every block reads the state before the
  // exchange, after which block 0 writes the new one), the streamed tiles
  L reg[kUnroll];  // cluster shape: vectors v0 + tid + u * kT
  if constexpr (kCluster) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (u * kT + tid < nres) reg[u] = xv[v0 + u * kT + tid];
  }
  if (tid == 0 && pieces) {
    for (int p = 0; p < pieces; ++p) mbar_init(smem_u32(&bars[p]));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int p = 0; p < pieces; ++p) {
      const int off = p * kPieceBytes, bytes = min(kPieceBytes, nres * 16 - off);
      mbar_expect_tx(smem_u32(&bars[p]), bytes);
      bulk_load(smem_u32(resident + off), reinterpret_cast<const uint8_t*>(xv + v0) + off,
                bytes, smem_u32(&bars[p]));
    }
  }
  if (tid == 32) {
    old[0] = *s.state_min;
    old[1] = *s.state_max;
    if (!kCluster) tag = *s.gen + 1;
  }

  // 2. min/max: the streamed tiles, the scalar range, the resident vectors
  float mn = INFINITY, mx = -INFINITY;
  for (long long tile = first; tile < s.nv; tile += step) {
    L r[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (tile + u * kT + tid < s.nv) r[u] = xv[tile + u * kT + tid];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (tile + u * kT + tid < s.nv) min_max<T>(r[u], mn, mx);
  }
  for (long long e = e0 + tid; e < e1; e += kT) {
    const float f = to_f32(x[e]);
    mn = nan_min(mn, f);
    mx = nan_max(mx, f);
  }
  if constexpr (kCluster) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (u * kT + tid < nres) min_max<T>(reg[u], mn, mx);
  } else {
    __syncthreads();  // the mbarriers initialized
    for (int p = 0; p < pieces; ++p) {
      mbar_wait(smem_u32(&bars[p]), 0);
      const int hi = min(nres, (p + 1) * (kPieceBytes / 16));
      for (int i = p * (kPieceBytes / 16) + tid; i < hi; i += kT) min_max<T>(rv[i], mn, mx);
    }
  }
  block_min_max<kT>(mn, mx);  // ends with __syncthreads: old and tag written

  // 3. all blocks' partials, in one order, in every block
  if constexpr (kCluster) {
    // lane r of warp 0 stores this block's partial into rank r's shared
    // memory (no remote load after the barrier, so no rank waits for its
    // peers before it exits)
    if (tid < nb) *cg::this_cluster().map_shared_rank(&part[b], tid) = make_float2(mn, mx);
    if (nb > 1) {
      asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
      asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
    } else {
      __syncthreads();
    }
    if (tid == 0) {
      float gmn = INFINITY, gmx = -INFINITY;
      for (int r = 0; r < nb; ++r) {
        gmn = nan_min(gmn, part[r].x);
        gmx = nan_max(gmx, part[r].y);
      }
      finish(gmn, gmx, old[0], old[1], s.has_c, s.c, s.g, fin);
    }
  } else if (tid < 32) {
    grid_exchange(s.slots, s.gen, tag, mn, mx);
    if (tid == 0) finish(mn, mx, old[0], old[1], s.has_c, s.c, s.g, fin);
  }
  __syncthreads();
  if (b == 0 && tid == 0) {
    *s.state_min = fin[0];
    *s.state_max = fin[1];
    s.qparams[0] = fin[2];
    s.qparams[1] = fin[3];
  }

  // 4. quantize: the streamed tiles last-read first, the scalar range, then
  // the resident vectors
  const float sc = fin[2], z = fin[3], inv = __fdiv_rn(1.0f, sc);
  T* y = static_cast<T*>(s.y);
  const long long last = first < s.nv ? first + (s.nv - 1 - first) / step * step : first - step;
  for (long long tile = last; tile >= first; tile -= step) {
    L r[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (tile + u * kT + tid < s.nv) r[u] = __ldcs(xv + tile + u * kT + tid);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (tile + u * kT + tid < s.nv)
        fq_vec<T, true>(r[u], tile + u * kT + tid, y, s.mask, inv, sc, z, s.g);
  }
  for (long long e = e0 + tid; e < e1; e += kT) {
    uint8_t m;
    store(y + e, fq_one(to_f32(x[e]), inv, sc, z, s.g, &m));
    s.mask[e] = m;
  }
  if constexpr (kCluster) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (u * kT + tid < nres)
        fq_vec<T, false>(reg[u], v0 + u * kT + tid, y, s.mask, inv, sc, z, s.g);
  } else {
    for (int i = tid; i < nres; i += kT)
      fq_vec<T, false>(rv[i], v0 + i, y, s.mask, inv, sc, z, s.g);
  }
}

// QAT_FROZEN: fake-quantize with the qparams of the frozen state, which
// every thread derives itself (grid-stride, 16-byte vectors where aligned).
template <typename T>
__global__ void __launch_bounds__(kQuantThreads)
fq_quantize_kernel(const T* __restrict__ x, T* __restrict__ y, uint8_t* __restrict__ mask,
                   long long n, int aligned, const float* __restrict__ state_min,
                   const float* __restrict__ state_max, Grid g) {
  using V = Vec<T>;
  float s, z;
  traced_qparams(*state_min, *state_max, g, &s, &z);
  const float inv = __fdiv_rn(1.0f, s);
  const long long tid = (long long)blockIdx.x * kQuantThreads + threadIdx.x;
  const long long stride = (long long)gridDim.x * kQuantThreads;
  long long done = 0;
  if (aligned) {
    const long long nv = n / V::kN;
    const typename V::Load* xv = reinterpret_cast<const typename V::Load*>(x);
    for (long long i = tid; i < nv; i += stride)
      fq_vec<T, false>(xv[i], i, y, mask, inv, s, z, g);
    done = nv * V::kN;
  }
  for (long long i = done + tid; i < n; i += stride) {
    uint8_t m;
    store(y + i, fq_one(to_f32(x[i]), inv, s, z, g, &m));
    mask[i] = m;
  }
}

// The data-parallel route's first launch: this rank's (-min, max) and the
// old state into stats[0..3]. partials holds two floats a CUDA block, count
// one uint32 (zero between launches: the last block resets it).
template <typename T>
__global__ void __launch_bounds__(kQuantThreads)
fq_min_max_kernel(const T* __restrict__ x, long long n, int aligned,
                  const float* __restrict__ state_min, const float* __restrict__ state_max,
                  float* __restrict__ stats, float* partials, unsigned int* count) {
  using V = Vec<T>;
  const long long tid = (long long)blockIdx.x * kQuantThreads + threadIdx.x;
  const long long stride = (long long)gridDim.x * kQuantThreads;
  float mn = INFINITY, mx = -INFINITY;
  long long done = 0;
  if (aligned) {
    const long long nv = n / V::kN;
    const typename V::Load* xv = reinterpret_cast<const typename V::Load*>(x);
    for (long long i = tid; i < nv; i += stride) min_max<T>(xv[i], mn, mx);
    done = nv * V::kN;
  }
  for (long long i = done + tid; i < n; i += stride) {
    const float f = to_f32(x[i]);
    mn = nan_min(mn, f);
    mx = nan_max(mx, f);
  }
  block_min_max<kQuantThreads>(mn, mx);
  __shared__ bool last;
  if (threadIdx.x == 0) {
    partials[2 * blockIdx.x] = mn;
    partials[2 * blockIdx.x + 1] = mx;
    __threadfence();
    last = atomicAdd(count, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last || threadIdx.x >= 32) return;
  // the last CUDA block: every partial is visible (each was fenced before
  // its block counted); warp 0 reduces them in block order
  __threadfence();
  const int lane = threadIdx.x;
  mn = INFINITY;
  mx = -INFINITY;
  for (int b = lane; b < (int)gridDim.x; b += 32) {
    mn = nan_min(mn, __ldcg(partials + 2 * b));
    mx = nan_max(mx, __ldcg(partials + 2 * b + 1));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    mn = nan_min(mn, __shfl_xor_sync(0xffffffffu, mn, o));
    mx = nan_max(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  }
  if (lane == 0) {
    stats[0] = -mn;
    stats[1] = mx;
    stats[2] = *state_min;
    stats[3] = *state_max;
    *count = 0;
  }
}

// The data-parallel route's second launch: the observer step on the global
// (min, max) = (-stats[0], stats[1]) from the old state stats[2..3], the
// traced qparams (each thread derives them; block 0 writes the new state
// and the qparams), then the fake-quantization of x.
template <typename T>
__global__ void __launch_bounds__(kQuantThreads)
fq_observe_reduced_kernel(const T* __restrict__ x, T* __restrict__ y, uint8_t* __restrict__ mask,
                          long long n, int aligned, const float* __restrict__ stats,
                          float* state_min, float* state_max, float* qparams, int has_c,
                          float c, Grid g) {
  using V = Vec<T>;
  float fin[4];
  finish(-stats[0], stats[1], stats[2], stats[3], has_c, c, g, fin);
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    *state_min = fin[0];
    *state_max = fin[1];
    qparams[0] = fin[2];
    qparams[1] = fin[3];
  }
  const float s = fin[2], z = fin[3], inv = __fdiv_rn(1.0f, s);
  const long long tid = (long long)blockIdx.x * kQuantThreads + threadIdx.x;
  const long long stride = (long long)gridDim.x * kQuantThreads;
  long long done = 0;
  if (aligned) {
    const long long nv = n / V::kN;
    const typename V::Load* xv = reinterpret_cast<const typename V::Load*>(x);
    for (long long i = tid; i < nv; i += stride)
      fq_vec<T, false>(xv[i], i, y, mask, inv, s, z, g);
    done = nv * V::kN;
  }
  for (long long i = done + tid; i < n; i += stride) {
    uint8_t m;
    store(y + i, fq_one(to_f32(x[i]), inv, s, z, g, &m));
    mask[i] = m;
  }
}

template <typename T, bool kCluster>
cudaError_t set_attributes() {
  auto kernel = fq_observe_kernel<T, kCluster>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kResidentBytes);
  if (err != cudaSuccess || !kCluster) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

// (a) one cluster of `blocks` CUDA blocks, or (b) a cooperative grid
template <bool kCluster>
cudaLaunchConfig_t launch_config(int blocks, int smem, cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kCluster ? kClusterThreads : kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  if (kCluster) {
    attr->id = cudaLaunchAttributeClusterDimension;
    attr->val.clusterDim.x = blocks;
    attr->val.clusterDim.y = 1;
    attr->val.clusterDim.z = 1;
  } else {
    attr->id = cudaLaunchAttributeCooperative;
    attr->val.cooperative = 1;
  }
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <typename T, bool kCluster>
cudaError_t launch(const Site& s, int blocks, int smem, cudaStream_t stream) {
  static const cudaError_t attr_err = set_attributes<T, kCluster>();
  if (attr_err != cudaSuccess) return attr_err;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = launch_config<kCluster>(blocks, smem, stream, &attr);
  cudaError_t err = cudaLaunchKernelEx(&cfg, fq_observe_kernel<T, kCluster>, s);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// clusters of the launch the card holds at once (a), or CUDA blocks an SM (b)
template <typename T, bool kCluster>
cudaError_t occupancy(int blocks, int smem, int* count) {
  static const cudaError_t attr_err = set_attributes<T, kCluster>();
  if (attr_err != cudaSuccess) return attr_err;
  if (!kCluster)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(count, fq_observe_kernel<T, false>,
                                                         kThreads, smem);
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = launch_config<true>(blocks, smem, 0, &attr);
  return cudaOccupancyMaxActiveClusters(count, fq_observe_kernel<T, true>, &cfg);
}

int blocks_for(long long n, int per_thread, int cap) {
  long long b = (n + (long long)kQuantThreads * per_thread - 1) /
                ((long long)kQuantThreads * per_thread);
  if (b < 1) b = 1;
  return (int)(b < cap ? b : cap);
}

}  // namespace

extern "C" {

int frost_fq_resident_bytes() { return kResidentBytes; }
int frost_fq_tile_vectors() { return kTile; }
int frost_fq_slot_bytes() { return kSlotWords * 8; }

// The observing launch of one site (ops/fake_quant.py plans it). slots
// holds 128 bytes a CUDA block of the grid shape and gen one uint32, both
// zeroed once by the host.
int frost_fq_observe(const void* x, void* y, uint8_t* mask, int is_bf16, long long n,
                     long long nv, long long schunk, int res, int cluster, int blocks, int smem,
                     float* state_min, float* state_max, float* qparams,
                     unsigned long long* slots, unsigned int* gen, float c, int has_c,
                     float qmin, float qmax, float factor, float eps, float sym_zp,
                     int symmetric, cudaStream_t stream) {
  // a plan that leaves an element out, or that the kernel cannot hold on chip
  if (blocks < 1 || blocks > (cluster ? kMaxCluster : 32 * kSlotsPerLane) || res < 0 ||
      schunk < 0 || smem > kResidentBytes ||
      (cluster ? res > kUnroll * kClusterThreads || (long long)blocks * res < nv
               : smem < 16 * res) ||
      nv * (is_bf16 ? 8 : 4) + blocks * schunk < n)
    return (int)cudaErrorInvalidValue;
  const Site s{x, y, mask, state_min, state_max, qparams, slots, gen, n, nv, schunk,
               res, has_c, c, Grid{qmin, qmax, factor, eps, sym_zp, symmetric}};
  if (is_bf16)
    return (int)(cluster ? launch<__nv_bfloat16, true>(s, blocks, smem, stream)
                         : launch<__nv_bfloat16, false>(s, blocks, smem, stream));
  return (int)(cluster ? launch<float, true>(s, blocks, smem, stream)
                       : launch<float, false>(s, blocks, smem, stream));
}

// cudaOccupancyMaxActiveClusters of a cluster launch, or
// cudaOccupancyMaxActiveBlocksPerMultiprocessor of a grid launch, into *count
int frost_fq_occupancy(int is_bf16, int cluster, int blocks, int smem, int* count) {
  if (is_bf16)
    return (int)(cluster ? occupancy<__nv_bfloat16, true>(blocks, smem, count)
                         : occupancy<__nv_bfloat16, false>(blocks, smem, count));
  return (int)(cluster ? occupancy<float, true>(blocks, smem, count)
                       : occupancy<float, false>(blocks, smem, count));
}

// QAT_FROZEN: y in x's dtype, mask one byte (0/1) per element.
int frost_fq_quantize(const void* x, void* y, uint8_t* mask, int is_bf16, long long n,
                      int aligned, const float* state_min, const float* state_max, float qmin,
                      float qmax, float factor, float eps, float sym_zp, int symmetric,
                      int max_blocks, cudaStream_t stream) {
  const Grid g{qmin, qmax, factor, eps, sym_zp, symmetric};
  if (is_bf16) {
    const int blocks = blocks_for(n, 8, max_blocks);
    fq_quantize_kernel<__nv_bfloat16><<<blocks, kQuantThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(y), mask, n,
        aligned, state_min, state_max, g);
  } else {
    const int blocks = blocks_for(n, 4, max_blocks);
    fq_quantize_kernel<float><<<blocks, kQuantThreads, 0, stream>>>(
        static_cast<const float*>(x), static_cast<float*>(y), mask, n, aligned, state_min,
        state_max, g);
  }
  return (int)cudaGetLastError();
}

// The data-parallel route, launch 1: stats[0..3] = (-min, max) of this
// rank's x, then the old state. partials: 2 * max_blocks floats; count: one
// uint32, zeroed once by the host.
int frost_fq_min_max(const void* x, int is_bf16, long long n, int aligned,
                     const float* state_min, const float* state_max, float* stats,
                     float* partials, unsigned int* count, int max_blocks, cudaStream_t stream) {
  if (n < 1 || max_blocks < 1) return (int)cudaErrorInvalidValue;
  if (is_bf16) {
    const int blocks = blocks_for(n, 8, max_blocks);
    fq_min_max_kernel<__nv_bfloat16><<<blocks, kQuantThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(x), n, aligned, state_min, state_max, stats, partials,
        count);
  } else {
    const int blocks = blocks_for(n, 4, max_blocks);
    fq_min_max_kernel<float><<<blocks, kQuantThreads, 0, stream>>>(
        static_cast<const float*>(x), n, aligned, state_min, state_max, stats, partials, count);
  }
  return (int)cudaGetLastError();
}

// The data-parallel route, launch 2: the observer step on the reduced stats,
// the new state and qparams written, y and the mask.
int frost_fq_observe_reduced(const void* x, void* y, uint8_t* mask, int is_bf16, long long n,
                             int aligned, const float* stats, float* state_min,
                             float* state_max, float* qparams, float c, int has_c, float qmin,
                             float qmax, float factor, float eps, float sym_zp, int symmetric,
                             int max_blocks, cudaStream_t stream) {
  const Grid g{qmin, qmax, factor, eps, sym_zp, symmetric};
  if (is_bf16) {
    const int blocks = blocks_for(n, 8, max_blocks);
    fq_observe_reduced_kernel<__nv_bfloat16><<<blocks, kQuantThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(y), mask, n, aligned,
        stats, state_min, state_max, qparams, has_c, c, g);
  } else {
    const int blocks = blocks_for(n, 4, max_blocks);
    fq_observe_reduced_kernel<float><<<blocks, kQuantThreads, 0, stream>>>(
        static_cast<const float*>(x), static_cast<float*>(y), mask, n, aligned, stats,
        state_min, state_max, qparams, has_c, c, g);
  }
  return (int)cudaGetLastError();
}

const char* frost_fq_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
