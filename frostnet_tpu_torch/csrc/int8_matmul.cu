// INT8 matmul with the requant epilogue of the frozen INT8 graph, on
// Hopper's int8 tensor cores.
//
// Replaces frostnet_tpu/ops/pallas_int8_matmul.py::int8_matmul_requant (the
// Pallas TPU kernel). It carries the port's INT8 1x1 convolutions and the
// im2col convs (the FrostNet stem, the GAN's stem and strided downs):
//   acc[m,n] = sum_k x[m,k] * w[k,n] + zterm[n]          (exact int32)
//   y        = fma(float(acc), scale[n], bias[n]), optional ReLU
//   out      = clamp(rint(y * out_mult) + out_zp, qmin, qmax) -> uint8
// x holds uint8 activation codes (or int8 values), w int8 weights stored
// transposed as wt[n, k] with each row zero-padded to ldw (a multiple of 64);
// x's rows may be longer than the weight's K (up to ldw), meeting zeros.
//
// What bounds it on an H100: at most shapes bytes (K is 16..1728, at most
// ~2 K operations per output byte, below the card's int8 ridge of ~590),
// except the GAN's strided downs (K = 576 and 1152 with N = 128 and 256),
// which sit near the ridge. Once the products run on the tensor cores, what
// is left is moving x in and the uint8 codes out. The design is the main
// loop of int8_mma.cuh with one tap: a block computes 64 x WGS rows x BN
// columns with WGS consumer warpgroups (64 rows each, wgmma m64nBNk32),
// streaming 128-byte K chunks of x and of the weight (whole cache lines of
// each row) by TMA, with 128-byte swizzle, through a 6-stage ring four
// chunks ahead of the tensor cores: x streams from device memory, and TMA
// keeps more of it in flight than 16-byte cp.async from every thread. The
// epilogue requantizes in registers (constants staged in shared memory)
// and writes the uint8 tile with 16-byte coalesced stores. The im2col
// route pads its rows to 16 bytes (the stems' K = 27 and 147 become 32 and
// 160) so they take the TMA path; rows that are not 16-byte aligned are
// still taken, read with aligned 32-bit loads and a funnel shift into the
// same swizzled layout. The tile is picked from the shape: BN = 256 where
// N >= 256 (x is then read once; 4 stages), 64 where N <= 64, else 128; and
// one warpgroup per block (64 x 64 tiles) where 128-row tiles would leave
// SMs idle (FrostNet's last_layer, the classifier).
#include "int8_mma.cuh"

namespace {

using namespace frost_mma;

constexpr int kBK = 128;    // bytes of K per chunk: four wgmma K steps, one swizzled row
// 6 stages; 4 for the 256-wide tile, whose stages are 48 KB
__host__ __device__ constexpr int stages(int bn) { return bn == 256 ? 4 : 6; }

__host__ __device__ constexpr int stage_bytes(int wgs, int bn) { return (64 * wgs + bn) * kBK; }
__host__ __device__ constexpr int smem_bytes(int wgs, int bn) {
  return 1024 + stages(bn) * (stage_bytes(wgs, bn) + 8) + 12 * bn;
}

// four bytes of a row starting at column k (k < K), from aligned loads;
// bytes past the row's end are whatever follows (their weights are 0)
__device__ __forceinline__ uint32_t load_word(const uint8_t* row, int k, int K) {
  const uint8_t* p = row + k;
  const int sh = (int)((size_t)p & 3);
  const uint32_t* pa = reinterpret_cast<const uint32_t*>(p - sh);
  const uint32_t lo = __ldg(pa);
  const uint32_t hi = (sh != 0 && sh + min(4, K - k) > 4) ? __ldg(pa + 1) : 0u;
  return __funnelshift_r(lo, hi, 8 * sh);
}

template <bool kUnsigned, int kWGS, int BN>
__global__ void __launch_bounds__(kWGS * 128, 1)
int8_matmul_requant_kernel(const __grid_constant__ CUtensorMap amap,
                           const __grid_constant__ CUtensorMap bmap,
                           const uint8_t* __restrict__ x, const int32_t* __restrict__ zterm,
                           const float* __restrict__ scale, const float* __restrict__ bias,
                           uint8_t* __restrict__ out, int M, int N, int K, int a_tma,
                           int out_vec16, int relu, float out_mult, float out_zp, float qmin,
                           float qmax) {
  extern __shared__ __align__(128) uint8_t smem_raw[];
  constexpr int kStages = stages(BN);
  constexpr int kBM = 64 * kWGS, kThreads = 128 * kWGS;
  constexpr int kA = kBM * kBK, kStage = stage_bytes(kWGS, BN);
  constexpr int kWords = kBM * (kBK / 4) / kThreads;  // unaligned rows: words per thread
  const int tid = threadIdx.x, wg = tid / 128;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * BN;
  const uint32_t raw = smem_u32(smem_raw), base = (raw + 1023) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  const int n_valid = min(BN, N - n0);
  int32_t* pz = reinterpret_cast<int32_t*>(smem + kStages * kStage);
  float* ps = reinterpret_cast<float*>(pz + BN);
  float* pb = ps + BN;
  const uint32_t bars = smem_u32(pb + BN);
  stage_params<BN>(pz, ps, pb, zterm, scale, bias, n0, n_valid);
  init_bars<kStages>(bars);

  // A (kBM rows) and B (BN rows) of 128 bytes of K each, 128-byte swizzle.
  // TMA fills zeros past M, N, K and the weight's padded row; rows that are
  // not 16-byte aligned are read by every thread, zero past K.
  auto load = [&](int stage, int chunk) {
    const int k0 = chunk * kBK;
    const uint32_t as = base + stage * kStage, bs = as + kA;
    if (tid == 0) {
      mbar_expect_tx(bars + 8 * stage, (a_tma ? kA : 0) + BN * kBK);
      if (a_tma) tma_load_2d(as, &amap, k0, m0, bars + 8 * stage);
      tma_load_2d(bs, &bmap, k0, n0, bars + 8 * stage);
    }
    if (!a_tma) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        uint32_t v[kWords / 2];
#pragma unroll
        for (int t = 0; t < kWords / 2; ++t) {
          const int i = tid + (half * kWords / 2 + t) * kThreads, row = i / (kBK / 4);
          const int k = k0 + 4 * (i % (kBK / 4)), m = m0 + row;
          v[t] = (m < M && k < K) ? load_word(x + (size_t)m * K, k, K) : 0u;
        }
#pragma unroll
        for (int t = 0; t < kWords / 2; ++t) {
          const int i = tid + (half * kWords / 2 + t) * kThreads, row = i / (kBK / 4);
          const int kk = 4 * (i % (kBK / 4));
          st_shared_u32(as + row * kBK + ((((kk >> 4) ^ (row & 7))) << 4) + (kk & 15), v[t]);
        }
      }
    }
  };

  auto mma = [&](int stage, int (&d)[BN / 2]) {
    const uint32_t as = base + stage * kStage, bs = as + kA;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kBK / 32; ++ks)
      Wgmma<BN, kUnsigned>::run(d, desc_sw128(as + 64 * wg * kBK + 32 * ks),
                                desc_sw128(bs + 32 * ks));
    wgmma_commit();
  };

  int acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
  run_pipeline<kStages, true>((K + kBK - 1) / kBK, acc, bars, load, mma);

  constexpr int kOs = BN + 16;
  requant_fragment<BN>(acc, smem, 64 * wg, pz, ps, pb, relu != 0, out_mult, out_zp, qmin,
                       qmax);
  __syncthreads();
  if (out_vec16) {
    for (int i = tid; i < kBM * (BN / 16); i += kThreads) {
      const int r = i / (BN / 16), q = i % (BN / 16);
      if (m0 + r < M && 16 * q < n_valid)
        *reinterpret_cast<uint4*>(out + (size_t)(m0 + r) * N + n0 + 16 * q) =
            *reinterpret_cast<const uint4*>(smem + r * kOs + 16 * q);
    }
  } else {
    for (int i = tid; i < kBM * BN; i += kThreads) {
      const int r = i / BN, n = i % BN;
      if (m0 + r < M && n < n_valid) out[(size_t)(m0 + r) * N + n0 + n] = smem[r * kOs + n];
    }
  }
}

template <bool kUnsigned, int kWGS, int BN>
cudaError_t launch(cudaStream_t st, const uint8_t* x, const int8_t* wt, const int32_t* zt,
                   const float* sp, const float* bp, uint8_t* op, int M, int N, int K,
                   int ldw, int a_tma, int out_vec16, int relu, float out_mult, float out_zp,
                   float qmin, float qmax) {
  constexpr int kSmem = smem_bytes(kWGS, BN);
  static const cudaError_t attr =
      allow_smem(int8_matmul_requant_kernel<kUnsigned, kWGS, BN>, kSmem);
  if (attr != cudaSuccess) return attr;
  CUtensorMap amap, bmap;
  if (!encode_u8_map(&bmap, wt, N, ldw, BN, kBK)) return cudaErrorInvalidValue;
  amap = bmap;  // not read when x is loaded by the threads
  if (a_tma && !encode_u8_map(&amap, x, M, K, 64 * kWGS, kBK)) return cudaErrorInvalidValue;
  const dim3 grid((M + 64 * kWGS - 1) / (64 * kWGS), (N + BN - 1) / BN);
  int8_matmul_requant_kernel<kUnsigned, kWGS, BN><<<grid, 128 * kWGS, kSmem, st>>>(
      amap, bmap, x, zt, sp, bp, op, M, N, K, a_tma, out_vec16, relu, out_mult, out_zp, qmin,
      qmax);
  return cudaGetLastError();
}

template <bool kUnsigned>
cudaError_t dispatch(cudaStream_t st, const uint8_t* x, const int8_t* wt, const int32_t* zt,
                     const float* sp, const float* bp, uint8_t* op, int M, int N, int K,
                     int ldw, int a_tma, int out_vec16, int relu, float out_mult,
                     float out_zp, float qmin, float qmax) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  const long tiles128 = (long)((M + 127) / 128) * ((N + 127) / 128);
  if (N >= 256 && (long)((M + 127) / 128) * ((N + 255) / 256) >= sms)
    return launch<kUnsigned, 2, 256>(st, x, wt, zt, sp, bp, op, M, N, K, ldw, a_tma,
                                      out_vec16, relu, out_mult, out_zp, qmin, qmax);
  if (N <= 64 && (M + 127) / 128 >= sms)
    return launch<kUnsigned, 2, 64>(st, x, wt, zt, sp, bp, op, M, N, K, ldw, a_tma,
                                     out_vec16, relu, out_mult, out_zp, qmin, qmax);
  if (N > 64 && tiles128 >= sms)
    return launch<kUnsigned, 2, 128>(st, x, wt, zt, sp, bp, op, M, N, K, ldw, a_tma,
                                      out_vec16, relu, out_mult, out_zp, qmin, qmax);
  return launch<kUnsigned, 1, 64>(st, x, wt, zt, sp, bp, op, M, N, K, ldw, a_tma, out_vec16,
                                   relu, out_mult, out_zp, qmin, qmax);
}

}  // namespace

extern "C" int frost_int8_matmul_requant(
    const void* x, const void* wt, const void* zterm, const void* scale,
    const void* bias, void* out, int M, int N, int K, int ldw, int x_unsigned,
    int relu, float out_mult, float out_zp, float qmin, float qmax,
    void* stream) {
  if (M <= 0 || N <= 0) return (int)cudaSuccess;
  if (K <= 0 || ldw % 64 != 0 || ldw < K || (size_t)wt % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int a_tma = K % 16 == 0 && (size_t)x % 16 == 0;
  const int out_vec16 = N % 16 == 0 && (size_t)out % 16 == 0;
  auto* xp = static_cast<const uint8_t*>(x);
  auto* wp = static_cast<const int8_t*>(wt);
  auto* zp = static_cast<const int32_t*>(zterm);
  auto* sp = static_cast<const float*>(scale);
  auto* bp = static_cast<const float*>(bias);
  auto* op = static_cast<uint8_t*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      x_unsigned ? dispatch<true>(st, xp, wp, zp, sp, bp, op, M, N, K, ldw, a_tma,
                                  out_vec16, relu, out_mult, out_zp, qmin, qmax)
                 : dispatch<false>(st, xp, wp, zp, sp, bp, op, M, N, K, ldw, a_tma,
                                   out_vec16, relu, out_mult, out_zp, qmin, qmax);
  return (int)err;
}

extern "C" const char* frost_int8_matmul_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
