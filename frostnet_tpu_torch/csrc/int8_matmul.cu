// INT8 matmul with the requant epilogue of the frozen INT8 graph.
//
// Replaces frostnet_tpu/ops/pallas_int8_matmul.py::int8_matmul_requant (the
// Pallas TPU kernel). It carries the port's INT8 1x1 convolutions and the
// im2col stem:
//   acc[m,n] = sum_k x[m,k] * w[k,n] + zterm[n]          (exact int32)
//   y        = fma(float(acc), scale[n], bias[n]), optional ReLU
//   out      = clamp(rint(y * out_mult) + out_zp, qmin, qmax) -> uint8
// x holds uint8 activation codes (or int8 values), w int8 weights stored
// transposed as wt[n, k] with each row zero-padded to ldw bytes.
//
// What bounds it on an H100: bytes. At the model's shapes K is 16..1728 and
// the product does at most ~2*K operations per output byte, far below the
// card's int8 ridge; the uint8 output and the activation read dominate. The
// design keeps it simple: 64x64 output tiles, 64-byte K steps staged in
// shared memory (odd word stride, so the dp4a operand reads are free of bank
// conflicts), dp4a on CUDA cores, the whole epilogue in registers, and one
// uint8 store per output. Tensor cores (mma.sync / wgmma) are later work.
#include "requant.cuh"

namespace {

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 64;             // bytes of K per stage
constexpr int kKW = kBK / 4;        // 32-bit words of K per stage
constexpr int kLds = kKW + 1;       // odd word stride
constexpr int kThreads = 256;

// four bytes of row `row` starting at column k, zero past the row end
__device__ __forceinline__ uint32_t load_a4(const uint8_t* row, int k, int K,
                                            bool aligned) {
  if (aligned && k + 3 < K) return *reinterpret_cast<const uint32_t*>(row + k);
  uint32_t v = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (k + i < K) v |= (uint32_t)row[k + i] << (8 * i);
  return v;
}

template <bool kUnsigned, bool kRelu>
__global__ void __launch_bounds__(kThreads)
int8_matmul_requant_kernel(const uint8_t* __restrict__ x,
                           const int8_t* __restrict__ wt,
                           const int32_t* __restrict__ zterm,
                           const float* __restrict__ scale,
                           const float* __restrict__ bias,
                           uint8_t* __restrict__ out, int M, int N, int K,
                           int ldw, int aligned, float out_mult, float out_zp,
                           float qmin, float qmax) {
  __shared__ uint32_t As[kBM][kLds];
  __shared__ uint32_t Bs[kBN][kLds];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  int acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    for (int i = tid; i < kBM * kKW; i += kThreads) {
      const int r = i / kKW, c = i % kKW;
      const int m = m0 + r;
      As[r][c] = m < M ? load_a4(x + (size_t)m * K, k0 + 4 * c, K, aligned != 0) : 0u;
    }
    for (int i = tid; i < kBN * kKW; i += kThreads) {
      const int r = i / kKW, c = i % kKW;
      const int n = n0 + r, k = k0 + 4 * c;
      Bs[r][c] = (n < N && k < ldw)
                     ? *reinterpret_cast<const uint32_t*>(wt + (size_t)n * ldw + k)
                     : 0u;
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < kKW; ++c) {
      uint32_t a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[ty + 16 * i][c];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[tx + 16 * j][c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[i][j] = kUnsigned ? dp4a_us(a[i], b[j], acc[i][j])
                                : dp4a_ss(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n >= N) continue;
      out[(size_t)m * N + n] = requant_acc(acc[i][j] + zterm[n], scale[n], bias[n],
                                           kRelu, out_mult, out_zp, qmin, qmax);
    }
  }
}

template <bool kUnsigned, bool kRelu>
void launch(dim3 grid, cudaStream_t stream, const uint8_t* x, const int8_t* wt,
            const int32_t* zterm, const float* scale, const float* bias,
            uint8_t* out, int M, int N, int K, int ldw, int aligned,
            float out_mult, float out_zp, float qmin, float qmax) {
  int8_matmul_requant_kernel<kUnsigned, kRelu><<<grid, kThreads, 0, stream>>>(
      x, wt, zterm, scale, bias, out, M, N, K, ldw, aligned, out_mult, out_zp,
      qmin, qmax);
}

}  // namespace

extern "C" int frost_int8_matmul_requant(
    const void* x, const void* wt, const void* zterm, const void* scale,
    const void* bias, void* out, int M, int N, int K, int ldw, int x_unsigned,
    int relu, float out_mult, float out_zp, float qmin, float qmax,
    void* stream) {
  if (M <= 0 || N <= 0) return (int)cudaSuccess;
  const dim3 grid((M + kBM - 1) / kBM, (N + kBN - 1) / kBN);
  const int aligned = (K % 4 == 0) && ((size_t)x % 4 == 0);
  auto* xp = static_cast<const uint8_t*>(x);
  auto* wp = static_cast<const int8_t*>(wt);
  auto* zp = static_cast<const int32_t*>(zterm);
  auto* sp = static_cast<const float*>(scale);
  auto* bp = static_cast<const float*>(bias);
  auto* op = static_cast<uint8_t*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  if (x_unsigned) {
    if (relu) launch<true, true>(grid, st, xp, wp, zp, sp, bp, op, M, N, K, ldw, aligned, out_mult, out_zp, qmin, qmax);
    else launch<true, false>(grid, st, xp, wp, zp, sp, bp, op, M, N, K, ldw, aligned, out_mult, out_zp, qmin, qmax);
  } else {
    if (relu) launch<false, true>(grid, st, xp, wp, zp, sp, bp, op, M, N, K, ldw, aligned, out_mult, out_zp, qmin, qmax);
    else launch<false, false>(grid, st, xp, wp, zp, sp, bp, op, M, N, K, ldw, aligned, out_mult, out_zp, qmin, qmax);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* frost_int8_matmul_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
