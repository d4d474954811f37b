// Hopper int8 tensor-core main loop shared by the port's INT8 GEMM kernels
// (csrc/int8_conv.cu and csrc/int8_matmul.cu), and the shared-memory, mbarrier
// and bulk-copy helpers that csrc/frost_block.cu and csrc/fake_quant.cu use too.
//
// Both compute an exact int32 u8 x s8 (or s8 x s8) product followed by the
// requant epilogue of requant.cuh. Each consumer warpgroup (128 threads)
// owns one 64-row accumulator tile, 64 x BN int32 in registers, and issues
// wgmma.mma_async m64nBNk32 on operands in shared memory.
//
// Shared-memory operand layouts (both operands K-major, as wgmma requires
// for 8-bit types):
//   * no swizzle (desc_interleave): a row contributes one 16-byte K slice
//     per core matrix, and eight rows with consecutive 16-byte slots form a
//     core matrix of 128 contiguous bytes. A tile is stored as [16-byte K
//     slice][row][16 bytes]: SBO (8-row group to the next) is 128 bytes,
//     LBO (one 16-byte K half of a 32-byte K step to the other) the slice
//     stride. Any 64 consecutive rows, starting at any row, are one
//     descriptor: the conv reads its 9 taps as shifted windows of one halo.
//   * 128-byte swizzle (desc_sw128): rows of 128 bytes of K, the 16-byte
//     chunks of row r at chunk ^ (r % 8), 8-row atoms of 1024 bytes (SBO);
//     what TMA writes with CU_TENSOR_MAP_SWIZZLE_128B. A 32-byte K step is
//     the descriptor advanced by 32 bytes. The matmul uses it.
//
// The main loop (run_pipeline) is a ring of S stages, S - 2 chunks ahead of
// the one the tensor cores work on, while one group of wgmma stays in
// flight. The matmul fills a chunk by TMA (one thread, completion on the
// stage's mbarrier); the conv (its halo holds the zero point outside the
// image) and rows that are not 16-byte aligned use cp.async and st.shared
// from every thread, each writer fencing the generic proxy against the
// async proxy (fence.proxy.async) before the barrier that hands the chunk
// to wgmma. The epilogue's per-column constants are staged in shared
// memory once.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "requant.cuh"

namespace frost_mma {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma shared-memory matrix descriptors
__device__ __forceinline__ uint64_t desc_interleave(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFFu) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFFu) << 32);
}

__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return desc_interleave(addr, 16, 1024) | (1ull << 62);
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// one bulk copy (the TMA engine) of `bytes` (a multiple of 16, both ends
// 16-byte aligned) into this CUDA block's shared memory, completing on `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// a TMA tile load into shared memory, completing on mbarrier `bar`
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void st_shared_u32(uint32_t dst, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(dst), "r"(v) : "memory");
}

__device__ __forceinline__ void st_shared_v4(uint32_t dst, uint32_t v) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst), "r"(v), "r"(v), "r"(v),
               "r"(v)
               : "memory");
}

// make this thread's generic-proxy writes to shared memory (st.shared and
// non-bulk cp.async) visible to the async proxy that wgmma reads through
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmma that owns them
template <int R>
__device__ __forceinline__ void fence_regs(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

#define FROST_WGMMA_N64(ATYPE)                                                              \
  asm volatile(                                                                             \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                                          \
      "wgmma.mma_async.sync.aligned.m64n64k32.s32." ATYPE ".s8 {"                           \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "              \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"      \
      "}, %32, %33, p;\n}\n"                                                                \
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),             \
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),           \
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),       \
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),       \
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),       \
        "+r"(d[30]), "+r"(d[31])                                                            \
      : "l"(desc_a), "l"(desc_b), "r"(1))

#define FROST_WGMMA_N128(ATYPE)                                                             \
  asm volatile(                                                                             \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                                          \
      "wgmma.mma_async.sync.aligned.m64n128k32.s32." ATYPE ".s8 {"                          \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "              \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "    \
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "    \
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"      \
      "}, %64, %65, p;\n}\n"                                                                \
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),             \
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),           \
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),       \
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),       \
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),       \
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),       \
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),       \
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),       \
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),       \
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),       \
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])                                  \
      : "l"(desc_a), "l"(desc_b), "r"(1))

#define FROST_WGMMA_N256(ATYPE)                                                             \
  asm volatile(                                                                             \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"                                         \
      "wgmma.mma_async.sync.aligned.m64n256k32.s32." ATYPE ".s8 {"                          \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "  \
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "  \
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "  \
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "  \
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "  \
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "  \
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"  \
      "}, %128, %129, p;\n}\n"                                                               \
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), \
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), \
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), \
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), \
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), \
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), \
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), \
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), \
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), \
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), \
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]), \
        "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]), \
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), \
        "+r"(d[78]), "+r"(d[79]), "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), \
        "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]), \
        "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]), \
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), \
        "+r"(d[102]), "+r"(d[103]), "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), \
        "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]), \
        "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]), \
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), \
        "+r"(d[126]), "+r"(d[127]) \
      : "l"(desc_a), "l"(desc_b), "r"(1))

// d += A (64 x 32 bytes, desc_a) * B^T (BN x 32 bytes, desc_b), int32; A is
// uint8 (kUnsigned) or int8, B int8. The accumulator fragment of thread t
// (warp w = (t % 128) / 32, lane l) holds, for v = 4 j + 2 hi + lo,
//   row 16 w + l / 4 + 8 hi, column 8 j + 2 (l % 4) + lo.
template <int BN, bool kUnsigned>
struct Wgmma;

template <>
struct Wgmma<64, true> {
  static __device__ __forceinline__ void run(int (&d)[32], uint64_t desc_a, uint64_t desc_b) {
    FROST_WGMMA_N64("u8");
  }
};
template <>
struct Wgmma<64, false> {
  static __device__ __forceinline__ void run(int (&d)[32], uint64_t desc_a, uint64_t desc_b) {
    FROST_WGMMA_N64("s8");
  }
};
template <>
struct Wgmma<128, true> {
  static __device__ __forceinline__ void run(int (&d)[64], uint64_t desc_a, uint64_t desc_b) {
    FROST_WGMMA_N128("u8");
  }
};
template <>
struct Wgmma<128, false> {
  static __device__ __forceinline__ void run(int (&d)[64], uint64_t desc_a, uint64_t desc_b) {
    FROST_WGMMA_N128("s8");
  }
};

template <>
struct Wgmma<256, true> {
  static __device__ __forceinline__ void run(int (&d)[128], uint64_t desc_a, uint64_t desc_b) {
    FROST_WGMMA_N256("u8");
  }
};
template <>
struct Wgmma<256, false> {
  static __device__ __forceinline__ void run(int (&d)[128], uint64_t desc_a, uint64_t desc_b) {
    FROST_WGMMA_N256("s8");
  }
};

#undef FROST_WGMMA_N64
#undef FROST_WGMMA_N128
#undef FROST_WGMMA_N256

// The main loop: `chunks` chunks of K through a ring of S stages, with one
// mbarrier each (at `bars`, 8 bytes apart, initialised by init_bars) where
// kTma. load(stage, chunk) issues a chunk: thread 0 arms the stage's
// mbarrier with the bytes it asks of TMA and issues the TMA loads; every
// thread issues its cp.async and st.shared. mma(stage, acc) issues and commits
// this warpgroup's wgmmas on a landed chunk. The loads of chunk c + S - 2
// go out while the wgmmas of chunks c - 1 and c run; they overwrite the
// stage of chunk c - 2, which every warpgroup retired (wgmma_wait<1>)
// before the barrier.
template <int S, bool kTma, int R, class Load, class Mma>
__device__ __forceinline__ void run_pipeline(int chunks, int (&acc)[R], uint32_t bars, Load&& load,
                                             Mma&& mma) {
  constexpr int kAhead = S - 2;
#pragma unroll
  for (int s = 0; s < kAhead; ++s) {
    if (s < chunks) load(s, s);
    cp_async_commit();
  }
  for (int c = 0; c < chunks; ++c) {
    cp_async_wait<kAhead - 1>();
    if (kTma) mbar_wait(bars + 8 * (c % S), (c / S) & 1);
    fence_proxy_async();
    __syncthreads();
    fence_regs(acc);
    mma(c % S, acc);
    const int next = c + kAhead;
    if (next < chunks) load(next % S, next);
    cp_async_commit();
    __syncwarp();
    wgmma_wait<1>();
    fence_regs(acc);
  }
  wgmma_wait<0>();
  fence_regs(acc);
  cp_async_wait<0>();
  __syncthreads();
}

// S mbarriers at `bars`, one arrival (thread 0's) per phase
template <int S>
__device__ __forceinline__ void init_bars(uint32_t bars) {
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < S; ++s) mbar_init(bars + 8 * s);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// The epilogue's constants of the BN columns n0.. (the last valid column
// repeated past n_valid) into shared memory; the pipeline's first barrier
// publishes them.
template <int BN>
__device__ __forceinline__ void stage_params(int32_t* pz, float* ps, float* pb,
                                             const int32_t* __restrict__ zterm,
                                             const float* __restrict__ scale,
                                             const float* __restrict__ bias, int n0,
                                             int n_valid) {
  for (int i = threadIdx.x; i < BN; i += blockDim.x) {
    const int n = n0 + min(i, n_valid - 1);
    pz[i] = __ldg(zterm + n);
    ps[i] = __ldg(scale + n);
    pb[i] = __ldg(bias + n);
  }
}

// Requantize this thread's accumulator fragment (rows row_base.. of the
// tile) into a uint8 tile in shared memory with a row stride of BN + 16
// bytes (16-byte aligned rows, spread over the banks).
template <int BN>
__device__ __forceinline__ void requant_fragment(const int (&acc)[BN / 2], uint8_t* tile,
                                                 int row_base, const int32_t* pz,
                                                 const float* ps, const float* pb, bool relu,
                                                 float out_mult, float out_zp, float qmin,
                                                 float qmax) {
  constexpr int kOs = BN + 16;
  const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32;
  const int r = row_base + 16 * warp + lane / 4;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int n = 8 * j + 2 * (lane % 4);
    const int za = pz[n], zb = pz[n + 1];
    const float sa = ps[n], sb = ps[n + 1], ba = pb[n], bb = pb[n + 1];
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const uint32_t qa = requant_acc(acc[4 * j + 2 * hi] + za, sa, ba, relu, out_mult,
                                      out_zp, qmin, qmax);
      const uint32_t qb = requant_acc(acc[4 * j + 2 * hi + 1] + zb, sb, bb, relu, out_mult,
                                      out_zp, qmin, qmax);
      *reinterpret_cast<uint16_t*>(tile + (r + 8 * hi) * kOs + n) = (uint16_t)(qa | (qb << 8));
    }
  }
}

// dynamic shared memory above 48 KB needs an opt-in per kernel
template <class Kernel>
inline cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// The TMA descriptor of a row-major (rows, cols) uint8 matrix read in
// boxes of box_rows x box_cols with 128-byte swizzle, by libcuda's
// cuTensorMapEncodeTiled looked up at run time (no link against libcuda).
// Out-of-bounds parts of a box are filled with zeros.
inline bool encode_u8_map(CUtensorMap* map, const void* base, uint64_t rows, uint64_t cols,
                          uint32_t box_rows, uint32_t box_cols) {
  using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                              const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                              const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
  static Encode encode = [] {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault,
                                     &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
    return found == cudaDriverEntryPointSuccess ? reinterpret_cast<Encode>(fn) : nullptr;
  }();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {cols, rows}, strides[1] = {cols};
  const cuuint32_t box[2] = {box_cols, box_rows}, unit[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace frost_mma
