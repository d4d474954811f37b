// One whole INT8 Frost (CascadePreEx) block in one kernel.
//
// Replaces frostnet_tpu/ops/pallas_frost_block.py::frost_block_int8 (the
// Pallas TPU kernel, body _make_kernel). The block is
//   squeeze 1x1 + ReLU -> QCat (both halves requantized to the cat grid)
//   -> expand 1x1 + ReLU -> depthwise kxk (k 3|5, stride 1|2) + ReLU
//   -> linear reduce 1x1 -> residual QAdd
// on uint8 NHWC codes, with the numerics of the frozen unfused graph
// (requant.cuh; plain version frostnet_tpu_torch/ops/frost_block.py).
//
// What bounds it on an H100: the expanded tensor. It is the block's largest
// activation (up to 6x the input width) and, run op by op, it is written and
// read back through device memory twice (expand out, depthwise in/out). This
// kernel never writes it: one CUDA block owns one output tile of one image,
// brings the input halo of that tile into shared memory once, computes the
// squeeze and the QCat requant over the halo, and then walks the expanded
// width in chunks. Per chunk it expands the halo into shared memory, runs the
// depthwise conv for the tile, and adds the chunk's share of the reduce 1x1
// to an int32 accumulator held in shared memory. After the last chunk it
// applies the reduce epilogue and the residual add and stores the uint8
// tile once. Device memory sees the input (with a halo re-read) and the
// output only. Halo positions outside the image hold the depthwise input's
// zero point (qnnpack pad semantics), not an expanded padding value.
//
// The small GEMMs use dp4a on CUDA cores; all operands of the dot products
// are uint8 codes x int8 weights. Weights stay in device memory (L1/L2 hit;
// a warp reads one weight word at a time, broadcast to its lanes).
#include "requant.cuh"

// Kernel arguments; mirrored field by field by FrostBlockArgs in
// frostnet_tpu_torch/ops/frost_block.py (its size is checked at load).
struct FrostBlockArgs {
  const uint8_t* x;
  uint8_t* out;
  int B, H, W, Cin, Cout, Ho, Wo, E, Ccat, Csq;
  int has_squeeze, has_expand, residual;
  int tile_h, tile_w, halo_h, halo_w, e_chunk, tiles_w;
  int ld_x, ld_cat, ld_e, ld_d;  // shared-memory row strides in bytes
  int off_cat, off_e, off_d, off_acc;  // shared-memory section offsets in bytes
  float qmax;
  // input grid
  float x_zp, x_scale;
  // squeeze 1x1 (weights transposed: [Csq][sq_ldw])
  const int8_t* sq_w;
  const int32_t* sq_zt;
  const float* sq_scale;
  const float* sq_bias;
  int sq_ldw;
  float sq_mult, sq_zp;
  // QCat: squeeze half and input half onto the cat grid
  float cat_sq_s, cat_sq_mult, cat_x_s, cat_x_mult, cat_zp;
  // expand 1x1 (weights transposed: [E][ex_ldw])
  const int8_t* ex_w;
  const int32_t* ex_zt;
  const float* ex_scale;
  const float* ex_bias;
  int ex_ldw;
  float ex_mult, ex_zp;
  // depthwise (taps: [k*k][E])
  const int8_t* dw_w;
  const float* dw_scale;
  const float* dw_bias;
  int dw_in_zp;
  float dw_mult, dw_zp;
  // reduce 1x1 (weights transposed: [Cout][rd_ldw])
  const int8_t* rd_w;
  const int32_t* rd_zt;
  const float* rd_scale;
  const float* rd_bias;
  int rd_ldw;
  float rd_mult, rd_zp, rd_s;
  // residual QAdd
  float add_mult, add_zp;
};

namespace {

constexpr int kThreads = 256;


// Block-wide small GEMM. Rows of A are uint8 codes in shared memory (row
// stride lda bytes, an odd number of words, so lanes reading 32 rows hit 32
// banks); rows of W are int8 in device memory (stride ldw bytes). Each warp
// takes 64 rows x 8 columns at a time; ncols is a multiple of 8.
template <class Epi>
__device__ __forceinline__ void block_gemm(const uint8_t* A, int lda, int rows,
                                           const int8_t* W, int ldw, int ncols,
                                           int kwords, Epi epi) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int row_groups = (rows + 63) / 64, col_groups = ncols / 8;
  const int wstride = ldw / 4;
  for (int task = warp; task < row_groups * col_groups; task += nwarps) {
    const int r0 = (task % row_groups) * 64 + lane, r1 = r0 + 32;
    const int n0 = (task / row_groups) * 8;
    const uint32_t* a0 = reinterpret_cast<const uint32_t*>(A + (size_t)min(r0, rows - 1) * lda);
    const uint32_t* a1 = reinterpret_cast<const uint32_t*>(A + (size_t)min(r1, rows - 1) * lda);
    const uint32_t* w = reinterpret_cast<const uint32_t*>(W + (size_t)n0 * ldw);
    int acc0[8], acc1[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) acc0[j] = acc1[j] = 0;
    for (int kw = 0; kw < kwords; ++kw) {
      const uint32_t x0 = a0[kw], x1 = a1[kw];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const uint32_t wv = __ldg(w + j * wstride + kw);
        acc0[j] = dp4a_us(x0, wv, acc0[j]);
        acc1[j] = dp4a_us(x1, wv, acc1[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (r0 < rows) epi(r0, n0 + j, acc0[j]);
      if (r1 < rows) epi(r1, n0 + j, acc1[j]);
    }
  }
}

template <int K, int S>
__device__ __forceinline__ void depthwise_chunk(const FrostBlockArgs& a,
                                                const uint8_t* src, int lds,
                                                int c0, int ec, uint8_t* dst) {
  const int tp = a.tile_h * a.tile_w;
  for (int i = threadIdx.x; i < tp * ec; i += blockDim.x) {
    const int n = i % ec, t = i / ec;
    const int ty = t / a.tile_w, tx = t % a.tile_w;
    const uint8_t* base = src + (size_t)((ty * S) * a.halo_w + tx * S) * lds + n;
    const int8_t* w = a.dw_w + c0 + n;
    int acc = 0;
#pragma unroll
    for (int dy = 0; dy < K; ++dy)
#pragma unroll
      for (int dx = 0; dx < K; ++dx)
        acc += ((int)base[(size_t)(dy * a.halo_w + dx) * lds] - a.dw_in_zp) *
               (int)__ldg(w + (dy * K + dx) * a.E);
    dst[(size_t)t * a.ld_d + n] =
        requant_acc(acc, a.dw_scale[c0 + n], a.dw_bias[c0 + n], true, a.dw_mult,
                    a.dw_zp, 0.0f, a.qmax);
  }
}

template <int K, int S>
__global__ void __launch_bounds__(kThreads) frost_block_kernel(const FrostBlockArgs a) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* xs = smem;
  uint8_t* cat = smem + a.off_cat;
  uint8_t* es = smem + a.off_e;
  uint8_t* ds = smem + a.off_d;
  int* accr = reinterpret_cast<int*>(smem + a.off_acc);

  const int b = blockIdx.y;
  const int oy0 = (blockIdx.x / a.tiles_w) * a.tile_h;
  const int ox0 = (blockIdx.x % a.tiles_w) * a.tile_w;
  const int pad = (K - 1) / 2;
  const int iy0 = oy0 * S - pad, ix0 = ox0 * S - pad;
  const int hp = a.halo_h * a.halo_w, tp = a.tile_h * a.tile_w;
  const uint8_t xz = (uint8_t)a.x_zp;

  // 1. input halo -> xs (outside the image: the input zero point)
  {
    const int cw = a.Cin / 4;
    for (int i = threadIdx.x; i < hp * cw; i += blockDim.x) {
      const int p = i / cw, c = i % cw;
      const int iy = iy0 + p / a.halo_w, ix = ix0 + p % a.halo_w;
      uint32_t v = xz * 0x01010101u;
      if (iy >= 0 && iy < a.H && ix >= 0 && ix < a.W)
        v = reinterpret_cast<const uint32_t*>(
            a.x + (((size_t)b * a.H + iy) * a.W + ix) * a.Cin)[c];
      reinterpret_cast<uint32_t*>(xs + (size_t)p * a.ld_x)[c] = v;
    }
  }
  __syncthreads();

  auto in_image = [&](int p) {
    const int iy = iy0 + p / a.halo_w, ix = ix0 + p % a.halo_w;
    return iy >= 0 && iy < a.H && ix >= 0 && ix < a.W;
  };

  // 2. squeeze 1x1 + ReLU, and both QCat halves -> cat
  if (a.has_squeeze) {
    block_gemm(xs, a.ld_x, hp, a.sq_w, a.sq_ldw, a.Csq, a.Cin / 4,
               [&](int p, int n, int acc) {
                 const uint8_t qs = requant_acc(acc + a.sq_zt[n], a.sq_scale[n],
                                                a.sq_bias[n], true, a.sq_mult,
                                                a.sq_zp, 0.0f, a.qmax);
                 cat[(size_t)p * a.ld_cat + n] =
                     requant_code(qs, a.sq_zp, a.cat_sq_s, a.cat_sq_mult,
                                  a.cat_zp, a.qmax);
               });
    for (int i = threadIdx.x; i < hp * a.Cin; i += blockDim.x) {
      const int p = i / a.Cin, c = i % a.Cin;
      cat[(size_t)p * a.ld_cat + a.Csq + c] =
          requant_code(xs[(size_t)p * a.ld_x + c], a.x_zp, a.cat_x_s,
                       a.cat_x_mult, a.cat_zp, a.qmax);
    }
    __syncthreads();
  }

  // 3. walk the expanded width in chunks
  for (int c0 = 0; c0 < a.E; c0 += a.e_chunk) {
    const int ec = min(a.e_chunk, a.E - c0);
    const uint8_t* dw_src;
    int dw_lds;
    if (a.has_expand) {
      const uint8_t* ein = a.has_squeeze ? cat : xs;
      const int ld_in = a.has_squeeze ? a.ld_cat : a.ld_x;
      const uint8_t ez = (uint8_t)a.dw_in_zp;
      block_gemm(ein, ld_in, hp, a.ex_w + (size_t)c0 * a.ex_ldw, a.ex_ldw, ec,
                 a.Ccat / 4, [&](int p, int n, int acc) {
                   es[(size_t)p * a.ld_e + n] =
                       in_image(p)
                           ? requant_acc(acc + a.ex_zt[c0 + n], a.ex_scale[c0 + n],
                                         a.ex_bias[c0 + n], true, a.ex_mult,
                                         a.ex_zp, 0.0f, a.qmax)
                           : ez;
                 });
      dw_src = es;
      dw_lds = a.ld_e;
      __syncthreads();
    } else {
      dw_src = xs + c0;
      dw_lds = a.ld_x;
    }
    depthwise_chunk<K, S>(a, dw_src, dw_lds, c0, ec, ds);
    __syncthreads();
    block_gemm(ds, a.ld_d, tp, a.rd_w + c0, a.rd_ldw, a.Cout, ec / 4,
               [&](int t, int n, int acc) {
                 int* r = accr + (size_t)t * a.Cout + n;
                 *r = (c0 == 0 ? 0 : *r) + acc;
               });
    __syncthreads();
  }

  // 4. reduce epilogue, residual add, one uint8 store per output
  for (int i = threadIdx.x; i < tp * a.Cout; i += blockDim.x) {
    const int t = i / a.Cout, n = i % a.Cout;
    const int ty = t / a.tile_w, tx = t % a.tile_w;
    const int oy = oy0 + ty, ox = ox0 + tx;
    if (oy >= a.Ho || ox >= a.Wo) continue;
    uint8_t q = requant_acc(accr[i] + a.rd_zt[n], a.rd_scale[n], a.rd_bias[n],
                            false, a.rd_mult, a.rd_zp, 0.0f, a.qmax);
    if (a.residual) {
      const int p = (ty + pad) * a.halo_w + tx + pad;  // stride 1
      q = qadd_code(xs[(size_t)p * a.ld_x + n], a.x_zp, a.x_scale, q, a.rd_zp,
                    a.rd_s, a.add_mult, a.add_zp, a.qmax);
    }
    a.out[(((size_t)b * a.Ho + oy) * a.Wo + ox) * a.Cout + n] = q;
  }
}

template <int K, int S>
cudaError_t launch(const FrostBlockArgs& a, int smem, cudaStream_t stream) {
  auto kernel = frost_block_kernel<K, S>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int tiles = ((a.Ho + a.tile_h - 1) / a.tile_h) * a.tiles_w;
  kernel<<<dim3(tiles, a.B), kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" int frost_block_args_size() { return (int)sizeof(FrostBlockArgs); }

extern "C" int frost_block_int8(const FrostBlockArgs* args, int kernel, int stride,
                                int smem, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  if (kernel == 3 && stride == 1) return (int)launch<3, 1>(*args, smem, st);
  if (kernel == 3 && stride == 2) return (int)launch<3, 2>(*args, smem, st);
  if (kernel == 5 && stride == 1) return (int)launch<5, 1>(*args, smem, st);
  if (kernel == 5 && stride == 2) return (int)launch<5, 2>(*args, smem, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* frost_block_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
