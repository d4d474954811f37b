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
// What bounds it on an H100: not bytes and not operations (a whole block is
// 0.1-1.4 us of either at batch 8) but latency and parallelism. The expanded
// tensor, the block's largest activation, never leaves shared memory; late
// blocks have 7x7 maps, so one CUDA block per (image, output tile) would
// leave most of the 132 SMs idle at small batch. So the expanded width E is
// split across a thread-block cluster of C = 1, 2, 4, 8 or 16 CUDA blocks
// (the host plans C, the tile and the chunk from the shape, the batch and
// the SM count; maps of 14x14 and smaller are one tile). Each CUDA block of a
// cluster:
//   1. loads the input halo of the tile (the image's rows only; cp.async)
//      and, in one bulk copy, the squeeze weights and the squeeze's and the
//      reduce's epilogue constants, and computes the squeeze and both QCat
//      halves (through 256-entry lookup tables) over the halo's in-image rows
//      itself (no exchange needed);
//   2. walks its slice of E (16-channel units; rank r owns units
//      [r U / C, (r + 1) U / C), at least 32 channels) in chunks: the
//      chunk's depthwise taps, epilogue constants and expand weights arrive
//      in shared memory as one bulk copy, its reduce weights as a second one
//      into the expand weights' place while the depthwise runs (the host
//      packs them in the shared-memory layout, per launch plan; 16-byte
//      cp.async requests per row kept too little in flight; two stages when
//      a slice has more than one chunk); the expand 1x1 runs over the
//      in-image halo rows only (out-of-image halo positions hold the
//      depthwise input's zero point, qnnpack pad semantics); the depthwise
//      runs on the CUDA cores, 4 channels a thread in int32 multiply-adds;
//      the chunk's reduce 1x1 adds into an int32 partial held in the CUDA
//      block's shared memory, grouped by the rank that finishes each column;
//   3. after cluster.sync(), sends each peer its group of the partial as one
//      bulk copy through distributed shared memory (completing on the peer's
//      mbarrier; LSU loads of 16 peers' partials were several times slower),
//      sums the C partials of its own Cout / C columns, adds the reduce's
//      zero-point term once (it is over the whole E), applies the epilogue
//      and the residual add, and stores the uint8 codes; a last
//      cluster.sync() keeps every partial alive until the copies reading it
//      are done.
// Every phase of a CUDA block is short, so latency, not issue rate, sets
// its time: a grid of at most one CUDA block an SM runs 512 threads a block
// (more warps to hide it), a larger grid 256 (more blocks an SM).
// The three 1x1 GEMMs run on the int8 tensor cores: mma.sync m16n8k32
// (u8 codes x s8 weights, exact int32) with ldmatrix operands from shared
// memory; every row stride is an odd number of 16-byte units, so the eight
// rows of an ldmatrix phase fall in eight different bank groups. All sums
// are exact int32, so the split over E and the order of the K sums do not
// change a bit.
#include <cooperative_groups.h>

#include "int8_mma.cuh"
#include "requant.cuh"

namespace cg = cooperative_groups;

// Kernel arguments; mirrored field by field by FrostBlockArgs in
// frostnet_tpu_torch/ops/frost_block.py (its size is checked at load).
struct FrostBlockArgs {
  const uint8_t* x;
  uint8_t* out;
  // packed by the host in the shared-memory layout:
  //   head: the reduce's epilogue constants (zero-point term, scale, bias:
  //   Cout values apiece), the squeeze's (Csq apiece), the squeeze weights
  //   [Csq][ld_sq] (Cin padded to 32 with zeros); head_bytes in all;
  //   stages: for rank r and chunk j of its slice, at (r * max_chunks + j) *
  //   chunk_bytes, the depthwise taps [K*K][ld_dw], at off_cx the expand's
  //   epilogue constants, then the depthwise's (e_chunk values apiece; the
  //   depthwise's zero-point term is -zp * the sum of the taps), at off_slot
  //   the expand weights [e_chunk][ld_ex] (Ccat padded to 32 with zeros):
  //   first_bytes up to here, copied when the chunk is due; then the
  //   reduce's [Cout][ld_rd] (the chunk's columns, zeros past them),
  //   rd_bytes, copied into the expand weights' slot once the expand is done
  const uint8_t* head;
  const uint8_t* stages;
  int B, H, W, Cin, Cout, Ho, Wo, E, Ccat, Csq;
  int has_squeeze, has_expand, residual;
  // launch plan: threads a CUDA block, cluster size, tile, expanded-width units and chunks
  int threads, cluster, tile_h, tile_w, halo_h, halo_w, tiles_w, e_unit, e_units, e_chunk,
      max_chunks;
  // shared-memory row strides in bytes (odd multiples of 16 for ldmatrix rows)
  int ld_x, ld_sq, ld_cat, ld_e, ld_d, ld_ex, ld_rd, ld_dw;
  // shared-memory sections (bytes): the input halo (with a squeeze, later the
  // reduce partial at off_acc: [rank owning the columns][pixel][n_cols]
  // int32), the head's reduce constants at off_rdc, the cat rows at off_cat,
  // the head's squeeze constants at off_sqc and its squeeze weights at off_e
  // (later the expanded chunk, and at off_d the depthwise output), the
  // weight stages at off_w (w_stage bytes apiece: the first part of a
  // chunk, its reduce weights later at off_slot); at off_tab two 256-byte
  // lookup tables, each column's offset in the partial (int32) and the halo
  // pixel of each in-image row (uint16); six mbarriers at off_bar. After the
  // last chunk, off_cat onwards receives the peers' partials of this rank's
  // columns, [rank][pixel][n_cols].
  int n_cols;  // output columns of a rank (the last may have fewer)
  int off_acc, off_rdc, off_cat, off_sqc, head_bytes, off_e, off_d, off_w, w_stage, off_cx,
      off_slot, chunk_bytes, first_bytes, rd_bytes, off_tab, off_bar;
  float qmax;
  float x_zp, x_scale;  // input grid
  float sq_mult, sq_zp;  // squeeze output grid
  float cat_sq_s, cat_sq_mult, cat_x_s, cat_x_mult, cat_zp;  // QCat
  float ex_mult, ex_zp;  // expand output grid
  int dw_in_zp;
  float dw_mult, dw_zp;  // depthwise
  float rd_mult, rd_zp, rd_s;  // reduce
  float add_mult, add_zp;  // residual QAdd
};

namespace {

using frost_mma::bulk_load;
using frost_mma::cp_async16;
using frost_mma::cp_async8;
using frost_mma::cp_async_commit;
using frost_mma::cp_async_wait;
using frost_mma::fence_proxy_async;
using frost_mma::mbar_expect_tx;
using frost_mma::mbar_init;
using frost_mma::mbar_wait;
using frost_mma::smem_u32;

constexpr int kMaxThreads = 512;  // a launch has 256 or 512 (the plan's `threads`)
constexpr int kSmemLimit = 232448;  // shared memory one CUDA block may use on an H100

// address of the same shared-memory location in CUDA block `rank` of the cluster
__device__ __forceinline__ uint32_t mapa(uint32_t addr, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

// one bulk copy of `bytes` (a multiple of 16) from this CUDA block's shared
// memory into a peer's (dst and bar: shared::cluster addresses from mapa),
// completing on the peer's mbarrier
__device__ __forceinline__ void bulk_to_peer(uint32_t dst, uint32_t src, uint32_t bytes,
                                             uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(dst), "r"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ int pad32(int n) { return (n + 31) & ~31; }

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a (16 x 32 u8, row-major) x b (32 x 8 s8, column-major), int32
__device__ __forceinline__ void mma_u8s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Block-wide small GEMM on the int8 tensor cores:
//   acc[m][n] = sum_{k < kpad} A[m][k] * W[n][k]   for m < rows, n < ncols.
// Row m of A is the uint8 row at shared address row_addr(m) (rows may be
// gathered); W is int8 [ncols][ldw] in shared memory, K contiguous. kpad is
// a multiple of 32 and both operands hold kpad readable bytes a row (columns
// past the true K meet zero weights). ncols is a multiple of 8. Each warp
// takes 16 rows x 32 columns at a time: one ldmatrix.x4 of A and two of W
// per 32-byte K step, four mma.sync. epi(m, n, acc_n, acc_n+1) gets two
// adjacent columns (n even).
template <class RowAddr, class Epi>
__device__ __forceinline__ void block_mma(RowAddr row_addr, int rows, uint32_t w, int ldw,
                                          int ncols, int kpad, Epi epi) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int mtiles = (rows + 15) >> 4, ngroups = (ncols + 31) >> 5;
  // A: lanes 0-15 give rows 0-15 at K bytes 0-15, lanes 16-31 the same rows at 16-31
  // W: lanes 0-7 / 8-15 give columns 0-7 at K bytes 0-15 / 16-31, lanes 16-31 columns 8-15
  const int b_col = (lane & 7) + ((lane >> 4) << 3), b_k = ((lane >> 3) & 1) * 16;
  for (int task = warp; task < mtiles * ngroups; task += blockDim.x / 32) {
    const int m0 = (task % mtiles) * 16, n0 = (task / mtiles) * 32;
    const int nt = min(4, (ncols - n0) >> 3);  // n8 tiles in range (warp-uniform)
    const uint32_t a = row_addr(min(m0 + (lane & 15), rows - 1)) + (lane >> 4) * 16;
    const uint32_t b0 = w + min(n0 + b_col, ncols - 1) * ldw + b_k;
    const uint32_t b1 = w + min(n0 + 16 + b_col, ncols - 1) * ldw + b_k;
    int acc[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0;
    for (int k = 0; k < kpad; k += 32) {
      uint32_t af[4], bf0[4], bf1[4];
      ldmatrix_x4(af, a + k);
      ldmatrix_x4(bf0, b0 + k);
      mma_u8s8(acc[0], af, bf0[0], bf0[1]);
      if (nt > 1) mma_u8s8(acc[1], af, bf0[2], bf0[3]);
      if (nt > 2) {
        ldmatrix_x4(bf1, b1 + k);
        mma_u8s8(acc[2], af, bf1[0], bf1[1]);
        if (nt > 3) mma_u8s8(acc[3], af, bf1[2], bf1[3]);
      }
    }
    const int r = m0 + (lane >> 2), c = (lane & 3) * 2;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (j >= nt) break;
      const int n = n0 + 8 * j + c;
      if (r < rows) epi(r, n, acc[j][0], acc[j][1]);
      if (r + 8 < rows) epi(r + 8, n, acc[j][2], acc[j][3]);
    }
  }
}

// byte j of v zero-extended (selector 0x444j) or sign-extended (selector
// 0xsssj, s = 8 + j), by prmt in inline PTX (written in C, nvcc fuses the
// byte products into dp4a)
__device__ __forceinline__ int prmt(uint32_t v, uint32_t sel) {
  int r;
  asm("prmt.b32 %0, %1, 0, %2;" : "=r"(r) : "r"(v), "r"(sel));
  return r;
}

// depthwise kxk + ReLU of one chunk for the tile's pixels, 4 channels a
// thread in int32 multiply-adds: src is the chunk's halo ([halo pixel][lds],
// the zero point outside the image), taps [K*K][ld_dw] int8, then the
// chunk's epilogue constants; dst [pixel][ld_d] uint8. The zero point enters
// once per channel, as the zero-point term -zp * (sum of the channel's taps).
template <int K, int S>
__device__ __forceinline__ void depthwise_chunk(const FrostBlockArgs& a, const uint8_t* src,
                                                int lds, const uint8_t* taps, const int* zt,
                                                const float* scale, const float* bias, int ec,
                                                uint8_t* dst) {
  const int tp = a.tile_h * a.tile_w, cw = ec / 4;
  for (int i = threadIdx.x; i < tp * cw; i += blockDim.x) {
    const int t = i / cw, c = (i - t * cw) * 4;
    const int ty = t / a.tile_w, tx = t - ty * a.tile_w;
    const uint8_t* base = src + ((ty * S) * a.halo_w + tx * S) * lds + c;
    int acc0 = zt[c], acc1 = zt[c + 1], acc2 = zt[c + 2], acc3 = zt[c + 3];
#pragma unroll
    for (int dy = 0; dy < K; ++dy)
#pragma unroll
      for (int dx = 0; dx < K; ++dx) {
        const uint32_t v = *reinterpret_cast<const uint32_t*>(base + (dy * a.halo_w + dx) * lds);
        const uint32_t w =
            *reinterpret_cast<const uint32_t*>(taps + (dy * K + dx) * a.ld_dw + c);
        acc0 += prmt(v, 0x4440) * prmt(w, 0x8880);
        acc1 += prmt(v, 0x4441) * prmt(w, 0x9991);
        acc2 += prmt(v, 0x4442) * prmt(w, 0xaaa2);
        acc3 += prmt(v, 0x4443) * prmt(w, 0xbbb3);
      }
    const int accs[4] = {acc0, acc1, acc2, acc3};
    uint32_t q = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      q |= (uint32_t)requant_acc(accs[j], scale[c + j], bias[c + j], true, a.dw_mult, a.dw_zp,
                                 0.0f, a.qmax)
           << (8 * j);
    *reinterpret_cast<uint32_t*>(dst + t * a.ld_d + c) = q;
  }
}

template <int K, int S>
__global__ void __launch_bounds__(kMaxThreads) frost_block_kernel(const FrostBlockArgs a) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* xs = smem;  // input halo [halo pixel][ld_x]
  uint8_t* cat = smem + a.off_cat;  // QCat codes of the in-image halo rows [row][ld_cat]
  uint8_t* es = smem + a.off_e;  // expanded chunk over the halo [halo pixel][ld_e]
  uint8_t* ds = smem + a.off_d;  // depthwise output [pixel][ld_d]
  int* part = reinterpret_cast<int*>(smem + a.off_acc);  // reduce partial, by finishing rank
  uint8_t* wst = smem + a.off_w;  // weight stages
  const int* rd_zt = reinterpret_cast<const int*>(smem + a.off_rdc);  // the head's constants
  const float* rd_scale = reinterpret_cast<const float*>(rd_zt + a.Cout);
  const float* rd_bias = rd_scale + a.Cout;
  const int* sq_zt = reinterpret_cast<const int*>(smem + a.off_sqc);
  const float* sq_scale = reinterpret_cast<const float*>(sq_zt + a.Csq);
  const float* sq_bias = sq_scale + a.Csq;
  uint8_t* lut_x = smem + a.off_tab;  // input code -> cat code
  uint8_t* lut_sq = lut_x + 256;  // squeeze code -> cat code
  int* col_at = reinterpret_cast<int*>(lut_x + 512);  // column -> its offset in the partial
  uint16_t* hpos = reinterpret_cast<uint16_t*>(col_at + a.Cout);  // in-image row -> halo pixel
  // mbarriers: the head, each stage's first part, each stage's reduce
  // weights, the peers' partials
  const uint32_t bar_head = smem_u32(smem + a.off_bar), bar_recv = bar_head + 40;

  cg::cluster_group cluster = cg::this_cluster();
  const int C = a.cluster, rank = (int)cluster.block_rank();
  const int b = blockIdx.y, tile = blockIdx.x / C;
  const int oy0 = (tile / a.tiles_w) * a.tile_h, ox0 = (tile % a.tiles_w) * a.tile_w;
  const int pad = (K - 1) / 2;
  const int iy0 = oy0 * S - pad, ix0 = ox0 * S - pad;
  const int hp = a.halo_h * a.halo_w, tp = a.tile_h * a.tile_w;
  // the halo's in-image rows: a rectangle [ya, yb) x [xa, xb) of the image
  const int ya = max(iy0, 0), yb = min(iy0 + a.halo_h, a.H);
  const int xa = max(ix0, 0), xb = min(ix0 + a.halo_w, a.W);
  const int rw = xb - xa, n_in = (yb - ya) * rw;
  // this CUDA block's slice of the expanded width (the planner gives every
  // rank at least one unit)
  const int e0 = (rank * a.e_units / C) * a.e_unit;
  const int e1 = min(a.E, ((rank + 1) * a.e_units / C) * a.e_unit);
  const int n_chunks = (e1 - e0 + a.e_chunk - 1) / a.e_chunk;
  const int n_stages = n_chunks > 1 ? 2 : 1;
  const int cm = a.n_cols, tpc = tp * cm;  // a rank's columns; one rank's block of the partial
  auto part_at = [&](int t, int n) { return part + col_at[n] + t * cm; };  // (pixel t, column n)
  const uint8_t* my_chunks = a.stages + (size_t)rank * a.max_chunks * a.chunk_bytes;
  // one thread: chunk j's taps, constants and expand weights, or (reduce)
  // its reduce weights, into its stage
  auto issue = [&](int j, bool reduce) {
    const uint32_t bar = bar_head + 8 * (1 + 2 * reduce + j % n_stages);
    const uint32_t dst = smem_u32(wst + (j % n_stages) * a.w_stage + (reduce ? a.off_slot : 0));
    const uint32_t bytes = reduce ? a.rd_bytes : a.first_bytes;
    mbar_expect_tx(bar, bytes);
    bulk_load(dst, my_chunks + (size_t)j * a.chunk_bytes + (reduce ? a.first_bytes : 0), bytes,
              bar);
  };

  // 1. in flight: the head and the first chunk's first part (bulk copies),
  // the input halo's in-image rows (cp.async); meanwhile the column and row
  // tables and the cat grid's lookup tables
  if (threadIdx.x == 0) {
    for (int i = 0; i < 6; ++i) mbar_init(bar_head + 8 * i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const int rdc = 12 * a.Cout;  // the reduce's constants, then the squeeze's part
    mbar_expect_tx(bar_head, a.head_bytes);
    bulk_load(smem_u32(smem + a.off_rdc), a.head, rdc, bar_head);
    if (a.head_bytes > rdc)
      bulk_load(smem_u32(smem + a.off_sqc), a.head + rdc, a.head_bytes - rdc, bar_head);
    issue(0, false);
    if (C > 1 && rank * cm < a.Cout) mbar_expect_tx(bar_recv, (C - 1) * tpc * 4);
  }
  {
    // 16 bytes a request where the rows allow it, else 8
    const int w = a.Cin % 16 == 0 ? 16 : 8, segs = a.Cin / w;
    for (int i = threadIdx.x; i < n_in * segs; i += blockDim.x) {
      const int m = i / segs, c = (i - m * segs) * w;
      const int ry = m / rw, iy = ya + ry, ix = xa + m - ry * rw;
      const uint8_t* src = a.x + (((size_t)b * a.H + iy) * a.W + ix) * a.Cin + c;
      const uint32_t dst = smem_u32(xs + ((ya - iy0 + ry) * a.halo_w + ix - ix0) * a.ld_x + c);
      if (w == 16)
        cp_async16(dst, src);
      else
        cp_async8(dst, src);
    }
    cp_async_commit();
  }
  for (int n = threadIdx.x; n < a.Cout; n += blockDim.x) col_at[n] = (n / cm) * (tpc - cm) + n;
  for (int m = threadIdx.x; m < n_in; m += blockDim.x) {
    const int ry = m / rw;
    hpos[m] = (uint16_t)((ya - iy0 + ry) * a.halo_w + xa - ix0 + m - ry * rw);
  }
  if (a.has_squeeze) {
    for (int q = threadIdx.x; q < 256; q += blockDim.x) {
      lut_x[q] = requant_code(q, a.x_zp, a.cat_x_s, a.cat_x_mult, a.cat_zp, a.qmax);
      lut_sq[q] = requant_code(q, a.sq_zp, a.cat_sq_s, a.cat_sq_mult, a.cat_zp, a.qmax);
    }
  }
  if (!a.has_expand) {  // the depthwise reads the input halo: its zero point outside the image
    const uint32_t z = (uint32_t)a.x_zp * 0x01010101u;
    const int cw = a.Cin / 4;
    for (int i = threadIdx.x; i < hp * cw; i += blockDim.x) {
      const int p = i / cw, hy = p / a.halo_w, iy = iy0 + hy, ix = ix0 + p - hy * a.halo_w;
      if (iy < ya || iy >= yb || ix < xa || ix >= xb)
        reinterpret_cast<uint32_t*>(xs + p * a.ld_x)[i - p * cw] = z;
    }
  }
  cp_async_wait<0>();
  mbar_wait(bar_head, 0);
  __syncthreads();

  // 2. squeeze 1x1 + ReLU and both QCat halves over the in-image rows -> cat
  if (a.has_squeeze) {
    // (the head put the squeeze weights where the expanded chunk goes later)
    block_mma([&](int m) { return smem_u32(xs + hpos[m] * a.ld_x); }, n_in, smem_u32(es),
              a.ld_sq, a.Csq, pad32(a.Cin), [&](int m, int n, int v0, int v1) {
                const uint8_t q0 = requant_acc(v0 + sq_zt[n], sq_scale[n], sq_bias[n], true,
                                               a.sq_mult, a.sq_zp, 0.0f, a.qmax);
                const uint8_t q1 = requant_acc(v1 + sq_zt[n + 1], sq_scale[n + 1], sq_bias[n + 1],
                                               true, a.sq_mult, a.sq_zp, 0.0f, a.qmax);
                *reinterpret_cast<uint16_t*>(cat + m * a.ld_cat + n) =
                    (uint16_t)(lut_sq[q0] | (lut_sq[q1] << 8));
              });
    const int cw = a.Cin / 4;  // 4 codes a thread
    for (int i = threadIdx.x; i < n_in * cw; i += blockDim.x) {
      const int m = i / cw, c = i - m * cw;
      const uint32_t v = reinterpret_cast<const uint32_t*>(xs + hpos[m] * a.ld_x)[c];
      reinterpret_cast<uint32_t*>(cat + m * a.ld_cat + a.Csq)[c] =
          lut_x[v & 0xffu] | (lut_x[(v >> 8) & 0xffu] << 8) | (lut_x[(v >> 16) & 0xffu] << 16) |
          ((uint32_t)lut_x[v >> 24] << 24);
    }
    __syncthreads();  // the squeeze weights' space becomes es and ds
  }
  if (a.has_expand) {
    // the depthwise input's zero point at every halo position; the expand
    // overwrites the in-image ones chunk by chunk
    const uint32_t z = 0x01010101u * a.dw_in_zp;
    const uint4 z4 = make_uint4(z, z, z, z);
    for (int i = threadIdx.x; i < hp * a.ld_e / 16; i += blockDim.x)
      reinterpret_cast<uint4*>(es)[i] = z4;
    __syncthreads();
  }

  // 3. the slice, chunk by chunk
  for (int j = 0; j < n_chunks; ++j) {
    const int c0 = e0 + j * a.e_chunk, ec = min(a.e_chunk, e1 - c0);
    uint8_t* stage = wst + (j % n_stages) * a.w_stage;
    const uint32_t phase = (j / n_stages) & 1;
    if (threadIdx.x == 0 && j + 1 < n_chunks) issue(j + 1, false);  // into the other stage
    mbar_wait(bar_head + 8 * (1 + j % n_stages), phase);
    const int* ex_zt = reinterpret_cast<const int*>(stage + a.off_cx);
    const float* ex_scale = reinterpret_cast<const float*>(ex_zt + a.e_chunk);
    const float* ex_bias = ex_scale + a.e_chunk;
    const int* dw_zt = reinterpret_cast<const int*>(ex_bias + a.e_chunk);
    const float* dw_scale = reinterpret_cast<const float*>(dw_zt + a.e_chunk);
    const float* dw_bias = dw_scale + a.e_chunk;
    const uint8_t* dw_src = xs + c0;
    int dw_lds = a.ld_x;
    if (a.has_expand) {
      auto epi = [&](int m, int n, int v0, int v1) {
        const uint8_t q0 = requant_acc(v0 + ex_zt[n], ex_scale[n], ex_bias[n], true, a.ex_mult,
                                       a.ex_zp, 0.0f, a.qmax);
        const uint8_t q1 = requant_acc(v1 + ex_zt[n + 1], ex_scale[n + 1], ex_bias[n + 1], true,
                                       a.ex_mult, a.ex_zp, 0.0f, a.qmax);
        *reinterpret_cast<uint16_t*>(es + hpos[m] * a.ld_e + n) = (uint16_t)(q0 | (q1 << 8));
      };
      if (a.has_squeeze)
        block_mma([&](int m) { return smem_u32(cat + m * a.ld_cat); }, n_in,
                  smem_u32(stage + a.off_slot), a.ld_ex, ec, pad32(a.Ccat), epi);
      else
        block_mma([&](int m) { return smem_u32(xs + hpos[m] * a.ld_x); }, n_in,
                  smem_u32(stage + a.off_slot), a.ld_ex, ec, pad32(a.Ccat), epi);
      dw_src = es;
      dw_lds = a.ld_e;
      __syncthreads();
    }
    // the reduce weights take the expand weights' place, in flight during the depthwise
    if (threadIdx.x == 0) issue(j, true);
    depthwise_chunk<K, S>(a, dw_src, dw_lds, stage, dw_zt, dw_scale, dw_bias, ec, ds);
    mbar_wait(bar_head + 8 * (3 + j % n_stages), phase);
    __syncthreads();
    block_mma([&](int m) { return smem_u32(ds + m * a.ld_d); }, tp, smem_u32(stage + a.off_slot),
              a.ld_rd, a.Cout, pad32(ec), [&](int t, int n, int v0, int v1) {
                int2* r = reinterpret_cast<int2*>(part_at(t, n));
                if (j > 0) {
                  const int2 old = *r;
                  v0 += old.x;
                  v1 += old.y;
                }
                *r = make_int2(v0, v1);
              });
    __syncthreads();
  }

  // 4. exchange: each rank's block of the partial goes, as one bulk copy
  // through distributed shared memory, to the rank that finishes those
  // columns; a rank sums the C partials of its columns, adds the zero-point
  // term once, applies the epilogue and the residual add
  const int n_lo = min(rank * cm, a.Cout), n_hi = min(n_lo + cm, a.Cout);
  const int* recv = reinterpret_cast<const int*>(smem + a.off_cat);  // [rank][pixel][n_cols]
  if (C > 1) {
    fence_proxy_async();  // the partial's writes, before the bulk copies read it
    cluster.sync();  // every rank is past its chunks: the receiving space is free
    if (threadIdx.x == 0)
      for (int q = 0; q < C; ++q)
        if (q != rank && q * cm < a.Cout)
          bulk_to_peer(mapa(smem_u32(recv + rank * tpc), q), smem_u32(part + q * tpc),
                       tpc * 4, mapa(bar_recv, q));
    if (n_lo < n_hi) mbar_wait(bar_recv, 0);
  }
  const int cols = (n_hi - n_lo) / 4;
  for (int i = threadIdx.x; i < tp * cols; i += blockDim.x) {
    const int t = i / cols, c = (i - t * cols) * 4, n = n_lo + c;
    const int ty = t / a.tile_w, oy = oy0 + ty, ox = ox0 + t - ty * a.tile_w;
    if (oy >= a.Ho || ox >= a.Wo) continue;
    int4 s = *reinterpret_cast<const int4*>(part + rank * tpc + t * cm + c);
    for (int q = 0; q < C; ++q) {
      if (q == rank) continue;
      const int4 v = *reinterpret_cast<const int4*>(recv + q * tpc + t * cm + c);
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    const int sum[4] = {s.x, s.y, s.z, s.w};
    uint32_t xr = 0;
    if (a.residual)  // stride 1, Cin == Cout
      xr = *reinterpret_cast<const uint32_t*>(a.x + (((size_t)b * a.H + oy) * a.W + ox) * a.Cin +
                                              n);
    uint32_t word = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint8_t q = requant_acc(sum[j] + rd_zt[n + j], rd_scale[n + j], rd_bias[n + j], false,
                              a.rd_mult, a.rd_zp, 0.0f, a.qmax);
      if (a.residual)
        q = qadd_code((xr >> (8 * j)) & 0xffu, a.x_zp, a.x_scale, q, a.rd_zp, a.rd_s,
                      a.add_mult, a.add_zp, a.qmax);
      word |= (uint32_t)q << (8 * j);
    }
    *reinterpret_cast<uint32_t*>(a.out + (((size_t)b * a.Ho + oy) * a.Wo + ox) * a.Cout + n) =
        word;
  }
  // no CUDA block leaves while a bulk copy may still read its partial
  if (C > 1) cluster.sync();
}

template <int K, int S>
cudaError_t set_attributes() {
  auto kernel = frost_block_kernel<K, S>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

template <int K, int S>
cudaLaunchConfig_t launch_config(const FrostBlockArgs& a, int smem, cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  const int tiles = ((a.Ho + a.tile_h - 1) / a.tile_h) * a.tiles_w;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles * a.cluster, a.B);
  cfg.blockDim = dim3(a.threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = a.cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// How many clusters of this launch the card can hold at once (0: it cannot
// be scheduled at all).
template <int K, int S>
cudaError_t max_clusters(const FrostBlockArgs& a, int smem, int* count) {
  static const cudaError_t attr_err = set_attributes<K, S>();
  if (attr_err != cudaSuccess) return attr_err;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = launch_config<K, S>(a, smem, 0, &attr);
  return cudaOccupancyMaxActiveClusters(count, frost_block_kernel<K, S>, &cfg);
}

template <int K, int S>
cudaError_t launch(const FrostBlockArgs& a, int smem, cudaStream_t stream) {
  static const cudaError_t attr_err = set_attributes<K, S>();
  if (attr_err != cudaSuccess) return attr_err;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = launch_config<K, S>(a, smem, stream, &attr);
  cudaError_t err = cudaLaunchKernelEx(&cfg, frost_block_kernel<K, S>, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" int frost_block_args_size() { return (int)sizeof(FrostBlockArgs); }

extern "C" int frost_block_int8(const FrostBlockArgs* args, int kernel, int stride, int smem,
                                void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  if (kernel == 3 && stride == 1) return (int)launch<3, 1>(*args, smem, st);
  if (kernel == 3 && stride == 2) return (int)launch<3, 2>(*args, smem, st);
  if (kernel == 5 && stride == 1) return (int)launch<5, 1>(*args, smem, st);
  if (kernel == 5 && stride == 2) return (int)launch<5, 2>(*args, smem, st);
  return (int)cudaErrorInvalidValue;
}

// cudaOccupancyMaxActiveClusters of a planned launch, into *count
extern "C" int frost_block_max_active_clusters(const FrostBlockArgs* args, int kernel, int stride,
                                               int smem, int* count) {
  if (kernel == 3 && stride == 1) return (int)max_clusters<3, 1>(*args, smem, count);
  if (kernel == 3 && stride == 2) return (int)max_clusters<3, 2>(*args, smem, count);
  if (kernel == 5 && stride == 1) return (int)max_clusters<5, 1>(*args, smem, count);
  if (kernel == 5 && stride == 2) return (int)max_clusters<5, 2>(*args, smem, count);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* frost_block_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
