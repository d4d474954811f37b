// Dense 3x3 stride-1 INT8 convolution with the requant epilogue of the
// frozen INT8 graph, on Hopper's int8 tensor cores.
//
// Replaces frostnet_tpu/ops/pallas_int8_conv.py::conv3x3_s1_int8 (the Pallas
// TPU kernel). It carries every dense 3x3 stride-1 INT8 conv of the GAN
// generator (the ResnetBlock convs and the two up convs):
//   acc[b,h,w,o] = sum_{dy,dx,c} x[b,h+dy-1,w+dx-1,c] * wt[o,dy*3+dx,c] + zterm[o]
//   y            = fma(float(acc), scale[o], bias[o]), optional ReLU
//   out          = clamp(rint(y * out_mult) + out_zp, qmin, qmax) -> uint8
// x holds unshifted uint8 codes (NHWC); taps outside the image read the
// input zero point, so they contribute exactly zp * w, which zterm[o] =
// -zp * sum(w[:, :, :, o]) cancels (qnnpack pad semantics). The weight is
// packed as wt[c / kKC][tap][(c % kKC) / 16][o][c % 16], c zero-padded to a
// multiple of kKC: what one block stages for one chunk and tap is BN rows
// of 16 contiguous bytes, read by whole warps as 512 contiguous bytes.
//
// What bounds it on an H100: operations. One conv does 2 * 9 * Cin
// operations per output byte (up to 4608 at the generator's widths), far
// above the card's int8 ridge (~590 operations per byte), so only the
// tensor cores can approach the bound. The design is an implicit GEMM on
// wgmma with reuse of the halo: one block computes 4 output rows x 64
// columns x BN (64 or 128) output channels with 4 consumer warpgroups, one
// output row each. For each 32-channel chunk of the input it stages the
// (4+2) x (64+2) halo of codes once (cp.async; slots outside the image are
// stored as the zero point with st.shared) and the chunk's 9 x 32 x BN
// weights, in a 4-stage cp.async ring two chunks ahead of the tensor cores
// (TMA boxes of 16-byte rows fetched the weights slower than cp.async). The 9 taps are 9 wgmma m64nBNk32 whose A
// descriptors are shifted windows of that one halo (its layout makes any
// 64 consecutive halo pixels one descriptor, int8_mma.cuh), so nothing is
// copied per tap. The int32 accumulators stay in registers; the epilogue
// requantizes them there (its per-channel constants staged in shared
// memory) and stages the uint8 tile through shared memory for 16-byte
// coalesced stores.
#include "int8_mma.cuh"

namespace {

using namespace frost_mma;

constexpr int kTH = 4;                          // output rows per block, one per warpgroup
constexpr int kTW = 64;                         // output columns per block (the wgmma M)
constexpr int kKC = 32;                         // input channels per chunk (one wgmma K step)
constexpr int kStages = 4;
constexpr int kHaloW = kTW + 2;
constexpr int kHaloPix = (kTH + 2) * kHaloW;
constexpr int kSlice = kHaloPix * 16;           // one 16-channel slice of the halo, bytes
constexpr int kHaloBytes = 2 * kSlice;          // a multiple of 128 (TMA destinations)
constexpr int kThreads = 128 * kTH;
// how the halo's rows are staged: 16-byte or 4-byte cp.async where Cin and
// x allow it, else byte loads (any Cin, e.g. an RGB image's 3 channels)
constexpr int kX16 = 2, kX4 = 1, kXBytes = 0;

__device__ __forceinline__ void st_shared_v4x(uint32_t dst, uint32_t a, uint32_t b, uint32_t c,
                                              uint32_t d) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst), "r"(a), "r"(b), "r"(c),
               "r"(d)
               : "memory");
}

__host__ __device__ constexpr int stage_bytes(int bn) { return kHaloBytes + 9 * kKC * bn; }
__host__ __device__ constexpr int smem_bytes(int bn) {
  return 128 + kStages * stage_bytes(bn) + 12 * bn;
}

template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
conv3x3_s1_int8_kernel(const uint8_t* __restrict__ x, const int8_t* __restrict__ wt,
                       const int32_t* __restrict__ zterm, const float* __restrict__ scale,
                       const float* __restrict__ bias, uint8_t* __restrict__ out, int H,
                       int W, int Cin, int Cout, int tiles_w, uint32_t zp_word,
                       int x_mode, int out_vec16, int relu, float out_mult, float out_zp,
                       float qmin, float qmax) {
  extern __shared__ __align__(128) uint8_t smem_raw[];
  constexpr int kStage = stage_bytes(BN);
  const int tid = threadIdx.x, wg = tid / 128;
  const int h0 = (blockIdx.x / tiles_w) * kTH, w0 = (blockIdx.x % tiles_w) * kTW;
  const int o0 = blockIdx.y * BN, b = blockIdx.z;
  const uint8_t* xb = x + (size_t)b * H * W * Cin;
  const uint32_t raw = smem_u32(smem_raw), base = (raw + 127) & ~127u;
  uint8_t* smem = smem_raw + (base - raw);
  const int n_valid = min(BN, Cout - o0);
  int32_t* pz = reinterpret_cast<int32_t*>(smem + kStages * kStage);
  float* ps = reinterpret_cast<float*>(pz + BN);
  float* pb = ps + BN;
  stage_params<BN>(pz, ps, pb, zterm, scale, bias, o0, n_valid);

  auto load = [&](int stage, int chunk) {
    const int c0 = chunk * kKC;
    const uint32_t hs = base + stage * kStage, ws = hs + kHaloBytes;
    // halo: [slice][pixel][16 bytes]; the zero point outside the image.
    // Channels past Cin are left as they are: their weights are 0.
    for (int i = tid; i < 2 * kHaloPix; i += kThreads) {
      const int pix = i >> 1, sl = i & 1;
      const int h = h0 - 1 + pix / kHaloW, w = w0 - 1 + pix % kHaloW;
      const int c = c0 + 16 * sl;
      const uint32_t dst = hs + sl * kSlice + pix * 16;
      if (h < 0 || h >= H || w < 0 || w >= W) {
        st_shared_v4(dst, zp_word);
      } else if (c < Cin) {
        const uint8_t* src = xb + ((size_t)h * W + w) * Cin + c;
        if (x_mode == kX16) {
          cp_async16(dst, src);
        } else if (x_mode == kX4) {
#pragma unroll
          for (int q = 0; q < 4; ++q)
            if (c + 4 * q < Cin) cp_async4(dst + 4 * q, src + 4 * q);
        } else {  // rows not 4-byte aligned: byte loads, packed into words
          uint32_t v[4] = {0u, 0u, 0u, 0u};
#pragma unroll
          for (int j = 0; j < 16; ++j)
            if (c + j < Cin) v[j >> 2] |= (uint32_t)__ldg(src + j) << (8 * (j & 3));
          st_shared_v4x(dst, v[0], v[1], v[2], v[3]);
        }
      }
    }
    // weights: [tap][slice][out channel][16 bytes], as packed: 512
    // contiguous bytes per warp. Channels past Cout are left as they are
    // (their outputs are not stored).
    const int8_t* wc = wt + (size_t)chunk * 18 * Cout * 16;
    for (int i = tid; i < 18 * BN; i += kThreads) {
      const int ts = i / BN, n = i % BN;
      if (o0 + n < Cout) cp_async16(ws + i * 16, wc + ((size_t)ts * Cout + o0 + n) * 16);
    }
  };

  auto mma = [&](int stage, int (&d)[BN / 2]) {
    const uint32_t hs = base + stage * kStage, ws = hs + kHaloBytes;
    wgmma_fence();
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
      const uint64_t da = desc_interleave(hs + ((wg + dy) * kHaloW + dx) * 16, kSlice, 128);
      const uint64_t db = desc_interleave(ws + tap * 2 * BN * 16, BN * 16, 128);
      Wgmma<BN, true>::run(d, da, db);
    }
    wgmma_commit();
  };

  int acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
  run_pipeline<kStages, false>((Cin + kKC - 1) / kKC, acc, 0u, load, mma);

  // epilogue: requantize in registers, stage the uint8 tile, store it
  constexpr int kOs = BN + 16;
  requant_fragment<BN>(acc, smem, wg * kTW, pz, ps, pb, relu != 0, out_mult, out_zp, qmin,
                       qmax);
  __syncthreads();
  if (out_vec16) {
    for (int i = tid; i < kTH * kTW * (BN / 16); i += kThreads) {
      const int p = i / (BN / 16), q = i % (BN / 16);
      const int oh = h0 + p / kTW, ow = w0 + p % kTW;
      if (oh < H && ow < W && 16 * q < n_valid)
        *reinterpret_cast<uint4*>(out + (((size_t)b * H + oh) * W + ow) * Cout + o0 + 16 * q) =
            *reinterpret_cast<const uint4*>(smem + p * kOs + 16 * q);
    }
  } else {
    for (int i = tid; i < kTH * kTW * BN; i += kThreads) {
      const int p = i / BN, n = i % BN;
      const int oh = h0 + p / kTW, ow = w0 + p % kTW;
      if (oh < H && ow < W && n < n_valid)
        out[(((size_t)b * H + oh) * W + ow) * Cout + o0 + n] = smem[p * kOs + n];
    }
  }
}

template <int BN>
cudaError_t launch(int B, int H, int W, const uint8_t* x, const int8_t* wt, const int32_t* zt,
                   const float* sp, const float* bp, uint8_t* op, int Cin, int Cout,
                   uint32_t zp_word, int x_mode, int out_vec16, int relu,
                   float out_mult, float out_zp, float qmin, float qmax, cudaStream_t st) {
  constexpr int kSmem = smem_bytes(BN);
  static const cudaError_t attr = allow_smem(conv3x3_s1_int8_kernel<BN>, kSmem);
  if (attr != cudaSuccess) return attr;
  const int tiles_w = (W + kTW - 1) / kTW;
  const dim3 grid(tiles_w * ((H + kTH - 1) / kTH), (Cout + BN - 1) / BN, B);
  conv3x3_s1_int8_kernel<BN><<<grid, kThreads, kSmem, st>>>(
      x, wt, zt, sp, bp, op, H, W, Cin, Cout, tiles_w, zp_word, x_mode, out_vec16, relu,
      out_mult, out_zp, qmin, qmax);
  return cudaGetLastError();
}

}  // namespace

extern "C" int frost_conv3x3_s1_int8(const void* x, const void* wt, const void* zterm,
                                     const void* scale, const void* bias, void* out,
                                     int B, int H, int W, int Cin, int Cout, int cin_pad,
                                     int zp_in, int relu, float out_mult, float out_zp,
                                     float qmin, float qmax, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || Cout <= 0) return (int)cudaSuccess;
  if (Cin <= 0 || cin_pad % kKC != 0 || cin_pad < Cin || (size_t)wt % 16 != 0)
    return (int)cudaErrorInvalidValue;
  // one branch per launch: the aligned shapes keep their cp.async staging
  const int x_mode = Cin % 16 == 0 && (size_t)x % 16 == 0 ? kX16
                     : Cin % 4 == 0 && (size_t)x % 4 == 0 ? kX4
                                                          : kXBytes;
  const int out_vec16 = Cout % 16 == 0 && (size_t)out % 16 == 0;
  const uint32_t zp_word = 0x01010101u * (uint32_t)(zp_in & 0xff);
  auto* xp = static_cast<const uint8_t*>(x);
  auto* wp = static_cast<const int8_t*>(wt);
  auto* zt = static_cast<const int32_t*>(zterm);
  auto* sp = static_cast<const float*>(scale);
  auto* bp = static_cast<const float*>(bias);
  auto* op = static_cast<uint8_t*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      Cout <= 64 ? launch<64>(B, H, W, xp, wp, zt, sp, bp, op, Cin, Cout, zp_word,
                              x_mode, out_vec16, relu, out_mult, out_zp, qmin, qmax, st)
                 : launch<128>(B, H, W, xp, wp, zt, sp, bp, op, Cin, Cout, zp_word,
                               x_mode, out_vec16, relu, out_mult, out_zp, qmin, qmax, st);
  return (int)err;
}

extern "C" const char* frost_conv3x3_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
