// Dense 3x3 stride-1 INT8 convolution with the requant epilogue of the
// frozen INT8 graph.
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
// packed as wt[o][tap][c] with c zero-padded to a multiple of kKC.
//
// What bounds it on an H100: operations. At the generator's shapes one conv
// does 2 * 9 * Cin operations per output byte (up to 4608), far above the
// card's int8 ridge. This first kernel is an implicit GEMM on the CUDA cores:
// one block per (image, 4x32 output pixels, 64 output channels); for each
// 32-channel chunk of the input it stages the 6x34 halo of codes (padded
// with the zero point) and the chunk's 64x9x32 weights in shared memory,
// then each thread accumulates 4 pixels x 8 channels with dp4a into int32
// registers. The whole epilogue runs in registers and only uint8 codes
// leave the kernel. The int8 tensor cores (mma.sync / wgmma, fed by TMA)
// would lift the dp4a ceiling about eightfold; that is later work.
#include "requant.cuh"

namespace {

constexpr int kTH = 4;                 // output rows per block
constexpr int kTW = 32;                // output columns per block (one warp's lanes)
constexpr int kTC = 64;                // output channels per block
constexpr int kKC = 32;                // input channels (bytes) per stage
constexpr int kKW = kKC / 4;           // 32-bit words per stage and pixel
constexpr int kHaloH = kTH + 2, kHaloW = kTW + 2;
constexpr int kXs = kKW + 1;           // word stride of a halo pixel (odd)
constexpr int kWs = 9 * kKW + 1;       // word stride of an output channel (odd)
constexpr int kThreads = 256;          // 32 lanes over columns x 8 warps over channels
constexpr int kPix = kTH * kTW / 32;   // pixels per thread (one per row)
constexpr int kCh = kTC / 8;           // channels per thread

template <bool kRelu>
__global__ void __launch_bounds__(kThreads)
conv3x3_s1_int8_kernel(const uint8_t* __restrict__ x, const int8_t* __restrict__ wt,
                       const int32_t* __restrict__ zterm,
                       const float* __restrict__ scale,
                       const float* __restrict__ bias, uint8_t* __restrict__ out,
                       int H, int W, int Cin, int Cout, int cin_pad, int tiles_w,
                       uint32_t zp_word, float out_mult, float out_zp, float qmin,
                       float qmax) {
  __shared__ uint32_t Xs[kHaloH * kHaloW * kXs];
  __shared__ uint32_t Ws[kTC * kWs];
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int h0 = (blockIdx.x / tiles_w) * kTH, w0 = (blockIdx.x % tiles_w) * kTW;
  const int o0 = blockIdx.y * kTC;
  const int b = blockIdx.z;
  const uint8_t* xb = x + (size_t)b * H * W * Cin;

  int acc[kPix][kCh];
#pragma unroll
  for (int i = 0; i < kPix; ++i)
#pragma unroll
    for (int j = 0; j < kCh; ++j) acc[i][j] = 0;

  for (int c0 = 0; c0 < Cin; c0 += kKC) {
    // halo of input codes: zero point outside the image, 0 past Cin
    for (int i = tid; i < kHaloH * kHaloW * kKW; i += kThreads) {
      const int slot = i / kKW, k = i % kKW;
      const int h = h0 - 1 + slot / kHaloW, w = w0 - 1 + slot % kHaloW;
      const int c = c0 + 4 * k;
      uint32_t v = 0u;
      if (c < Cin) {
        v = (h >= 0 && h < H && w >= 0 && w < W)
                ? *reinterpret_cast<const uint32_t*>(xb + ((size_t)h * W + w) * Cin + c)
                : zp_word;
      }
      Xs[slot * kXs + k] = v;
    }
    // weights of this chunk: zero past Cout (and past Cin, by the packing)
    for (int i = tid; i < kTC * 9 * kKW; i += kThreads) {
      const int o = i / (9 * kKW), r = i % (9 * kKW);
      const int tap = r / kKW, k = r % kKW;
      Ws[o * kWs + r] =
          (o0 + o < Cout)
              ? *reinterpret_cast<const uint32_t*>(
                    wt + ((size_t)(o0 + o) * 9 + tap) * cin_pad + c0 + 4 * k)
              : 0u;
    }
    __syncthreads();
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
#pragma unroll
      for (int k = 0; k < kKW; ++k) {
        uint32_t a[kPix], w[kCh];
#pragma unroll
        for (int i = 0; i < kPix; ++i)
          a[i] = Xs[((i + dy) * kHaloW + lane + dx) * kXs + k];
#pragma unroll
        for (int j = 0; j < kCh; ++j) w[j] = Ws[(warp * kCh + j) * kWs + tap * kKW + k];
#pragma unroll
        for (int i = 0; i < kPix; ++i)
#pragma unroll
          for (int j = 0; j < kCh; ++j) acc[i][j] = dp4a_us(a[i], w[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

  const int ow = w0 + lane;
  if (ow >= W) return;
  const int oc = o0 + warp * kCh;
#pragma unroll
  for (int i = 0; i < kPix; ++i) {
    const int oh = h0 + i;
    if (oh >= H) continue;
    uint8_t* dst = out + ((size_t)(b * H + oh) * W + ow) * Cout + oc;
    uint8_t q[kCh];
#pragma unroll
    for (int j = 0; j < kCh; ++j) {
      const int o = oc + j < Cout ? oc + j : Cout - 1;
      q[j] = requant_acc(acc[i][j] + zterm[o], scale[o], bias[o], kRelu, out_mult,
                         out_zp, qmin, qmax);
    }
    if (oc + kCh <= Cout && (Cout % kCh) == 0) {
      uint2 v;
      v.x = q[0] | (q[1] << 8) | (q[2] << 16) | ((uint32_t)q[3] << 24);
      v.y = q[4] | (q[5] << 8) | (q[6] << 16) | ((uint32_t)q[7] << 24);
      *reinterpret_cast<uint2*>(dst) = v;
    } else {
#pragma unroll
      for (int j = 0; j < kCh; ++j)
        if (oc + j < Cout) dst[j] = q[j];
    }
  }
}

}  // namespace

extern "C" int frost_conv3x3_s1_int8(const void* x, const void* wt, const void* zterm,
                                     const void* scale, const void* bias, void* out,
                                     int B, int H, int W, int Cin, int Cout, int cin_pad,
                                     int zp_in, int relu, float out_mult, float out_zp,
                                     float qmin, float qmax, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || Cout <= 0) return (int)cudaSuccess;
  if (Cin % 4 != 0 || Cout % 4 != 0 || cin_pad % kKC != 0 || cin_pad < Cin ||
      (size_t)x % 4 != 0 || (size_t)out % 8 != 0)
    return (int)cudaErrorInvalidValue;
  const int tiles_w = (W + kTW - 1) / kTW;
  const dim3 grid(tiles_w * ((H + kTH - 1) / kTH), (Cout + kTC - 1) / kTC, B);
  const uint32_t zp_word = 0x01010101u * (uint32_t)(zp_in & 0xff);
  auto st = static_cast<cudaStream_t>(stream);
  auto* xp = static_cast<const uint8_t*>(x);
  auto* wp = static_cast<const int8_t*>(wt);
  auto* zt = static_cast<const int32_t*>(zterm);
  auto* sp = static_cast<const float*>(scale);
  auto* bp = static_cast<const float*>(bias);
  auto* op = static_cast<uint8_t*>(out);
  if (relu)
    conv3x3_s1_int8_kernel<true><<<grid, kThreads, 0, st>>>(
        xp, wp, zt, sp, bp, op, H, W, Cin, Cout, cin_pad, tiles_w, zp_word, out_mult,
        out_zp, qmin, qmax);
  else
    conv3x3_s1_int8_kernel<false><<<grid, kThreads, 0, st>>>(
        xp, wp, zt, sp, bp, op, H, W, Cin, Cout, cin_pad, tiles_w, zp_word, out_mult,
        out_zp, qmin, qmax);
  return (int)cudaGetLastError();
}

extern "C" const char* frost_conv3x3_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
