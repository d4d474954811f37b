// INT8 depthwise convolution with the requant epilogue of the frozen INT8
// graph, in one launch.
//
// Added, not ported: no TPU kernel does this work. The JAX package runs the
// INT8 depthwise conv as XLA code (frostnet_tpu/nn/conv.py, the depthwise
// branch of the INT8 forward), and the port ran it as torch ops
// (ops/requant.py::depthwise_acc, a loop over the taps, then
// requant_epilogue: 58 launches a 3x3 layer and 90 a 5x5 one). It
// computes, over uint8 NHWC codes,
//   acc[b,y,x,o] = sum_{dy,dx} (x[b, y*s-ph+d*dy, x*s-pw+d*dx, o/m] - zp_in) * taps[dy*kw+dx, o]
//   out          = requant_acc(acc, scale[o], bias[o], ...)   (requant.cuh)
// with taps outside the image reading the zero point (they add 0), for any
// kernel (kh, kw), stride s, dilation d, padding (ph, pw) and channel
// multiplier m (Cout = m * C, output channel o reading input channel o / m).
// The zero point is folded into zterm[o] = -zp_in * sum_t taps[t, o] (slots
// outside the image hold zp_in), so the products take the codes as they are:
// the same int32 as the torch ops, then the same roundings.
//
// What bounds it on an H100: bytes. A tap is one multiply-add an output
// code, 18 operations an output byte at 3x3 and 50 at 5x5, far under the
// card's int8 ridge (~590 operations a byte of device memory); the least
// time is the input codes read once and the output codes written once. The
// multiply-adds still cost instruction slots on the CUDA cores (no
// tensor-core shape fits a per-channel product), so the design spends few
// instructions on each.
//
// The design: a block owns a tile of output rows x columns x a slab of up to
// 64 output channels of one image. It stages the tile's input halo (the
// slab's input channels) in shared memory with V-byte vector loads (V = 16,
// 8, 4 or 1, the widest that C's alignment allows, by template; slots
// outside the image store the zero point), the slab's taps in chunks of 4
// (one word a channel: taps t..t+3, zero past the last) and each tap's
// offset in the halo. A thread owns one output column of the tile, 4 output
// channels (one 32-bit word of codes) and kPix rows at a time in int32
// registers. Where m = 1 and C is a multiple of 4, a chunk costs it four
// 32-bit shared-memory reads a pixel (4 taps x 4 channels), a 4x4 byte
// transpose (8 byte permutes) and 4 dp4a, one a channel: 16 multiply-adds
// in 16 instructions. Otherwise each channel gathers its own bytes. The
// epilogue runs in registers, and a thread stores its 4 codes as one 32-bit
// word (a warp's words are contiguous). The tile is as wide as the block has
// lanes (64 columns at 16 channels, 16-25 at 64) and 8 rows deep, so the
// 32x64 maps of the segmentation trunk still give hundreds of blocks at
// batch 8.
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "requant.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPix = 4;       // output pixels a thread holds at once
constexpr int kSlabWords = 16; // most 32-bit words of output channels a slab
constexpr int kDefaultSmem = 48 * 1024;
constexpr int kMaxSmem = 227 * 1024;

struct Params {
  const uint8_t* x;
  const int8_t* taps;
  const int32_t* zterm;
  const float* scale;
  const float* bias;
  uint8_t* out;
  int H, W, C, m, Cout, Ho, Wo;
  int kh, kw, s, d, ph, pw;
  int nw;        // words of output channels a slab
  int th, tw;    // output tile
  int ih, iw;    // its input halo
  int csp;       // bytes a staged pixel (the slab's input channels, padded)
  int xs_bytes;  // bytes of the staged halo (a multiple of 16)
  int tiles_w;
  int zp, relu;
  float out_mult, out_zp, qmin, qmax;
};

template <int V> struct Vec;
template <> struct Vec<16> {
  using T = uint4;
  static __device__ __forceinline__ T splat(uint32_t z) { return make_uint4(z, z, z, z); }
};
template <> struct Vec<8> {
  using T = uint2;
  static __device__ __forceinline__ T splat(uint32_t z) { return make_uint2(z, z); }
};
template <> struct Vec<4> {
  using T = uint32_t;
  static __device__ __forceinline__ T splat(uint32_t z) { return z; }
};
template <> struct Vec<1> {
  using T = uint8_t;
  static __device__ __forceinline__ T splat(uint32_t z) { return (uint8_t)z; }
};

__device__ __forceinline__ int dp4a_us(uint32_t a, uint32_t b, int c) {
  int d;  // c + the four products of a's unsigned bytes and b's signed ones
  asm("dp4a.u32.s32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

__device__ __forceinline__ uint32_t ld_shared_u32(const uint8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <int V, bool kWord>
__global__ void __launch_bounds__(kThreads)
depthwise_int8_kernel(const Params p) {
  extern __shared__ __align__(16) uint8_t smem[];
  using T = typename Vec<V>::T;
  const int tid = threadIdx.x, b = blockIdx.z;
  const int oy0 = (blockIdx.x / p.tiles_w) * p.th, ox0 = (blockIdx.x % p.tiles_w) * p.tw;
  const int slab = 4 * p.nw;
  const int c0 = blockIdx.y * slab;          // the slab's first output channel
  const int ci0 = c0 / p.m;                  // its first input channel
  const int ncs = min(p.C, (min(c0 + slab, p.Cout) - 1) / p.m + 1) - ci0;
  const int ntaps = p.kh * p.kw, nchunks = (ntaps + 3) / 4;
  uint8_t* xs = smem;                                          // [ih][iw][csp]
  uint32_t* wt = reinterpret_cast<uint32_t*>(smem + p.xs_bytes);  // [nchunks][slab]
  int* toff = reinterpret_cast<int*>(wt + nchunks * slab);       // [nchunks * 4]

  // the taps by chunks of 4, a word a channel (taps past the last are 0),
  // and each tap's offset in the halo (a padded tap reads tap 0's codes)
  for (int i = tid; i < nchunks * slab; i += kThreads) {
    const int g = i / slab, c = c0 + i - g * slab;
    uint32_t word = 0;
    for (int k = 0; k < 4; ++k) {
      const int t = 4 * g + k;
      if (t < ntaps && c < p.Cout) word |= (uint32_t)(uint8_t)p.taps[(size_t)t * p.Cout + c] << (8 * k);
    }
    wt[i] = word;
  }
  for (int t = tid; t < 4 * nchunks; t += kThreads)
    toff[t] = t < ntaps ? ((t / p.kw) * p.iw + t % p.kw) * p.d * p.csp : 0;
  // the halo, a column of vectors at a time
  const int iy0 = oy0 * p.s - p.ph, ix0 = ox0 * p.s - p.pw;
  const int nv = ncs / V;
  const T zv = Vec<V>::splat(0x01010101u * (uint32_t)(p.zp & 0xff));
  const uint8_t* xb = p.x + (size_t)b * p.H * p.W * p.C + ci0;
  for (int i = tid; i < p.iw * nv; i += kThreads) {
    const int c = i / nv, v = i - c * nv, gx = ix0 + c;
    const bool in_x = gx >= 0 && gx < p.W;
    const T* src = reinterpret_cast<const T*>(xb + ((long long)iy0 * p.W + gx) * p.C) + v;
    uint8_t* dst = xs + c * p.csp + v * V;
#pragma unroll 4
    for (int r = 0; r < p.ih; ++r) {
      const int gy = iy0 + r;
      T val = zv;
      if (in_x && gy >= 0 && gy < p.H) val = __ldg(src + (size_t)r * p.W * p.C / V);
      *reinterpret_cast<T*>(dst + r * p.iw * p.csp) = val;
    }
  }
  __syncthreads();

  // a thread: one output column of the tile (its lane), 4 output channels
  // (its word w), kPix rows at a time
  const int lanes = kThreads / p.nw, lane = tid / p.nw, w = tid - lane * p.nw;
  const int oc = c0 + 4 * w;
  if (lane >= lanes || lane >= p.tw || ox0 + lane >= p.Wo || oc >= p.Cout) return;
  int zt[4], ic[4];
  float sc[4], bi[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const bool on = oc + j < p.Cout;
    zt[j] = on ? p.zterm[oc + j] : 0;
    sc[j] = on ? p.scale[oc + j] : 0.0f;
    bi[j] = on ? p.bias[oc + j] : 0.0f;
    ic[j] = on ? (oc + j) / p.m - ci0 : 0;
  }
  const bool relu = p.relu != 0;
  const int row = p.s * p.iw * p.csp;   // the halo's bytes between output rows
  const uint8_t* col = xs + lane * p.s * p.csp + (kWord ? 4 * w : 0);
  const uint4* wq = reinterpret_cast<const uint4*>(wt) + w;
  const int4* tq = reinterpret_cast<const int4*>(toff);
  uint8_t* ob = p.out + (((size_t)b * p.Ho + oy0) * p.Wo + ox0 + lane) * p.Cout + oc;
  for (int ty = 0; ty < p.th; ty += kPix) {
    int acc[kPix][4];
#pragma unroll
    for (int i = 0; i < kPix; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = zt[j];
    const uint8_t* x0 = col + ty * row;
    for (int g = 0; g < nchunks; ++g) {
      const uint4 wg = wq[g * p.nw];   // channel j's 4 taps in word j
      const int4 o = tq[g];
      if (kWord) {
#pragma unroll
        for (int i = 0; i < kPix; ++i) {
          const uint8_t* xp = x0 + i * row;
          // 4 taps x 4 channels, transposed to 4 channels x 4 taps
          const uint32_t a = ld_shared_u32(xp + o.x), bb = ld_shared_u32(xp + o.y);
          const uint32_t c = ld_shared_u32(xp + o.z), d = ld_shared_u32(xp + o.w);
          const uint32_t ab0 = __byte_perm(a, bb, 0x5140), ab1 = __byte_perm(a, bb, 0x7362);
          const uint32_t cd0 = __byte_perm(c, d, 0x5140), cd1 = __byte_perm(c, d, 0x7362);
          acc[i][0] = dp4a_us(__byte_perm(ab0, cd0, 0x5410), wg.x, acc[i][0]);
          acc[i][1] = dp4a_us(__byte_perm(ab0, cd0, 0x7632), wg.y, acc[i][1]);
          acc[i][2] = dp4a_us(__byte_perm(ab1, cd1, 0x5410), wg.z, acc[i][2]);
          acc[i][3] = dp4a_us(__byte_perm(ab1, cd1, 0x7632), wg.w, acc[i][3]);
        }
      } else {
        const uint32_t wj[4] = {wg.x, wg.y, wg.z, wg.w};
        const int ot[4] = {o.x, o.y, o.z, o.w};
#pragma unroll
        for (int i = 0; i < kPix; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const uint8_t* xp = x0 + i * row + ic[j];
            const uint32_t xv = (uint32_t)xp[ot[0]] | ((uint32_t)xp[ot[1]] << 8) |
                                ((uint32_t)xp[ot[2]] << 16) | ((uint32_t)xp[ot[3]] << 24);
            acc[i][j] = dp4a_us(xv, wj[j], acc[i][j]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kPix; ++i) {
      if (ty + i >= p.th || oy0 + ty + i >= p.Ho) break;
      uint8_t* o = ob + (size_t)(ty + i) * p.Wo * p.Cout;
      uint8_t code[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        code[j] = requant_acc(acc[i][j], sc[j], bi[j], relu, p.out_mult, p.out_zp, p.qmin,
                              p.qmax);
      if (kWord) {
        *reinterpret_cast<uint32_t*>(o) = (uint32_t)code[0] | ((uint32_t)code[1] << 8) |
                                          ((uint32_t)code[2] << 16) | ((uint32_t)code[3] << 24);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (oc + j < p.Cout) o[j] = code[j];
      }
    }
  }
}

template <int V, bool kWord>
cudaError_t launch(const Params& p, dim3 grid, int smem, cudaStream_t st) {
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        depthwise_int8_kernel<V, kWord>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  depthwise_int8_kernel<V, kWord><<<grid, kThreads, smem, st>>>(p);
  return cudaGetLastError();
}

int smem_bytes(const Params& p) {
  const int nchunks = (p.kh * p.kw + 3) / 4;
  return p.xs_bytes + nchunks * 16 * p.nw + nchunks * 16;
}

// The slab, the staged vector and the tile of one launch, for slabs of at
// most `cap` words: the words split evenly into slabs; V the widest vector
// that C, x and every slab's input channels allow; a tile as wide as the
// lanes (one output column a lane) and 8 rows, its rows then its columns
// halved until its halo fits the default shared memory. Returns V.
int plan(Params& p, int cap, bool word, size_t x_addr) {
  const int words = (p.Cout + 3) / 4;
  const int slabs = (words + cap - 1) / cap;
  int nw = (words + slabs - 1) / slabs;
  int V = 16;
  while (V > 1 && (p.C % V != 0 || x_addr % V != 0 || (word && V / 4 > cap)))
    V = V == 4 ? 1 : V / 2;
  if (word && V > 4) nw = (nw + V / 4 - 1) / (V / 4) * (V / 4);
  while (V > 1 && (4 * nw) % (p.m * V) != 0) V = V == 4 ? 1 : V / 2;
  p.nw = nw;
  const int slab_in = word ? 4 * nw : std::min(p.C, (4 * nw - 1) / p.m + 2);
  const int align = std::max(V, 4);
  p.csp = (slab_in + align - 1) / align * align;
  p.tw = std::min(p.Wo, kThreads / nw);
  p.th = std::min(2 * kPix, (p.Ho + kPix - 1) / kPix * kPix);  // a multiple of kPix
  for (;;) {
    p.ih = (p.th - 1) * p.s + p.d * (p.kh - 1) + 1;
    p.iw = (p.tw - 1) * p.s + p.d * (p.kw - 1) + 1;
    p.xs_bytes = (p.ih * p.iw * p.csp + 15) / 16 * 16;
    if (smem_bytes(p) <= kDefaultSmem || (p.th == kPix && p.tw == 1)) break;
    if (p.th > kPix) p.th -= kPix;
    else p.tw = (p.tw + 1) / 2;
  }
  return V;
}

}  // namespace

extern "C" int frost_depthwise_int8(const void* x, const void* taps, const void* zterm,
                                    const void* scale, const void* bias, void* out, int B,
                                    int H, int W, int C, int m, int kh, int kw, int stride,
                                    int dilation, int ph, int pw, int zp_in, int relu,
                                    float out_mult, float out_zp, float qmin, float qmax,
                                    void* stream) {
  if (C <= 0 || m <= 0 || kh <= 0 || kw <= 0 || stride <= 0 || dilation <= 0 || ph < 0 ||
      pw < 0 || B < 0 || B > 65535)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.x = static_cast<const uint8_t*>(x);
  p.taps = static_cast<const int8_t*>(taps);
  p.zterm = static_cast<const int32_t*>(zterm);
  p.scale = static_cast<const float*>(scale);
  p.bias = static_cast<const float*>(bias);
  p.out = static_cast<uint8_t*>(out);
  p.H = H, p.W = W, p.C = C, p.m = m, p.Cout = C * m;
  p.kh = kh, p.kw = kw, p.s = stride, p.d = dilation, p.ph = ph, p.pw = pw;
  const int span_h = H + 2 * ph - dilation * (kh - 1) - 1;
  const int span_w = W + 2 * pw - dilation * (kw - 1) - 1;
  if (H <= 0 || W <= 0 || span_h < 0 || span_w < 0) return (int)cudaErrorInvalidValue;
  p.Ho = span_h / stride + 1, p.Wo = span_w / stride + 1;
  if (B == 0) return (int)cudaSuccess;
  p.zp = zp_in, p.relu = relu;
  p.out_mult = out_mult, p.out_zp = out_zp, p.qmin = qmin, p.qmax = qmax;

  // 32-bit words of codes where m = 1 and C, x and out allow; smaller slabs
  // only where a one-pixel tile's halo would not fit in shared memory
  const bool word = m == 1 && C % 4 == 0 && (size_t)x % 4 == 0 && (size_t)out % 4 == 0;
  int V = 1;
  for (int cap = kSlabWords; cap >= 1; cap /= 2) {
    V = plan(p, cap, word, (size_t)x);
    if (smem_bytes(p) <= kMaxSmem) break;
  }
  const int smem = smem_bytes(p);
  const int ns = ((p.Cout + 3) / 4 + p.nw - 1) / p.nw;
  if (smem > kMaxSmem || ns > 65535) return (int)cudaErrorInvalidValue;
  p.tiles_w = (p.Wo + p.tw - 1) / p.tw;
  const long tiles = (long)p.tiles_w * ((p.Ho + p.th - 1) / p.th);
  if (tiles > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)tiles, ns, B);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (word) {
    err = V == 16 ? launch<16, true>(p, grid, smem, st)
        : V == 8  ? launch<8, true>(p, grid, smem, st)
                  : launch<4, true>(p, grid, smem, st);
  } else {
    err = V == 16 ? launch<16, false>(p, grid, smem, st)
        : V == 8  ? launch<8, false>(p, grid, smem, st)
        : V == 4  ? launch<4, false>(p, grid, smem, st)
                  : launch<1, false>(p, grid, smem, st);
  }
  return (int)err;
}

extern "C" const char* frost_depthwise_int8_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
