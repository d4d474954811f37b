// Bilinear resize of NHWC maps with the rounding of the frozen JAX graph,
// both passes in one launch.
//
// Added, not ported: no TPU kernel does this work. The JAX package resizes
// with two float32 einsums against host-built interpolation matrices
// (frostnet_tpu/ops/resize.py), and the port ran each pass as torch ops
// (ops/resize.py::_interp: two gathers, the products and, where XLA fuses,
// a float64 emulation of the float32 FMA; 42-65 launches a resize and a
// blocking copy of the tap tables from the host at each pass). It computes
//   t[b, oy, ix, c]  = lerp_H(wh_lo[oy], x[b, lo_h[oy], ix, c], wh_hi[oy], x[b, hi_h[oy], ix, c])
//   out[b, oy, ox, c] = lerp_W(ww_lo[ox], t[b, oy, lo_w[ox], c], ww_hi[ox], t[b, oy, hi_w[ox], c])
// where each pass rounds as XLA's CPU dot does at that pass's output side
// (ops/resize.py): a multiple of 64 gives fma(w_hi, x_hi, w_lo * x_lo), any
// other side w_lo * x_lo + w_hi * x_hi, each product rounded. t is rounded
// to float32 before the W pass, as between the two einsums, so fusing the
// passes moves no bit. The hardware FMA is the operation that
// ops/requant.py::fma_f32 emulates in float64; that emulation returns +0
// for an exact zero sum, so the fused form adds +0 after the FMA (it maps
// -0 to +0 and leaves every other value as it is). The taps (lo, hi and
// the float32 weights of each output row and column) come from the same
// host function as the plain path's and stay on the card between calls.
//
// What bounds it on an H100: bytes written. The segmentation tail resizes
// (8, 64, 128, 19) to 512x1024: 5 MB read, 319 MB written, three operations
// an output; the least time is the input read once and the output written
// once at 3.35 TB/s.
//
// The design: a block owns one output row of one image, or a tile of its
// columns where the row's input span would not fit in shared memory. It
// forms the H pass of the input columns its tile reads (W_in x C floats,
// 9.7 KB for the tail) once in shared memory, beside the tile's column taps
// (the two line offsets and the two weights), then streams the contiguous
// output row: each thread writes 4 consecutive values with one 16-byte
// store. Where C is a multiple of 4 the four share one column and one
// 16-byte shared-memory read a tap; otherwise each value reads its own
// column's taps (an upsampled row's neighbours read the same few words,
// which the shared memory broadcasts). Where the row's length is not a
// multiple of 4 values, each thread stores its values one by one.
// Consecutive blocks read the same input rows, so the input comes from L2
// after its first read. It reads and writes float32; the wrapper converts
// other dtypes, as the plain path does.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSmem = 48 * 1024;

struct Params {
  const float* x;
  float* out;
  const int32_t* th;  // (4, Ho): lo, hi, bits of w_lo, bits of w_hi
  const int32_t* tw;  // (4, Wo)
  int H, W, C, Ho, Wo;
  int tile;           // output columns a block
  int fuse_h, fuse_w;
};

__device__ __forceinline__ float lerp(float wl, float xl, float wh, float xh, bool fused) {
  if (fused) return __fadd_rn(__fmaf_rn(wh, xh, __fmul_rn(wl, xl)), 0.0f);
  return __fadd_rn(__fmul_rn(wl, xl), __fmul_rn(wh, xh));
}

// kC4: C % 4 == 0 (a thread's 4 values share a column); kVec: 4 values a
// store (the tile's values and the output's start a multiple of 4 values)
template <bool kC4, bool kVec>
__global__ void __launch_bounds__(kThreads) resize_bilinear_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int row = blockIdx.x;  // b * Ho + oy
  const int b = row / p.Ho, oy = row - b * p.Ho;
  const int ox0 = blockIdx.y * p.tile;
  const int nx = min(p.tile, p.Wo - ox0);
  const int C = p.C;
  // the input columns the tile reads: taps never decrease along a row
  const int col0 = p.tw[ox0];
  const int span = p.tw[p.Wo + ox0 + nx - 1] - col0 + 1;
  int2* tap = reinterpret_cast<int2*>(smem);                 // line offsets of lo, hi
  float2* wts = reinterpret_cast<float2*>(smem + 8 * nx);    // w_lo, w_hi
  float* line = reinterpret_cast<float*>(smem + 16 * nx);    // span x C, 16-byte aligned
  for (int i = threadIdx.x; i < nx; i += kThreads) {
    const int o = ox0 + i;
    tap[i] = make_int2((p.tw[o] - col0) * C, (p.tw[p.Wo + o] - col0) * C);
    wts[i] = make_float2(__int_as_float(p.tw[2 * p.Wo + o]), __int_as_float(p.tw[3 * p.Wo + o]));
  }

  // H pass: the tile's input columns of row oy, in float32
  {
    const size_t row_len = (size_t)p.W * C;
    const size_t first = (size_t)b * p.H;
    const float* xl = p.x + (first + p.th[oy]) * row_len + (size_t)col0 * C;
    const float* xh = p.x + (first + p.th[p.Ho + oy]) * row_len + (size_t)col0 * C;
    const float wl = __int_as_float(p.th[2 * p.Ho + oy]);
    const float wh = __int_as_float(p.th[3 * p.Ho + oy]);
    const bool fused = p.fuse_h;
    const int n = span * C;
    // four independent loads of each row in flight a thread
    for (int i0 = threadIdx.x; i0 < n; i0 += 4 * kThreads) {
      float a[4], h[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int i = i0 + k * kThreads;
        a[k] = i < n ? xl[i] : 0.0f;
        h[k] = i < n ? xh[i] : 0.0f;
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int i = i0 + k * kThreads;
        if (i < n) line[i] = lerp(wl, a[k], wh, h[k], fused);
      }
    }
  }
  __syncthreads();

  // W pass: the tile's nx x C output values, contiguous in the output
  float* out = p.out + ((size_t)row * p.Wo + ox0) * C;
  const bool fused = p.fuse_w;
  const int n = nx * C;
  if (kC4) {
    const int c4 = C >> 2;
    int ox = threadIdx.x / c4, c = threadIdx.x - ox * c4;
    const int dox = kThreads / c4, dc = kThreads - dox * c4;
    for (int g = threadIdx.x; 4 * g < n; g += kThreads) {
      const int2 t = tap[ox];
      const float2 w = wts[ox];
      const float4 a = *reinterpret_cast<const float4*>(line + t.x + 4 * c);
      const float4 h = *reinterpret_cast<const float4*>(line + t.y + 4 * c);
      *reinterpret_cast<float4*>(out + 4 * g) =
          make_float4(lerp(w.x, a.x, w.y, h.x, fused), lerp(w.x, a.y, w.y, h.y, fused),
                      lerp(w.x, a.z, w.y, h.z, fused), lerp(w.x, a.w, w.y, h.w, fused));
      c += dc;
      ox += dox;
      if (c >= c4) c -= c4, ++ox;
    }
  } else {
    const int j0 = 4 * threadIdx.x;
    int ox = j0 / C, c = j0 - ox * C;
    const int dox = 4 * kThreads / C, dc = 4 * kThreads - dox * C;
    for (int j = j0; j < n; j += 4 * kThreads) {
      float v[4];
      int o = ox, k = c;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (kVec || j + e < n) {
          const int2 t = tap[o];
          const float2 w = wts[o];
          v[e] = lerp(w.x, line[t.x + k], w.y, line[t.y + k], fused);
        }
        if (++k == C) k = 0, ++o;
      }
      if (kVec) {
        *reinterpret_cast<float4*>(out + j) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (j + e < n) out[j + e] = v[e];
      }
      c += dc;
      ox += dox;
      if (c >= C) c -= C, ++ox;
    }
  }
}

}  // namespace

// x, out: float32 NHWC. th, tw: the (4, Ho) and (4, Wo) int32 tap tables.
// tile: output columns a block, smem: the bytes its largest tile needs (16
// a column and 4 a value of its input span, worked out by the caller from
// the same tables).
extern "C" int frost_resize_bilinear(const void* x, void* out, const void* th, const void* tw,
                                     int B, int H, int W, int C, int Ho, int Wo, int tile,
                                     int smem, int fuse_h, int fuse_w, void* stream) {
  if (B < 0 || H <= 0 || W <= 0 || C <= 0 || Ho <= 0 || Wo <= 0 || tile <= 0 || smem <= 0 ||
      smem > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  const long rows = (long)B * Ho, tiles = (Wo + (long)tile - 1) / tile;
  if (rows > 0x7fffffffL || tiles > 65535) return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaSuccess;
  Params p;
  p.x = static_cast<const float*>(x), p.out = static_cast<float*>(out);
  p.th = static_cast<const int32_t*>(th), p.tw = static_cast<const int32_t*>(tw);
  p.H = H, p.W = W, p.C = C, p.Ho = Ho, p.Wo = Wo, p.tile = tile;
  p.fuse_h = fuse_h, p.fuse_w = fuse_w;
  const bool vec = ((long)Wo * C) % 4 == 0 && ((long)tile * C) % 4 == 0 && (size_t)out % 16 == 0;
  const dim3 grid((unsigned)rows, (unsigned)tiles);
  auto st = static_cast<cudaStream_t>(stream);
  if (vec && C % 4 == 0)
    resize_bilinear_kernel<true, true><<<grid, kThreads, smem, st>>>(p);
  else if (vec)
    resize_bilinear_kernel<false, true><<<grid, kThreads, smem, st>>>(p);
  else
    resize_bilinear_kernel<false, false><<<grid, kThreads, smem, st>>>(p);
  return (int)cudaGetLastError();
}

extern "C" const char* frost_resize_bilinear_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
