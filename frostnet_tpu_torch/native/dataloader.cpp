// Native data loader: threaded JPEG/PNG decode + augment + normalize.
//
// A copy of frostnet_tpu/native/dataloader.cpp for the PyTorch port: the
// host-side worker pool that feeds the card (torch's DataLoader worker pool
// in the reference, SURVEY.md §2.6 last row). N worker threads decode images
// with libjpeg/libpng, apply train augmentation, and publish whole batches
// into a bounded ring the Python side drains via ctypes
// (frostnet_tpu_torch/native/__init__.py). Keeping the decode in C++ threads
// sidesteps the GIL so the step on the card never waits on input.
//
// What the copy adds: each pool takes (rank, world), and of each global
// batch of `batch` rows it builds rank r's contiguous block
// [r * batch / world, (r + 1) * batch / world) only, the rows
// frostnet_tpu_torch/parallel/mesh.py::shard_rows gives replica r (JAX's
// shard_batch over a dp mesh). In train mode a worker draws the augmentation
// of the other ranks' rows too, from the image's header alone (its size; no
// pixels decoded), so at threads=1 the ranks' blocks, concatenated, are the
// (0, 1) batch. A file whose header reads but whose pixels fail to decode
// is the one case where that replay and the decode part ways. (rank, world)
// = (0, 1) is the JAX copy's pool, byte for byte.
//
// Classification C ABI (JPEG folders, random-resized-crop + hflip):
//   void* fndl_create(const char** paths, const int* labels, long n,
//                     int batch, int out_hw, int threads, int train,
//                     unsigned seed, int queue_depth,
//                     const float* mean, const float* std, int out_uint8,
//                     int rank, int world);
//   int   fndl_next(void* h, void* images, int* labels);  // 1 ok, 0 end
//   void  fndl_destroy(void* h);
//   long  fndl_batches_per_epoch(void* h);
//
// out_uint8=1 emits raw resized uint8 RGB (4x smaller host->device
// transfers; the train step normalizes on the card,
// frostnet_tpu_torch/train/state.py::prep_image). out_uint8=0 keeps
// normalized f32.
//
// Segmentation C ABI (paired image+mask, the reference's
// data_transforms.py:18-166 pipeline: hflip + scale jitter + pad + crop,
// image bilinear / mask nearest; cityscapes images are PNG, masks are
// grayscale-or-palette PNG whose PIXEL VALUE is the class id):
//   void* fnsl_create(const char** img_paths, const char** mask_paths,
//                     long n, int batch, int crop_h, int crop_w,
//                     int threads, int train, unsigned seed,
//                     int queue_depth, float scale_min, float scale_max,
//                     int ignore_label, int rank, int world);
//   int   fnsl_next(void* h, unsigned char* images, unsigned char* masks);
//   void  fnsl_destroy(void* h);
//   long  fnsl_batches_per_epoch(void* h);
// Images are emitted as raw uint8 RGB (normalize on the card like the
// classification uint8 mode); masks as uint8 class ids. Eval (train=0)
// bilinear-resizes the whole frame to (crop_h, crop_w) — identity at the
// native resolution.
//
// Detection C ABI: fndt_create(..., int queue_depth, int rank, int world),
// fndt_next, fndt_destroy, fndt_batches_per_epoch (below).
//
// Every epoch has the same file order: a pool shuffles with
// mt19937_64(seed), and the Python side makes a new pool with the same seed
// for each pass, as the JAX loader does.

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>
#include <png.h>

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <csetjmp>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <queue>
#include <random>
#include <string>
#include <thread>
#include <vector>

namespace {

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jb;
};

void jpeg_error_exit(j_common_ptr cinfo) {
  JpegErr* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jb, 1);
}

// Decode a JPEG file to RGB8. Returns false on failure.
bool decode_jpeg(const std::string& path, std::vector<unsigned char>& rgb,
                 int* w, int* h) {
  FILE* f = fopen(path.c_str(), "rb");
  if (!f) return false;
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_error_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    fclose(f);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  *w = cinfo.output_width;
  *h = cinfo.output_height;
  rgb.resize(static_cast<size_t>(*w) * *h * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    unsigned char* row = rgb.data() + static_cast<size_t>(cinfo.output_scanline) * *w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  fclose(f);
  return true;
}

// Decode a PNG. for_image=true -> RGB8 (palette/gray expanded, alpha
// stripped, channels=3). for_image=false (mask) -> single channel of raw
// class ids: palette indices are NOT expanded to RGB (VOC-style masks store
// the class in the palette index; cityscapes *TrainIds are 8-bit gray).
bool decode_png(const std::string& path, bool for_image,
                std::vector<unsigned char>& out, int* w, int* h) {
  FILE* f = fopen(path.c_str(), "rb");
  if (!f) return false;
  png_byte sig[8];
  if (fread(sig, 1, 8, f) != 8 || png_sig_cmp(sig, 0, 8)) {
    fclose(f);
    return false;
  }
  // declared BEFORE setjmp: a libpng error longjmps back into the if-block
  // below and we return normally, so these still destruct (objects
  // constructed between setjmp and longjmp would be skipped/leaked)
  std::vector<unsigned char> rows;
  std::vector<png_bytep> rowp;
  png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr,
                                           nullptr, nullptr);
  png_infop info = png ? png_create_info_struct(png) : nullptr;
  if (!png || !info || setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, info ? &info : nullptr, nullptr);
    fclose(f);
    return false;
  }
  png_init_io(png, f);
  png_set_sig_bytes(png, 8);
  png_read_info(png, info);
  png_uint_32 pw = png_get_image_width(png, info);
  png_uint_32 ph = png_get_image_height(png, info);
  int bit_depth = png_get_bit_depth(png, info);
  int color = png_get_color_type(png, info);
  if (for_image) {
    if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
    if (color == PNG_COLOR_TYPE_GRAY && bit_depth < 8)
      png_set_expand_gray_1_2_4_to_8(png);
    if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
    if (color == PNG_COLOR_TYPE_GRAY || color == PNG_COLOR_TYPE_GRAY_ALPHA)
      png_set_gray_to_rgb(png);
    png_set_strip_alpha(png);
  } else {
    // keep palette indices / gray values as-is; just normalize to 8-bit
    if (bit_depth < 8) png_set_packing(png);
    if (color == PNG_COLOR_TYPE_GRAY_ALPHA || color == PNG_COLOR_TYPE_RGB_ALPHA)
      png_set_strip_alpha(png);
  }
  if (bit_depth == 16) png_set_strip_16(png);
  png_read_update_info(png, info);
  int channels = png_get_channels(png, info);
  int want = for_image ? 3 : 1;
  rows.resize(static_cast<size_t>(pw) * ph * channels);
  rowp.resize(ph);
  for (png_uint_32 y = 0; y < ph; ++y)
    rowp[y] = rows.data() + static_cast<size_t>(y) * pw * channels;
  png_read_image(png, rowp.data());
  png_destroy_read_struct(&png, &info, nullptr);
  fclose(f);
  *w = static_cast<int>(pw);
  *h = static_cast<int>(ph);
  if (channels == want) {
    out = std::move(rows);
  } else {
    out.resize(static_cast<size_t>(pw) * ph * want);
    for (size_t p = 0; p < static_cast<size_t>(pw) * ph; ++p)
      for (int c = 0; c < want; ++c)
        out[p * want + c] = rows[p * channels + (channels >= want ? c : 0)];
  }
  return true;
}

// Magic-byte dispatch: PNG or JPEG, to `want_channels` (3 = RGB image,
// 1 = raw mask values).
bool decode_image(const std::string& path, bool for_image,
                  std::vector<unsigned char>& out, int* w, int* h) {
  unsigned char magic[2] = {0, 0};
  FILE* f = fopen(path.c_str(), "rb");
  if (!f) return false;
  size_t got = fread(magic, 1, 2, f);
  fclose(f);
  if (got != 2) return false;
  if (magic[0] == 0x89 && magic[1] == 'P')
    return decode_png(path, for_image, out, w, h);
  if (magic[0] == 0xFF && magic[1] == 0xD8) {
    if (!decode_jpeg(path, out, w, h)) return false;
    if (!for_image) {  // JPEG mask (unusual): take the first channel
      std::vector<unsigned char> one(static_cast<size_t>(*w) * *h);
      for (size_t p = 0; p < one.size(); ++p) one[p] = out[p * 3];
      out = std::move(one);
    }
    return true;
  }
  return false;
}

// The size of a JPEG from its header alone (no pixels decoded).
bool jpeg_dims(const std::string& path, int* w, int* h) {
  FILE* f = fopen(path.c_str(), "rb");
  if (!f) return false;
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_error_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    fclose(f);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  *w = cinfo.image_width;
  *h = cinfo.image_height;
  jpeg_destroy_decompress(&cinfo);
  fclose(f);
  return true;
}

// The size of a PNG from its header alone.
bool png_dims(const std::string& path, int* w, int* h) {
  FILE* f = fopen(path.c_str(), "rb");
  if (!f) return false;
  png_byte sig[8];
  if (fread(sig, 1, 8, f) != 8 || png_sig_cmp(sig, 0, 8)) {
    fclose(f);
    return false;
  }
  png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr,
                                           nullptr, nullptr);
  png_infop info = png ? png_create_info_struct(png) : nullptr;
  if (!png || !info || setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, info ? &info : nullptr, nullptr);
    fclose(f);
    return false;
  }
  png_init_io(png, f);
  png_set_sig_bytes(png, 8);
  png_read_info(png, info);
  *w = static_cast<int>(png_get_image_width(png, info));
  *h = static_cast<int>(png_get_image_height(png, info));
  png_destroy_read_struct(&png, &info, nullptr);
  fclose(f);
  return true;
}

// decode_image's dispatch for the size alone: what a worker needs to draw
// the augmentation of another rank's row.
bool image_dims(const std::string& path, int* w, int* h) {
  unsigned char magic[2] = {0, 0};
  FILE* f = fopen(path.c_str(), "rb");
  if (!f) return false;
  size_t got = fread(magic, 1, 2, f);
  fclose(f);
  if (got != 2) return false;
  if (magic[0] == 0x89 && magic[1] == 'P') return png_dims(path, w, h);
  if (magic[0] == 0xFF && magic[1] == 0xD8) return jpeg_dims(path, w, h);
  return false;
}

// Bilinear sample from an RGB8 crop region into out_hw x out_hw RGB:
// normalized float32 (u8_out=nullptr) or raw uint8 (u8_out set).
void resample_normalize(const unsigned char* src, int sw, int sh,
                        float x0, float y0, float cw, float ch, bool hflip,
                        int out_hw, const float* mean, const float* stdv,
                        float* dst, unsigned char* u8_out) {
  for (int oy = 0; oy < out_hw; ++oy) {
    float sy = y0 + (oy + 0.5f) * ch / out_hw - 0.5f;
    if (sy < 0) sy = 0;
    if (sy > sh - 1) sy = static_cast<float>(sh - 1);
    int iy = static_cast<int>(sy);
    int iy1 = iy + 1 < sh ? iy + 1 : sh - 1;
    float fy = sy - iy;
    for (int ox = 0; ox < out_hw; ++ox) {
      int oxx = hflip ? (out_hw - 1 - ox) : ox;
      float sx = x0 + (oxx + 0.5f) * cw / out_hw - 0.5f;
      if (sx < 0) sx = 0;
      if (sx > sw - 1) sx = static_cast<float>(sw - 1);
      int ix = static_cast<int>(sx);
      int ix1 = ix + 1 < sw ? ix + 1 : sw - 1;
      float fx = sx - ix;
      const unsigned char* p00 = src + (static_cast<size_t>(iy) * sw + ix) * 3;
      const unsigned char* p01 = src + (static_cast<size_t>(iy) * sw + ix1) * 3;
      const unsigned char* p10 = src + (static_cast<size_t>(iy1) * sw + ix) * 3;
      const unsigned char* p11 = src + (static_cast<size_t>(iy1) * sw + ix1) * 3;
      size_t off = (static_cast<size_t>(oy) * out_hw + ox) * 3;
      for (int c = 0; c < 3; ++c) {
        float v = (1 - fy) * ((1 - fx) * p00[c] + fx * p01[c]) +
                  fy * ((1 - fx) * p10[c] + fx * p11[c]);
        if (u8_out) {
          float r = v + 0.5f;
          u8_out[off + c] = static_cast<unsigned char>(
              r < 0 ? 0 : (r > 255 ? 255 : r));
        } else {
          dst[off + c] = (v / 255.0f - mean[c]) / stdv[c];
        }
      }
    }
  }
}

struct Batch {
  std::vector<unsigned char> images;  // raw bytes: f32 or u8 elements
  std::vector<int> labels;
};

struct Loader {
  std::vector<std::string> paths;
  std::vector<int> labels;
  int batch, out_hw, threads, queue_depth;
  int rank = 0, world = 1;  // this pool builds rows [rank * rows, (rank + 1) * rows)
  bool train;
  bool out_uint8 = false;
  unsigned seed;
  float mean[3], stdv[3];

  std::vector<std::thread> workers;
  std::mutex mu;
  std::condition_variable cv_put, cv_get;
  std::queue<Batch> ready;
  std::atomic<long> next_batch{0};
  long delivered = 0;  // batches handed to the consumer; guarded by mu
  long total_batches = 0;
  std::atomic<bool> stop{false};
  std::vector<long> order;

  void worker_main(int wid) {
    std::mt19937 rng(seed * 9176 + wid);
    std::uniform_real_distribution<float> u01(0.f, 1.f);
    while (!stop.load()) {
      long b = next_batch.fetch_add(1);
      if (b >= total_batches) break;
      Batch out;
      const size_t px = static_cast<size_t>(out_hw) * out_hw * 3;
      const size_t elt = out_uint8 ? 1 : sizeof(float);
      const int rows = batch / world, lo = rank * rows;
      out.images.resize(static_cast<size_t>(rows) * px * elt);
      out.labels.resize(rows);
      for (int i = 0; i < batch; ++i) {
        long idx = order[(b * batch + i) % static_cast<long>(paths.size())];
        std::vector<unsigned char> rgb;
        int w = 0, h = 0;
        if (i < lo || i >= lo + rows) {  // another rank's row: its draws only
          if (train && jpeg_dims(paths[idx], &w, &h) && w >= 2 && h >= 2)
            for (int k = 0; k < 4; ++k) u01(rng);
          continue;
        }
        out.labels[i - lo] = labels[idx];
        unsigned char* raw = out.images.data() + static_cast<size_t>(i - lo) * px * elt;
        float* dst_f = out_uint8 ? nullptr : reinterpret_cast<float*>(raw);
        unsigned char* dst_u8 = out_uint8 ? raw : nullptr;
        if (!decode_jpeg(paths[idx], rgb, &w, &h) || w < 2 || h < 2) {
          std::memset(raw, 0, px * elt);
          continue;
        }
        if (train) {
          float scale = 0.7f + 0.3f * u01(rng);  // RandomResizedCrop-style
          float cw = w * scale, ch = h * scale;
          float x0 = u01(rng) * (w - cw);
          float y0 = u01(rng) * (h - ch);
          bool flip = u01(rng) < 0.5f;
          resample_normalize(rgb.data(), w, h, x0, y0, cw, ch, flip,
                             out_hw, mean, stdv, dst_f, dst_u8);
        } else {
          float side = static_cast<float>(w < h ? w : h) / 1.14f;  // resize+center crop
          float x0 = (w - side) / 2, y0 = (h - side) / 2;
          resample_normalize(rgb.data(), w, h, x0, y0, side, side, false,
                             out_hw, mean, stdv, dst_f, dst_u8);
        }
      }
      std::unique_lock<std::mutex> lk(mu);
      cv_put.wait(lk, [&] { return static_cast<int>(ready.size()) < queue_depth || stop.load(); });
      if (stop.load()) break;
      ready.push(std::move(out));
      cv_get.notify_one();
    }
    std::unique_lock<std::mutex> lk(mu);
    cv_get.notify_all();
  }
};

// --------------------------------------------------------------------------
// Paired segmentation pipeline (image bilinear / mask nearest, synchronized
// flip+scale+pad+crop; reference data_transforms.py:18-166 semantics).
// Samples the virtual "scaled to (nh,nw), padded, cropped at (y0,x0)" frame
// directly from the decoded source — the scaled image is never materialized.
// --------------------------------------------------------------------------
void sample_pair(const unsigned char* img, const unsigned char* mask,
                 int w, int h, int nh, int nw, int y0, int x0, bool flip,
                 int crop_h, int crop_w, unsigned char ignore,
                 unsigned char* img_out, unsigned char* mask_out) {
  for (int oy = 0; oy < crop_h; ++oy) {
    int ys = y0 + oy;
    for (int ox = 0; ox < crop_w; ++ox) {
      int xs = x0 + ox;
      size_t off = (static_cast<size_t>(oy) * crop_w + ox);
      if (ys >= nh || xs >= nw) {  // bottom/right pad region
        img_out[off * 3] = img_out[off * 3 + 1] = img_out[off * 3 + 2] = 0;
        mask_out[off] = ignore;
        continue;
      }
      // PIL-style center-aligned sampling from the unscaled source
      float sy = (ys + 0.5f) * h / nh - 0.5f;
      float sx = (xs + 0.5f) * w / nw - 0.5f;
      if (sy < 0) sy = 0;
      if (sy > h - 1) sy = static_cast<float>(h - 1);
      if (sx < 0) sx = 0;
      if (sx > w - 1) sx = static_cast<float>(w - 1);
      int iy = static_cast<int>(sy), ix = static_cast<int>(sx);
      int iy1 = iy + 1 < h ? iy + 1 : h - 1;
      int ix1 = ix + 1 < w ? ix + 1 : w - 1;
      float fy = sy - iy, fx = sx - ix;
      int cx = ix, cx1 = ix1;
      if (flip) {  // flip-then-scale == sample mirrored source columns
        cx = w - 1 - ix;
        cx1 = w - 1 - ix1;
      }
      const unsigned char* p00 = img + (static_cast<size_t>(iy) * w + cx) * 3;
      const unsigned char* p01 = img + (static_cast<size_t>(iy) * w + cx1) * 3;
      const unsigned char* p10 = img + (static_cast<size_t>(iy1) * w + cx) * 3;
      const unsigned char* p11 = img + (static_cast<size_t>(iy1) * w + cx1) * 3;
      for (int c = 0; c < 3; ++c) {
        float v = (1 - fy) * ((1 - fx) * p00[c] + fx * p01[c]) +
                  fy * ((1 - fx) * p10[c] + fx * p11[c]);
        float r = v + 0.5f;
        img_out[off * 3 + c] =
            static_cast<unsigned char>(r < 0 ? 0 : (r > 255 ? 255 : r));
      }
      // nearest for the mask (class ids must never blend)
      int my = static_cast<int>((ys + 0.5f) * h / nh);
      int mx = static_cast<int>((xs + 0.5f) * w / nw);
      if (my > h - 1) my = h - 1;
      if (mx > w - 1) mx = w - 1;
      if (flip) mx = w - 1 - mx;
      mask_out[off] = mask[static_cast<size_t>(my) * w + mx];
    }
  }
}

struct SegBatch {
  std::vector<unsigned char> images;  // (B, crop_h, crop_w, 3) u8
  std::vector<unsigned char> masks;   // (B, crop_h, crop_w) u8 class ids
};

// The train-mode crop of one segmentation row: scale, then the crop's corner
// in the scaled and padded frame, then the flip.
struct SegCrop {
  int nh, nw, y0, x0;
  bool flip;
};

SegCrop seg_crop(int w, int h, int crop_h, int crop_w, float scale_min,
                 float scale_max, std::mt19937& rng) {
  std::uniform_real_distribution<float> u01(0.f, 1.f);
  float s = scale_min + (scale_max - scale_min) * u01(rng);
  int nh = static_cast<int>(h * s), nw = static_cast<int>(w * s);
  if (nh < 1) nh = 1;
  if (nw < 1) nw = 1;
  // pad bottom/right to at least the crop (image 0, mask ignore)
  int span_h = nh > crop_h ? nh - crop_h : 0;
  int span_w = nw > crop_w ? nw - crop_w : 0;
  int y0 = span_h ? static_cast<int>(u01(rng) * (span_h + 1)) : 0;
  int x0 = span_w ? static_cast<int>(u01(rng) * (span_w + 1)) : 0;
  if (y0 > span_h) y0 = span_h;
  if (x0 > span_w) x0 = span_w;
  bool flip = u01(rng) < 0.5f;
  return SegCrop{nh, nw, y0, x0, flip};
}

struct SegLoader {
  std::vector<std::string> img_paths, mask_paths;
  int batch, crop_h, crop_w, threads, queue_depth;
  int rank = 0, world = 1;  // this pool builds rows [rank * rows, (rank + 1) * rows)
  bool train;
  unsigned seed;
  float scale_min, scale_max;
  unsigned char ignore;

  std::vector<std::thread> workers;
  std::mutex mu;
  std::condition_variable cv_put, cv_get;
  std::queue<SegBatch> ready;
  std::atomic<long> next_batch{0};
  long delivered = 0;
  long total_batches = 0;
  std::atomic<bool> stop{false};
  std::vector<long> order;

  void worker_main(int wid) {
    std::mt19937 rng(seed * 9176 + wid);
    const size_t px = static_cast<size_t>(crop_h) * crop_w;
    const int rows = batch / world, lo = rank * rows;
    while (!stop.load()) {
      long b = next_batch.fetch_add(1);
      if (b >= total_batches) break;
      SegBatch out;
      out.images.resize(static_cast<size_t>(rows) * px * 3);
      out.masks.resize(static_cast<size_t>(rows) * px);
      for (int i = 0; i < batch; ++i) {
        long idx = order[(b * batch + i) % static_cast<long>(img_paths.size())];
        int w = 0, h = 0, mw = 0, mh = 0;
        if (i < lo || i >= lo + rows) {  // another rank's row: its draws only
          if (train && image_dims(img_paths[idx], &w, &h) &&
              image_dims(mask_paths[idx], &mw, &mh) && mw == w && mh == h &&
              w >= 2 && h >= 2)
            seg_crop(w, h, crop_h, crop_w, scale_min, scale_max, rng);
          continue;
        }
        unsigned char* img_dst = out.images.data() + static_cast<size_t>(i - lo) * px * 3;
        unsigned char* mask_dst = out.masks.data() + static_cast<size_t>(i - lo) * px;
        std::vector<unsigned char> img, mask;
        if (!decode_image(img_paths[idx], true, img, &w, &h) ||
            !decode_image(mask_paths[idx], false, mask, &mw, &mh) ||
            mw != w || mh != h || w < 2 || h < 2) {
          std::memset(img_dst, 0, px * 3);
          std::memset(mask_dst, ignore, px);
          continue;
        }
        if (train) {
          const SegCrop c = seg_crop(w, h, crop_h, crop_w, scale_min, scale_max, rng);
          sample_pair(img.data(), mask.data(), w, h, c.nh, c.nw, c.y0, c.x0, c.flip,
                      crop_h, crop_w, ignore, img_dst, mask_dst);
        } else {
          // whole-frame resize to the output shape (identity at native res)
          sample_pair(img.data(), mask.data(), w, h, crop_h, crop_w, 0, 0,
                      false, crop_h, crop_w, ignore, img_dst, mask_dst);
        }
      }
      std::unique_lock<std::mutex> lk(mu);
      cv_put.wait(lk, [&] { return static_cast<int>(ready.size()) < queue_depth || stop.load(); });
      if (stop.load()) break;
      ready.push(std::move(out));
      cv_get.notify_one();
    }
    std::unique_lock<std::mutex> lk(mu);
    cv_get.notify_all();
  }
};

// --------------------------------------------------------------------------
// Detection pipeline (the SSD augmentation of detection/data.py ssd_augment,
// itself mirroring Object_Detection/utils/augmentations.py): photometric
// distort -> expand (mean fill) -> IoU-constrained random crop -> mirror ->
// squash-resize to out_hw. XML parsing stays on the Python side; boxes come
// in pre-parsed (pixel xyxy). Output: uint8 RGB (the BGR flip + mean
// subtraction runs on device), boxes normalized to the final frame, padded
// to max_boxes with a count.
// --------------------------------------------------------------------------

void rgb_to_hsv_px(float r, float g, float b, float* h, float* s, float* v) {
  float mx = std::max(r, std::max(g, b));
  float mn = std::min(r, std::min(g, b));
  float d = mx - mn;
  *v = mx;
  *s = mx > 0 ? d / mx : 0.f;
  if (d <= 0) {
    *h = 0;
  } else if (mx == r) {
    *h = std::fmod(60.f * ((g - b) / d) + 360.f, 360.f);
  } else if (mx == g) {
    *h = 60.f * ((b - r) / d) + 120.f;
  } else {
    *h = 60.f * ((r - g) / d) + 240.f;
  }
}

void hsv_to_rgb_px(float h, float s, float v, float* r, float* g, float* b) {
  h = std::fmod(std::fmod(h, 360.f) + 360.f, 360.f);
  s = std::min(std::max(s, 0.f), 1.f);
  float c = v * s;
  float x = c * (1.f - std::fabs(std::fmod(h / 60.f, 2.f) - 1.f));
  float m = v - c;
  float rr = 0, gg = 0, bb = 0;
  if (h < 60) {
    rr = c; gg = x;
  } else if (h < 120) {
    rr = x; gg = c;
  } else if (h < 180) {
    gg = c; bb = x;
  } else if (h < 240) {
    gg = x; bb = c;
  } else if (h < 300) {
    rr = x; bb = c;
  } else {
    rr = c; bb = x;
  }
  *r = rr + m;
  *g = gg + m;
  *b = bb + m;
}

struct DetItem {
  std::vector<float> img;  // HWC float RGB 0..255
  int w = 0, h = 0;
  std::vector<float> boxes;  // xyxy pixels
  std::vector<int> labels;
};

void det_photometric(DetItem& it, std::mt19937& rng) {
  std::uniform_real_distribution<float> u01(0.f, 1.f);
  auto coin = [&] { return u01(rng) < 0.5f; };
  size_t n = it.img.size();
  if (coin()) {  // RandomBrightness(32)
    float d = -32.f + 64.f * u01(rng);
    for (size_t i = 0; i < n; ++i) it.img[i] += d;
  }
  bool sathue_first = !coin();  // distort order
  auto contrast = [&] {
    if (coin()) {
      float a = 0.5f + u01(rng);
      for (size_t i = 0; i < n; ++i) it.img[i] *= a;
    }
  };
  auto sat_hue = [&] {
    bool do_s = coin();
    float sa = 0.5f + u01(rng);
    bool do_h = coin();
    float hd = -18.f + 36.f * u01(rng);
    if (!do_s && !do_h) return;
    for (size_t p = 0; p < n; p += 3) {
      float r = std::min(std::max(it.img[p], 0.f), 255.f);
      float g = std::min(std::max(it.img[p + 1], 0.f), 255.f);
      float b = std::min(std::max(it.img[p + 2], 0.f), 255.f);
      float h, s, v;
      rgb_to_hsv_px(r, g, b, &h, &s, &v);
      if (do_s) s *= sa;
      if (do_h) h += hd;
      hsv_to_rgb_px(h, s, v, &it.img[p], &it.img[p + 1], &it.img[p + 2]);
    }
  };
  if (sathue_first) {
    sat_hue();
    contrast();
  } else {
    contrast();
    sat_hue();
  }
  if (coin()) {  // RandomLightingNoise: random channel permutation
    int perm[3] = {0, 1, 2};
    std::shuffle(perm, perm + 3, rng);
    for (size_t p = 0; p < n; p += 3) {
      float v[3] = {it.img[p], it.img[p + 1], it.img[p + 2]};
      it.img[p] = v[perm[0]];
      it.img[p + 1] = v[perm[1]];
      it.img[p + 2] = v[perm[2]];
    }
  }
  for (size_t i = 0; i < n; ++i)
    it.img[i] = std::min(std::max(it.img[i], 0.f), 255.f);
}

void det_expand(DetItem& it, const float* means, std::mt19937& rng) {
  std::uniform_real_distribution<float> u01(0.f, 1.f);
  if (u01(rng) < 0.5f) return;
  float ratio = 1.f + 3.f * u01(rng);
  int nw = static_cast<int>(it.w * ratio), nh = static_cast<int>(it.h * ratio);
  int left = static_cast<int>(u01(rng) * (it.w * ratio - it.w));
  int top = static_cast<int>(u01(rng) * (it.h * ratio - it.h));
  if (!it.img.empty()) {  // no pixels: another rank's row, its geometry only
    std::vector<float> out(static_cast<size_t>(nw) * nh * 3);
    for (size_t p = 0; p < out.size(); p += 3) {
      out[p] = means[0];
      out[p + 1] = means[1];
      out[p + 2] = means[2];
    }
    for (int y = 0; y < it.h; ++y)
      std::memcpy(out.data() + (static_cast<size_t>(top + y) * nw + left) * 3,
                  it.img.data() + static_cast<size_t>(y) * it.w * 3,
                  sizeof(float) * it.w * 3);
    it.img = std::move(out);
  }
  for (size_t b = 0; b < it.boxes.size(); b += 4) {
    it.boxes[b] += left;
    it.boxes[b + 2] += left;
    it.boxes[b + 1] += top;
    it.boxes[b + 3] += top;
  }
  it.w = nw;
  it.h = nh;
}

void det_random_crop(DetItem& it, std::mt19937& rng) {
  // the reference's IoU reject condition is inert (the ssd.pytorch
  // 'and'-for-'or' bug; see detection/data.py _random_crop) — the
  // effective rule is center-in-crop, mirrored here
  std::uniform_real_distribution<float> u01(0.f, 1.f);
  for (int trial = 0; trial < 20; ++trial) {
    int mode = static_cast<int>(u01(rng) * 6);
    if (mode >= 6) mode = 5;
    if (mode == 0) return;  // keep whole image
    float cw = (0.3f + 0.7f * u01(rng)) * it.w;
    float ch = (0.3f + 0.7f * u01(rng)) * it.h;
    float ar = cw / ch;
    if (ar < 0.5f || ar > 2.f) continue;
    float x0 = u01(rng) * (it.w - cw);
    float y0 = u01(rng) * (it.h - ch);
    // keep boxes whose centers fall inside the crop
    std::vector<float> nb;
    std::vector<int> nl;
    for (size_t b = 0; b < it.boxes.size(); b += 4) {
      float cx = (it.boxes[b] + it.boxes[b + 2]) / 2;
      float cy = (it.boxes[b + 1] + it.boxes[b + 3]) / 2;
      if (cx > x0 && cx < x0 + cw && cy > y0 && cy < y0 + ch) {
        nb.push_back(std::max(it.boxes[b], x0) - x0);
        nb.push_back(std::max(it.boxes[b + 1], y0) - y0);
        nb.push_back(std::min(it.boxes[b + 2], x0 + cw) - x0);
        nb.push_back(std::min(it.boxes[b + 3], y0 + ch) - y0);
        nl.push_back(it.labels[b / 4]);
      }
    }
    if (nb.empty()) continue;
    // materialize the crop
    int ix0 = static_cast<int>(x0), iy0 = static_cast<int>(y0);
    int icw = static_cast<int>(cw), ich = static_cast<int>(ch);
    if (icw < 1 || ich < 1) continue;
    if (!it.img.empty()) {  // no pixels: another rank's row, its geometry only
      std::vector<float> out(static_cast<size_t>(icw) * ich * 3);
      for (int y = 0; y < ich; ++y)
        std::memcpy(out.data() + static_cast<size_t>(y) * icw * 3,
                    it.img.data() + (static_cast<size_t>(iy0 + y) * it.w + ix0) * 3,
                    sizeof(float) * icw * 3);
      it.img = std::move(out);
    }
    it.w = icw;
    it.h = ich;
    it.boxes = std::move(nb);
    it.labels = std::move(nl);
    return;
  }
}

// squash-resize the float canvas to out_hw x out_hw uint8 RGB (bilinear),
// with optional horizontal mirror
void det_resize_out(const DetItem& it, int out_hw, bool mirror,
                    unsigned char* dst) {
  for (int oy = 0; oy < out_hw; ++oy) {
    float sy = (oy + 0.5f) * it.h / out_hw - 0.5f;
    sy = std::min(std::max(sy, 0.f), static_cast<float>(it.h - 1));
    int iy = static_cast<int>(sy);
    int iy1 = std::min(iy + 1, it.h - 1);
    float fy = sy - iy;
    for (int ox = 0; ox < out_hw; ++ox) {
      int oxx = mirror ? out_hw - 1 - ox : ox;
      float sx = (oxx + 0.5f) * it.w / out_hw - 0.5f;
      sx = std::min(std::max(sx, 0.f), static_cast<float>(it.w - 1));
      int ix = static_cast<int>(sx);
      int ix1 = std::min(ix + 1, it.w - 1);
      float fx = sx - ix;
      const float* p00 = it.img.data() + (static_cast<size_t>(iy) * it.w + ix) * 3;
      const float* p01 = it.img.data() + (static_cast<size_t>(iy) * it.w + ix1) * 3;
      const float* p10 = it.img.data() + (static_cast<size_t>(iy1) * it.w + ix) * 3;
      const float* p11 = it.img.data() + (static_cast<size_t>(iy1) * it.w + ix1) * 3;
      size_t off = (static_cast<size_t>(oy) * out_hw + ox) * 3;
      for (int c = 0; c < 3; ++c) {
        float v = (1 - fy) * ((1 - fx) * p00[c] + fx * p01[c]) +
                  fy * ((1 - fx) * p10[c] + fx * p11[c]);
        v = std::min(std::max(v + 0.5f, 0.f), 255.f);
        dst[off + c] = static_cast<unsigned char>(v);
      }
    }
  }
}

struct DetBatch {
  std::vector<unsigned char> images;  // (B, s, s, 3) u8
  std::vector<float> boxes;           // (B, max_boxes, 4) normalized xyxy
  std::vector<int> labels;            // (B, max_boxes)
  std::vector<int> counts;            // (B,)
};

struct DetLoader {
  std::vector<std::string> paths;
  std::vector<std::vector<float>> boxes;  // per-image xyxy pixels
  std::vector<std::vector<int>> labels;
  int max_boxes, batch, out_hw, threads, queue_depth;
  int rank = 0, world = 1;  // this pool builds rows [rank * rows, (rank + 1) * rows)
  bool train;
  unsigned seed;
  float means[3] = {123.f, 117.f, 104.f};  // RGB order of the BGR means

  std::vector<std::thread> workers;
  std::mutex mu;
  std::condition_variable cv_put, cv_get;
  std::queue<DetBatch> ready;
  std::atomic<long> next_batch{0};
  long delivered = 0;
  long total_batches = 0;
  std::atomic<bool> stop{false};
  std::vector<long> order;

  void worker_main(int wid) {
    std::mt19937 rng(seed * 9176 + wid);
    std::uniform_real_distribution<float> u01(0.f, 1.f);
    const size_t px = static_cast<size_t>(out_hw) * out_hw;
    const int rows = batch / world, lo = rank * rows;
    while (!stop.load()) {
      long b = next_batch.fetch_add(1);
      if (b >= total_batches) break;
      DetBatch out;
      out.images.assign(static_cast<size_t>(rows) * px * 3, 0);
      out.boxes.assign(static_cast<size_t>(rows) * max_boxes * 4, 0.f);
      out.labels.assign(static_cast<size_t>(rows) * max_boxes, 0);
      out.counts.assign(rows, 0);
      for (int row = 0; row < batch; ++row) {
        long idx = order[(b * batch + row) % static_cast<long>(paths.size())];
        std::vector<unsigned char> rgb;
        DetItem it;
        if (row < lo || row >= lo + rows) {  // another rank's row: its draws only
          if (train && !boxes[idx].empty() && image_dims(paths[idx], &it.w, &it.h) &&
              it.w >= 2 && it.h >= 2) {
            it.boxes = boxes[idx];
            it.labels = labels[idx];
            det_photometric(it, rng);
            det_expand(it, means, rng);
            det_random_crop(it, rng);
            u01(rng);  // the mirror
          }
          continue;
        }
        const int i = row - lo;
        if (!decode_image(paths[idx], true, rgb, &it.w, &it.h) ||
            it.w < 2 || it.h < 2)
          continue;  // zero image, zero boxes
        it.img.resize(rgb.size());
        for (size_t p = 0; p < rgb.size(); ++p)
          it.img[p] = static_cast<float>(rgb[p]);
        it.boxes = boxes[idx];
        it.labels = labels[idx];
        bool mirror = false;
        if (train && !it.boxes.empty()) {
          det_photometric(it, rng);
          det_expand(it, means, rng);
          det_random_crop(it, rng);
          mirror = u01(rng) < 0.5f;
        }
        det_resize_out(it, out_hw, mirror,
                       out.images.data() + static_cast<size_t>(i) * px * 3);
        int n = std::min(static_cast<int>(it.boxes.size() / 4), max_boxes);
        out.counts[i] = n;
        for (int bi = 0; bi < n; ++bi) {
          float x1 = it.boxes[bi * 4] / it.w;
          float y1 = it.boxes[bi * 4 + 1] / it.h;
          float x2 = it.boxes[bi * 4 + 2] / it.w;
          float y2 = it.boxes[bi * 4 + 3] / it.h;
          if (mirror) {
            float nx1 = 1.f - x2, nx2 = 1.f - x1;
            x1 = nx1;
            x2 = nx2;
          }
          float* dstb = out.boxes.data() +
                        (static_cast<size_t>(i) * max_boxes + bi) * 4;
          dstb[0] = x1;
          dstb[1] = y1;
          dstb[2] = x2;
          dstb[3] = y2;
          out.labels[static_cast<size_t>(i) * max_boxes + bi] = it.labels[bi];
        }
      }
      std::unique_lock<std::mutex> lk(mu);
      cv_put.wait(lk, [&] { return static_cast<int>(ready.size()) < queue_depth || stop.load(); });
      if (stop.load()) break;
      ready.push(std::move(out));
      cv_get.notify_one();
    }
    std::unique_lock<std::mutex> lk(mu);
    cv_get.notify_all();
  }
};

}  // namespace

extern "C" {

void* fndt_create(const char** img_paths, const float* flat_boxes,
                  const int* box_counts, const int* flat_labels, long n,
                  int max_boxes, int batch, int out_hw, int threads,
                  int train, unsigned seed, int queue_depth, int rank,
                  int world) {
  auto* l = new DetLoader();
  l->rank = rank;
  l->world = world;
  l->paths.reserve(n);
  l->boxes.resize(n);
  l->labels.resize(n);
  long off = 0;
  for (long i = 0; i < n; ++i) {
    l->paths.emplace_back(img_paths[i]);
    int c = box_counts[i];
    l->boxes[i].assign(flat_boxes + off * 4, flat_boxes + (off + c) * 4);
    l->labels[i].assign(flat_labels + off, flat_labels + off + c);
    off += c;
  }
  l->max_boxes = max_boxes;
  l->batch = batch;
  l->out_hw = out_hw;
  l->threads = threads;
  l->train = train != 0;
  l->seed = seed;
  l->queue_depth = queue_depth;
  l->total_batches = n / batch;
  l->order.resize(n);
  for (long i = 0; i < n; ++i) l->order[i] = i;
  if (l->train) {
    std::mt19937_64 rng(seed);
    std::shuffle(l->order.begin(), l->order.end(), rng);
  }
  for (int t = 0; t < threads; ++t)
    l->workers.emplace_back(&DetLoader::worker_main, l, t);
  return l;
}

long fndt_batches_per_epoch(void* h) {
  return static_cast<DetLoader*>(h)->total_batches;
}

int fndt_next(void* h, unsigned char* images, float* boxes_out,
              int* labels_out, int* counts_out) {
  auto* l = static_cast<DetLoader*>(h);
  std::unique_lock<std::mutex> lk(l->mu);
  l->cv_get.wait(lk, [&] {
    return !l->ready.empty() || l->delivered >= l->total_batches ||
           l->stop.load();
  });
  if (l->ready.empty()) return 0;
  DetBatch b = std::move(l->ready.front());
  l->ready.pop();
  ++l->delivered;
  l->cv_put.notify_one();
  lk.unlock();
  std::memcpy(images, b.images.data(), b.images.size());
  std::memcpy(boxes_out, b.boxes.data(), b.boxes.size() * sizeof(float));
  std::memcpy(labels_out, b.labels.data(), b.labels.size() * sizeof(int));
  std::memcpy(counts_out, b.counts.data(), b.counts.size() * sizeof(int));
  return 1;
}

void fndt_destroy(void* h) {
  auto* l = static_cast<DetLoader*>(h);
  // Store `stop` under the mutex: a worker that has just evaluated its
  // wait predicate (false) still holds `mu` until it blocks, so an unlocked
  // store+notify in that window is a lost wakeup and join() deadlocks.
  {
    std::lock_guard<std::mutex> lk(l->mu);
    l->stop.store(true);
  }
  l->cv_put.notify_all();
  l->cv_get.notify_all();
  for (auto& t : l->workers) t.join();
  delete l;
}

void* fnsl_create(const char** img_paths, const char** mask_paths, long n,
                  int batch, int crop_h, int crop_w, int threads, int train,
                  unsigned seed, int queue_depth, float scale_min,
                  float scale_max, int ignore_label, int rank, int world) {
  auto* l = new SegLoader();
  l->rank = rank;
  l->world = world;
  l->img_paths.reserve(n);
  l->mask_paths.reserve(n);
  for (long i = 0; i < n; ++i) {
    l->img_paths.emplace_back(img_paths[i]);
    l->mask_paths.emplace_back(mask_paths[i]);
  }
  l->batch = batch;
  l->crop_h = crop_h;
  l->crop_w = crop_w;
  l->threads = threads;
  l->train = train != 0;
  l->seed = seed;
  l->queue_depth = queue_depth;
  l->scale_min = scale_min;
  l->scale_max = scale_max;
  l->ignore = static_cast<unsigned char>(ignore_label);
  l->total_batches = n / batch;
  l->order.resize(n);
  for (long i = 0; i < n; ++i) l->order[i] = i;
  if (l->train) {
    std::mt19937_64 rng(seed);
    std::shuffle(l->order.begin(), l->order.end(), rng);
  }
  for (int t = 0; t < threads; ++t)
    l->workers.emplace_back(&SegLoader::worker_main, l, t);
  return l;
}

long fnsl_batches_per_epoch(void* h) {
  return static_cast<SegLoader*>(h)->total_batches;
}

int fnsl_next(void* h, unsigned char* images, unsigned char* masks) {
  auto* l = static_cast<SegLoader*>(h);
  std::unique_lock<std::mutex> lk(l->mu);
  l->cv_get.wait(lk, [&] {
    return !l->ready.empty() || l->delivered >= l->total_batches ||
           l->stop.load();
  });
  if (l->ready.empty()) return 0;
  SegBatch b = std::move(l->ready.front());
  l->ready.pop();
  ++l->delivered;
  l->cv_put.notify_one();
  lk.unlock();
  std::memcpy(images, b.images.data(), b.images.size());
  std::memcpy(masks, b.masks.data(), b.masks.size());
  return 1;
}

void fnsl_destroy(void* h) {
  auto* l = static_cast<SegLoader*>(h);
  // Store `stop` under the mutex: a worker that has just evaluated its
  // wait predicate (false) still holds `mu` until it blocks, so an unlocked
  // store+notify in that window is a lost wakeup and join() deadlocks.
  {
    std::lock_guard<std::mutex> lk(l->mu);
    l->stop.store(true);
  }
  l->cv_put.notify_all();
  l->cv_get.notify_all();
  for (auto& t : l->workers) t.join();
  delete l;
}

void* fndl_create(const char** paths, const int* labels, long n, int batch,
                  int out_hw, int threads, int train, unsigned seed,
                  int queue_depth, const float* mean, const float* stdv,
                  int out_uint8, int rank, int world) {
  auto* l = new Loader();
  l->rank = rank;
  l->world = world;
  l->out_uint8 = out_uint8 != 0;
  l->paths.reserve(n);
  l->labels.assign(labels, labels + n);
  for (long i = 0; i < n; ++i) l->paths.emplace_back(paths[i]);
  l->batch = batch;
  l->out_hw = out_hw;
  l->threads = threads;
  l->train = train != 0;
  l->seed = seed;
  l->queue_depth = queue_depth;
  std::memcpy(l->mean, mean, sizeof(float) * 3);
  std::memcpy(l->stdv, stdv, sizeof(float) * 3);
  l->total_batches = n / batch;
  l->order.resize(n);
  for (long i = 0; i < n; ++i) l->order[i] = i;
  if (l->train) {
    std::mt19937_64 rng(seed);
    std::shuffle(l->order.begin(), l->order.end(), rng);
  }
  for (int t = 0; t < threads; ++t)
    l->workers.emplace_back(&Loader::worker_main, l, t);
  return l;
}

long fndl_batches_per_epoch(void* h) {
  return static_cast<Loader*>(h)->total_batches;
}

int fndl_next(void* h, void* images, int* labels_out) {
  auto* l = static_cast<Loader*>(h);
  std::unique_lock<std::mutex> lk(l->mu);
  // End-of-epoch = all batches DELIVERED, not all batches CLAIMED: workers
  // bump next_batch when they claim work, before decoding/pushing it, so a
  // claimed-based predicate can fire with batches still in flight and drop
  // them (observed as a flaky short epoch under CPU contention).
  l->cv_get.wait(lk, [&] {
    return !l->ready.empty() || l->delivered >= l->total_batches ||
           l->stop.load();
  });
  if (l->ready.empty()) return 0;
  Batch b = std::move(l->ready.front());
  l->ready.pop();
  ++l->delivered;
  l->cv_put.notify_one();
  lk.unlock();
  std::memcpy(images, b.images.data(), b.images.size());
  std::memcpy(labels_out, b.labels.data(), b.labels.size() * sizeof(int));
  return 1;
}

void fndl_destroy(void* h) {
  auto* l = static_cast<Loader*>(h);
  // Store `stop` under the mutex: a worker that has just evaluated its
  // wait predicate (false) still holds `mu` until it blocks, so an unlocked
  // store+notify in that window is a lost wakeup and join() deadlocks.
  {
    std::lock_guard<std::mutex> lk(l->mu);
    l->stop.store(true);
  }
  l->cv_put.notify_all();
  l->cv_get.notify_all();
  for (auto& t : l->workers) t.join();
  delete l;
}

}  // extern "C"
