// Native data-loading runtime of the PyTorch port: JPEG/PNG decode +
// letterbox + normalize. The port's copy of
// `yolo_from_scratch_tpu/native/yolodata.cc`: the same C ABI and the same
// algorithm, line for line, so that both libraries, built with the same
// flags on one machine, decode bit for bit alike
// (`tests/test_torch_native.py`).
//
// libjpeg / libpng decode (chosen by the file's magic bytes), PIL-style
// triangle-filter letterbox resize onto a gray (114,114,114) canvas, and
// float32 [0,1] NHWC normalization, in a worker-thread pool so batches
// materialize while the card runs the previous step.
//
// Exposed as a C ABI for ctypes:
//   yd_decode_letterbox_batch(paths, n, target, out, scales, pad_tops,
//                             pad_lefts, n_threads) -> failure count
//   yd_image_size(path, w, h) -> 0 on success
//
// Built at first use by `yolo_from_scratch_tpu_torch/native/__init__.py`
// (g++ -O3 -march=native -fPIC -std=c++17 -Wall, -ljpeg -lpng -lpthread)
// into build/torch_native/ at the repository root.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <atomic>
#include <thread>
#include <vector>

#include <csetjmp>
#include <jpeglib.h>
#include <png.h>

namespace {

constexpr float kPad = 114.0f / 255.0f;

struct Image {
  int w = 0, h = 0;
  std::vector<uint8_t> rgb;  // HWC, 3 channels
  bool ok = false;
};

// ---------------- JPEG decode (libjpeg) ----------------

struct JpegErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void jpeg_error_exit(j_common_ptr cinfo) {
  auto* err = reinterpret_cast<JpegErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

Image decode_jpeg(FILE* f) {
  Image img;
  jpeg_decompress_struct cinfo;
  JpegErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return img;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  img.w = cinfo.output_width;
  img.h = cinfo.output_height;
  img.rgb.resize(size_t(img.w) * img.h * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = img.rgb.data() + size_t(cinfo.output_scanline) * img.w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  img.ok = true;
  return img;
}

// ---------------- PNG decode (libpng) ----------------

Image decode_png(FILE* f) {
  Image img;
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) return img;
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    return img;
  }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return img;
  }
  png_init_io(png, f);
  png_read_info(png, info);
  png_set_expand(png);          // palette/gray -> 8-bit
  png_set_strip_16(png);        // 16-bit -> 8-bit
  png_set_strip_alpha(png);     // drop alpha
  png_set_gray_to_rgb(png);     // gray -> rgb
  png_read_update_info(png, info);
  img.w = png_get_image_width(png, info);
  img.h = png_get_image_height(png, info);
  img.rgb.resize(size_t(img.w) * img.h * 3);
  std::vector<png_bytep> rows(img.h);
  for (int y = 0; y < img.h; ++y)
    rows[y] = img.rgb.data() + size_t(y) * img.w * 3;
  png_read_image(png, rows.data());
  png_read_end(png, nullptr);
  png_destroy_read_struct(&png, &info, nullptr);
  img.ok = true;
  return img;
}

Image decode_file(const char* path) {
  Image img;
  FILE* f = fopen(path, "rb");
  if (!f) return img;
  uint8_t magic[8] = {0};
  size_t got = fread(magic, 1, 8, f);
  rewind(f);
  if (got >= 2 && magic[0] == 0xFF && magic[1] == 0xD8) {
    img = decode_jpeg(f);
  } else if (got >= 8 && png_sig_cmp(magic, 0, 8) == 0) {
    img = decode_png(f);
  }
  fclose(f);
  return img;
}

// ---------------- letterbox: triangle-filter resize + pad + normalize ----

// Separable triangle ("bilinear") resampling with filter support scaled by
// the downscale ratio — the same algorithm PIL's BILINEAR uses (its
// ImagingResample), so the native path anti-aliases identically to the
// reference preprocessing instead of point-sampling.
struct FilterTaps {
  std::vector<int> first;      // first source index per dest pixel
  std::vector<int> count;      // tap count per dest pixel
  std::vector<float> weights;  // taps, normalized, max_taps stride
  int max_taps = 0;
};

FilterTaps build_triangle_taps(int src_size, int dst_size) {
  FilterTaps t;
  const double ratio = double(src_size) / dst_size;
  const double fscale = ratio > 1.0 ? ratio : 1.0;
  const double support = 1.0 * fscale;  // triangle support = 1
  t.max_taps = int(support * 2.0 + 2.0);
  t.first.resize(dst_size);
  t.count.resize(dst_size);
  t.weights.assign(size_t(dst_size) * t.max_taps, 0.0f);
  for (int x = 0; x < dst_size; ++x) {
    const double center = (x + 0.5) * ratio;
    int lo = int(center - support + 0.5);
    int hi = int(center + support + 0.5);
    if (lo < 0) lo = 0;
    if (hi > src_size) hi = src_size;
    double sum = 0.0;
    float* w = &t.weights[size_t(x) * t.max_taps];
    for (int i = lo; i < hi; ++i) {
      double d = (i + 0.5 - center) / fscale;
      double k = d < 0 ? 1.0 + d : 1.0 - d;  // triangle kernel
      if (k < 0) k = 0;
      w[i - lo] = float(k);
      sum += k;
    }
    if (sum > 0) {
      for (int i = 0; i < hi - lo; ++i) w[i] = float(w[i] / sum);
    }
    t.first[x] = lo;
    t.count[x] = hi - lo;
  }
  return t;
}

// Writes a (target x target x 3) float32 [0,1] canvas; returns the scale
// and pad offsets used (identical geometry to the reference letterbox,
// reference: train.py:36-53: floor-int new dims, centered integer pads).
void letterbox_into(const Image& img, int target, float* out, float* scale_out,
                    int* pad_top_out, int* pad_left_out) {
  // double precision: float32 scale produces off-by-one floor-int new
  // dims vs the Python host path for ~3.5% of sizes (w*scale landing
  // exactly on an integer in double)
  const double scale =
      std::min(double(target) / img.w, double(target) / img.h);
  // clamp to >=1: extreme aspect ratios would otherwise produce a
  // 0-wide/0-tall resample (division by zero in the tap builder) while
  // still reporting a nonzero scale
  const int new_w = std::max(1, int(img.w * scale));
  const int new_h = std::max(1, int(img.h * scale));
  const int pad_left = (target - new_w) / 2;
  const int pad_top = (target - new_h) / 2;
  *scale_out = float(scale);
  *pad_top_out = pad_top;
  *pad_left_out = pad_left;

  // gray fill
  const size_t total = size_t(target) * target * 3;
  for (size_t i = 0; i < total; ++i) out[i] = kPad;

  const FilterTaps tx = build_triangle_taps(img.w, new_w);
  const FilterTaps ty = build_triangle_taps(img.h, new_h);

  // horizontal pass: (h, new_w, 3) f32
  std::vector<float> mid(size_t(img.h) * new_w * 3);
  for (int y = 0; y < img.h; ++y) {
    const uint8_t* src = img.rgb.data() + size_t(y) * img.w * 3;
    float* dst = mid.data() + size_t(y) * new_w * 3;
    for (int x = 0; x < new_w; ++x) {
      const float* w = &tx.weights[size_t(x) * tx.max_taps];
      const int lo = tx.first[x], cnt = tx.count[x];
      float acc0 = 0, acc1 = 0, acc2 = 0;
      for (int i = 0; i < cnt; ++i) {
        const uint8_t* p = src + size_t(lo + i) * 3;
        acc0 += w[i] * p[0];
        acc1 += w[i] * p[1];
        acc2 += w[i] * p[2];
      }
      dst[x * 3 + 0] = acc0;
      dst[x * 3 + 1] = acc1;
      dst[x * 3 + 2] = acc2;
    }
  }

  // vertical pass straight into the padded canvas, normalized to [0,1]
  for (int y = 0; y < new_h; ++y) {
    const float* w = &ty.weights[size_t(y) * ty.max_taps];
    const int lo = ty.first[y], cnt = ty.count[y];
    float* dst = out + (size_t(y + pad_top) * target + pad_left) * 3;
    for (int x = 0; x < new_w * 3; ++x) {
      float acc = 0;
      for (int i = 0; i < cnt; ++i) {
        acc += w[i] * mid[size_t(lo + i) * new_w * 3 + x];
      }
      dst[x] = acc * (1.0f / 255.0f);
    }
  }
}

}  // namespace

extern "C" {

// paths: array of n C strings. out: (n, target, target, 3) float32.
// scales: (n,) float32. pad_tops/pad_lefts: (n,) int32.
// Returns the number of images that FAILED to decode (0 == all good);
// failed slots are left as an all-gray canvas with scale 0.
int yd_decode_letterbox_batch(const char** paths, int n, int target,
                              float* out, float* scales, int32_t* pad_tops,
                              int32_t* pad_lefts, int n_threads) {
  std::atomic<int> next(0), failures(0);
  const size_t img_stride = size_t(target) * target * 3;

  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      Image img = decode_file(paths[i]);
      float* dst = out + size_t(i) * img_stride;
      if (!img.ok || img.w <= 0 || img.h <= 0) {
        for (size_t k = 0; k < img_stride; ++k) dst[k] = kPad;
        scales[i] = 0.0f;
        pad_tops[i] = 0;
        pad_lefts[i] = 0;
        failures.fetch_add(1);
        continue;
      }
      letterbox_into(img, target, dst, &scales[i], &pad_tops[i],
                     &pad_lefts[i]);
    }
  };

  if (n_threads <= 1) {
    worker();
  } else {
    std::vector<std::thread> threads;
    int spawn = n_threads < n ? n_threads : n;
    threads.reserve(spawn);
    for (int t = 0; t < spawn; ++t) threads.emplace_back(worker);
    for (auto& t : threads) t.join();
  }
  return failures.load();
}

// Decode a single image's dimensions without full decode (for metadata).
// Returns 0 on success.
int yd_image_size(const char* path, int32_t* w, int32_t* h) {
  Image img = decode_file(path);  // simple: full decode
  if (!img.ok) return 1;
  *w = img.w;
  *h = img.h;
  return 0;
}

}  // extern "C"
