// Letterbox of a batch of raw HWC uint8 frames into the model's uint8 input
// on the card (L1, sm_90a).
//
// Replaces no Pallas kernel: the JAX package letterboxes on the host with
// PIL (`yolo_from_scratch_tpu/data/letterbox.py::letterbox_image`), and
// its device letterbox (`letterbox_device_bucketed`) is XLA's resample,
// which differs from PIL by up to ~1.5 LSB. L1 was added because the host
// letterbox held batched serving's card idle most of every call: it makes
// PIL's bytes, bit for bit, from the raw frames that one upload brings.
//
// Input: one staging buffer that `ops/letterbox_cuda.py::Staging` writes,
//   [table: B rows of 32 int32] [coefficient blocks] [frames],
// each part on a 16-byte boundary; a row's fields are `Field` below
// (offsets in 16-byte units from the buffer's start). Output: (B, S, S, 3)
// uint8, or with `packed` the (B, S/4, S/4, 48) layout of
// `data/letterbox.py::pack_s2d_host` (channel (a * 4 + b) * 3 + c of
// packed pixel (I, J) is pixel (4 I + a, 4 J + b), channel c), by index
// math alone.
//
// Per image, from its own row: outside the letterboxed rectangle the pad
// colour (114); inside, where the letterboxed size is the frame's own, a
// copy (PIL's same-size resize is one); elsewhere Pillow's 8-bit bilinear
// resample in integers, with Pillow's coefficients (computed on the host,
// 22 fractional bits): the horizontal pass into a uint8 value (accumulator
// from 1 << 21, >> 22, clipped to 0..255), then the vertical pass over
// those values; an axis whose size stays has no pass, as in Pillow. Every
// sum is Pillow's, in Pillow's order, in int32 (no overflow: the
// coefficients are >= 0 and sum to ~2^22).
//
// Design: one thread a 16-byte chunk of the output, written with one
// 16-byte store; a block of 256 threads covers 4 KiB of one image. What
// bounds it on the H100 is bytes: each frame's bytes read once and the
// output written once (29.5 MB in and 39.3 MB out at B=32 640x480, 20.5 us
// at 3.35 TB/s). A chunk wholly inside a copied frame's rectangle (all
// but the pads' edges in the unpacked layout) reads its 16 source bytes as
// five aligned 32-bit words and funnel-shifts them into place; a chunk of
// pad alone reads nothing; the others (edges, the packed layout, the
// resample branch) build the chunk a byte at a time, a pixel's three
// channels computed once. The resample branch computes each intermediate
// value where it is used, from L1/L2-cached source rows, at any scale.
// Staging a block's intermediate rows in shared memory would save little
// in this grid: a block covers ~2 output rows, whose taps span ~7
// intermediate rows each, so it would compute about as many intermediate
// values as it reads; the reuse (~(2s + 1) / s at a shrink by s) needs
// 2-D tiles. The branch is bound by its scattered loads, not by bytes (a
// warp's loads of one tap span ~1.5 KB of a source row, 7 x 7 x 3 of them
// an output pixel at a 3x shrink): on an H100 at B=32 1920x1080 it takes
// ~28x its bound. No serving cell takes it.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kRowInts = 32;  // int32 fields of a table row (128 bytes)
constexpr int kUnit = 16;     // table offsets count 16-byte units
constexpr int kPrecisionBits = 22;
constexpr uint32_t kPadPixel = 0x727272u;  // PAD_COLOR (114, 114, 114)
constexpr uint32_t kPadWord = 0x72727272u;
constexpr int kMaxImages = 65535;  // gridDim.y
constexpr int kMaxSize = 16384;

// A table row's int32 fields (`FIELDS` in ops/letterbox_cuda.py).
enum Field { kSrc, kH, kW, kNewH, kNewW, kPadTop, kPadLeft, kXCoef, kXTaps, kYCoef, kYTaps };

struct Image {
  const uint8_t* src;
  int w, nh, nw, pt, pl;
  const int* xb;  // (nw, 2) [first tap, taps]; xt == 0: no horizontal pass
  const int* xk;  // (nw, xt) coefficients
  int xt;
  const int* yb;  // (nh, 2); yt == 0: no vertical pass
  const int* yk;  // (nh, yt)
  int yt;
};

__device__ __forceinline__ Image load_image(const uint8_t* buf, int b) {
  const int* row = reinterpret_cast<const int*>(buf) + b * kRowInts;
  Image g;
  g.src = buf + static_cast<size_t>(__ldg(row + kSrc)) * kUnit;
  g.w = __ldg(row + kW);
  g.nh = __ldg(row + kNewH);
  g.nw = __ldg(row + kNewW);
  g.pt = __ldg(row + kPadTop);
  g.pl = __ldg(row + kPadLeft);
  g.xt = __ldg(row + kXTaps);
  g.yt = __ldg(row + kYTaps);
  g.xb = reinterpret_cast<const int*>(buf + static_cast<size_t>(__ldg(row + kXCoef)) * kUnit);
  g.xk = g.xb + 2 * g.nw;
  g.yb = reinterpret_cast<const int*>(buf + static_cast<size_t>(__ldg(row + kYCoef)) * kUnit);
  g.yk = g.yb + 2 * g.nh;
  return g;
}

// Pillow's clip8: the accumulator >> 22, clipped to 0..255.
__device__ __forceinline__ uint32_t clip8(int acc) {
  const int v = acc >> kPrecisionBits;
  return static_cast<uint32_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
}

__device__ __forceinline__ uint32_t src_pixel(const Image& g, int y, int x) {
  const uint8_t* p = g.src + (static_cast<size_t>(y) * g.w + x) * 3;
  return static_cast<uint32_t>(__ldg(p)) | (static_cast<uint32_t>(__ldg(p + 1)) << 8) |
         (static_cast<uint32_t>(__ldg(p + 2)) << 16);
}

// Content pixel (row y of the horizontal pass's output, column cx): the
// frame's own where the width stays, else the horizontal pass.
__device__ __forceinline__ uint32_t h_pixel(const Image& g, int y, int cx) {
  if (g.xt == 0) return src_pixel(g, y, cx);
  const int xmin = __ldg(g.xb + 2 * cx), n = __ldg(g.xb + 2 * cx + 1);
  const int* k = g.xk + cx * g.xt;
  const uint8_t* p = g.src + (static_cast<size_t>(y) * g.w + xmin) * 3;
  int s0 = 1 << (kPrecisionBits - 1), s1 = s0, s2 = s0;
  for (int i = 0; i < n; ++i) {
    const int c = __ldg(k + i);
    s0 += static_cast<int>(__ldg(p + 3 * i)) * c;
    s1 += static_cast<int>(__ldg(p + 3 * i + 1)) * c;
    s2 += static_cast<int>(__ldg(p + 3 * i + 2)) * c;
  }
  return clip8(s0) | (clip8(s1) << 8) | (clip8(s2) << 16);
}

// Output pixel (y, x) of the S x S letterbox, channels in bytes 0..2.
__device__ uint32_t pixel(const Image& g, int y, int x) {
  const int cy = y - g.pt, cx = x - g.pl;
  if (cy < 0 || cy >= g.nh || cx < 0 || cx >= g.nw) return kPadPixel;
  if (g.yt == 0) return h_pixel(g, cy, cx);
  const int ymin = __ldg(g.yb + 2 * cy), n = __ldg(g.yb + 2 * cy + 1);
  const int* k = g.yk + cy * g.yt;
  int s0 = 1 << (kPrecisionBits - 1), s1 = s0, s2 = s0;
  for (int j = 0; j < n; ++j) {
    const int c = __ldg(k + j);
    const uint32_t v = h_pixel(g, ymin + j, cx);
    s0 += static_cast<int>(v & 255u) * c;
    s1 += static_cast<int>((v >> 8) & 255u) * c;
    s2 += static_cast<int>(v >> 16) * c;
  }
  return clip8(s0) | (clip8(s1) << 8) | (clip8(s2) << 16);
}

// 16 bytes from any address, as five aligned words funnel-shifted into
// place (the buffer has 16 bytes of slack past its last frame).
__device__ __forceinline__ uint4 load16(const uint8_t* p) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  const uint32_t* w = reinterpret_cast<const uint32_t*>(a & ~uintptr_t{3});
  const uint32_t sh = static_cast<uint32_t>(a & 3u) * 8u;
  const uint32_t w0 = __ldg(w), w1 = __ldg(w + 1), w2 = __ldg(w + 2), w3 = __ldg(w + 3),
                 w4 = __ldg(w + 4);
  return make_uint4(__funnelshift_r(w0, w1, sh), __funnelshift_r(w1, w2, sh),
                    __funnelshift_r(w2, w3, sh), __funnelshift_r(w3, w4, sh));
}

// The chunk at byte o of an image's output a byte at a time: each byte's
// (y, x, channel) from the layout, a pixel computed once for its bytes.
__device__ uint4 build16(const Image& g, int size, uint32_t o, bool packed) {
  unsigned long long lo = 0, hi = 0;
  int py = -1, px = -1;
  uint32_t pix = 0;
  const uint32_t row_bytes = 3u * size, quads = size / 4;
  const uint32_t y0 = o / row_bytes, r0 = o - y0 * row_bytes;
  const uint32_t cell = o / 48u, k0 = o - cell * 48u;
  const uint32_t ci = cell / quads, cj = cell - ci * quads;
#pragma unroll 1
  for (uint32_t t = 0; t < 16; ++t) {
    int y, x;
    uint32_t c;
    if (packed) {
      const uint32_t k = k0 + t, ab = k / 3u;
      c = k - ab * 3u;
      y = static_cast<int>(4u * ci + (ab >> 2));
      x = static_cast<int>(4u * cj + (ab & 3u));
    } else {
      const uint32_t r = r0 + t;
      y = static_cast<int>(y0);
      x = static_cast<int>(r / 3u);
      c = r - 3u * (r / 3u);
    }
    if (y != py || x != px) {
      pix = pixel(g, y, x);
      py = y;
      px = x;
    }
    const unsigned long long v = (pix >> (8u * c)) & 255u;
    if (t < 8)
      lo |= v << (8u * t);
    else
      hi |= v << (8u * (t - 8));
  }
  return make_uint4(static_cast<uint32_t>(lo), static_cast<uint32_t>(lo >> 32),
                    static_cast<uint32_t>(hi), static_cast<uint32_t>(hi >> 32));
}

__global__ void __launch_bounds__(kThreads)
    letterbox_u8_kernel(const uint8_t* __restrict__ buf, uint8_t* __restrict__ out, int size,
                        bool packed) {
  const uint32_t row_bytes = 3u * size;
  const uint32_t chunks = row_bytes * size / kUnit;
  const uint32_t q = blockIdx.x * kThreads + threadIdx.x;
  if (q >= chunks) return;
  const int b = blockIdx.y;
  const Image g = load_image(buf, b);
  const uint32_t o = q * kUnit;
  uint4 v;
  if (packed) {
    v = build16(g, size, o, true);
  } else {
    const uint32_t y = o / row_bytes, r = o - y * row_bytes;
    const int cy = static_cast<int>(y) - g.pt;
    const int x0 = static_cast<int>(r / 3u), x1 = static_cast<int>((r + kUnit - 1) / 3u);
    if (cy < 0 || cy >= g.nh || x1 < g.pl || x0 >= g.pl + g.nw) {
      v = make_uint4(kPadWord, kPadWord, kPadWord, kPadWord);
    } else if (g.xt == 0 && g.yt == 0 && x0 >= g.pl && x1 < g.pl + g.nw) {
      v = load16(g.src + static_cast<size_t>(cy) * g.w * 3 + (r - 3u * g.pl));
    } else {
      v = build16(g, size, o, false);
    }
  }
  reinterpret_cast<uint4*>(out + static_cast<size_t>(b) * chunks * kUnit)[q] = v;
}

}  // namespace

extern "C" {

// buf: the staging buffer on the device, 16-byte aligned, with 16 bytes of
// slack past its last frame; out: (B, S, S, 3) uint8, or (B, S/4, S/4, 48)
// with `packed`, 16-byte aligned. One launch on `stream`, no
// synchronisation; returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for B outside 1..65535 or S outside 16..16384 or
// not a multiple of 16.
int letterbox_u8(const void* buf, int b, int size, int packed, void* out, void* stream) {
  if (b <= 0 || b > kMaxImages || size <= 0 || size > kMaxSize || size % kUnit != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const uint32_t chunks = 3u * size * size / kUnit;
  const dim3 grid((chunks + kThreads - 1) / kThreads, b);
  letterbox_u8_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(buf), static_cast<uint8_t*>(out), size, packed != 0);
  return static_cast<int>(cudaGetLastError());
}

const char* letterbox_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
