// Device helpers shared by the 64-channel 3x3 conv backward kernels
// (conv_bwd_patch.cu, conv_bwd_tap.cu, chain_bwd.cu), sm_90a.
//
// Layouts: activations (B, H, W, 64) NHWC; the flipped weights W9flip
// (576, 64) with row t*64 + co and column ci, t = 3i + j the tap; a dW
// partial (576, 64) float with row t*64 + ci and column co, which is also
// the flat layout of a (3, 3, 64, 64) HWIO gradient. The library is built
// with --fmad=false, so every float sum here is an explicit __fmaf_rn.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace convk {

constexpr int kC = 64;
constexpr int kK9 = 9 * kC;         // 576
constexpr int kPartial = kK9 * kC;  // 36,864 floats: one dW partial
constexpr int kThreads = 256;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// v rounded to T and back: what a value stored in the compute dtype holds.
template <typename T>
__device__ __forceinline__ float round_to(float v) { return to_f(from_f<T>(v)); }

// 4 consecutive values of a T array as floats (p 8- or 16-byte aligned).
__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  return make_float4(__low2float(lo), __high2float(lo), __low2float(hi),
                     __high2float(hi));
}

// Output tiles of th x tw pixels over a (B, H, W) batch, numbered image by
// image, row-major inside an image.
struct Tiles {
  int th, tw, tiles_h, tiles_w, n;
  __host__ __device__ Tiles(int b, int h, int w, int th_, int tw_)
      : th(th_), tw(tw_), tiles_h((h + th_ - 1) / th_), tiles_w((w + tw_ - 1) / tw_),
        n(b * tiles_h * tiles_w) {}
  // image, first row and first column of tile k
  __device__ void origin(int k, int* b, int* r0, int* c0) const {
    const int per_image = tiles_h * tiles_w;
    *b = k / per_image;
    const int r = k - *b * per_image;
    *r0 = (r / tiles_w) * th;
    *c0 = (r % tiles_w) * tw;
  }
};

// Stage rows [r0, r0 + rh) x columns [c0, c0 + rw) of image b of a
// (B, H, W, 64) tensor into dst[(rr * rw + cc) * 64 + c], zero outside the
// image, converting T to S (S == T copies 16 bytes a thread-step).
template <typename S, typename T>
__device__ void load_region(S* dst, const T* __restrict__ src, int b, int h, int w,
                            int r0, int c0, int rh, int rw) {
  constexpr int V = 8;  // channels a step
  const int steps = rh * rw * (kC / V);
  for (int g = threadIdx.x; g < steps; g += blockDim.x) {
    const int pix = g / (kC / V);
    const int c = (g - pix * (kC / V)) * V;
    const int hh = r0 + pix / rw, ww = c0 + pix % rw;
    const bool in = hh >= 0 && hh < h && ww >= 0 && ww < w;
    const T* s = src + ((static_cast<size_t>(b) * h + hh) * w + ww) * kC + c;
    S* d = dst + pix * kC + c;
    if constexpr (sizeof(S) == sizeof(T)) {
      constexpr int kVec = V * sizeof(T) / 16;  // int4s a step
#pragma unroll
      for (int v = 0; v < kVec; ++v)
        reinterpret_cast<int4*>(d)[v] =
            in ? __ldg(reinterpret_cast<const int4*>(s) + v) : make_int4(0, 0, 0, 0);
    } else {
#pragma unroll
      for (int v = 0; v < V; v += 4) {
        const float4 f = in ? load4(s + v) : make_float4(0.f, 0.f, 0.f, 0.f);
        *reinterpret_cast<float4*>(d + v) = f;
      }
    }
  }
}

// dW partial += the tile's products, in FP32 FMAs. Thread (cp = tid & 31,
// cg = tid >> 5) owns rows t*64 + 2cp + {0, 1} x columns 8cg .. 8cg + 7 of
// every tap t: 144 floats, read from `dw` (shared or device memory, only
// this thread touches them), summed over the tile's `npix` pixels and
// written back. in_row(p, t) is the 64-channel input row that tap t of
// pixel p reads; g_row(p) the pixel's 64-channel gradient row. Pixels
// outside the image carry a zero gradient.
template <typename InRow, typename GRow>
__device__ void dw_fma(float* dw, int npix, InRow in_row, GRow g_row) {
  const int cp = threadIdx.x & 31;
  const int cg = threadIdx.x >> 5;
  float acc[9][2][8];
#pragma unroll
  for (int t = 0; t < 9; ++t)
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const float* row = dw + (t * kC + 2 * cp + q) * kC + cg * 8;
      const float4 a = *reinterpret_cast<const float4*>(row);
      const float4 b = *reinterpret_cast<const float4*>(row + 4);
      acc[t][q][0] = a.x; acc[t][q][1] = a.y; acc[t][q][2] = a.z; acc[t][q][3] = a.w;
      acc[t][q][4] = b.x; acc[t][q][5] = b.y; acc[t][q][6] = b.z; acc[t][q][7] = b.w;
    }
#pragma unroll 1
  for (int p = 0; p < npix; ++p) {
    const float* gv = g_row(p) + cg * 8;
    const float4 d0 = *reinterpret_cast<const float4*>(gv);
    const float4 d1 = *reinterpret_cast<const float4*>(gv + 4);
    const float d[8] = {d0.x, d0.y, d0.z, d0.w, d1.x, d1.y, d1.z, d1.w};
#pragma unroll
    for (int t = 0; t < 9; ++t) {
      const float2 xv = *reinterpret_cast<const float2*>(in_row(p, t) + 2 * cp);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        acc[t][0][e] = __fmaf_rn(xv.x, d[e], acc[t][0][e]);
        acc[t][1][e] = __fmaf_rn(xv.y, d[e], acc[t][1][e]);
      }
    }
  }
#pragma unroll
  for (int t = 0; t < 9; ++t)
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      float* row = dw + (t * kC + 2 * cp + q) * kC + cg * 8;
      *reinterpret_cast<float4*>(row) =
          make_float4(acc[t][q][0], acc[t][q][1], acc[t][q][2], acc[t][q][3]);
      *reinterpret_cast<float4*>(row + 4) =
          make_float4(acc[t][q][4], acc[t][q][5], acc[t][q][6], acc[t][q][7]);
    }
}

// out[p, ci] = sum_t sum_co g_row(p, t)[co] * W9flip[t*64 + co, ci] for the
// `npix` pixels of a region, in FP32 FMAs: the per-tap product of a tile
// (dx, or the chain's da1). Thread (cq = tid & 15, pg = tid >> 4) takes
// input channels 4cq .. 4cq + 3 of pixels pg, pg + 16, ... (at most KP of
// them); W9flip (type WT) is read from device memory, where the L1 and L2
// caches hold it. epi(p, ci0, float acc[4]) consumes each result.
template <int KP, typename WT, typename GRow, typename Epi>
__device__ void tap_gemm_fma(int npix, const WT* __restrict__ w9, GRow g_row, Epi epi) {
  const int cq = threadIdx.x & 15;
  const int pg = threadIdx.x >> 4;
  float acc[KP][4];
#pragma unroll
  for (int k = 0; k < KP; ++k)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[k][e] = 0.0f;
#pragma unroll 1
  for (int t = 0; t < 9; ++t) {
    const float* rows[KP];
#pragma unroll
    for (int k = 0; k < KP; ++k) {
      const int p = pg + 16 * k;
      rows[k] = g_row(p < npix ? p : 0, t);
    }
    const WT* wt = w9 + t * kC * kC + cq * 4;
#pragma unroll 4
    for (int co = 0; co < kC; ++co) {
      const float4 wv = load4(wt + co * kC);
#pragma unroll
      for (int k = 0; k < KP; ++k) {
        const float d = rows[k][co];
        acc[k][0] = __fmaf_rn(d, wv.x, acc[k][0]);
        acc[k][1] = __fmaf_rn(d, wv.y, acc[k][1]);
        acc[k][2] = __fmaf_rn(d, wv.z, acc[k][2]);
        acc[k][3] = __fmaf_rn(d, wv.w, acc[k][3]);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < KP; ++k) {
    const int p = pg + 16 * k;
    if (p < npix) epi(p, cq * 4, acc[k]);
  }
}

// The bf16 tensor-core counterpart of one warp's share of a dW partial:
// for row blocks rb = warp, warp + 8, ... of the 576 rows, the four 16x16
// float fragments of dW[rb*16 .. +16, 0 .. 64) are read from `dw` (shared
// memory), += sum over the tile's kchunks 16-pixel chunks of
// A(rb, kc)^T @ B(kc), and written back. a_ptr(rb, kc) points at A's
// (pixel 0, row 0) element with pixel stride lda (col-major A^T); b_ptr(kc)
// at the gradient's (pixel 0, co 0) with pixel stride 64.
template <typename APtr, typename BPtr>
__device__ void dw_wmma(float* dw, int kchunks, int lda, APtr a_ptr, BPtr b_ptr) {
  using namespace nvcuda;
  const int warp = threadIdx.x >> 5;
  for (int rb = warp; rb < kK9 / 16; rb += kThreads / 32) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
#pragma unroll
    for (int n = 0; n < 4; ++n)
      wmma::load_matrix_sync(acc[n], dw + rb * 16 * kC + n * 16, kC, wmma::mem_row_major);
    for (int kc = 0; kc < kchunks; ++kc) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::col_major> a;
      wmma::load_matrix_sync(a, a_ptr(rb, kc), lda);
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf;
        wmma::load_matrix_sync(bf, b_ptr(kc) + n * 16, kC);
        wmma::mma_sync(acc[n], a, bf, acc[n]);
      }
    }
#pragma unroll
    for (int n = 0; n < 4; ++n)
      wmma::store_matrix_sync(dw + rb * 16 * kC + n * 16, acc[n], kC, wmma::mem_row_major);
  }
}

// Write a warp's 16 pixels x 16 channels float fragment as T: the fragment
// goes through the warp's 1 KiB `scratch`, then lane l writes 8 channels of
// pixel l / 2 to dst(pixel) + 8 * (l & 1) if dst(pixel) is not null.
template <typename T, typename Frag, typename Dst>
__device__ void store_frag(float* scratch, const Frag& frag, Dst dst) {
  using namespace nvcuda;
  wmma::store_matrix_sync(scratch, frag, 16, wmma::mem_row_major);
  __syncwarp();
  const int lane = threadIdx.x & 31;
  const int m = lane >> 1, c = (lane & 1) * 8;
  T* out = dst(m);
  if (out != nullptr) {
#pragma unroll
    for (int e = 0; e < 8; ++e) out[c + e] = from_f<T>(scratch[m * 16 + c + e]);
  }
  __syncwarp();
}

// Zero a block's float buffer of n floats (n a multiple of 4).
__device__ __forceinline__ void zero_block(float* p, int n) {
  for (int g = threadIdx.x * 4; g < n; g += blockDim.x * 4)
    *reinterpret_cast<float4*>(p + g) = make_float4(0.f, 0.f, 0.f, 0.f);
}

// Copy a block's n floats from src to dst (n a multiple of 4).
__device__ __forceinline__ void copy_block(float* dst, const float* src, int n) {
  for (int g = threadIdx.x * 4; g < n; g += blockDim.x * 4)
    *reinterpret_cast<float4*>(dst + g) = *reinterpret_cast<const float4*>(src + g);
}

// out[o] = sum over blocks g = 0, 1, ... of partial[g * stride + o], o < n,
// summed in block order: the second pass that keeps a run's bits fixed.
static __global__ void sum_partials(const float* __restrict__ partial, int parts, int stride,
                             int n, float* __restrict__ out) {
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= n) return;
  float s = 0.0f;
  for (int g = 0; g < parts; ++g)
    s = __fadd_rn(s, partial[static_cast<size_t>(g) * stride + o]);
  out[o] = s;
}

static inline int launch_sum(const float* partial, int parts, int stride, int n, float* out,
                      cudaStream_t stream) {
  sum_partials<<<(n + 255) / 256, 256, 0, stream>>>(partial, parts, stride, n, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace convk
