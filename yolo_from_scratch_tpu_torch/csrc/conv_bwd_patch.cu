// Backward of a stride-1 SAME 3x3 convolution with 64 channels in and out,
// in the patch-matrix form (sm_90a).
//
// Replaces the Pallas TPU kernel `benchmarks/bwdproto.py::_bwd_kernel` and
// computes what `yolo_from_scratch_tpu_torch/benchmarks/bwdproto.py::
// fused_bwd_patch_plain` computes. With t = 3i + j and (B, H, W, 64) NHWC
// tensors:
//
//   X9[p, t*64 + ci]  = x[p + (i - 1, j - 1), ci]   (zero outside the image)
//   dW                = sum over tiles of X9^T @ dy          (576 x 64, float)
//   DY9               = the same patch matrix of dy, in the same buffer
//   dx                = DY9 @ W9flip                          (rounded once)
//
// Design. As the TPU kernel does, a block builds its tile's X9 rows in one
// shared-memory buffer, takes the dW product, then rebuilds the buffer as
// DY9 for the dx product. The TPU's sequential batch walk becomes blocks
// that take tiles k, k + gridDim.x, ... and keep their dW partial (576 x 64
// float, 144 KiB) in shared memory; a second kernel sums the partials in
// block order (no atomics, the same bits on every run).
//   - bfloat16: 4x16-pixel tiles: X9 is 64 x 576 bf16 (72 KiB) beside the
//     dy tile (8 KiB, later the warps' rounding scratch) and the partial:
//     224 KiB of the 227. Both products run on the tensor cores as 16x16x16
//     bf16 fragments with float accumulation; W9flip is read from device
//     memory (L2).
//   - float32: 4x8-pixel tiles (X9 72 KiB in float) in FP32 FMAs, since
//     TF32 fragments would miss the 1e-5 tolerance.
//
// What bounds it on the H100: building X9 and DY9 writes 9x the tile's
// input into shared memory twice and reads it back for the products, and
// the 144 KiB partial is read and written once a tile; shared-memory
// traffic, not the tensor cores, is the limit, as the patch copies were on
// the TPU. The small tile that the budget leaves (64 pixels) makes it
// worse. A later version keeps dW in registers and streams the patch rows
// through a ring of TMA loads.

#include "conv_tiles.cuh"

namespace {

using namespace convk;
using bf16 = __nv_bfloat16;

constexpr int kTH = 4;    // tile rows, both types
constexpr int kTWb = 16;  // tile columns, bfloat16
constexpr int kTWf = 8;   // tile columns, float
constexpr int kPb = kTH * kTWb;  // 64 pixels
constexpr int kPf = kTH * kTWf;  // 32 pixels
constexpr int kSmemB = kPartial * 4 + kPb * kK9 * 2 + kPb * kC * 2;  // 229,376
constexpr int kSmemF = kPartial * 4 + kPf * kK9 * 4 + kPf * kC * 4;  // 229,376

// patches[p * 576 + t * 64 + c] = src at tap t of tile pixel p (tw columns
// a tile row), zero outside the image.
template <typename T>
__device__ void build_patches(T* patches, const T* __restrict__ src, int b, int h, int w,
                              int r0, int c0, int npix, int tw) {
  constexpr int V = 8;                       // channels a step
  constexpr int kVec = V * sizeof(T) / 16;   // int4s a step
  const int steps = npix * 9 * (kC / V);
  for (int g = threadIdx.x; g < steps; g += blockDim.x) {
    const int p = g / (9 * (kC / V));
    const int rem = g - p * (9 * (kC / V));
    const int t = rem / (kC / V);
    const int c = (rem - t * (kC / V)) * V;
    const int hh = r0 + p / tw + t / 3 - 1;
    const int ww = c0 + p % tw + t % 3 - 1;
    const bool in = hh >= 0 && hh < h && ww >= 0 && ww < w;
    const int4* s = reinterpret_cast<const int4*>(
        src + ((static_cast<size_t>(b) * h + hh) * w + ww) * kC + c);
    int4* d = reinterpret_cast<int4*>(patches + p * kK9 + t * kC + c);
#pragma unroll
    for (int v = 0; v < kVec; ++v) d[v] = in ? __ldg(s + v) : make_int4(0, 0, 0, 0);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
patch_bwd_bf16(const bf16* __restrict__ x, const bf16* __restrict__ dy,
               const bf16* __restrict__ w9, bf16* __restrict__ dx,
               float* __restrict__ partial, int h, int w, Tiles tiles) {
  using namespace nvcuda;
  extern __shared__ __align__(128) unsigned char smem[];
  float* dw = reinterpret_cast<float*>(smem);
  bf16* patches = reinterpret_cast<bf16*>(dw + kPartial);
  bf16* dyt = patches + kPb * kK9;  // the dy tile, then the rounding scratch
  float* scratch = reinterpret_cast<float*>(dyt) + (threadIdx.x >> 5) * 256;
  const int warp = threadIdx.x >> 5;

  zero_block(dw, kPartial);
  for (int k = blockIdx.x; k < tiles.n; k += gridDim.x) {
    int b, r0, c0;
    tiles.origin(k, &b, &r0, &c0);
    __syncthreads();  // dw zeroed; the previous tile's dx written
    build_patches(patches, x, b, h, w, r0, c0, kPb, kTWb);
    load_region(dyt, dy, b, h, w, r0, c0, kTH, kTWb);
    __syncthreads();

    // dW += X9^T @ dy over the tile's 4 chunks of 16 pixels
    dw_wmma(
        dw, kPb / 16, kK9,
        [&](int rb, int kc) {
          return static_cast<const bf16*>(patches + kc * 16 * kK9 + rb * 16);
        },
        [&](int kc) { return static_cast<const bf16*>(dyt + kc * 16 * kC); });
    __syncthreads();  // X9 consumed
    build_patches(patches, dy, b, h, w, r0, c0, kPb, kTWb);
    __syncthreads();

    // dx = DY9 @ W9flip: warp -> tile row warp / 2, channels 32 (warp % 2) ..
    const int mr = warp >> 1, n0 = (warp & 1) * 2;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
    wmma::fill_fragment(acc[0], 0.0f);
    wmma::fill_fragment(acc[1], 0.0f);
#pragma unroll 4
    for (int kk = 0; kk < kK9 / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::load_matrix_sync(a, patches + mr * 16 * kK9 + kk * 16, kK9);
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> wf;
        wmma::load_matrix_sync(wf, w9 + kk * 16 * kC + (n0 + n) * 16, kC);
        wmma::mma_sync(acc[n], a, wf, acc[n]);
      }
    }
    const int oh = r0 + mr;
#pragma unroll
    for (int n = 0; n < 2; ++n)
      store_frag<bf16>(scratch, acc[n], [&](int m) -> bf16* {
        const int ow = c0 + m;
        if (oh >= h || ow >= w) return nullptr;
        return dx + ((static_cast<size_t>(b) * h + oh) * w + ow) * kC + (n0 + n) * 16;
      });
  }
  __syncthreads();
  copy_block(partial + static_cast<size_t>(blockIdx.x) * kPartial, dw, kPartial);
}

__global__ void __launch_bounds__(kThreads, 1)
patch_bwd_f32(const float* __restrict__ x, const float* __restrict__ dy,
              const float* __restrict__ w9, float* __restrict__ dx,
              float* __restrict__ partial, int h, int w, Tiles tiles) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* dw = reinterpret_cast<float*>(smem);
  float* patches = dw + kPartial;
  float* dyt = patches + kPf * kK9;

  zero_block(dw, kPartial);
  for (int k = blockIdx.x; k < tiles.n; k += gridDim.x) {
    int b, r0, c0;
    tiles.origin(k, &b, &r0, &c0);
    __syncthreads();
    build_patches(patches, x, b, h, w, r0, c0, kPf, kTWf);
    load_region(dyt, dy, b, h, w, r0, c0, kTH, kTWf);
    __syncthreads();
    dw_fma(
        dw, kPf,
        [&](int p, int t) { return static_cast<const float*>(patches + p * kK9 + t * kC); },
        [&](int p) { return static_cast<const float*>(dyt + p * kC); });
    __syncthreads();
    build_patches(patches, dy, b, h, w, r0, c0, kPf, kTWf);
    __syncthreads();
    tap_gemm_fma<kPf / 16>(
        kPf, w9,
        [&](int p, int t) { return static_cast<const float*>(patches + p * kK9 + t * kC); },
        [&](int p, int ci0, const float* v) {
          const int oh = r0 + p / kTWf, ow = c0 + p % kTWf;
          if (oh < h && ow < w)
            *reinterpret_cast<float4*>(
                dx + ((static_cast<size_t>(b) * h + oh) * w + ow) * kC + ci0) =
                make_float4(v[0], v[1], v[2], v[3]);
        });
  }
  __syncthreads();
  copy_block(partial + static_cast<size_t>(blockIdx.x) * kPartial, dw, kPartial);
}

Tiles tiles_for(int b, int h, int w, int bf16_) {
  return Tiles(b, h, w, kTH, bf16_ ? kTWb : kTWf);
}

}  // namespace

extern "C" {

// Blocks the tile kernel runs with: one per SM, at most one per tile. The
// workspace holds grid * 36,864 floats.
int conv_bwd_patch_grid(int b, int h, int w, int bf16_, int sms) {
  const int n = tiles_for(b, h, w, bf16_).n;
  return n < sms ? n : sms;
}

// As conv_bwd_tap (conv_bwd_tap.cu), in the patch-matrix form.
int conv_bwd_patch(const void* x, const void* dy, const void* w9, void* dx, void* dw,
                   void* workspace, int b, int h, int w, int grid, int bf16_,
                   void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  auto* ws = static_cast<float*>(workspace);
  if (b <= 0 || h <= 0 || w <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const Tiles tiles = tiles_for(b, h, w, bf16_);
  if (grid < 1 || grid > tiles.n) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (bf16_) {
    err = cudaFuncSetAttribute(patch_bwd_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemB);
    if (err != cudaSuccess) return static_cast<int>(err);
    patch_bwd_bf16<<<grid, kThreads, kSmemB, st>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(dy),
        static_cast<const bf16*>(w9), static_cast<bf16*>(dx), ws, h, w, tiles);
  } else {
    err = cudaFuncSetAttribute(patch_bwd_f32, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemF);
    if (err != cudaSuccess) return static_cast<int>(err);
    patch_bwd_f32<<<grid, kThreads, kSmemF, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(dy),
        static_cast<const float*>(w9), static_cast<float*>(dx), ws, h, w, tiles);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_sum(ws, grid, kPartial, kPartial, static_cast<float*>(dw), st);
}

}  // extern "C"
