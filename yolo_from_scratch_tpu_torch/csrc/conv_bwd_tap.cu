// Backward of a stride-1 SAME 3x3 convolution with 64 channels in and out,
// in the per-tap form: dx and dW from one read of x and dy, with no patch
// matrix (sm_90a).
//
// Replaces the Pallas TPU kernel `benchmarks/bwdproto.py::_bwd_kernel_v2`
// and computes what `yolo_from_scratch_tpu_torch/benchmarks/bwdproto.py::
// fused_bwd_tap_plain` computes. With t = 3i + j and (B, H, W, 64) NHWC
// tensors, for every tap t:
//
//   dW[t*64 + ci, co] += sum_p x[p + (i - 1, j - 1), ci] * dy[p, co]
//   dx[p, ci]         += sum_co dy[p + (i - 1, j - 1), co] * W9flip[t*64 + co, ci]
//
// reading the 9 shifted views of the zero-padded x and dy halos in shared
// memory in place; dx is summed in float and rounded to the input type once.
//
// Design. The TPU kernel walks the batch in order and carries dW across its
// grid; here block k takes tiles k, k + gridDim.x, ... in no fixed order
// against the other blocks, keeps its dW partial (576 x 64 float, 144 KiB)
// in shared memory across its tiles, writes it to a workspace at the end,
// and a second kernel sums the partials in block order: no atomics, the
// same bits on every run.
//   - bfloat16: 8x16-pixel tiles, so that a 16-pixel wmma row is one tile
//     row and every shifted view is a strided matrix; both products run on
//     the tensor cores as 16x16x16 bf16 fragments with float accumulation
//     (bf16 x bf16 products are exact in float). Shared memory: the 10x18
//     halos of x and dy (22.5 KiB each, bf16), the dW partial, and 1 KiB a
//     warp to round dx fragments; W9flip is read from device memory (L2).
//   - float32: 8x8-pixel tiles in FP32 FMAs (TF32 fragments would miss the
//     1e-5 tolerance): each thread sums 4 pixels x 4 input channels of dx
//     and owns 144 entries of the dW partial.
//
// What bounds it on the H100: each per-tap product is [128 x 64] @ [64 x 64]
// (dx) or [64 x 16-pixel] @ [16 x 64] (dW), so a warp issues one mma per
// fragment it loads from shared memory: shared-memory bandwidth and the
// per-tile read-modify-write of the 144 KiB dW partial, not the tensor
// cores, set the pace. The fast version (a later change) keeps dW in
// registers, feeds wgmma from TMA-loaded tiles and reuses W9flip from
// shared memory.

#include "conv_tiles.cuh"

namespace {

using namespace convk;
using bf16 = __nv_bfloat16;

constexpr int kTH = 8;             // tile rows, both types
constexpr int kTWb = 16;           // tile columns, bfloat16 (one wmma row)
constexpr int kTWf = 8;            // tile columns, float
constexpr int kHaloB = (kTH + 2) * (kTWb + 2);  // 180 pixels
constexpr int kHaloF = (kTH + 2) * (kTWf + 2);  // 100 pixels
constexpr int kScratch = (kThreads / 32) * 256;  // floats, 1 KiB a warp
constexpr int kSmemB = (kPartial + kScratch) * 4 + 2 * kHaloB * kC * 2;  // 201,728
constexpr int kSmemF = (kPartial + 2 * kHaloF * kC) * 4;                 // 198,656

__global__ void __launch_bounds__(kThreads, 1)
tap_bwd_bf16(const bf16* __restrict__ x, const bf16* __restrict__ dy,
             const bf16* __restrict__ w9, bf16* __restrict__ dx,
             float* __restrict__ partial, int h, int w, Tiles tiles) {
  using namespace nvcuda;
  extern __shared__ __align__(128) unsigned char smem[];
  float* dw = reinterpret_cast<float*>(smem);
  float* scratch = dw + kPartial + (threadIdx.x >> 5) * 256;
  bf16* xh = reinterpret_cast<bf16*>(dw + kPartial + kScratch);
  bf16* dyh = xh + kHaloB * kC;
  constexpr int hw = kTWb + 2;  // halo row, pixels
  const int warp = threadIdx.x >> 5;

  zero_block(dw, kPartial);
  for (int k = blockIdx.x; k < tiles.n; k += gridDim.x) {
    int b, r0, c0;
    tiles.origin(k, &b, &r0, &c0);
    __syncthreads();  // dw zeroed; the previous tile's halos consumed
    load_region(xh, x, b, h, w, r0 - 1, c0 - 1, kTH + 2, hw);
    load_region(dyh, dy, b, h, w, r0 - 1, c0 - 1, kTH + 2, hw);
    __syncthreads();

    // dW: A^T = the shifted x view of tap rb / 4, channels 16 (rb % 4) ..;
    // k-chunk kc = tile row kc. Pixels outside the image carry dy = 0.
    dw_wmma(
        dw, kTH, kC,
        [&](int rb, int kc) {
          const int t = rb >> 2, i = t / 3, j = t - 3 * (t / 3);
          return static_cast<const bf16*>(xh + ((kc + i) * hw + j) * kC + (rb & 3) * 16);
        },
        [&](int kc) { return static_cast<const bf16*>(dyh + ((kc + 1) * hw + 1) * kC); });

    // dx: warp = tile row; 9 taps x 4 chunks of 16 output channels
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
#pragma unroll
    for (int n = 0; n < 4; ++n) wmma::fill_fragment(acc[n], 0.0f);
#pragma unroll 1
    for (int t = 0; t < 9; ++t) {
      const int i = t / 3, j = t - 3 * (t / 3);
#pragma unroll
      for (int ck = 0; ck < 4; ++ck) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, dyh + ((warp + i) * hw + j) * kC + ck * 16, kC);
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> wf;
          wmma::load_matrix_sync(wf, w9 + (t * kC + ck * 16) * kC + n * 16, kC);
          wmma::mma_sync(acc[n], a, wf, acc[n]);
        }
      }
    }
    const int oh = r0 + warp;
#pragma unroll
    for (int n = 0; n < 4; ++n)
      store_frag<bf16>(scratch, acc[n], [&](int m) -> bf16* {
        const int ow = c0 + m;
        if (oh >= h || ow >= w) return nullptr;
        return dx + ((static_cast<size_t>(b) * h + oh) * w + ow) * kC + n * 16;
      });
  }
  __syncthreads();
  copy_block(partial + static_cast<size_t>(blockIdx.x) * kPartial, dw, kPartial);
}

__global__ void __launch_bounds__(kThreads, 1)
tap_bwd_f32(const float* __restrict__ x, const float* __restrict__ dy,
            const float* __restrict__ w9, float* __restrict__ dx,
            float* __restrict__ partial, int h, int w, Tiles tiles) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* dw = reinterpret_cast<float*>(smem);
  float* xh = dw + kPartial;
  float* dyh = xh + kHaloF * kC;
  constexpr int hw = kTWf + 2;

  zero_block(dw, kPartial);
  for (int k = blockIdx.x; k < tiles.n; k += gridDim.x) {
    int b, r0, c0;
    tiles.origin(k, &b, &r0, &c0);
    __syncthreads();
    load_region(xh, x, b, h, w, r0 - 1, c0 - 1, kTH + 2, hw);
    load_region(dyh, dy, b, h, w, r0 - 1, c0 - 1, kTH + 2, hw);
    __syncthreads();
    dw_fma(
        dw, kTH * kTWf,
        [&](int p, int t) {
          const int i = t / 3, j = t - 3 * (t / 3);
          return static_cast<const float*>(xh + (((p >> 3) + i) * hw + (p & 7) + j) * kC);
        },
        [&](int p) {
          return static_cast<const float*>(dyh + (((p >> 3) + 1) * hw + (p & 7) + 1) * kC);
        });
    tap_gemm_fma<4>(
        kTH * kTWf, w9,
        [&](int p, int t) {
          const int i = t / 3, j = t - 3 * (t / 3);
          return static_cast<const float*>(dyh + (((p >> 3) + i) * hw + (p & 7) + j) * kC);
        },
        [&](int p, int ci0, const float* v) {
          const int oh = r0 + (p >> 3), ow = c0 + (p & 7);
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

// Launch geometry of the tile kernel, the one source of it that the wrapper
// reads, in conv3x3_bwd_geometry's layout: unclustered (one block per SM,
// whose shared memory holds one), a partial a block. Returns 0.
int conv_bwd_tap_geometry(int bf16_, int* out) {
  out[0] = kTH;
  out[1] = bf16_ ? kTWb : kTWf;
  out[2] = 1;
  out[3] = kPartial;
  out[4] = 0;
  return 0;
}

// x, dy, dx (B, H, W, 64) NHWC and w9 = W9flip (576, 64), all float32
// (bf16 = 0) or all bfloat16 (bf16 = 1); dw (3, 3, 64, 64) HWIO float32;
// grid and workspace as conv_bwd_tap_geometry gives them. Launches the
// tile kernel and the sum of the partials on `stream`, does not
// synchronise; returns cudaGetLastError() (0 on success).
int conv_bwd_tap(const void* x, const void* dy, const void* w9, void* dx, void* dw,
                 void* workspace, int b, int h, int w, int grid, int bf16_,
                 void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  auto* ws = static_cast<float*>(workspace);
  if (b <= 0 || h <= 0 || w <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const Tiles tiles = tiles_for(b, h, w, bf16_);
  if (grid < 1 || grid > tiles.n) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (bf16_) {
    err = cudaFuncSetAttribute(tap_bwd_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemB);
    if (err != cudaSuccess) return static_cast<int>(err);
    tap_bwd_bf16<<<grid, kThreads, kSmemB, st>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(dy),
        static_cast<const bf16*>(w9), static_cast<bf16*>(dx), ws, h, w, tiles);
  } else {
    err = cudaFuncSetAttribute(tap_bwd_f32, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemF);
    if (err != cudaSuccess) return static_cast<int>(err);
    tap_bwd_f32<<<grid, kThreads, kSmemF, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(dy),
        static_cast<const float*>(w9), static_cast<float*>(dx), ws, h, w, tiles);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_sum(ws, grid, kPartial, kPartial, static_cast<float*>(dw), st);
}

}  // extern "C"
