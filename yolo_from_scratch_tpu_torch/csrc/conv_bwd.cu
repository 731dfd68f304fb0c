// Backward of a stride-1 SAME 3x3 convolution with 64 input and 64 output
// channels: dx and dW from one read of x and dy (sm_90a).
//
// Replaces the Pallas TPU kernel `yolo_from_scratch_tpu/ops/conv_bwd.py::
// _bwd_kernel` and computes what the plain version
// `yolo_from_scratch_tpu_torch/ops/conv_bwd.py::fused_bwd_plain` computes.
// With C = 64, t = 3i + j the tap and (B, H, W, C) channels-last tensors:
//
//   dW[t*C + ci, co] = sum_b sum_p X9_b[p, t*C + ci] * dy_b[p, co]
//                      (X9_b[p, t*C + ci] = x_b[p + (i - 1, j - 1), ci],
//                       zero outside the image), written as grad_w[co, ci, i, j];
//   dx[p, ci]        = sum_t sum_co dy[p + (i - 1, j - 1), co] * W9flip[t*C + co, ci]
//                      (W9flip[t*C + co, ci] = w[co, ci, 2 - i, 2 - j]).
//
// As the TPU kernel does, a tile reads x and dy once, as zero-padded halos,
// and the nine taps are shifted views of the halos.
//
// bfloat16: a persistent kernel on the tensor cores whose tile loop,
// `conv_tap_tile.cuh::tap_tiles`, K4 (conv_bwd_tap.cu) shares.
//   - The 10x18-pixel halos of x and dy around each 8x16-pixel output tile
//     arrive by TMA (one 4-D box a tensor, 128-byte swizzle, zeros outside
//     the image: the SAME padding), double-buffered behind mbarriers: thread
//     0 issues tile k + 2's loads into a stage as soon as all warps have
//     released it, so the next tile's halos arrive during this tile's
//     products. (No separate producer warp: a ninth warp caps ptxas at 168
//     registers a thread, and the 144 dW accumulators then spill.)
//   - Both products run on the tensor cores (bf16 in, float accumulate),
//     with the halos' shifted views read in place by ldmatrix; ldmatrix.trans
//     gives dW's transposed operands. The 128-byte swizzle puts eight
//     consecutive pixels on eight distinct bank groups.
//   - W9T[t*64 + ci, co] = W9flip[t*64 + co, ci] (72 KiB bf16) is built
//     from w (OIHW), which the autograd Function hands over as it is, once
//     per block, in 16-byte chunks swizzled as TMA would write them.
//   - dx: wgmma, each warpgroup 64 pixels (4 tile rows) x 64 channels, A
//     the dy halo's shifted rows in registers (warp w: tile row w), B the
//     tap's W9T block read by the tensor cores from shared memory; summed
//     over the 576-deep (tap, co) product and rounded to bf16 once.
//   - dW: mma.sync.m16n8k16; warp w owns 9 of the 36 16-row blocks (tap,
//     16 input channels) times 32 output channels, 144 floats that stay in
//     accumulator registers across all of the block's tiles.
//   - Blocks run in clusters of 4; at the end the cluster sums its four dW
//     partials in rank order through distributed shared memory and writes
//     one partial (at most 33 x 144 KiB = 4.87 MB on 132 SMs); the second
//     kernel sums those in cluster order and writes grad_w in OIHW. No float
//     atomics: two runs give the same bits.
// float32: 8x8-pixel tiles in FP32 FMAs from float halos (TF32 would miss
// the 1e-5 tolerance): W9flip (144 KiB float) in shared memory, dx as an
// implicit GEMM of 4 pixels x 4 channels a thread, each thread's 144-entry
// share of dW in registers across the block's tiles; one partial a block.
// Sums are explicit __fmaf_rn (the library is built with --fmad=false).
//
// What bounds it on the H100: at the training shapes (B=8, 40x40 and
// 80x80, bf16) the products are 1.9 / 7.6 GFLOP, about 2 / 8 us at the
// tensor cores' peak. The kernel is far from that: each call pays a fixed
// cost (building W9T, the first tile's halos, the cluster's dW reduction,
// and the second kernel's sum of up to 30 partials), and a tile's dW
// product is mma.sync fed by ldmatrix from shared memory (one x4 load for
// about three mma), with the dx wgmma waited for tap by tap. Only 30
// clusters of 4 (120 of 132 SMs) are resident at once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "conv_tap_tile.cuh"

namespace {

constexpr int kC = 64;
constexpr int kK9 = 9 * kC;         // 576
constexpr int kTile = 8;            // output tile edge, pixels
constexpr int kHalo = kTile + 2;    // 10
constexpr int kThreads = 256;
constexpr int kPartial = kK9 * kC;  // 36,864 floats per block
constexpr int kSmemFloats = kPartial + 2 * kHalo * kHalo * kC;
constexpr int kSmemBytes = kSmemFloats * 4;  // 198,656

// ------------------------------------------------------------- float32 path

__global__ void __launch_bounds__(kThreads, 1)
conv3x3_bwd_tiles(const float* __restrict__ x, const float* __restrict__ dy,
                  const float* __restrict__ w, float* __restrict__ dx,
                  float* __restrict__ partial, int h, int wd, int tiles_h,
                  int tiles_w, int n_tiles) {
  extern __shared__ __align__(16) float smem[];
  float* w9 = smem;                      // [t*64 + co][ci]
  float* xs = w9 + kPartial;             // [halo pixel][c]
  float* dys = xs + kHalo * kHalo * kC;  // [halo pixel][c]
  const int tid = threadIdx.x;

  // w is OIHW: g = (co*64 + ci)*9 + tap, tap = 3*kh + kw; the flipped tap
  // is t = 3*(2 - kh) + (2 - kw) = 8 - tap.
  for (int g = tid; g < kPartial; g += kThreads) {
    const int co = g / kK9;
    const int rem = g - co * kK9;
    const int ci = rem / 9;
    const int t = 8 - (rem - ci * 9);
    w9[(t * kC + co) * kC + ci] = w[g];
  }

  // dx mapping: input-channel quad cq, pixel group pg (4 pixels of a row)
  const int cq = tid & 15;
  const int pg = tid >> 4;
  const int prow = pg >> 1;
  const int pcol = (pg & 1) * 4;
  // dW mapping: input-channel pair cp, output-channel group cg (8 channels)
  const int cp = tid & 31;
  const int cg = tid >> 5;

  float accw[9][2][8];
#pragma unroll
  for (int t = 0; t < 9; ++t)
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int e = 0; e < 8; ++e) accw[t][q][e] = 0.0f;

  const int per_image = tiles_h * tiles_w;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int b = tile / per_image;
    const int r = tile - b * per_image;
    const int h0 = (r / tiles_w) * kTile;
    const int w0 = (r % tiles_w) * kTile;

    __syncthreads();  // W9flip written; the previous tile's halos consumed
    for (int g = tid; g < kHalo * kHalo * kC; g += kThreads) {
      const int pix = g / kC;
      const int c = g - pix * kC;
      const int hh = h0 - 1 + pix / kHalo;
      const int ww = w0 - 1 + pix % kHalo;
      float xv = 0.0f, dv = 0.0f;
      if (hh >= 0 && hh < h && ww >= 0 && ww < wd) {
        const size_t off = ((static_cast<size_t>(b) * h + hh) * wd + ww) * kC + c;
        xv = x[off];
        dv = dy[off];
      }
      xs[g] = xv;
      dys[g] = dv;
    }
    __syncthreads();

    // ---- dx for 4 pixels x 4 input channels ----
    float acc[4][4];
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[p][k] = 0.0f;
#pragma unroll 1
    for (int t = 0; t < 9; ++t) {
      const int i = t / 3, j = t - (t / 3) * 3;
      const float* drow = dys + ((prow + i) * kHalo + pcol + j) * kC;
      const float* wt = w9 + t * kC * kC + cq * 4;
#pragma unroll 8
      for (int co = 0; co < kC; ++co) {
        const float4 wv = *reinterpret_cast<const float4*>(wt + co * kC);
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          const float d = drow[p * kC + co];
          acc[p][0] = __fmaf_rn(d, wv.x, acc[p][0]);
          acc[p][1] = __fmaf_rn(d, wv.y, acc[p][1]);
          acc[p][2] = __fmaf_rn(d, wv.z, acc[p][2]);
          acc[p][3] = __fmaf_rn(d, wv.w, acc[p][3]);
        }
      }
    }
    const int oh = h0 + prow;
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int ow = w0 + pcol + p;
      if (oh < h && ow < wd) {
        float* out = dx + ((static_cast<size_t>(b) * h + oh) * wd + ow) * kC + cq * 4;
#pragma unroll
        for (int k = 0; k < 4; ++k) out[k] = acc[p][k];
      }
    }

    // ---- dW partial: pixels outside the image carry dy = 0 ----
#pragma unroll 1
    for (int p = 0; p < kTile * kTile; ++p) {
      const int ph = p / kTile, pw = p - (p / kTile) * kTile;
      const float* dv = dys + ((ph + 1) * kHalo + pw + 1) * kC + cg * 8;
      const float4 d0 = *reinterpret_cast<const float4*>(dv);
      const float4 d1 = *reinterpret_cast<const float4*>(dv + 4);
      const float d[8] = {d0.x, d0.y, d0.z, d0.w, d1.x, d1.y, d1.z, d1.w};
#pragma unroll
      for (int t = 0; t < 9; ++t) {
        const int i = t / 3, j = t % 3;
        const float2 xv = *reinterpret_cast<const float2*>(
            xs + ((ph + i) * kHalo + pw + j) * kC + 2 * cp);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          accw[t][0][e] = __fmaf_rn(xv.x, d[e], accw[t][0][e]);
          accw[t][1][e] = __fmaf_rn(xv.y, d[e], accw[t][1][e]);
        }
      }
    }
  }

  float* out = partial + static_cast<size_t>(blockIdx.x) * kPartial;
#pragma unroll
  for (int t = 0; t < 9; ++t)
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      float* row = out + (t * kC + 2 * cp + q) * kC + cg * 8;
      *reinterpret_cast<float4*>(row) =
          make_float4(accw[t][q][0], accw[t][q][1], accw[t][q][2], accw[t][q][3]);
      *reinterpret_cast<float4*>(row + 4) =
          make_float4(accw[t][q][4], accw[t][q][5], accw[t][q][6], accw[t][q][7]);
    }
}

// grad_w[co][ci][tap] = sum over blocks g = 0, 1, ... of partial[g][tap*64 + ci][co]
__global__ void conv3x3_bwd_reduce(const float* __restrict__ partial, int parts,
                                   float* __restrict__ dw) {
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= kPartial) return;
  float s = 0.0f;
  for (int g = 0; g < parts; ++g) s = __fadd_rn(s, partial[static_cast<size_t>(g) * kPartial + o]);
  const int co = o % kC;
  const int row = o / kC;
  const int ci = row % kC;
  const int t = row / kC;
  dw[(co * kC + ci) * 9 + t] = s;
}

// ------------------------------------------------------------ bfloat16 path

using bf16 = __nv_bfloat16;
namespace tt = taptile;

__global__ void __launch_bounds__(tt::kThreads, 1)
conv3x3_bwd_bf16(const __grid_constant__ CUtensorMap map_x,
                 const __grid_constant__ CUtensorMap map_dy, const bf16* __restrict__ w,
                 bf16* __restrict__ dx, float* __restrict__ partial, int h, int wd,
                 int tiles_h, int tiles_w, int n_tiles) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = tt::aligned_smem(smem_raw);
  if (threadIdx.x == 0) tt::start_tiles(smem, &map_x, &map_dy, tiles_h, tiles_w, n_tiles);

  // W9T[t*64 + ci][co] = w[co][ci][2 - i][2 - j] (w OIHW), one swizzled
  // 16-byte chunk (8 output channels) a step; neighbouring threads take
  // neighbouring input channels, so that their reads of w are close and
  // their chunks land in distinct bank groups
  static_assert(kK9 * 8 % tt::kThreads == 0, "whole chunks a thread");
#pragma unroll 6  // several chunks' loads in flight at once
  for (int it = 0; it < kK9 * 8 / tt::kThreads; ++it) {
    const int c = it * tt::kThreads + threadIdx.x;
    const int ci = c & (kC - 1), cc = (c >> 6) & 7, t = c >> 9;
    __align__(16) bf16 v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = w[((cc * 8 + e) * kC + ci) * 9 + 8 - t];
    *reinterpret_cast<int4*>(smem + tt::kOffW9 + hop::swz(t * kC + ci, cc)) =
        *reinterpret_cast<const int4*>(v);
  }
  // W9T is the wgmma B operand: make the generic-proxy writes visible to
  // the async proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  tt::tap_tiles(smem, &map_x, &map_dy, dx, partial, h, wd, tiles_h, tiles_w, n_tiles);
}

int launch_bf16(const void* x, const void* dy, const void* w, void* dx, float* dw,
                float* workspace, int b, int h, int wd, int grid, cudaStream_t stream) {
  const int tiles_h = (h + tt::kTH - 1) / tt::kTH;
  const int tiles_w = (wd + tt::kTW - 1) / tt::kTW;
  if (grid < tt::kCluster || grid % tt::kCluster != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap mx, mdy;
  int rc = hop::nhwc_map(&mx, x, b, h, wd, tt::kTH + 2, tt::kHaloW);
  if (rc == 0) rc = hop::nhwc_map(&mdy, dy, b, h, wd, tt::kTH + 2, tt::kHaloW);
  if (rc != 0) return rc;
  cudaError_t err = cudaFuncSetAttribute(conv3x3_bwd_bf16,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, tt::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  rc = hop::launch_clustered(conv3x3_bwd_bf16, grid, tt::kThreads, tt::kSmem, tt::kCluster,
                             stream, mx, mdy, static_cast<const bf16*>(w),
                             static_cast<bf16*>(dx), workspace, h, wd, tiles_h, tiles_w,
                             b * tiles_h * tiles_w);
  if (rc != 0) return rc;
  conv3x3_bwd_reduce<<<(kPartial + 255) / 256, 256, 0, stream>>>(workspace,
                                                                  grid / tt::kCluster, dw);
  return static_cast<int>(cudaGetLastError());
}

int launch_f32(const void* x, const void* dy, const void* w, void* dx, float* dw,
               float* workspace, int b, int h, int wd, int grid, cudaStream_t stream) {
  const int tiles_h = (h + kTile - 1) / kTile;
  const int tiles_w = (wd + kTile - 1) / kTile;
  const int n_tiles = b * tiles_h * tiles_w;
  if (grid < 1 || grid > n_tiles) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      conv3x3_bwd_tiles, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  conv3x3_bwd_tiles<<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(dy), static_cast<const float*>(w),
      static_cast<float*>(dx), workspace, h, wd, tiles_h, tiles_w, n_tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  conv3x3_bwd_reduce<<<(kPartial + 255) / 256, 256, 0, stream>>>(workspace, grid, dw);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launch geometry of the tile kernel for bfloat16 (bf16 = 1) or float32,
// the one source of it that the wrapper reads: out[0], out[1] the output
// tile's rows and columns, out[2] the blocks of a cluster (1: no clusters),
// out[3] the floats of one dW partial in the workspace (one a cluster, else
// one a block), out[4] the clusters the card holds at once (0 unclustered).
// Returns 0, or cudaErrorInvalidValue if the card cannot run a cluster.
int conv3x3_bwd_geometry(int bf16, int* out) {
  out[0] = bf16 ? tt::kTH : kTile;
  out[1] = bf16 ? tt::kTW : kTile;
  out[2] = bf16 ? tt::kCluster : 1;
  out[3] = kPartial;
  out[4] = bf16 ? hop::max_active_clusters(conv3x3_bwd_bf16, tt::kThreads, tt::kSmem,
                                           tt::kCluster)
                : 0;
  return bf16 && out[4] < 1 ? static_cast<int>(cudaErrorInvalidValue) : 0;
}

// x, dy, dx (B, H, W, 64) channels-last and w (64, 64, 3, 3) OIHW, all
// float32 (bf16 = 0) or all bfloat16 (bf16 = 1); dw (64, 64, 3, 3) float32.
// Tiles, grid and workspace as conv3x3_bwd_geometry gives them: bfloat16
// in clusters (grid a multiple of the cluster, a partial a cluster; x and dy
// dense and 16-byte aligned for TMA), float32 one block per SM (1 <= grid <=
// tiles, a partial a block). Launches two kernels on `stream`, does not
// synchronise; returns a cudaError_t (0 on success).
int conv3x3_bwd(const void* x, const void* dy, const void* w, void* dx, void* dw,
                void* workspace, int b, int h, int wd, int grid, int bf16,
                void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  auto* dwf = static_cast<float*>(dw);
  auto* ws = static_cast<float*>(workspace);
  if (b <= 0 || h <= 0 || wd <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (bf16) return launch_bf16(x, dy, w, dx, dwf, ws, b, h, wd, grid, st);
  return launch_f32(x, dy, w, dx, dwf, ws, b, h, wd, grid, st);
}

const char* conv3x3_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
