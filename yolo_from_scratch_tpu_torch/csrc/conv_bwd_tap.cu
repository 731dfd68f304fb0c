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
// bfloat16: K2's tile routine (`conv_tap_tile.cuh`, shared with
// conv_bwd.cu): a persistent kernel of two warpgroups a block, in clusters
// of 4.
//   - The 10x18 halos of x and dy around each 8x16 output tile arrive by
//     TMA (zeros outside the image: the SAME padding), double-buffered
//     behind mbarriers; thread 0 issues them.
//   - dW by ldmatrix + mma.sync, 144 accumulator floats a thread held in
//     registers across all of the block's tiles; dx by wgmma with A (the
//     dy halo's shifted rows) from registers and B from W9T in shared
//     memory, summed over 576 in float and rounded to bf16 once.
//   - W9T (576, 64), row t*64 + ci, column co, is prepared once by the
//     wrapper (`bwdproto.flip9t`) and loaded by TMA into the 128-byte-
//     swizzled layout that wgmma reads: each block of a cluster issues a
//     quarter of the nine 8 KiB tap blocks, multicast to all four, so a
//     cluster reads W9T from L2 once. (K2 builds the same layout from OIHW
//     w inside every block, 8 gathered loads per 16-byte chunk.)
//   - At the end the cluster sums its four dW partials in rank order
//     through distributed shared memory and writes one partial (at most 33
//     x 144 KiB = 4.87 MB on 132 SMs); a second kernel sums those in
//     cluster order. No float atomics: two runs give the same bits.
// float32: 8x8-pixel tiles in FP32 FMAs (TF32 would miss the 1e-5
// tolerance): each thread sums 4 pixels x 4 input channels of dx, and the
// block's 144 KiB dW partial lives in shared memory; one partial a block.
//
// What bounds it on the H100: as K2, the products are 1.9 / 7.6 GFLOP at
// B=8 40x40 / 80x80 (about 2 / 8 us at the tensor cores' peak); a call
// pays a fixed cost (the first tile's halos and W9T, the cluster's dW
// reduction, the second kernel's sum of up to 33 partials), and a tile's dW
// product is mma.sync fed by ldmatrix (one x4 load for about three mma),
// with the dx wgmma waited for tap by tap.

#include "conv_tap_tile.cuh"
#include "conv_tiles.cuh"

namespace {

using namespace convk;
using bf16 = __nv_bfloat16;
namespace tt = taptile;

// ------------------------------------------------------------ bfloat16 path

__global__ void __launch_bounds__(tt::kThreads, 1)
tap_bwd_bf16(const __grid_constant__ CUtensorMap map_x,
             const __grid_constant__ CUtensorMap map_dy,
             const __grid_constant__ CUtensorMap map_w9, bf16* __restrict__ dx,
             float* __restrict__ partial, int h, int wd, int tiles_h, int tiles_w,
             int n_tiles) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = tt::aligned_smem(smem_raw);
  uint64_t* w9_full = reinterpret_cast<uint64_t*>(smem + tt::kOffBar) + 4;
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  if (threadIdx.x == 0) {
    hop::mbar_init(w9_full, 1);
    tt::start_tiles(smem, &map_x, &map_dy, tiles_h, tiles_w, n_tiles);
    hop::prefetch_map(&map_w9);
  }
  cluster.sync();  // every block's W9T barrier is initialised before any multicast
  if (threadIdx.x == 0)
    hop::load_w9t_multicast(smem + tt::kOffW9, &map_w9, w9_full,
                            static_cast<int>(cluster.block_rank()), tt::kCluster, 0xF);
  hop::mbar_wait(w9_full, 0);
  tt::tap_tiles(smem, &map_x, &map_dy, dx, partial, h, wd, tiles_h, tiles_w, n_tiles);
}

int launch_bf16(const void* x, const void* dy, const void* w9t, void* dx, float* ws, int b,
                int h, int wd, int grid, cudaStream_t st) {
  const int tiles_h = (h + tt::kTH - 1) / tt::kTH;
  const int tiles_w = (wd + tt::kTW - 1) / tt::kTW;
  if (grid < tt::kCluster || grid % tt::kCluster != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap mx, mdy, mw;
  int rc = hop::nhwc_map(&mx, x, b, h, wd, tt::kTH + 2, tt::kHaloW);
  if (rc == 0) rc = hop::nhwc_map(&mdy, dy, b, h, wd, tt::kTH + 2, tt::kHaloW);
  if (rc == 0) rc = hop::w9t_map(&mw, w9t);
  if (rc != 0) return rc;
  const cudaError_t err =
      cudaFuncSetAttribute(tap_bwd_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize, tt::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  return hop::launch_clustered(tap_bwd_bf16, grid, tt::kThreads, tt::kSmem, tt::kCluster, st,
                               mx, mdy, mw, static_cast<bf16*>(dx), ws, h, wd, tiles_h, tiles_w,
                               b * tiles_h * tiles_w);
}

// ------------------------------------------------------------- float32 path

constexpr int kTH = 8;             // tile rows
constexpr int kTWf = 8;            // tile columns
constexpr int kHaloF = (kTH + 2) * (kTWf + 2);  // 100 pixels
constexpr int kSmemF = (kPartial + 2 * kHaloF * kC) * 4;  // 198,656

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

}  // namespace

extern "C" {

// Launch geometry of the tile kernel for bfloat16 (bf16 = 1) or float32, in
// conv3x3_bwd_geometry's layout: bfloat16 8x16 tiles in clusters of 4, a
// partial a cluster; float32 8x8 tiles, one block per SM, a partial a
// block. Returns 0, or cudaErrorInvalidValue if the card cannot run a
// cluster.
int conv_bwd_tap_geometry(int bf16_, int* out) {
  out[0] = bf16_ ? tt::kTH : kTH;
  out[1] = bf16_ ? tt::kTW : kTWf;
  out[2] = bf16_ ? tt::kCluster : 1;
  out[3] = kPartial;
  out[4] = bf16_ ? hop::max_active_clusters(tap_bwd_bf16, tt::kThreads, tt::kSmem, tt::kCluster)
                 : 0;
  return bf16_ && out[4] < 1 ? static_cast<int>(cudaErrorInvalidValue) : 0;
}

// x, dy, dx (B, H, W, 64) NHWC and the weights, all float32 (bf16 = 0) or
// all bfloat16 (bf16 = 1); the weights are W9flip (576, 64), row t*64 + co,
// in float32 and W9T (576, 64), row t*64 + ci, column co, in bfloat16. dw
// (3, 3, 64, 64) HWIO float32; grid and workspace as conv_bwd_tap_geometry
// gives them. The bfloat16 tensors must be dense and 16-byte aligned
// (TMA). Launches the tile kernel and the sum of the partials on `stream`,
// does not synchronise; returns a cudaError_t (0 on success).
int conv_bwd_tap(const void* x, const void* dy, const void* w9, void* dx, void* dw,
                 void* workspace, int b, int h, int w, int grid, int bf16_,
                 void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  auto* ws = static_cast<float*>(workspace);
  if (b <= 0 || h <= 0 || w <= 0) return static_cast<int>(cudaErrorInvalidValue);
  int rc;
  if (bf16_) {
    rc = launch_bf16(x, dy, w9, dx, ws, b, h, w, grid, st);
  } else {
    const Tiles tiles(b, h, w, kTH, kTWf);
    if (grid < 1 || grid > tiles.n) return static_cast<int>(cudaErrorInvalidValue);
    const cudaError_t err =
        cudaFuncSetAttribute(tap_bwd_f32, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemF);
    if (err != cudaSuccess) return static_cast<int>(err);
    tap_bwd_f32<<<grid, kThreads, kSmemF, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(dy),
        static_cast<const float*>(w9), static_cast<float*>(dx), ws, h, w, tiles);
    rc = static_cast<int>(cudaGetLastError());
  }
  if (rc != 0) return rc;
  return launch_sum(ws, bf16_ ? grid / tt::kCluster : grid, kPartial, kPartial,
                    static_cast<float*>(dw), st);
}

}  // extern "C"
