// The bf16 per-tap tile routine of the 64-channel 3x3 conv backward on the
// tensor cores (sm_90a), shared by conv_bwd.cu (K2), conv_bwd_tap.cu (K4)
// and chain_bwd.cu (K5).
//
// An 8x16-pixel output tile reads its input x and its gradient g as
// zero-padded halos that TMA wrote with 128-byte swizzle (one pixel, all
// 64 channels, a 128-byte row; tiles 1 KiB aligned). The nine taps are
// shifted views of the halos, read in place by ldmatrix, which takes one
// address per 8-element row (wgmma's shared-memory descriptors cannot
// express a view shifted by one pixel):
//   - dW (`dw_tile`): mma.sync.m16n8k16; warp w owns 9 of the 36 16-row
//     blocks (tap, 16 input channels) times 32 output channels, 144 floats
//     that stay in accumulator registers across all of a block's tiles;
//   - dx (`dx_taps`): wgmma with A, the gradient halo's shifted rows, from
//     registers (ldmatrix) and B, the tap's block of W9T[t*64 + ci, co] =
//     W9flip[t*64 + co, ci], from shared memory; summed in float over the
//     576-deep (tap, co) product.
// `tap_tiles` is K2's and K4's whole tile loop around them.

#pragma once

#include <cuda_bf16.h>

#include "hopper.cuh"

namespace taptile {

using bf16 = __nv_bfloat16;

constexpr int kC = 64;
constexpr int kK9 = 9 * kC;                        // 576
constexpr int kPartial = kK9 * kC;                 // 36,864 floats: one dW
constexpr int kTH = 8;                             // tile rows
constexpr int kTW = 16;                            // tile columns
constexpr int kHaloW = kTW + 2;                    // 18
constexpr int kHaloPix = (kTH + 2) * kHaloW;       // 180 pixels, 128 B each
constexpr int kHaloBytes = kHaloPix * 128;         // 23,040
constexpr int kHaloPitch = 23 * 1024;              // 1 KiB aligned, for the swizzle
constexpr int kW9Bytes = kK9 * 128;                // 72 KiB of W9T
constexpr int kCluster = 4;
constexpr int kWarps = 8;                          // two warpgroups
constexpr int kThreads = kWarps * 32;

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d[64 x 64] += A[64 x 16] @ B[16 x 64]: A from registers (each warp of
// the warpgroup its 16 rows, laid out as mma.sync's A fragment), B K-major
// from 128-byte-swizzled shared memory
__device__ __forceinline__ void wgmma_m64n64_rs(float (&d)[32], const uint32_t (&a)[4],
                                                uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31},"
      " {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
// the same with 32 output columns
__device__ __forceinline__ void wgmma_m64n32_rs(float (&d)[16], const uint32_t (&a)[4],
                                                uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15},"
      " {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d[16 x 8] += A[16 x 16] @ B[16 x 8], bf16 in, float accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One tile's dW products into warp `warp`'s accumulators: acc_w[q] is the
// 16-row block mb = 9 * (warp & 3) + q (tap mb / 4, input channels 16 (mb
// % 4) ..) times output channels 32 (warp >> 2) + 8n ... `xh` is the input's
// 10x18 halo, `gh` the gradient's halo, kGW pixels wide, in which tile
// pixel (0, 0) sits at row and column kGOff. Pixels outside the image must
// carry a zero gradient.
template <int kGW, int kGOff>
__device__ __forceinline__ void dw_tile(float (&acc_w)[9][4][4], uint32_t xh, uint32_t gh,
                                        int warp, int lane) {
  const int quad = lane >> 3;  // which 8x8 matrix of an x4 load this lane addresses
  const int r8 = lane & 7;     // and which of its rows
  const int mg = warp & 3, ng = warp >> 2;
#pragma unroll 1
  for (int ks = 0; ks < kTH; ++ks) {
    // B (the gradient at the tile's pixels, transposed): rows = pixels
    // (quad & 1) * 8 + r8 of tile row ks, channels 32ng + 8 (2p + quad/2)
    uint32_t bt[2][4];
    const int hpd = (ks + kGOff) * kGW + kGOff + (quad & 1) * 8 + r8;
#pragma unroll
    for (int p = 0; p < 2; ++p)
      ldsm_x4_t(bt[p], gh + hop::swz(hpd, 4 * ng + 2 * p + (quad >> 1)));
#pragma unroll
    for (int q = 0; q < 9; ++q) {
      const int mb = 9 * mg + q;
      const int t = mb >> 2, cb = mb & 3;
      const int i = t / 3, j = t - (t / 3) * 3;
      // A (x at the tap's shifted pixels, transposed): rows = pixels
      // (quad >> 1) * 8 + r8, channels 16cb + 8 (quad & 1)
      uint32_t a[4];
      ldsm_x4_t(a, xh + hop::swz((ks + i) * kHaloW + (quad >> 1) * 8 + r8 + j,
                                 2 * cb + (quad & 1)));
#pragma unroll
      for (int n = 0; n < 4; ++n)
        mma_bf16(acc_w[q][n], a, bt[n >> 1][2 * (n & 1)], bt[n >> 1][2 * (n & 1) + 1]);
    }
  }
}

// acc (kN / 2 floats: a wgmma m64 x kN accumulator) = sum over the nine
// taps t = 3i + j of G_t @ W9T_t^T, where row m (0..15) of this warp's
// 16 rows of G_t is pixel row_pix(i, j, m) of the gradient halo `gh` and
// W9T_t is the tap's block at `w9` + t * 8 KiB, of which the kN columns
// from `w9`'s row offset are used (a 32-column half starts 4 KiB in).
// Each tap's products are waited for before the next tap's rows are
// loaded: the 144 dW accumulators beside them leave no registers for a
// second set of rows.
template <int kN, typename RowPix>
__device__ __forceinline__ void dx_taps(float (&acc)[kN / 2], uint32_t gh, uint32_t w9,
                                        int lane, RowPix row_pix) {
  const int quad = lane >> 3, r8 = lane & 7;
#pragma unroll
  for (int e = 0; e < kN / 2; ++e) acc[e] = 0.0f;
#pragma unroll 1
  for (int t = 0; t < 9; ++t) {
    const int i = t / 3, j = t - (t / 3) * 3;
    const int hp = row_pix(i, j, (quad & 1) * 8 + r8);
    uint32_t a[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) ldsm_x4(a[kk], gh + hop::swz(hp, 2 * kk + (quad >> 1)));
    hop::fence_regs(acc);
    hop::wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if constexpr (kN == 64)
        wgmma_m64n64_rs(acc, a[kk], hop::wg_desc(w9 + t * 8192 + kk * 32));
      else
        wgmma_m64n32_rs(acc, a[kk], hop::wg_desc(w9 + t * 8192 + kk * 32));
    }
    hop::wg_commit();
    hop::wg_wait<0>();
    hop::fence_regs(acc);
  }
}

// Write a warp's 144 dW accumulators into the block's (576 x 64 float)
// partial `part` (row t*64 + ci, column co).
__device__ __forceinline__ void store_dw(float* part, const float (&acc_w)[9][4][4], int warp,
                                         int lane) {
  const int mg = warp & 3, ng = warp >> 2;
#pragma unroll
  for (int q = 0; q < 9; ++q) {
    const int mb = 9 * mg + q;
    const int row = (mb >> 2) * kC + (mb & 3) * 16 + (lane >> 2);
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int half = 0; half < 2; ++half)
        *reinterpret_cast<float2*>(part + (row + 8 * half) * kC + 32 * ng + 8 * n +
                                   2 * (lane & 3)) =
            make_float2(acc_w[q][n][2 * half], acc_w[q][n][2 * half + 1]);
  }
}

// ------------------------------------------------- K2's and K4's tile loop

// Shared memory of a K2 / K4 block, from its 1 KiB-aligned base.
constexpr int kOffW9 = 0;                                // 72 KiB
constexpr int kOffStage = kW9Bytes;                      // 2 stages x (x halo, dy halo)
constexpr int kOffBar = kOffStage + 2 * 2 * kHaloPitch;  // full[2], empty[2], W9T's
constexpr int kSmem = kOffBar + 5 * 8 + 1024;            // + slack to align the base to 1 KiB
static_assert(kPartial * 4 <= kOffBar, "the dW partial reuses the tile buffers");

__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  const uint32_t a = hop::smem_u32(raw);
  return raw + (((a + 1023) & ~1023u) - a);
}

// Thread 0 issues the TMA loads of both halos of tile `tile` into stage
// `stage`, completing `bar`.
__device__ __forceinline__ void load_halos(unsigned char* stage, const CUtensorMap* map_x,
                                           const CUtensorMap* map_dy, uint64_t* bar, int tile,
                                           int tiles_h, int tiles_w) {
  const int per_image = tiles_h * tiles_w;
  const int b = tile / per_image;
  const int r = tile - b * per_image;
  const int r0 = (r / tiles_w) * kTH, c0 = (r % tiles_w) * kTW;
  hop::mbar_expect_tx(bar, 2 * kHaloBytes);
  hop::tma_load_4d(stage, map_x, 0, c0 - 1, r0 - 1, b, bar);
  hop::tma_load_4d(stage + kHaloPitch, map_dy, 0, c0 - 1, r0 - 1, b, bar);
}

// Thread 0: the stage barriers, and the first two tiles' halos.
__device__ __forceinline__ void start_tiles(unsigned char* smem, const CUtensorMap* map_x,
                                            const CUtensorMap* map_dy, int tiles_h,
                                            int tiles_w, int n_tiles) {
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kOffBar);
  uint64_t* empty = full + 2;
  for (int s = 0; s < 2; ++s) {
    hop::mbar_init(&full[s], 1);
    hop::mbar_init(&empty[s], kWarps);
  }
  hop::fence_barrier_init();
  hop::prefetch_map(map_x);
  hop::prefetch_map(map_dy);
  for (int s = 0; s < 2; ++s) {
    const int tile = blockIdx.x + s * gridDim.x;
    if (tile < n_tiles)
      load_halos(smem + kOffStage + s * 2 * kHaloPitch, map_x, map_dy, &full[s], tile, tiles_h,
                 tiles_w);
  }
}

// The block's tiles blockIdx.x, + gridDim.x, ...: both products of each,
// dx rounded to bf16 once and stored (NHWC), dW kept in registers; at the
// end the cluster sums its blocks' dW partials in rank order into the
// cluster's slot of `partial`. Expects start_tiles' loads in flight and
// W9T in place at kOffW9, visible to the async proxy, with every thread
// past a barrier since.
__device__ __forceinline__ void tap_tiles(unsigned char* smem, const CUtensorMap* map_x,
                                          const CUtensorMap* map_dy, bf16* __restrict__ dx,
                                          float* __restrict__ partial, int h, int wd,
                                          int tiles_h, int tiles_w, int n_tiles) {
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kOffBar);
  uint64_t* empty = full + 2;
  unsigned char* stages = smem + kOffStage;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int per_image = tiles_h * tiles_w;

  float acc_w[9][4][4];
#pragma unroll
  for (int q = 0; q < 9; ++q)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc_w[q][n][e] = 0.0f;

  const uint32_t w9 = hop::smem_u32(smem + kOffW9);
  int k = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++k) {
    const int b = tile / per_image;
    const int r = tile - b * per_image;
    const int r0 = (r / tiles_w) * kTH, c0 = (r % tiles_w) * kTW;
    const int s = k & 1;
    const uint32_t xh = hop::smem_u32(stages + s * 2 * kHaloPitch);
    const uint32_t dh = xh + kHaloPitch;
    hop::mbar_wait(&full[s], (k >> 1) & 1);
    __syncwarp();  // converged for the .aligned ldmatrix / mma

    // dx of tile row `warp` (the warpgroup's 64 pixels: tile rows 4 (warp
    // / 4) ..) x 64 channels
    float acc[32];
    dx_taps<64>(acc, dh, w9, lane,
                [&](int i, int j, int m) { return (warp + i) * kHaloW + m + j; });
    {
      const int oh = r0 + warp;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int ow = c0 + (lane >> 2) + 8 * half;
        if (oh < h && ow < wd) {
          bf16* out = dx + ((static_cast<size_t>(b) * h + oh) * wd + ow) * kC + 2 * (lane & 3);
#pragma unroll
          for (int n = 0; n < 8; ++n)
            *reinterpret_cast<__nv_bfloat162*>(out + 8 * n) =
                __floats2bfloat162_rn(acc[4 * n + 2 * half], acc[4 * n + 2 * half + 1]);
        }
      }
    }

    // dW share += X9^T dy over the tile's 8 rows of 16 pixels
    dw_tile<kHaloW, 1>(acc_w, xh, dh, warp, lane);
    __syncwarp();
    if (lane == 0) hop::mbar_arrive(&empty[s]);
    const int next = tile + 2 * gridDim.x;
    if (threadIdx.x == 0 && next < n_tiles) {
      hop::mbar_wait(&empty[s], (k >> 1) & 1);
      load_halos(stages + s * 2 * kHaloPitch, map_x, map_dy, &full[s], next, tiles_h, tiles_w);
    }
    __syncwarp();
  }

  // this block's dW partial -> its shared memory, then the cluster's sum
  __syncthreads();
  float* part = reinterpret_cast<float*>(smem);
  store_dw(part, acc_w, warp, lane);
  __syncthreads();
  hop::cluster_sum_partials<kCluster>(
      part, partial + static_cast<size_t>(blockIdx.x / kCluster) * kPartial, kPartial);
}

}  // namespace taptile
