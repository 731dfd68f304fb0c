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
// bfloat16: a persistent, warp-specialised kernel on the tensor cores.
//   - The 10x18-pixel halos of x and dy around each 8x16-pixel output tile
//     arrive by TMA (one 4-D box a tensor, 128-byte swizzle, zeros outside
//     the image: the SAME padding), double-buffered behind mbarriers: thread
//     0 issues tile k + 2's loads into a stage as soon as all warps have
//     released it, so the next tile's halos arrive during this tile's
//     products. (No separate producer warp: a ninth warp caps ptxas at 168
//     registers a thread, and the 144 dW accumulators then spill.)
//   - Both products run on the tensor cores (bf16 in, float accumulate),
//     with the halos' shifted views read in place by ldmatrix, which takes
//     one address per 8-element row (wgmma's shared-memory descriptors
//     cannot express a view shifted by one pixel); ldmatrix.trans gives
//     dW's transposed operands. The 128-byte swizzle puts eight consecutive
//     pixels on eight distinct bank groups.
//   - W9T[t*64 + ci, co] = W9flip[t*64 + co, ci] (72 KiB bf16) is built
//     from w (OIHW) once per block, in 16-byte chunks swizzled the same way.
//   - dx: wgmma, each warpgroup 64 pixels (4 tile rows) x 64 channels, A
//     the dy halo's shifted rows in registers (warp w: tile row w), B the
//     tap's W9T block read by the tensor cores from shared memory; summed
//     over the 576-deep (tap, co) product and rounded to bf16 once.
//   - dW: mma.sync.m16n8k16; warp w owns 9 of the 36 16-row blocks (tap,
//     16 input channels) times 32 output channels, 144 floats that stay in
//     accumulator registers across all of the block's tiles.
//   - Blocks run in clusters of 4; at the end the cluster sums its four dW
//     partials in rank order through distributed shared memory and writes
//     one partial (at most 33 x 144 KiB = 4.75 MB on 132 SMs); the second
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

#include "hopper.cuh"

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

constexpr int kTHb = 8;                            // tile rows
constexpr int kTWb = 16;                           // tile columns
constexpr int kHaloW = kTWb + 2;                   // 18
constexpr int kHaloPix = (kTHb + 2) * kHaloW;      // 180 pixels, 128 B each
constexpr int kHaloBytes = kHaloPix * 128;         // 23,040
constexpr int kHaloPitch = 23 * 1024;              // 1 KiB aligned, for the swizzle
constexpr int kCluster = 4;
constexpr int kWarpsB = 8;
constexpr int kThreadsB = kWarpsB * 32;
constexpr int kOffW9 = 0;                          // 72 KiB
constexpr int kOffStage = kK9 * 128;               // 2 stages x (x halo, dy halo)
constexpr int kOffBar = kOffStage + 2 * 2 * kHaloPitch;
constexpr int kSmemB = kOffBar + 4 * 8 + 1024;     // + slack to align the base to 1 KiB
static_assert(kPartial * 4 <= kOffBar, "the dW partial reuses the tile buffers");

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

// d[16 x 8] += A[16 x 16] @ B[16 x 8], bf16 in, float accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Thread 0 issues the TMA loads of both halos of tile `tile` into stage
// `stage`, completing `bar`.
__device__ __forceinline__ void load_halos(unsigned char* stage, const CUtensorMap* map_x,
                                           const CUtensorMap* map_dy, uint64_t* bar, int tile,
                                           int tiles_h, int tiles_w) {
  const int per_image = tiles_h * tiles_w;
  const int b = tile / per_image;
  const int r = tile - b * per_image;
  const int r0 = (r / tiles_w) * kTHb, c0 = (r % tiles_w) * kTWb;
  hop::mbar_expect_tx(bar, 2 * kHaloBytes);
  hop::tma_load_4d(stage, map_x, 0, c0 - 1, r0 - 1, b, bar);
  hop::tma_load_4d(stage + kHaloPitch, map_dy, 0, c0 - 1, r0 - 1, b, bar);
}

__global__ void __launch_bounds__(kThreadsB, 1)
conv3x3_bwd_bf16(const __grid_constant__ CUtensorMap map_x,
                 const __grid_constant__ CUtensorMap map_dy, const bf16* __restrict__ w,
                 bf16* __restrict__ dx, float* __restrict__ partial, int h, int wd,
                 int tiles_h, int tiles_w, int n_tiles) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = hop::smem_u32(smem_raw);
  unsigned char* smem = smem_raw + (((raw + 1023) & ~1023u) - raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kOffBar);
  uint64_t* empty = full + 2;
  unsigned char* stages = smem + kOffStage;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int per_image = tiles_h * tiles_w;

  // Thread 0 keeps both stages loaded: the first two tiles now, tile k + 2
  // into stage k % 2 once all warps have released it.
  if (threadIdx.x == 0) {
    for (int s = 0; s < 2; ++s) {
      hop::mbar_init(&full[s], 1);
      hop::mbar_init(&empty[s], kWarpsB);
    }
    hop::fence_barrier_init();
    hop::prefetch_map(&map_x);
    hop::prefetch_map(&map_dy);
    for (int s = 0; s < 2; ++s) {
      const int tile = blockIdx.x + s * gridDim.x;
      if (tile < n_tiles)
        load_halos(stages + s * 2 * kHaloPitch, &map_x, &map_dy, &full[s], tile, tiles_h,
                   tiles_w);
    }
  }

  // W9T[t*64 + ci][co] = w[co][ci][2 - i][2 - j] (w OIHW), one swizzled
  // 16-byte chunk (8 output channels) a step; neighbouring threads take
  // neighbouring input channels, so that their reads of w are close and
  // their chunks land in distinct bank groups
  static_assert(kK9 * 8 % kThreadsB == 0, "whole chunks a thread");
#pragma unroll 6  // several chunks' loads in flight at once
  for (int it = 0; it < kK9 * 8 / kThreadsB; ++it) {
    const int c = it * kThreadsB + threadIdx.x;
    const int ci = c & (kC - 1), cc = (c >> 6) & 7, t = c >> 9;
    __align__(16) bf16 v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = w[((cc * 8 + e) * kC + ci) * 9 + 8 - t];
    *reinterpret_cast<int4*>(smem + kOffW9 + hop::swz(t * kC + ci, cc)) =
        *reinterpret_cast<const int4*>(v);
  }
  // W9T is the wgmma B operand: make the generic-proxy writes visible to
  // the async proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  // dW share: 16-row block mb = 9 * (warp & 3) + q (tap mb / 4, input
  // channels 16 (mb % 4) ..), output channels 32 (warp >> 2) + 8n ..
  float acc_w[9][4][4];
#pragma unroll
  for (int q = 0; q < 9; ++q)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc_w[q][n][e] = 0.0f;

  const uint32_t w9 = hop::smem_u32(smem + kOffW9);
  const int quad = lane >> 3;  // which 8x8 matrix of an x4 load this lane addresses
  const int r8 = lane & 7;     // and which of its rows
  const int mg = warp & 3, ng = warp >> 2;
  int k = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++k) {
    const int b = tile / per_image;
    const int r = tile - b * per_image;
    const int r0 = (r / tiles_w) * kTHb, c0 = (r % tiles_w) * kTWb;
    const int s = k & 1;
    const uint32_t xh = hop::smem_u32(stages + s * 2 * kHaloPitch);
    const uint32_t dh = xh + kHaloPitch;
    hop::mbar_wait(&full[s], (k >> 1) & 1);
    __syncwarp();  // converged for the .aligned ldmatrix / mma

    // ---- dx of tile row `warp`: 16 pixels x 64 channels ----
    // wgmma: the warpgroup's 64 pixels (tile rows 4 (warp / 4) ..) x 64
    // channels, A = the shifted dy halo rows from registers (ldmatrix), B =
    // tap t's W9T block from shared memory
    float acc[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[e] = 0.0f;
#pragma unroll 1
    for (int t = 0; t < 9; ++t) {
      const int i = t / 3, j = t - (t / 3) * 3;
      // A rows: pixels (quad & 1) * 8 + r8 of the shifted halo row
      const int hp = (warp + i) * kHaloW + (quad & 1) * 8 + r8 + j;
      uint32_t a[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) ldsm_x4(a[kk], dh + hop::swz(hp, 2 * kk + (quad >> 1)));
      hop::fence_regs(acc);
      hop::wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_m64n64_rs(acc, a[kk], hop::wg_desc(w9 + t * 8192 + kk * 32));
      hop::wg_commit();
      hop::wg_wait<0>();
      hop::fence_regs(acc);
    }
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

    // ---- dW share += X9^T dy over the tile's 8 rows of 16 pixels ----
#pragma unroll 1
    for (int ks = 0; ks < kTHb; ++ks) {
      // B (dy at the tile's pixels, transposed): rows = pixels
      // (quad & 1) * 8 + r8 of tile row ks, channels 32ng + 8 (2p + quad/2)
      uint32_t bt[2][4];
      const int hpd = (ks + 1) * kHaloW + 1 + (quad & 1) * 8 + r8;
#pragma unroll
      for (int p = 0; p < 2; ++p)
        ldsm_x4_t(bt[p], dh + hop::swz(hpd, 4 * ng + 2 * p + (quad >> 1)));
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
    __syncwarp();
    if (lane == 0) hop::mbar_arrive(&empty[s]);
    const int next = tile + 2 * gridDim.x;
    if (threadIdx.x == 0 && next < n_tiles) {
      hop::mbar_wait(&empty[s], (k >> 1) & 1);
      load_halos(stages + s * 2 * kHaloPitch, &map_x, &map_dy, &full[s], next, tiles_h,
                 tiles_w);
    }
    __syncwarp();
  }

  // this block's dW partial -> its shared memory (row t*64 + ci, column co)
  __syncthreads();
  float* part = reinterpret_cast<float*>(smem);
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
  __syncthreads();
  hop::cluster_sum_partials<kCluster>(
      part, partial + static_cast<size_t>(blockIdx.x / kCluster) * kPartial, kPartial);
}

int launch_bf16(const void* x, const void* dy, const void* w, void* dx, float* dw,
                float* workspace, int b, int h, int wd, int grid, cudaStream_t stream) {
  const int tiles_h = (h + kTHb - 1) / kTHb;
  const int tiles_w = (wd + kTWb - 1) / kTWb;
  if (grid < kCluster || grid % kCluster != 0) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap mx, mdy;
  int rc = hop::nhwc_map(&mx, x, b, h, wd, kTHb + 2, kHaloW);
  if (rc == 0) rc = hop::nhwc_map(&mdy, dy, b, h, wd, kTHb + 2, kHaloW);
  if (rc != 0) return rc;
  cudaError_t err = cudaFuncSetAttribute(conv3x3_bwd_bf16,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemB);
  if (err != cudaSuccess) return static_cast<int>(err);
  rc = hop::launch_clustered(conv3x3_bwd_bf16, grid, kThreadsB, kSmemB, kCluster, stream, mx,
                             mdy, static_cast<const bf16*>(w), static_cast<bf16*>(dx),
                             workspace, h, wd, tiles_h, tiles_w, b * tiles_h * tiles_w);
  if (rc != 0) return rc;
  conv3x3_bwd_reduce<<<(kPartial + 255) / 256, 256, 0, stream>>>(workspace, grid / kCluster, dw);
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
  out[0] = bf16 ? kTHb : kTile;
  out[1] = bf16 ? kTWb : kTile;
  out[2] = bf16 ? kCluster : 1;
  out[3] = kPartial;
  out[4] = bf16 ? hop::max_active_clusters(conv3x3_bwd_bf16, kThreadsB, kSmemB, kCluster) : 0;
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
