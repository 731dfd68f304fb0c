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
//   DY9               = the same patch matrix of dy
//   dx                = DY9 @ W9flip                          (rounded once)
//
// bfloat16: a persistent TMA + wgmma kernel, one block of two warpgroups
// per SM.
//   - The copy engine builds the patch matrix. For an 8x16-pixel tile, one
//     4-D TMA box (64 channels x 16 columns x 10 rows x 1 image) at
//     (c0 + j - 1, r0 - 1) holds the three taps (i, j), i = 0, 1, 2, of
//     column shift j: tap (i, j) is the box's rows 16i .. 16i + 127, a
//     1024-byte-aligned block of 128 pixel rows of 128 bytes (128-byte
//     swizzle), which is X9's (or DY9's) 64-column block t = 3i + j as a
//     wgmma operand. Coordinates outside the tensor read zeros, which is
//     exactly SAME padding. No thread writes a patch. A tile's three x
//     boxes and two dy boxes stream through a ring of kStages 20 KiB stages
//     guarded by mbarriers; the dy box at j = 1, which holds the dy tile
//     (its rows 16 ..), has a double-buffered slot of its own for both
//     products. (One box a tap, 9 + 8 loads of 16 KiB a tile, read 2.4x
//     the bytes from L2 and took 0.052 ms at B=8 80x80 on an H100 SXM at
//     700 W.) Thread 0 issues
//     every load, kStages ahead, refilling a stage as soon as all warps
//     have released it; a warpgroup issues a tap's products while the
//     previous tap's still run, and releases a stage when they finish. (A separate producer warp, the textbook shape,
//     makes the block nine warps, which caps ptxas at 168 registers a
//     thread: the 176 accumulator floats then spill.)
//   - W9flip, stored transposed per tap (W9T[t*64 + ci, co] =
//     w[2-i, 2-j, ci, co], 72 KiB), is loaded once per block by TMA and is
//     the B operand of every dx product.
//   - Two consumer warpgroups issue wgmma (bf16 in, float accumulate).
//     dW: warpgroup g owns output channels 32g .. 32g + 31 of all 576 rows,
//     nine m64n32 accumulators (144 floats a thread) that live in
//     registers across all of the block's tiles; A is the X9 block read
//     M-major (channels contiguous), B the dy tile read N-major, K the
//     tile's 128 pixels. dx: warpgroup g owns tile pixels 64g .. 64g + 63,
//     one m64n64 accumulator, K = 576 streamed through the DY9 blocks; it
//     is rounded to bf16 once and stored.
//   - Blocks run in clusters of 4. At the end each block writes its dW
//     partial to its own shared memory and the cluster sums the four in
//     rank order through distributed shared memory; one partial a cluster
//     (at most 33 x 144 KiB = 4.75 MB on 132 SMs) goes to the workspace,
//     and a second kernel sums those in cluster order. No float atomics:
//     two runs give the same bits.
// float32: 4x8-pixel tiles, threads build X9 / DY9 in shared memory and
// both products run in FP32 FMAs (TF32 would miss the 1e-5 tolerance),
// each block with a 144 KiB dW partial summed in block order.
//
// What bounds it on the H100: the products (2 x 2 x 128 x 576 x 64 FLOPs a
// tile) take the tensor cores little time; a tile's six boxes (120 KiB,
// 3.75 times the tile's x and dy, since every column shift loads its own
// box) come from L2 through one issuing thread that waits for both
// warpgroups, and that stream sets the pace.

#include <cuda_bf16.h>

#include "conv_tiles.cuh"
#include "hopper.cuh"

namespace {

using namespace convk;
using bf16 = __nv_bfloat16;

// ------------------------------------------------------------ bfloat16 path

constexpr int kTHb = 8;                        // tile rows
constexpr int kTWb = 16;                       // tile columns
constexpr int kBoxRows = kTHb + 2;             // a column-shift box: 10 x 16 pixels
constexpr int kBox = kBoxRows * kTWb * 128;    // 20 KiB, 128 B a pixel
constexpr int kTapStep = kTWb * 128;           // 2 KiB: one tile row, tap i -> i + 1
constexpr int kStages = 5;
constexpr int kCluster = 4;
constexpr int kWarpsB = 8;                     // two warpgroups
constexpr int kThreadsB = kWarpsB * 32;
constexpr int kLoadsPerTile = 5;               // ring loads: X at j = 0, 1, 2; dy at j = 0, 2
constexpr int kOffW9 = 0;                      // 9 x 8 KiB
constexpr int kOffDyc = kOffW9 + 9 * 8192;     // 2 x 20 KiB: dy at j = 1
constexpr int kOffRing = kOffDyc + 2 * kBox;   // kStages x 20 KiB
constexpr int kOffBar = kOffRing + kStages * kBox;
constexpr int kBars = 2 * kStages + 4 + 1;
constexpr int kSmemB = kOffBar + kBars * 8 + 1024;  // + slack to align the base to 1 KiB
static_assert(kPartial * 4 <= kOffBar, "the dW partial reuses the tile buffers");

// d[64 x 32] += A[64 x 16] @ B[16 x 32], A M-major and B N-major
__device__ __forceinline__ void wgmma_m64n32_mn(float (&d)[16], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15},"
      " %16, %17, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(1));
}

// d[64 x 64] += A[64 x 16] @ B[16 x 64], both K-major
__device__ __forceinline__ void wgmma_m64n64_k(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31},"
      " %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

// Thread 0 issues ring load `n` of this block (its tile n / 5, load
// q = n % 5: x at column shift j = q for q < 3, then dy at j = 0 and 2)
// into stage n % kStages, if that tile exists.
__device__ __forceinline__ void issue_ring(int n, unsigned char* ring, uint64_t* full,
                                           const CUtensorMap* map_x, const CUtensorMap* map_dy,
                                           const Tiles& tiles) {
  const int tile = blockIdx.x + (n / kLoadsPerTile) * gridDim.x;
  if (tile >= tiles.n) return;
  const int q = n % kLoadsPerTile, s = n % kStages;
  const int j = q < 3 ? q : 2 * (q - 3);
  int b, r0, c0;
  tiles.origin(tile, &b, &r0, &c0);
  hop::mbar_expect_tx(&full[s], kBox);
  hop::tma_load_4d(ring + s * kBox, q < 3 ? map_x : map_dy, 0, c0 + j - 1, r0 - 1, b, &full[s]);
}

// Thread 0 issues the dy box at column shift 1 of the block's k-th tile
// (its rows 1..8 are the dy tile) into slot k % 2.
__device__ __forceinline__ void issue_dyc(int k, unsigned char* dyc, uint64_t* dyc_full,
                                          const CUtensorMap* map_dy, const Tiles& tiles) {
  const int tile = blockIdx.x + k * gridDim.x;
  if (tile >= tiles.n) return;
  int b, r0, c0;
  tiles.origin(tile, &b, &r0, &c0);
  hop::mbar_expect_tx(&dyc_full[k & 1], kBox);
  hop::tma_load_4d(dyc + (k & 1) * kBox, map_dy, 0, c0, r0 - 1, b, &dyc_full[k & 1]);
}

__global__ void __launch_bounds__(kThreadsB, 1)
patch_bwd_bf16(const __grid_constant__ CUtensorMap map_x,
               const __grid_constant__ CUtensorMap map_dy,
               const __grid_constant__ CUtensorMap map_w9, bf16* __restrict__ dx,
               float* __restrict__ partial, int h, int w, Tiles tiles) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = hop::smem_u32(smem_raw);
  unsigned char* smem = smem_raw + (((raw + 1023) & ~1023u) - raw);
  unsigned char* ring = smem + kOffRing;
  unsigned char* dycs = smem + kOffDyc;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kOffBar);
  uint64_t* empty = full + kStages;
  uint64_t* dyc_full = empty + kStages;
  uint64_t* dyc_empty = dyc_full + 2;
  uint64_t* w9_full = dyc_empty + 2;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const bool issuer = threadIdx.x == 0;

  // Thread 0 is also the producer: W9T once, the first two dy tiles and
  // the first kStages ring loads now; later each load as soon as every warp
  // has released the buffer it goes into.
  if (issuer) {
    for (int s = 0; s < kStages; ++s) {
      hop::mbar_init(&full[s], 1);
      hop::mbar_init(&empty[s], kWarpsB);
    }
    for (int d = 0; d < 2; ++d) {
      hop::mbar_init(&dyc_full[d], 1);
      hop::mbar_init(&dyc_empty[d], kWarpsB);
    }
    hop::mbar_init(w9_full, 1);
    hop::fence_barrier_init();
    hop::prefetch_map(&map_x);
    hop::prefetch_map(&map_dy);
    hop::mbar_expect_tx(w9_full, 9 * 8192);
    for (int t = 0; t < 9; ++t)
      hop::tma_load_2d(smem + kOffW9 + t * 8192, &map_w9, 0, t * 64, w9_full);
    issue_dyc(0, dycs, dyc_full, &map_dy, tiles);
    issue_dyc(1, dycs, dyc_full, &map_dy, tiles);
    for (int n = 0; n < kStages; ++n) issue_ring(n, ring, full, &map_x, &map_dy, tiles);
  }
  __syncthreads();

  float acc_dw[9][16];
#pragma unroll
  for (int t = 0; t < 9; ++t)
#pragma unroll
    for (int e = 0; e < 16; ++e) acc_dw[t][e] = 0.0f;

  const int g = warp >> 2;   // warpgroup
  const int wq = warp & 3;   // warp within it: rows 16wq .. of a product
  const uint32_t w9 = hop::smem_u32(smem + kOffW9);
  const uint32_t ring_u = hop::smem_u32(ring);
  hop::mbar_wait(w9_full, 0);
  __syncwarp();
  int n = 0;  // ring loads consumed
  // Release ring load m's stage; thread 0 then refills it with load
  // m + kStages. Each tap's products run while the next tap's are issued:
  // a stage is released once the group after it has been committed and
  // its own group has finished (wgmma.wait_group 1).
  auto release = [&](int m) {
    const int s = m % kStages;
    __syncwarp();
    if (lane == 0) hop::mbar_arrive(&empty[s]);
    if (issuer) {
      hop::mbar_wait(&empty[s], (m / kStages) & 1);
      issue_ring(m + kStages, ring, full, &map_x, &map_dy, tiles);
    }
    __syncwarp();  // the warp reconverges before its next .aligned instruction
  };
  int k = 0;
  for (int tile = blockIdx.x; tile < tiles.n; tile += gridDim.x, ++k) {
    int b, r0, c0;
    tiles.origin(tile, &b, &r0, &c0);
    const int d = k & 1;
    const uint32_t dyc = hop::smem_u32(dycs + d * kBox);
    hop::mbar_wait(&dyc_full[d], (k >> 1) & 1);
    __syncwarp();

    // dW[t*64 + ci, 32g + c] += sum over the tile's pixels p of
    // X9[p, t*64 + ci] * dy[p, 32g + c]; tap t = 3i + j is rows 16i ..
    // 16i + 127 of the x box at column shift j, the dy tile rows 16 .. of
    // the centre box
    const uint32_t dyt = dyc + kTapStep;
#pragma unroll
    for (int j = 0; j < 3; ++j, ++n) {
      hop::mbar_wait(&full[n % kStages], (n / kStages) & 1);
      __syncwarp();
      const uint32_t xs = ring_u + (n % kStages) * kBox;
#pragma unroll
      for (int i = 0; i < 3; ++i) hop::fence_regs(acc_dw[3 * i + j]);
      hop::wg_fence();
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int kk = 0; kk < 8; ++kk)
          wgmma_m64n32_mn(acc_dw[3 * i + j], hop::wg_desc(xs + i * kTapStep + kk * 2048),
                          hop::wg_desc(dyt + kk * 2048 + g * 64));
      hop::wg_commit();
      if (j > 0) {
        hop::wg_wait<1>();
#pragma unroll
        for (int i = 0; i < 3; ++i) hop::fence_regs(acc_dw[3 * i + j - 1]);
        release(n - 1);
      }
    }
    hop::wg_wait<0>();
#pragma unroll
    for (int i = 0; i < 3; ++i) hop::fence_regs(acc_dw[3 * i + 2]);
    release(n - 1);

    // dx[64g + m, ci] = sum over taps t and channels co of
    // DY9[64g + m, t*64 + co] * W9T[t*64 + ci, co], tap t = 3i + j from
    // the dy box at column shift j
    float acc[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[e] = 0.0f;
    int pending = -1;  // the ring load the previous column shift read
#pragma unroll 1
    for (int j = 0; j < 3; ++j) {
      uint32_t src = dyc;
      if (j != 1) {
        hop::mbar_wait(&full[n % kStages], (n / kStages) & 1);
        __syncwarp();
        src = ring_u + (n % kStages) * kBox;
      }
      hop::fence_regs(acc);
      hop::wg_fence();
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_m64n64_k(acc, hop::wg_desc(src + i * kTapStep + g * 8192 + kk * 32),
                         hop::wg_desc(w9 + (3 * i + j) * 8192 + kk * 32));
      hop::wg_commit();
      hop::wg_wait<1>();
      if (pending >= 0) release(pending);
      pending = j != 1 ? n++ : -1;
    }
    hop::wg_wait<0>();
    hop::fence_regs(acc);
    release(pending);
    __syncwarp();
    if (lane == 0) hop::mbar_arrive(&dyc_empty[d]);
    if (issuer && blockIdx.x + (k + 2) * gridDim.x < tiles.n) {
      hop::mbar_wait(&dyc_empty[d], (k >> 1) & 1);
      issue_dyc(k + 2, dycs, dyc_full, &map_dy, tiles);
    }
    __syncwarp();

    // accumulator row m = 16wq + lane/4 (+8), column 8j + 2(lane%4) (+1)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int p = 64 * g + 16 * wq + (lane >> 2) + 8 * half;
      const int oh = r0 + p / kTWb, ow = c0 + p % kTWb;
      if (oh < h && ow < w) {
        bf16* out = dx + ((static_cast<size_t>(b) * h + oh) * w + ow) * kC + 2 * (lane & 3);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(out + 8 * j) =
              __floats2bfloat162_rn(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
      }
    }
  }

  // this block's dW partial -> its shared memory (row t*64 + ci, column co)
  __syncthreads();
  float* part = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int t = 0; t < 9; ++t)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int ci = 16 * wq + (lane >> 2) + 8 * half;
        const int co = 32 * g + 8 * j + 2 * (lane & 3);
        *reinterpret_cast<float2*>(part + (t * kC + ci) * kC + co) =
            make_float2(acc_dw[t][4 * j + 2 * half], acc_dw[t][4 * j + 2 * half + 1]);
      }
  __syncthreads();
  hop::cluster_sum_partials<kCluster>(
      part, partial + static_cast<size_t>(blockIdx.x / kCluster) * kPartial, kPartial);
}

// ------------------------------------------------------------- float32 path

constexpr int kTHf = 4;    // tile rows
constexpr int kTWf = 8;    // tile columns
constexpr int kPf = kTHf * kTWf;  // 32 pixels
constexpr int kSmemF = kPartial * 4 + kPf * kK9 * 4 + kPf * kC * 4;  // 229,376

// patches[p * 576 + t * 64 + c] = src at tap t of tile pixel p (tw columns
// a tile row), zero outside the image.
__device__ void build_patches(float* patches, const float* __restrict__ src, int b, int h,
                              int w, int r0, int c0, int npix, int tw) {
  constexpr int V = 4;  // channels a step: one float4
  const int steps = npix * 9 * (kC / V);
  for (int g = threadIdx.x; g < steps; g += blockDim.x) {
    const int p = g / (9 * (kC / V));
    const int rem = g - p * (9 * (kC / V));
    const int t = rem / (kC / V);
    const int c = (rem - t * (kC / V)) * V;
    const int hh = r0 + p / tw + t / 3 - 1;
    const int ww = c0 + p % tw + t % 3 - 1;
    const bool in = hh >= 0 && hh < h && ww >= 0 && ww < w;
    const float4* s = reinterpret_cast<const float4*>(
        src + ((static_cast<size_t>(b) * h + hh) * w + ww) * kC + c);
    *reinterpret_cast<float4*>(patches + p * kK9 + t * kC + c) =
        in ? __ldg(s) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
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
    load_region(dyt, dy, b, h, w, r0, c0, kTHf, kTWf);
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
  return bf16_ ? Tiles(b, h, w, kTHb, kTWb) : Tiles(b, h, w, kTHf, kTWf);
}

int launch_bf16(const void* x, const void* dy, const void* w9t, void* dx, float* ws, int b,
                int h, int w, int grid, const Tiles& tiles, cudaStream_t st) {
  if (grid % kCluster != 0) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap mx, mdy, mw;
  int rc = hop::nhwc_map(&mx, x, b, h, w, kBoxRows, kTWb);
  if (rc == 0) rc = hop::nhwc_map(&mdy, dy, b, h, w, kBoxRows, kTWb);
  if (rc == 0) rc = hop::w9t_map(&mw, w9t);
  if (rc != 0) return rc;
  cudaError_t err =
      cudaFuncSetAttribute(patch_bwd_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemB);
  if (err != cudaSuccess) return static_cast<int>(err);
  return hop::launch_clustered(patch_bwd_bf16, grid, kThreadsB, kSmemB, kCluster, st, mx, mdy,
                               mw, static_cast<bf16*>(dx), ws, h, w, tiles);
}

}  // namespace

extern "C" {

// Launch geometry of the tile kernel for bfloat16 (bf16 = 1) or float32,
// the one source of it that the wrapper reads: out[0], out[1] the output
// tile's rows and columns, out[2] the blocks of a cluster (1: no clusters),
// out[3] the floats of one dW partial in the workspace (one a cluster, else
// one a block), out[4] the clusters the card holds at once (0 unclustered).
// Returns 0, or cudaErrorInvalidValue if the card cannot run a cluster.
int conv_bwd_patch_geometry(int bf16_, int* out) {
  out[0] = bf16_ ? kTHb : kTHf;
  out[1] = bf16_ ? kTWb : kTWf;
  out[2] = bf16_ ? kCluster : 1;
  out[3] = kPartial;
  out[4] = bf16_ ? hop::max_active_clusters(patch_bwd_bf16, kThreadsB, kSmemB, kCluster) : 0;
  return bf16_ && out[4] < 1 ? static_cast<int>(cudaErrorInvalidValue) : 0;
}

// x, dy, dx (B, H, W, 64) NHWC and the weights, all float32 (bf16 = 0) or
// all bfloat16 (bf16 = 1); the weights are W9flip (576, 64), row t*64 + co,
// in float32 and W9T (576, 64), row t*64 + ci, column co, in bfloat16. dw
// (3, 3, 64, 64) HWIO float32; grid and workspace as
// conv_bwd_patch_geometry gives them. The bfloat16 tensors must be dense
// and 16-byte aligned (TMA). Launches the tile kernel and the sum of the partials on `stream`,
// does not synchronise; returns a cudaError_t (0 on success).
int conv_bwd_patch(const void* x, const void* dy, const void* w9, void* dx, void* dw,
                   void* workspace, int b, int h, int w, int grid, int bf16_,
                   void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  auto* ws = static_cast<float*>(workspace);
  if (b <= 0 || h <= 0 || w <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const Tiles tiles = tiles_for(b, h, w, bf16_);
  int rc;
  if (bf16_) {
    if (grid < kCluster) return static_cast<int>(cudaErrorInvalidValue);
    rc = launch_bf16(x, dy, w9, dx, ws, b, h, w, grid, tiles, st);
  } else {
    if (grid < 1 || grid > tiles.n) return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = cudaFuncSetAttribute(
        patch_bwd_f32, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemF);
    if (err != cudaSuccess) return static_cast<int>(err);
    patch_bwd_f32<<<grid, kThreads, kSmemF, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(dy),
        static_cast<const float*>(w9), static_cast<float*>(dx), ws, h, w, tiles);
    rc = static_cast<int>(cudaGetLastError());
  }
  if (rc != 0) return rc;
  return launch_sum(ws, bf16_ ? grid / kCluster : grid, kPartial, kPartial,
                    static_cast<float*>(dw), st);
}

}  // extern "C"
