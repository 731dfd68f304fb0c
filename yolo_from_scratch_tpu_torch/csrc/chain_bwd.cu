// Backward through a whole bottleneck chain in one kernel (sm_90a):
//
//   z1 = conv1(x) * s1;  a1 = silu(z1);  y = x + conv2(a1) * s2
//
// with both convs 3x3 stride 1 SAME, 64 channels in and out, and s1, s2
// per-channel (folded BatchNorm) scales in float. Given dy it returns dx,
// dw1 and dw2:
//
//   dz2 = round(dy * s2)
//   dw2[t] = sum_p a1[p + shift_t] (x) dz2[p]    da1 = sum_t shift_t(dz2) @ W2flip[t]
//   dz1 = round(da1 * silu'(z1) * s1),  silu'(z) = sig * (1 + z * (1 - sig))
//   dw1[t] = sum_p x[p + shift_t] (x) dz1[p]     dx = round(sum_t shift_t(dz1) @ W1flip[t] + dy)
//
// where round() is to the compute type (float or bfloat16) and every sum is
// float. Replaces the Pallas TPU kernel `benchmarks/blockbwd.py::
// _chain_bwd_kernel` and computes what `yolo_from_scratch_tpu_torch/
// benchmarks/blockbwd.py::chain_bwd_plain` computes. The point of the TPU
// kernel is that dz1 never goes to device memory; here it lives only in
// shared memory. For an output tile T, dx needs dz1 on T plus a one-pixel
// ring, hence da1 there, hence dz2 on T plus two pixels: each tile
// recomputes da1 on its ring. A ring pixel outside the image gets dz1 = 0
// and dz2 = 0, as the zero borders of the TPU kernel's g1pad and g2pad give.
//
// bfloat16: every product on the tensor cores (bf16 in, float accumulate),
// in clusters of 4 blocks made of two pairs. Two dW accumulators (2 x
// 36,864 floats) exceed one SM's 65,536 registers, so a pair splits the
// chain by its convs and each block keeps one dW in registers across all
// of its tiles, as K2 does (`conv_tap_tile.cuh`):
//   - Block A (even rank, conv2's backward) holds W2T in shared memory. For
//     8x16 tile k it loads by TMA the a1 halo (10x18) and dy on the
//     two-pixel ring (12x20), turns dy into dz2 = bf16(dy * s2) in place,
//     adds tile k's products to dw2 (ldmatrix + mma.sync), and computes da1
//     on the ring's 180 pixels by wgmma with A from registers: three m64
//     row blocks, the first two one per warpgroup with all 64 channels, the
//     third split by its 32-channel halves between the warpgroups, so both
//     do 1.5 m64n64 products. Its epilogue forms dz1 = bf16(da1 * silu'(z1)
//     * s1) (zero outside the image) and stores it, swizzled as a TMA halo,
//     straight into block B's shared memory (distributed shared memory).
//   - Block B (odd rank, conv1's backward) holds W1T in shared memory and
//     loads the x halo and z1 on A's ring by TMA. At the start of a step it
//     computes silu'(z1) (expf, not __expf) on A's ring in float into A's
//     shared memory and signals A through an mbarrier there (release and
//     acquire at cluster scope); then for its own tile it computes dx by
//     wgmma, adds dy at the tile's pixels in float and rounds once, and
//     adds to dw1. silu' is elementwise in z1 alone, so moving it to B,
//     which had half of each step to spare, changes no bit of the result.
//   - The pair runs in lock-step with the other pair of its cluster: in
//     step s, A works on tile s while B works on tile s - 1 from the other
//     of its two dz1 buffers; a cluster barrier ends each step, which
//     publishes A's dz1 stores to B, tells B that A is done with the silu'
//     buffer, and frees the stages that the next TMA loads (issued by
//     thread 0, two tiles ahead) go into.
//   - W2T and W1T (prepared once by the wrapper, `bwdproto.flip9t`) arrive
//     by TMA, each multicast to the two blocks that use it.
//   - At the end each dW is summed over the two blocks of the cluster that
//     hold it, in rank order, through distributed shared memory; one (dw1,
//     dw2) partial a cluster (at most 33 x 288 KiB = 9.7 MB on 132 SMs) goes
//     to the workspace, and a second kernel sums those in cluster order. No
//     float atomics: two runs give the same bits.
//   The 8x16 tile is kept because it is what the shared routine and its
//   one-tile-row-per-warp dx mapping take; the ring's 1.41x overhead of
//   da1 falls on A, silu' on B, which leaves the two about even.
// float32: 8x8 tiles, one block per SM, in FP32 FMAs from float halos
// (TF32 would miss the 1e-5 tolerance), each block's two dW partials in
// its slice of the device workspace, read and written once a tile, summed
// in block order by the second kernel; W1flip and W2flip are read a tap at
// a time from device memory (L2).
//
// Sums are explicit __fmaf_rn / __fadd_rn where the order matters (the
// library is built with --fmad=false).
//
// What bounds it on the H100: the four products are 2 x 1.9 / 7.6 GFLOP at
// B=8 40x40 / 80x80 plus the ring's 1.41x of da1 (about 4 / 15 us at the
// tensor cores' peak). A step lasts as long as the slower block of the
// cluster (A: dz2, dw2 by mma.sync from ldmatrix, 1.5 products of da1
// waited for tap by tap and the dz1 epilogue; B: silu' with an accurate
// expf on 180 x 64 values, dx and dw1), about 10 us each at 80x80, plus
// ~2 us of barrier and waiting; a call pays ~17 us of fixed cost (the
// first tile's loads, both weights, the cluster's dW sums and the second
// kernel) and one step more than a pair has tiles.

#include "conv_tap_tile.cuh"
#include "conv_tiles.cuh"

namespace {

using namespace convk;
using bf16 = __nv_bfloat16;
namespace tt = taptile;
namespace cg = cooperative_groups;

// ------------------------------------------------------------ bfloat16 path

constexpr int kR2W = tt::kTW + 4;                    // 20: the two-pixel ring's width
constexpr int kR2Bytes = (tt::kTH + 4) * kR2W * 128;  // 30 KiB: dy, then dz2, on it
constexpr int kRing = tt::kHaloPix;                  // 180 pixels of the one-pixel ring
constexpr int kGradBytes = kRing * kC * 4;           // silu'(z1) on the ring, float
// Shared memory from the 1 KiB-aligned base. A: W2T, two stages of (a1
// halo, dy -> dz2 on the two-pixel ring), the silu' buffer that B fills.
// B: W1T, two x-halo stages, the two dz1 buffers that A fills, two stages
// of z1 on the one-pixel ring.
constexpr int kOffW = 0;
constexpr int kOffStage = tt::kW9Bytes;
constexpr int kStageA = tt::kHaloPitch + kR2Bytes;       // 53 KiB
constexpr int kOffA1 = 0;                                // in an A stage
constexpr int kOffDz2 = tt::kHaloPitch;
constexpr int kBytesA = tt::kHaloBytes + kR2Bytes;       // TMA bytes of an A stage
constexpr int kOffGrad = kOffStage + 2 * kStageA;        // A's
constexpr int kOffDz1 = kOffStage + 2 * tt::kHaloPitch;  // B's
constexpr int kOffZ1 = kOffDz1 + 2 * tt::kHaloPitch;     // B's
// full[2] (A's or B's tile stages), the weights', zfull[2] (B's z1
// stages), grad_ready (A's: every thread of B arrives once a tile)
constexpr int kOffBar = kOffGrad + 2 * tt::kHaloPitch;
constexpr int kSmemB = kOffBar + 6 * 8 + 1024;           // + slack to align the base
static_assert(kGradBytes <= 2 * tt::kHaloPitch, "the silu' buffer fits its slot");
static_assert(kOffZ1 + 2 * tt::kHaloPitch <= kOffBar, "B's buffers fit in A's layout");
static_assert(kSmemB <= 232448, "one block's shared memory");
static_assert(tt::kPartial * 4 <= kOffBar, "the dW partial reuses the tile buffers");

// Byte offset of channel c (even) of ring pixel q in the silu' buffer: 256
// bytes a pixel, its 16-byte chunks of 4 channels XOR-swizzled by the
// pixel, so that a warp's float2 reads of 8 pixels hit distinct banks.
__device__ __forceinline__ uint32_t grad_off(int q, int c) {
  return static_cast<uint32_t>(q * 256 + ((((c >> 2) ^ (q & 7)) << 4) | ((c & 3) << 2)));
}

// Thread 0 issues the TMA loads of the block's tile `tile` into stage s:
// A's a1 halo and dy ring, or B's x halo.
__device__ __forceinline__ void issue_tile(unsigned char* smem, bool conv2, int s, int tile,
                                           const Tiles& tiles, uint64_t* full,
                                           const CUtensorMap* map_x, const CUtensorMap* map_a1,
                                           const CUtensorMap* map_dy) {
  int b, r0, c0;
  tiles.origin(tile, &b, &r0, &c0);
  if (conv2) {
    unsigned char* st = smem + kOffStage + s * kStageA;
    hop::mbar_expect_tx(&full[s], kBytesA);
    hop::tma_load_4d(st + kOffA1, map_a1, 0, c0 - 1, r0 - 1, b, &full[s]);
    hop::tma_load_4d(st + kOffDz2, map_dy, 0, c0 - 2, r0 - 2, b, &full[s]);
  } else {
    hop::mbar_expect_tx(&full[s], tt::kHaloBytes);
    hop::tma_load_4d(smem + kOffStage + s * tt::kHaloPitch, map_x, 0, c0 - 1, r0 - 1, b,
                     &full[s]);
  }
}

// Thread 0 of B issues the TMA load of z1 on the ring of tile `tile` into
// z1 stage s.
__device__ __forceinline__ void issue_z1(unsigned char* smem, int s, int tile,
                                         const Tiles& tiles, uint64_t* zfull,
                                         const CUtensorMap* map_z1) {
  int b, r0, c0;
  tiles.origin(tile, &b, &r0, &c0);
  hop::mbar_expect_tx(&zfull[s], tt::kHaloBytes);
  hop::tma_load_4d(smem + kOffZ1 + s * tt::kHaloPitch, map_z1, 0, c0 - 1, r0 - 1, b, &zfull[s]);
}

// Block B, for A's tile j (z1 stage j % 2): silu'(z1) on the tile's ring,
// float, into A's buffer `dst`; then every thread arrives on A's
// `grad_ready` (rank `rank_a`), which releases its stores to A.
__device__ __forceinline__ void silu_grad_ring(unsigned char* smem, int j, uint64_t* zfull,
                                               unsigned char* dst, uint64_t* grad_ready,
                                               int rank_a) {
  hop::mbar_wait(&zfull[j & 1], (j >> 1) & 1);
  const unsigned char* z1s = smem + kOffZ1 + (j & 1) * tt::kHaloPitch;
  for (int g = threadIdx.x; g < kRing * (kC / 4); g += tt::kThreads) {
    const int q = g / (kC / 4), c = 4 * (g % (kC / 4));
    const uint2 raw = *reinterpret_cast<const uint2*>(z1s + hop::swz(q, c >> 3) + 2 * (c & 7));
    const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    const float z[4] = {lo.x, lo.y, hi.x, hi.y};
    float grad[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float sig = 1.0f / (1.0f + expf(-z[e]));
      grad[e] = sig * (1.0f + z[e] * (1.0f - sig));
    }
    *reinterpret_cast<float4*>(dst + grad_off(q, c)) =
        make_float4(grad[0], grad[1], grad[2], grad[3]);
  }
  hop::mbar_arrive_remote(grad_ready, static_cast<uint32_t>(rank_a));
}

// dz1 = bf16(da1 * silu'(z1) * s1) of a warp's wgmma rows into `dst` (B's
// dz1 buffer, laid out as a TMA halo): rows q0 + lane / 4 (+ 8) of the
// ring, channels c0 + 8n + 2 (lane % 4) (+ 1), silu' from `grad`; rows
// past the ring are padding, pixels outside the image get 0.
template <int kN>
__device__ __forceinline__ void store_dz1(const float (&acc)[kN / 2], int q0, int ch0,
                                          const unsigned char* grad, unsigned char* dst,
                                          const float* __restrict__ s1, int r0, int c0, int h,
                                          int w, int lane) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int q = q0 + (lane >> 2) + 8 * half;
    if (q >= kRing) continue;
    const int qr = q / tt::kHaloW;
    const int gr = r0 - 1 + qr, gc = c0 - 1 + q - qr * tt::kHaloW;
    const bool in = gr >= 0 && gr < h && gc >= 0 && gc < w;
#pragma unroll
    for (int n = 0; n < kN / 8; ++n) {
      const int c = ch0 + 8 * n + 2 * (lane & 3);
      __nv_bfloat162 v = __floats2bfloat162_rn(0.0f, 0.0f);
      if (in) {
        const float2 g = *reinterpret_cast<const float2*>(grad + grad_off(q, c));
        const float2 s = __ldg(reinterpret_cast<const float2*>(s1 + c));
        v = __floats2bfloat162_rn(acc[4 * n + 2 * half] * g.x * s.x,
                                  acc[4 * n + 2 * half + 1] * g.y * s.y);
      }
      *reinterpret_cast<__nv_bfloat162*>(dst + hop::swz(q, c >> 3) + 2 * (c & 7)) = v;
    }
  }
}

// Block A's tile k (stage k % 2): dz2 in place, dw2 += its products, da1
// on the ring -> dz1 into B's buffer `dz1_dst`, once B has put silu'(z1)
// for the tile in place (`grad_ready`).
__device__ __forceinline__ void conv2_tile(unsigned char* smem, int k, int tile,
                                           const Tiles& tiles, uint64_t* full,
                                           uint64_t* grad_ready, unsigned char* dz1_dst,
                                           const float* __restrict__ s1,
                                           const float* __restrict__ s2, int h, int w,
                                           float (&acc_w)[9][4][4]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int b, r0, c0;
  tiles.origin(tile, &b, &r0, &c0);
  unsigned char* st = smem + kOffStage + (k & 1) * kStageA;
  hop::mbar_wait(&full[k & 1], (k >> 1) & 1);

  // dz2 = bf16(dy * s2) on the two-pixel ring, in place: 16-byte chunk g
  // of the swizzled box holds channels 8 ((g % 8) ^ (pixel % 8)) ..
  unsigned char* r2 = st + kOffDz2;
  for (int g = threadIdx.x; g < kR2Bytes / 16; g += tt::kThreads) {
    const int c = 8 * ((g & 7) ^ ((g >> 3) & 7));
    uint4 v = *reinterpret_cast<const uint4*>(r2 + 16 * g);
    __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(&v);
    const float4 sa = __ldg(reinterpret_cast<const float4*>(s2 + c));
    const float4 sb = __ldg(reinterpret_cast<const float4*>(s2 + c + 4));
    const float sc[8] = {sa.x, sa.y, sa.z, sa.w, sb.x, sb.y, sb.z, sb.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float2 f = __bfloat1622float2(e[q]);
      e[q] = __floats2bfloat162_rn(f.x * sc[2 * q], f.y * sc[2 * q + 1]);
    }
    *reinterpret_cast<uint4*>(r2 + 16 * g) = v;
  }
  // a later TMA load (the async proxy) rewrites this stage
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  const uint32_t a1h = hop::smem_u32(st + kOffA1);
  const uint32_t dz2h = hop::smem_u32(r2);
  const uint32_t w2 = hop::smem_u32(smem + kOffW);
  tt::dw_tile<kR2W, 2>(acc_w, a1h, dz2h, warp, lane);

  // da1 on the ring: ring pixel q (row q / 18, column q % 18 from the
  // tile's origin minus one) reads dz2 at (q / 18 + i, q % 18 + j)
  const int wg = warp >> 2, wq = warp & 3;
  const unsigned char* grad = smem + kOffGrad;
  {  // rows 64 wg .. 64 wg + 63, all 64 channels
    float acc[32];
    tt::dx_taps<64>(acc, dz2h, w2, lane, [&](int i, int j, int m) {
      const int q = 64 * wg + 16 * wq + m;
      return (q / tt::kHaloW + i) * kR2W + q % tt::kHaloW + j;
    });
    hop::mbar_wait<true>(grad_ready, k & 1);
    store_dz1<64>(acc, 64 * wg + 16 * wq, 0, grad, dz1_dst, s1, r0, c0, h, w, lane);
  }
  __syncwarp();  // converged again for the .aligned ldmatrix / wgmma
  {  // rows 128 .. 191 (180 and up padding), channels 32 wg .. 32 wg + 31
    float acc[16];
    tt::dx_taps<32>(acc, dz2h, w2 + wg * 4096, lane, [&](int i, int j, int m) {
      int q = 128 + 16 * wq + m;
      q = q < kRing ? q : 0;
      return (q / tt::kHaloW + i) * kR2W + q % tt::kHaloW + j;
    });
    store_dz1<32>(acc, 128 + 16 * wq, 32 * wg, grad, dz1_dst, s1, r0, c0, h, w, lane);
  }
}

// Block B's tile k (x stage and dz1 buffer k % 2): dx = bf16(conv1's
// input gradient + dy), dw1 += its products.
__device__ __forceinline__ void conv1_tile(unsigned char* smem, int k, int tile,
                                           const Tiles& tiles, uint64_t* full,
                                           const bf16* __restrict__ dy, bf16* __restrict__ dx,
                                           int h, int w, float (&acc_w)[9][4][4]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int b, r0, c0;
  tiles.origin(tile, &b, &r0, &c0);
  const uint32_t xh = hop::smem_u32(smem + kOffStage + (k & 1) * tt::kHaloPitch);
  const uint32_t dz1h = hop::smem_u32(smem + kOffDz1 + (k & 1) * tt::kHaloPitch);
  hop::mbar_wait(&full[k & 1], (k >> 1) & 1);
  __syncwarp();

  float acc[32];
  tt::dx_taps<64>(acc, dz1h, hop::smem_u32(smem + kOffW), lane,
                  [&](int i, int j, int m) { return (warp + i) * tt::kHaloW + m + j; });
  const int oh = r0 + warp;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int ow = c0 + (lane >> 2) + 8 * half;
    if (oh < h && ow < w) {
      const size_t px = ((static_cast<size_t>(b) * h + oh) * w + ow) * kC + 2 * (lane & 3);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const unsigned int raw = __ldg(reinterpret_cast<const unsigned int*>(dy + px + 8 * n));
        const float2 d = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw));
        *reinterpret_cast<__nv_bfloat162*>(dx + px + 8 * n) = __floats2bfloat162_rn(
            __fadd_rn(acc[4 * n + 2 * half], d.x), __fadd_rn(acc[4 * n + 2 * half + 1], d.y));
      }
    }
  }
  __syncwarp();
  tt::dw_tile<tt::kHaloW, 1>(acc_w, xh, dz1h, warp, lane);
}

__global__ void __launch_bounds__(tt::kThreads, 1)
chain_bwd_bf16(const __grid_constant__ CUtensorMap map_x,
               const __grid_constant__ CUtensorMap map_z1,
               const __grid_constant__ CUtensorMap map_a1,
               const __grid_constant__ CUtensorMap map_dy,
               const __grid_constant__ CUtensorMap map_w1,
               const __grid_constant__ CUtensorMap map_w2, const bf16* __restrict__ dy,
               const float* __restrict__ s1, const float* __restrict__ s2,
               bf16* __restrict__ dx, float* __restrict__ partial, int h, int w, Tiles tiles) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = tt::aligned_smem(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kOffBar);
  uint64_t* w_full = full + 2;
  uint64_t* zfull = full + 3;
  uint64_t* grad_ready = full + 5;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const bool conv2 = (rank & 1) == 0;  // block A; its partner B is rank + 1
  // pair p = blockIdx.x / 2 takes tiles p, p + n_pairs, ...; the cluster
  // runs one step more than its first pair has tiles
  const int n_pairs = static_cast<int>(gridDim.x) / 2;
  const int pair = static_cast<int>(blockIdx.x) / 2;
  auto tiles_of = [&](int p) { return p < tiles.n ? (tiles.n - p + n_pairs - 1) / n_pairs : 0; };
  const int mine = tiles_of(pair);
  const int steps = tiles_of(static_cast<int>(blockIdx.x) / tt::kCluster * 2) + 1;

  if (threadIdx.x == 0) {
    for (int s = 0; s < 2; ++s) {
      hop::mbar_init(&full[s], 1);
      hop::mbar_init(&zfull[s], 1);
    }
    hop::mbar_init(w_full, 1);
    hop::mbar_init(grad_ready, tt::kThreads);
    hop::fence_barrier_init();
    hop::prefetch_map(conv2 ? &map_a1 : &map_x);
    for (int k = 0; k < 2 && k < mine; ++k) {
      issue_tile(smem, conv2, k, pair + k * n_pairs, tiles, full, &map_x, &map_a1, &map_dy);
      if (!conv2) issue_z1(smem, k, pair + k * n_pairs, tiles, zfull, &map_z1);
    }
  }
  cluster.sync();  // every block's barriers are initialised before any multicast
  if (threadIdx.x == 0)
    hop::load_w9t_multicast(smem + kOffW, conv2 ? &map_w2 : &map_w1, w_full, rank >> 1, 2,
                            conv2 ? 0x5 : 0xA);
  // A's view of its partner's dz1 buffers, B's of its partner's silu'
  // buffer
  unsigned char* partner_dz1 = static_cast<unsigned char*>(
      cluster.map_shared_rank(static_cast<void*>(smem + kOffDz1), rank | 1));
  unsigned char* partner_grad = static_cast<unsigned char*>(
      cluster.map_shared_rank(static_cast<void*>(smem + kOffGrad), rank & ~1));

  float acc_w[9][4][4];
#pragma unroll
  for (int q = 0; q < 9; ++q)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc_w[q][n][e] = 0.0f;
  hop::mbar_wait(w_full, 0);

  for (int s = 0; s < steps; ++s) {
    if (conv2) {
      if (s < mine)
        conv2_tile(smem, s, pair + s * n_pairs, tiles, full, grad_ready,
                   partner_dz1 + (s & 1) * tt::kHaloPitch, s1, s2, h, w, acc_w);
    } else {
      if (s < mine) silu_grad_ring(smem, s, zfull, partner_grad, grad_ready, rank - 1);
      if (s >= 1 && s - 1 < mine)
        conv1_tile(smem, s - 1, pair + (s - 1) * n_pairs, tiles, full, dy, dx, h, w, acc_w);
    }
    // A's dz1 of tile s is visible to B; A is done with B's silu' of tile
    // s and B with the dz1 buffer A fills next; this block's stages of
    // step s are free for the tiles two ahead
    cluster.sync();
    const int k = conv2 ? s : s - 1;  // the tile this block's stage held
    if (threadIdx.x == 0 && k >= 0 && k + 2 < mine)
      issue_tile(smem, conv2, k & 1, pair + (k + 2) * n_pairs, tiles, full, &map_x, &map_a1,
                 &map_dy);
    if (threadIdx.x == 0 && !conv2 && s + 2 < mine)
      issue_z1(smem, s & 1, pair + (s + 2) * n_pairs, tiles, zfull, &map_z1);
  }

  // this block's dW partial -> its shared memory; the cluster sums dw1
  // over its B blocks (ranks 1, 3) and dw2 over its A blocks (0, 2)
  float* part = reinterpret_cast<float*>(smem);
  tt::store_dw(part, acc_w, threadIdx.x >> 5, threadIdx.x & 31);
  cluster.sync();
  float* out = partial + static_cast<size_t>(blockIdx.x / tt::kCluster) * 2 * tt::kPartial;
  hop::sum_cluster_ranks<tt::kCluster, 1, 2>(part, out, tt::kPartial);
  hop::sum_cluster_ranks<tt::kCluster, 0, 2>(part, out + tt::kPartial, tt::kPartial);
  cluster.sync();  // no block leaves while another still reads its partial
}

int launch_bf16(const void* x, const void* z1, const void* a1, const void* dy, const void* w1t,
                const void* w2t, const float* s1, const float* s2, void* dx, float* dws,
                float* ws, int b, int h, int w, int grid, cudaStream_t st) {
  if (grid < tt::kCluster || grid % tt::kCluster != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap mx, mz1, ma1, mdy, mw1, mw2;
  int rc = hop::nhwc_map(&mx, x, b, h, w, tt::kTH + 2, tt::kHaloW);
  if (rc == 0) rc = hop::nhwc_map(&mz1, z1, b, h, w, tt::kTH + 2, tt::kHaloW);
  if (rc == 0) rc = hop::nhwc_map(&ma1, a1, b, h, w, tt::kTH + 2, tt::kHaloW);
  if (rc == 0) rc = hop::nhwc_map(&mdy, dy, b, h, w, tt::kTH + 4, kR2W);
  if (rc == 0) rc = hop::w9t_map(&mw1, w1t);
  if (rc == 0) rc = hop::w9t_map(&mw2, w2t);
  if (rc != 0) return rc;
  const cudaError_t err =
      cudaFuncSetAttribute(chain_bwd_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemB);
  if (err != cudaSuccess) return static_cast<int>(err);
  rc = hop::launch_clustered(chain_bwd_bf16, grid, tt::kThreads, kSmemB, tt::kCluster, st, mx,
                             mz1, ma1, mdy, mw1, mw2, static_cast<const bf16*>(dy), s1, s2,
                             static_cast<bf16*>(dx), ws, h, w, Tiles(b, h, w, tt::kTH, tt::kTW));
  if (rc != 0) return rc;
  return launch_sum(ws, grid / tt::kCluster, 2 * kPartial, 2 * kPartial, dws, st);
}

// ------------------------------------------------------------- float32 path

constexpr int kT = 8;            // output tile edge
constexpr int kR1 = kT + 2;      // 10: the one-pixel ring
constexpr int kR2 = kT + 4;      // 12: the two-pixel ring
constexpr int kSmemF = (kR1 * kR1 * 2 + kR2 * kR2) * kC * 4;  // 88,064

__global__ void __launch_bounds__(kThreads, 1)
chain_bwd_f32(const float* __restrict__ x, const float* __restrict__ z1,
              const float* __restrict__ a1, const float* __restrict__ dy,
              const float* __restrict__ w1f, const float* __restrict__ w2f,
              const float* __restrict__ s1, const float* __restrict__ s2,
              float* __restrict__ dx, float* __restrict__ partial, int h, int w,
              Tiles tiles) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* act = reinterpret_cast<float*>(smem);  // a1, then x, on 10x10
  float* dz2 = act + kR1 * kR1 * kC;            // 12x12
  float* dz1 = dz2 + kR2 * kR2 * kC;            // 10x10
  float* dw1 = partial + static_cast<size_t>(blockIdx.x) * 2 * kPartial;
  float* dw2 = dw1 + kPartial;

  zero_block(dw1, 2 * kPartial);
  for (int k = blockIdx.x; k < tiles.n; k += gridDim.x) {
    int b, r0, c0;
    tiles.origin(k, &b, &r0, &c0);
    const size_t img = static_cast<size_t>(b) * h;
    __syncthreads();  // partials zeroed; the previous tile's dz1 consumed
    load_region(act, a1, b, h, w, r0 - 1, c0 - 1, kR1, kR1);
    // dz2 = dy * s2 on the 12x12 ring, 0 outside the image
    for (int g = threadIdx.x; g < kR2 * kR2 * (kC / 4); g += blockDim.x) {
      const int pix = g / (kC / 4), c = (g - pix * (kC / 4)) * 4;
      const int hh = r0 - 2 + pix / kR2, ww = c0 - 2 + pix % kR2;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (hh >= 0 && hh < h && ww >= 0 && ww < w) {
        const float4 d = load4(dy + ((img + hh) * w + ww) * kC + c);
        const float4 s = load4(s2 + c);
        v = make_float4(d.x * s.x, d.y * s.y, d.z * s.z, d.w * s.w);
      }
      *reinterpret_cast<float4*>(dz2 + pix * kC + c) = v;
    }
    __syncthreads();

    // conv2 backward: dw2 over the tile, da1 (-> dz1) over the ring
    dw_fma(
        dw2, kT * kT,
        [&](int p, int t) {
          const int i = t / 3, j = t - 3 * (t / 3);
          return static_cast<const float*>(act + (((p >> 3) + i) * kR1 + (p & 7) + j) * kC);
        },
        [&](int p) {
          return static_cast<const float*>(dz2 + (((p >> 3) + 2) * kR2 + (p & 7) + 2) * kC);
        });
    tap_gemm_fma<(kR1 * kR1 + 15) / 16>(
        kR1 * kR1, w2f,
        [&](int q, int t) {
          const int i = t / 3, j = t - 3 * (t / 3);
          return static_cast<const float*>(dz2 + ((q / kR1 + i) * kR2 + q % kR1 + j) * kC);
        },
        [&](int q, int ci0, const float* da1) {
          const int hh = r0 - 1 + q / kR1, ww = c0 - 1 + q % kR1;
          float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
          if (hh >= 0 && hh < h && ww >= 0 && ww < w) {
            const float4 z = load4(z1 + ((img + hh) * w + ww) * kC + ci0);
            const float4 s = load4(s1 + ci0);
            const float zs[4] = {z.x, z.y, z.z, z.w}, ss[4] = {s.x, s.y, s.z, s.w};
            float out[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float sig = 1.0f / (1.0f + expf(-zs[e]));
              const float grad = sig * (1.0f + zs[e] * (1.0f - sig));
              out[e] = da1[e] * grad * ss[e];
            }
            v = make_float4(out[0], out[1], out[2], out[3]);
          }
          *reinterpret_cast<float4*>(dz1 + q * kC + ci0) = v;
        });
    __syncthreads();  // dz1 complete; a1 consumed

    // conv1 backward: dw1 and dx over the tile, dz1 read from shared memory
    load_region(act, x, b, h, w, r0 - 1, c0 - 1, kR1, kR1);
    __syncthreads();
    dw_fma(
        dw1, kT * kT,
        [&](int p, int t) {
          const int i = t / 3, j = t - 3 * (t / 3);
          return static_cast<const float*>(act + (((p >> 3) + i) * kR1 + (p & 7) + j) * kC);
        },
        [&](int p) {
          return static_cast<const float*>(dz1 + (((p >> 3) + 1) * kR1 + (p & 7) + 1) * kC);
        });
    tap_gemm_fma<kT * kT / 16>(
        kT * kT, w1f,
        [&](int p, int t) {
          const int i = t / 3, j = t - 3 * (t / 3);
          return static_cast<const float*>(dz1 + (((p >> 3) + i) * kR1 + (p & 7) + j) * kC);
        },
        [&](int p, int ci0, const float* v) {
          const int oh = r0 + (p >> 3), ow = c0 + (p & 7);
          if (oh < h && ow < w) {
            const size_t off = ((img + oh) * w + ow) * kC + ci0;
            const float4 d = load4(dy + off);
            *reinterpret_cast<float4*>(dx + off) =
                make_float4(v[0] + d.x, v[1] + d.y, v[2] + d.z, v[3] + d.w);
          }
        });
  }
}

int launch_f32(const void* x, const void* z1, const void* a1, const void* dy, const void* w1f,
               const void* w2f, const float* s1, const float* s2, void* dx, float* dws,
               float* ws, int b, int h, int w, int grid, cudaStream_t st) {
  const Tiles tiles(b, h, w, kT, kT);
  if (grid < 1 || grid > tiles.n) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err =
      cudaFuncSetAttribute(chain_bwd_f32, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemF);
  if (err != cudaSuccess) return static_cast<int>(err);
  chain_bwd_f32<<<grid, kThreads, kSmemF, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(z1), static_cast<const float*>(a1),
      static_cast<const float*>(dy), static_cast<const float*>(w1f),
      static_cast<const float*>(w2f), s1, s2, static_cast<float*>(dx), ws, h, w, tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_sum(ws, grid, 2 * kPartial, 2 * kPartial, dws, st);
}

}  // namespace

extern "C" {

// Launch geometry of the tile kernel for bfloat16 (bf16 = 1) or float32,
// in conv3x3_bwd_geometry's layout; a partial holds dw1 then dw2.
// bfloat16: 8x16 tiles, each taken by a pair of blocks, in clusters of 4
// (two pairs), a partial a cluster; float32: 8x8 tiles, one block per SM,
// a partial a block. Returns 0, or cudaErrorInvalidValue if the card
// cannot run a cluster.
int chain_bwd_geometry(int bf16_, int* out) {
  out[0] = bf16_ ? tt::kTH : kT;
  out[1] = bf16_ ? tt::kTW : kT;
  out[2] = bf16_ ? tt::kCluster : 1;
  out[3] = 2 * kPartial;
  out[4] = bf16_ ? hop::max_active_clusters(chain_bwd_bf16, tt::kThreads, kSmemB, tt::kCluster)
                 : 0;
  return bf16_ && out[4] < 1 ? static_cast<int>(cudaErrorInvalidValue) : 0;
}

// x, z1, a1, dy, dx (B, H, W, 64) NHWC and the weights of each conv, all
// float32 (bf16 = 0) or all bfloat16 (bf16 = 1): W9flip (576, 64), row t*64
// + co, in float32, W9T (576, 64), row t*64 + ci, column co, in bfloat16;
// s1, s2 (64,) float32; dws (2, 3, 3, 64, 64) float32 receives dw1 then dw2
// (HWIO); grid and workspace as chain_bwd_geometry gives them. The
// bfloat16 tensors must be dense and 16-byte aligned (TMA). Launches the
// tile kernel and the sum of the partials on `stream`, does not
// synchronise; returns a cudaError_t (0 on success).
int chain_bwd(const void* x, const void* z1, const void* a1, const void* dy,
              const void* w1, const void* w2, const void* s1, const void* s2,
              void* dx, void* dws, void* workspace, int b, int h, int w, int grid,
              int bf16_, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (b <= 0 || h <= 0 || w <= 0) return static_cast<int>(cudaErrorInvalidValue);
  auto* f1 = static_cast<const float*>(s1);
  auto* f2 = static_cast<const float*>(s2);
  auto* out = static_cast<float*>(dws);
  auto* ws = static_cast<float*>(workspace);
  if (bf16_) return launch_bf16(x, z1, a1, dy, w1, w2, f1, f2, dx, out, ws, b, h, w, grid, st);
  return launch_f32(x, z1, a1, dy, w1, w2, f1, f2, dx, out, ws, b, h, w, grid, st);
}

}  // extern "C"
