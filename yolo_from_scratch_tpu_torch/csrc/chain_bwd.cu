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
// benchmarks/blockbwd.py::chain_bwd_plain` computes.
//
// Design. The point of the TPU kernel is that dz1 never goes to device
// memory; here too it lives only in shared memory. A block takes 8x8 output
// tiles k, k + gridDim.x, ...; for a tile T it needs dz1 on T plus a
// one-pixel ring (10x10) for dx, hence da1 there, hence dz2 on T plus two
// pixels (12x12). So each tile recomputes da1 on its ring: 100 / 64 = 1.56x
// the conv2 input-gradient products of the tile itself. A ring pixel
// outside the image gets dz1 = 0 and dz2 = 0, as the zero borders of the
// TPU kernel's g1pad and g2pad give. Shared memory (float, 86 KiB): the
// 10x10 halo of a1 (then of x), dz2 on 12x12 and dz1 on 10x10. The two dW
// partials (2 x 144 KiB) do not fit beside them: each block keeps them in
// its slice of the device-memory workspace, each entry read and written by
// one thread once a tile, and a second kernel sums the blocks' partials in
// block order (no atomics, the same bits on every run). W1flip and W2flip
// are read a tap at a time from device memory (L2). Every product is an
// FP32 FMA (`__fmaf_rn`) in both types.
//
// What bounds it on the H100: FP32 FMAs fed from shared memory, 4.56
// [64 x 576] @ [576 x 64]-sized products a tile (dx, dw1, dw2 and the
// 1.56x da1), plus 576 KiB of L2 traffic a tile for the two partials. The
// tensor cores, and dW in registers, are a later change.

#include "conv_tiles.cuh"

namespace {

using namespace convk;
using bf16 = __nv_bfloat16;

constexpr int kT = 8;            // output tile edge
constexpr int kR1 = kT + 2;      // 10: the one-pixel ring
constexpr int kR2 = kT + 4;      // 12: the two-pixel ring
constexpr int kSmem = (kR1 * kR1 * 2 + kR2 * kR2) * kC * 4;  // 88,064

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
chain_bwd_tiles(const T* __restrict__ x, const T* __restrict__ z1,
                const T* __restrict__ a1, const T* __restrict__ dy,
                const T* __restrict__ w1f, const T* __restrict__ w2f,
                const float* __restrict__ s1, const float* __restrict__ s2,
                T* __restrict__ dx, float* __restrict__ partial, int h, int w,
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
    // dz2 = round(dy * s2) on the 12x12 ring, 0 outside the image
    for (int g = threadIdx.x; g < kR2 * kR2 * (kC / 4); g += blockDim.x) {
      const int pix = g / (kC / 4), c = (g - pix * (kC / 4)) * 4;
      const int hh = r0 - 2 + pix / kR2, ww = c0 - 2 + pix % kR2;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (hh >= 0 && hh < h && ww >= 0 && ww < w) {
        const float4 d = load4(dy + ((img + hh) * w + ww) * kC + c);
        const float4 s = load4(s2 + c);
        v = make_float4(round_to<T>(d.x * s.x), round_to<T>(d.y * s.y),
                        round_to<T>(d.z * s.z), round_to<T>(d.w * s.w));
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
              out[e] = round_to<T>(da1[e] * grad * ss[e]);
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
            dx[off] = from_f<T>(v[0] + d.x);
            dx[off + 1] = from_f<T>(v[1] + d.y);
            dx[off + 2] = from_f<T>(v[2] + d.z);
            dx[off + 3] = from_f<T>(v[3] + d.w);
          }
        });
  }
}

template <typename T>
int launch(const void* x, const void* z1, const void* a1, const void* dy, const void* w1f,
           const void* w2f, const float* s1, const float* s2, void* dx, float* dws,
           float* ws, int h, int w, const Tiles& tiles, int grid, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      chain_bwd_tiles<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  chain_bwd_tiles<T><<<grid, kThreads, kSmem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(z1), static_cast<const T*>(a1),
      static_cast<const T*>(dy), static_cast<const T*>(w1f), static_cast<const T*>(w2f),
      s1, s2, static_cast<T*>(dx), ws, h, w, tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_sum(ws, grid, 2 * kPartial, 2 * kPartial, dws, st);
}

}  // namespace

extern "C" {

// Blocks the tile kernel runs with: one per SM, at most one per 8x8 tile.
// The workspace holds grid * 2 * 36,864 floats.
int chain_bwd_grid(int b, int h, int w, int sms) {
  const int n = Tiles(b, h, w, kT, kT).n;
  return n < sms ? n : sms;
}

// x, z1, a1, dy, dx (B, H, W, 64) NHWC and w1f, w2f = W9flip of each conv
// (576, 64), all float32 (bf16 = 0) or all bfloat16 (bf16 = 1); s1, s2 (64,)
// float32; dws (2, 3, 3, 64, 64) float32 receives dw1 then dw2 (HWIO);
// workspace grid * 2 * 36,864 floats, grid from chain_bwd_grid. Launches the
// tile kernel and the sum of the partials on `stream`, does not
// synchronise; returns cudaGetLastError() (0 on success).
int chain_bwd(const void* x, const void* z1, const void* a1, const void* dy,
              const void* w1f, const void* w2f, const void* s1, const void* s2,
              void* dx, void* dws, void* workspace, int b, int h, int w, int grid,
              int bf16_, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (b <= 0 || h <= 0 || w <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const Tiles tiles(b, h, w, kT, kT);
  if (grid < 1 || grid > tiles.n) return static_cast<int>(cudaErrorInvalidValue);
  auto* f1 = static_cast<const float*>(s1);
  auto* f2 = static_cast<const float*>(s2);
  auto* out = static_cast<float*>(dws);
  auto* ws = static_cast<float*>(workspace);
  if (bf16_)
    return launch<bf16>(x, z1, a1, dy, w1f, w2f, f1, f2, dx, out, ws, h, w, tiles, grid, st);
  return launch<float>(x, z1, a1, dy, w1f, w2f, f1, f2, dx, out, ws, h, w, tiles, grid, st);
}

}  // extern "C"
