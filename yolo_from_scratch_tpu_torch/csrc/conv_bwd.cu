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
// Design. The first kernel walks 8x8-pixel tiles; block k takes tiles k,
// k + gridDim.x, ... A block keeps W9flip (576 x 64 float, 144 KiB) in shared
// memory for all its tiles, and per tile the zero-padded 10x10 halo of x and
// of dy (25 KiB each, float). Per tile it computes
//   - dx as an implicit GEMM: each thread 4 pixels x 4 input channels, over
//     the 576-deep (tap, co) sum, read from the dy halo and W9flip;
//   - its share of dW: each thread 9 taps x 2 input channels x 8 output
//     channels, summed over the tile's pixels into registers that persist
//     across the block's tiles.
// Each block then writes its dW partial (576 x 64 float) to a workspace, and
// the second kernel sums the partials in block order and writes grad_w in
// OIHW. No float atomics and no patch matrix in device memory: a block's
// order of summation is fixed, so two runs give the same bits. Inputs and dx
// are float or bfloat16; everything is summed in float with explicit
// __fmaf_rn (the library is built with --fmad=false).
//
// What bounds it on the H100: at the training shapes (B=8, 40x40 and 80x80)
// the two products are ~1-4 GFLOP, done here in FP32 FMAs fed from shared
// memory; each k-step of a warp reads 4 scalars and one float4 for 16 FMAs,
// so shared-memory bandwidth, not device memory, is the limit. The 198 KiB
// of shared memory hold one block per SM. The later fast version moves both
// products to the tensor cores (wgmma on bf16 tiles fed by TMA).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kC = 64;
constexpr int kK9 = 9 * kC;         // 576
constexpr int kTile = 8;            // output tile edge, pixels
constexpr int kHalo = kTile + 2;    // 10
constexpr int kThreads = 256;
constexpr int kPartial = kK9 * kC;  // 36,864 floats per block
constexpr int kSmemFloats = kPartial + 2 * kHalo * kHalo * kC;
constexpr int kSmemBytes = kSmemFloats * 4;  // 198,656

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

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
conv3x3_bwd_tiles(const T* __restrict__ x, const T* __restrict__ dy,
                  const T* __restrict__ w, T* __restrict__ dx,
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
    w9[(t * kC + co) * kC + ci] = to_f(w[g]);
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
        xv = to_f(x[off]);
        dv = to_f(dy[off]);
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
        T* out = dx + ((static_cast<size_t>(b) * h + oh) * wd + ow) * kC + cq * 4;
#pragma unroll
        for (int k = 0; k < 4; ++k) out[k] = from_f<T>(acc[p][k]);
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

template <typename T>
int launch(const void* x, const void* dy, const void* w, void* dx, float* dw,
           float* workspace, int b, int h, int wd, int grid, cudaStream_t stream) {
  const int tiles_h = (h + kTile - 1) / kTile;
  const int tiles_w = (wd + kTile - 1) / kTile;
  const int n_tiles = b * tiles_h * tiles_w;
  if (grid < 1 || grid > n_tiles) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      conv3x3_bwd_tiles<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  conv3x3_bwd_tiles<T><<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), static_cast<const T*>(w),
      static_cast<T*>(dx), workspace, h, wd, tiles_h, tiles_w, n_tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  conv3x3_bwd_reduce<<<(kPartial + 255) / 256, 256, 0, stream>>>(workspace, grid, dw);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Floats of workspace one block of the tile kernel needs.
int conv3x3_bwd_partial_floats() { return kPartial; }

// x, dy, dx (B, H, W, 64) channels-last and w (64, 64, 3, 3) OIHW, all
// float32 (bf16 = 0) or all bfloat16 (bf16 = 1); dw (64, 64, 3, 3) float32;
// workspace grid * conv3x3_bwd_partial_floats() float32, 1 <= grid <= number
// of 8x8 tiles. Launches two kernels on `stream`, does not synchronise;
// returns cudaGetLastError() (0 on success).
int conv3x3_bwd(const void* x, const void* dy, const void* w, void* dx, void* dw,
                void* workspace, int b, int h, int wd, int grid, int bf16,
                void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  auto* dwf = static_cast<float*>(dw);
  auto* ws = static_cast<float*>(workspace);
  if (b <= 0 || h <= 0 || wd <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (bf16) return launch<__nv_bfloat16>(x, dy, w, dx, dwf, ws, b, h, wd, grid, st);
  return launch<float>(x, dy, w, dx, dwf, ws, b, h, wd, grid, st);
}

const char* conv3x3_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
