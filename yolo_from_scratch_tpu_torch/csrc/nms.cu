// Greedy NMS keep mask, one thread block per image (sm_90a).
//
// Replaces the Pallas TPU kernel `yolo_from_scratch_tpu/ops/nms_pallas.py::
// _nms_kernel` and computes exactly what the plain version
// `yolo_from_scratch_tpu_torch/ops/nms.py::nms_keep_mask` computes, on
// boxes that the wrapper (`ops/nms_cuda.py`) has already sorted by
// descending score and offset by class:
//
//   repeat until `cap` boxes are kept or none is available:
//     pivot = lowest available rank (available = valid, not kept, not
//             suppressed); keep it;
//     suppress every later rank r with
//       inter / (area_pivot + area_r - inter + 1e-6f) > thr.
//
// Design. Block b walks image b. Thread t holds the candidates of ranks
// t, t + blockDim, t + 2*blockDim, ... (PER of them) in registers: four
// coordinates, the area and one bit of availability each. A step is
//   1. each thread's lowest available rank (first set bit of its mask),
//      a warp-wide min (__reduce_min_sync); the warp's owner lane writes
//      the rank and the pivot box to a shared slot of its warp;
//   2. one __syncthreads; every warp then reduces the (<= 32) slots itself,
//      so all threads learn the pivot and read its box from shared memory
//      without a second barrier (the slots are double-buffered by step
//      parity, so the next step's writes cannot race this step's reads);
//   3. each thread tests its own candidates against the pivot.
// The TPU kernel's (R, 128) tiling, one-hot sums and float masks exist for
// the TPU's vector registers and are not carried over.
//
// Bit-equality with the plain version: every IoU is computed with
// round-to-nearest intrinsics in the reference's op order, so nvcc can
// contract nothing into an FMA (the library is also built with
// --fmad=false and without --use_fast_math); 1e-6f and the strict '>' are
// the reference's.
//
// What bounds it on the H100: not bytes or FLOPs (4096 boxes are 64 KiB)
// but the latency of one step -- a warp reduction, a block barrier and a
// second warp reduction -- times the number of kept boxes, with one SM
// busy per image. The later fast version is the bitmask formulation: all
// pairwise IoU bits computed across SMs in parallel, then a short
// sequential scan over 64-bit words.

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kWarp = 32;
// Scores <= NEG_INF / 2 (NEG_INF = -1e30) are padding, never kept.
constexpr float kPadScore = -5e29f;

template <int PER>
__global__ void __launch_bounds__(kMaxThreads)
nms_pivot_walk(const float* __restrict__ boxes, const float* __restrict__ scores,
               bool* __restrict__ keep, int n, int cap, float thr) {
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & (kWarp - 1);
  const int warp = tid / kWarp;
  const int nwarps = nt / kWarp;
  const size_t base = static_cast<size_t>(blockIdx.x) * n;

  float x1[PER], y1[PER], x2[PER], y2[PER], area[PER];
  unsigned avail = 0u;
  unsigned kept = 0u;
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int r = tid + j * nt;
    x1[j] = y1[j] = x2[j] = y2[j] = area[j] = 0.0f;
    if (r < n) {
      const float* bx = boxes + (base + r) * 4;
      x1[j] = bx[0];
      y1[j] = bx[1];
      x2[j] = bx[2];
      y2[j] = bx[3];
      area[j] = __fmul_rn(__fsub_rn(x2[j], x1[j]), __fsub_rn(y2[j], y1[j]));
      if (scores[base + r] > kPadScore) avail |= 1u << j;
    }
  }

  __shared__ int s_rank[2][kWarp];
  __shared__ float4 s_box[2][kWarp];

  for (int count = 0, step = 0; count < cap; ++count, ++step) {
    const int buf = step & 1;
    // ranks of a thread grow with j: the first set bit is its lowest
    const int local = avail ? tid + (__ffs(avail) - 1) * nt : INT_MAX;
    const int wmin = __reduce_min_sync(0xffffffffu, local);
    if (lane == 0) s_rank[buf][warp] = wmin;
    if (local == wmin && wmin != INT_MAX) {
      const int jsel = (wmin - tid) / nt;
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        if (j == jsel) s_box[buf][warp] = make_float4(x1[j], y1[j], x2[j], y2[j]);
      }
    }
    __syncthreads();

    const int slot = lane < nwarps ? s_rank[buf][lane] : INT_MAX;
    const int pivot = __reduce_min_sync(0xffffffffu, slot);
    if (pivot == INT_MAX) break;  // nothing available: uniform across the block
    const int owner_warp = __ffs(__ballot_sync(0xffffffffu, slot == pivot)) - 1;
    const float4 p = s_box[buf][owner_warp];
    const float parea = __fmul_rn(__fsub_rn(p.z, p.x), __fsub_rn(p.w, p.y));

#pragma unroll
    for (int j = 0; j < PER; ++j) {
      if (!((avail >> j) & 1u)) continue;
      const int r = tid + j * nt;
      if (r == pivot) {
        kept |= 1u << j;
        avail &= ~(1u << j);
      } else if (r > pivot) {
        const float iw = fmaxf(__fsub_rn(fminf(p.z, x2[j]), fmaxf(p.x, x1[j])), 0.0f);
        const float ih = fmaxf(__fsub_rn(fminf(p.w, y2[j]), fmaxf(p.y, y1[j])), 0.0f);
        const float inter = __fmul_rn(iw, ih);
        const float den = __fadd_rn(__fsub_rn(__fadd_rn(parea, area[j]), inter), 1e-6f);
        if (__fdiv_rn(inter, den) > thr) avail &= ~(1u << j);
      }
    }
  }

#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int r = tid + j * nt;
    if (r < n) keep[base + r] = (kept >> j) & 1u;
  }
}

template <int PER>
void launch(const float* boxes, const float* scores, bool* keep, int b, int n,
            int cap, float thr, cudaStream_t stream) {
  int threads = (n + PER - 1) / PER;
  threads = ((threads + kWarp - 1) / kWarp) * kWarp;
  nms_pivot_walk<PER><<<b, threads, 0, stream>>>(boxes, scores, keep, n, cap, thr);
}

}  // namespace

extern "C" {

// Largest N one block takes: 1024 threads x 16 candidates each.
int nms_max_boxes() { return kMaxThreads * 16; }

// boxes (B, N, 4) float32, scores (B, N) float32, both sorted by descending
// score per image and contiguous; keep (B, N) bool. Launches on `stream`,
// does not synchronise; returns cudaGetLastError() (0 on success).
int nms_keep_mask_f32(const void* boxes, const void* scores, void* keep, int b,
                      int n, int cap, float thr, void* stream) {
  const auto* bx = static_cast<const float*>(boxes);
  const auto* sc = static_cast<const float*>(scores);
  auto* kp = static_cast<bool*>(keep);
  auto st = static_cast<cudaStream_t>(stream);
  if (b <= 0 || n <= 0) return 0;
  if (n > nms_max_boxes()) return static_cast<int>(cudaErrorInvalidValue);
  if (n <= kMaxThreads) {
    launch<1>(bx, sc, kp, b, n, cap, thr, st);
  } else if (n <= 2 * kMaxThreads) {
    launch<2>(bx, sc, kp, b, n, cap, thr, st);
  } else if (n <= 4 * kMaxThreads) {
    launch<4>(bx, sc, kp, b, n, cap, thr, st);
  } else if (n <= 8 * kMaxThreads) {
    launch<8>(bx, sc, kp, b, n, cap, thr, st);
  } else {
    launch<16>(bx, sc, kp, b, n, cap, thr, st);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* nms_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
