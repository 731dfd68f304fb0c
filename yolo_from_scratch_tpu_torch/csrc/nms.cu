// Greedy NMS keep mask as a two-pass bitmask NMS (sm_90a).
//
// Replaces the Pallas TPU kernel `yolo_from_scratch_tpu/ops/nms_pallas.py::
// _nms_kernel` and computes exactly what the plain version
// `yolo_from_scratch_tpu_torch/ops/nms.py::nms_keep_mask` computes, on
// boxes that the wrapper (`ops/nms_cuda.py`) has already sorted by
// descending score and offset by class: rank j is kept if and only if
//   it is valid (score > -5e29),
//   no kept rank i < j has inter / ((area_i + area_j) - inter + 1e-6f) > thr,
//   and fewer than `cap` ranks before it were kept.
// The greedy walk (keep the first available rank, suppress the later ones
// it overlaps, repeat) gives the same set: suppression is an OR over the
// kept ranks, and the walk only skips tests whose bits no kept rank reads.
//
// Design: two kernels on the caller's stream, over a workspace that the
// wrapper allocates, W = ceil(N / 64) words of 8 bytes to a full row. An
// image's chunk c (ranks 64 c .. 64 c + 63) is one contiguous block of
// 64 (W - c) words: the chunk's 64 column words, then its 64 rows of words
// c + 1 .. W - 1 (31.5 KiB for chunk 0 at N = 4096; 1.02 MiB an image in
// all, about half the square).
//   (a) nms_mask_pass, over the whole card: one 64-thread block per
//       (image, row block rb, column block cb >= rb) of 64 ranks each. The
//       block stages its 64 column boxes and areas in shared memory and
//       thread k takes rank r = 64 rb + k. Off the diagonal (cb > rb) it
//       writes r's row word cb: bit j set if r suppresses rank 64 cb + j.
//       On the diagonal it writes r's column word: bit j set if the earlier
//       rank 64 rb + j (j < k) suppresses r. Invalid ranks are never kept,
//       so their words are never written and never read.
//   (b) nms_scan, one 256-thread block per image, over chunks of 64 ranks.
//       Chunks stream into shared memory, one bulk copy each behind an
//       mbarrier, up to 8 in flight (7 at N = 4096, 1 above N = 14,016,
//       within the 227 KB a block may use). Warp 0 walks the chunks alone.
//       Chunk c's removed word is the invalid ranks, what the other warps
//       ORed in from chunks up to c - 2, and a carry, chunk c - 1's kept
//       rows' word c, which warp 0 ORs itself. It resolves the chunk in
//       rounds, two ranks a lane: an open rank whose column meets a kept
//       rank is removed; one whose earlier suppressors in the chunk are all
//       removed is kept. The lowest open rank is decided every round, so a
//       chunk takes as many rounds as its longest chain of suppressions,
//       where a walk takes a step a kept box. `cap` then keeps the first
//       ranks in rank order. Warp 0 writes the chunk's keep bits and
//       publishes its kept ranks through an mbarrier; behind it, three
//       groups of two warps OR every third kept row's words c + 2 .. into
//       removed words of their own (a thread a word: no atomics) and signal
//       a second mbarrier, on which warp 0 waits two chunks later and after
//       which one of them refills the stage. No block barrier is left in
//       the walk.
//       Chunks past the last valid rank keep nothing and are not read.
// The TPU kernel's (R, 128) tiling, one-hot sums and float masks exist for
// the TPU's vector registers and are not carried over.
//
// Bit-equality with the plain version: every IoU is computed with
// round-to-nearest intrinsics in the reference's op order, the lower rank
// as the pivot (`ops/boxes.py::box_iou_corner`), so nvcc can contract
// nothing into an FMA (the library is also built with --fmad=false and
// without --use_fast_math); 1e-6f and the strict '>' are the reference's.
//
// What bounds it on the H100. The function's own bound (utils/roofline.py)
// counts the walk's IoU tests, 3.8 M at a request's N = 4096, 0.8 us; the
// mask pass does all N (N - 1) / 2 tests (8.4 M), ~2.2x that, spread over
// 132 SMs, and is bound by its float32 operations (~20 instructions a
// test that skips the IEEE division because the boxes do not overlap,
// ~35 with it). The scan is latency-bound on one SM per image: warp 0's
// chain through the chunks, a wait on each chunk's mbarrier and on the
// workers, a few shared-memory loads, the rounds of four ballots, the carry
// and the publishing arrive, in sequence; the copies and the workers' ORs
// run under it. A pivot walk, one kept box a step with a warp reduction,
// a block barrier and a second reduction (~1.3 us a step) on one SM, took
// ~35x as long on a request's candidates.

#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

constexpr int kBits = 64;           // ranks a mask word covers, and a scan chunk
constexpr int kScanThreads = 256;
constexpr int kMaxStages = 8;       // scan chunks in flight at most
constexpr int kMaxBoxes = 16384;
constexpr int kMaxImages = 65535;   // gridDim.y of the mask pass
// the scan's dynamic shared memory, under the 232,448 bytes a block may use
constexpr int kScanSmemLimit = 232448 - 1024;
// Scores <= NEG_INF / 2 (NEG_INF = -1e30) are padding, never kept.
constexpr float kPadScore = -5e29f;

using u64 = unsigned long long;

int words_for(int n) { return (n + kBits - 1) / kBits; }

// The scan's roles: warp 0 resolves the chunks one after another; behind
// it, kGroups groups of two warps OR each resolved chunk's kept rows into
// removed words of their own (group g takes every kGroups-th kept row, a
// thread the words w with w % 64 == its index: one writer a word). The
// last warp has no role.
constexpr int kGroups = 3;
constexpr int kGroupThreads = 64;
constexpr int kWorkerWarps = kGroups * kGroupThreads / 32;

// Scan chunks in flight: as many as fit beside the removed words (W for
// the invalid ranks and W a group), up to kMaxStages (7 at N = 4096, 1
// above N = 14,016).
int scan_stages(int words) {
  const long long chunk = 8ll * kBits * words;
  const long long fit = (kScanSmemLimit - 8ll * (1 + kGroups) * words) / chunk;
  return static_cast<int>(fit < 1 ? 1 : fit > kMaxStages ? kMaxStages : fit);
}

long long scan_smem(int words) {
  return scan_stages(words) * 8ll * kBits * words + 8ll * (1 + kGroups) * words;
}

__device__ __forceinline__ float area_of(float4 b) {
  return __fmul_rn(__fsub_rn(b.z, b.x), __fsub_rn(b.w, b.y));
}

// Does pivot p (the lower rank) suppress q: IoU > thr, in the walk's op
// order. Boxes that do not overlap (inter 0, or NaN) skip the division:
// 0 / den is +-0 or NaN, never > thr for thr >= 0, so the bit is the same.
__device__ __forceinline__ bool suppresses(float4 p, float parea, float4 q, float qarea,
                                           float thr) {
  const float iw = fmaxf(__fsub_rn(fminf(p.z, q.z), fmaxf(p.x, q.x)), 0.0f);
  const float ih = fmaxf(__fsub_rn(fminf(p.w, q.w), fmaxf(p.y, q.y)), 0.0f);
  const float inter = __fmul_rn(iw, ih);
  if (!(inter > 0.0f) && thr >= 0.0f) return false;
  const float den = __fadd_rn(__fsub_rn(__fadd_rn(parea, qarea), inter), 1e-6f);
  return __fdiv_rn(inter, den) > thr;
}

// Pairs (row block, column block >= row block) before row block rb, when
// pairs are numbered row by row.
__device__ __forceinline__ int first_pair(int rb, int words) {
  return rb * words - rb * (rb - 1) / 2;
}

// Words of an image's workspace before chunk c: chunk c' holds its 64
// column words, then its 64 rows of words c' + 1 .. W - 1, 64 (W - c')
// words in all. tri(W, W) is the image's whole area, 32 W (W + 1).
__host__ __device__ __forceinline__ size_t tri(int c, int words) {
  return static_cast<size_t>(kBits) *
         (static_cast<size_t>(c) * words - static_cast<size_t>(c) * (c - 1) / 2);
}

__global__ void __launch_bounds__(kBits)
nms_mask_pass(const float4* __restrict__ boxes, const float* __restrict__ scores,
              u64* __restrict__ mask, int n, int words, float thr) {
  const int t = blockIdx.x;
  const float span = 2.0f * words + 1.0f;
  int rb = static_cast<int>((span - sqrtf(span * span - 8.0f * t)) * 0.5f);
  rb = max(0, min(rb, words - 1));
  while (rb > 0 && first_pair(rb, words) > t) --rb;
  while (rb + 1 < words && first_pair(rb + 1, words) <= t) ++rb;
  const int cb = rb + (t - first_pair(rb, words));
  const int img = blockIdx.y;
  const size_t base = static_cast<size_t>(img) * n;
  const int k = threadIdx.x;
  u64* chunk = mask + static_cast<size_t>(img) * tri(words, words) + tri(rb, words);

  __shared__ float4 s_box[kBits];
  __shared__ float s_area[kBits];
  const int col = cb * kBits + k;
  if (col < n) {
    const float4 q = boxes[base + col];
    s_box[k] = q;
    s_area[k] = area_of(q);
  }
  __syncthreads();

  const int row = rb * kBits + k;
  // an invalid rank is never kept, so nothing of it is ever read
  if (row >= n || !(scores[base + row] > kPadScore)) return;
  const float4 p = boxes[base + row];
  const float parea = area_of(p);
  u64 bits = 0;
  // unrolled: constant bit positions, and independent tests to overlap
  if (cb == rb) {
    // the diagonal block: rank `row`'s column word, bit j set if the
    // earlier rank 64 rb + j of its chunk suppresses it (j the pivot)
#pragma unroll
    for (int j = 0; j < kBits; ++j)
      if (j < k && suppresses(s_box[j], s_area[j], p, parea, thr)) bits |= 1ull << j;
    chunk[k] = bits;
    return;
  }
  const int last = min(kBits, n - cb * kBits);
#pragma unroll
  for (int j = 0; j < kBits; ++j)
    if (j < last && suppresses(p, parea, s_box[j], s_area[j], thr)) bits |= 1ull << j;
  chunk[kBits + k * (words - 1 - rb) + (cb - rb - 1)] = bits;
}

__global__ void __launch_bounds__(kScanThreads)
nms_scan(const float* __restrict__ scores, const u64* __restrict__ mask,
         bool* __restrict__ keep, int n, int words, int cap, int stages) {
  extern __shared__ __align__(128) unsigned char smem[];
  // full[s]: stage s has landed. resolved[c % 2]: warp 0 has published
  // chunk c. ored[c % 2]: the workers are done with chunk c.
  __shared__ __align__(8) uint64_t full[kMaxStages], resolved[2], ored[2];
  __shared__ u64 s_kept[2];
  __shared__ int s_count[2], s_list[2][kBits];  // the kept ranks of a chunk, in order
  __shared__ int s_chunks, s_resolved;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int img = blockIdx.x;
  const size_t base = static_cast<size_t>(img) * n;
  const size_t stage_words = static_cast<size_t>(kBits) * words;  // chunk 0
  const u64* area = mask + static_cast<size_t>(img) * tri(words, words);
  u64* buf = reinterpret_cast<u64*>(smem);  // stages x a chunk's words
  // removed[0 .. W): the invalid ranks; removed[(1 + g) W + w]: what group g
  // ORed into word w
  u64* removed = buf + stages * stage_words;

  // chunk c (its column words and rows, 512 (W - c) bytes) into stage s
  auto issue = [&](int c, int s) {
    const uint32_t bytes = 8u * kBits * static_cast<uint32_t>(words - c);
    hop::mbar_expect_tx(&full[s], bytes);
    hop::bulk_load(buf + s * stage_words, area + tri(c, words), bytes, &full[s]);
  };

  // the first chunks start streaming in while `removed` is built
  int next_load = min(stages, words);
  if (tid == 0) {
    s_chunks = 0;
    for (int s = 0; s < stages; ++s) hop::mbar_init(&full[s], 1);
    for (int i = 0; i < 2; ++i) {
      hop::mbar_init(&resolved[i], 1);
      hop::mbar_init(&ored[i], kWorkerWarps);
    }
    hop::fence_barrier_init();
    for (int c = 0; c < next_load; ++c) issue(c, c);
  }
  for (int i = words + tid; i < (1 + kGroups) * words; i += kScanThreads) removed[i] = 0;
  __syncthreads();  // s_chunks is 0 before any warp raises it
  for (int w = warp; w < words; w += kScanThreads / 32) {
    const int r0 = w * kBits + lane;
    const int r1 = r0 + 32;
    const unsigned lo = __ballot_sync(0xffffffffu, r0 < n && scores[base + r0] > kPadScore);
    const unsigned hi = __ballot_sync(0xffffffffu, r1 < n && scores[base + r1] > kPadScore);
    if (lane == 0) {
      removed[w] = ~((static_cast<u64>(hi) << 32) | lo);
      if (lo | hi) atomicMax(&s_chunks, w + 1);
    }
  }
  __syncthreads();
  const int chunks = s_chunks;  // past the last valid rank nothing is kept

  if (warp == 0) {
    // Warp 0: chunk c's removed word is what the workers ORed in from
    // chunks up to c - 2, and `carry`, what chunk c - 1's kept rows say.
    int count = 0;
    u64 carry = 0;
    int c = 0;
    for (; c < chunks; ++c) {
      const int s = c % stages;
      const u64* cur = buf + s * stage_words;  // 64 column words, then the rows
      const int stride = words - 1 - c;        // words a row holds: c + 1 .. W - 1
      hop::mbar_wait(&full[s], (c / stages) & 1);
      // the chunk's loads go out before the wait on the workers: the
      // columns of this lane's two ranks and their rows' word c + 1
      const u64 ca = cur[lane];
      const u64 cb = cur[lane + 32];
      const bool has_next = c + 1 < chunks;
      const u64 next_a = has_next ? cur[kBits + lane * stride] : 0;
      const u64 next_b = has_next ? cur[kBits + (lane + 32) * stride] : 0;
      if (c >= 2) hop::mbar_wait(&ored[c & 1], ((c - 2) >> 1) & 1);
      u64 done = carry;
#pragma unroll
      for (int g = 0; g <= kGroups; ++g) done |= removed[g * words + c];
      // Resolve the chunk in rounds: an open rank whose column meets a kept
      // rank is removed; one whose earlier suppressors are all removed is
      // kept. The lowest open rank is decided in every round. (Bitwise
      // operators on the conditions: no branches inside a round.)
      u64 kept = 0;
      for (u64 open = ~done; open != 0; open = ~(done | kept)) {
        const bool oa = (open >> lane) & 1;
        const bool ob = (open >> (lane + 32)) & 1;
        const bool hit_a = (ca & kept) != 0;
        const bool hit_b = (cb & kept) != 0;
        const u64 keep_lo = __ballot_sync(0xffffffffu, oa & !hit_a & ((ca & open) == 0));
        const u64 keep_hi = __ballot_sync(0xffffffffu, ob & !hit_b & ((cb & open) == 0));
        const u64 drop_lo = __ballot_sync(0xffffffffu, oa & hit_a);
        const u64 drop_hi = __ballot_sync(0xffffffffu, ob & hit_b);
        kept |= keep_lo | (keep_hi << 32);
        done |= drop_lo | (drop_hi << 32);
      }
      // `cap` keeps the first ranks of the greedy set, in rank order
      while (__popcll(kept) > cap - count) kept &= ~(1ull << (63 - __clzll(kept)));
      count += __popcll(kept);
      const bool ka = (kept >> lane) & 1;
      const bool kb = (kept >> (lane + 32)) & 1;
      const int row = c * kBits + lane;
      if (row < n) keep[base + row] = ka;
      if (row + 32 < n) keep[base + row + 32] = kb;
      // what this chunk's kept rows say of the next chunk: its word c + 1
      const u64 next = (ka ? next_a : 0) | (kb ? next_b : 0);
      carry = static_cast<u64>(__reduce_or_sync(0xffffffffu, static_cast<unsigned>(next))) |
              static_cast<u64>(__reduce_or_sync(0xffffffffu, static_cast<unsigned>(next >> 32)))
                  << 32;
      // publish the chunk to the workers; slot c & 1 was last read for chunk
      // c - 2, which the wait on ored above has seen finished
      if (ka) s_list[c & 1][__popcll(kept & ((1ull << lane) - 1))] = lane;
      if (kb) s_list[c & 1][__popcll(kept & ((1ull << (lane + 32)) - 1))] = lane + 32;
      if (lane == 0) {
        s_kept[c & 1] = kept;
        s_count[c & 1] = count;
      }
      __syncwarp();
      if (lane == 0) hop::mbar_arrive(&resolved[c & 1]);
      if (count >= cap) {  // later ranks are not kept, whatever they overlap
        ++c;
        break;
      }
    }
    if (lane == 0) s_resolved = c;
  } else if (warp <= kWorkerWarps) {
    // The workers: chunk c's kept rows' words c + 2 .., a word always to
    // the same thread, so that its updates stay in order.
    const int wt = tid - 32;
    const int group = wt / kGroupThreads;
    u64* mine = removed + (1 + group) * words;
    for (int c = 0; c < chunks; ++c) {
      hop::mbar_wait(&resolved[c & 1], (c >> 1) & 1);
      if (s_count[c & 1] >= cap) break;  // warp 0 stopped at this chunk
      const u64 kept = s_kept[c & 1];
      const int n_kept = __popcll(kept);
      const int* list = s_list[c & 1];
      const int s = c % stages;
      const u64* cur = buf + s * stage_words;
      const int stride = words - 1 - c;
      hop::mbar_wait(&full[s], (c / stages) & 1);  // landed: warp 0 has seen it
      for (int w = wt % kGroupThreads; w < chunks; w += kGroupThreads) {
        if (w < c + 2) continue;
        const u64* at = cur + kBits + (w - c - 1);  // word w of the chunk's row 0
        u64 acc = 0;
#pragma unroll 4
        for (int i = group; i < n_kept; i += kGroups) acc |= at[list[i] * stride];
        mine[w] |= acc;
      }
      __syncwarp();
      if (lane == 0) hop::mbar_arrive(&ored[c & 1]);
      if (wt == 0) {
        // every worker is done with the stage: refill it
        hop::mbar_wait(&ored[c & 1], (c >> 1) & 1);
        if (c + stages < chunks) {
          issue(c + stages, s);
          next_load = c + stages + 1;
        }
      }
    }
  }
  __syncthreads();
  const int resolved_chunks = s_resolved;
  // no bulk copy may still write into shared memory when the block exits
  if (tid == 32)  // the worker that issued the refills
    for (int j = resolved_chunks; j < next_load; ++j)
      hop::mbar_wait(&full[j % stages], (j / stages) & 1);
  for (int r = resolved_chunks * kBits + tid; r < n; r += kScanThreads) keep[base + r] = false;
}

}  // namespace

extern "C" {

// Largest N the kernels take: 256 words a row; one scan chunk in flight,
// 128 KiB.
int nms_max_boxes() { return kMaxBoxes; }

// Launch geometry at (B, N), into out[0..4]: W = ceil(N / 64), the scan's
// chunks in flight (1 to 8), its dynamic shared memory in bytes, the
// workspace in bytes (the wrapper allocates it: per image 32 W (W + 1)
// words of 8 bytes) and the mask pass's blocks.
// Returns 0, or cudaErrorInvalidValue for N outside 1 .. nms_max_boxes()
// or B outside 1 .. 65535.
int nms_geometry(int b, int n, long long* out) {
  if (b <= 0 || b > kMaxImages || n <= 0 || n > kMaxBoxes)
    return static_cast<int>(cudaErrorInvalidValue);
  const int words = words_for(n);
  out[0] = words;
  out[1] = scan_stages(words);
  out[2] = scan_smem(words);
  out[3] = static_cast<long long>(b) * tri(words, words) * 8;
  out[4] = static_cast<long long>(b) * words * (words + 1) / 2;
  return 0;
}

// boxes (B, N, 4) float32 16-byte aligned, scores (B, N) float32, both
// sorted by descending score per image and contiguous; keep (B, N) bool;
// mask the workspace of nms_geometry's out[3] bytes, 16-byte aligned.
// Launches both passes on `stream`, does not synchronise; returns
// cudaGetLastError() (0 on success).
int nms_keep_mask_f32(const void* boxes, const void* scores, void* keep, void* mask, int b,
                      int n, int cap, float thr, void* stream) {
  long long geom[5];
  if (b == 0 || n == 0) return 0;
  const int rc = nms_geometry(b, n, geom);
  if (rc != 0) return rc;
  const int words = static_cast<int>(geom[0]);
  const int stages = static_cast<int>(geom[1]);
  const int smem = static_cast<int>(geom[2]);
  auto st = static_cast<cudaStream_t>(stream);
  auto* mk = static_cast<u64*>(mask);
  const auto* sc = static_cast<const float*>(scores);

  nms_mask_pass<<<dim3(static_cast<unsigned>(geom[4] / b), b), kBits, 0, st>>>(
      static_cast<const float4*>(boxes), sc, mk, n, words, thr);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(nms_scan, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  nms_scan<<<b, kScanThreads, smem, st>>>(sc, mk, static_cast<bool*>(keep), n, words, cap,
                                          stages);
  return static_cast<int>(cudaGetLastError());
}

const char* nms_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
