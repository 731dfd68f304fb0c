// Hopper building blocks shared by the TMA-fed conv backward kernels
// (conv_bwd.cu, conv_bwd_patch.cu, conv_bwd_tap.cu, chain_bwd.cu), the int8
// conv (int8_conv.cu) and the NMS scan (nms.cu), sm_90a: tensor maps,
// mbarriers, bulk and TMA loads (multicast across a cluster too), wgmma
// descriptors and fences, and the deterministic reduction of per-block dW
// partials across a thread-block cluster.
//
// The tensor-map encoder is the driver's cuTensorMapEncodeTiled, reached
// through cudaGetDriverEntryPoint so that the library links against the
// runtime only (no -lcuda). <cuda.h> is included for its types.

#pragma once

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace hop {

// ---------------------------------------------------------------- host side

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A bf16 tensor map of `rank` dimensions (innermost first) with 128-byte
// swizzle and zero fill outside the tensor: `dims` in elements, `strides`
// in bytes for dimensions 1.., `box` in elements. Returns a cudaError_t.
inline int bf16_map(CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims,
                    const cuuint64_t* strides, const cuuint32_t* box) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  const cuuint32_t elem_strides[5] = {1, 1, 1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base),
                         dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// The map of a dense (B, H, W, 64) NHWC bf16 tensor that loads boxes of
// bh x bw pixels (all 64 channels: one 128-byte row a pixel) of one image.
inline int nhwc_map(CUtensorMap* map, const void* base, int b, int h, int w, int bh, int bw) {
  const cuuint64_t dims[4] = {64, static_cast<cuuint64_t>(w), static_cast<cuuint64_t>(h),
                              static_cast<cuuint64_t>(b)};
  const cuuint64_t strides[3] = {128, 128ull * w, 128ull * w * h};
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(bw), static_cast<cuuint32_t>(bh), 1};
  return bf16_map(map, base, 4, dims, strides, box);
}

// An 8-bit tensor map (int8 data: the bits are the same) of `rank`
// dimensions, innermost first, zero fill outside the tensor, with the
// swizzle of rows of `row_bytes` (128, 64 or 32; 16: none): `dims` in
// elements, `strides` in bytes for dimensions 1.., `box` in elements.
// Returns a cudaError_t.
inline int u8_map(CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims,
                  const cuuint64_t* strides, const cuuint32_t* box, int row_bytes) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  const cuuint32_t elem_strides[5] = {1, 1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle = row_bytes == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : row_bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                     : row_bytes == 32 ? CU_TENSOR_MAP_SWIZZLE_32B
                                                       : CU_TENSOR_MAP_SWIZZLE_NONE;
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, rank, const_cast<void*>(base), dims,
                         strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// Launch `kernel` on `grid` blocks in clusters of `cluster` blocks.
template <typename... Params, typename... Args>
int launch_clustered(void (*kernel)(Params...), int grid, int threads, int smem, int cluster,
                     cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, kernel, args...));
}

// Clusters of `cluster` blocks of `kernel` that the card holds at once
// (0 on error).
template <typename Kernel>
int max_active_clusters(Kernel kernel, int threads, int smem, int cluster) {
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem) !=
      cudaSuccess)
    return 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, kernel, &cfg) != cudaSuccess) return 0;
  return n;
}

// -------------------------------------------------------------- device side

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Block until the phase of parity `parity` of `bar` has completed. A wait
// that outlasts kSpinLimit polls (seconds; a healthy wait takes
// microseconds) traps, so that a pipeline fault ends the launch with an
// error instead of hanging the card. kClusterScope: the phase is completed
// by threads of other blocks of the cluster (mbar_arrive_remote), whose
// writes before they arrived are visible after the wait.
constexpr uint32_t kSpinLimit = 1u << 26;
template <bool kClusterScope = false>
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  for (uint32_t spins = 0;; ++spins) {
    if constexpr (kClusterScope)
      asm volatile(
          "{\n .reg .pred p;\n"
          " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
          " selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done)
          : "r"(addr), "r"(parity)
          : "memory");
    else
      asm volatile(
          "{\n .reg .pred p;\n"
          " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
          " selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done)
          : "r"(addr), "r"(parity)
          : "memory");
    if (done) return;
    if (spins == kSpinLimit) __trap();
  }
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Arrive on the mbarrier at `bar`'s offset in block `rank` of the cluster,
// releasing this thread's earlier writes (to that block's shared memory
// too) at cluster scope.
__device__ __forceinline__ void mbar_arrive_remote(uint64_t* bar, uint32_t rank) {
  uint32_t addr;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(addr) : "r"(smem_u32(bar)), "r"(rank));
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(addr)
               : "memory");
}

// Arrive and announce `bytes` of TMA traffic that completes this phase.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// `bytes` of contiguous global memory from `src` into shared `dst` by the
// bulk-copy engine, completing on `bar` (which the issuing thread armed with
// mbar_expect_tx). Both addresses 16-byte aligned, `bytes` a multiple of 16.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// Coordinates innermost first: (channel, column, row, image); negative or
// past-the-end coordinates read zeros.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, int c3, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// As tma_load_2d, but the box lands at the same shared-memory offset in
// every block of the cluster named in `mask` (bit r: rank r) and completes
// the mbarrier at `bar`'s offset in each of them.
__device__ __forceinline__ void tma_load_2d_multicast(void* dst, const CUtensorMap* map, int c0,
                                                      int c1, uint64_t* bar, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%4, %5}], [%2], %3;\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "h"(mask), "r"(c0), "r"(c1)
      : "memory");
}

// The map of a dense (576, 64) bf16 W9T (row t*64 + ci, column co) that
// loads one tap's 64 x 64 block (8 KiB) a box.
inline int w9t_map(CUtensorMap* map, const void* base) {
  const cuuint64_t dims[2] = {64, 576};
  const cuuint64_t strides[1] = {128};
  const cuuint32_t box[2] = {64, 64};
  return bf16_map(map, base, 2, dims, strides, box);
}

// W9T (9 tap blocks of 8 KiB, 128-byte swizzled: the K-major wgmma B
// operand of each tap) into `dst` of every block of `mask`, `parts` blocks
// sharing the loads: this one, number `part`, issues taps part, part +
// parts, ... and announces all 72 KiB on its own `bar`. Every block of
// `mask` must have initialised its `bar` (a cluster barrier after the
// init) before any of them issues.
__device__ __forceinline__ void load_w9t_multicast(unsigned char* dst, const CUtensorMap* map,
                                                   uint64_t* bar, int part, int parts,
                                                   uint16_t mask) {
  mbar_expect_tx(bar, 9 * 8192);
  for (int t = part; t < 9; t += parts)
    tma_load_2d_multicast(dst + t * 8192, map, 0, t * 64, bar, mask);
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// Byte offset of 16-byte chunk `chunk` of row `row` in a tile that TMA
// wrote with 128-byte swizzle (rows of 128 bytes, tile 1024-byte aligned).
__device__ __forceinline__ uint32_t swz(int row, int chunk) {
  return static_cast<uint32_t>(row * 128 + ((chunk ^ (row & 7)) << 4));
}

// `off` (a byte offset from a base aligned to 1024 bytes) as TMA's swizzle
// of rows of `row_bytes` (128, 64, 32; 16: none) moves it: the 16-byte
// chunk index XOR address bits 7.. (swz is the 128-byte case).
__device__ __forceinline__ uint32_t swz_rows(uint32_t off, int row_bytes) {
  return off ^ (((off >> 7) & static_cast<uint32_t>((row_bytes >> 4) - 1)) << 4);
}

// wgmma shared-memory descriptor of a K-major operand whose rows are
// `row_bytes` wide: 128, 64 or 32 with TMA's swizzle of that width (8-row
// groups 8 rows apart, the leading offset unused); 16 with no swizzle, core
// matrices (8 rows x 16 bytes, 128 bytes) 128 bytes apart along M / N and
// `lbo` bytes apart along K.
__device__ __forceinline__ uint64_t wg_desc_rows(uint32_t addr, int row_bytes, uint32_t lbo) {
  const uint64_t layout = row_bytes == 128 ? 1 : row_bytes == 64 ? 2 : row_bytes == 32 ? 3 : 0;
  const uint64_t sbo = row_bytes == 16 ? 128 >> 4 : (8 * row_bytes) >> 4;
  const uint64_t lead = row_bytes == 16 ? lbo >> 4 : 1;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (lead << 16) | (sbo << 32) |
         (layout << 62);
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand whose
// 8-row groups lie 1024 bytes apart; both offset fields are set to that
// stride, which is the only one an operand 64 elements wide uses.
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr) {
  constexpr uint64_t k1024 = 1024 >> 4;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (k1024 << 16) | (k1024 << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed groups of products are still running
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keep the compiler from moving accumulator reads or writes across the
// asynchronous products
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// The deterministic cross-block reduction of dW partials. The blocks of a
// cluster of kCluster have each written a partial of n floats to their own
// shared memory at `mine`; block r of the cluster sums elements [r * n /
// kC, (r + 1) * n / kC) of the partials of ranks kFirst, kFirst + kStep,
// ... in rank order and writes them to `out` (n floats) of the device
// workspace. The caller brackets it with cluster barriers, which keep
// every partial alive until all have been read.
template <int kCluster, int kFirst, int kStep>
__device__ void sum_cluster_ranks(float* mine, float* __restrict__ out, int n) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  constexpr int kParts = (kCluster - kFirst + kStep - 1) / kStep;
  const int rank = static_cast<int>(cluster.block_rank());
  const float4* src[kParts];
#pragma unroll
  for (int q = 0; q < kParts; ++q)
    src[q] = reinterpret_cast<const float4*>(cluster.map_shared_rank(mine, kFirst + q * kStep));
  const int per = n / 4 / kCluster;  // float4s this block sums
  float4* dst = reinterpret_cast<float4*>(out);
  for (int i = rank * per + static_cast<int>(threadIdx.x); i < (rank + 1) * per;
       i += blockDim.x) {
    float4 s = src[0][i];
#pragma unroll
    for (int q = 1; q < kParts; ++q) {
      const float4 v = src[q][i];
      s.x = __fadd_rn(s.x, v.x);
      s.y = __fadd_rn(s.y, v.y);
      s.z = __fadd_rn(s.z, v.z);
      s.w = __fadd_rn(s.w, v.w);
    }
    dst[i] = s;
  }
}

// Every block's partial of a cluster summed in rank order into `out`.
template <int kCluster>
__device__ void cluster_sum_partials(float* mine, float* __restrict__ out, int n) {
  namespace cg = cooperative_groups;
  cg::this_cluster().sync();  // every block's partial is in its shared memory
  sum_cluster_ranks<kCluster, 0, 1>(mine, out, n);
  cg::this_cluster().sync();  // no block leaves while another still reads its partial
}

}  // namespace hop
