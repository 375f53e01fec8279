// Hopper (sm_90a) pieces shared by the TMA + wgmma kernels of this library:
// mbarriers, TMA tensor and bulk loads, the TMA store, wgmma group waits,
// register rebalancing between warpgroups, the head-grouped launch order of
// the flash kernels, and on the host the encoding of bf16 tensor maps with
// the 128-byte swizzle the wgmma descriptors name and the opt-in to more
// than 48 KB of dynamic shared memory.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

namespace mxtpu {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

// Make the initialised barriers visible to every thread and to TMA; a
// __syncthreads() follows it.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Spin until the barrier's phase of parity `parity` has completed.  A wait
// that has not ended after 2^26 tries (seconds) traps, so that a fault in a
// pipeline's bookkeeping ends the launch with an error instead of hanging
// the card.
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned done;
  unsigned tries = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (++tries == (1u << 26)) __trap();
  } while (!done);
}

// A box of a 2-D or 3-D tensor map into shared memory; completes `bytes` of
// the barrier's expected transaction count.  Coordinates innermost first.
__device__ __forceinline__ void tma_load(unsigned dst, const CUtensorMap* map, unsigned bar,
                                         int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<unsigned long long>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load(unsigned dst, const CUtensorMap* map, unsigned bar,
                                         int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<unsigned long long>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// `bytes` contiguous bytes (a multiple of 16, both addresses 16-byte
// aligned) into shared memory, completing on the barrier like a TMA box.
__device__ __forceinline__ void bulk_load(unsigned dst, const void* src, unsigned bytes,
                                          unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, unsigned src, int c0,
                                          int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
          reinterpret_cast<unsigned long long>(map)),
      "r"(src), "r"(c0), "r"(c1)
      : "memory");
}

// Wait until at most N of this warpgroup's committed wgmma groups are still
// running (groups retire in the order they were committed).
template <int N>
__device__ __forceinline__ void wgmma_wait_group() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Registers a retired wgmma wrote: the compiler may not move a read of them
// above the wait that retired it.
template <int N>
__device__ __forceinline__ void reg_fence(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(x[i])::"memory");
}

// Hand registers between the warpgroups of a block: every warp of a
// warpgroup runs the same one, and the kernel's launch bounds fix the count
// each thread starts with.
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>((reinterpret_cast<unsigned long long>(p) + 1023) &
                                          ~1023ull);
}

// Heads whose blocks a flash kernel launches together.
constexpr int kHeadGroup = 8;

// The head and row block of work unit `u` (one per head and row block) in
// the launch order: the heads in groups of kHeadGroup, each group's units
// before the next group's, so that the rows they all stream (a few MB) stay
// in L2; in a group, row blocks by `order` (0 the longest under causal),
// heads fastest.  Units of every head at once would stream every head's
// rows: more than L2 holds.
__device__ __forceinline__ void unit_coords(int u, int heads, int row_blocks, int& bh,
                                            int& order) {
  const int g0 = u / (kHeadGroup * row_blocks) * kHeadGroup;
  const int n = min(kHeadGroup, heads - g0);
  const int r = u - g0 * row_blocks;
  order = r / n;
  bh = g0 + r % n;
}

// The same for a grid of one block per unit, launched in that order.
__device__ __forceinline__ void block_coords(int heads, int row_blocks, int& bh, int& order) {
  unit_coords(blockIdx.x, heads, row_blocks, bh, order);
}

// cuTensorMapEncodeTiled is a driver entry point; it is fetched through the
// runtime so a library needs no link against libcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                     &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (p != nullptr && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A bf16 tensor of `rank` (2 or 3) dimensions, innermost first, `strides`
// the bytes between steps of dimensions 1..rank-1; boxes of `box` elements,
// 64 columns (128 bytes) wide, written with the 128-byte swizzle.  Elements
// of a box outside the tensor read as zero.
inline bool encode_bf16(EncodeTiled fn, CUtensorMap* map, const void* ptr, int rank,
                        const cuuint64_t* dims, const cuuint64_t* strides,
                        const cuuint32_t* box) {
  const cuuint32_t estr[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(ptr), dims,
            strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A [bh][len][d] bf16 tensor as a 3-D tensor map, boxes of `rows` rows and
// 64 columns: rows past a head's end and columns past d read as zero.
inline bool encode_rows(EncodeTiled fn, CUtensorMap* map, const void* p, int bh, int len,
                        int d, int rows) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(len),
                              static_cast<cuuint64_t>(bh)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d) * 2,
                                 static_cast<cuuint64_t>(len) * d * 2};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(rows), 1};
  return encode_bf16(fn, map, p, 3, dims, strides, box);
}

// Let `kern` take `bytes` of dynamic shared memory, once a process.
template <typename Kern>
cudaError_t allow_smem(Kern kern, int bytes, bool& done) {
  if (done) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) done = true;
  return err;
}

}  // namespace mxtpu
