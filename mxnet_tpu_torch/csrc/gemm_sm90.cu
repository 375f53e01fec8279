// The 1x1-conv dgrad in bf16 for Hopper: dx[M, I] = dy[M, O] @ w[O, I],
// fp32 accumulators, stored bf16, with TMA loads and wgmma.
//
// It replaces the Pallas kernel of the JAX package's 1x1-conv backward,
// mxnet_tpu/ops/nn.py _conv1x1_dgrad_pallas (its pallas_call at :110).
//
// What bounds it on an H100: at 9 of the 12 dgrad shapes of a bench
// ResNet-50 step (M = batch * H * W up to 401408 rows, O and I 64..1024) the
// product does 32-230 flops per byte of bf16 read and written, below the
// ~295 the tensor cores need, so reading dy and writing dx at 3.35 TB/s is
// the limit; the three widest shapes (K, N >= 512 at M = 6272 and 25088) are
// bound by the 989 TFLOP/s of the tensor cores.  So the design reads each
// byte of dy from device memory once and keeps enough loads in flight to
// cover the memory's latency:
//
// * Persistent blocks, one per SM (its shared memory fills the SM), walk
//   the output tiles [128, BN] with the N tiles of a row block adjacent, so
//   the blocks that share a row block of dy run together and find it in L2.
//   BN is the whole of N up to 256 (8 of the 12 shapes: dy is read once);
//   the launcher narrows it where the wide tile would leave SMs idle
//   (M = 6272 has only 49 row blocks).
// * Warp specialisation.  Warp 8 is the producer: one thread issues
//   TMA loads (cp.async.bulk.tensor.2d, completion on an mbarrier) of dy
//   tiles [128, 64] and w tiles [64, 64] into a ring of 3-8 stages, filling
//   stages for the next tile while the consumers finish this one.  Warp
//   groups 0 and 1 are consumers, 64 rows each: wgmma.mma_async m64n64k16,
//   bf16 -> fp32, one instruction per 64-wide chunk of BN and per 16 of K,
//   reading both operands from the stage in shared memory; each consumer
//   group frees a stage with one arrival on its "empty" mbarrier.
// * Layouts.  dy is K-major (row-major [M, O]); w, row-major [O, I], is the
//   B operand [K, N] in MN-major order, which wgmma takes for 16-bit types
//   with the transpose bit.  Both tiles are 128 bytes wide and TMA writes
//   them with the 128-byte swizzle that the wgmma descriptors name (K-major
//   A: stride 1024 bytes between groups of 8 rows; MN-major B: 1024 bytes
//   between groups of 8 rows of K; one 64-wide swizzle atom per
//   instruction, so the atom-to-atom offset is never read).
// * Epilogue.  Each consumer group rounds its accumulators to bf16 into its
//   own swizzled staging tile and issues TMA stores; the store of one tile
//   overlaps the next tile's products, and the staging tile is only
//   rewritten once its previous store has been read out.  No fp32 tile
//   goes through shared memory.
// * Tails.  Rows past M, and K or N past the tensor's edge, are TMA's
//   zero-filled out-of-bounds box on load and are clipped on store.  TMA
//   needs 16-byte aligned tensors and row strides, i.e. O and I multiples of
//   8: the Python wrapper sends every other shape, and fp32, to the older
//   core of gemm_kernels.cu, by shape alone.
#include <cuda.h>
#include <cuda_bf16.h>

#include "common.h"

namespace mxtpu {
namespace {

constexpr int kBM = 128;           // rows of an output tile (two consumer groups)
constexpr int kBK = 64;            // K of a stage: 128 bytes of bf16
constexpr int kChunk = 64;         // N of one wgmma and of one TMA box of w
constexpr int kThreads = 288;      // consumer groups 0, 1; producer warp 8
constexpr int kABytes = kBM * kBK * 2;       // 16 KB
constexpr int kBBytes = kBK * kChunk * 2;    // 8 KB a chunk
constexpr int kOutBytes = 64 * kChunk * 2;   // 8 KB a chunk of one group
constexpr int kSmemBudget = 220 * 1024;

template <int NB>
struct Plan {
  static constexpr int kStageBytes = kABytes + NB * kBBytes;
  static constexpr int kOutTotal = 2 * NB * kOutBytes;
  static constexpr int kFit = (kSmemBudget - kOutTotal - 1024) / kStageBytes;
  static constexpr int kStages = kFit > 8 ? 8 : kFit;
  static_assert(kStages >= 3, "the ring needs at least three stages");
  // 1024 bytes of slack align the tiles to the 128-byte swizzle's period
  static constexpr int kSmem =
      1024 + kStages * kStageBytes + kOutTotal + 2 * kStages * 8;
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Spin until the barrier's phase differs from `parity`.
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load(unsigned dst, const CUtensorMap* map, unsigned bar,
                                         int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<unsigned long long>(map)), "r"(bar), "r"(c0), "r"(c1)
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

// A wgmma shared-memory descriptor for a tile written by TMA with the
// 128-byte swizzle: start address, leading and stride byte offsets (all in
// 16-byte units), layout type 1 (SWIZZLE_128B) in bits 62-63.
__device__ __forceinline__ unsigned long long wgmma_desc(unsigned addr, unsigned lbo,
                                                         unsigned sbo) {
  return (static_cast<unsigned long long>((addr & 0x3FFFF) >> 4)) |
         (static_cast<unsigned long long>(lbo & 0x3FFF) << 16) |
         (static_cast<unsigned long long>(sbo & 0x3FFF) << 32) | (1ull << 62);
}

// acc[0..31] += A[64 x 16] (K-major) @ B[16 x 64] (MN-major), bf16 in, fp32 out.
__device__ __forceinline__ void wgmma_m64n64k16(float* d, unsigned long long da,
                                                unsigned long long db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

template <int NB>
__global__ void __launch_bounds__(kThreads, 1)
    conv1x1_dgrad_sm90_kernel(const __grid_constant__ CUtensorMap map_dy,
                              const __grid_constant__ CUtensorMap map_w,
                              const __grid_constant__ CUtensorMap map_dx, int M, int K,
                              int N) {
  using P = Plan<NB>;
  constexpr int S = P::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<unsigned long long>(smem_raw) + 1023) & ~1023ull);
  unsigned char* stage0 = smem;                                // S x [A | B chunks]
  unsigned char* out0 = smem + S * P::kStageBytes;             // 2 groups x NB chunks
  unsigned long long* bars =
      reinterpret_cast<unsigned long long*>(out0 + P::kOutTotal);  // full[S], empty[S]
  const unsigned full0 = smem_addr(bars), empty0 = smem_addr(bars + S);

  const int tiles_m = (M + kBM - 1) / kBM;
  const int tiles_n = (N + NB * kChunk - 1) / (NB * kChunk);
  const int tiles = tiles_m * tiles_n;
  const int nk = (K + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full0 + 8 * s, 1);    // the producer's arrive.expect_tx
      mbar_init(empty0 + 8 * s, 2);   // one arrival per consumer group
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int group = threadIdx.x / 128;
  if (group == 2) {
    // ------------------------------------------------------------ producer
    if (threadIdx.x == 256) {
      int s = 0;
      unsigned phase = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = (t / tiles_n) * kBM;
        const int n0 = (t % tiles_n) * NB * kChunk;
        // chunks wholly past N are not loaded; their products are never stored
        const int live = min(NB, (N - n0 + kChunk - 1) / kChunk);
        for (int kt = 0; kt < nk; ++kt) {
          mbar_wait(empty0 + 8 * s, phase ^ 1);   // passes at once on the first lap
          const unsigned full = full0 + 8 * s;
          mbar_expect_tx(full, kABytes + live * kBBytes);
          const unsigned a = smem_addr(stage0 + s * P::kStageBytes);
          tma_load(a, &map_dy, full, kt * kBK, m0);
          for (int c = 0; c < live; ++c)
            tma_load(a + kABytes + c * kBBytes, &map_w, full, n0 + c * kChunk, kt * kBK);
          if (++s == S) {
            s = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const bool leader = tid == 0;
    unsigned char* out = out0 + group * NB * kOutBytes;
    int s = 0;
    unsigned phase = 0;
    float acc[NB][32];
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int m0 = (t / tiles_n) * kBM;
      const int n0 = (t % tiles_n) * NB * kChunk;
#pragma unroll
      for (int c = 0; c < NB; ++c)
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;
      for (int kt = 0; kt < nk; ++kt) {
        mbar_wait(full0 + 8 * s, phase);
        const unsigned a = smem_addr(stage0 + s * P::kStageBytes) + group * 64 * 128;
        const unsigned b = smem_addr(stage0 + s * P::kStageBytes) + kABytes;
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) {
          // A: 16 K columns are 32 bytes along the swizzled row; B: 16 K
          // rows are 2048 bytes down the chunk
          const unsigned long long da = wgmma_desc(a + kk * 32, 1, 64);
#pragma unroll
          for (int c = 0; c < NB; ++c)
            wgmma_m64n64k16(acc[c], da,
                            wgmma_desc(b + c * kBBytes + kk * 2048, kBBytes / 16, 64));
        }
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
        if (leader) mbar_arrive(empty0 + 8 * s);
        if (++s == S) {
          s = 0;
          phase ^= 1;
        }
      }

      // epilogue: the previous tile's store must have read the staging tile
      if (leader) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + group) : "memory");
      // accumulator layout of m64nN: row 16 * warp + lane / 4 (+ 8), columns
      // 8 * j + 2 * (lane % 4) (+ 1); rows of the staging tile are 128
      // bytes, their 16-byte units XOR-swizzled with the row's low 3 bits
      const int r = warp * 16 + lane / 4;
#pragma unroll
      for (int c = 0; c < NB; ++c) {
        unsigned char* tile = out + c * kOutBytes;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int unit = (j ^ (r & 7)) * 16 + (lane % 4) * 4;
          *reinterpret_cast<unsigned*>(tile + r * 128 + unit) =
              pack_bf16(acc[c][4 * j], acc[c][4 * j + 1]);
          *reinterpret_cast<unsigned*>(tile + (r + 8) * 128 + unit) =
              pack_bf16(acc[c][4 * j + 2], acc[c][4 * j + 3]);
        }
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + group) : "memory");
      if (leader) {
#pragma unroll
        for (int c = 0; c < NB; ++c)
          if (n0 + c * kChunk < N)
            tma_store(&map_dx, smem_addr(out + c * kOutBytes), n0 + c * kChunk,
                      m0 + group * 64);
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      }
    }
    if (leader) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
}

// cuTensorMapEncodeTiled is a driver entry point; it is fetched through the
// runtime so the library needs no link against libcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_fn() {
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

// A 2-D bf16 row-major [rows, cols] tensor, boxes [box_rows, 64], 128-byte swizzle.
bool encode(EncodeTiled fn, CUtensorMap* map, const void* ptr, long long rows, int cols,
            int box_rows) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t estr[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides,
            box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int NB>
int launch(const void* dy, const void* w, void* dx, int M, int O, int I, int grid,
           cudaStream_t stream) {
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  CUtensorMap map_dy, map_w, map_dx;
  if (!encode(fn, &map_dy, dy, M, O, kBM) || !encode(fn, &map_w, w, O, I, kBK) ||
      !encode(fn, &map_dx, dx, M, I, 64))
    return static_cast<int>(cudaErrorInvalidValue);
  static bool attr = false;
  if (!attr) {
    cudaError_t err = cudaFuncSetAttribute(conv1x1_dgrad_sm90_kernel<NB>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           Plan<NB>::kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr = true;
  }
  conv1x1_dgrad_sm90_kernel<NB><<<grid, kThreads, Plan<NB>::kSmem, stream>>>(
      map_dy, map_w, map_dx, M, O, I);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace mxtpu

// dx[M, I] = dy[M, O] @ w[O, I], bf16, contiguous, 16-byte aligned, O and I
// multiples of 8.  tile_n (64, 128 or 256) is the N of an output tile and
// grid the number of persistent blocks (the Python wrapper picks both).
MXTPU_API int mxtpu_conv1x1_dgrad_sm90(const void* dy, const void* w, void* dx, long long M,
                                       int O, int I, int tile_n, int grid,
                                       cudaStream_t stream) {
  if (M <= 0 || O <= 0 || I <= 0) return static_cast<int>(cudaGetLastError());
  if (M > 0x7fffffffLL || O % 8 || I % 8 || grid <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int m = static_cast<int>(M);
  switch (tile_n) {
    case 64: return mxtpu::launch<1>(dy, w, dx, m, O, I, grid, stream);
    case 128: return mxtpu::launch<2>(dy, w, dx, m, O, I, grid, stream);
    case 256: return mxtpu::launch<4>(dy, w, dx, m, O, I, grid, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
