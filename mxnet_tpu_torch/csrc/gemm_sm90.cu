// bf16 GEMMs for Hopper: C[M, N] = A[M, K] @ B[K, N], both operands
// row-major, fp32 accumulators, with TMA loads and wgmma, through one of
// three epilogues (gemm_sm90_kernel<NB, EPI>):
//
//   kStore   C rounded to bf16: the 1x1-conv dgrad dx = dy @ w.  It
//            replaces the Pallas kernel of the JAX package's 1x1-conv
//            backward, mxnet_tpu/ops/nn.py _conv1x1_dgrad_pallas (its
//            pallas_call at :110).
//   kAffine  y = relu?(acc * scale[n] + bias[n] [+ res[m, n]]), stored bf16:
//            the bottleneck probe's mm_epilogue, tools/bottleneck_probe.py
//            _mm_epilogue_kernel (its pallas_call at :135).  The rounding
//            steps are the JAX kernel's: one rounded multiply, then the
//            bias's add, then the residual's (as fp32), then y < 0 ? 0 : y,
//            so that a NaN stays NaN.
//   kStats   y as kStore, plus the column sums of the fp32 accumulator and
//            of its square over each 128-row block into part1/part2
//            [ceil(M / 128), N]: the probe's mm_with_stats,
//            tools/bottleneck_probe.py _mm_stats_kernel (pallas_call at
//            :162); the wrapper adds the blocks' partials.
//
// What bounds them on an H100: at the bench ResNet-50's shapes (M = batch *
// H * W up to 401408 rows, K and N 64..2048) most products do 32-230 flops
// per byte of bf16 read and written, below the ~295 the tensor cores need,
// so reading A (and the residual) and writing C at 3.35 TB/s is the limit;
// the widest (K, N >= 512 at M = 6272 and 25088) are bound by the 989
// TFLOP/s of the tensor cores.  So the design reads each byte of A from
// device memory once and keeps enough loads in flight to cover the
// memory's latency:
//
// * Persistent blocks, one per SM (its shared memory fills the SM), walk
//   the output tiles [128, BN] with the N tiles of a row block adjacent, so
//   the blocks that share a row block of A run together and find it in L2.
//   BN is the whole of N up to 256 where that fills the card; the launcher
//   picks it (ops/fused/conv_kernels.py tma_tile_n).
// * Warp specialisation.  Warp 8 is the producer: one thread issues
//   TMA loads (cp.async.bulk.tensor.2d, completion on an mbarrier) of A
//   tiles [128, 64] and B tiles [64, 64] into a ring of 3-8 stages, filling
//   stages for the next tile while the consumers finish this one.  Warp
//   groups 0 and 1 are consumers, 64 rows each: wgmma.mma_async m64n64k16,
//   bf16 -> fp32, one instruction per 64-wide chunk of BN and per 16 of K,
//   reading both operands from the stage in shared memory; each consumer
//   group frees a stage with one arrival on its "empty" mbarrier.
// * Layouts.  A is K-major (row-major [M, K]); B, row-major [K, N], is
//   MN-major, which wgmma takes for 16-bit types with the transpose bit.
//   Both tiles are 128 bytes wide and TMA writes them with the 128-byte
//   swizzle that the wgmma descriptors name (K-major A: stride 1024 bytes
//   between groups of 8 rows; MN-major B: 1024 bytes between groups of 8
//   rows of K; one 64-wide swizzle atom per instruction, so the
//   atom-to-atom offset is never read).
// * Epilogue.  Each consumer group rounds its accumulators to bf16 into its
//   own swizzled staging tile and issues TMA stores; the store of one tile
//   overlaps the next tile's products, and the staging tile is only
//   rewritten once its previous store has been read out.  No fp32 tile
//   goes through shared memory.  kAffine's inputs come by TMA and land
//   under the tile's products: at the start of a tile each group's leader
//   issues bulk copies of the tile's columns of scale and bias (fp32 [N])
//   into the group's shared memory, where each thread reads the 16 columns
//   it holds in a chunk, 8 j + 2 (lane % 4) + {0, 1}; and, once the
//   previous store has been read out, the residual's boxes (a bf16 [M, N]
//   stream as large as y) into the staging tile itself, which has the
//   layout y is stored from, so that each thread reads res where it writes
//   y.  One mbarrier a group counts the three.  kStats sums each thread's two rows, then the 8 rows of a
//   column that a warp's lanes hold by a butterfly over lane bits 4, 3, 2
//   (each step keeps half the values: 28 shuffles a chunk for a thread's
//   32 sums), writes the warp's sums of every chunk of the tile to shared
//   memory (4 KB a chunk), and after one named barrier of the 256 consumer
//   threads a tile each thread adds the 8 warps' sums of a column in order
//   and stores them; an mbarrier tells the next tile's writes that the
//   sums were read.  The sums come out in the same order on every run.
// * Tails.  Rows past M, and K or N past the tensor's edge, are TMA's
//   zero-filled out-of-bounds box on load and are clipped on store, so rows
//   past M add zeros to kStats' sums.  Chunks wholly past N are neither
//   loaded nor stored, and their columns are not summed.  TMA needs 16-byte
//   aligned tensors and row strides, i.e. K and N multiples of 8: the
//   Python wrappers send every other shape, and fp32, to the older core of
//   gemm_kernels.cu, by shape and type alone.
#include <cuda.h>
#include <cuda_bf16.h>

#include "common.h"
#include "sm90.h"

namespace mxtpu {
namespace {

constexpr int kBM = 128;           // rows of an output tile (two consumer groups)
constexpr int kBK = 64;            // K of a stage: 128 bytes of bf16
constexpr int kChunk = 64;         // N of one wgmma and of one TMA box of B
constexpr int kThreads = 288;      // consumer groups 0, 1; producer warp 8
constexpr int kABytes = kBM * kBK * 2;       // 16 KB
constexpr int kBBytes = kBK * kChunk * 2;    // 8 KB a chunk
constexpr int kOutBytes = 64 * kChunk * 2;   // 8 KB a chunk of one group
constexpr int kSmemBudget = 220 * 1024;
constexpr int kSmemMax = 227 * 1024;         // the most a block can take

enum Epi { kStore = 0, kAffine = 1, kStats = 2 };

// kStats: the sums of a chunk, [8 consumer warps][2 sums][64 columns] fp32.
constexpr int kRedFloats = 8 * 2 * kChunk;

template <int NB, int EPI>
struct Plan {
  static constexpr int kStageBytes = kABytes + NB * kBBytes;
  static constexpr int kOutTotal = 2 * NB * kOutBytes;
  // kAffine keeps each group's scale and bias of a tile (512 bytes a
  // chunk); kStats a tile's sums (4 KB a chunk), and it takes all the
  // shared memory a block may have, so that the ring keeps three stages at
  // NB 4
  static constexpr int kEpi = EPI == kStats ? NB * kRedFloats * 4
                              : EPI == kAffine ? 2 * 2 * NB * kChunk * 4 : 0;
  static constexpr int kBudget = EPI == kStats ? kSmemMax - 64 : kSmemBudget;
  static constexpr int kFit = (kBudget - kOutTotal - kEpi - 1024) / kStageBytes;
  static constexpr int kStages = kFit > 8 ? 8 : kFit;
  static_assert(kStages >= 3, "the ring needs at least three stages");
  // full[S], empty[S]; kAffine: one barrier per consumer group for its
  // tile's scale, bias and residual; kStats: "the sums have been read"
  static constexpr int kBars = 2 * kStages + (EPI == kAffine ? 2 : EPI == kStats ? 1 : 0);
  // 1024 bytes of slack align the tiles to the 128-byte swizzle's period
  static constexpr int kSmem = 1024 + kStages * kStageBytes + kOutTotal + kEpi + kBars * 8;
  static_assert(kSmem <= kSmemMax, "more shared memory than a block can take");
};

struct EpiArgs {
  const float* scale;  // kAffine: [N]
  const float* bias;   // kAffine: [N]
  int res;             // kAffine: add the residual map's [M, N]
  int relu;            // kAffine
  float* part1;        // kStats: [ceil(M / kBM), N]
  float* part2;
};

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

// The JAX kernel's first two rounding steps: acc * scale, then + bias.
__device__ __forceinline__ float affine(float acc, float scale, float bias) {
  return __fadd_rn(__fmul_rn(acc, scale), bias);
}

// One step of the kStats butterfly over the lanes that differ in lane bit
// `bit`: of x[0 .. 2H), the lane keeps the half its bit names, adds the
// partner's copy of that half, and leaves it in x[0 .. H).
template <int H>
__device__ __forceinline__ void fold(float* x, int lane, int bit) {
  const bool upper = (lane & bit) != 0;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float keep = upper ? x[H + i] : x[i];
    const float send = upper ? x[i] : x[H + i];
    x[i] = keep + __shfl_xor_sync(kFullMask, send, bit);
  }
}

template <int NB, int EPI>
__global__ void __launch_bounds__(kThreads, 1)
    gemm_sm90_kernel(const __grid_constant__ CUtensorMap map_a,
                     const __grid_constant__ CUtensorMap map_b,
                     const __grid_constant__ CUtensorMap map_c,
                     const __grid_constant__ CUtensorMap map_res, int M, int K, int N,
                     EpiArgs ep) {
  using P = Plan<NB, EPI>;
  constexpr int S = P::kStages;
  extern __shared__ unsigned char smem_raw[];
  // aligned by an offset from the __shared__ array, so that the compiler
  // knows every pointer below is in shared memory and addresses it with 32
  // bits: generic 64-bit pointers to the staging tile would take 32
  // registers beside 128 accumulators, which the stats epilogue at NB 4
  // does not have
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* stage0 = smem;                                // S x [A | B chunks]
  unsigned char* out0 = smem + S * P::kStageBytes;             // 2 groups x NB chunks
  // kAffine: [2 groups][scale, bias][NB * 64]; kStats: [NB][kRedFloats]
  float* epi = reinterpret_cast<float*>(out0 + P::kOutTotal);
  unsigned long long* bars = reinterpret_cast<unsigned long long*>(
      out0 + P::kOutTotal + P::kEpi);  // full[S], empty[S], then the epilogue's
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
    if constexpr (EPI == kAffine) {
      mbar_init(smem_addr(bars + 2 * S), 1);   // a group leader's arrive.expect_tx
      mbar_init(smem_addr(bars + 2 * S + 1), 1);
    }
    if constexpr (EPI == kStats) mbar_init(smem_addr(bars + 2 * S), 256);   // every consumer
    mbar_init_fence();
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
          tma_load(a, &map_a, full, kt * kBK, m0);
          for (int c = 0; c < live; ++c)
            tma_load(a + kABytes + c * kBBytes, &map_b, full, n0 + c * kChunk, kt * kBK);
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
    const unsigned epi_bar = smem_addr(bars + 2 * S + group);  // kAffine
    unsigned epi_phase = 0;
    float* sb = epi + group * 2 * NB * kChunk;   // kAffine: scale, then bias
    const unsigned red_free = smem_addr(bars + 2 * S);         // kStats
    unsigned red_phase = 0;
    int s = 0;
    unsigned phase = 0;
    float acc[NB][32];
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int m0 = (t / tiles_n) * kBM;
      const int n0 = (t % tiles_n) * NB * kChunk;
      bool res_live = false;
      if constexpr (EPI == kAffine) {
        // the tile's scale and bias, and the residual's boxes into the
        // staging tile once the previous tile's store has read it out, land
        // under this tile's products
        res_live = ep.res && m0 + group * 64 < M;
        if (leader) {
          const int live = min(NB, (N - n0 + kChunk - 1) / kChunk);
          const unsigned sb_bytes = (min(N, n0 + NB * kChunk) - n0) * 4;
          mbar_expect_tx(epi_bar, 2 * sb_bytes + (res_live ? live * kOutBytes : 0));
          bulk_load(smem_addr(sb), ep.scale + n0, sb_bytes, epi_bar);
          bulk_load(smem_addr(sb + NB * kChunk), ep.bias + n0, sb_bytes, epi_bar);
          if (res_live) {
            asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
            for (int c = 0; c < live; ++c)
              tma_load(smem_addr(out + c * kOutBytes), &map_res, epi_bar, n0 + c * kChunk,
                       m0 + group * 64);
          }
        }
      }
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
      if constexpr (EPI == kAffine) {
        mbar_wait(epi_bar, epi_phase);
        epi_phase ^= 1;
      }
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
          unsigned* lo = reinterpret_cast<unsigned*>(tile + r * 128 + unit);
          unsigned* hi = reinterpret_cast<unsigned*>(tile + (r + 8) * 128 + unit);
          float y[4] = {acc[c][4 * j], acc[c][4 * j + 1], acc[c][4 * j + 2], acc[c][4 * j + 3]};
          if constexpr (EPI == kAffine) {
            // columns past N read what the buffer held: never stored
            const int col = c * kChunk + 8 * j + 2 * (lane % 4);
            const float2 sc = *reinterpret_cast<const float2*>(sb + col);
            const float2 bi = *reinterpret_cast<const float2*>(sb + NB * kChunk + col);
            y[0] = affine(y[0], sc.x, bi.x);
            y[1] = affine(y[1], sc.y, bi.y);
            y[2] = affine(y[2], sc.x, bi.x);
            y[3] = affine(y[3], sc.y, bi.y);
            if (res_live) {
              const float2 r0 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(lo));
              const float2 r1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(hi));
              y[0] = __fadd_rn(y[0], r0.x);
              y[1] = __fadd_rn(y[1], r0.y);
              y[2] = __fadd_rn(y[2], r1.x);
              y[3] = __fadd_rn(y[3], r1.y);
            }
            if (ep.relu) {
#pragma unroll
              for (int e = 0; e < 4; ++e) y[e] = y[e] < 0.f ? 0.f : y[e];   // NaN stays NaN
            }
          }
          *lo = pack_bf16(y[0], y[1]);
          *hi = pack_bf16(y[2], y[3]);
        }
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + group) : "memory");
      if (leader) {
#pragma unroll
        for (int c = 0; c < NB; ++c)
          if (n0 + c * kChunk < N)
            tma_store(&map_c, smem_addr(out + c * kOutBytes), n0 + c * kChunk,
                      m0 + group * 64);
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      }

      if constexpr (EPI == kStats) {
        // Each piece of 16 columns (j = 2p, 2p + 1): x[k], x[4 + k] are the
        // sum and the sum of squares of the thread's two rows in column
        // 16 p + 8 (k / 2) + 2 (lane % 4) + k % 2; after the butterfly over
        // lane bits 4, 3, 2, x[0] holds the warp's slot g = lane / 4 of
        // the piece's 8: the sum named by g / 4 in column 16 p + 8 ((g / 2)
        // % 2) + 2 (lane % 4) + g % 2.
        const int g = lane / 4;
        mbar_wait(red_free, red_phase ^ 1);   // the last tile's sums were read
#pragma unroll
        for (int c = 0; c < NB; ++c) {
          if (n0 + c * kChunk >= N) continue;   // the same for every consumer
          float* dst = epi + (c * 8 + group * 4 + warp) * 2 * kChunk + (g / 4) * kChunk +
                       8 * ((g / 2) % 2) + 2 * (lane % 4) + g % 2;
#pragma unroll
          for (int p = 0; p < 4; ++p) {
            float x[8];
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              const int i = 4 * (2 * p + k / 2) + k % 2;
              const float v0 = acc[c][i], v1 = acc[c][i + 2];
              x[k] = v0 + v1;
              x[4 + k] = fmaf(v1, v1, v0 * v0);
            }
            fold<4>(x, lane, 16);
            fold<2>(x, lane, 8);
            fold<1>(x, lane, 4);
            dst[16 * p] = x[0];
          }
        }
        asm volatile("bar.sync 3, 256;\n" ::: "memory");
        // then each consumer thread adds the 8 warps' sums of a slot in order
        for (int i = threadIdx.x; i < NB * 2 * kChunk; i += 256) {
          const int c = i / (2 * kChunk), slot = i % (2 * kChunk);
          const int n = n0 + c * kChunk + slot % kChunk;
          if (n >= N) continue;
          const float* src = epi + c * kRedFloats + slot;
          float sum = 0.f;
#pragma unroll
          for (int w = 0; w < 8; ++w) sum += src[w * 2 * kChunk];
          (slot < kChunk ? ep.part1 : ep.part2)[static_cast<long long>(m0 / kBM) * N + n] = sum;
        }
        mbar_arrive(red_free);
        red_phase ^= 1;
      }
    }
    if (leader) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
}

// A 2-D bf16 row-major [rows, cols] tensor, boxes [box_rows, 64], 128-byte swizzle.
bool encode(EncodeTiled fn, CUtensorMap* map, const void* ptr, long long rows, int cols,
            int box_rows) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_rows)};
  return encode_bf16(fn, map, ptr, 2, dims, strides, box);
}

// C[M, N] = A[M, K] @ B[K, N] through epilogue EPI; res (kAffine) may be null.
template <int NB, int EPI>
int launch(const void* a, const void* b, void* c, const void* res, int M, int K, int N,
           EpiArgs ep, int grid, cudaStream_t stream) {
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  CUtensorMap map_a, map_b, map_c, map_res;
  if (!encode(fn, &map_a, a, M, K, kBM) || !encode(fn, &map_b, b, K, N, kBK) ||
      !encode(fn, &map_c, c, M, N, 64))
    return static_cast<int>(cudaErrorInvalidValue);
  if (res == nullptr)
    map_res = map_c;   // never read
  else if (!encode(fn, &map_res, res, M, N, 64))
    return static_cast<int>(cudaErrorInvalidValue);
  static bool attr = false;
  const cudaError_t err = allow_smem(gemm_sm90_kernel<NB, EPI>, Plan<NB, EPI>::kSmem, attr);
  if (err != cudaSuccess) return static_cast<int>(err);
  gemm_sm90_kernel<NB, EPI><<<grid, kThreads, Plan<NB, EPI>::kSmem, stream>>>(
      map_a, map_b, map_c, map_res, M, K, N, ep);
  return static_cast<int>(cudaGetLastError());
}

// The common checks of the entries, then the instantiation of tile_n (64,
// 128 or 256).  -1: nothing to launch.
template <int EPI>
int dispatch(const void* a, const void* b, void* c, const void* res, long long M, int K,
             int N, EpiArgs ep, int tile_n, int grid, cudaStream_t stream) {
  if (M <= 0 || K <= 0 || N <= 0) return static_cast<int>(cudaGetLastError());
  if (M > 0x7fffffffLL || K % 8 || N % 8 || grid <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int m = static_cast<int>(M);
  switch (tile_n) {
    case 64: return launch<1, EPI>(a, b, c, res, m, K, N, ep, grid, stream);
    case 128: return launch<2, EPI>(a, b, c, res, m, K, N, ep, grid, stream);
    case 256: return launch<4, EPI>(a, b, c, res, m, K, N, ep, grid, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
}  // namespace mxtpu

// All entries take contiguous bf16 tensors, 16-byte aligned, K and N
// multiples of 8.  tile_n (64, 128 or 256) is the N of an output tile and
// grid the number of persistent blocks (the Python wrappers pick both).

// dx[M, I] = dy[M, O] @ w[O, I].
MXTPU_API int mxtpu_conv1x1_dgrad_sm90(const void* dy, const void* w, void* dx, long long M,
                                       int O, int I, int tile_n, int grid,
                                       cudaStream_t stream) {
  return mxtpu::dispatch<mxtpu::kStore>(dy, w, dx, nullptr, M, O, I, mxtpu::EpiArgs{}, tile_n,
                                        grid, stream);
}

// y[M, N] = relu?(scale * (x[M, K] @ w[K, N]) + bias [+ res[M, N]]); scale,
// bias fp32 [N] (8-byte aligned); res null or bf16 [M, N].
MXTPU_API int mxtpu_mm_epilogue_sm90(const void* x, const void* w, const float* scale,
                                     const float* bias, const void* res, void* y, long long M,
                                     int K, int N, int relu, int tile_n, int grid,
                                     cudaStream_t stream) {
  if (scale == nullptr || bias == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const mxtpu::EpiArgs ep{scale, bias, res != nullptr, relu, nullptr, nullptr};
  return mxtpu::dispatch<mxtpu::kAffine>(x, w, y, res, M, K, N, ep, tile_n, grid, stream);
}

// y[M, N] = x[M, K] @ w[K, N]; part1/part2 fp32 [ceil(M / 128), N] get each
// 128-row block's column sums of the accumulator and of its square.
MXTPU_API int mxtpu_mm_stats_sm90(const void* x, const void* w, void* y, float* part1,
                                  float* part2, long long M, int K, int N, int tile_n,
                                  int grid, cudaStream_t stream) {
  if (part1 == nullptr || part2 == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const mxtpu::EpiArgs ep{nullptr, nullptr, 0, 0, part1, part2};
  return mxtpu::dispatch<mxtpu::kStats>(x, w, y, nullptr, M, K, N, ep, tile_n, grid, stream);
}
