// Flash attention (forward with its log-sum-exp, and the backward's dK/dV and
// dQ passes) and block-table paged decode attention, fp32, for sm_90a.
//
// mxtpu_flash_prefill replaces the Pallas flash forward that the JAX
// package's prefill reaches (mxnet_tpu/ops/attention.py _flash_fwd_pallas /
// _flash_kernel, through ops/fused/attention_kernels.py
// fused_prefill_attention).  mxtpu_paged_decode replaces
// fused_paged_decode_attention (_paged_decode_kernel) of
// mxnet_tpu/ops/fused/attention_kernels.py.  mxtpu_flash_bwd_dkdv and
// mxtpu_flash_bwd_dq replace the two pallas_calls of _flash_bwd_pallas
// (_flash_bwd_dkdv_kernel, _flash_bwd_dq_kernel) in mxnet_tpu/ops/attention.py;
// with the lse output and the causal flag, mxtpu_flash_prefill also replaces
// the training forward (_flash_fwd_pallas with return_lse=True).
//
// Flash forward.  softmax(q k^T * scale) v on [B, H, T, D], causal or not,
// with the lse the backward reads.  What bounds it on an H100: at the
// training shape (B = 8, 16 heads, T = 2048, D = 64, causal) the two
// products do 4 * D * B * H * T(T+1)/2 = 68.7 GFLOP against 268 MB of q,
// k, v, o and lse (0.08 ms), so it is bound by operations.  It is fp32
// and must stay within 1e-4 of an fp32 softmax, which one pass of TF32
// (10-bit mantissa) cannot; on CUDA cores (67 TFLOP/s) the floor is
// 1.03 ms.  The tensor cores reach fp32 accuracy in 3xTF32: each operand
// is split into a TF32 "big" part and a TF32 "small" remainder, and a b =
// a_s b_b + a_b b_s + a_b b_b, three products at 495 TFLOP/s, a floor of
// 0.42 ms.  Design
// (flash_fwd_kernel): a warpgroup owns 64 query rows and a block holds one
// or two warpgroups (two where the grid still covers the card: they share
// each K/V tile); K/V tiles of 64 keys (32 at D = 128) land by cp.async
// while the previous tile is multiplied, and are split once into TF32 big
// and small tiles in 128-byte swizzled shared memory, V transposed, as
// wgmma wants both tf32 operands K-major.  S = Q K^T and O += P V run as
// wgmma m64nNk8 tf32, three products each, with A in registers (Q's split
// fragments, loaded once; P straight from S's accumulators).  The online
// softmax (running max, sum, rescale) never leaves registers; under causal
// the key tiles above the diagonal are never loaded and only the diagonal
// tile is masked; the bottom (longest) row blocks start first.  No product
// is single-pass TF32.
//
// Flash backward.  At the training shape (B = 8, 16 heads, T = 2048, D = 64,
// causal) the two passes do 4 + 3 products of D per (query, key) pair below
// the diagonal, 7 * 2 * D * B * H * T(T+1)/2 = 240 GFLOP against 60 MB read
// and written: bound by operations.  As in the forward, fp32 accuracy on the
// tensor cores takes 3xTF32, a floor of 0.83 ms (dK/dV) + 0.63 ms (dQ) at
// 495 TFLOP/s, against 2.05 + 1.54 ms on CUDA cores.  The TPU kernels'
// 1024-row blocks carried their sums across a sequential grid axis; here one
// block per (b*h, 128 resident rows) loops over the streamed tiles, sums
// each tile's products in fresh wgmma accumulators and adds them to fp32
// totals in registers.  Two passes, each writing only its own rows, so no
// atomics (see the backward section below).
//
// Paged decode.  One query per sequence against K/V read through the
// block table, the current token's K/V taken from k_step/v_step at
// position context_len - 1.  What bounds it: it reads each live K and V
// row once (B = 8 sequences of about 576 tokens, 16 heads, D = 64 read
// 38 MB per layer, about 11 us at 3.35 TB/s) and does 4 flops per element
// read, far below the card's ratio, so it is bound by bytes.  Design: one
// block of 256 threads per (b, h).  Each block reads its own block ids from
// the table (the TPU version's scalar prefetch), visits only the
// ceil(context_len / block_size) live pages, and never builds the
// [B, max_blocks * block_size, H, D] gather the Pallas kernel stages: one
// warp per key computes a score with a coalesced 256-byte read of the key
// row, the scores of the sequence sit in shared memory for an exact
// two-pass softmax, and the P.V pass reads each value row once, coalesced.

#include "common.h"

namespace {

// ---------------------------------------------------------------- forward

constexpr int kFwdGroupQ = 64;    // query rows of a warpgroup: one wgmma M, 16 a warp

// x = big + small to about 2^-22 of x, both tf32 (round to nearest, ties away).
__device__ __forceinline__ void split_tf32(float x, unsigned& big, unsigned& small) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(big) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(small) : "f"(x - __uint_as_float(big)));
}

// Shared-memory descriptor of a K-major tf32 tile stored in 128-byte
// swizzled atoms ([rows][32 fp32], 16-byte units XOR row % 8): 8-row groups
// 1024 bytes apart, layout type SWIZZLE_128B.
__device__ __forceinline__ unsigned long long tile_desc(const void* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  return static_cast<unsigned long long>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (64ull << 32) | (1ull << 62);
}

// Byte offset of element (row, k) in a K-major tile of `rows` rows stored
// as atoms of 32 k: the layout tile_desc describes.
__device__ __forceinline__ int swz(int rows, int row, int k) {
  return (k / 32) * rows * 128 + row * 128 + ((((k % 32) / 4) ^ (row % 8)) * 16) + (k % 4) * 4;
}

// d[64 x N] += a[64 x 8] (registers, the m16n8k8 A layout per warp) @ b[8 x N]
// (shared memory, K-major), tf32 in, fp32 out.
template <int N>
__device__ __forceinline__ void wgmma_tf32(float* d, const unsigned* a, unsigned long long b);

template <>
__device__ __forceinline__ void wgmma_tf32<32>(float* d, const unsigned* a, unsigned long long b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tf32<64>(float* d, const unsigned* a, unsigned long long b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d += a b in 3xTF32: the two terms with a small part first, then big x big
// (small x small, below fp32's rounding, is dropped).
template <int N>
__device__ __forceinline__ void wgmma_3xtf32(float* d, const unsigned* a_big,
                                             const unsigned* a_small, unsigned long long b_big,
                                             unsigned long long b_small) {
  wgmma_tf32<N>(d, a_small, b_big);
  wgmma_tf32<N>(d, a_big, b_small);
  wgmma_tf32<N>(d, a_big, b_big);
}

// d[64 x N] += a[64 x 8] @ b[8 x N], both from shared memory (K-major
// tiles, as tile_desc describes), tf32 in, fp32 out.
template <int N>
__device__ __forceinline__ void wgmma_tf32_ss(float* d, unsigned long long a,
                                              unsigned long long b);

template <>
__device__ __forceinline__ void wgmma_tf32_ss<32>(float* d, unsigned long long a,
                                                  unsigned long long b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tf32_ss<64>(float* d, unsigned long long a,
                                                  unsigned long long b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_3xtf32_ss(float* d, unsigned long long a_big,
                                                unsigned long long a_small,
                                                unsigned long long b_big,
                                                unsigned long long b_small) {
  wgmma_tf32_ss<N>(d, a_small, b_big);
  wgmma_tf32_ss<N>(d, a_big, b_small);
  wgmma_tf32_ss<N>(d, a_big, b_big);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

template <int D>
struct Fwd {
  static constexpr int kBK = D == 128 ? 32 : 64;   // keys of a tile: S is 64 x kBK
  static constexpr int kNO = D < 64 ? D : 64;      // N of one P.V instruction
  static constexpr int kLdRaw = D + 4;             // padded rows of the cp.async landing
  static constexpr int kSplit = kBK * D * 4;       // bytes of one big or small tile
  static constexpr int kBytes = 1024 + 4 * kSplit + 2 * kBK * kLdRaw * 4;
};

// One block of WG warpgroups per (b*h, 64 * WG query rows), each warpgroup
// 64 rows; K/V tiles of kBK keys, shared by the warpgroups.  Each tile
// lands raw by cp.async, is split once into TF32 big and small
// tiles in 128-byte swizzled shared memory (K as it is, V transposed, both
// K-major as wgmma takes tf32), and the next tile's load flies while this
// one is multiplied.  S = Q K^T and O += P V run as wgmma m64nNk8 tf32 with
// A in registers (Q's split fragments, loaded once; P from S's
// accumulators) and B from the split tiles, three products each.  The
// m64nN accumulator holds, in key block j, (row g, keys 8j+2c, 8j+2c+1)
// and (row g+8, the same), with g = lane / 4, c = lane % 4; the tf32 A
// fragment wants (row g | g+8, k c | c+4).  So V's keys are stored
// permuted within each block of 8 (key 2c at k = c, key 2c+1 at k = c+4),
// and S's accumulators are P's A fragments register for register.
// (Two one-warpgroup blocks or one two-warpgroup block fill an SM's
// registers: ~250 a thread.)
template <int D, int WG>
__global__ void __launch_bounds__(128 * WG, 3 - WG)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
                 int t_len, int tk_len, int causal, float scale) {
  using F = Fwd<D>;
  constexpr int BK = F::kBK;
  constexpr int kKSteps = D / 8;        // k-steps of S = Q K^T
  constexpr int kSB = BK / 8;           // 8-key blocks of S (k-steps of P V)
  constexpr int kChunks = D / F::kNO;   // P V instructions a k-step
  extern __shared__ unsigned char fwd_raw[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<unsigned long long>(fwd_raw) + 1023) & ~1023ull);
  unsigned char* kb = sm;                   // K big   [BK rows][D], K-major
  unsigned char* ks = kb + F::kSplit;       // K small
  unsigned char* vb = ks + F::kSplit;       // V^T big [D rows][BK keys, permuted]
  unsigned char* vs = vb + F::kSplit;       // V^T small
  float* kraw = reinterpret_cast<float*>(vs + F::kSplit);   // [BK][kLdRaw]
  float* vraw = kraw + BK * F::kLdRaw;

  constexpr int kThreads = 128 * WG;
  const int tid = threadIdx.x, warp = tid / 32 % 4, lane = tid % 32;
  const int g = lane / 4, c = lane % 4;
  // blockIdx.y = 0 is the bottom tile, the longest under causal: it starts first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kFwdGroupQ * WG;
  const int qg = q0 + tid / 128 * kFwdGroupQ;  // this warpgroup's first row
  const long long qbase = static_cast<long long>(blockIdx.x) * t_len * D;
  const long long kbase = static_cast<long long>(blockIdx.x) * tk_len * D;
  const int row0 = qg + warp * 16 + g, row1 = row0 + 8;  // this thread's rows
  const int k_end = causal ? min(q0 + kFwdGroupQ * WG, tk_len) : tk_len;
  const int ntiles = (k_end + BK - 1) / BK;

  auto load_raw = [&](int tile) {
    const int k0 = tile * BK;
    for (int idx = tid; idx < BK * D / 4; idx += kThreads) {
      const int r = idx / (D / 4), col = (idx % (D / 4)) * 4;
      const bool ok = k0 + r < tk_len;
      const long long at = kbase + static_cast<long long>(ok ? k0 + r : 0) * D + col;
      mxtpu::cp_async16(kraw + r * F::kLdRaw + col, k + at, ok);
      mxtpu::cp_async16(vraw + r * F::kLdRaw + col, v + at, ok);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  load_raw(0);

  // Q's fragments, split once: k-step kk holds (row g | g+8, dim 8kk + c | +4)
  unsigned qb[kKSteps][4], qsm[kKSteps][4];
#pragma unroll
  for (int kk = 0; kk < kKSteps; ++kk) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e & 1 ? row1 : row0;
      const int d = 8 * kk + c + (e & 2 ? 4 : 0);
      const float x = r < t_len ? q[qbase + static_cast<long long>(r) * D + d] : 0.f;
      split_tf32(x, qb[kk][e], qsm[kk][e]);
    }
  }

  float acc[kChunks][F::kNO / 2];
#pragma unroll
  for (int n = 0; n < kChunks; ++n)
#pragma unroll
    for (int i = 0; i < F::kNO / 2; ++i) acc[n][i] = 0.f;
  float m0 = mxtpu::kNegInf, m1 = mxtpu::kNegInf, l0 = 0.f, l1 = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();  // the raw tile has landed; the last tile's products are done
    // split K as it is and V transposed with its keys permuted, a 16-byte
    // unit a thread (for V: 4 keys of one dim, gathered from 4 raw rows)
    for (int idx = tid; idx < BK * D / 4; idx += kThreads) {
      const int key = idx / (D / 4), d4 = (idx % (D / 4)) * 4;
      const float4 x = *reinterpret_cast<const float4*>(kraw + key * F::kLdRaw + d4);
      uint4 big, small;
      split_tf32(x.x, big.x, small.x);
      split_tf32(x.y, big.y, small.y);
      split_tf32(x.z, big.z, small.z);
      split_tf32(x.w, big.w, small.w);
      const int at = swz(BK, key, d4);
      *reinterpret_cast<uint4*>(kb + at) = big;
      *reinterpret_cast<uint4*>(ks + at) = small;
    }
    for (int idx = tid; idx < BK * D / 4; idx += kThreads) {
      // positions 4u..4u+3 of a block of 8 hold its keys h, h+2, h+4, h+6
      const int d = idx % D, pos = (idx / D) * 4;
      const float* col = vraw + ((pos & ~7) + ((pos >> 2) & 1)) * F::kLdRaw + d;
      uint4 big, small;
      split_tf32(col[0], big.x, small.x);
      split_tf32(col[2 * F::kLdRaw], big.y, small.y);
      split_tf32(col[4 * F::kLdRaw], big.z, small.z);
      split_tf32(col[6 * F::kLdRaw], big.w, small.w);
      const int at = swz(D, d, pos);
      *reinterpret_cast<uint4*>(vb + at) = big;
      *reinterpret_cast<uint4*>(vs + at) = small;
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();  // the split tiles are visible to wgmma; the raw tile is free
    if (it + 1 < ntiles) load_raw(it + 1);
    const int k0 = it * BK;
    // under causal a warpgroup's rows may all lie above this tile: it only
    // helps split the tile (the condition is uniform in the warpgroup)
    if (causal && k0 > qg + kFwdGroupQ - 1) continue;

    // S = Q K^T for the block's 64 rows and the tile's BK keys
    float s[BK / 2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
      const int off = (kk / 4) * BK * 128 + (kk % 4) * 32;
      wgmma_3xtf32<BK>(s, qb[kk], qsm[kk], tile_desc(kb + off), tile_desc(ks + off));
    }
    wgmma_commit_wait();

    // scale, mask (only the tiles that cross the diagonal or the end of
    // the keys), and the online softmax over the tile
    const bool masked = k0 + BK > tk_len || (causal && k0 + BK - 1 > qg);
    float mx0 = mxtpu::kNegInf, mx1 = mxtpu::kNegInf;
#pragma unroll
    for (int j = 0; j < kSB; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float sc = s[4 * j + e] * scale;
        if (masked) {
          const int kj = k0 + 8 * j + 2 * c + (e & 1);
          const int qi = e < 2 ? row0 : row1;
          if ((causal && kj > qi) || kj >= tk_len) sc = mxtpu::kNegInf;
        }
        s[4 * j + e] = sc;
      }
      mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
    // the four threads of a row are the four lanes of a quad
    mx0 = fmaxf(mx0, __shfl_xor_sync(mxtpu::kFullMask, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(mxtpu::kFullMask, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(mxtpu::kFullMask, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(mxtpu::kFullMask, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float alpha0 = expf(m0 - mn0), alpha1 = expf(m1 - mn1);
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < kSB; ++j) {
      s[4 * j] = expf(s[4 * j] - mn0);
      s[4 * j + 1] = expf(s[4 * j + 1] - mn0);
      s[4 * j + 2] = expf(s[4 * j + 2] - mn1);
      s[4 * j + 3] = expf(s[4 * j + 3] - mn1);
      sum0 += s[4 * j] + s[4 * j + 1];
      sum1 += s[4 * j + 2] + s[4 * j + 3];
    }
    l0 = l0 * alpha0 + sum0;
    l1 = l1 * alpha1 + sum1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int n = 0; n < kChunks; ++n)
#pragma unroll
      for (int i = 0; i < F::kNO / 8; ++i) {
        acc[n][4 * i] *= alpha0;
        acc[n][4 * i + 1] *= alpha0;
        acc[n][4 * i + 2] *= alpha1;
        acc[n][4 * i + 3] *= alpha1;
      }

    // O += P V: key block j of S is the A fragment of k-step j (split
    // before the fence: wgmma reads registers written before it)
    unsigned pb[kSB][4], ps[kSB][4];
#pragma unroll
    for (int j = 0; j < kSB; ++j) {
      split_tf32(s[4 * j], pb[j][0], ps[j][0]);
      split_tf32(s[4 * j + 2], pb[j][1], ps[j][1]);
      split_tf32(s[4 * j + 1], pb[j][2], ps[j][2]);
      split_tf32(s[4 * j + 3], pb[j][3], ps[j][3]);
    }
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kSB; ++j)
#pragma unroll
      for (int n = 0; n < kChunks; ++n) {
        const int off = (j / 4) * D * 128 + n * F::kNO * 128 + (j % 4) * 32;
        wgmma_3xtf32<F::kNO>(acc[n], pb[j], ps[j], tile_desc(vb + off),
                             tile_desc(vs + off));
      }
    wgmma_commit_wait();
  }

  l0 += __shfl_xor_sync(mxtpu::kFullMask, l0, 1);
  l0 += __shfl_xor_sync(mxtpu::kFullMask, l0, 2);
  l1 += __shfl_xor_sync(mxtpu::kFullMask, l1, 1);
  l1 += __shfl_xor_sync(mxtpu::kFullMask, l1, 2);
#pragma unroll
  for (int n = 0; n < kChunks; ++n)
#pragma unroll
    for (int i = 0; i < F::kNO / 8; ++i) {
      const int col = n * F::kNO + 8 * i + 2 * c;
      if (row0 < t_len)
        *reinterpret_cast<float2*>(o + qbase + static_cast<long long>(row0) * D + col) =
            make_float2(acc[n][4 * i] / l0, acc[n][4 * i + 1] / l0);
      if (row1 < t_len)
        *reinterpret_cast<float2*>(o + qbase + static_cast<long long>(row1) * D + col) =
            make_float2(acc[n][4 * i + 2] / l1, acc[n][4 * i + 3] / l1);
    }
  // natural log of the row's softmax denominator over the scaled scores;
  // the backward recomputes p = exp(s * scale - lse) from it
  if (lse != nullptr && c == 0) {
    const long long rbase = static_cast<long long>(blockIdx.x) * t_len;
    if (row0 < t_len) lse[rbase + row0] = m0 + logf(l0);
    if (row1 < t_len) lse[rbase + row1] = m1 + logf(l1);
  }
}

// The earlier forward, on CUDA cores (fmaf, 4 threads a row, 32 x 32
// tiles), kept behind its own entry point, mxtpu_flash_fwd_simt, so that a
// run on the card can time it beside flash_fwd_kernel; no path of the
// package calls it.

constexpr int kFlashThreads = 128;
constexpr int kFlashRowThreads = 4;                          // threads per query row
constexpr int kFlashBlockQ = kFlashThreads / kFlashRowThreads;  // 32 rows
constexpr int kFlashBlockK = 32;

template <int D>
__global__ void __launch_bounds__(kFlashThreads)
flash_fwd_simt_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ o,
                      float* __restrict__ lse, int t_len, int tk_len, int causal,
                      float scale) {
  constexpr int kDpt = D / kFlashRowThreads;  // dims per thread
  __shared__ __align__(16) float ks[kFlashBlockK][D];
  __shared__ __align__(16) float vs[kFlashBlockK][D];

  const int tid = threadIdx.x;
  const int row = tid / kFlashRowThreads;
  const int part = tid % kFlashRowThreads;
  const int q0 = blockIdx.x * kFlashBlockQ;
  const int qi = q0 + row;
  const long long base = static_cast<long long>(blockIdx.y) * t_len * D;
  const long long kbase = static_cast<long long>(blockIdx.y) * tk_len * D;

  float qr[kDpt], acc[kDpt];
#pragma unroll
  for (int i = 0; i < kDpt; ++i) {
    qr[i] = qi < t_len ? q[base + static_cast<long long>(qi) * D + part + kFlashRowThreads * i]
                       : 0.f;
    acc[i] = 0.f;
  }
  float m = mxtpu::kNegInf;
  float l = 0.f;

  // causal: keys past the tile's last row never matter
  const int k_end = causal ? min(q0 + kFlashBlockQ, tk_len) : tk_len;
  for (int k0 = 0; k0 < k_end; k0 += kFlashBlockK) {
    __syncthreads();  // the previous tile is consumed
    for (int idx = tid; idx < kFlashBlockK * D / 4; idx += kFlashThreads) {
      const int r = idx / (D / 4);
      const int c4 = idx % (D / 4);
      const int kr = k0 + r;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 vv = kv;
      if (kr < tk_len) {
        kv = reinterpret_cast<const float4*>(k + kbase + static_cast<long long>(kr) * D)[c4];
        vv = reinterpret_cast<const float4*>(v + kbase + static_cast<long long>(kr) * D)[c4];
      }
      reinterpret_cast<float4*>(&ks[r][0])[c4] = kv;
      reinterpret_cast<float4*>(&vs[r][0])[c4] = vv;
    }
    __syncthreads();

    float s[kFlashBlockK];
    float tile_max = mxtpu::kNegInf;
#pragma unroll
    for (int j = 0; j < kFlashBlockK; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < kDpt; ++i) dot += qr[i] * ks[j][part + kFlashRowThreads * i];
      // the four threads of a row are neighbouring lanes of one warp
      dot += __shfl_xor_sync(mxtpu::kFullMask, dot, 1);
      dot += __shfl_xor_sync(mxtpu::kFullMask, dot, 2);
      float sc = dot * scale;
      const int kj = k0 + j;
      if ((causal && kj > qi) || kj >= tk_len) sc = mxtpu::kNegInf;
      s[j] = sc;
      tile_max = fmaxf(tile_max, sc);
    }
    const float m_new = fmaxf(m, tile_max);
    const float alpha = expf(m - m_new);
    float tile_sum = 0.f;
#pragma unroll
    for (int j = 0; j < kFlashBlockK; ++j) {
      s[j] = expf(s[j] - m_new);
      tile_sum += s[j];
    }
    l = l * alpha + tile_sum;
#pragma unroll
    for (int i = 0; i < kDpt; ++i) acc[i] *= alpha;
#pragma unroll
    for (int j = 0; j < kFlashBlockK; ++j) {
#pragma unroll
      for (int i = 0; i < kDpt; ++i) acc[i] += s[j] * vs[j][part + kFlashRowThreads * i];
    }
    m = m_new;
  }
  if (qi < t_len) {
#pragma unroll
    for (int i = 0; i < kDpt; ++i)
      o[base + static_cast<long long>(qi) * D + part + kFlashRowThreads * i] = acc[i] / l;
    // natural log of the row's softmax denominator over the scaled scores;
    // the backward recomputes p = exp(s * scale - lse) from it
    if (lse != nullptr && part == 0)
      lse[static_cast<long long>(blockIdx.y) * t_len + qi] = m + logf(l);
  }
}

// --------------------------------------------------------------- backward
//
// Both passes recompute p = exp(s * scale - lse) from the forward's lse and
// ds = p * (dp - delta) * scale with dp = do . v and delta = rowsum(do * o)
// (computed before the launch, as the JAX wrapper does).  Every product runs
// on the tensor cores in 3xTF32, as the forward's do, and each pass writes
// only its own rows: no atomics, and the gradients are the same bits run to
// run.  One block per (b*h, 128 resident rows), two warpgroups of 64 rows
// (blocks of one warpgroup took about 1.6x as long on an H100, also on
// grids of fewer than two 128-row blocks an SM).
// The resident rows of two operands are A of the first two products, split
// once into TF32 big and small parts: one operand's fragments stay in
// registers, the other's tiles in shared memory, where wgmma reads them
// (registers cannot hold both beside the accumulators, and A from registers
// spares shared memory's bandwidth, which products of N = kBS from two
// shared tiles exceed).  The streamed tiles (kBS rows) land by cp.async
// while the previous tile is multiplied and are split once per block.
// wgmma takes tf32 operands only K-major, so an operand that a pass
// contracts over both of its axes is stored twice: as it is and transposed,
// the transposed copy's rows permuted within each block of 8 (split_cols) so
// that an accumulator serves as the next product's A fragment with no
// shuffle.  The two passes compute s and dp with other sums than the
// forward, so p agrees with the forward's softmax to about 1e-6 of its
// value, not bit for bit.
//
// At D = 128 the dK/dV pass's K fragments and its dK and dV accumulators
// alone would take 256 registers a thread; both passes stay on the earlier
// CUDA-core kernels there (flash_bwd_*_simt_kernel below), which the Python
// wrapper picks by shape and counts under their own names.

__device__ __forceinline__ void split4(const float4& x, uint4& big, uint4& small) {
  split_tf32(x.x, big.x, small.x);
  split_tf32(x.y, big.y, small.y);
  split_tf32(x.z, big.z, small.z);
  split_tf32(x.w, big.w, small.w);
}

// A cp.async landing tile raw [ROWS][D + 4] split into TF32 big and small
// K-major tiles as it is (row r, k = dim), a 16-byte unit a thread.
template <int D, int ROWS>
__device__ __forceinline__ void split_rows(const float* raw, unsigned char* big,
                                           unsigned char* small, int tid, int nthreads) {
  for (int idx = tid; idx < ROWS * D / 4; idx += nthreads) {
    const int r = idx / (D / 4), d4 = (idx % (D / 4)) * 4;
    uint4 b, sm;
    split4(*reinterpret_cast<const float4*>(raw + r * (D + 4) + d4), b, sm);
    const int at = swz(ROWS, r, d4);
    *reinterpret_cast<uint4*>(big + at) = b;
    *reinterpret_cast<uint4*>(small + at) = sm;
  }
}

// The same tile transposed (row = dim, k = raw row) with the raw rows
// permuted within each block of 8: positions 4u..4u+3 hold rows u, u+2, u+4,
// u+6, so row 2c sits at k = c and row 2c+1 at k = c+4.  An m64nN
// accumulator holds, in column block j, (row g, columns 8j+2c, 8j+2c+1) and
// (row g+8, the same), with g = lane / 4, c = lane % 4, and the tf32 A
// fragment wants (row g | g+8, k c | c+4): against this tile the
// accumulator is the A fragment register for register.  A thread gathers 4
// raw rows of one dim into a 16-byte unit.
template <int D, int ROWS>
__device__ __forceinline__ void split_cols(const float* raw, unsigned char* big,
                                           unsigned char* small, int tid, int nthreads) {
  constexpr int kLd = D + 4;
  for (int idx = tid; idx < ROWS * D / 4; idx += nthreads) {
    const int d = idx % D, pos = (idx / D) * 4;
    const float* col = raw + ((pos & ~7) + ((pos >> 2) & 1)) * kLd + d;
    uint4 b, sm;
    split4(make_float4(col[0], col[2 * kLd], col[4 * kLd], col[6 * kLd]), b, sm);
    const int at = swz(D, d, pos);
    *reinterpret_cast<uint4*>(big + at) = b;
    *reinterpret_cast<uint4*>(small + at) = sm;
  }
}

// The tf32 A fragments of this thread's rows of a [len][D] matrix, split
// once: k-step kk holds (row0 | row1, dim 8kk + c | 8kk + c + 4); rows at or
// past len read as 0.
template <int D>
__device__ __forceinline__ void load_a_frags(const float* __restrict__ src, int row0, int row1,
                                             int len, int c, unsigned (&big)[D / 8][4],
                                             unsigned (&small)[D / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e & 1 ? row1 : row0;
      const int d = 8 * kk + c + (e & 2 ? 4 : 0);
      const float x = r < len ? src[static_cast<long long>(r) * D + d] : 0.f;
      split_tf32(x, big[kk][e], small[kk][e]);
    }
}

// Tiles of a pass streaming BS rows: 2048 / D in the dK/dV pass (64 at
// D = 32, 32 at D = 64; its registers hold K's fragments and the dK and dV
// accumulators beside BS / 2 columns of S^T and dP^T), 64 in the dQ pass.
template <int D, int BS>
struct Bwd {
  static constexpr int kBS = BS;
  static constexpr int kLdRaw = D + 4;           // padded rows of the cp.async landing
  static constexpr int kRes = 64 * D * 4;        // one resident big or small tile
  static constexpr int kStr = BS * D * 4;        // one streamed big or small tile
  static constexpr int kRaw = BS * kLdRaw * 4;   // one landing tile
  // V (2 tiles a warpgroup) + Q, dO as they are and transposed + landing + lse, delta
  static constexpr int kDkdvBytes = 1024 + 4 * kRes + 8 * kStr + 2 * kRaw + 2 * BS * 4;
  // dO (2 tiles a warpgroup) + K, V as they are + K transposed + landing
  static constexpr int kDqBytes = 1024 + 4 * kRes + 6 * kStr + 2 * kRaw;
};
template <int D>
using BwdKV = Bwd<D, 2048 / D>;
template <int D>
using BwdQ = Bwd<D, 64>;

constexpr int kBwdTcThreads = 256;  // two warpgroups of 64 resident rows

// Rows [r0, r0 + 128) of a [len][D] matrix (rows at or past len read as 0)
// split into each warpgroup's 64-row K-major tiles: big at dst + wg *
// stride, small at big + 64 * D * 4.
template <int D>
__device__ __forceinline__ void split_resident(const float* __restrict__ src, int r0, int len,
                                               unsigned char* dst, int stride, int tid) {
  for (int idx = tid; idx < 128 * D / 4; idx += kBwdTcThreads) {
    const int r = idx / (D / 4), d4 = (idx % (D / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < len)
      x = *reinterpret_cast<const float4*>(src + static_cast<long long>(r0 + r) * D + d4);
    uint4 big, small;
    split4(x, big, small);
    unsigned char* t = dst + (r / 64) * stride;
    const int at = swz(64, r % 64, d4);
    *reinterpret_cast<uint4*>(t + at) = big;
    *reinterpret_cast<uint4*>(t + 64 * D * 4 + at) = small;
  }
}

// An m64nN accumulator split into tf32 A fragments, its column block j
// being k-step j (as the forward turns S into P's fragments).
template <int N>
__device__ __forceinline__ void split_acc(const float* x, unsigned (&big)[N / 8][4],
                                          unsigned (&small)[N / 8][4]) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    split_tf32(x[4 * j], big[j][0], small[j][0]);
    split_tf32(x[4 * j + 2], big[j][1], small[j][1]);
    split_tf32(x[4 * j + 1], big[j][2], small[j][2]);
    split_tf32(x[4 * j + 3], big[j][3], small[j][3]);
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = 0.f;
}

// total += part, in fp32 (round to nearest).  A gradient sums over every
// streamed tile; each tile's products go to a fresh accumulator that is
// then added here.  Chained through one wgmma accumulator over the whole
// stream, the error grew with the number of tiles, as sums that are not
// rounded to nearest do; a fresh accumulator takes a few k-steps' sums.
template <int N>
__device__ __forceinline__ void add_tile(float (&total)[N], const float (&part)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) total[i] += part[i];
}

// Warpgroup 1 issues a tile's first products only after warpgroup 0 has
// issued its own: the tensor cores then run the two groups one after the
// other, and each warpgroup's elementwise work overlaps the other's
// products.  `mine` and `ones` say whether this warpgroup and warpgroup 1
// multiply the tile (uniform in the block).
__device__ __forceinline__ void wait_turn(int wg, bool mine) {
  if (wg == 1 && mine) asm volatile("bar.sync 1, 256;\n" ::: "memory");
}
__device__ __forceinline__ void pass_turn(int wg, bool ones) {
  if (wg == 0 && ones) asm volatile("bar.arrive 1, 256;\n" ::: "memory");
}

// dK and dV of 128 keys (a warpgroup per 64).  Replaces
// _flash_bwd_dkdv_kernel.  K and V are resident (A of S^T = K Q^T, from
// registers, and dP^T = V dO^T, from shared memory); Q and dO stream past in
// tiles of kBS queries, each split as it is (B of those two products) and
// transposed with its queries permuted (B of dV += P^T dO and dK += dS^T Q,
// whose A are P^T and dS^T straight from the accumulators).  The
// accumulators' columns are queries, so lse and delta are staged per tile in
// shared memory and read by column.  Under causal the stream starts at the
// block's diagonal, a warpgroup skips
// the tiles that lie wholly above its keys and masks only those that cross
// them; pad query rows get lse = +inf, so their p is exactly 0.
template <int D>
__global__ void __launch_bounds__(kBwdTcThreads, 1)
flash_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      float* __restrict__ dk, float* __restrict__ dv, int t_len, int tk_len,
                      int causal, float scale) {
  using B = BwdKV<D>;
  constexpr int BS = B::kBS;
  constexpr int kSB = BS / 8;  // 8-query blocks of S^T: the k-steps of dV and dK
  extern __shared__ unsigned char bwd_raw[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<unsigned long long>(bwd_raw) + 1023) & ~1023ull);
  unsigned char* res = sm;                           // per warpgroup: V big, small [64][D]
  unsigned char* qrow = res + 4 * B::kRes;           // Q big, small [BS][D]
  unsigned char* drow = qrow + 2 * B::kStr;          // dO big, small
  unsigned char* qcol = drow + 2 * B::kStr;          // Q^T big, small [D][BS, permuted]
  unsigned char* dcol = qcol + 2 * B::kStr;          // dO^T big, small
  float* qraw = reinterpret_cast<float*>(dcol + 2 * B::kStr);  // [BS][kLdRaw]
  float* draw = qraw + BS * B::kLdRaw;
  float* lse_s = draw + BS * B::kLdRaw;
  float* del_s = lse_s + BS;

  const int tid = threadIdx.x, warp = tid / 32 % 4, lane = tid % 32;
  // the warpgroup, broadcast from lane 0 so that the compiler sees it uniform
  // in the warp: branches on it around wgmma then do not serialize them
  const int wg = __shfl_sync(mxtpu::kFullMask, tid / 128, 0);
  const int g = lane / 4, c = lane % 4;
  // blockIdx.y = 0 holds the first keys, the longest under causal: it starts first
  const int k0 = blockIdx.y * 128;
  const int kw = k0 + wg * 64;                        // this warpgroup's first key
  const int key0 = kw + warp * 16 + g, key1 = key0 + 8;  // this thread's rows
  const long long qbase = static_cast<long long>(blockIdx.x) * t_len * D;
  const long long kbase = static_cast<long long>(blockIdx.x) * tk_len * D;
  const long long rbase = static_cast<long long>(blockIdx.x) * t_len;
  // causal: queries above the block's first key see none of its keys
  const int q_begin = causal ? k0 : 0;
  const int ntiles = q_begin < t_len ? (t_len - q_begin + BS - 1) / BS : 0;

  auto load_raw = [&](int tile) {
    const int q0 = q_begin + tile * BS;
    for (int idx = tid; idx < BS * D / 4; idx += kBwdTcThreads) {
      const int r = idx / (D / 4), col = (idx % (D / 4)) * 4;
      const bool ok = q0 + r < t_len;
      const long long at = qbase + static_cast<long long>(ok ? q0 + r : 0) * D + col;
      mxtpu::cp_async16(qraw + r * B::kLdRaw + col, q + at, ok);
      mxtpu::cp_async16(draw + r * B::kLdRaw + col, dout + at, ok);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  if (ntiles > 0) load_raw(0);
  split_resident<D>(v + kbase, k0, tk_len, res, 2 * B::kRes, tid);
  const unsigned char* vb = res + wg * 2 * B::kRes;
  unsigned kfb[D / 8][4], kfs[D / 8][4];  // K's A fragments, split once
  load_a_frags<D>(k + kbase, key0, key1, tk_len, c, kfb, kfs);

  float dka[D / 2], dva[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();  // the raw tile has landed; the last tile's products are done
    split_rows<D, BS>(qraw, qrow, qrow + B::kStr, tid, kBwdTcThreads);
    split_rows<D, BS>(draw, drow, drow + B::kStr, tid, kBwdTcThreads);
    split_cols<D, BS>(qraw, qcol, qcol + B::kStr, tid, kBwdTcThreads);
    split_cols<D, BS>(draw, dcol, dcol + B::kStr, tid, kBwdTcThreads);
    const int q0 = q_begin + it * BS;
    for (int i = tid; i < BS; i += kBwdTcThreads) {
      const bool ok = q0 + i < t_len;
      lse_s[i] = ok ? lse[rbase + q0 + i] : __int_as_float(0x7f800000);  // +inf
      del_s[i] = ok ? delta[rbase + q0 + i] : 0.f;
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();  // the split tiles are visible to wgmma; the raw tile is free
    if (it + 1 < ntiles) load_raw(it + 1);
    // a warpgroup skips a tile whose queries all lie above its keys (all
    // p = 0; the condition is uniform in the warpgroup)
    const bool mine = !(causal && q0 + BS - 1 < kw);
    const bool ones = !(causal && q0 + BS - 1 < k0 + 64);

    // S^T = K Q^T and dP^T = V dO^T: [64 keys x BS queries]
    float s[BS / 2], dp[BS / 2];
#pragma unroll
    for (int i = 0; i < BS / 2; ++i) s[i] = dp[i] = 0.f;
    wait_turn(wg, mine);
    if (mine) {
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) {
        const int oa = (kk / 4) * 64 * 128 + (kk % 4) * 32;
        const int ob = (kk / 4) * BS * 128 + (kk % 4) * 32;
        wgmma_3xtf32<BS>(s, kfb[kk], kfs[kk], tile_desc(qrow + ob),
                         tile_desc(qrow + B::kStr + ob));
        wgmma_3xtf32_ss<BS>(dp, tile_desc(vb + oa), tile_desc(vb + B::kRes + oa),
                            tile_desc(drow + ob), tile_desc(drow + B::kStr + ob));
      }
      wgmma_commit();
    }
    pass_turn(wg, ones);
    if (!mine) continue;
    wgmma_wait();

    // P^T and dS^T; (row g | g+8, query column 8j + 2c | +1) in block j
    const bool masked = causal && q0 < kw + 63;
#pragma unroll
    for (int j = 0; j < kSB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + 2 * c + (e & 1);
        float p = expf(s[4 * j + e] * scale - lse_s[col]);
        if (masked && (e < 2 ? key0 : key1) > q0 + col) p = 0.f;
        dp[4 * j + e] = p * (dp[4 * j + e] - del_s[col]) * scale;
        s[4 * j + e] = p;
      }

    // dV += P^T dO, then dK += dS^T Q, query block j being k-step j, each
    // through a fresh accumulator (add_tile); one after the other, so that
    // P^T's and dS^T's split fragments are not held at once
    unsigned pb[kSB][4], ps[kSB][4];
    split_acc<BS>(s, pb, ps);
    float part[D / 2];
    zero<D / 2>(part);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kSB; ++j) {
      const int off = (j / 4) * D * 128 + (j % 4) * 32;
      wgmma_3xtf32<D>(part, pb[j], ps[j], tile_desc(dcol + off), tile_desc(dcol + B::kStr + off));
    }
    wgmma_commit_wait();
    add_tile<D / 2>(dva, part);
    unsigned db[kSB][4], ds[kSB][4];
    split_acc<BS>(dp, db, ds);
    zero<D / 2>(part);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kSB; ++j) {
      const int off = (j / 4) * D * 128 + (j % 4) * 32;
      wgmma_3xtf32<D>(part, db[j], ds[j], tile_desc(qcol + off), tile_desc(qcol + B::kStr + off));
    }
    wgmma_commit_wait();
    add_tile<D / 2>(dka, part);
  }

#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    const int col = 8 * i + 2 * c;
    if (key0 < tk_len) {
      const long long at = kbase + static_cast<long long>(key0) * D + col;
      *reinterpret_cast<float2*>(dk + at) = make_float2(dka[4 * i], dka[4 * i + 1]);
      *reinterpret_cast<float2*>(dv + at) = make_float2(dva[4 * i], dva[4 * i + 1]);
    }
    if (key1 < tk_len) {
      const long long at = kbase + static_cast<long long>(key1) * D + col;
      *reinterpret_cast<float2*>(dk + at) = make_float2(dka[4 * i + 2], dka[4 * i + 3]);
      *reinterpret_cast<float2*>(dv + at) = make_float2(dva[4 * i + 2], dva[4 * i + 3]);
    }
  }
}

// dQ of 128 queries (a warpgroup per 64).  Replaces _flash_bwd_dq_kernel.
// The forward's shape with one more product: Q and dO are resident (A of
// S = Q K^T, from registers, and dP = dO V^T, from shared memory); K and V
// stream past in tiles of kBS keys, K
// split as it is and transposed with its keys permuted (B of dQ += dS K,
// whose A is dS straight from the accumulators), V as it is.  Under causal
// the stream stops at the block's diagonal, a warpgroup skips the tiles
// wholly past its rows and masks only those that cross them; pad keys get
// p = 0.
template <int D>
__global__ void __launch_bounds__(kBwdTcThreads, 1)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    float* __restrict__ dq, int t_len, int tk_len, int causal, float scale) {
  using B = BwdQ<D>;
  constexpr int BS = B::kBS;
  constexpr int kSB = BS / 8;  // 8-key blocks of S: the k-steps of dQ
  extern __shared__ unsigned char bwd_raw[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<unsigned long long>(bwd_raw) + 1023) & ~1023ull);
  unsigned char* res = sm;                        // per warpgroup: dO big, small [64][D]
  unsigned char* krow = res + 4 * B::kRes;        // K big, small [BS][D]
  unsigned char* vrow = krow + 2 * B::kStr;       // V big, small
  unsigned char* kcol = vrow + 2 * B::kStr;       // K^T big, small [D][BS, permuted]
  float* kraw = reinterpret_cast<float*>(kcol + 2 * B::kStr);  // [BS][kLdRaw]
  float* vraw = kraw + BS * B::kLdRaw;

  const int tid = threadIdx.x, warp = tid / 32 % 4, lane = tid % 32;
  // the warpgroup, broadcast from lane 0 so that the compiler sees it uniform
  // in the warp: branches on it around wgmma then do not serialize them
  const int wg = __shfl_sync(mxtpu::kFullMask, tid / 128, 0);
  const int g = lane / 4, c = lane % 4;
  // blockIdx.y = 0 is the bottom tile, the longest under causal: it starts first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * 128;
  const int qg = q0 + wg * 64;                            // this warpgroup's first row
  const int row0 = qg + warp * 16 + g, row1 = row0 + 8;  // this thread's rows
  const long long qbase = static_cast<long long>(blockIdx.x) * t_len * D;
  const long long kbase = static_cast<long long>(blockIdx.x) * tk_len * D;
  const long long rbase = static_cast<long long>(blockIdx.x) * t_len;
  const float inf = __int_as_float(0x7f800000);
  const float lse0 = row0 < t_len ? lse[rbase + row0] : inf;
  const float lse1 = row1 < t_len ? lse[rbase + row1] : inf;
  const float del0 = row0 < t_len ? delta[rbase + row0] : 0.f;
  const float del1 = row1 < t_len ? delta[rbase + row1] : 0.f;
  const int k_end = causal ? min(q0 + 128, tk_len) : tk_len;
  const int ntiles = (k_end + BS - 1) / BS;

  auto load_raw = [&](int tile) {
    const int k0 = tile * BS;
    for (int idx = tid; idx < BS * D / 4; idx += kBwdTcThreads) {
      const int r = idx / (D / 4), col = (idx % (D / 4)) * 4;
      const bool ok = k0 + r < tk_len;
      const long long at = kbase + static_cast<long long>(ok ? k0 + r : 0) * D + col;
      mxtpu::cp_async16(kraw + r * B::kLdRaw + col, k + at, ok);
      mxtpu::cp_async16(vraw + r * B::kLdRaw + col, v + at, ok);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  load_raw(0);
  split_resident<D>(dout + qbase, q0, t_len, res, 2 * B::kRes, tid);
  const unsigned char* dob = res + wg * 2 * B::kRes;
  unsigned qfb[D / 8][4], qfs[D / 8][4];  // Q's A fragments, split once
  load_a_frags<D>(q + qbase, row0, row1, t_len, c, qfb, qfs);

  float dqa[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dqa[i] = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();  // the raw tile has landed; the last tile's products are done
    split_rows<D, BS>(kraw, krow, krow + B::kStr, tid, kBwdTcThreads);
    split_rows<D, BS>(vraw, vrow, vrow + B::kStr, tid, kBwdTcThreads);
    split_cols<D, BS>(kraw, kcol, kcol + B::kStr, tid, kBwdTcThreads);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();  // the split tiles are visible to wgmma; the raw tile is free
    if (it + 1 < ntiles) load_raw(it + 1);
    const int k0 = it * BS;
    // under causal a warpgroup's rows may all lie above this tile: it skips
    // it (the condition is uniform in the warpgroup)
    const bool mine = !(causal && k0 > qg + 63);
    const bool ones = !(causal && k0 > q0 + 127);

    // S = Q K^T and dP = dO V^T: [64 queries x BS keys]
    float s[BS / 2], dp[BS / 2];
#pragma unroll
    for (int i = 0; i < BS / 2; ++i) s[i] = dp[i] = 0.f;
    wait_turn(wg, mine);
    if (mine) {
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) {
        const int oa = (kk / 4) * 64 * 128 + (kk % 4) * 32;
        const int ob = (kk / 4) * BS * 128 + (kk % 4) * 32;
        wgmma_3xtf32<BS>(s, qfb[kk], qfs[kk], tile_desc(krow + ob),
                         tile_desc(krow + B::kStr + ob));
        wgmma_3xtf32_ss<BS>(dp, tile_desc(dob + oa), tile_desc(dob + B::kRes + oa),
                            tile_desc(vrow + ob), tile_desc(vrow + B::kStr + ob));
      }
      wgmma_commit();
    }
    pass_turn(wg, ones);
    if (!mine) continue;
    wgmma_wait();

    // dS; (row g | g+8, key 8j + 2c | +1) in block j
    const bool masked = k0 + BS > tk_len || (causal && k0 + BS - 1 > qg);
#pragma unroll
    for (int j = 0; j < kSB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kj = k0 + 8 * j + 2 * c + (e & 1);
        const int qi = e < 2 ? row0 : row1;
        float p = expf(s[4 * j + e] * scale - (e < 2 ? lse0 : lse1));
        if (masked && ((causal && kj > qi) || kj >= tk_len)) p = 0.f;
        dp[4 * j + e] = p * (dp[4 * j + e] - (e < 2 ? del0 : del1)) * scale;
      }
    unsigned db[kSB][4], ds[kSB][4];
    split_acc<BS>(dp, db, ds);

    // dQ += dS K, key block j being k-step j, through a fresh accumulator
    // (add_tile)
    float part[D / 2];
    zero<D / 2>(part);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kSB; ++j) {
      const int off = (j / 4) * D * 128 + (j % 4) * 32;
      wgmma_3xtf32<D>(part, db[j], ds[j], tile_desc(kcol + off), tile_desc(kcol + B::kStr + off));
    }
    wgmma_commit_wait();
    add_tile<D / 2>(dqa, part);
  }

#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    const int col = 8 * i + 2 * c;
    if (row0 < t_len)
      *reinterpret_cast<float2*>(dq + qbase + static_cast<long long>(row0) * D + col) =
          make_float2(dqa[4 * i], dqa[4 * i + 1]);
    if (row1 < t_len)
      *reinterpret_cast<float2*>(dq + qbase + static_cast<long long>(row1) * D + col) =
          make_float2(dqa[4 * i + 2], dqa[4 * i + 3]);
  }
}

// The earlier backward, on CUDA cores: four threads per row of a 32-row
// resident tile, each holding a quarter of its vectors, interleaved (dim =
// part + 4 * i); the streamed tiles sit in shared memory and every thread
// of a warp reads the same row of them (a broadcast); every dot product is
// an fmaf loop.  It serves D = 128 (see above) and, at D = 64, a run on the
// card that times it beside the tensor-core kernels.

constexpr int kBwdThreads = 128;
constexpr int kBwdRowThreads = 4;
constexpr int kBwdTile = kBwdThreads / kBwdRowThreads;  // 32 rows

// The two dot products of one (query, key) pair over the four threads of a
// row: s = q . k (unscaled) and dp = do . v.
template <int kDpt>
__device__ __forceinline__ void bwd_dots(const float* a_row, const float* b_row,
                                         const float* a_reg, const float* b_reg, int part,
                                         float& s, float& dp) {
  s = 0.f;
  dp = 0.f;
#pragma unroll
  for (int i = 0; i < kDpt; ++i) {
    s += a_reg[i] * a_row[part + kBwdRowThreads * i];
    dp += b_reg[i] * b_row[part + kBwdRowThreads * i];
  }
  s += __shfl_xor_sync(mxtpu::kFullMask, s, 1);
  s += __shfl_xor_sync(mxtpu::kFullMask, s, 2);
  dp += __shfl_xor_sync(mxtpu::kFullMask, dp, 1);
  dp += __shfl_xor_sync(mxtpu::kFullMask, dp, 2);
}

// dK and dV of one tile of 32 keys: K, V and the two accumulators stay in
// registers while 32-row tiles of q, do, lse and delta stream through shared
// memory.  Under causal the stream starts at the tile's diagonal.  Pad query
// rows get lse = +inf, so their p is exactly 0.
template <int D>
__global__ void __launch_bounds__(kBwdThreads)
flash_bwd_dkdv_simt_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      float* __restrict__ dk, float* __restrict__ dv, int t_len, int tk_len,
                      int causal, float scale) {
  constexpr int kDpt = D / kBwdRowThreads;
  __shared__ __align__(16) float qs[kBwdTile][D];
  __shared__ __align__(16) float dos[kBwdTile][D];
  __shared__ float lses[kBwdTile];
  __shared__ float dels[kBwdTile];

  const int tid = threadIdx.x;
  const int row = tid / kBwdRowThreads;
  const int part = tid % kBwdRowThreads;
  const int k0 = blockIdx.x * kBwdTile;
  const int kj = k0 + row;
  const long long qbase = static_cast<long long>(blockIdx.y) * t_len * D;
  const long long kbase = static_cast<long long>(blockIdx.y) * tk_len * D;
  const long long rbase = static_cast<long long>(blockIdx.y) * t_len;

  float kr[kDpt], vr[kDpt], dkr[kDpt], dvr[kDpt];
#pragma unroll
  for (int i = 0; i < kDpt; ++i) {
    const long long at = kbase + static_cast<long long>(kj) * D + part + kBwdRowThreads * i;
    kr[i] = kj < tk_len ? k[at] : 0.f;
    vr[i] = kj < tk_len ? v[at] : 0.f;
    dkr[i] = 0.f;
    dvr[i] = 0.f;
  }

  // causal: queries above the tile's first key see none of its keys
  const int q_begin = causal ? k0 : 0;
  for (int q0 = q_begin; q0 < t_len; q0 += kBwdTile) {
    __syncthreads();  // the previous tile is consumed
    for (int idx = tid; idx < kBwdTile * D / 4; idx += kBwdThreads) {
      const int r = idx / (D / 4);
      const int c4 = idx % (D / 4);
      const int qi = q0 + r;
      float4 qv = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 dov = qv;
      if (qi < t_len) {
        qv = reinterpret_cast<const float4*>(q + qbase + static_cast<long long>(qi) * D)[c4];
        dov = reinterpret_cast<const float4*>(dout + qbase + static_cast<long long>(qi) * D)[c4];
      }
      reinterpret_cast<float4*>(&qs[r][0])[c4] = qv;
      reinterpret_cast<float4*>(&dos[r][0])[c4] = dov;
    }
    if (tid < kBwdTile) {
      const int qi = q0 + tid;
      lses[tid] = qi < t_len ? lse[rbase + qi] : __int_as_float(0x7f800000);  // +inf
      dels[tid] = qi < t_len ? delta[rbase + qi] : 0.f;
    }
    __syncthreads();

#pragma unroll 4
    for (int i = 0; i < kBwdTile; ++i) {
      float s, dp;
      bwd_dots<kDpt>(&qs[i][0], &dos[i][0], kr, vr, part, s, dp);
      float p = expf(s * scale - lses[i]);
      if (causal && kj > q0 + i) p = 0.f;
      const float ds = p * (dp - dels[i]) * scale;
#pragma unroll
      for (int c = 0; c < kDpt; ++c) {
        dvr[c] += p * dos[i][part + kBwdRowThreads * c];
        dkr[c] += ds * qs[i][part + kBwdRowThreads * c];
      }
    }
  }
  if (kj < tk_len) {
#pragma unroll
    for (int i = 0; i < kDpt; ++i) {
      const long long at = kbase + static_cast<long long>(kj) * D + part + kBwdRowThreads * i;
      dk[at] = dkr[i];
      dv[at] = dvr[i];
    }
  }
}

// dQ of one tile of 32 queries: q, do and the accumulator stay in registers
// while 32-key tiles of K and V stream through shared memory, up to the
// diagonal under causal.  Pad keys and masked pairs get p = 0.
template <int D>
__global__ void __launch_bounds__(kBwdThreads)
flash_bwd_dq_simt_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    float* __restrict__ dq, int t_len, int tk_len, int causal, float scale) {
  constexpr int kDpt = D / kBwdRowThreads;
  __shared__ __align__(16) float ks[kBwdTile][D];
  __shared__ __align__(16) float vs[kBwdTile][D];

  const int tid = threadIdx.x;
  const int row = tid / kBwdRowThreads;
  const int part = tid % kBwdRowThreads;
  const int q0 = blockIdx.x * kBwdTile;
  const int qi = q0 + row;
  const long long qbase = static_cast<long long>(blockIdx.y) * t_len * D;
  const long long kbase = static_cast<long long>(blockIdx.y) * tk_len * D;
  const long long rbase = static_cast<long long>(blockIdx.y) * t_len;

  float qr[kDpt], dor[kDpt], dqr[kDpt];
#pragma unroll
  for (int i = 0; i < kDpt; ++i) {
    const long long at = qbase + static_cast<long long>(qi) * D + part + kBwdRowThreads * i;
    qr[i] = qi < t_len ? q[at] : 0.f;
    dor[i] = qi < t_len ? dout[at] : 0.f;
    dqr[i] = 0.f;
  }
  const float lse_i = qi < t_len ? lse[rbase + qi] : __int_as_float(0x7f800000);
  const float del_i = qi < t_len ? delta[rbase + qi] : 0.f;

  const int k_end = causal ? min(q0 + kBwdTile, tk_len) : tk_len;
  for (int k0 = 0; k0 < k_end; k0 += kBwdTile) {
    __syncthreads();
    for (int idx = tid; idx < kBwdTile * D / 4; idx += kBwdThreads) {
      const int r = idx / (D / 4);
      const int c4 = idx % (D / 4);
      const int kr = k0 + r;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 vv = kv;
      if (kr < tk_len) {
        kv = reinterpret_cast<const float4*>(k + kbase + static_cast<long long>(kr) * D)[c4];
        vv = reinterpret_cast<const float4*>(v + kbase + static_cast<long long>(kr) * D)[c4];
      }
      reinterpret_cast<float4*>(&ks[r][0])[c4] = kv;
      reinterpret_cast<float4*>(&vs[r][0])[c4] = vv;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kBwdTile; ++j) {
      float s, dp;
      bwd_dots<kDpt>(&ks[j][0], &vs[j][0], qr, dor, part, s, dp);
      const int kj = k0 + j;
      float p = expf(s * scale - lse_i);
      if ((causal && kj > qi) || kj >= tk_len) p = 0.f;
      const float ds = p * (dp - del_i) * scale;
#pragma unroll
      for (int c = 0; c < kDpt; ++c) dqr[c] += ds * ks[j][part + kBwdRowThreads * c];
    }
  }
  if (qi < t_len) {
#pragma unroll
    for (int i = 0; i < kDpt; ++i)
      dq[qbase + static_cast<long long>(qi) * D + part + kBwdRowThreads * i] = dqr[i];
  }
}

template <int D>
cudaError_t launch_bwd(const float* q, const float* k, const float* v, const float* dout,
                       const float* lse, const float* delta, float* dq, float* dk, float* dv,
                       int bh, int t_len, int tk_len, int causal, float scale,
                       cudaStream_t stream) {
  if (dk != nullptr) {
    static bool attr = false;
    if (!attr) {
      const cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<D>,
                                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                   BwdKV<D>::kDkdvBytes);
      if (err != cudaSuccess) return err;
      attr = true;
    }
    dim3 grid(bh, (tk_len + 127) / 128);
    flash_bwd_dkdv_kernel<D><<<grid, kBwdTcThreads, BwdKV<D>::kDkdvBytes, stream>>>(
        q, k, v, dout, lse, delta, dk, dv, t_len, tk_len, causal, scale);
  } else {
    static bool attr = false;
    if (!attr) {
      const cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<D>,
                                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                   BwdQ<D>::kDqBytes);
      if (err != cudaSuccess) return err;
      attr = true;
    }
    dim3 grid(bh, (t_len + 127) / 128);
    flash_bwd_dq_kernel<D><<<grid, kBwdTcThreads, BwdQ<D>::kDqBytes, stream>>>(
        q, k, v, dout, lse, delta, dq, t_len, tk_len, causal, scale);
  }
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bwd_simt(const float* q, const float* k, const float* v, const float* dout,
                            const float* lse, const float* delta, float* dq, float* dk,
                            float* dv, int bh, int t_len, int tk_len, int causal, float scale,
                            cudaStream_t stream) {
  if (dk != nullptr) {
    dim3 grid((tk_len + kBwdTile - 1) / kBwdTile, bh);
    flash_bwd_dkdv_simt_kernel<D><<<grid, kBwdThreads, 0, stream>>>(
        q, k, v, dout, lse, delta, dk, dv, t_len, tk_len, causal, scale);
  } else {
    dim3 grid((t_len + kBwdTile - 1) / kBwdTile, bh);
    flash_bwd_dq_simt_kernel<D><<<grid, kBwdThreads, 0, stream>>>(
        q, k, v, dout, lse, delta, dq, t_len, tk_len, causal, scale);
  }
  return cudaGetLastError();
}

// The tensor-core pair is built for head_dim 32 and 64, the CUDA-core pair
// for 64 and 128 (ops/fused/attention_kernels.py bwd_kernels picks the pair).
template <bool kSimt>
int dispatch_bwd(const float* q, const float* k, const float* v, const float* dout,
                 const float* lse, const float* delta, float* dq, float* dk, float* dv,
                 int bsz, int heads, int t_len, int tk_len, int head_dim, int causal,
                 float scale, void* stream) {
  if (bsz <= 0 || heads <= 0 || t_len <= 0 || tk_len <= 0)
    return static_cast<int>(cudaGetLastError());
  const int bh = bsz * heads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if constexpr (kSimt) {
    if (head_dim == 64)
      err = launch_bwd_simt<64>(q, k, v, dout, lse, delta, dq, dk, dv, bh, t_len, tk_len, causal,
                                scale, s);
    else if (head_dim == 128)
      err = launch_bwd_simt<128>(q, k, v, dout, lse, delta, dq, dk, dv, bh, t_len, tk_len,
                                 causal, scale, s);
  } else {
    if (head_dim == 32)
      err = launch_bwd<32>(q, k, v, dout, lse, delta, dq, dk, dv, bh, t_len, tk_len, causal,
                           scale, s);
    else if (head_dim == 64)
      err = launch_bwd<64>(q, k, v, dout, lse, delta, dq, dk, dv, bh, t_len, tk_len, causal,
                           scale, s);
  }
  return static_cast<int>(err);
}

// ----------------------------------------------------------------- decode

constexpr int kDecodeThreads = 256;

template <int D>
__global__ void __launch_bounds__(kDecodeThreads)
paged_decode_kernel(const float* __restrict__ q, const float* __restrict__ k_step,
                    const float* __restrict__ v_step, const float* __restrict__ k_pages,
                    const float* __restrict__ v_pages, const int* __restrict__ block_tables,
                    const int* __restrict__ context_lens, float* __restrict__ out, int heads,
                    int blk, int max_blocks, float scale) {
  extern __shared__ float scores[];  // [max_blocks * blk]
  __shared__ float qs[D];
  __shared__ float part_out[kDecodeThreads];
  __shared__ float scratch[33];

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  constexpr int kWarps = kDecodeThreads / 32;
  const int kmax = max_blocks * blk;
  // context_len counts the current token; positions >= it are never read
  const int ctx = min(max(context_lens[b], 1), kmax);
  const int* table = block_tables + static_cast<long long>(b) * max_blocks;
  const long long row = (static_cast<long long>(b) * heads + h) * D;  // [B, H, D] tensors
  const long long page_stride = static_cast<long long>(blk) * heads * D;

  for (int d = tid; d < D; d += kDecodeThreads) qs[d] = q[row + d];
  __syncthreads();

  // pass 1: one warp per key, scores into shared memory
  float wmax = mxtpu::kNegInf;
  for (int p = warp; p < ctx; p += kWarps) {
    const float* kr = p == ctx - 1
        ? k_step + row
        : k_pages + table[p / blk] * page_stride +
              (static_cast<long long>(p % blk) * heads + h) * D;
    float dot = 0.f;
#pragma unroll
    for (int d = lane; d < D; d += 32) dot += qs[d] * kr[d];
    dot = mxtpu::warp_sum(dot);
    const float sc = dot * scale;
    if (lane == 0) scores[p] = sc;
    wmax = fmaxf(wmax, sc);
  }
  const float m = mxtpu::block_reduce<true>(wmax, scratch);

  // pass 2: exponentials and their sum
  float lsum = 0.f;
  for (int p = tid; p < ctx; p += kDecodeThreads) {
    const float e = expf(scores[p] - m);
    scores[p] = e;
    lsum += e;
  }
  const float l = mxtpu::block_reduce<false>(lsum, scratch);  // also publishes scores

  // pass 3: P.V, kDecodeThreads / D groups of D threads split the keys
  constexpr int kGroups = kDecodeThreads / D;
  const int g = tid / D;
  const int d = tid % D;
  float a = 0.f;
  for (int p = g; p < ctx; p += kGroups) {
    const float* vr = p == ctx - 1
        ? v_step + row
        : v_pages + table[p / blk] * page_stride +
              (static_cast<long long>(p % blk) * heads + h) * D;
    a += scores[p] * vr[d];
  }
  part_out[tid] = a;
  __syncthreads();
  if (tid < D) {
    float total = 0.f;
#pragma unroll
    for (int gg = 0; gg < kGroups; ++gg) total += part_out[gg * D + tid];
    out[row + tid] = total / l;
  }
}

template <int D, int WG>
cudaError_t launch_flash_wg(const float* q, const float* k, const float* v, float* o,
                            float* lse, int bh, int t_len, int tk_len, int causal, float scale,
                            cudaStream_t stream) {
  static bool attr = false;
  if (!attr) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<D, WG>, cudaFuncAttributeMaxDynamicSharedMemorySize, Fwd<D>::kBytes);
    if (err != cudaSuccess) return err;
    attr = true;
  }
  dim3 grid(bh, (t_len + kFwdGroupQ * WG - 1) / (kFwdGroupQ * WG));
  flash_fwd_kernel<D, WG><<<grid, 128 * WG, Fwd<D>::kBytes, stream>>>(
      q, k, v, o, lse, t_len, tk_len, causal, scale);
  return cudaGetLastError();
}

// Two warpgroups a block share each split K/V tile (half the splitting
// work a row) where that still gives every SM a block or more; else one.
template <int D>
cudaError_t launch_flash(const float* q, const float* k, const float* v, float* o, float* lse,
                         int bh, int t_len, int tk_len, int causal, float scale,
                         cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (static_cast<long long>(bh) * ((t_len + 127) / 128) >= 2LL * sms)
    return launch_flash_wg<D, 2>(q, k, v, o, lse, bh, t_len, tk_len, causal, scale, stream);
  return launch_flash_wg<D, 1>(q, k, v, o, lse, bh, t_len, tk_len, causal, scale, stream);
}

template <int D>
cudaError_t launch_flash_simt(const float* q, const float* k, const float* v, float* o,
                              float* lse, int bh, int t_len, int tk_len, int causal,
                              float scale, cudaStream_t stream) {
  dim3 grid((t_len + kFlashBlockQ - 1) / kFlashBlockQ, bh);
  flash_fwd_simt_kernel<D><<<grid, kFlashThreads, 0, stream>>>(q, k, v, o, lse, t_len, tk_len,
                                                               causal, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_decode(const float* q, const float* k_step, const float* v_step,
                          const float* k_pages, const float* v_pages, const int* block_tables,
                          const int* context_lens, float* out, int bsz, int heads, int blk,
                          int max_blocks, float scale, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(max_blocks) * blk * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(paged_decode_kernel<D>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  dim3 grid(heads, bsz);
  paged_decode_kernel<D><<<grid, kDecodeThreads, smem, stream>>>(
      q, k_step, v_step, k_pages, v_pages, block_tables, context_lens, out, heads, blk,
      max_blocks, scale);
  return cudaGetLastError();
}

}  // namespace

// q, o: contiguous fp32 [B, H, T, D]; k, v: [B, H, Tk, D]; lse: fp32 [B, H, T] or
// nullptr; head_dim one of 32, 64, 128.  causal masks key j from query i when j > i.
MXTPU_API int mxtpu_flash_prefill(const float* q, const float* k, const float* v, float* o,
                                  float* lse, int bsz, int heads, int t_len, int tk_len,
                                  int head_dim, int causal, float scale, void* stream) {
  if (bsz <= 0 || heads <= 0 || t_len <= 0 || tk_len <= 0)
    return static_cast<int>(cudaGetLastError());
  const int bh = bsz * heads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 32:
      return static_cast<int>(
          launch_flash<32>(q, k, v, o, lse, bh, t_len, tk_len, causal, scale, s));
    case 64:
      return static_cast<int>(
          launch_flash<64>(q, k, v, o, lse, bh, t_len, tk_len, causal, scale, s));
    case 128:
      return static_cast<int>(
          launch_flash<128>(q, k, v, o, lse, bh, t_len, tk_len, causal, scale, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The CUDA-core forward (flash_fwd_simt_kernel) with mxtpu_flash_prefill's
// arguments, head_dim 64 only: for timing it beside the tensor-core kernel.
MXTPU_API int mxtpu_flash_fwd_simt(const float* q, const float* k, const float* v, float* o,
                                   float* lse, int bsz, int heads, int t_len, int tk_len,
                                   int head_dim, int causal, float scale, void* stream) {
  if (bsz <= 0 || heads <= 0 || t_len <= 0 || tk_len <= 0)
    return static_cast<int>(cudaGetLastError());
  if (head_dim != 64) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_flash_simt<64>(q, k, v, o, lse, bsz * heads, t_len, tk_len,
                                                causal, scale,
                                                static_cast<cudaStream_t>(stream)));
}

// q, k_step, v_step, out: contiguous fp32 [B, H, D]; k_pages, v_pages:
// contiguous fp32 [num_blocks, blk, H, D]; block_tables int32 [B, max_blocks];
// context_lens int32 [B].  head_dim one of 32, 64, 128.
MXTPU_API int mxtpu_paged_decode(const float* q, const float* k_step, const float* v_step,
                                 const float* k_pages, const float* v_pages,
                                 const int* block_tables, const int* context_lens, float* out,
                                 int bsz, int heads, int head_dim, int blk, int max_blocks,
                                 float scale, void* stream) {
  if (bsz <= 0 || heads <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 32:
      return static_cast<int>(launch_decode<32>(q, k_step, v_step, k_pages, v_pages,
                                                block_tables, context_lens, out, bsz, heads,
                                                blk, max_blocks, scale, s));
    case 64:
      return static_cast<int>(launch_decode<64>(q, k_step, v_step, k_pages, v_pages,
                                                block_tables, context_lens, out, bsz, heads,
                                                blk, max_blocks, scale, s));
    case 128:
      return static_cast<int>(launch_decode<128>(q, k_step, v_step, k_pages, v_pages,
                                                 block_tables, context_lens, out, bsz, heads,
                                                 blk, max_blocks, scale, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The flash backward's two passes.  q, dout: contiguous fp32 [B, H, T, D]; k, v:
// [B, H, Tk, D]; lse (from mxtpu_flash_prefill) and delta = rowsum(dout * o):
// fp32 [B, H, T].  mxtpu_flash_bwd_dkdv writes dk, dv [B, H, Tk, D];
// mxtpu_flash_bwd_dq writes dq [B, H, T, D].  head_dim 32 or 64 (tensor
// cores); the _simt entry points take the same arguments and head_dim 64 or
// 128 (CUDA cores).
MXTPU_API int mxtpu_flash_bwd_dkdv(const float* q, const float* k, const float* v,
                                   const float* dout, const float* lse, const float* delta,
                                   float* dk, float* dv, int bsz, int heads, int t_len,
                                   int tk_len, int head_dim, int causal, float scale,
                                   void* stream) {
  return dispatch_bwd<false>(q, k, v, dout, lse, delta, nullptr, dk, dv, bsz, heads, t_len, tk_len,
                             head_dim, causal, scale, stream);
}

MXTPU_API int mxtpu_flash_bwd_dq(const float* q, const float* k, const float* v,
                                 const float* dout, const float* lse, const float* delta,
                                 float* dq, int bsz, int heads, int t_len, int tk_len,
                                 int head_dim, int causal, float scale, void* stream) {
  return dispatch_bwd<false>(q, k, v, dout, lse, delta, dq, nullptr, nullptr, bsz, heads, t_len,
                             tk_len, head_dim, causal, scale, stream);
}

MXTPU_API int mxtpu_flash_bwd_dkdv_simt(const float* q, const float* k, const float* v,
                                        const float* dout, const float* lse,
                                        const float* delta, float* dk, float* dv, int bsz,
                                        int heads, int t_len, int tk_len, int head_dim,
                                        int causal, float scale, void* stream) {
  return dispatch_bwd<true>(q, k, v, dout, lse, delta, nullptr, dk, dv, bsz, heads, t_len, tk_len,
                            head_dim, causal, scale, stream);
}

MXTPU_API int mxtpu_flash_bwd_dq_simt(const float* q, const float* k, const float* v,
                                      const float* dout, const float* lse, const float* delta,
                                      float* dq, int bsz, int heads, int t_len, int tk_len,
                                      int head_dim, int causal, float scale, void* stream) {
  return dispatch_bwd<true>(q, k, v, dout, lse, delta, dq, nullptr, nullptr, bsz, heads, t_len,
                            tk_len, head_dim, causal, scale, stream);
}
