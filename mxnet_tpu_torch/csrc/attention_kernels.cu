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
// the diagonal, 7 * 2 * D * B * H * T(T+1)/2 = 240 GFLOP (3.6 ms at 67 TFLOP/s
// fp32) against 60 MB read and written: bound by operations.  The TPU
// kernels' 1024-row blocks carried their sums across a sequential grid axis;
// here one block per (b*h, 32-row tile) keeps the resident tile's rows and
// accumulators in registers and loops over the streamed tiles (see below).
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

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
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
// (computed before the launch, as the JAX wrapper does).  Thread layout as in
// the forward: four threads per row of the resident tile, each holding a
// quarter of its vectors, interleaved (dim = part + 4 * i); the streamed
// tiles sit in shared memory and every thread of a warp reads the same row
// of them (a broadcast).  The dot products run on CUDA cores in fp32, in
// another order than the forward's 3xTF32 tensor-core products: both are
// within fp32 rounding of the exact score, so p agrees with the forward's
// softmax to about 1e-6 of its value, not bit for bit.  Each pass writes
// only its own rows: no atomics, and the gradients are the same bits run to
// run.

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
flash_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
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
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
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
    dim3 grid((tk_len + kBwdTile - 1) / kBwdTile, bh);
    flash_bwd_dkdv_kernel<D><<<grid, kBwdThreads, 0, stream>>>(
        q, k, v, dout, lse, delta, dk, dv, t_len, tk_len, causal, scale);
  } else {
    dim3 grid((t_len + kBwdTile - 1) / kBwdTile, bh);
    flash_bwd_dq_kernel<D><<<grid, kBwdThreads, 0, stream>>>(
        q, k, v, dout, lse, delta, dq, t_len, tk_len, causal, scale);
  }
  return cudaGetLastError();
}

int dispatch_bwd(const float* q, const float* k, const float* v, const float* dout,
                 const float* lse, const float* delta, float* dq, float* dk, float* dv,
                 int bsz, int heads, int t_len, int tk_len, int head_dim, int causal,
                 float scale, void* stream) {
  if (bsz <= 0 || heads <= 0 || t_len <= 0 || tk_len <= 0)
    return static_cast<int>(cudaGetLastError());
  const int bh = bsz * heads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 32:
      return static_cast<int>(launch_bwd<32>(q, k, v, dout, lse, delta, dq, dk, dv, bh, t_len,
                                             tk_len, causal, scale, s));
    case 64:
      return static_cast<int>(launch_bwd<64>(q, k, v, dout, lse, delta, dq, dk, dv, bh, t_len,
                                             tk_len, causal, scale, s));
    case 128:
      return static_cast<int>(launch_bwd<128>(q, k, v, dout, lse, delta, dq, dk, dv, bh, t_len,
                                              tk_len, causal, scale, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
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
// mxtpu_flash_bwd_dq writes dq [B, H, T, D].
MXTPU_API int mxtpu_flash_bwd_dkdv(const float* q, const float* k, const float* v,
                                   const float* dout, const float* lse, const float* delta,
                                   float* dk, float* dv, int bsz, int heads, int t_len,
                                   int tk_len, int head_dim, int causal, float scale,
                                   void* stream) {
  return dispatch_bwd(q, k, v, dout, lse, delta, nullptr, dk, dv, bsz, heads, t_len, tk_len,
                      head_dim, causal, scale, stream);
}

MXTPU_API int mxtpu_flash_bwd_dq(const float* q, const float* k, const float* v,
                                 const float* dout, const float* lse, const float* delta,
                                 float* dq, int bsz, int heads, int t_len, int tk_len,
                                 int head_dim, int causal, float scale, void* stream) {
  return dispatch_bwd(q, k, v, dout, lse, delta, dq, nullptr, nullptr, bsz, heads, t_len,
                      tk_len, head_dim, causal, scale, stream);
}
