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
// Flash forward.  softmax(q k^T * scale) v on [B, H, T, D], causal or not.  What
// bounds it on an H100: at the lane's largest prefill (T = 512, 16 heads,
// D = 64) the causal half does 4 * D * H * T(T+1)/2 = 0.54 GFLOP per layer
// against 8.4 MB of q, k, v and out, so it is bound by operations: 8 us at
// the 67 TFLOP/s fp32 rate (the lane runs in fp32, so the tensor cores'
// TF32 is out).  Design: one block of 128 threads per (b*h, 32-row q tile);
// four threads share a query row, each holding a quarter of q and of the
// accumulator in registers, interleaved (dim = part + 4*i) so the four
// threads of a row read four consecutive shared-memory banks.  A loop over
// 32-key tiles of K and V staged in shared memory takes the place of the
// TPU's sequential grid axis; the running max, sum and accumulator never
// leave registers, and tiles above the diagonal are never loaded.  No
// tensor cores yet: that is the later, faster version.
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

// ---------------------------------------------------------------- prefill

constexpr int kFlashThreads = 128;
constexpr int kFlashRowThreads = 4;                          // threads per query row
constexpr int kFlashBlockQ = kFlashThreads / kFlashRowThreads;  // 32 rows
constexpr int kFlashBlockK = 32;

template <int D>
__global__ void __launch_bounds__(kFlashThreads)
flash_prefill_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, int t_len, int tk_len, int causal, float scale) {
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
// of them (a broadcast).  The dot products are summed in the forward's
// order, so p agrees with the forward's softmax.  Each pass writes only its
// own rows: no atomics, and the gradients are the same bits run to run.

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

template <int D>
cudaError_t launch_flash(const float* q, const float* k, const float* v, float* o, float* lse,
                         int bh, int t_len, int tk_len, int causal, float scale,
                         cudaStream_t stream) {
  dim3 grid((t_len + kFlashBlockQ - 1) / kFlashBlockQ, bh);
  flash_prefill_kernel<D><<<grid, kFlashThreads, 0, stream>>>(q, k, v, o, lse, t_len, tk_len,
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
