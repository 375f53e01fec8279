// Flash attention in bf16 for sm_90a: the forward with its log-sum-exp and the
// backward's dK/dV and dQ passes, bf16 q, k, v, do, o, dq, dk, dv with fp32
// lse and delta.
//
// mxtpu_flash_fwd_bf16 replaces the Pallas flash forward of the JAX package's
// training path on bf16 inputs (mxnet_tpu/ops/attention.py _flash_fwd_pallas
// with return_lse=True, _flash_kernel); mxtpu_flash_bwd_dkdv_bf16_v1 and
// mxtpu_flash_bwd_dq_bf16_v1 replace the two pallas_calls of
// _flash_bwd_pallas (_flash_bwd_dkdv_kernel, _flash_bwd_dq_kernel) on bf16
// inputs of head dim 128; at head dims 32 and 64 the redesigned pair of
// flash_bwd_bf16_sm90.cu does (these stay its in-turn yardstick).  The
// fp32 kernels of attention_kernels.cu keep the fp32 inputs.
//
// What the TPU kernels compute on bf16, and so these: every product takes
// bf16 operands and sums in fp32 (S = q k^T, dP = do v^T, P V, P^T do,
// dS^T q, dS k); the softmax, lse and delta are fp32; P is rounded to bf16
// before P V and P^T do, dS before dS k and dS^T q; o, dq, dk and dv are
// rounded to bf16 once, at the end.
//
// What bounds them on an H100: at the bench LM's shape (B = 8, 16 heads,
// T = 2048, D = 64, causal) the forward does 4 * D * B * H * T(T+1)/2 =
// 68.7 GFLOP against 67 MB of q, k, v, o and lse, 0.069 ms at the dense
// bf16 tensor-core rate (989 TFLOP/s) against 0.020 ms of bytes; the dK/dV
// pass does 8 * D per (query, key) pair, 137 GFLOP (0.139 ms), and the dQ
// pass 6 * D, 103 GFLOP (0.104 ms): all three are bound by operations.
//
// Design.  A block is two warpgroups of 64 resident rows (queries in the
// forward and the dQ pass, keys in the dK/dV pass); the other operand streams
// past in tiles of 64 rows (32 in the dK/dV pass), landing by
// cp.async in a second buffer while the current tile is multiplied.  Every
// product is one wgmma m64nNk16 bf16 -> fp32 (no split: bf16 times bf16 is
// exact in the fp32 accumulator).  Each tile is stored once, row-major as it
// lies in memory, in 128-byte swizzled atoms of 64 columns; 16-bit wgmma
// reads a shared-memory B operand in either major order, so the same tile
// serves as the K-major B of q k^T (or do v^T) and, transposed by the
// instruction, as the MN-major B of P V (or P^T do, dS^T q, dS k).  Neither a
// transposed copy nor a key permutation is kept, unlike the fp32 kernels.  The
// first products take both operands from shared memory; P and dS (or P^T and
// dS^T) go from the fp32 accumulators to bf16 A fragments in registers: the
// m64nN accumulator holds, in column block j, (row g, columns 8j+2c, 8j+2c+1)
// and (row g+8, the same), with g = lane / 4, c = lane % 4, and the bf16 A
// fragment of k-step kk wants (row g | g+8, k 16kk+2c, +1 | 16kk+8+2c, +1):
// column blocks 2kk and 2kk+1, register for register.  Every sum runs through
// one wgmma accumulator over the whole stream: its error, which grows with
// T, stays far below the one rounding of o, dq, dk and dv to bf16 (2^-9),
// and the registers it saves let the forward and the dQ pass run two blocks
// an SM.  The softmax's exponentials are ex2 with the scale folded into one
// FFMA: an expf per score, with its range reduction, left these kernels
// bound by instructions rather than by the tensor cores.  Head dims 32, 64
// and 128;
// D = 32 pads the tiles to 64 columns with zeros.  Under causal, tiles wholly
// masked from a warpgroup's rows are skipped and only tiles that cross the
// diagonal or the end of the keys are masked.  Two passes, each writing only
// its own rows: no atomics, the same bits on every call.

#include <cuda_bf16.h>

#include "common.h"
#include "flash_bf16.h"

namespace {

using namespace mxtpu;

constexpr int kThreads = 256;  // two warpgroups
constexpr int kRes = 128;      // resident rows of a block

// Rows [r0, r0 + R) of a row-major [len][D] bf16 matrix into a tile, by
// cp.async; rows at or past len and the pad columns are zero-filled.
template <int D, int R>
__device__ __forceinline__ void load_tile(unsigned char* tile, const bf16* __restrict__ src,
                                          int r0, int len, int tid) {
  constexpr int W = cols<D>();
  for (int idx = tid; idx < R * W / 8; idx += kThreads) {
    const int r = idx / (W / 8), u = idx % (W / 8);
    const bool ok = r0 + r < len && u < D / 8;
    const bf16* g = src + (ok ? static_cast<long long>(r0 + r) * D + u * 8 : 0);
    mxtpu::cp_async16(tile + swz(R, r, u * 8), g, ok);
  }
}

// The landed tiles are visible to every thread and to wgmma (async proxy).
__device__ __forceinline__ void cp_wait_sync() {
  mxtpu::cp_async_wait_all();
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
}

// ---------------------------------------------------------------- forward

constexpr int kFwdBK = 64;  // keys of a streamed tile

template <int D>
struct FwdB {
  static constexpr int kQ = kRes * cols<D>() * 2;     // the resident Q tile
  static constexpr int kKV = kFwdBK * cols<D>() * 2;  // one K or V tile
  static constexpr int kBytes = 1024 + kQ + 4 * kKV;
};

// One block per (b*h, 128 queries), a warpgroup per 64; K and V stream past
// in tiles of 64 keys.  S = Q K^T from shared memory, the online softmax in
// fp32 registers (running max of the unscaled scores; scale and exponent in
// one FFMA), P rounded to bf16 fragments, O += P V with V's tile read
// MN-major.  At most 128 registers a thread at D <= 64, so two blocks share
// an SM and one's softmax overlaps the other's products.  The bottom
// (longest under causal) row blocks start first.
template <int D>
__global__ void __launch_bounds__(kThreads, D <= 64 ? 2 : 1)
flash_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
                      int t_len, int tk_len, int causal, float scale) {
  using F = FwdB<D>;
  constexpr int kNC = cols<D>() / 64;  // 64-column accumulators of O
  extern __shared__ unsigned char fwd_bf16_raw[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<unsigned long long>(fwd_bf16_raw) + 1023) & ~1023ull);
  unsigned char* qt = sm;
  unsigned char* kt = qt + F::kQ;  // two stages of K, then two of V
  unsigned char* vt = kt + 2 * F::kKV;

  const int tid = threadIdx.x, warp = tid / 32 % 4, lane = tid % 32;
  // the warpgroup, broadcast from lane 0 so that the compiler sees it uniform
  // in the warp: branches on it around wgmma then do not serialize them
  const int wg = __shfl_sync(mxtpu::kFullMask, tid / 128, 0);
  const int g = lane / 4, c = lane % 4;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRes;
  const int qg = q0 + wg * 64;
  const int row0 = qg + warp * 16 + g, row1 = row0 + 8;
  const long long qbase = static_cast<long long>(blockIdx.x) * t_len * D;
  const long long kbase = static_cast<long long>(blockIdx.x) * tk_len * D;
  const int k_end = causal ? min(q0 + kRes, tk_len) : tk_len;
  const int ntiles = (k_end + kFwdBK - 1) / kFwdBK;
  const float sl2 = scale * kLog2e;

  load_tile<D, kRes>(qt, q + qbase, q0, t_len, tid);
  load_tile<D, kFwdBK>(kt, k + kbase, 0, tk_len, tid);
  load_tile<D, kFwdBK>(vt, v + kbase, 0, tk_len, tid);
  mxtpu::cp_async_commit();

  float acc[kNC][32];
  zero_acc<D>(acc);
  // running max of the unscaled scores, and sum of p, of rows 0 and 1
  float m0 = mxtpu::kNegInf, m1 = mxtpu::kNegInf, l0 = 0.f, l1 = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    cp_wait_sync();  // tile it has landed; every product of tile it - 1 is done
    const int st = it & 1;
    if (it + 1 < ntiles) {
      load_tile<D, kFwdBK>(kt + (st ^ 1) * F::kKV, k + kbase, (it + 1) * kFwdBK, tk_len, tid);
      load_tile<D, kFwdBK>(vt + (st ^ 1) * F::kKV, v + kbase, (it + 1) * kFwdBK, tk_len, tid);
      mxtpu::cp_async_commit();
    }
    const int k0 = it * kFwdBK;
    // under causal a warpgroup's rows may all lie above this tile
    if (causal && k0 > qg + 63) continue;

    float s[kFwdBK / 2];
    mxtpu::wgmma_fence();
    product_ss<D, kFwdBK>(s, qt, kRes, wg * 64, kt + st * F::kKV);
    mxtpu::wgmma_commit_wait();

    // mask (only tiles crossing the diagonal or the end of the keys) and
    // the online softmax.  A masked score is -1e30, its p exactly 0; the
    // first tile holds a valid key of every row (key 0), so the running max
    // is a score.
    if (k0 + kFwdBK > tk_len || (causal && k0 + kFwdBK - 1 > qg)) {
#pragma unroll
      for (int i = 0; i < kFwdBK / 2; ++i) {
        const int kj = k0 + 8 * (i / 4) + 2 * c + (i & 1);
        const int qi = (i & 2) ? row1 : row0;
        if ((causal && kj > qi) || kj >= tk_len) s[i] = mxtpu::kNegInf;
      }
    }
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int j = 0; j < kFwdBK / 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
    mx0 = mxtpu::quad_max(mx0);
    mx1 = mxtpu::quad_max(mx1);
    const float alpha0 = ex2((m0 - mx0) * sl2), alpha1 = ex2((m1 - mx1) * sl2);
    const float nm0 = -mx0 * sl2, nm1 = -mx1 * sl2;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int i = 0; i < kFwdBK / 2; ++i) {
      const float p = ex2(fmaf(s[i], sl2, (i & 2) ? nm1 : nm0));
      s[i] = p;
      if (i & 2) sum1 += p; else sum0 += p;
    }
    l0 = l0 * alpha0 + sum0;
    l1 = l1 * alpha1 + sum1;
    m0 = mx0;
    m1 = mx1;
    unsigned pa[kFwdBK / 16][4];
    to_frags<kFwdBK>(s, pa);
#pragma unroll
    for (int n = 0; n < kNC; ++n)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[n][i] *= (i & 2) ? alpha1 : alpha0;
    mxtpu::wgmma_fence();
    product_rs<D, kFwdBK>(acc, pa, vt + st * F::kKV);
    mxtpu::wgmma_commit_wait();
  }

  l0 = mxtpu::quad_sum(l0);
  l1 = mxtpu::quad_sum(l1);
  const float inv0 = 1.f / (l0 == 0.f ? 1.f : l0), inv1 = 1.f / (l1 == 0.f ? 1.f : l1);
  store_rows<D>(o + qbase, acc, row0, row1, t_len, c, inv0, inv1);
  // natural log of the row's softmax denominator over the scaled scores
  if (lse != nullptr && c == 0) {
    const long long rbase = static_cast<long long>(blockIdx.x) * t_len;
    if (row0 < t_len) lse[rbase + row0] = m0 * scale + logf(l0);
    if (row1 < t_len) lse[rbase + row1] = m1 * scale + logf(l1);
  }
}

// --------------------------------------------------------------- backward

template <int D>
struct BwdB {
  static constexpr int kKvBS = 32;  // queries of a dK/dV tile
  static constexpr int kQBS = 64;                   // keys of a dQ tile
  static constexpr int kResT = kRes * cols<D>() * 2;
  static constexpr int kKvT = kKvBS * cols<D>() * 2;
  static constexpr int kQT = kQBS * cols<D>() * 2;
  // K, V resident; two stages of Q and dO; two of lse and delta
  static constexpr int kDkdvBytes = 1024 + 2 * kResT + 4 * kKvT + 4 * kKvBS * 4;
  // Q, dO resident; two stages of K and V
  static constexpr int kDqBytes = 1024 + 2 * kResT + 4 * kQT;
};

// dK and dV of 128 keys (a warpgroup per 64).  K and V are resident (A of
// S^T = K Q^T and dP^T = V dO^T); Q and dO stream past in tiles of 32
// queries, B of those two products K-major and, read MN-major, of
// dV += P^T dO and dK += dS^T Q.  Tiles of 32 keep a thread's dK and dV
// totals and the tile's S^T and dP^T within 128 registers at D <= 64, so
// two blocks share an SM (with tiles of 64 they do not fit).
// The accumulators' columns are queries, so
// lse (times log2(e)) and delta are staged per tile in shared memory; pad
// queries get lse = +inf, so their p is exactly 0.  Under causal the stream
// starts at the block's first key, a warpgroup skips the tiles wholly above
// its keys and masks only those that cross them.
template <int D>
__global__ void __launch_bounds__(kThreads, D <= 64 ? 2 : 1)
flash_bwd_dkdv_bf16_v1_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const bf16* __restrict__ v, const bf16* __restrict__ dout,
                           const float* __restrict__ lse, const float* __restrict__ delta,
                           bf16* __restrict__ dk, bf16* __restrict__ dv, int t_len, int tk_len,
                           int causal, float scale) {
  using B = BwdB<D>;
  constexpr int BS = B::kKvBS;
  constexpr int kNC = cols<D>() / 64;
  extern __shared__ unsigned char dkdv_bf16_raw[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<unsigned long long>(dkdv_bf16_raw) + 1023) & ~1023ull);
  unsigned char* kres = sm;
  unsigned char* vres = kres + B::kResT;
  unsigned char* qt = vres + B::kResT;   // two stages
  unsigned char* dot = qt + 2 * B::kKvT;  // two stages
  float* lse_s = reinterpret_cast<float*>(dot + 2 * B::kKvT);  // [2][BS]
  float* del_s = lse_s + 2 * BS;

  const int tid = threadIdx.x, warp = tid / 32 % 4, lane = tid % 32;
  const int wg = __shfl_sync(mxtpu::kFullMask, tid / 128, 0);
  const int g = lane / 4, c = lane % 4;
  const int k0 = blockIdx.y * kRes;  // blockIdx.y = 0, the longest under causal, first
  const int kw = k0 + wg * 64;
  const int key0 = kw + warp * 16 + g, key1 = key0 + 8;
  const long long qbase = static_cast<long long>(blockIdx.x) * t_len * D;
  const long long kbase = static_cast<long long>(blockIdx.x) * tk_len * D;
  const long long rbase = static_cast<long long>(blockIdx.x) * t_len;
  // causal: queries above the block's first key see none of its keys
  const int q_begin = causal ? k0 : 0;
  const int ntiles = q_begin < t_len ? (t_len - q_begin + BS - 1) / BS : 0;
  const float inf = __int_as_float(0x7f800000);
  const float sl2 = scale * kLog2e;

  auto load = [&](int tile) {
    const int st = tile & 1, r0 = q_begin + tile * BS;
    load_tile<D, BS>(qt + st * B::kKvT, q + qbase, r0, t_len, tid);
    load_tile<D, BS>(dot + st * B::kKvT, dout + qbase, r0, t_len, tid);
    for (int i = tid; i < BS; i += kThreads) {
      const bool ok = r0 + i < t_len;
      lse_s[st * BS + i] = ok ? lse[rbase + r0 + i] * kLog2e : inf;
      del_s[st * BS + i] = ok ? delta[rbase + r0 + i] : 0.f;
    }
  };
  load_tile<D, kRes>(kres, k + kbase, k0, tk_len, tid);
  load_tile<D, kRes>(vres, v + kbase, k0, tk_len, tid);
  if (ntiles > 0) load(0);
  mxtpu::cp_async_commit();

  float dka[kNC][32], dva[kNC][32];
  zero_acc<D>(dka);
  zero_acc<D>(dva);

  for (int it = 0; it < ntiles; ++it) {
    cp_wait_sync();
    const int st = it & 1;
    if (it + 1 < ntiles) {
      load(it + 1);
      mxtpu::cp_async_commit();
    }
    const int q0 = q_begin + it * BS;
    // a warpgroup skips a tile whose queries all lie above its keys
    if (causal && q0 + BS - 1 < kw) continue;
    const unsigned char* qs = qt + st * B::kKvT;
    const unsigned char* dos = dot + st * B::kKvT;
    const float* ls = lse_s + st * BS;
    const float* dl = del_s + st * BS;

    // S^T = K Q^T and dP^T = V dO^T: [64 keys x BS queries]
    float s[BS / 2], dp[BS / 2];
    mxtpu::wgmma_fence();
    product_ss<D, BS>(s, kres, kRes, wg * 64, qs);
    product_ss<D, BS>(dp, vres, kRes, wg * 64, dos);
    mxtpu::wgmma_commit_wait();

    const bool masked = causal && q0 < kw + 63;
#pragma unroll
    for (int i = 0; i < BS / 2; ++i) {
      const int col = 8 * (i / 4) + 2 * c + (i & 1);
      float p = ex2(fmaf(s[i], sl2, -ls[col]));
      if (masked && ((i & 2) ? key1 : key0) > q0 + col) p = 0.f;
      dp[i] = p * (dp[i] - dl[col]) * scale;
      s[i] = p;
    }
    unsigned pa[BS / 16][4], da[BS / 16][4];
    to_frags<BS>(s, pa);
    to_frags<BS>(dp, da);

    // dV += P^T dO, dK += dS^T Q (query block pair kk being k-step kk)
    mxtpu::wgmma_fence();
    product_rs<D, BS>(dva, pa, dos);
    product_rs<D, BS>(dka, da, qs);
    mxtpu::wgmma_commit_wait();
  }

  asm volatile("cp.async.wait_group 0;\n" ::);  // no tile: the resident ones
  store_rows<D>(dk + kbase, dka, key0, key1, tk_len, c);
  store_rows<D>(dv + kbase, dva, key0, key1, tk_len, c);
}

// dQ of 128 queries (a warpgroup per 64).  Q and dO are resident (A of
// S = Q K^T and dP = dO V^T); K and V stream past in tiles of 64 keys, B of
// those two products K-major and K, read MN-major, B of dQ += dS K.  Under
// causal the stream stops at the block's last query, a warpgroup skips the
// tiles wholly past its rows and masks only those that cross them; pad keys
// get p = 0.  At most 128 registers a thread at D <= 64: two blocks an SM.
template <int D>
__global__ void __launch_bounds__(kThreads, D <= 64 ? 2 : 1)
flash_bwd_dq_bf16_v1_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         bf16* __restrict__ dq, int t_len, int tk_len, int causal, float scale) {
  using B = BwdB<D>;
  constexpr int BS = B::kQBS;
  constexpr int kNC = cols<D>() / 64;
  extern __shared__ unsigned char dq_bf16_raw[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<unsigned long long>(dq_bf16_raw) + 1023) & ~1023ull);
  unsigned char* qres = sm;
  unsigned char* dores = qres + B::kResT;
  unsigned char* kt = dores + B::kResT;  // two stages
  unsigned char* vt = kt + 2 * B::kQT;   // two stages

  const int tid = threadIdx.x, warp = tid / 32 % 4, lane = tid % 32;
  const int wg = __shfl_sync(mxtpu::kFullMask, tid / 128, 0);
  const int g = lane / 4, c = lane % 4;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRes;
  const int qg = q0 + wg * 64;
  const int row0 = qg + warp * 16 + g, row1 = row0 + 8;
  const long long qbase = static_cast<long long>(blockIdx.x) * t_len * D;
  const long long kbase = static_cast<long long>(blockIdx.x) * tk_len * D;
  const long long rbase = static_cast<long long>(blockIdx.x) * t_len;
  const float inf = __int_as_float(0x7f800000);
  const float sl2 = scale * kLog2e;
  const float nl0 = row0 < t_len ? -lse[rbase + row0] * kLog2e : -inf;
  const float nl1 = row1 < t_len ? -lse[rbase + row1] * kLog2e : -inf;
  const float del0 = row0 < t_len ? delta[rbase + row0] : 0.f;
  const float del1 = row1 < t_len ? delta[rbase + row1] : 0.f;
  const int k_end = causal ? min(q0 + kRes, tk_len) : tk_len;
  const int ntiles = (k_end + BS - 1) / BS;

  load_tile<D, kRes>(qres, q + qbase, q0, t_len, tid);
  load_tile<D, kRes>(dores, dout + qbase, q0, t_len, tid);
  load_tile<D, BS>(kt, k + kbase, 0, tk_len, tid);
  load_tile<D, BS>(vt, v + kbase, 0, tk_len, tid);
  mxtpu::cp_async_commit();

  float dqa[kNC][32];
  zero_acc<D>(dqa);

  for (int it = 0; it < ntiles; ++it) {
    cp_wait_sync();
    const int st = it & 1;
    if (it + 1 < ntiles) {
      load_tile<D, BS>(kt + (st ^ 1) * B::kQT, k + kbase, (it + 1) * BS, tk_len, tid);
      load_tile<D, BS>(vt + (st ^ 1) * B::kQT, v + kbase, (it + 1) * BS, tk_len, tid);
      mxtpu::cp_async_commit();
    }
    const int k0 = it * BS;
    if (causal && k0 > qg + 63) continue;
    const unsigned char* ks = kt + st * B::kQT;

    // S = Q K^T and dP = dO V^T: [64 queries x BS keys]
    float s[BS / 2], dp[BS / 2];
    mxtpu::wgmma_fence();
    product_ss<D, BS>(s, qres, kRes, wg * 64, ks);
    product_ss<D, BS>(dp, dores, kRes, wg * 64, vt + st * B::kQT);
    mxtpu::wgmma_commit_wait();

    const bool masked = k0 + BS > tk_len || (causal && k0 + BS - 1 > qg);
#pragma unroll
    for (int i = 0; i < BS / 2; ++i) {
      const int kj = k0 + 8 * (i / 4) + 2 * c + (i & 1);
      const int qi = (i & 2) ? row1 : row0;
      float p = ex2(fmaf(s[i], sl2, (i & 2) ? nl1 : nl0));
      if (masked && ((causal && kj > qi) || kj >= tk_len)) p = 0.f;
      dp[i] = p * (dp[i] - ((i & 2) ? del1 : del0)) * scale;
    }
    unsigned da[BS / 16][4];
    to_frags<BS>(dp, da);

    // dQ += dS K, key block pair kk being k-step kk
    mxtpu::wgmma_fence();
    product_rs<D, BS>(dqa, da, ks);
    mxtpu::wgmma_commit_wait();
  }

  store_rows<D>(dq + qbase, dqa, row0, row1, t_len, c);
}

template <typename Kern>
cudaError_t allow_smem(Kern kern, int bytes, bool& done) {
  if (done) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) done = true;
  return err;
}

template <int D>
cudaError_t launch_fwd(const bf16* q, const bf16* k, const bf16* v, bf16* o, float* lse, int bh,
                       int t_len, int tk_len, int causal, float scale, cudaStream_t stream) {
  static bool attr = false;
  cudaError_t err = allow_smem(flash_fwd_bf16_kernel<D>, FwdB<D>::kBytes, attr);
  if (err != cudaSuccess) return err;
  dim3 grid(bh, (t_len + kRes - 1) / kRes);
  flash_fwd_bf16_kernel<D><<<grid, kThreads, FwdB<D>::kBytes, stream>>>(
      q, k, v, o, lse, t_len, tk_len, causal, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bwd(const bf16* q, const bf16* k, const bf16* v, const bf16* dout,
                       const float* lse, const float* delta, bf16* dq, bf16* dk, bf16* dv,
                       int bh, int t_len, int tk_len, int causal, float scale,
                       cudaStream_t stream) {
  if (dk != nullptr) {
    static bool attr = false;
    cudaError_t err = allow_smem(flash_bwd_dkdv_bf16_v1_kernel<D>, BwdB<D>::kDkdvBytes, attr);
    if (err != cudaSuccess) return err;
    dim3 grid(bh, (tk_len + kRes - 1) / kRes);
    flash_bwd_dkdv_bf16_v1_kernel<D><<<grid, kThreads, BwdB<D>::kDkdvBytes, stream>>>(
        q, k, v, dout, lse, delta, dk, dv, t_len, tk_len, causal, scale);
  } else {
    static bool attr = false;
    cudaError_t err = allow_smem(flash_bwd_dq_bf16_v1_kernel<D>, BwdB<D>::kDqBytes, attr);
    if (err != cudaSuccess) return err;
    dim3 grid(bh, (t_len + kRes - 1) / kRes);
    flash_bwd_dq_bf16_v1_kernel<D><<<grid, kThreads, BwdB<D>::kDqBytes, stream>>>(
        q, k, v, dout, lse, delta, dq, t_len, tk_len, causal, scale);
  }
  return cudaGetLastError();
}

int dispatch_bwd(const void* q, const void* k, const void* v, const void* dout,
                 const float* lse, const float* delta, void* dq, void* dk, void* dv, int bsz,
                 int heads, int t_len, int tk_len, int head_dim, int causal, float scale,
                 void* stream) {
  if (bsz <= 0 || heads <= 0 || t_len <= 0 || tk_len <= 0)
    return static_cast<int>(cudaGetLastError());
  const auto* q_ = static_cast<const bf16*>(q);
  const auto* k_ = static_cast<const bf16*>(k);
  const auto* v_ = static_cast<const bf16*>(v);
  const auto* d_ = static_cast<const bf16*>(dout);
  auto* dq_ = static_cast<bf16*>(dq);
  auto* dk_ = static_cast<bf16*>(dk);
  auto* dv_ = static_cast<bf16*>(dv);
  const int bh = bsz * heads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 32:
      return static_cast<int>(launch_bwd<32>(q_, k_, v_, d_, lse, delta, dq_, dk_, dv_, bh,
                                             t_len, tk_len, causal, scale, s));
    case 64:
      return static_cast<int>(launch_bwd<64>(q_, k_, v_, d_, lse, delta, dq_, dk_, dv_, bh,
                                             t_len, tk_len, causal, scale, s));
    case 128:
      return static_cast<int>(launch_bwd<128>(q_, k_, v_, d_, lse, delta, dq_, dk_, dv_, bh,
                                              t_len, tk_len, causal, scale, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, o: contiguous bf16 [B, H, T, D]; k, v: [B, H, Tk, D]; lse: fp32 [B, H, T]
// or nullptr; head_dim one of 32, 64, 128.  causal masks key j from query i
// when j > i.
MXTPU_API int mxtpu_flash_fwd_bf16(const void* q, const void* k, const void* v, void* o,
                                   float* lse, int bsz, int heads, int t_len, int tk_len,
                                   int head_dim, int causal, float scale, void* stream) {
  if (bsz <= 0 || heads <= 0 || t_len <= 0 || tk_len <= 0)
    return static_cast<int>(cudaGetLastError());
  const auto* q_ = static_cast<const bf16*>(q);
  const auto* k_ = static_cast<const bf16*>(k);
  const auto* v_ = static_cast<const bf16*>(v);
  auto* o_ = static_cast<bf16*>(o);
  const int bh = bsz * heads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 32:
      return static_cast<int>(
          launch_fwd<32>(q_, k_, v_, o_, lse, bh, t_len, tk_len, causal, scale, s));
    case 64:
      return static_cast<int>(
          launch_fwd<64>(q_, k_, v_, o_, lse, bh, t_len, tk_len, causal, scale, s));
    case 128:
      return static_cast<int>(
          launch_fwd<128>(q_, k_, v_, o_, lse, bh, t_len, tk_len, causal, scale, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The backward's two passes on bf16, as PR 8 first wrote them (the _v1
// entries): the path of head dim 128, which the redesigned pair of
// flash_bwd_bf16_sm90.cu does not take, and the yardstick that pair is
// timed against.  q, dout: contiguous bf16 [B, H, T, D]; k, v: [B, H, Tk,
// D]; lse (from mxtpu_flash_fwd_bf16) and delta = rowsum(dout * o) in
// fp32: fp32 [B, H, T].  mxtpu_flash_bwd_dkdv_bf16_v1 writes bf16 dk, dv
// [B, H, Tk, D]; mxtpu_flash_bwd_dq_bf16_v1 writes bf16 dq [B, H, T, D].
// head_dim one of 32, 64, 128.
MXTPU_API int mxtpu_flash_bwd_dkdv_bf16_v1(const void* q, const void* k, const void* v,
                                           const void* dout, const float* lse,
                                           const float* delta, void* dk, void* dv, int bsz,
                                           int heads, int t_len, int tk_len, int head_dim,
                                           int causal, float scale, void* stream) {
  return dispatch_bwd(q, k, v, dout, lse, delta, nullptr, dk, dv, bsz, heads, t_len, tk_len,
                      head_dim, causal, scale, stream);
}

MXTPU_API int mxtpu_flash_bwd_dq_bf16_v1(const void* q, const void* k, const void* v,
                                         const void* dout, const float* lse,
                                         const float* delta, void* dq, int bsz, int heads,
                                         int t_len, int tk_len, int head_dim, int causal,
                                         float scale, void* stream) {
  return dispatch_bwd(q, k, v, dout, lse, delta, dq, nullptr, nullptr, bsz, heads, t_len,
                      tk_len, head_dim, causal, scale, stream);
}
