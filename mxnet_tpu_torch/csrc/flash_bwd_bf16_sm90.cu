// The flash attention backward's two passes in bf16 for Hopper, with a TMA
// producer warp and an mbarrier ring: dK/dV (flash_bwd_dkdv_bf16_kernel) and
// dQ (flash_bwd_dq_bf16_kernel), bf16 q, k, v, do, dq, dk, dv with fp32 lse
// and delta, head dims 32 and 64.
//
// They replace the two pallas_calls of the JAX package's flash backward on
// bf16 inputs (mxnet_tpu/ops/attention.py _flash_bwd_pallas:
// _flash_bwd_dkdv_kernel, its pallas_call at :572; _flash_bwd_dq_kernel, at
// :596).  What they compute is what flash_bf16.cu's first pair (the _v1
// kernels, which keep head dim 128) computes, bit for bit: every product
// takes bf16 operands and sums in fp32 (S = q k^T, dP = do v^T, P^T do,
// dS^T q, dS k); lse and delta are fp32; p is rounded to bf16 before P^T do,
// ds before dS^T q and dS k; dk, dv and dq are rounded to bf16 once, at the
// end.
//
// What bounds them on an H100: at the bench LM's shape (B = 8, 16 heads,
// T = 2048, D = 64, causal) the dK/dV pass does 8 * D per (query, key) pair
// at or below the diagonal, 137 GFLOP (0.139 ms at the dense bf16 rate of
// 989 TFLOP/s), and the dQ pass 6 * D, 103 GFLOP (0.104 ms), against 0.03
// ms of bytes: both are bound by the tensor cores.  On the card each pass
// takes about the sum of its products alone and its elementwise work alone
// (exponentials, dS, bf16 fragments): the two consumer warpgroups of a block
// do not overlap one's products with the other's arithmetic.
//
// Design.  A block is three warpgroups: warpgroup 0 the producer, lowered to
// 40 registers a thread (setmaxnreg.dec), of which one thread issues every
// load; warpgroups 1 and 2 the consumers, raised to 232 (setmaxnreg.inc),
// each owning 64 resident rows (128 keys a block in the dK/dV pass, 128
// queries in the dQ pass): 128 * 40 + 256 * 232 = 64,512 of the SM's 65,536
// registers, one block an SM.  ptxas keeps wgmma groups in flight only in
// code that fits the 168 registers a thread starts with; designs that need
// more (S and dP with A in registers, or a tile's accumulations issued
// behind the next tile's products) had every wgmma serialized (C7512).
// * Loads.  The resident tiles (K and V, or Q and dO) come by TMA once; the
//   streamed ones (Q and dO, or K and V, 64 rows each) come by TMA into a
//   ring of kStages stages, each with a "full" mbarrier (the producer's
//   arrive.expect_tx plus the bytes) and an "empty" one (one arrival per
//   consumer warpgroup).  In the dK/dV pass the stage also takes the tile's
//   64 lse and delta values by cp.async.bulk on the same barrier.  The
//   tensor maps are 3-D, [B*H, T, D] with boxes [1, rows, 64]: rows past a
//   head's end and the pad columns of D = 32 read as zero, where a 2-D map
//   would read the next head's rows.  No consumer thread loads a tile, and
//   nothing but the mbarriers couples the two consumers: no
//   __syncthreads() runs after the barriers are set up.
// * Overlap.  A consumer issues S^T = K Q^T (S = Q K^T in the dQ pass) and
//   dP^T = V dO^T (dP = dO V^T) as two commit groups and turns S into P
//   under wgmma.wait_group 1 while dP still runs.  The accumulations (dV +=
//   P^T dO and dK += dS^T Q, or dQ += dS K) are a third group; a stage is
//   freed (its empty barrier arrived on) once every wgmma that reads it has
//   retired.  The dK/dV pass waits for its accumulations at the end of the
//   tile: left in flight into the next tile they made ptxas serialize every
//   wgmma of the pass (C7515).  The dQ pass issues its accumulation without
//   a wait; ptxas still waits for it before the loop's next iteration.
// * Tiles.  Each tile is stored once, row-major in 128-byte swizzled atoms
//   of 64 columns, the layout TMA's 128-byte swizzle writes and the wgmma
//   descriptors name; it serves as the K-major B of S and dP and, read
//   MN-major with the instruction's transpose bit, as the B of the
//   accumulations.  Queries stream in tiles of 64 in the dK/dV pass too
//   (m64n64 S^T and dP^T, four k-steps for dV and dK).
// * The softmax's exponentials are ex2.approx with the scale folded into one
//   FFMA, -lse * log2(e) taken by the consumer as it reads the stage.  Pad
//   rows get p = 0 and ds = 0 by index: lse -inf and delta 0 in the dK/dV
//   pass (the bulk copy cannot fill them), keys past the end masked in the
//   dQ pass.  Under causal, tiles wholly masked from a warpgroup's rows are
//   skipped (their stage freed at once) and only tiles that cross the
//   diagonal are masked.
// * Order.  Blocks are launched a group of kHeadGroup heads at a time, the
//   longest (under causal) first within a group, so that the rows the
//   running blocks stream stay in L2.
// * Sums.  Every gradient sums through one wgmma accumulator over the
//   stream, as in the first pair.  Two passes, each writing only its own
//   rows: no atomics, the same bits on every call.

#include <cuda.h>
#include <cuda_bf16.h>

#include "common.h"
#include "flash_bf16.h"
#include "sm90.h"

namespace {

using namespace mxtpu;

constexpr int kThreads = 384;  // warpgroup 0 the producer, 1 and 2 the consumers
constexpr int kRes = 128;      // resident rows of a block, 64 a consumer
constexpr int kBS = 64;        // rows of a streamed tile
constexpr int kStages = 6;     // the ring
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
static_assert(128 * kProducerRegs + 256 * kConsumerRegs <= 65536,
              "the warpgroups' registers exceed the SM's");
constexpr int kTile = kBS * 128;      // a streamed tile: 64 columns of bf16 (D = 32 padded)
constexpr int kResTile = kRes * 128;  // a resident tile
// A stage's lse or delta window: 64 rows and up to 3 before them, in 272
// bytes (a bulk copy moves multiples of 16), kept 16-byte aligned.
constexpr int kWin = 80;
constexpr unsigned kWinBytes = 272;

// K, V resident; the ring's Q and dO tiles and lse and delta windows; the
// barriers full[kStages], empty[kStages] and the resident tiles'.
constexpr int kDkdvSmem =
    1024 + 2 * kResTile + kStages * (2 * kTile + 2 * kWin * 4) + (2 * kStages + 1) * 8;
// Q, dO resident; the ring's K and V tiles; the barriers.
constexpr int kDqSmem = 1024 + 2 * kResTile + kStages * 2 * kTile + (2 * kStages + 1) * 8;

// Rows [r, r + 64) of an fp32 vector of `total` rows as one bulk copy, which
// wants 16-byte aligned addresses and sizes: the window starts at the
// 16-byte boundary at or below row r (row r lies `off` floats into it) and
// ends kWinBytes later or at the 16-byte boundary at or past the vector's
// end, on the same memory page as its last row.  What it holds past row
// r + 63, or past the head's rows, is never used unmasked.
struct Window {
  const void* src;
  unsigned bytes;
  int off;
};

__device__ __forceinline__ Window window(const float* v, long long r, long long total) {
  const unsigned long long a = reinterpret_cast<unsigned long long>(v + r);
  const unsigned long long start = a & ~15ull;
  const unsigned long long end = (reinterpret_cast<unsigned long long>(v + total) + 15) & ~15ull;
  const unsigned long long bytes = end - start < kWinBytes ? end - start : kWinBytes;
  return {reinterpret_cast<const void*>(start), static_cast<unsigned>(bytes),
          static_cast<int>((a - start) / 4)};
}

__device__ __forceinline__ void init_barriers(unsigned full0, unsigned empty0, unsigned res) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);   // the producer's arrive.expect_tx
      mbar_init(empty0 + 8 * s, 2);  // one arrival per consumer warpgroup
    }
    mbar_init(res, 1);
    mbar_init_fence();
  }
  __syncthreads();
}

// dK and dV of 128 keys, a consumer warpgroup per 64.  K and V are resident
// (A of S^T = K Q^T and dP^T = V dO^T); Q and dO stream past in tiles of 64
// queries with their lse and delta, B of those two products K-major and,
// read MN-major, of dV += P^T dO and dK += dS^T Q.  Under causal the stream
// starts at the block's first key.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkdv_bf16_kernel(const __grid_constant__ CUtensorMap map_q,
                               const __grid_constant__ CUtensorMap map_k,
                               const __grid_constant__ CUtensorMap map_v,
                               const __grid_constant__ CUtensorMap map_do,
                               const float* __restrict__ lse, const float* __restrict__ delta,
                               bf16* __restrict__ dk, bf16* __restrict__ dv, int heads,
                               int t_len, int tk_len, int causal, float scale) {
  constexpr int kNC = cols<D>() / 64;
  // S^T and dP^T over all 64 columns of a tile, the pad of D = 32 included
  // (zeros add nothing): one code, and one register allocation, for both
  constexpr int kW = cols<D>();
  extern __shared__ unsigned char dkdv_sm90_raw[];
  unsigned char* kres = align1024(dkdv_sm90_raw);
  unsigned char* vres = kres + kResTile;
  unsigned char* qst = vres + kResTile;         // kStages tiles of Q
  unsigned char* dost = qst + kStages * kTile;  // and of dO
  float* lse_s = reinterpret_cast<float*>(dost + kStages * kTile);  // [kStages][kWin]
  float* del_s = lse_s + kStages * kWin;
  const unsigned full0 = smem_addr(del_s + kStages * kWin);
  const unsigned empty0 = full0 + 8 * kStages, res_bar = empty0 + 8 * kStages;

  int bh, kb;  // kb = 0, the longest under causal, first
  block_coords(heads, (tk_len + kRes - 1) / kRes, bh, kb);
  const int k0 = kb * kRes;
  // causal: queries above the block's first key see none of its keys
  const int q_begin = causal ? k0 : 0;
  const int ntiles = q_begin < t_len ? (t_len - q_begin + kBS - 1) / kBS : 0;
  const long long rbase = static_cast<long long>(bh) * t_len;
  const long long rows = static_cast<long long>(heads) * t_len;
  init_barriers(full0, empty0, res_bar);

  // the warpgroup, broadcast from lane 0 so that the compiler sees it
  // uniform in the warp: branches on it around wgmma do not serialize them
  const int wg = __shfl_sync(kFullMask, threadIdx.x / 128, 0);
  if (wg == 0) {
    // ------------------------------------------------------------ producer
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(res_bar, 2 * kResTile);
      tma_load(smem_addr(kres), &map_k, res_bar, 0, k0, bh);
      tma_load(smem_addr(vres), &map_v, res_bar, 0, k0, bh);
      for (int it = 0; it < ntiles; ++it) {
        const int s = it % kStages;
        mbar_wait(empty0 + 8 * s, ((it / kStages) & 1) ^ 1);  // passes at once on lap 0
        const int q0 = q_begin + it * kBS;
        const Window wl = window(lse, rbase + q0, rows), wd = window(delta, rbase + q0, rows);
        const unsigned full = full0 + 8 * s;
        mbar_expect_tx(full, 2 * kTile + wl.bytes + wd.bytes);
        tma_load(smem_addr(qst + s * kTile), &map_q, full, 0, q0, bh);
        tma_load(smem_addr(dost + s * kTile), &map_do, full, 0, q0, bh);
        bulk_load(smem_addr(lse_s + s * kWin), wl.src, wl.bytes, full);
        bulk_load(smem_addr(del_s + s * kWin), wd.src, wd.bytes, full);
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    setmaxnreg_inc<kConsumerRegs>();
    const int cw = wg - 1;
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, c = lane % 4;
    const bool leader = tid == 0;
    const int kw = k0 + cw * 64;
    const int key0 = kw + warp * 16 + g, key1 = key0 + 8;
    const float sl2 = scale * kLog2e;
    const float inf = __int_as_float(0x7f800000);
    float dka[kNC][32], dva[kNC][32];
    zero_acc<D>(dka);
    zero_acc<D>(dva);
    // under causal the warpgroup skips the first tiles, whose queries all
    // lie above its keys: it frees their stages as they land
    const int first = causal ? min(ntiles, (kw - q_begin) / kBS) : 0;
    for (int it = 0; it < first; ++it) {
      mbar_wait(full0 + 8 * (it % kStages), (it / kStages) & 1);
      if (leader) mbar_arrive(empty0 + 8 * (it % kStages));
    }
    mbar_wait(res_bar, 0);

    for (int it = first; it < ntiles; ++it) {
      const int s = it % kStages;
      mbar_wait(full0 + 8 * s, (it / kStages) & 1);
      const int q0 = q_begin + it * kBS;
      const unsigned char* qs = qst + s * kTile;
      const unsigned char* dos = dost + s * kTile;

      // this thread's 16 queries' -lse log2(e) and delta; pad queries take
      // -inf and 0, so their p and ds are 0
      const float* ls = lse_s + s * kWin + window(lse, rbase + q0, rows).off;
      const float* dl = del_s + s * kWin + window(delta, rbase + q0, rows).off;
      float nl[kBS / 4], dlt[kBS / 4];
#pragma unroll
      for (int j = 0; j < kBS / 4; ++j) {
        const int col = 8 * (j / 2) + 2 * c + (j & 1);
        const bool ok = q0 + col < t_len;
        nl[j] = ok ? -(ls[col] * kLog2e) : -inf;
        dlt[j] = ok ? dl[col] : 0.f;
      }

      // S^T = K Q^T and dP^T = V dO^T, [64 keys x 64 queries], two groups
      float st[kBS / 2], dpt[kBS / 2];
      wgmma_fence();
      product_ss<kW, kBS>(st, kres, kRes, cw * 64, qs);
      wgmma_commit();
      product_ss<kW, kBS>(dpt, vres, kRes, cw * 64, dos);
      wgmma_commit();

      wgmma_wait_group<1>();  // S^T
      reg_fence(st);
      const bool diag = causal && q0 < kw + 63;  // the tile crosses the diagonal
#pragma unroll
      for (int i = 0; i < kBS / 2; ++i) {
        const int j = 2 * (i / 4) + (i & 1);
        float p = ex2(fmaf(st[i], sl2, nl[j]));
        if (diag && ((i & 2) ? key1 : key0) > q0 + 8 * (i / 4) + 2 * c + (i & 1)) p = 0.f;
        st[i] = p;
      }
      unsigned pa[kBS / 16][4], da[kBS / 16][4];
      to_frags<kBS>(st, pa);

      wgmma_wait_group<0>();  // dP^T
      reg_fence(dpt);
#pragma unroll
      for (int i = 0; i < kBS / 2; ++i)
        dpt[i] = st[i] * (dpt[i] - dlt[2 * (i / 4) + (i & 1)]) * scale;
      to_frags<kBS>(dpt, da);

      // dV += P^T dO, dK += dS^T Q, waited for before the next tile: left
      // in flight across it, they make ptxas serialize every wgmma of the
      // pass (C7515)
      wgmma_fence();
      product_rs<D, kBS>(dva, pa, dos);
      product_rs<D, kBS>(dka, da, qs);
      wgmma_commit();
      wgmma_wait_group<0>();
      if (leader) mbar_arrive(empty0 + 8 * s);
    }

#pragma unroll
    for (int n = 0; n < kNC; ++n) {
      reg_fence(dka[n]);
      reg_fence(dva[n]);
    }
    const long long kbase = static_cast<long long>(bh) * tk_len * D;
    store_rows<D>(dk + kbase, dka, key0, key1, tk_len, c);
    store_rows<D>(dv + kbase, dva, key0, key1, tk_len, c);
  }
}

// dQ of 128 queries, a consumer warpgroup per 64.  Q and dO are resident (A
// of S = Q K^T and dP = dO V^T); K and V stream past in tiles of 64 keys, B
// of those two products K-major and K, read MN-major, B of dQ += dS K.
// Under causal the stream stops at the block's last query.  lse and delta
// are two rows a thread, read once.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_bf16_kernel(const __grid_constant__ CUtensorMap map_q,
                             const __grid_constant__ CUtensorMap map_k,
                             const __grid_constant__ CUtensorMap map_v,
                             const __grid_constant__ CUtensorMap map_do,
                             const float* __restrict__ lse, const float* __restrict__ delta,
                             bf16* __restrict__ dq, int heads, int t_len, int tk_len,
                             int causal, float scale) {
  constexpr int kNC = cols<D>() / 64;
  constexpr int kW = cols<D>();  // S and dP over the whole tile, as above
  extern __shared__ unsigned char dq_sm90_raw[];
  unsigned char* qres = align1024(dq_sm90_raw);
  unsigned char* dores = qres + kResTile;
  unsigned char* kst = dores + kResTile;      // kStages tiles of K
  unsigned char* vst = kst + kStages * kTile;  // and of V
  const unsigned full0 = smem_addr(vst + kStages * kTile);
  const unsigned empty0 = full0 + 8 * kStages, res_bar = empty0 + 8 * kStages;

  const int nqb = (t_len + kRes - 1) / kRes;
  int bh, order;
  block_coords(heads, nqb, bh, order);
  const int q0 = (nqb - 1 - order) * kRes;  // the bottom (longest) row blocks first
  const int k_end = causal ? min(q0 + kRes, tk_len) : tk_len;
  const int ntiles = (k_end + kBS - 1) / kBS;
  init_barriers(full0, empty0, res_bar);

  const int wg = __shfl_sync(kFullMask, threadIdx.x / 128, 0);
  if (wg == 0) {
    // ------------------------------------------------------------ producer
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(res_bar, 2 * kResTile);
      tma_load(smem_addr(qres), &map_q, res_bar, 0, q0, bh);
      tma_load(smem_addr(dores), &map_do, res_bar, 0, q0, bh);
      for (int it = 0; it < ntiles; ++it) {
        const int s = it % kStages;
        mbar_wait(empty0 + 8 * s, ((it / kStages) & 1) ^ 1);
        const unsigned full = full0 + 8 * s;
        mbar_expect_tx(full, 2 * kTile);
        tma_load(smem_addr(kst + s * kTile), &map_k, full, 0, it * kBS, bh);
        tma_load(smem_addr(vst + s * kTile), &map_v, full, 0, it * kBS, bh);
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    setmaxnreg_inc<kConsumerRegs>();
    const int cw = wg - 1;
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, c = lane % 4;
    const bool leader = tid == 0;
    const int qg = q0 + cw * 64;
    const int row0 = qg + warp * 16 + g, row1 = row0 + 8;
    const long long rbase = static_cast<long long>(bh) * t_len;
    const float inf = __int_as_float(0x7f800000);
    const float sl2 = scale * kLog2e;
    const float nl0 = row0 < t_len ? -lse[rbase + row0] * kLog2e : -inf;
    const float nl1 = row1 < t_len ? -lse[rbase + row1] * kLog2e : -inf;
    const float del0 = row0 < t_len ? delta[rbase + row0] : 0.f;
    const float del1 = row1 < t_len ? delta[rbase + row1] : 0.f;
    float dqa[kNC][32];
    zero_acc<D>(dqa);
    // under causal the warpgroup skips the last tiles, whose keys all lie
    // past its queries: it frees their stages as they land (after the loop)
    const int last = causal ? min(ntiles, qg / kBS + 1) : ntiles;
    int held = -1;  // the stage whose dQ accumulation is still in flight
    mbar_wait(res_bar, 0);

    for (int it = 0; it < last; ++it) {
      const int s = it % kStages;
      mbar_wait(full0 + 8 * s, (it / kStages) & 1);
      const int kt0 = it * kBS;
      const unsigned char* ks = kst + s * kTile;

      // S = Q K^T and dP = dO V^T, [64 queries x 64 keys], two groups
      float st[kBS / 2], dp[kBS / 2];
      wgmma_fence();
      product_ss<kW, kBS>(st, qres, kRes, cw * 64, ks);
      wgmma_commit();
      product_ss<kW, kBS>(dp, dores, kRes, cw * 64, vst + s * kTile);
      wgmma_commit();

      wgmma_wait_group<1>();  // S, and the previous tile's dQ accumulation
      reg_fence(st);
      if (held >= 0 && leader) mbar_arrive(empty0 + 8 * held);
      held = s;
      const bool masked = kt0 + kBS > tk_len || (causal && kt0 + kBS - 1 > qg);
#pragma unroll
      for (int i = 0; i < kBS / 2; ++i) {
        const int kj = kt0 + 8 * (i / 4) + 2 * c + (i & 1);
        const int qi = (i & 2) ? row1 : row0;
        float p = ex2(fmaf(st[i], sl2, (i & 2) ? nl1 : nl0));
        if (masked && ((causal && kj > qi) || kj >= tk_len)) p = 0.f;
        st[i] = p;
      }

      wgmma_wait_group<0>();  // dP
      reg_fence(dp);
#pragma unroll
      for (int i = 0; i < kBS / 2; ++i) dp[i] = st[i] * (dp[i] - ((i & 2) ? del1 : del0)) * scale;
      unsigned da[kBS / 16][4];
      to_frags<kBS>(dp, da);

      // dQ += dS K, issued without a wait (ptxas waits for it before the
      // next iteration); its stage is freed by the next tile
      wgmma_fence();
      product_rs<D, kBS>(dqa, da, ks);
      wgmma_commit();
    }

    wgmma_wait_group<0>();
    if (held >= 0 && leader) mbar_arrive(empty0 + 8 * held);
    for (int it = last; it < ntiles; ++it) {
      mbar_wait(full0 + 8 * (it % kStages), (it / kStages) & 1);
      if (leader) mbar_arrive(empty0 + 8 * (it % kStages));
    }
#pragma unroll
    for (int n = 0; n < kNC; ++n) reg_fence(dqa[n]);
    store_rows<D>(dq + static_cast<long long>(bh) * t_len * D, dqa, row0, row1, t_len, c);
  }
}

template <int D>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* dout,
                       const float* lse, const float* delta, bf16* dq, bf16* dk, bf16* dv,
                       int bh, int t_len, int tk_len, int causal, float scale,
                       cudaStream_t stream) {
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return cudaErrorSymbolNotFound;
  // the dK/dV pass keeps K, V resident and streams Q, dO; the dQ pass the
  // other way round
  const bool dkdv = dk != nullptr;
  const int qrows = dkdv ? kBS : kRes, krows = dkdv ? kRes : kBS;
  CUtensorMap mq, mk, mv, mdo;
  if (!encode_rows(fn, &mq, q, bh, t_len, D, qrows) ||
      !encode_rows(fn, &mdo, dout, bh, t_len, D, qrows) ||
      !encode_rows(fn, &mk, k, bh, tk_len, D, krows) ||
      !encode_rows(fn, &mv, v, bh, tk_len, D, krows))
    return cudaErrorInvalidValue;
  if (dkdv) {
    static bool attr = false;
    cudaError_t err = allow_smem(flash_bwd_dkdv_bf16_kernel<D>, kDkdvSmem, attr);
    if (err != cudaSuccess) return err;
    const int grid = bh * ((tk_len + kRes - 1) / kRes);
    flash_bwd_dkdv_bf16_kernel<D><<<grid, kThreads, kDkdvSmem, stream>>>(
        mq, mk, mv, mdo, lse, delta, dk, dv, bh, t_len, tk_len, causal, scale);
  } else {
    static bool attr = false;
    cudaError_t err = allow_smem(flash_bwd_dq_bf16_kernel<D>, kDqSmem, attr);
    if (err != cudaSuccess) return err;
    const int grid = bh * ((t_len + kRes - 1) / kRes);
    flash_bwd_dq_bf16_kernel<D><<<grid, kThreads, kDqSmem, stream>>>(
        mq, mk, mv, mdo, lse, delta, dq, bh, t_len, tk_len, causal, scale);
  }
  return cudaGetLastError();
}

int dispatch_bwd(const void* q, const void* k, const void* v, const void* dout,
                 const float* lse, const float* delta, void* dq, void* dk, void* dv, int bsz,
                 int heads, int t_len, int tk_len, int head_dim, int causal, float scale,
                 void* stream) {
  if (bsz <= 0 || heads <= 0 || t_len <= 0 || tk_len <= 0)
    return static_cast<int>(cudaGetLastError());
  auto* dq_ = static_cast<bf16*>(dq);
  auto* dk_ = static_cast<bf16*>(dk);
  auto* dv_ = static_cast<bf16*>(dv);
  const int bh = bsz * heads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 32:
      return static_cast<int>(launch_bwd<32>(q, k, v, dout, lse, delta, dq_, dk_, dv_, bh,
                                             t_len, tk_len, causal, scale, s));
    case 64:
      return static_cast<int>(launch_bwd<64>(q, k, v, dout, lse, delta, dq_, dk_, dv_, bh,
                                             t_len, tk_len, causal, scale, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// The backward's two passes on bf16.  q, dout: contiguous bf16 [B, H, T, D];
// k, v: [B, H, Tk, D], all 16-byte aligned; lse (from mxtpu_flash_fwd_bf16)
// and delta = rowsum(dout * o) in fp32: fp32 [B, H, T].
// mxtpu_flash_bwd_dkdv_bf16 writes bf16 dk, dv [B, H, Tk, D];
// mxtpu_flash_bwd_dq_bf16 writes bf16 dq [B, H, T, D].  head_dim 32 or 64
// (128 takes flash_bf16.cu's _v1 entries).  causal masks key j from query i
// when j > i.
MXTPU_API int mxtpu_flash_bwd_dkdv_bf16(const void* q, const void* k, const void* v,
                                        const void* dout, const float* lse, const float* delta,
                                        void* dk, void* dv, int bsz, int heads, int t_len,
                                        int tk_len, int head_dim, int causal, float scale,
                                        void* stream) {
  return dispatch_bwd(q, k, v, dout, lse, delta, nullptr, dk, dv, bsz, heads, t_len, tk_len,
                      head_dim, causal, scale, stream);
}

MXTPU_API int mxtpu_flash_bwd_dq_bf16(const void* q, const void* k, const void* v,
                                      const void* dout, const float* lse, const float* delta,
                                      void* dq, int bsz, int heads, int t_len, int tk_len,
                                      int head_dim, int causal, float scale, void* stream) {
  return dispatch_bwd(q, k, v, dout, lse, delta, dq, nullptr, nullptr, bsz, heads, t_len,
                      tk_len, head_dim, causal, scale, stream);
}
