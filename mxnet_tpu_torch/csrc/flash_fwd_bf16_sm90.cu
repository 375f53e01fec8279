// The flash attention forward in bf16 for Hopper, with a TMA producer warp,
// an mbarrier ring and each consumer warpgroup's softmax running under its
// next Q K^T (flash_fwd_bf16_kernel): bf16 q, k, v, o with fp32 lse, head
// dims 32 and 64.
//
// It replaces the Pallas flash forward of the JAX package's training path on
// bf16 inputs (mxnet_tpu/ops/attention.py _flash_fwd_pallas at :281 with
// return_lse=True, its pallas_call at :330, the kernel body _flash_kernel at
// :194).  What it computes is what flash_bf16.cu's first forward (the _v1
// kernel, which keeps head dim 128) computes, bit for bit: S = q k^T from
// bf16 operands with fp32 sums; the causal mask and the ragged key tail; the
// online softmax in fp32 over tiles of 64 keys, p rounded to bf16 before
// P V; o divided by l and rounded to bf16 once; lse = m + log l in fp32.
//
// What bounds it on an H100: at the bench LM's shape (B = 8, 16 heads,
// T = 2048, D = 64, causal) it does 4 * D * B * H * T(T+1)/2 = 68.7 GFLOP
// against 67 MB of q, k, v, o and lse: 0.0695 ms at the dense bf16
// tensor-core rate (989 TFLOP/s) against 0.020 ms of bytes, so it is bound
// by operations.  Its softmax is about as large: 277 M scores (tiles of 64
// by 64 up to the diagonal), one ex2 each at the SFUs' 16 an SM a clock,
// take about 0.07 ms too.  The first design reached 30% of the bound: all
// its threads loaded every tile and met at a __syncthreads() per tile, and
// each warpgroup waited for every product as soon as it was issued, so its
// tensor cores idled through the mask, the max, the exponentials and the
// sums, filled only by a second block on the SM.
//
// Design.  A block is four warpgroups, one an SM, persistent: warpgroup 0
// the producer, lowered to 24 registers a thread (setmaxnreg.dec), of which
// one thread issues every load; warpgroups 1-3 the consumers, raised to 160
// (setmaxnreg.inc), each owning 64 of a unit's 192 queries.
// * Units.  A unit is one head's 192 queries.  The blocks claim units from
//   a counter in global memory (`units`, two ints the caller keeps per
//   stream, which each launch leaves zero) in the order of unit_coords: a
//   group of kHeadGroup heads at a time, so that the K and V the running
//   units stream stay in L2, and the longest units (under causal) first
//   within a group.  A grid of one block per unit spent a few microseconds
//   a block starting and ending it, which nothing overlapped.
// * Loads.  Q comes by TMA into one of two tiles, so that the next unit's
//   lands while this one's ends; K and V stream by TMA through one ring of
//   kStages stages of 64 keys across the units.  Each stage has a "full"
//   mbarrier for K and another for V (the producer's arrive.expect_tx plus
//   the bytes), so that S can start before V lands, and an "empty" one
//   (one arrival per consumer warpgroup).  The tensor maps are 3-D,
//   [B*H, T, D] with boxes [1, rows, 64]: rows past a head's end and the
//   pad columns of D = 32 read as zero.  No consumer thread loads a tile,
//   and after the barriers are set up no __syncthreads() runs.
// * Overlap.  A consumer runs a one-tile software pipeline: it commits
//   S_{j+1} = Q K_{j+1}^T, then O += P_j V_j, waits for S_{j+1} alone
//   (wgmma.wait_group 1) and does tile j+1's mask, max, exponentials and
//   sums while P_j V_j still runs; then it waits for that group, rescales O
//   by alpha_{j+1}, turns S_{j+1} into P_{j+1}'s bf16 fragments and frees
//   stage j.  Nothing stays in flight across the loop's back edge (ptxas
//   serializes every wgmma of a loop that leaves an accumulation in flight
//   there, C7515), and no register the products read is written between
//   their issue and their wait (C7513).  The consumers issue their products
//   in turn (a ping-pong over named barriers), so that one's products run
//   under another's softmax.  A consumer's registers (O, S, one set of P
//   fragments) fit the 128 a thread starts with at 512 threads, the budget
//   ptxas plans wgmma pipelines in.
// * Sums.  The key tile stays at 64 and O sums in the wgmma accumulator,
//   updated as acc * alpha_j + P_j V_j in the first design's sequence, so o
//   and lse are the _v1 kernel's bits.
// * Tiles.  Each tile is stored once, row-major in 128-byte swizzled atoms
//   of 64 columns, the layout TMA's 128-byte swizzle writes and the wgmma
//   descriptors name: K serves as the K-major B of Q K^T and V, read
//   MN-major with the instruction's transpose bit, as the B of P V.  P goes
//   from the S accumulator to bf16 A fragments in registers.
// * Masks.  Only tiles that cross the diagonal or the end of the keys are
//   masked; under causal, tiles wholly above a warpgroup's queries are not
//   multiplied, their stages freed as they land.

#include <cuda.h>
#include <cuda_bf16.h>

#include "common.h"
#include "flash_bf16.h"
#include "sm90.h"

namespace {

using namespace mxtpu;

constexpr int kConsumers = 3;                     // warpgroups 1-3
constexpr int kThreads = 128 * (kConsumers + 1);  // warpgroup 0 the producer
constexpr int kRes = 64 * kConsumers;             // queries of a unit
constexpr int kBK = 64;                           // keys of a streamed tile
constexpr int kStages = 6;                        // the ring
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 160;
static_assert(128 * kProducerRegs + 128 * kConsumers * kConsumerRegs <= 65536,
              "the warpgroups' registers exceed the SM's");
constexpr int kTile = kBK * 128;    // a K or V tile: 64 columns of bf16 (D = 32 padded)
constexpr int kQTile = kRes * 128;  // a Q tile
// Two Q tiles; the ring's K and V tiles; the Q tiles' units; the barriers
// full_k[kStages], full_v[kStages], empty[kStages], q_full[2], q_empty[2].
constexpr int kSmem = 1024 + 2 * kQTile + kStages * 2 * kTile + 8 + (3 * kStages + 4) * 8;

// O's accumulator and the P fragments of P V, pinned at this point of the
// instruction stream: before a wgmma fence, every write of them lands
// before the products that read them; after the wait that retires those
// products, no read of O moves above it and no other value takes the
// fragments' registers while the products still read them.
template <int D>
__device__ __forceinline__ void fence_operands(float (&acc)[cols<D>() / 64][32],
                                               unsigned (&a)[kBK / 16][4]) {
#pragma unroll
  for (int n = 0; n < cols<D>() / 64; ++n) reg_fence(acc[n]);
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[kk][j])::"memory");
}

// The consumers' turns to issue products (ping-pong): consumer cw waits on
// named barrier 1 + cw, which the one before it arrives on once it has
// issued its own.  Every consumer takes ntiles + 1 turns a unit, so none
// waits for a turn that never comes.
__device__ __forceinline__ void turn_wait(int cw) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(1 + cw) : "memory");
}
__device__ __forceinline__ void turn_pass(int cw) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(1 + (cw + 1) % kConsumers) : "memory");
}

// One tile's step of the online softmax for this thread's rows row0 and
// row1, as the first design takes it: the mask (when `masked`; a masked
// score is -1e30, its p exactly 0), the running max m of the unscaled
// scores, p = 2^(s * scale * log2(e) - m * scale * log2(e)) in place of s,
// the sum l, and alpha, the factor of the earlier sums.
__device__ __forceinline__ void softmax_tile(float (&s)[kBK / 2], bool masked, int k0,
                                             int row0, int row1, int c, int tk_len,
                                             int causal, float sl2, float& m0, float& m1,
                                             float& l0, float& l1, float& alpha0,
                                             float& alpha1) {
  if (masked) {
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i) {
      const int kj = k0 + 8 * (i / 4) + 2 * c + (i & 1);
      const int qi = (i & 2) ? row1 : row0;
      if ((causal && kj > qi) || kj >= tk_len) s[i] = kNegInf;
    }
  }
  float mx0 = m0, mx1 = m1;
#pragma unroll
  for (int j = 0; j < kBK / 8; ++j) {
    mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
    mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
  mx0 = quad_max(mx0);
  mx1 = quad_max(mx1);
  alpha0 = ex2((m0 - mx0) * sl2);
  alpha1 = ex2((m1 - mx1) * sl2);
  const float nm0 = -mx0 * sl2, nm1 = -mx1 * sl2;
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int i = 0; i < kBK / 2; ++i) {
    const float p = ex2(fmaf(s[i], sl2, (i & 2) ? nm1 : nm0));
    s[i] = p;
    if (i & 2) sum1 += p; else sum0 += p;
  }
  l0 = l0 * alpha0 + sum0;
  l1 = l1 * alpha1 + sum1;
  m0 = mx0;
  m1 = mx1;
}

// The streamed tiles of the unit whose queries start at q0: every key, or
// under causal the keys up to its last query.
__device__ __forceinline__ int unit_tiles(int q0, int tk_len, int causal) {
  return ((causal ? min(q0 + kRes, tk_len) : tk_len) + kBK - 1) / kBK;
}

// o and lse of units of kRes queries of one head, a consumer warpgroup per
// 64.  Q is resident (A of S = Q K^T), two tiles of it so that the next
// unit's lands while this one's ends; K and V stream past in tiles of 64
// keys, through one ring across the units.  One block an SM, claiming
// units in the launch order of unit_coords (the longest first within a
// group of heads) from units[0] as it goes.  units[0] counts the units
// claimed so far and units[1] the blocks that have claimed past the last
// unit: the last of those sets both back to zero, so every launch starts
// from zero.  Two launches that may run at once (on two streams) need two
// buffers.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_bf16_kernel(const __grid_constant__ CUtensorMap map_q,
                          const __grid_constant__ CUtensorMap map_k,
                          const __grid_constant__ CUtensorMap map_v, bf16* __restrict__ o,
                          float* __restrict__ lse, int* __restrict__ units, int heads,
                          int t_len, int tk_len, int causal, float scale) {
  constexpr int kNC = cols<D>() / 64;  // 64-column accumulators of O
  extern __shared__ unsigned char fwd_sm90_raw[];
  unsigned char* qres = align1024(fwd_sm90_raw);  // two Q tiles
  unsigned char* kst = qres + 2 * kQTile;         // kStages tiles of K
  unsigned char* vst = kst + kStages * kTile;     // and of V
  int* unit_s = reinterpret_cast<int*>(vst + kStages * kTile);  // the Q tiles' units
  const unsigned fullk0 = smem_addr(unit_s + 2);
  const unsigned fullv0 = fullk0 + 8 * kStages, empty0 = fullv0 + 8 * kStages;
  const unsigned qfull0 = empty0 + 8 * kStages, qempty0 = qfull0 + 16;

  const int nqb = (t_len + kRes - 1) / kRes;
  const int nunits = heads * nqb;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(fullk0 + 8 * s, 1);  // the producer's arrive.expect_tx
      mbar_init(fullv0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kConsumers);  // one arrival per consumer warpgroup
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(qfull0 + 8 * b, 1);
      mbar_init(qempty0 + 8 * b, kConsumers);
    }
    mbar_init_fence();
  }
  __syncthreads();

  // the warpgroup, broadcast from lane 0 so that the compiler sees it
  // uniform in the warp: branches on it around wgmma do not serialize them
  const int wg = __shfl_sync(kFullMask, threadIdx.x / 128, 0);
  if (wg == 0) {
    // ------------------------------------------------------------ producer
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      int tile = 0;  // tiles issued into the ring
      for (int i = 0;; ++i) {
        // the unit of Q tile b, once the consumers are done with its last
        const int b = i & 1;
        mbar_wait(qempty0 + 8 * b, ((i >> 1) & 1) ^ 1);  // passes at once on lap 0
        const int u = atomicAdd(&units[0], 1);
        unit_s[b] = u;
        if (u >= nunits) {  // the consumers read it and stop
          mbar_arrive(qfull0 + 8 * b);
          break;
        }
        int bh, order;
        unit_coords(u, heads, nqb, bh, order);
        const int q0 = (nqb - 1 - order) * kRes;  // the bottom (longest) row blocks first
        mbar_expect_tx(qfull0 + 8 * b, kQTile);
        tma_load(smem_addr(qres + b * kQTile), &map_q, qfull0 + 8 * b, 0, q0, bh);
        const int ntiles = unit_tiles(q0, tk_len, causal);
        for (int it = 0; it < ntiles; ++it, ++tile) {
          const int s = tile % kStages;
          mbar_wait(empty0 + 8 * s, ((tile / kStages) & 1) ^ 1);
          mbar_expect_tx(fullk0 + 8 * s, kTile);
          tma_load(smem_addr(kst + s * kTile), &map_k, fullk0 + 8 * s, 0, it * kBK, bh);
          mbar_expect_tx(fullv0 + 8 * s, kTile);
          tma_load(smem_addr(vst + s * kTile), &map_v, fullv0 + 8 * s, 0, it * kBK, bh);
        }
      }
      if (atomicAdd(&units[1], 1) == static_cast<int>(gridDim.x) - 1) {
        atomicExch(&units[0], 0);
        atomicExch(&units[1], 0);
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    setmaxnreg_inc<kConsumerRegs>();
    const int cw = wg - 1;
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, c = lane % 4;
    const bool leader = tid == 0;
    const float sl2 = scale * kLog2e;
    if (cw == kConsumers - 1) turn_pass(cw);  // the first turn is warpgroup 0's
    int tile = 0;  // tiles taken from the ring
    for (int i = 0;; ++i) {
      const int b = i & 1;
      mbar_wait(qfull0 + 8 * b, (i >> 1) & 1);
      const int u = __shfl_sync(kFullMask, unit_s[b], 0);  // uniform, as wg above
      if (u >= nunits) break;
      int bh, order;
      unit_coords(u, heads, nqb, bh, order);
      const int q0 = (nqb - 1 - order) * kRes;
      const int ntiles = unit_tiles(q0, tk_len, causal);
      const unsigned char* qt = qres + b * kQTile;
      const int qg = q0 + cw * 64;
      const int row0 = qg + warp * 16 + g, row1 = row0 + 8;
      // under causal the warpgroup stops at the tile that holds its last
      // query's key: the unit's later tiles are freed as they land; a
      // warpgroup wholly past the queries only frees them
      const int last = qg >= t_len ? 0 : causal ? min(ntiles, qg / kBK + 1) : ntiles;
      float acc[kNC][32];
      zero_acc<D>(acc);
      // running max of the unscaled scores, and sum of p, of rows 0 and 1
      float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
      unsigned pa[kBK / 16][4];  // P of the tile whose P V is next

      if (last > 0) {  // tile 0: S_0 and its softmax; O is zero, so its rescale is dropped
        float s[kBK / 2], alpha0, alpha1;
        const int st = tile % kStages;
        mbar_wait(fullk0 + 8 * st, (tile / kStages) & 1);
        turn_wait(cw);
        wgmma_fence();
        product_ss<D, kBK>(s, qt, kRes, cw * 64, kst + st * kTile);
        wgmma_commit();
        turn_pass(cw);
        wgmma_wait_group<0>();
        reg_fence(s);
        softmax_tile(s, kBK > tk_len || (causal && kBK - 1 > qg), 0, row0, row1, c, tk_len,
                     causal, sl2, m0, m1, l0, l1, alpha0, alpha1);
        to_frags<kBK>(s, pa);
      }

      for (int it = 0; it + 1 < last; ++it) {
        const int s_cur = (tile + it) % kStages, s_next = (tile + it + 1) % kStages;
        const int k0 = (it + 1) * kBK;
        mbar_wait(fullk0 + 8 * s_next, ((tile + it + 1) / kStages) & 1);
        mbar_wait(fullv0 + 8 * s_cur, ((tile + it) / kStages) & 1);

        // S_{j+1} = Q K_{j+1}^T, then O += P_j V_j: two groups.  O's
        // rescale and P_j's fragments are fenced in before them: moved in
        // between the two groups, they make ptxas serialize every wgmma
        // (C7513)
        float s[kBK / 2], alpha0, alpha1;
        fence_operands<D>(acc, pa);
        turn_wait(cw);
        wgmma_fence();
        product_ss<D, kBK>(s, qt, kRes, cw * 64, kst + s_next * kTile);
        wgmma_commit();
        product_rs<D, kBK>(acc, pa, vst + s_cur * kTile);
        wgmma_commit();
        turn_pass(cw);

        wgmma_wait_group<1>();  // S_{j+1}; P_j V_j still runs under its softmax
        reg_fence(s);
        softmax_tile(s, k0 + kBK > tk_len || (causal && k0 + kBK - 1 > qg), k0, row0, row1,
                     c, tk_len, causal, sl2, m0, m1, l0, l1, alpha0, alpha1);

        // P_j V_j, then O's rescale and P_{j+1}'s fragments, which take
        // P_j's registers (written before the wait, they make ptxas
        // serialize every wgmma, C7513)
        wgmma_wait_group<0>();
        fence_operands<D>(acc, pa);
#pragma unroll
        for (int n = 0; n < kNC; ++n)
#pragma unroll
          for (int j = 0; j < 32; ++j) acc[n][j] *= (j & 2) ? alpha1 : alpha0;
        to_frags<kBK>(s, pa);
        if (leader) mbar_arrive(empty0 + 8 * s_cur);
      }
      if (leader) mbar_arrive(qempty0 + 8 * b);  // every S of the unit has retired

      if (last > 0) {  // the last tile's P V
        const int s_last = (tile + last - 1) % kStages;
        mbar_wait(fullv0 + 8 * s_last, ((tile + last - 1) / kStages) & 1);
        fence_operands<D>(acc, pa);
        turn_wait(cw);
        wgmma_fence();
        product_rs<D, kBK>(acc, pa, vst + s_last * kTile);
        wgmma_commit();
        turn_pass(cw);
        wgmma_wait_group<0>();
        fence_operands<D>(acc, pa);
        if (leader) mbar_arrive(empty0 + 8 * s_last);
      }
      for (int it = last; it < ntiles; ++it) {
        const int s = (tile + it) % kStages;
        mbar_wait(fullk0 + 8 * s, ((tile + it) / kStages) & 1);
        mbar_wait(fullv0 + 8 * s, ((tile + it) / kStages) & 1);
        if (leader) mbar_arrive(empty0 + 8 * s);
        turn_wait(cw);  // every warpgroup takes ntiles + 1 turns a unit
        turn_pass(cw);
      }
      if (last == 0) {
        turn_wait(cw);
        turn_pass(cw);
      }
      tile += ntiles;
      if (last == 0) continue;

      l0 = quad_sum(l0);
      l1 = quad_sum(l1);
      const float inv0 = 1.f / (l0 == 0.f ? 1.f : l0), inv1 = 1.f / (l1 == 0.f ? 1.f : l1);
      store_rows<D>(o + static_cast<long long>(bh) * t_len * D, acc, row0, row1, t_len, c,
                    inv0, inv1);
      // natural log of the row's softmax denominator over the scaled scores
      if (lse != nullptr && c == 0) {
        const long long rbase = static_cast<long long>(bh) * t_len;
        if (row0 < t_len) lse[rbase + row0] = m0 * scale + logf(l0);
        if (row1 < t_len) lse[rbase + row1] = m1 * scale + logf(l1);
      }
    }
  }
}

template <int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, bf16* o, float* lse,
                       int* units, int bh, int t_len, int tk_len, int causal, float scale,
                       cudaStream_t stream) {
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return cudaErrorSymbolNotFound;
  CUtensorMap mq, mk, mv;
  if (!encode_rows(fn, &mq, q, bh, t_len, D, kRes) ||
      !encode_rows(fn, &mk, k, bh, tk_len, D, kBK) ||
      !encode_rows(fn, &mv, v, bh, tk_len, D, kBK))
    return cudaErrorInvalidValue;
  static bool attr = false;
  cudaError_t err = allow_smem(flash_fwd_bf16_kernel<D>, kSmem, attr);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  const int grid = min(sms, bh * ((t_len + kRes - 1) / kRes));
  flash_fwd_bf16_kernel<D><<<grid, kThreads, kSmem, stream>>>(mq, mk, mv, o, lse, units, bh,
                                                              t_len, tk_len, causal, scale);
  return cudaGetLastError();
}

}  // namespace

// The forward on bf16.  q, o: contiguous bf16 [B, H, T, D]; k, v: [B, H, Tk,
// D], all 16-byte aligned; lse: fp32 [B, H, T] or nullptr; units: two
// zero ints on the device, which the launch leaves zero and which no launch
// running at the same time uses.  head_dim 32 or 64 (128 takes
// flash_bf16.cu's _v1 entry).  causal masks key j from query i when j > i.
MXTPU_API int mxtpu_flash_fwd_bf16(const void* q, const void* k, const void* v, void* o,
                                   float* lse, int* units, int bsz, int heads, int t_len,
                                   int tk_len, int head_dim, int causal, float scale,
                                   void* stream) {
  if (bsz <= 0 || heads <= 0 || t_len <= 0 || tk_len <= 0)
    return static_cast<int>(cudaGetLastError());
  if (units == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  auto* o_ = static_cast<bf16*>(o);
  const int bh = bsz * heads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 32:
      return static_cast<int>(
          launch_fwd<32>(q, k, v, o_, lse, units, bh, t_len, tk_len, causal, scale, s));
    case 64:
      return static_cast<int>(
          launch_fwd<64>(q, k, v, o_, lse, units, bh, t_len, tk_len, causal, scale, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
