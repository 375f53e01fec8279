// The SGD-momentum step, fp32, for sm_90a.
//
// Replaces the Pallas kernel of mxnet_tpu/ops/fused/optimizer_kernels.py
// (fused_sgd_mom_update, _sgd_mom_kernel) and, with one launch over every
// parameter, the whole-tree step the trainer takes (parallel/trainer.py
// fused_sgd_mom_tree):
//   mxtpu_sgd_mom_update     one tensor: w, g, m in; w', m' out (may alias
//                            w, m); the caller gives the grid
//   mxtpu_sgd_mom_multi      a device table of (w, g, m, n) over many tensors,
//                            updated in place, with an optional device flag
//                            `ok`: when *ok is false no element is written
//                            (skip_nonfinite keeps the old state)
//   mxtpu_sgd_mom_update_v1  the first design of the one-tensor step, kept
//                            for timing in turns
//
// What bounds it on an H100: per element it reads w, g and m and writes w and
// m (20 bytes) for 7 operations, so it is bound by bytes: the bench LM's
// 218.6 M parameters move 4.4 GB, about 1.3 ms at 3.35 TB/s.
//
// The one-tensor step runs once a parameter (Module.update), mostly on
// tensors of 1-4 M elements, where a streaming pass needs megabytes in flight
// to reach the memory rate.  Its design: the wrapper sizes the grid to the
// card (one block per kPerOpThreads * kPerOpUnroll float4 groups, at most a
// full wave of resident blocks, found by the occupancy API), each thread
// issues the streaming loads (evict-first) of kPerOpUnroll float4 groups of
// w, g and m before it computes any of them, and a grid-stride loop covers
// what one wave does not.  Each launch lets the next one on the stream start
// while it ends (programmatic dependent launch): a kernel waits
// (griddepcontrol.wait) before its first load until the grid before it is
// done and its writes are seen, then lets its own successor launch.  The
// constants were timed on the card at the bench LM's 126 parameter sizes
// (mxnet_tpu_torch/tools/sgd_mom_ab.py): at a full wave the resident threads
// keep enough bytes in flight with one float4 triple each, and more groups
// a thread only lower the occupancy and leave small tensors fewer blocks.
// Five pointers that share one misalignment mod 16 take a scalar head up to
// the boundary and then the vector path; any other mix is scalar.  The first
// design (one block a 64K-element chunk, one float4 triple a thread in
// flight) is mxtpu_sgd_mom_update_v1; the multi-tensor step keeps it: its
// table numbers chunks of kChunk elements, and each block finds its chunk's
// tensor by a binary search over the table's chunk offsets, so one launch
// covers the whole parameter list without a per-chunk table.
//
// The arithmetic is the JAX spelling (g * rescale, clip, m' = mu * m -
// lr * (g + wd * w), w' = w + m') with every operation rounded on its own
// (__fmul_rn and friends forbid fused multiply-adds), so the result has the
// same bits as the plain PyTorch version run on the card, on every route.

#include <cstdint>

#include "common.h"

namespace {

constexpr int kOptThreads = 256;
// elements per chunk; ops/fused/optimizer_kernels.py numbers the multi-tensor
// launch's chunks by the same constant (_CHUNK)
constexpr long long kChunk = 1 << 16;
// The one-tensor step: threads a block and float4 groups a thread keeps in
// flight (ops/fused/optimizer_kernels.py sizes the grid by the same two,
// _PER_OP_THREADS and _PER_OP_UNROLL)
constexpr int kPerOpThreads = 256;
constexpr int kPerOpUnroll = 1;
// launched with programmatic stream serialization: the next launch on the
// stream may start while this one ends, and waits (griddepcontrol.wait)
// before its first load until the previous grid is done and its writes seen
constexpr bool kPerOpPdl = true;

struct SgdMomParams {
  float lr, wd, momentum, rescale, clip;
};

// One row of the multi-tensor table: 5 x 8 bytes, written by the wrapper as
// an int64 [n_tensors, 5] tensor.
struct SgdMomTensor {
  float* w;
  const float* g;
  float* m;
  long long n;
  long long chunk0;  // index of the tensor's first chunk in the launch
};

__device__ __forceinline__ void sgd_mom(float& w, float g, float& m, const SgdMomParams& p) {
  g = __fmul_rn(g, p.rescale);
  // comparisons, not fminf/fmaxf, so a NaN gradient stays NaN as in jnp.clip
  if (p.clip > 0.f) g = g < -p.clip ? -p.clip : (g > p.clip ? p.clip : g);
  const float nm =
      __fsub_rn(__fmul_rn(p.momentum, m), __fmul_rn(p.lr, __fadd_rn(g, __fmul_rn(p.wd, w))));
  m = nm;
  w = __fadd_rn(w, nm);
}

// Elements [begin, end) of one tensor by the threads of one block; w_out and
// m_out may alias w and m (each element is read before it is written).
__device__ __forceinline__ void sgd_mom_range(const float* w, const float* g, const float* m,
                                              float* w_out, float* m_out, long long begin,
                                              long long end, const SgdMomParams& p,
                                              long long tid, long long stride) {
  const bool vec = ((reinterpret_cast<uintptr_t>(w) | reinterpret_cast<uintptr_t>(g) |
                     reinterpret_cast<uintptr_t>(m) | reinterpret_cast<uintptr_t>(w_out) |
                     reinterpret_cast<uintptr_t>(m_out)) & 15) == 0 && (begin & 3) == 0;
  long long i = begin;
  if (vec) {
    const long long vend = begin + ((end - begin) & ~3LL);
    for (long long j = begin + 4 * tid; j < vend; j += 4 * stride) {
      float4 wv = *reinterpret_cast<const float4*>(w + j);
      const float4 gv = *reinterpret_cast<const float4*>(g + j);
      float4 mv = *reinterpret_cast<const float4*>(m + j);
      sgd_mom(wv.x, gv.x, mv.x, p);
      sgd_mom(wv.y, gv.y, mv.y, p);
      sgd_mom(wv.z, gv.z, mv.z, p);
      sgd_mom(wv.w, gv.w, mv.w, p);
      *reinterpret_cast<float4*>(w_out + j) = wv;
      *reinterpret_cast<float4*>(m_out + j) = mv;
    }
    i = vend;
  }
  for (long long j = i + tid; j < end; j += stride) {
    float wv = w[j];
    float mv = m[j];
    sgd_mom(wv, g[j], mv, p);
    w_out[j] = wv;
    m_out[j] = mv;
  }
}

__global__ void __launch_bounds__(kOptThreads)
sgd_mom_update_v1_kernel(const float* w, const float* g, const float* m, float* w_out,
                         float* m_out, long long n, SgdMomParams p) {
  for (long long c = blockIdx.x; c * kChunk < n; c += gridDim.x) {
    const long long begin = c * kChunk;
    const long long end = begin + kChunk < n ? begin + kChunk : n;
    sgd_mom_range(w, g, m, w_out, m_out, begin, end, p, threadIdx.x, blockDim.x);
  }
}

__device__ __forceinline__ void sgd_mom_one(const float* w, const float* g, const float* m,
                                            float* w_out, float* m_out, long long j,
                                            const SgdMomParams& p) {
  float wv = w[j];
  float mv = m[j];
  sgd_mom(wv, g[j], mv, p);
  w_out[j] = wv;
  m_out[j] = mv;
}

// One tensor over the whole grid.  No __restrict__: w_out and m_out may be w
// and m; each element is read by one thread before that thread writes it.
__global__ void __launch_bounds__(kPerOpThreads)
sgd_mom_update_kernel(const float* w, const float* g, const float* m, float* w_out,
                      float* m_out, long long n, SgdMomParams p) {
  if (kPerOpPdl) {
    asm volatile("griddepcontrol.wait;\n" ::: "memory");
    asm volatile("griddepcontrol.launch_dependents;\n" :::);
  }
  const uintptr_t a = reinterpret_cast<uintptr_t>(w);
  const bool same = ((a ^ reinterpret_cast<uintptr_t>(g)) | (a ^ reinterpret_cast<uintptr_t>(m)) |
                     (a ^ reinterpret_cast<uintptr_t>(w_out)) |
                     (a ^ reinterpret_cast<uintptr_t>(m_out))) % 16 == 0;
  // scalar elements before the first 16-byte boundary: all of them when the
  // five pointers do not share one alignment
  long long head = same ? static_cast<long long>((16 - a % 16) % 16 / 4) : n;
  if (head > n) head = n;
  const long long nvec = (n - head) / 4;
  const long long tail = head + 4 * nvec;
  const long long tid = static_cast<long long>(blockIdx.x) * kPerOpThreads + threadIdx.x;
  const long long nthreads = static_cast<long long>(gridDim.x) * kPerOpThreads;
  for (long long j = tid; j < head; j += nthreads) sgd_mom_one(w, g, m, w_out, m_out, j, p);
  for (long long j = tail + tid; j < n; j += nthreads) sgd_mom_one(w, g, m, w_out, m_out, j, p);

  const float4* w4 = reinterpret_cast<const float4*>(w + head);
  const float4* g4 = reinterpret_cast<const float4*>(g + head);
  const float4* m4 = reinterpret_cast<const float4*>(m + head);
  float4* wo4 = reinterpret_cast<float4*>(w_out + head);
  float4* mo4 = reinterpret_cast<float4*>(m_out + head);
  const long long step = static_cast<long long>(gridDim.x) * kPerOpThreads * kPerOpUnroll;
  for (long long base = static_cast<long long>(blockIdx.x) * kPerOpThreads * kPerOpUnroll +
                        threadIdx.x;
       base < nvec; base += step) {
    float4 wv[kPerOpUnroll], gv[kPerOpUnroll], mv[kPerOpUnroll];
#pragma unroll
    for (int u = 0; u < kPerOpUnroll; ++u) {
      const long long j = base + u * kPerOpThreads;
      if (j < nvec) {
        wv[u] = __ldcs(w4 + j);
        gv[u] = __ldcs(g4 + j);
        mv[u] = __ldcs(m4 + j);
      }
    }
#pragma unroll
    for (int u = 0; u < kPerOpUnroll; ++u) {
      const long long j = base + u * kPerOpThreads;
      if (j < nvec) {
        sgd_mom(wv[u].x, gv[u].x, mv[u].x, p);
        sgd_mom(wv[u].y, gv[u].y, mv[u].y, p);
        sgd_mom(wv[u].z, gv[u].z, mv[u].z, p);
        sgd_mom(wv[u].w, gv[u].w, mv[u].w, p);
        __stcs(wo4 + j, wv[u]);
        __stcs(mo4 + j, mv[u]);
      }
    }
  }
}

__global__ void __launch_bounds__(kOptThreads)
sgd_mom_multi_kernel(const SgdMomTensor* __restrict__ table, int n_tensors, long long n_chunks,
                     const bool* ok, SgdMomParams p) {
  if (ok != nullptr && !*ok) return;
  for (long long c = blockIdx.x; c < n_chunks; c += gridDim.x) {
    int lo = 0;
    int hi = n_tensors - 1;
    while (lo < hi) {  // the last tensor whose first chunk is <= c
      const int mid = (lo + hi + 1) / 2;
      if (table[mid].chunk0 <= c) lo = mid;
      else hi = mid - 1;
    }
    const SgdMomTensor t = table[lo];
    const long long begin = (c - t.chunk0) * kChunk;
    const long long end = begin + kChunk < t.n ? begin + kChunk : t.n;
    sgd_mom_range(t.w, t.g, t.m, t.w, t.m, begin, end, p, threadIdx.x, blockDim.x);
  }
}

unsigned grid_for(long long chunks) {
  const long long cap = 132LL * 8;  // a few waves of blocks; the loop covers the rest
  return static_cast<unsigned>(chunks < cap ? (chunks > 0 ? chunks : 1) : cap);
}

}  // namespace

// w, g, m, w_out, m_out: contiguous fp32 of n elements, 4-byte aligned;
// w_out/m_out may be w/m.  clip <= 0 turns clipping off.  grid: blocks, from
// ops/fused/optimizer_kernels.py _per_op_grid.
MXTPU_API int mxtpu_sgd_mom_update(const float* w, const float* g, const float* m, float* w_out,
                                   float* m_out, long long n, unsigned grid, float lr, float wd,
                                   float momentum, float rescale, float clip, void* stream) {
  if (n > 0 && grid > 0) {
    const SgdMomParams p{lr, wd, momentum, rescale, clip};
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(grid);
    cfg.blockDim = dim3(kPerOpThreads);
    cfg.stream = static_cast<cudaStream_t>(stream);
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cfg.attrs = attr;
    cfg.numAttrs = kPerOpPdl ? 1 : 0;
    cudaLaunchKernelEx(&cfg, sgd_mom_update_kernel, w, g, m, w_out, m_out, n, p);
  }
  return static_cast<int>(cudaGetLastError());
}

// Blocks of sgd_mom_update_kernel that one SM of the current device holds at
// once, into *blocks.
MXTPU_API int mxtpu_sgd_mom_update_blocks_per_sm(int* blocks) {
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, sgd_mom_update_kernel, kPerOpThreads, 0));
}

// The first design of mxtpu_sgd_mom_update: one block a 64K-element chunk.
MXTPU_API int mxtpu_sgd_mom_update_v1(const float* w, const float* g, const float* m,
                                      float* w_out, float* m_out, long long n, float lr,
                                      float wd, float momentum, float rescale, float clip,
                                      void* stream) {
  if (n > 0) {
    const SgdMomParams p{lr, wd, momentum, rescale, clip};
    sgd_mom_update_v1_kernel<<<grid_for((n + kChunk - 1) / kChunk), kOptThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(w, g, m, w_out, m_out, n,
                                                                    p);
  }
  return static_cast<int>(cudaGetLastError());
}

// table: device int64 [n_tensors, 5] rows (w, g, m, n, first chunk), chunks of
// 65536 elements numbered across the tensors in table order; n_chunks their
// total; ok: device bool or nullptr.
MXTPU_API int mxtpu_sgd_mom_multi(const void* table, int n_tensors, long long n_chunks,
                                  const bool* ok, float lr, float wd, float momentum,
                                  float rescale, float clip, void* stream) {
  if (n_tensors > 0 && n_chunks > 0) {
    const SgdMomParams p{lr, wd, momentum, rescale, clip};
    sgd_mom_multi_kernel<<<grid_for(n_chunks), kOptThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const SgdMomTensor*>(table), n_tensors, n_chunks, ok, p);
  }
  return static_cast<int>(cudaGetLastError());
}

