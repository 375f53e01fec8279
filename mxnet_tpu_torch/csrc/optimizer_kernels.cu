// The SGD-momentum step, fp32, for sm_90a.
//
// Replaces the Pallas kernel of mxnet_tpu/ops/fused/optimizer_kernels.py
// (fused_sgd_mom_update, _sgd_mom_kernel) and, with one launch over every
// parameter, the whole-tree step the trainer takes (parallel/trainer.py
// fused_sgd_mom_tree):
//   mxtpu_sgd_mom_update  one tensor: w, g, m in; w', m' out (may alias w, m)
//   mxtpu_sgd_mom_multi   a device table of (w, g, m, n) over many tensors,
//                         updated in place, with an optional device flag `ok`:
//                         when *ok is false no element is written
//                         (skip_nonfinite keeps the old state)
//
// What bounds it on an H100: per element it reads w, g and m and writes w and
// m (20 bytes) for 7 operations, so it is bound by bytes: the bench LM's
// 218.6 M parameters move 4.4 GB, about 1.3 ms at 3.35 TB/s.  Design: 16-byte
// loads and stores where the tensor's three pointers allow, a grid-stride loop
// over fixed chunks, and (multi-tensor) each block finds its chunk's tensor by
// a binary search over the table's chunk offsets, so one launch covers the
// whole parameter list without a per-chunk table.
//
// The arithmetic is the JAX spelling (g * rescale, clip, m' = mu * m -
// lr * (g + wd * w), w' = w + m') with every operation rounded on its own
// (__fmul_rn and friends forbid fused multiply-adds), so the result has the
// same bits as the plain PyTorch version run on the card.

#include <cstdint>

#include "common.h"

namespace {

constexpr int kOptThreads = 256;
// elements per chunk; ops/fused/optimizer_kernels.py numbers the multi-tensor
// launch's chunks by the same constant (_CHUNK)
constexpr long long kChunk = 1 << 16;

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
sgd_mom_update_kernel(const float* w, const float* g, const float* m, float* w_out,
                      float* m_out, long long n, SgdMomParams p) {
  for (long long c = blockIdx.x; c * kChunk < n; c += gridDim.x) {
    const long long begin = c * kChunk;
    const long long end = begin + kChunk < n ? begin + kChunk : n;
    sgd_mom_range(w, g, m, w_out, m_out, begin, end, p, threadIdx.x, blockDim.x);
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

// w, g, m, w_out, m_out: contiguous fp32 of n elements; w_out/m_out may be w/m.
// clip <= 0 turns clipping off.
MXTPU_API int mxtpu_sgd_mom_update(const float* w, const float* g, const float* m, float* w_out,
                                   float* m_out, long long n, float lr, float wd,
                                   float momentum, float rescale, float clip, void* stream) {
  if (n > 0) {
    const SgdMomParams p{lr, wd, momentum, rescale, clip};
    sgd_mom_update_kernel<<<grid_for((n + kChunk - 1) / kChunk), kOptThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(w, g, m, w_out, m_out, n, p);
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

