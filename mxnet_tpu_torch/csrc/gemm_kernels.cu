// GEMM kernels of mxnet_tpu_torch: C[M, N] = A[M, K] @ B[K, N], both
// operands row-major, fp32 accumulators, one of three epilogues.
//
// They replace two Pallas kernels of the JAX package and serve part of a
// third, all products over the 1x1 convolutions of ResNet-50's bottleneck
// blocks:
//
//   mm_epilogue_kernel    tools/bottleneck_probe.py mm_epilogue:
//                         relu?(scale * acc + bias [+ res]);
//   mm_stats_kernel       tools/bottleneck_probe.py mm_with_stats: the
//                         product plus per-block column sums of acc and
//                         acc^2, taken on the fp32 accumulator before it is
//                         rounded (a second pass in the wrapper adds the
//                         per-block partials);
//   conv1x1_dgrad_kernel  the dgrad dx = dy @ w of a 1x1 stride-1 NHWC conv
//                         (mxnet_tpu/ops/nn.py _conv1x1_dgrad_pallas) in
//                         fp32, and in bf16 where TMA cannot take the shape
//                         (O or I no multiple of 8, or unaligned tensors);
//                         every other bf16 dgrad, the bench ResNet-50's
//                         included, runs the TMA + wgmma kernel of
//                         gemm_sm90.cu.  The Python wrapper chooses by shape.
//
// What bounds them on an H100: at the bench's shapes (M = batch * H * W up
// to 401408 rows, K and N 64..2048) most products do 64-256 flops per byte
// of bf16 read and written, below the ~295 the tensor cores need, so they
// are bound by device memory; only the widest (K, N >= 512 at M = 6272) are
// bound by the tensor cores.  The design is the simple one that reads each
// operand tile once per output tile: a 128 x 64 output tile per block of 256
// threads, K walked in steps of 32 (bf16) or 16 (fp32) through two
// shared-memory stages filled with cp.async, so the next tile's loads fly
// while this one is multiplied.  bf16 runs on the tensor cores through
// nvcuda::wmma (16x16x16 fragments, fp32 accumulate; each of the 8 warps
// owns a 32 x 32 sub-tile); fp32 runs on CUDA cores with fmaf (8 x 4
// outputs a thread), never TF32.  Output tiles walk N fastest, so the
// blocks that share a row block of A run together and find it in L2.  The
// accumulators go through shared memory to the epilogue, which writes 16
// bytes a thread where the row length allows.  Tails in M, N and K are
// zero-filled on load and masked on store; the vector path (cp.async of 16
// bytes) needs K and N to be multiples of 16 bytes' worth of elements and
// 16-byte aligned tensors, else a scalar path loads element by element.
// gemm_sm90.cu shows what TMA, wgmma and a deeper ring buy over this core
// at the dgrad's shapes (root PERF.md); the probe's epilogues keep it.
#include <cuda_bf16.h>
#include <mma.h>

#include "common.h"

namespace mxtpu {
namespace {

using bf16 = __nv_bfloat16;

constexpr int kBM = 128;
constexpr int kBN = 64;
constexpr int kThreads = 256;
constexpr int kLDC = kBN + 4;  // fp32 accumulator tile in shared memory

enum Epi { kStore = 0, kAffine = 1, kStats = 2 };

template <typename T>
struct Tile;
template <>
struct Tile<bf16> {
  static constexpr int kBK = 32;
  static constexpr int kVec = 8;   // elements in 16 bytes
  static constexpr int kPad = 8;
};
template <>
struct Tile<float> {
  static constexpr int kBK = 16;
  static constexpr int kVec = 4;
  static constexpr int kPad = 4;
};

template <typename T>
struct Layout {
  static constexpr int kBK = Tile<T>::kBK;
  static constexpr int kLDA = kBK + Tile<T>::kPad;
  static constexpr int kLDB = kBN + Tile<T>::kPad;
  static constexpr int kStageA = kBM * kLDA;   // elements
  static constexpr int kStageB = kBK * kLDB;
  static constexpr int kABBytes = 2 * (kStageA + kStageB) * (int)sizeof(T);
  static constexpr int kCBytes = kBM * kLDC * (int)sizeof(float);
  static constexpr int kBytes = kABBytes > kCBytes ? kABBytes : kCBytes;
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_float<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// One K step of A (kBM x kBK) and B (kBK x kBN) into a stage.
template <typename T, bool kVecLoad>
__device__ __forceinline__ void load_stage(T* As, T* Bs, const T* A,
                                           const T* B, long long M, int N,
                                           int K, long long m0, int n0,
                                           int k0) {
  using L = Layout<T>;
  constexpr int BK = L::kBK;
  if (kVecLoad) {
    constexpr int V = Tile<T>::kVec;
    for (int c = threadIdx.x; c < kBM * BK / V; c += kThreads) {
      const int r = c / (BK / V), col = (c % (BK / V)) * V;
      const bool ok = m0 + r < M && k0 + col < K;
      const T* src = ok ? A + (m0 + r) * K + k0 + col : A;
      cp_async16(As + r * L::kLDA + col, src, ok);
    }
    for (int c = threadIdx.x; c < BK * kBN / V; c += kThreads) {
      const int r = c / (kBN / V), col = (c % (kBN / V)) * V;
      const bool ok = k0 + r < K && n0 + col < N;
      const T* src = ok ? B + (long long)(k0 + r) * N + n0 + col : B;
      cp_async16(Bs + r * L::kLDB + col, src, ok);
    }
  } else {
    for (int e = threadIdx.x; e < kBM * BK; e += kThreads) {
      const int r = e / BK, col = e % BK;
      As[r * L::kLDA + col] = (m0 + r < M && k0 + col < K)
                                  ? A[(m0 + r) * K + k0 + col]
                                  : from_float<T>(0.f);
    }
    for (int e = threadIdx.x; e < BK * kBN; e += kThreads) {
      const int r = e / kBN, col = e % kBN;
      Bs[r * L::kLDB + col] = (k0 + r < K && n0 + col < N)
                                  ? B[(long long)(k0 + r) * N + n0 + col]
                                  : from_float<T>(0.f);
    }
  }
}

// Walks K through the two stages; `mul(As, Bs)` multiplies one stage.  The
// product leaves its fp32 tile in Cs (kBM x kLDC), which aliases the stages.
template <typename T, bool kVecLoad, typename Mul>
__device__ __forceinline__ void k_loop(unsigned char* smem, const T* A,
                                       const T* B, long long M, int N, int K,
                                       long long m0, int n0, Mul mul) {
  using L = Layout<T>;
  T* stage_a[2] = {reinterpret_cast<T*>(smem),
                   reinterpret_cast<T*>(smem) + L::kStageA};
  T* stage_b[2] = {reinterpret_cast<T*>(smem) + 2 * L::kStageA,
                   reinterpret_cast<T*>(smem) + 2 * L::kStageA + L::kStageB};
  const int nk = (K + L::kBK - 1) / L::kBK;
  load_stage<T, kVecLoad>(stage_a[0], stage_b[0], A, B, M, N, K, m0, n0, 0);
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) {
      const int s = (kt + 1) & 1;
      load_stage<T, kVecLoad>(stage_a[s], stage_b[s], A, B, M, N, K, m0, n0,
                              (kt + 1) * L::kBK);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    mul(stage_a[kt & 1], stage_b[kt & 1]);
    __syncthreads();
  }
}

template <bool kVecLoad>
__device__ __forceinline__ void product_bf16(unsigned char* smem, float* Cs,
                                             const bf16* A, const bf16* B,
                                             long long M, int N, int K,
                                             long long m0, int n0) {
  using namespace nvcuda;
  using L = Layout<bf16>;
  const int warp = threadIdx.x >> 5;
  const int wm = warp & 3, wn = warp >> 2;   // 4 x 2 warps of 32 x 32
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
  k_loop<bf16, kVecLoad>(
      smem, A, B, M, N, K, m0, n0, [&](const bf16* As, const bf16* Bs) {
#pragma unroll
        for (int kk = 0; kk < L::kBK; kk += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
              a[2];
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>
              b[2];
#pragma unroll
          for (int i = 0; i < 2; ++i)
            wmma::load_matrix_sync(a[i], As + (wm * 32 + i * 16) * L::kLDA + kk,
                                   L::kLDA);
#pragma unroll
          for (int j = 0; j < 2; ++j)
            wmma::load_matrix_sync(b[j], Bs + kk * L::kLDB + wn * 32 + j * 16,
                                   L::kLDB);
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 2; ++j)
              wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
        }
      });
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * kLDC + wn * 32 + j * 16,
                              acc[i][j], kLDC, wmma::mem_row_major);
  __syncthreads();
}

template <bool kVecLoad>
__device__ __forceinline__ void product_f32(unsigned char* smem, float* Cs,
                                            const float* A, const float* B,
                                            long long M, int N, int K,
                                            long long m0, int n0) {
  using L = Layout<float>;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;  // 8 rows x 4 cols
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  k_loop<float, kVecLoad>(
      smem, A, B, M, N, K, m0, n0, [&](const float* As, const float* Bs) {
#pragma unroll
        for (int kk = 0; kk < L::kBK; ++kk) {
          const float4 b =
              *reinterpret_cast<const float4*>(Bs + kk * L::kLDB + tx * 4);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float a = As[(ty * 8 + i) * L::kLDA + kk];
            acc[i][0] = fmaf(a, b.x, acc[i][0]);
            acc[i][1] = fmaf(a, b.y, acc[i][1]);
            acc[i][2] = fmaf(a, b.z, acc[i][2]);
            acc[i][3] = fmaf(a, b.w, acc[i][3]);
          }
        }
      });
#pragma unroll
  for (int i = 0; i < 8; ++i)
    *reinterpret_cast<float4*>(Cs + (ty * 8 + i) * kLDC + tx * 4) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  __syncthreads();
}

template <typename T, bool kVecLoad>
__device__ __forceinline__ void product(unsigned char* smem, float* Cs,
                                        const T* A, const T* B, long long M,
                                        int N, int K, long long m0, int n0) {
  if constexpr (sizeof(T) == 2)
    product_bf16<kVecLoad>(smem, Cs, A, B, M, N, K, m0, n0);
  else
    product_f32<kVecLoad>(smem, Cs, A, B, M, N, K, m0, n0);
}

struct EpiArgs {
  const float* scale;   // [N] (kAffine)
  const float* bias;    // [N] (kAffine)
  const void* res;      // [M, N] of T, or null (kAffine)
  int relu;             // (kAffine)
  float* part1;         // [ceil(M / kBM), N] (kStats)
  float* part2;
};

// Output tile (m0, n0) of C = A @ B through epilogue EPI.  kVec: K and N are
// multiples of Tile<T>::kVec and A, B, C (and res) are 16-byte aligned.
template <typename T, int EPI, bool kVec>
__device__ __forceinline__ void gemm_tile(const T* __restrict__ A,
                                          const T* __restrict__ B,
                                          T* __restrict__ C, long long M,
                                          int N, int K, EpiArgs ep) {
  __shared__ __align__(128) unsigned char smem[Layout<T>::kBytes];
  __shared__ float red[2][kThreads / kBN][kBN];
  const int tiles_n = (N + kBN - 1) / kBN;
  const long long mt = blockIdx.x / tiles_n;
  const int n0 = (int)(blockIdx.x % tiles_n) * kBN;
  const long long m0 = mt * kBM;
  float* Cs = reinterpret_cast<float*>(smem);
  product<T, kVec>(smem, Cs, A, B, M, N, K, m0, n0);

  const T* res = static_cast<const T*>(ep.res);
  for (int c = threadIdx.x; c < kBM * kBN / 8; c += kThreads) {
    const int r = c / (kBN / 8), col = (c % (kBN / 8)) * 8;
    const long long gm = m0 + r;
    const int gn = n0 + col;
    if (gm >= M || gn >= N) continue;
    float v[8];
    const float4 lo = *reinterpret_cast<const float4*>(Cs + r * kLDC + col);
    const float4 hi = *reinterpret_cast<const float4*>(Cs + r * kLDC + col + 4);
    v[0] = lo.x, v[1] = lo.y, v[2] = lo.z, v[3] = lo.w;
    v[4] = hi.x, v[5] = hi.y, v[6] = hi.z, v[7] = hi.w;
    if (EPI == kAffine) {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        if (gn + e >= N) break;
        float y = __fadd_rn(__fmul_rn(v[e], ep.scale[gn + e]), ep.bias[gn + e]);
        if (res != nullptr) y = __fadd_rn(y, to_float(res[gm * N + gn + e]));
        if (ep.relu) y = y < 0.f ? 0.f : y;   // NaN stays NaN
        v[e] = y;
      }
    }
    T* dst = C + gm * N + gn;
    if (kVec && gn + 8 <= N) {
      if constexpr (sizeof(T) == 2) {
        __align__(16) bf16 out[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) out[e] = from_float<T>(v[e]);
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(out);
      } else {
        reinterpret_cast<float4*>(dst)[0] = make_float4(v[0], v[1], v[2], v[3]);
        reinterpret_cast<float4*>(dst)[1] = make_float4(v[4], v[5], v[6], v[7]);
      }
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (gn + e < N) dst[e] = from_float<T>(v[e]);
    }
  }

  if (EPI == kStats) {
    // rows past M hold exact zeros (their A rows were zero-filled), so the
    // column sums need no mask
    constexpr int kGroups = kThreads / kBN;
    constexpr int kRows = kBM / kGroups;
    const int col = threadIdx.x % kBN, grp = threadIdx.x / kBN;
    float s1 = 0.f, s2 = 0.f;
    for (int r = grp * kRows; r < (grp + 1) * kRows; ++r) {
      const float v = Cs[r * kLDC + col];
      s1 += v;
      s2 = fmaf(v, v, s2);
    }
    red[0][grp][col] = s1;
    red[1][grp][col] = s2;
    __syncthreads();
    if (grp == 0 && n0 + col < N) {
      float t1 = 0.f, t2 = 0.f;
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
        t1 += red[0][g][col];
        t2 += red[1][g][col];
      }
      ep.part1[mt * N + n0 + col] = t1;
      ep.part2[mt * N + n0 + col] = t2;
    }
  }
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
    conv1x1_dgrad_kernel(const T* dy, const T* w, T* dx, long long M, int O,
                         int I) {
  gemm_tile<T, kStore, kVec>(dy, w, dx, M, I, O, EpiArgs{});
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
    mm_epilogue_kernel(const T* x, const T* w, T* y, long long M, int K,
                       int N, EpiArgs ep) {
  gemm_tile<T, kAffine, kVec>(x, w, y, M, N, K, ep);
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
    mm_stats_kernel(const T* x, const T* w, T* y, long long M, int K, int N,
                    EpiArgs ep) {
  gemm_tile<T, kStats, kVec>(x, w, y, M, N, K, ep);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15) == 0;
}

template <typename T>
bool use_vec(int K, int N, const void* a, const void* b, const void* c,
             const void* res) {
  constexpr int V = Tile<T>::kVec;
  return K % V == 0 && N % V == 0 && aligned16(a) && aligned16(b) &&
         aligned16(c) && (res == nullptr || aligned16(res));
}

unsigned grid_of(long long M, int N) {
  return (unsigned)(((M + kBM - 1) / kBM) * ((N + kBN - 1) / kBN));
}

template <typename T>
int dgrad(const void* dy, const void* w, void* dx, long long M, int O, int I,
          cudaStream_t stream) {
  const unsigned grid = grid_of(M, I);
  if (grid == 0) return (int)cudaGetLastError();
  auto a = static_cast<const T*>(dy);
  auto b = static_cast<const T*>(w);
  auto c = static_cast<T*>(dx);
  if (use_vec<T>(O, I, dy, w, dx, nullptr))
    conv1x1_dgrad_kernel<T, true><<<grid, kThreads, 0, stream>>>(a, b, c, M,
                                                                 O, I);
  else
    conv1x1_dgrad_kernel<T, false><<<grid, kThreads, 0, stream>>>(a, b, c, M,
                                                                  O, I);
  return (int)cudaGetLastError();
}

template <typename T>
int epilogue(const void* x, const void* w, void* y, long long M, int K,
             int N, EpiArgs ep, cudaStream_t stream) {
  const unsigned grid = grid_of(M, N);
  if (grid == 0) return (int)cudaGetLastError();
  auto a = static_cast<const T*>(x);
  auto b = static_cast<const T*>(w);
  auto c = static_cast<T*>(y);
  if (use_vec<T>(K, N, x, w, y, ep.res))
    mm_epilogue_kernel<T, true><<<grid, kThreads, 0, stream>>>(a, b, c, M, K,
                                                               N, ep);
  else
    mm_epilogue_kernel<T, false><<<grid, kThreads, 0, stream>>>(a, b, c, M, K,
                                                                N, ep);
  return (int)cudaGetLastError();
}

template <typename T>
int stats(const void* x, const void* w, void* y, long long M, int K, int N,
          EpiArgs ep, cudaStream_t stream) {
  const unsigned grid = grid_of(M, N);
  if (grid == 0) return (int)cudaGetLastError();
  auto a = static_cast<const T*>(x);
  auto b = static_cast<const T*>(w);
  auto c = static_cast<T*>(y);
  if (use_vec<T>(K, N, x, w, y, nullptr))
    mm_stats_kernel<T, true><<<grid, kThreads, 0, stream>>>(a, b, c, M, K, N,
                                                            ep);
  else
    mm_stats_kernel<T, false><<<grid, kThreads, 0, stream>>>(a, b, c, M, K,
                                                             N, ep);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace mxtpu

// dx[M, I] = dy[M, O] @ w[O, I]; bf16 != 0: bf16 tensors, else fp32.
MXTPU_API int mxtpu_conv1x1_dgrad(const void* dy, const void* w, void* dx,
                                  long long M, int O, int I, int bf16,
                                  cudaStream_t stream) {
  return bf16 ? mxtpu::dgrad<__nv_bfloat16>(dy, w, dx, M, O, I, stream)
              : mxtpu::dgrad<float>(dy, w, dx, M, O, I, stream);
}

// y[M, N] = relu?(scale * (x[M, K] @ w[K, N]) + bias [+ res[M, N]]);
// scale, bias fp32 [N]; res null or of the operands' type.
MXTPU_API int mxtpu_mm_epilogue(const void* x, const void* w,
                                const float* scale, const float* bias,
                                const void* res, void* y, long long M, int K,
                                int N, int relu, int bf16,
                                cudaStream_t stream) {
  mxtpu::EpiArgs ep{scale, bias, res, relu, nullptr, nullptr};
  return bf16 ? mxtpu::epilogue<__nv_bfloat16>(x, w, y, M, K, N, ep, stream)
              : mxtpu::epilogue<float>(x, w, y, M, K, N, ep, stream);
}

// y[M, N] = x[M, K] @ w[K, N]; part1/part2 [ceil(M / 128), N] fp32 get each
// 128-row block's column sums of the accumulator and of its square.
MXTPU_API int mxtpu_mm_stats(const void* x, const void* w, void* y,
                             float* part1, float* part2, long long M, int K,
                             int N, int bf16, cudaStream_t stream) {
  mxtpu::EpiArgs ep{nullptr, nullptr, nullptr, 0, part1, part2};
  return bf16 ? mxtpu::stats<__nv_bfloat16>(x, w, y, M, K, N, ep, stream)
              : mxtpu::stats<float>(x, w, y, M, K, N, ep, stream);
}
