// LM layer norm and the FFN's GELU+bias epilogue (fp32), and the LayerNorm op
// (fp32, bf16 or fp16 data), for sm_90a.
//
// Replace the Pallas kernels of mxnet_tpu/ops/fused/norm_kernels.py:
//   mxtpu_lm_layer_norm  <- fused_lm_layer_norm (_lm_ln_kernel)
//   mxtpu_lm_gelu_bias   <- fused_lm_gelu_bias (_gelu_bias_kernel)
//   mxtpu_layer_norm_op  <- fused_layer_norm_op (_ln_op_kernel), the LayerNorm
//                           registry op of the training graph; it also writes
//                           each row's mean and 1/std for the backward
//
// What bounds them on an H100: each reads its input once and writes its
// output once with a handful of fp32 operations per element, so they are
// bound by device memory (3.35 TB/s on the SXM part).  At the generation
// lane's widths: layer norm of a [512, 1024] prefill block moves 4.2 MB
// (about 1.3 us at the memory rate), GELU+bias of the [512, 4096] FFN
// hidden moves 16.8 MB (about 5 us); a decode step's [<= 8, 1024] rows move
// at most 74 KB, so there the launch and one memory round trip bound them.
// The training graph's LayerNorm op on [8 * 2048, 1024] fp32 moves 134 MB
// (about 40 us; half that in bf16).
//
// Both layer norms run one kernel body, ln_rows_kernel, which keeps each row
// in registers: a group of W warps a row (W = 1: a warp a row), each thread
// reading its share with 16-byte loads (vector j of thread t is t + 32 W j:
// 8 float4 a lane at C = 1024 fp32 and W = 1, 4 vectors of 8 at bf16), all
// issued before any arithmetic, so the group has the whole row in flight.
// A warp's mean and then its centred squares come from those registers by
// shuffles alone.  With W = 1 those are the row's (no shared memory, no
// barrier).  With W > 1 each warp finds its own mean and centred squares,
// and the group combines them in one shared-memory exchange with one
// barrier: mean = sum s_k / C, M2 = sum_k (q_k + n_k (m_k - mean)^2) (Chan
// et al.), still the population variance from centred squares and not
// E[x^2] - E[x]^2.  y leaves by 16-byte stores; gamma and beta come by
// 16-byte __ldg, either after the statistics (from L1 as they are needed)
// or, with kEarly, issued beside the row's loads so that their round trip
// hides under the row's.  Two flags make the two functions:
//   kLm     the LM layer norm (transformer._lm_ln_stock's spelling, which the
//           lane's decode-versus-full-forward gate is built on): divide by
//           sqrtf(var + eps), no statistics written;
//   else    the LayerNorm op (ops/attention.py _layer_norm's spelling):
//           multiply by rsqrtf(var + eps), mean and rstd written.
//
// The LayerNorm op launches W = 1, eight rows a 256-thread block, gamma and
// beta late.  (Persistent warps holding gamma and beta in registers measured
// slower in fp32 on the H100: 128 registers a thread halve the warps in
// flight, and the last rows leave a tail.)
//
// The LM layer norm launches one shape at every row count (kLm*): W = 4
// warps a row (2 float4 a thread at C = 1024), one row a 128-thread block,
// gamma and beta early.  The lane gives it 1-8 rows a decode step and
// 64-512 rows a prefill bucket, at C = 1024.  python3 -m
// mxnet_tpu_torch.tools.lm_layer_norm_ab builds this source at each of 20
// shapes (W 1, 2, 4, 8; 1-8 rows a block within 256 threads; gamma and beta
// early or late) and times them in turns at rows 1, 2, 4, 8, 64, 128, 256
// and 512, beside the first design, F.layer_norm and zero_() of one
// element (the floor of any launch).  Device us, CUDA-graph replay, mean of
// 4 rounds, NVIDIA H100 80GB HBM3, 700 W:
//
//   rows  W4 R1 early  next best        W1 R8 late  W1 best early  v1    F.layer_norm  floor
//      1  2.07         W4 R2 early 2.10  3.24        2.83           3.23  3.24          1.03
//      8  2.15         W4 R2 early 2.23  3.71        2.94           3.31  3.32          1.04
//     64  2.25         W4 R2 early 2.32  3.99        3.00           3.36  3.54          1.03
//    512  2.95         W4 R2 early 2.98  4.14        3.27           3.64  4.22          1.03
//
// It was the fastest shape at each of the 8 row counts, so the rule takes
// no count.  A warp a row (W = 1) is the slower design at these counts: at
// 8 rows it puts 8 warps on the card, each lane issuing 8 loads of x (24
// with gamma and beta) and summing 32 values around its two shuffle chains,
// and at 512 rows with 8 rows a block (the LayerNorm op's shape) it puts 64
// blocks on 132 SMs.  W = 8 pays a barrier over 256 threads for 1 vector a
// thread.  Gamma and beta early saved 0.07-0.14 us at W = 4 and 0.4-0.8 us
// at W = 1.
//
// Both take C a multiple of the vector width (4 fp32, 8 bf16/fp16) up to 32 *
// 8 vectors (C <= 1024 fp32, 2048 bf16), with 16-byte aligned tensors; any
// other row goes to the port's first design (one 256-thread block a row, two
// block reductions, the row read three times): lm_layer_norm_v1_kernel and
// layer_norm_op_v1_kernel.  mxtpu_lm_layer_norm_v1 and mxtpu_layer_norm_op_v1
// (fp32) run those alone, so a run on the card can time each design beside
// its first in turns; no path of the package launches them.  The LayerNorm
// op's x and y share one dtype; gamma, beta, mean and rstd are fp32 and all
// math is fp32, y rounded once to x's dtype (the JAX kernel's _ln_op_kernel).

#include "common.h"
#include "vec16.h"

namespace {

constexpr int kLnThreads = 256;
constexpr int kEwThreads = 256;

// The port's first LM layer norm, one 256-thread block a row: y = (x - mean)
// / sqrt(var + eps) * gamma + beta over the last axis, with the population
// variance mean((x - mean)^2): the JAX package's spelling
// (models/transformer.py _lm_ln_stock), sqrt and division rather than rsqrt.
// The sum, the centred squares and the output each read the row again.  Any
// C and alignment; the general path of mxtpu_lm_layer_norm.
__global__ void __launch_bounds__(kLnThreads)
lm_layer_norm_v1_kernel(const float* __restrict__ x, const float* __restrict__ gamma,
                        const float* __restrict__ beta, float* __restrict__ y, int cols,
                        float eps) {
  __shared__ float scratch[33];
  const long long row = blockIdx.x;
  const float* xr = x + row * cols;
  float* yr = y + row * cols;
  float s = 0.f;
  for (int c = threadIdx.x; c < cols; c += blockDim.x) s += xr[c];
  const float mean = mxtpu::block_reduce<false>(s, scratch) / static_cast<float>(cols);
  float q = 0.f;
  for (int c = threadIdx.x; c < cols; c += blockDim.x) {
    const float d = xr[c] - mean;
    q += d * d;
  }
  const float var = mxtpu::block_reduce<false>(q, scratch) / static_cast<float>(cols);
  const float denom = sqrtf(var + eps);
  for (int c = threadIdx.x; c < cols; c += blockDim.x)
    yr[c] = (xr[c] - mean) / denom * gamma[c] + beta[c];
}

constexpr int kLnWarpThreads = 256;   // threads a block, at most
constexpr int kLnMaxVecs = 8;         // 16-byte vectors a row holds: 32 * kLnMaxVecs

// Elements of a row that warp k of its group of W holds (vector j of thread
// t is t + 32 W j), of nvec vectors of kN elements.
template <int NV, int W>
__device__ __forceinline__ int warp_elems(int nvec, int k, int kn) {
  int n = 0;
#pragma unroll
  for (int j = 0; j < NV; ++j) n += min(max(nvec - 32 * (W * j + k), 0), 32);
  return n * kn;
}

// y = (x - mean) / sqrt(var + eps) * gamma + beta (kLm) or (x - mean) *
// rsqrt(var + eps) * gamma + beta with mean_out and rstd_out one value a row
// (else) over the last axis, population variance from centred squares.  A
// group of W warps a row (blockDim.x / (32 W) rows a block), NV vectors of
// 16 bytes a thread; cols is a multiple of the vector width and at most
// 32 W NV vectors.  kEarly loads gamma and beta beside x.
template <typename T, int NV, int W, bool kLm, bool kEarly>
__global__ void __launch_bounds__(kLnWarpThreads)
ln_rows_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
               const float* __restrict__ beta, T* __restrict__ y,
               float* __restrict__ mean_out, float* __restrict__ rstd_out, long long rows,
               int cols, float eps) {
  using V = mxtpu::Vec16<T>;
  constexpr int kN = V::kN;
  constexpr int kGroup = 32 * W;    // threads of one row
  constexpr int kG4 = kN / 4;       // float4s of gamma (and of beta) a vector
  const int lane = threadIdx.x & 31;
  const int t = threadIdx.x % kGroup;
  const long long row = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) / kGroup;
  if (W == 1 && row >= rows) return;   // whole warps; a wider group meets the barrier
  const int nvec = row < rows ? cols / kN : 0;
  const T* xr = x + row * cols;
  T* yr = y + row * cols;
  uint4 raw[NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int v = t + kGroup * j;
    raw[j] = v < nvec ? mxtpu::load16(xr + v * kN) : make_uint4(0u, 0u, 0u, 0u);
  }
  float4 ga[kEarly ? NV * kG4 : 1], be[kEarly ? NV * kG4 : 1];
  if constexpr (kEarly) {
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int v = t + kGroup * j;
#pragma unroll
      for (int i = 0; i < kG4; ++i) {
        if (v < nvec) {
          ga[j * kG4 + i] = __ldg(reinterpret_cast<const float4*>(gamma + v * kN) + i);
          be[j * kG4 + i] = __ldg(reinterpret_cast<const float4*>(beta + v * kN) + i);
        }
      }
    }
  }
  float xv[NV][kN];
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    V::unpack(raw[j], xv[j]);
#pragma unroll
    for (int i = 0; i < kN; ++i) s += xv[j][i];   // padding vectors hold zeros
  }
  const float inv_cols = 1.f / static_cast<float>(cols);
  float mean, var;
  if constexpr (W == 1) {
    mean = mxtpu::warp_sum(s) * inv_cols;
    float q = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      if (lane + 32 * j < nvec) {
#pragma unroll
        for (int i = 0; i < kN; ++i) {
          const float d = xv[j][i] - mean;
          q += d * d;
        }
      }
    }
    var = mxtpu::warp_sum(q) * inv_cols;
  } else {
    // each warp's sum and centred squares about its own mean, then one
    // exchange: the group's mean, and M2 by Chan et al.'s combination
    __shared__ float2 part[kLnWarpThreads / 32];
    const int k = t >> 5;
    const int n_w = warp_elems<NV, W>(nvec, k, kN);
    const float s_w = mxtpu::warp_sum(s);
    const float m_w = n_w ? s_w / static_cast<float>(n_w) : 0.f;
    float q = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      if (t + kGroup * j < nvec) {
#pragma unroll
        for (int i = 0; i < kN; ++i) {
          const float d = xv[j][i] - m_w;
          q += d * d;
        }
      }
    }
    q = mxtpu::warp_sum(q);
    if (lane == 0) part[threadIdx.x >> 5] = make_float2(s_w, q);
    __syncthreads();
    const float2* gp = part + ((threadIdx.x >> 5) - k);
    float total = 0.f;
#pragma unroll
    for (int w = 0; w < W; ++w) total += gp[w].x;
    mean = total * inv_cols;
    float m2 = 0.f;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const int n = warp_elems<NV, W>(nvec, w, kN);
      if (n) {
        const float d = gp[w].x / static_cast<float>(n) - mean;
        m2 += gp[w].y + static_cast<float>(n) * d * d;
      }
    }
    var = m2 * inv_cols;
  }
  // kLm divides by sqrt(var + eps); the op multiplies by rsqrt(var + eps)
  const float scale = kLm ? sqrtf(var + eps) : rsqrtf(var + eps);
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int v = t + kGroup * j;
    if (v < nvec) {
      float o[kN];
#pragma unroll
      for (int i = 0; i < kN; i += 4) {
        float4 g, b;
        if constexpr (kEarly) {
          g = ga[j * kG4 + i / 4];
          b = be[j * kG4 + i / 4];
        } else {
          g = __ldg(reinterpret_cast<const float4*>(gamma + v * kN + i));
          b = __ldg(reinterpret_cast<const float4*>(beta + v * kN + i));
        }
        const float gs[4] = {g.x, g.y, g.z, g.w}, bs[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float d = xv[j][i + e] - mean;
          o[i + e] = (kLm ? d / scale : d * scale) * gs[e] + bs[e];
        }
      }
      *reinterpret_cast<uint4*>(yr + v * kN) = V::pack(o);
    }
  }
  if (!kLm && t == 0 && row < rows) {
    mean_out[row] = mean;
    rstd_out[row] = scale;
  }
}

// The port's first LayerNorm op kernel, one 256-thread block a row: the sum,
// the centred squares and the output each read the row again, with two block
// reductions.  Any C and alignment; the general path of mxtpu_layer_norm_op.
template <typename T>
__global__ void __launch_bounds__(kLnThreads)
layer_norm_op_v1_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                        const float* __restrict__ beta, T* __restrict__ y,
                        float* __restrict__ mean_out, float* __restrict__ rstd_out, int cols,
                        float eps) {
  using V = mxtpu::Vec16<T>;
  __shared__ float scratch[33];
  const long long row = blockIdx.x;
  const T* xr = x + row * cols;
  T* yr = y + row * cols;
  float s = 0.f;
  for (int c = threadIdx.x; c < cols; c += blockDim.x) s += V::scalar(xr[c]);
  const float mean = mxtpu::block_reduce<false>(s, scratch) / static_cast<float>(cols);
  float q = 0.f;
  for (int c = threadIdx.x; c < cols; c += blockDim.x) {
    const float d = V::scalar(xr[c]) - mean;
    q += d * d;
  }
  const float var = mxtpu::block_reduce<false>(q, scratch) / static_cast<float>(cols);
  const float rstd = rsqrtf(var + eps);
  for (int c = threadIdx.x; c < cols; c += blockDim.x)
    yr[c] = V::round((V::scalar(xr[c]) - mean) * rstd * gamma[c] + beta[c]);
  if (threadIdx.x == 0) {
    mean_out[row] = mean;
    rstd_out[row] = rstd;
  }
}

// out = gelu_tanh(h + bias), bias broadcast over the last axis (width f).
// The tanh form, as jax.nn.gelu's default (approximate=True).
__global__ void __launch_bounds__(kEwThreads)
lm_gelu_bias_kernel(const float* __restrict__ h, const float* __restrict__ bias,
                    float* __restrict__ out, long long n, int f) {
  const float k_sqrt_2_over_pi = 0.7978845608028654f;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const float x = h[i] + bias[i % f];
    const float inner = k_sqrt_2_over_pi * (x + 0.044715f * (x * x * x));
    out[i] = x * (0.5f * (1.f + tanhf(inner)));
  }
}

// Whether the row-resident kernels take these rows: C a multiple of the
// vector width, at most 32 * kLnMaxVecs vectors, 16-byte aligned tensors.
template <typename T>
bool rows_fit(const void* x, const void* y, const float* gamma, const float* beta, int cols) {
  constexpr int kN = mxtpu::Vec16<T>::kN;
  const unsigned long long addr = reinterpret_cast<unsigned long long>(x) |
      reinterpret_cast<unsigned long long>(y) | reinterpret_cast<unsigned long long>(gamma) |
      reinterpret_cast<unsigned long long>(beta);
  return addr % 16 == 0 && cols % kN == 0 && cols / kN <= 32 * kLnMaxVecs;
}

// ln_rows_kernel<T, NV, W, kLm, kEarly> on rows_fit rows, rows_per_block rows
// a block (32 W rows_per_block <= kLnWarpThreads), with the least NV that
// holds a row: start at NV = 1 and double while the row does not fit.
template <typename T, int NV, int W, bool kLm, bool kEarly>
cudaError_t launch_ln_rows(const T* x, const float* gamma, const float* beta, T* y,
                           float* mean, float* rstd, long long rows, int cols, float eps,
                           int rows_per_block, cudaStream_t stream) {
  if constexpr (W * NV < kLnMaxVecs) {
    if (cols / mxtpu::Vec16<T>::kN > 32 * W * NV)
      return launch_ln_rows<T, 2 * NV, W, kLm, kEarly>(x, gamma, beta, y, mean, rstd, rows,
                                                        cols, eps, rows_per_block, stream);
  }
  const long long blocks = (rows + rows_per_block - 1) / rows_per_block;
  ln_rows_kernel<T, NV, W, kLm, kEarly>
      <<<static_cast<unsigned>(blocks), 32 * W * rows_per_block, 0, stream>>>(
          x, gamma, beta, y, mean, rstd, rows, cols, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_ln_op(const void* xv, const float* gamma, const float* beta, void* yv,
                         float* mean, float* rstd, long long rows, int cols, float eps,
                         cudaStream_t stream) {
  const T* x = static_cast<const T*>(xv);
  T* y = static_cast<T*>(yv);
  if (rows_fit<T>(x, y, gamma, beta, cols))
    return launch_ln_rows<T, 1, 1, false, false>(x, gamma, beta, y, mean, rstd, rows, cols, eps,
                                                 kLnWarpThreads / 32, stream);
  layer_norm_op_v1_kernel<T><<<static_cast<unsigned>(rows), kLnThreads, 0, stream>>>(
      x, gamma, beta, y, mean, rstd, cols, eps);
  return cudaGetLastError();
}

// The LM layer norm's launch shape at every row count (see the header).
constexpr int kLmWarpsPerRow = 4;
constexpr int kLmRowsPerBlock = 1;
constexpr bool kLmEarly = true;
static_assert(32 * kLmWarpsPerRow * kLmRowsPerBlock <= kLnWarpThreads, "block too large");

}  // namespace

// x, y: contiguous fp32 [rows, cols]; gamma, beta: fp32 [cols].
MXTPU_API int mxtpu_lm_layer_norm(const float* x, const float* gamma, const float* beta,
                                  float* y, long long rows, int cols, float eps,
                                  void* stream) {
  if (rows <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows_fit<float>(x, y, gamma, beta, cols))
    return static_cast<int>(launch_ln_rows<float, 1, kLmWarpsPerRow, true, kLmEarly>(
        x, gamma, beta, y, nullptr, nullptr, rows, cols, eps, kLmRowsPerBlock, s));
  lm_layer_norm_v1_kernel<<<static_cast<unsigned>(rows), kLnThreads, 0, s>>>(x, gamma, beta, y,
                                                                            cols, eps);
  return static_cast<int>(cudaGetLastError());
}

// The first design (lm_layer_norm_v1_kernel) alone, with mxtpu_lm_layer_norm's
// arguments: for timing it beside the row-resident kernel.
MXTPU_API int mxtpu_lm_layer_norm_v1(const float* x, const float* gamma, const float* beta,
                                     float* y, long long rows, int cols, float eps,
                                     void* stream) {
  if (rows > 0)
    lm_layer_norm_v1_kernel<<<static_cast<unsigned>(rows), kLnThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(x, gamma, beta, y, cols,
                                                                   eps);
  return static_cast<int>(cudaGetLastError());
}

MXTPU_API int mxtpu_lm_gelu_bias(const float* h, const float* bias, float* out, long long n,
                                 int f, void* stream) {
  if (n > 0) {
    long long blocks = (n + kEwThreads - 1) / kEwThreads;
    if (blocks > 132LL * 32) blocks = 132LL * 32;  // grid-stride beyond a few waves
    lm_gelu_bias_kernel<<<static_cast<unsigned>(blocks), kEwThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(h, bias, out, n, f);
  }
  return static_cast<int>(cudaGetLastError());
}

// x, y: contiguous [rows, cols] of one dtype (dtype: mxtpu::DtypeCode, fp32,
// bf16 or fp16); gamma, beta: fp32 [cols]; mean, rstd: fp32 [rows].
MXTPU_API int mxtpu_layer_norm_op(const void* x, const float* gamma, const float* beta,
                                  void* y, float* mean, float* rstd, long long rows, int cols,
                                  float eps, int dtype, void* stream) {
  if (rows <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case mxtpu::kFloat32:
      return static_cast<int>(
          launch_ln_op<float>(x, gamma, beta, y, mean, rstd, rows, cols, eps, s));
    case mxtpu::kBFloat16:
      return static_cast<int>(
          launch_ln_op<__nv_bfloat16>(x, gamma, beta, y, mean, rstd, rows, cols, eps, s));
    case mxtpu::kFloat16:
      return static_cast<int>(
          launch_ln_op<__half>(x, gamma, beta, y, mean, rstd, rows, cols, eps, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The first design (layer_norm_op_v1_kernel), fp32, with mxtpu_layer_norm_op's
// fp32 arguments: for timing it beside the row-resident kernel.
MXTPU_API int mxtpu_layer_norm_op_v1(const float* x, const float* gamma, const float* beta,
                                     float* y, float* mean, float* rstd, long long rows,
                                     int cols, float eps, void* stream) {
  if (rows > 0)
    layer_norm_op_v1_kernel<float><<<static_cast<unsigned>(rows), kLnThreads, 0,
                                     static_cast<cudaStream_t>(stream)>>>(
        x, gamma, beta, y, mean, rstd, cols, eps);
  return static_cast<int>(cudaGetLastError());
}
