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
// hidden moves 16.8 MB (about 5 us); a decode step's [8, 1024] rows are
// launch-bound.  The training graph's LayerNorm op on [8 * 2048, 1024] fp32
// moves 134 MB (about 40 us; half that in bf16).
//
// The LayerNorm op (layer_norm_op_kernel) keeps each row in registers: one
// warp a row, each lane reading its share with 16-byte loads (8 float4 a lane
// at C = 1024 fp32, 4 vectors of 8 at bf16), all issued before any
// arithmetic, so a warp has the whole row in flight.  Mean and then the
// centred variance come from those registers by warp shuffles alone (no
// shared memory, no block barrier); y leaves by 16-byte stores, and gamma and
// beta come from L1 as they are needed.  (Persistent warps holding gamma and
// beta in registers measured slower in fp32 on the H100: 128 registers a
// thread halve the warps in flight, and the last rows leave a tail.)  It
// takes C a multiple of the vector width (4 fp32, 8 bf16/fp16) up to 32 * 8
// vectors, with 16-byte aligned tensors; any other row goes to
// layer_norm_op_v1_kernel, the port's first design (one block a row, two
// block reductions, the row read three times), which mxtpu_layer_norm_op_v1
// also runs in fp32 so a run on the card can time the two in turns.  The LM
// layer norm keeps that first design.  x and y share one dtype; gamma, beta,
// mean and rstd are fp32 and all math is fp32, y rounded once to x's dtype
// (the JAX kernel's _ln_op_kernel).

#include "common.h"
#include "vec16.h"

namespace {

constexpr int kLnThreads = 256;
constexpr int kEwThreads = 256;

// y = (x - mean) / sqrt(var + eps) * gamma + beta over the last axis, with
// the population variance mean((x - mean)^2): the JAX package's spelling
// (models/transformer.py _lm_ln_stock), sqrt and division rather than rsqrt.
__global__ void __launch_bounds__(kLnThreads)
lm_layer_norm_kernel(const float* __restrict__ x, const float* __restrict__ gamma,
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

constexpr int kLnWarpThreads = 256;
constexpr int kLnMaxVecs = 8;   // 16-byte vectors a lane holds, at most

// The LayerNorm op: y = (x - mean) * rsqrt(var + eps) * gamma + beta over the
// last axis, population variance by a second pass over the row (not
// E[x^2] - E[x]^2): the JAX package's spelling (ops/attention.py _layer_norm).
// mean_out and rstd_out get one value per row for the backward.  One warp a
// row, NV vectors of 16 bytes a lane (vector j of a lane is lane + 32 j);
// cols is a multiple of the vector width and at most 32 * NV vectors.
template <typename T, int NV>
__global__ void __launch_bounds__(kLnWarpThreads)
layer_norm_op_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                     const float* __restrict__ beta, T* __restrict__ y,
                     float* __restrict__ mean_out, float* __restrict__ rstd_out,
                     long long rows, int cols, float eps) {
  using V = mxtpu::Vec16<T>;
  constexpr int kN = V::kN;
  const int lane = threadIdx.x & 31;
  const long long row = (static_cast<long long>(blockIdx.x) * kLnWarpThreads + threadIdx.x) >> 5;
  if (row >= rows) return;   // whole warps
  const int nvec = cols / kN;
  const T* xr = x + row * cols;
  T* yr = y + row * cols;
  uint4 raw[NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int v = lane + 32 * j;
    raw[j] = v < nvec ? mxtpu::load16(xr + v * kN) : make_uint4(0u, 0u, 0u, 0u);
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
  const float mean = mxtpu::warp_sum(s) * inv_cols;
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
  const float rstd = rsqrtf(mxtpu::warp_sum(q) * inv_cols + eps);
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int v = lane + 32 * j;
    if (v < nvec) {
      float o[kN];
#pragma unroll
      for (int i = 0; i < kN; i += 4) {
        const float4 g = __ldg(reinterpret_cast<const float4*>(gamma + v * kN + i));
        const float4 b = __ldg(reinterpret_cast<const float4*>(beta + v * kN + i));
        o[i] = (xv[j][i] - mean) * rstd * g.x + b.x;
        o[i + 1] = (xv[j][i + 1] - mean) * rstd * g.y + b.y;
        o[i + 2] = (xv[j][i + 2] - mean) * rstd * g.z + b.z;
        o[i + 3] = (xv[j][i + 3] - mean) * rstd * g.w + b.w;
      }
      *reinterpret_cast<uint4*>(yr + v * kN) = V::pack(o);
    }
  }
  if (lane == 0) {
    mean_out[row] = mean;
    rstd_out[row] = rstd;
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

template <typename T, int NV>
cudaError_t launch_ln_op_warps(const T* x, const float* gamma, const float* beta, T* y,
                               float* mean, float* rstd, long long rows, int cols, float eps,
                               cudaStream_t stream) {
  constexpr int kRowsPerBlock = kLnWarpThreads / 32;
  const long long blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  layer_norm_op_kernel<T, NV><<<static_cast<unsigned>(blocks), kLnWarpThreads, 0, stream>>>(
      x, gamma, beta, y, mean, rstd, rows, cols, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_ln_op(const void* xv, const float* gamma, const float* beta, void* yv,
                         float* mean, float* rstd, long long rows, int cols, float eps,
                         cudaStream_t stream) {
  const T* x = static_cast<const T*>(xv);
  T* y = static_cast<T*>(yv);
  constexpr int kN = mxtpu::Vec16<T>::kN;
  const unsigned long long addr = reinterpret_cast<unsigned long long>(x) |
      reinterpret_cast<unsigned long long>(y) | reinterpret_cast<unsigned long long>(gamma) |
      reinterpret_cast<unsigned long long>(beta);
  const int nvec = cols / kN;
  if (addr % 16 == 0 && cols % kN == 0 && nvec <= 32 * kLnMaxVecs) {
    if (nvec <= 32)
      return launch_ln_op_warps<T, 1>(x, gamma, beta, y, mean, rstd, rows, cols, eps, stream);
    if (nvec <= 64)
      return launch_ln_op_warps<T, 2>(x, gamma, beta, y, mean, rstd, rows, cols, eps, stream);
    if (nvec <= 128)
      return launch_ln_op_warps<T, 4>(x, gamma, beta, y, mean, rstd, rows, cols, eps, stream);
    return launch_ln_op_warps<T, 8>(x, gamma, beta, y, mean, rstd, rows, cols, eps, stream);
  }
  layer_norm_op_v1_kernel<T><<<static_cast<unsigned>(rows), kLnThreads, 0, stream>>>(
      x, gamma, beta, y, mean, rstd, cols, eps);
  return cudaGetLastError();
}

}  // namespace

MXTPU_API int mxtpu_lm_layer_norm(const float* x, const float* gamma, const float* beta,
                                  float* y, long long rows, int cols, float eps,
                                  void* stream) {
  if (rows > 0)
    lm_layer_norm_kernel<<<static_cast<unsigned>(rows), kLnThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(x, gamma, beta, y, cols, eps);
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
// fp32 arguments: for timing it beside layer_norm_op_kernel.
MXTPU_API int mxtpu_layer_norm_op_v1(const float* x, const float* gamma, const float* beta,
                                     float* y, float* mean, float* rstd, long long rows,
                                     int cols, float eps, void* stream) {
  if (rows > 0)
    layer_norm_op_v1_kernel<float><<<static_cast<unsigned>(rows), kLnThreads, 0,
                                     static_cast<cudaStream_t>(stream)>>>(
        x, gamma, beta, y, mean, rstd, cols, eps);
  return static_cast<int>(cudaGetLastError());
}
