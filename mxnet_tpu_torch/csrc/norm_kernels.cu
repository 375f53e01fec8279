// LM layer norm and the FFN's GELU+bias epilogue, fp32, for sm_90a.
//
// Replace the Pallas kernels of mxnet_tpu/ops/fused/norm_kernels.py:
//   mxtpu_lm_layer_norm  <- fused_lm_layer_norm (_lm_ln_kernel)
//   mxtpu_lm_gelu_bias   <- fused_lm_gelu_bias (_gelu_bias_kernel)
//   mxtpu_layer_norm_op  <- fused_layer_norm_op (_ln_op_kernel), the LayerNorm
//                           registry op of the training graph; it also writes
//                           each row's mean and 1/std for the backward
//
// What bounds them on an H100: both read each input once and write each
// output once with a handful of fp32 operations per element, so they are
// bound by device memory (3.35 TB/s on the SXM part).  At the generation
// lane's widths: layer norm of a [512, 1024] prefill block moves 4.2 MB
// (about 1.3 us at the memory rate), GELU+bias of the [512, 4096] FFN
// hidden moves 16.8 MB (about 5 us); a decode step's [8, 1024] rows are
// launch-bound.  The training graph's LayerNorm op on [8 * 2048, 1024] moves
// 134 MB (about 40 us).  The design keeps every intermediate in registers: one
// block per row for the norm (mean and population variance by two block
// reductions, then the affine, all from the same row), one grid-stride
// pass for the epilogue.

#include "common.h"

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

// The LayerNorm op: y = (x - mean) * rsqrt(var + eps) * gamma + beta over the
// last axis, population variance by a second pass over the row (not
// E[x^2] - E[x]^2): the JAX package's spelling (ops/attention.py _layer_norm).
// mean_out and rstd_out get one value per row for the backward.
__global__ void __launch_bounds__(kLnThreads)
layer_norm_op_kernel(const float* __restrict__ x, const float* __restrict__ gamma,
                     const float* __restrict__ beta, float* __restrict__ y,
                     float* __restrict__ mean_out, float* __restrict__ rstd_out, int cols,
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
  const float rstd = rsqrtf(var + eps);
  for (int c = threadIdx.x; c < cols; c += blockDim.x)
    yr[c] = (xr[c] - mean) * rstd * gamma[c] + beta[c];
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

MXTPU_API int mxtpu_layer_norm_op(const float* x, const float* gamma, const float* beta,
                                  float* y, float* mean, float* rstd, long long rows, int cols,
                                  float eps, void* stream) {
  if (rows > 0)
    layer_norm_op_kernel<<<static_cast<unsigned>(rows), kLnThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(x, gamma, beta, y, mean, rstd,
                                                                cols, eps);
  return static_cast<int>(cudaGetLastError());
}
