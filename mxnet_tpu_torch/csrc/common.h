// Shared by every kernel library of mxnet_tpu_torch.
//
// Each csrc/*.cu file is compiled by nvcc alone into its own shared library
// with a plain C interface (no PyTorch headers), loaded from Python with
// ctypes (mxnet_tpu_torch/ops/_build.py).  Every C entry point takes the
// CUDA stream as its last argument, launches on it, does not synchronise,
// and returns cudaGetLastError() so the Python wrapper can raise on a
// refused launch.
#pragma once

#include <cuda_runtime.h>

#define MXTPU_API extern "C" __attribute__((visibility("default")))

// Text for an error code returned by an entry point of this library.
MXTPU_API const char* mxtpu_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

namespace mxtpu {

constexpr unsigned kFullMask = 0xffffffffu;
// Masked scores, as in the JAX package (ops/attention.py _NEG_INF): set
// before the row max, so exp() of a masked lane underflows to exactly 0.
constexpr float kNegInf = -1e30f;

// 16 bytes global -> shared, asynchronously (cp.async); zero-filled when
// !pred, and then no byte of src is read.
__device__ __forceinline__ void cp_async16(void* smem, const void* src, bool pred) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(pred ? 16 : 0));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFullMask, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFullMask, v, o));
  return v;
}

// Sum (or max) over the whole block; every thread gets the result.
// `scratch` holds at least 33 floats.  blockDim.x is a multiple of 32.
template <bool kMax>
__device__ __forceinline__ float block_reduce(float v, float* scratch) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  v = kMax ? warp_max(v) : warp_sum(v);
  __syncthreads();  // scratch may still be read by a previous call
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float w = lane < nwarps ? scratch[lane] : (kMax ? kNegInf : 0.f);
    w = kMax ? warp_max(w) : warp_sum(w);
    if (lane == 0) scratch[32] = w;
  }
  __syncthreads();
  return scratch[32];
}

}  // namespace mxtpu
