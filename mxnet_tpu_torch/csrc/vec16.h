// 16-byte vectors of fp32, bf16 or fp16 elements, converted to and from fp32
// registers: the unit of the row-resident kernels' loads and stores
// (norm_kernels.cu ln_rows_kernel, attention_kernels.cu
// paged_decode_kernel).  Math stays fp32; a low-precision store rounds to
// nearest even, as PyTorch's and JAX's casts do.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace mxtpu {

// Element type codes of the entry points that take more than one dtype.
enum DtypeCode { kFloat32 = 0, kBFloat16 = 1, kFloat16 = 2 };

template <typename T>
struct Vec16;

template <>
struct Vec16<float> {
  static constexpr int kN = 4;
  __device__ __forceinline__ static void unpack(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  __device__ __forceinline__ static uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                      __float_as_uint(f[3]));
  }
  __device__ __forceinline__ static float scalar(float v) { return v; }
  __device__ __forceinline__ static float round(float v) { return v; }
};

// The two 16-bit types: four 32-bit words of two elements each.
#define MXTPU_VEC16_HALF(T, T2, TO_F2, FROM_F2, TO_F, FROM_F)                      \
  template <>                                                                       \
  struct Vec16<T> {                                                                 \
    static constexpr int kN = 8;                                                    \
    __device__ __forceinline__ static void unpack(const uint4& u, float* f) {       \
      const unsigned w[4] = {u.x, u.y, u.z, u.w};                                   \
      _Pragma("unroll") for (int i = 0; i < 4; ++i) {                               \
        const float2 p = TO_F2(*reinterpret_cast<const T2*>(&w[i]));                \
        f[2 * i] = p.x;                                                             \
        f[2 * i + 1] = p.y;                                                         \
      }                                                                             \
    }                                                                               \
    __device__ __forceinline__ static uint4 pack(const float* f) {                  \
      unsigned w[4];                                                                \
      _Pragma("unroll") for (int i = 0; i < 4; ++i) {                               \
        const T2 p = FROM_F2(make_float2(f[2 * i], f[2 * i + 1]));                  \
        w[i] = *reinterpret_cast<const unsigned*>(&p);                              \
      }                                                                             \
      return make_uint4(w[0], w[1], w[2], w[3]);                                    \
    }                                                                               \
    __device__ __forceinline__ static float scalar(T v) { return TO_F(v); }         \
    __device__ __forceinline__ static T round(float v) { return FROM_F(v); }        \
  };

MXTPU_VEC16_HALF(__nv_bfloat16, __nv_bfloat162, __bfloat1622float2, __float22bfloat162_rn,
                 __bfloat162float, __float2bfloat16_rn)
MXTPU_VEC16_HALF(__half, __half2, __half22float2, __float22half2_rn, __half2float,
                 __float2half_rn)
#undef MXTPU_VEC16_HALF

// 16 bytes from global memory through the read-only path.
template <typename T>
__device__ __forceinline__ uint4 load16(const T* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

}  // namespace mxtpu
