// The bf16 wgmma pieces of the flash kernels (flash_bf16.cu,
// flash_bwd_bf16_sm90.cu): shared-memory descriptors of tiles stored
// row-major in 128-byte swizzled atoms of 64 columns, the m64nNk16 bf16
// products with both operands in shared memory or A in registers, the
// accumulator -> A fragment conversion, the rows' bf16 store and the
// softmax's base-2 exponential.
#pragma once

#include <cuda_bf16.h>

#include "common.h"

namespace mxtpu {

using bf16 = __nv_bfloat16;

// Shared-memory descriptor, 128-byte swizzle, 8-row groups 1024 bytes apart
// (SBO); `lbo` bytes between 64-column atoms of an MN-major operand (a
// K-major one takes 16, unused).
__device__ __forceinline__ unsigned long long sdesc(const void* p, int lbo) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  return static_cast<unsigned long long>((addr & 0x3FFFF) >> 4) |
         (static_cast<unsigned long long>((lbo >> 4) & 0x3FFF) << 16) | (64ull << 32) |
         (1ull << 62);
}

// Byte offset of element (r, col) of a row-major bf16 tile of `rows` rows:
// 64-column atoms `rows * 128` bytes apart; in an atom, row r at r * 128,
// its 16-byte units XOR r % 8.
__device__ __forceinline__ int swz(int rows, int r, int col) {
  return (col / 64) * rows * 128 + r * 128 + ((((col % 64) / 8) ^ (r % 8)) * 16) +
         (col % 8) * 2;
}

// Columns of a tile: D, or 64 at D = 32 (the pad reads as zero).
template <int D>
__host__ __device__ constexpr int cols() {
  return D < 64 ? 64 : D;
}

// d[64 x N] (+)= a[64 x 16] @ b[16 x N], both K-major in shared memory; the
// sum starts from d when acc != 0, from zero otherwise.
template <int N>
__device__ __forceinline__ void wgmma_ss(float* d, unsigned long long a, unsigned long long b,
                                         int acc);

template <>
__device__ __forceinline__ void wgmma_ss<64>(float* d, unsigned long long a,
                                             unsigned long long b, int acc) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(a), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_ss<32>(float* d, unsigned long long a,
                                             unsigned long long b, int acc) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(acc));
}

// d[64 x 64] += a[64 x 16] (registers, bf16 A fragments) @ b[16 x 64]
// (shared memory, MN-major: the instruction transposes it).
__device__ __forceinline__ void wgmma_rs_t(float* d, const unsigned* a, unsigned long long b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// S (+)= A B^T over the D columns of a resident A tile (this warpgroup's 64
// rows, `a_rows` rows in all) and a streamed B tile of N rows.
template <int D, int N>
__device__ __forceinline__ void product_ss(float* s, const unsigned char* a, int a_rows,
                                           int a_row0, const unsigned char* b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int ka = (kk / 4) * a_rows * 128 + a_row0 * 128 + (kk % 4) * 32;
    const int kb = (kk / 4) * N * 128 + (kk % 4) * 32;
    wgmma_ss<N>(s, sdesc(a + ka, 16), sdesc(b + kb, 16), kk > 0);
  }
}

// d[n] += A_frags @ B, B a streamed tile of R rows (the k axis) read
// MN-major, 64 columns per accumulator.
template <int D, int R>
__device__ __forceinline__ void product_rs(float (&d)[cols<D>() / 64][32],
                                           const unsigned (&a)[R / 16][4],
                                           const unsigned char* b) {
#pragma unroll
  for (int n = 0; n < cols<D>() / 64; ++n)
#pragma unroll
    for (int kk = 0; kk < R / 16; ++kk)
      wgmma_rs_t(d[n], a[kk], sdesc(b + n * R * 128 + kk * 16 * 128, R * 128));
}

// An m64nN fp32 accumulator rounded to bf16 A fragments, column blocks 2kk
// and 2kk + 1 being k-step kk.
template <int N>
__device__ __forceinline__ void to_frags(const float* x, unsigned (&a)[N / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    a[kk][0] = pack_bf16(x[8 * kk], x[8 * kk + 1]);
    a[kk][1] = pack_bf16(x[8 * kk + 2], x[8 * kk + 3]);
    a[kk][2] = pack_bf16(x[8 * kk + 4], x[8 * kk + 5]);
    a[kk][3] = pack_bf16(x[8 * kk + 6], x[8 * kk + 7]);
  }
}

// Rows row0 and row1 (this thread's) of accumulators d, rounded to bf16, to
// a row-major [len][D] matrix.
template <int D>
__device__ __forceinline__ void store_rows(bf16* __restrict__ dst,
                                           const float (&d)[cols<D>() / 64][32], int row0,
                                           int row1, int len, int c, float s0 = 1.f,
                                           float s1 = 1.f) {
#pragma unroll
  for (int n = 0; n < cols<D>() / 64; ++n)
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int col = n * 64 + 8 * i + 2 * c;
      if (col >= D) continue;
      if (row0 < len)
        *reinterpret_cast<unsigned*>(dst + static_cast<long long>(row0) * D + col) =
            pack_bf16(d[n][4 * i] * s0, d[n][4 * i + 1] * s0);
      if (row1 < len)
        *reinterpret_cast<unsigned*>(dst + static_cast<long long>(row1) * D + col) =
            pack_bf16(d[n][4 * i + 2] * s1, d[n][4 * i + 3] * s1);
    }
}

template <int D>
__device__ __forceinline__ void zero_acc(float (&d)[cols<D>() / 64][32]) {
#pragma unroll
  for (int n = 0; n < cols<D>() / 64; ++n)
#pragma unroll
    for (int i = 0; i < 32; ++i) d[n][i] = 0.f;
}

// The softmax's exponentials in base 2, the scale folded in: p =
// 2^(s * scale * log2(e) - m * log2(e)) is one FFMA and one ex2.approx
// (within 2 ulps; 2^-huge is +0).
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

}  // namespace mxtpu
