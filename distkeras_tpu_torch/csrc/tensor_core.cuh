// Tensor-core and asynchronous-copy building blocks for sm_80 and later
// (used on sm_90a): mma.sync products on TF32, bf16 and f16 operands, the
// 3xTF32 split of an f32 value, ldmatrix, cp.async with zero-fill, strided
// tile copies into padded shared rows, and paired stores.
//
// A TF32 operand is an f32 register of which the tensor cores read the
// sign, the exponent and the top 10 mantissa bits: the low 13 bits are
// dropped (truncation), so any f32 value may be passed as is.
//
// Fragment layouts of mma.sync.m16n8k8 (TF32) and m16n8k16 (bf16; f16 has
// the same), with g = lane / 4 and t = lane % 4 (the PTX ISA, "Matrix
// Fragments for mma.m16n8k8" and "... mma.m16n8k16"):
//   C/D (16 x 8, f32):  c0 (g, 2t)  c1 (g, 2t+1)  c2 (g+8, 2t)  c3 (g+8, 2t+1)
//   A tf32 (16 x 8):    a0 (g, t)   a1 (g+8, t)   a2 (g, t+4)   a3 (g+8, t+4)
//   B tf32 (8 x 8):     b0 (k t, n g)  b1 (k t+4, n g)
//   A bf16 (16 x 16):   a0 (g, 2t..2t+1)  a1 (g+8, 2t..)  a2 (g, 2t+8..)  a3 (g+8, 2t+8..)
//   B bf16 (16 x 8):    b0 (k 2t..2t+1, n g)  b1 (k 2t+8..2t+9, n g)

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

// The 3xTF32 split, two instructions: big is x truncated to TF32 (its low
// 13 mantissa bits cleared), small = x - big exactly; the tensor cores
// truncate small in turn, so big + small reads as x to 2^-21 |x|.
__device__ __forceinline__ void split_tf32(float x, unsigned& big, unsigned& small) {
  big = __float_as_uint(x) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

// d += a b on the tensor cores: A 16 x 8 and B 8 x 8 in TF32, D in f32.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b on the tensor cores: A 16 x 16 and B 16 x 8 in bf16, D in f32.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b on the tensor cores: A 16 x 16 and B 16 x 8 in f16, D in f32.
__device__ __forceinline__ void mma_f16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                        unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The 16-bit input types (bf16 and f16): their products run on m16n8k16.
template <typename T>
inline constexpr bool kIs16Bit =
    std::is_same_v<T, __nv_bfloat16> || std::is_same_v<T, __half>;

// d += a b on m16n8k16 in T, bf16 or f16.
template <typename T>
__device__ __forceinline__ void mma_16bit(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                          unsigned b1) {
  if constexpr (std::is_same_v<T, __half>) {
    mma_f16(d, a, b0, b1);
  } else {
    mma_bf16(d, a, b0, b1);
  }
}

// A 16-bit value as f32 (exact: bf16 and f16 both fit TF32's 11
// significant bits and f32's exponent range).
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Four 8 x 8 b16 matrices from shared memory: lanes 8i..8i+7 give the row
// addresses of matrix i (16 bytes each, 16-byte aligned); r[i] receives
// row lane / 4, elements 2 (lane % 4) and 2 (lane % 4) + 1 of matrix i.
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(row)));
}

// 16 bytes global -> shared, bypassing L1; fewer than 16 source bytes
// (0 past the ragged edge) zero-fill the rest.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(smem_addr(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}

// 4 bytes global -> shared, zero-filled when src_bytes is 0.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(smem_addr(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Wait until at most N committed groups of this thread are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Shared row stride, in elements, of a tile of D-element rows: the row plus
// 16 bytes, which makes the f32 fragment loads and the bf16 ldmatrix loads
// of a warp free of bank conflicts and keeps every row 16-byte aligned.
template <typename T, int D>
__host__ __device__ constexpr int padded_stride() {
  return D + 16 / static_cast<int>(sizeof(T));
}

// Start copying rows [row0, row0 + ROWS) of a [rows, D] slice (row stride
// `row_stride` elements, every row 16-byte aligned) into a shared tile of
// padded rows, 16 bytes a copy, spread over the THREADS threads of the
// block; rows at or past `rows_valid` are zero-filled.
template <typename T, int D, int ROWS, int THREADS>
__device__ __forceinline__ void load_tile_async(T* dst, const T* src, long long row_stride,
                                                int row0, int rows_valid) {
  constexpr int kChunks = D * static_cast<int>(sizeof(T)) / 16;  // 16-byte copies a row
  constexpr int kElems = 16 / static_cast<int>(sizeof(T));
  constexpr int ST = padded_stride<T, D>();
  static_assert((ROWS * kChunks) % THREADS == 0, "every thread copies alike");
#pragma unroll
  for (int i = 0; i < ROWS * kChunks / THREADS; ++i) {
    const int e = static_cast<int>(threadIdx.x) + i * THREADS;
    const int r = e / kChunks;
    const int c = (e % kChunks) * kElems;
    const int row = row0 + r;
    const bool valid = row < rows_valid;
    cp_async16(dst + r * ST + c, src + (valid ? row * row_stride + c : 0), valid ? 16 : 0);
  }
}

// Two adjacent outputs from f32 values, in one store.
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(__half* p, float a, float b) {
  *reinterpret_cast<__half2*>(p) = __floats2half2_rn(a, b);
}

}  // namespace
