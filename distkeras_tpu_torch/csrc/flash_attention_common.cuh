// Pieces shared by the flash-attention kernels (flash_attention_fwd.cu and
// flash_attention_bwd.cu): tile sizes, the thread layout, dtype
// conversions, strided tile loads and the row-group reductions.
//
// Thread layout.  A block of 128 threads covers a 64 x 64 score tile: the
// 8 threads of a row group (adjacent lanes) share 4 rows, and each owns
// the 8 columns tc, tc + 8, ..., tc + 56.  An output tile of 64 rows x D
// columns is split the same way (4 rows x D/8 columns a thread).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 128;
constexpr int kThreadCols = 8;                          // threads sharing a row
constexpr int kThreadRows = kThreads / kThreadCols;     // 16
constexpr int kRowsPerThread = kBlockQ / kThreadRows;   // 4
constexpr int kColsPerThread = kBlockK / kThreadCols;   // 8
constexpr float kNegBig = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

struct Strides {  // element strides of a [batch, seq, heads, dim] tensor
  long long b, l, h;
};

// Copy rows [row0, row0 + 64) of one (batch, head) slice into shared memory
// as f32; rows at or past `rows_valid` are zero-filled.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, int dst_stride, const T* src,
                                          long long row_stride, int row0, int rows_valid) {
  for (int e = threadIdx.x; e < 64 * D; e += kThreads) {
    const int r = e / D;
    const int c = e % D;
    const int row = row0 + r;
    dst[r * dst_stride + c] = row < rows_valid ? to_f32(src[row * row_stride + c]) : 0.f;
  }
}

__device__ __forceinline__ float row_group_max(float x) {
#pragma unroll
  for (int off = 1; off < kThreadCols; off <<= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float row_group_sum(float x) {
#pragma unroll
  for (int off = 1; off < kThreadCols; off <<= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

}  // namespace

// Message for a cudaError_t returned by an entry point; each library built
// from a source that includes this header carries its own copy.
extern "C" const char* dk_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
