// Pieces shared by the flash-attention kernels (flash_attention_fwd.cu and
// flash_attention_bwd.cu): the block shape, the tiles, and the two tile
// products on the tensor cores that every kernel is built from.
//
// A block of 4 warps owns 64 rows of its output, 16 a warp, and loops over
// tiles of the other operand, which stream through shared memory in the
// input dtype (rows padded by 16 bytes, tensor_core.cuh :: padded_stride).
// Every product runs on mma.sync with f32 accumulators:
//   f32 tiles: 3xTF32, the arithmetic of PyTorch's f32 memory-efficient
//     attention: each operand x = big + small with big = x truncated to
//     TF32 and small = x - big, and a b = a_small b_big + a_big b_small +
//     a_big b_big, which keeps about f32 accuracy (one TF32 pass does not:
//     its 2^-10 relative error breaks the 1e-4 gates);
//   bf16 and f16 tiles: a product of two 16-bit tiles on m16n8k16 in their
//     type (16-bit products are exact in f32, as on the TPU); an f32 left
//     operand (P or dS, never rounded to 16 bits: the TPU kernels multiply
//     them in f32) times a 16-bit tile, which is exact in TF32, as two TF32
//     passes.
// The first product (rows_dot_rows) leaves its 16 x BN result in the
// accumulator layout, which holds columns 2t and 2t+1 of each 8-column
// block where an A fragment wants columns t and t+4; the second product
// (tile_times_rows) permutes its k index the same way (MMA column t <->
// column 2t, t+4 <-> 2t+1) and reads B's rows in that order, so the first
// result goes into the second product's A fragments in registers.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "tensor_core.cuh"

namespace {

constexpr int kThreads = 128;   // 4 warps
// Blocks an SM the registers must allow.  Shared memory holds two f32
// d = 64 blocks of the backward (104 KB each); left unsaid, ptxas caps the
// registers for three and the dQ kernel runs slower.
constexpr int kMinBlocks = 2;
constexpr int kOwnedRows = 64;  // output rows a block owns, 16 a warp
constexpr float kNegBig = -1e30f;  // the TPU kernels' mask value (not -inf)
constexpr float kLog2e = 1.4426950408889634f;

struct Strides {  // element strides of a [batch, seq, heads, dim] tensor
  long long b, l, h;
};

template <typename T, int D>
struct Tiles {
  // rows of a streamed tile: 32 at d = 128 keeps the accumulators and the
  // tile's scores in registers and two blocks' tiles in shared memory; 16
  // at d = 256 keeps the backward's f32 tiles (two owned, two stages of two
  // streamed: 195 KB) within the 227 KB a block may have
  static constexpr int kStream = D == 256 ? 16 : D == 128 ? 32 : 64;
  static constexpr int kStride = padded_stride<T, D>();  // shared row stride in elements
  static constexpr int kOwned = kOwnedRows * kStride;    // elements of an owned tile
  static constexpr int kStreamed = kStream * kStride;    // elements of a streamed tile
};

// The A fragments of k-step [kk, kk + 8) of the warp's 16 rows of an f32
// tile (`a` points at its first row), split into big and small.
template <int D>
__device__ __forceinline__ void a_fragment(const float* a, int kk, int lane, unsigned (&big)[4],
                                           unsigned (&small)[4]) {
  constexpr int ST = Tiles<float, D>::kStride;
  const int g = lane >> 2;
  const int t = lane & 3;
  split_tf32(a[g * ST + kk + t], big[0], small[0]);
  split_tf32(a[(g + 8) * ST + kk + t], big[1], small[1]);
  split_tf32(a[g * ST + kk + t + 4], big[2], small[2]);
  split_tf32(a[(g + 8) * ST + kk + t + 4], big[3], small[3]);
}

// The A fragment of k-step [kk, kk + 16) of the warp's 16 rows of a 16-bit
// (bf16 or f16) tile.
template <int D, typename T, std::enable_if_t<kIs16Bit<T>, int> = 0>
__device__ __forceinline__ void a_fragment(const T* a, int kk, int lane, unsigned (&f)[4]) {
  constexpr int ST = Tiles<T, D>::kStride;
  ldmatrix_x4(f, a + (lane & 15) * ST + kk + (lane >> 4) * 8);
}

// s += A B^T over k-step [kk, kk + 8): A given by its split fragments, B
// the BN rows of an f32 tile; block n of s holds columns 8n..8n+7.  3xTF32.
template <int D, int BN>
__device__ __forceinline__ void dot_rows_step(float (&s)[BN / 8][4], const unsigned (&ab)[4],
                                              const unsigned (&as)[4], const float* b, int kk,
                                              int lane) {
  constexpr int ST = Tiles<float, D>::kStride;
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int n = 0; n < BN / 8; ++n) {
    unsigned bb[2], bs[2];
    split_tf32(b[(8 * n + g) * ST + kk + t], bb[0], bs[0]);
    split_tf32(b[(8 * n + g) * ST + kk + t + 4], bb[1], bs[1]);
    mma_tf32(s[n], as, bb);
    mma_tf32(s[n], ab, bs);
    mma_tf32(s[n], ab, bb);
  }
}

// As above over k-step [kk, kk + 16) of 16-bit tiles: m16n8k16 products in
// the tiles' type, B's fragments by ldmatrix.
template <int D, int BN, typename T, std::enable_if_t<kIs16Bit<T>, int> = 0>
__device__ __forceinline__ void dot_rows_step(float (&s)[BN / 8][4], const unsigned (&af)[4],
                                              const T* b, int kk, int lane) {
  constexpr int ST = Tiles<T, D>::kStride;
#pragma unroll
  for (int n = 0; n < BN / 8; n += 2) {
    unsigned bf[4];  // column blocks n and n + 1, k halves low and high
    ldmatrix_x4(bf, b + (8 * n + (lane & 7) + (lane >> 4) * 8) * ST + kk + ((lane >> 3) & 1) * 8);
    mma_16bit<T>(s[n], af, bf[0], bf[1]);
    mma_16bit<T>(s[n + 1], af, bf[2], bf[3]);
  }
}

// s += A B^T over the head dim: A is the warp's 16 rows of an owned tile
// (`a` points at its first row), B the BN rows of a streamed tile; block n
// of s holds columns 8n..8n+7, in the accumulator layout.
template <int D, int BN>
__device__ __forceinline__ void rows_dot_rows(float (&s)[BN / 8][4], const float* a,
                                              const float* b, int lane) {
#pragma unroll
  for (int kk = 0; kk < D; kk += 8) {
    unsigned ab[4], as[4];
    a_fragment<D>(a, kk, lane, ab, as);
    dot_rows_step<D, BN>(s, ab, as, b, kk, lane);
  }
}

template <int D, int BN, typename T, std::enable_if_t<kIs16Bit<T>, int> = 0>
__device__ __forceinline__ void rows_dot_rows(float (&s)[BN / 8][4], const T* a, const T* b,
                                              int lane) {
#pragma unroll
  for (int kk = 0; kk < D; kk += 16) {
    unsigned af[4];
    a_fragment<D>(a, kk, lane, af);
    dot_rows_step<D, BN>(s, af, b, kk, lane);
  }
}

// The A fragments (big and small halves) of an 8-column block of a tile in
// the accumulator layout, with the permuted k index: MMA column t is column
// 2t and MMA column t + 4 is column 2t + 1.
__device__ __forceinline__ void acc_to_a(const float (&c)[4], unsigned (&big)[4],
                                         unsigned (&small)[4]) {
  split_tf32(c[0], big[0], small[0]);  // (g, 2t)
  split_tf32(c[2], big[1], small[1]);  // (g + 8, 2t)
  split_tf32(c[1], big[2], small[2]);  // (g, 2t + 1)
  split_tf32(c[3], big[3], small[3]);  // (g + 8, 2t + 1)
}

// acc += P B: P is the warp's 16 x BN tile in the accumulator layout (an
// f32 left operand), B the BN x D streamed tile, whose rows are read in the
// permuted k order of acc_to_a.  f32 B: 3xTF32.
template <int D, int BN>
__device__ __forceinline__ void tile_times_rows(float (&acc)[D / 8][4],
                                                const float (&p)[BN / 8][4], const float* b,
                                                int lane) {
  constexpr int ST = Tiles<float, D>::kStride;
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    unsigned ab[4], as[4];
    acc_to_a(p[j], ab, as);
    const float* r = b + (8 * j + 2 * t) * ST + g;  // rows 2t and 2t + 1 of block j
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      unsigned bb[2], bs[2];
      split_tf32(r[8 * n], bb[0], bs[0]);
      split_tf32(r[ST + 8 * n], bb[1], bs[1]);
      mma_tf32(acc[n], as, bb);
      mma_tf32(acc[n], ab, bs);
      mma_tf32(acc[n], ab, bb);
    }
  }
}

// As above with a 16-bit B, exact in TF32: two passes (P_small B + P_big B).
template <int D, int BN, typename T, std::enable_if_t<kIs16Bit<T>, int> = 0>
__device__ __forceinline__ void tile_times_rows(float (&acc)[D / 8][4],
                                                const float (&p)[BN / 8][4], const T* b,
                                                int lane) {
  constexpr int ST = Tiles<T, D>::kStride;
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    unsigned ab[4], as[4];
    acc_to_a(p[j], ab, as);
    const T* r = b + (8 * j + 2 * t) * ST + g;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const unsigned bb[2] = {__float_as_uint(to_float(r[8 * n])),
                              __float_as_uint(to_float(r[ST + 8 * n]))};
      mma_tf32(acc[n], as, bb);
      mma_tf32(acc[n], ab, bb);
    }
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&x)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[i][e] = 0.f;
}

int check_grid(long long blocks) {
  return (blocks <= 0 || blocks > 0x7fffffffLL) ? static_cast<int>(cudaErrorInvalidConfiguration)
                                                : 0;
}

}  // namespace

// Message for a cudaError_t returned by an entry point; each library built
// from a source that includes this header carries its own copy.
extern "C" const char* dk_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
