// FlashAttention forward for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel distkeras_tpu/ops/pallas/flash_attention.py
// :: _fwd_kernel (launched by _fwd_call).  It computes the same function:
//   S = Q K^T * scale in f32, masked with -1e30 (not -inf) outside the valid
//   rows/columns and, when causal, above the diagonal (row >= col kept);
//   online softmax with a running max m and denominator l;
//   O = acc / l in the input dtype, LSE = m + log(l) in f32, and O = 0,
//   LSE = 0 for a row whose denominator is 0.
//
// What bounds it on this card.  At the inference path's shape
// (b*h = 16*12, L = 1024, d = 64, f32) the kernel does 4*b*h*L^2*d = 51.5
// GFLOP (about half of that when causal) and must move only
// 4*b*h*L*d*4 bytes = 201 MB (Q, K, V in, O out).  Against the card's f32
// rate outside the tensor cores (67 TFLOP/s) and its 3.35 TB/s of memory
// bandwidth that is 0.77 ms of arithmetic against 0.06 ms of traffic: the
// kernel is bound by operations, not bytes.  Computing in f32 (as the JAX
// kernel does) rules out the tensor cores, whose float32 path is TF32.
//
// What the design does about it.  One thread block owns one (batch*head,
// 64-row query tile) and walks the K/V tiles in a loop, which replaces the
// TPU's sequential innermost grid axis.  The running max, denominator and
// the 64 x d accumulator live in registers (each thread owns 4 rows x d/8
// columns); Q, one K/V tile and the probability tile P are staged in shared
// memory as f32, so each element is read from device memory once per tile
// and every multiply-add is an FMA on registers fed from shared memory.
// Rows of Q and K are padded by one float to keep the warp's shared-memory
// reads free of bank conflicts.  K tiles wholly above the diagonal are
// never visited when causal, and the blocks of a (batch, head) are issued
// heaviest query tile first so that causal tails do not straggle.  Q, K and
// V are read in their [batch, seq, heads, dim] layout through strides: no
// transpose and no padded copy, the ragged edge is masked against the true
// lengths.  Tensor-core (wgmma) tiles, TMA and warp specialisation are left
// for a later revision.

#include "flash_attention_common.cuh"

namespace {

template <int D>
struct Smem {
  static constexpr int kQStride = D + 1;
  static constexpr int kKStride = D + 1;
  static constexpr int kVStride = D;
  static constexpr int kPStride = kBlockK + 1;
  static constexpr int kBytes =
      (kBlockQ * kQStride + kBlockK * kKStride + kBlockK * kVStride + kBlockQ * kPStride) *
      static_cast<int>(sizeof(float));
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ lse, int heads, int lq, int lk,
                 Strides q_st, Strides k_st, Strides v_st, int causal, float scale) {
  using S = Smem<D>;
  constexpr int R = kRowsPerThread;
  constexpr int C = kColsPerThread;
  constexpr int DN = D / kThreadCols;  // output columns per thread
  extern __shared__ float smem[];
  float* q_tile = smem;
  float* k_tile = q_tile + kBlockQ * S::kQStride;
  float* v_tile = k_tile + kBlockK * S::kKStride;
  float* p_tile = v_tile + kBlockK * S::kVStride;

  const int n_qblocks = (lq + kBlockQ - 1) / kBlockQ;
  const int bh = blockIdx.x / n_qblocks;
  const int qblock = n_qblocks - 1 - static_cast<int>(blockIdx.x % n_qblocks);
  const int b = bh / heads;
  const int h = bh % heads;
  const int q0 = qblock * kBlockQ;
  const int tc = threadIdx.x % kThreadCols;
  const int r0 = (threadIdx.x / kThreadCols) * R;  // first tile row of this thread

  const T* qp = q + b * q_st.b + h * q_st.h;
  const T* kp = k + b * k_st.b + h * k_st.h;
  const T* vp = v + b * v_st.b + h * v_st.h;
  load_tile<T, D>(q_tile, S::kQStride, qp, q_st.l, q0, lq);

  float m[R], l[R], acc[R][DN];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = kNegBig;
    l[i] = 0.f;
#pragma unroll
    for (int dd = 0; dd < DN; ++dd) acc[i][dd] = 0.f;
  }

  int n_kblocks = (lk + kBlockK - 1) / kBlockK;
  if (causal) n_kblocks = min(n_kblocks, (q0 + kBlockQ - 1) / kBlockK + 1);

  for (int j = 0; j < n_kblocks; ++j) {
    const int k0 = j * kBlockK;
    __syncthreads();  // the previous tile's K, V and P are no longer read
    load_tile<T, D>(k_tile, S::kKStride, kp, k_st.l, k0, lk);
    load_tile<T, D>(v_tile, S::kVStride, vp, v_st.l, k0, lk);
    __syncthreads();

    // S = Q K^T for this thread's 4 rows x 8 columns (columns tc + 8c).
    float s[R][C];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int c = 0; c < C; ++c) s[i][c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[R], kv[C];
#pragma unroll
      for (int i = 0; i < R; ++i) qv[i] = q_tile[(r0 + i) * S::kQStride + d];
#pragma unroll
      for (int c = 0; c < C; ++c) kv[c] = k_tile[(tc + c * kThreadCols) * S::kKStride + d];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int c = 0; c < C; ++c) s[i][c] = fmaf(qv[i], kv[c], s[i][c]);
    }

    // Online softmax; the 8 threads of a row group sit in adjacent lanes.
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int row = q0 + r0 + i;
      bool live[C];
      float row_max = kNegBig;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int col = k0 + tc + c * kThreadCols;
        live[c] = row < lq && col < lk && (!causal || row >= col);
        s[i][c] = live[c] ? s[i][c] * scale : kNegBig;
        row_max = fmaxf(row_max, s[i][c]);
      }
      const float m_new = fmaxf(m[i], row_group_max(row_max));
      const float alpha = expf(m[i] - m_new);
      float row_sum = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float p = live[c] ? expf(s[i][c] - m_new) : 0.f;
        p_tile[(r0 + i) * S::kPStride + tc + c * kThreadCols] = p;
        row_sum += p;
      }
      l[i] = alpha * l[i] + row_group_sum(row_sum);
      m[i] = m_new;
#pragma unroll
      for (int dd = 0; dd < DN; ++dd) acc[i][dd] *= alpha;
    }
    __syncthreads();

    // acc += P V for this thread's 4 rows x d/8 columns (columns tc + 8dd).
#pragma unroll 8
    for (int kk = 0; kk < kBlockK; ++kk) {
      float pv[R], vv[DN];
#pragma unroll
      for (int i = 0; i < R; ++i) pv[i] = p_tile[(r0 + i) * S::kPStride + kk];
#pragma unroll
      for (int dd = 0; dd < DN; ++dd) vv[dd] = v_tile[kk * S::kVStride + tc + dd * kThreadCols];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int dd = 0; dd < DN; ++dd) acc[i][dd] = fmaf(pv[i], vv[dd], acc[i][dd]);
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = q0 + r0 + i;
    if (row >= lq) continue;
    const float l_safe = l[i] == 0.f ? 1.f : l[i];
    T* orow = o + (static_cast<long long>(b * lq + row) * heads + h) * D;
#pragma unroll
    for (int dd = 0; dd < DN; ++dd) store(orow + tc + dd * kThreadCols, acc[i][dd] / l_safe);
    if (tc == 0) lse[static_cast<long long>(bh) * lq + row] = l[i] > 0.f ? m[i] + logf(l_safe) : 0.f;
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int batch, int heads,
           int lq, int lk, Strides q_st, Strides k_st, Strides v_st, int causal, float scale,
           cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<T, D>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Smem<D>::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = static_cast<long long>(batch) * heads * ((lq + kBlockQ - 1) / kBlockQ);
  if (blocks <= 0 || blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  kernel<<<static_cast<unsigned>(blocks), kThreads, Smem<D>::kBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, heads, lq, lk, q_st, k_st, v_st, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dim(int head_dim, const void* q, const void* k, const void* v, void* o, float* lse,
               int batch, int heads, int lq, int lk, Strides q_st, Strides k_st, Strides v_st,
               int causal, float scale, cudaStream_t stream) {
  switch (head_dim) {
    case 16: return launch<T, 16>(q, k, v, o, lse, batch, heads, lq, lk, q_st, k_st, v_st, causal, scale, stream);
    case 32: return launch<T, 32>(q, k, v, o, lse, batch, heads, lq, lk, q_st, k_st, v_st, causal, scale, stream);
    case 64: return launch<T, 64>(q, k, v, o, lse, batch, heads, lq, lk, q_st, k_st, v_st, causal, scale, stream);
    case 128: return launch<T, 128>(q, k, v, o, lse, batch, heads, lq, lk, q_st, k_st, v_st, causal, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C entry, bound with ctypes.  `o` is a contiguous [batch, lq, heads,
// head_dim] tensor of the input dtype and `lse` a contiguous [batch, heads,
// lq] f32 tensor; q, k and v have unit stride in their last dimension.
// dtype: 0 = float32, 1 = bfloat16.  Returns the cudaError_t of the launch.
extern "C" int dk_flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                      float* lse, int batch, int heads, int lq, int lk,
                                      int head_dim, long long q_sb, long long q_sl, long long q_sh,
                                      long long k_sb, long long k_sl, long long k_sh,
                                      long long v_sb, long long v_sl, long long v_sh, int causal,
                                      int dtype, float scale, void* stream) {
  const Strides q_st{q_sb, q_sl, q_sh};
  const Strides k_st{k_sb, k_sl, k_sh};
  const Strides v_st{v_sb, v_sl, v_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_dim<float>(head_dim, q, k, v, o, lse, batch, heads, lq, lk, q_st, k_st, v_st,
                             causal, scale, s);
  if (dtype == 1)
    return launch_dim<__nv_bfloat16>(head_dim, q, k, v, o, lse, batch, heads, lq, lk, q_st, k_st,
                                     v_st, causal, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
