// FlashAttention backward for NVIDIA Hopper (sm_90a): the dQ kernel and the
// dK/dV kernel.
//
// Replaces the Pallas TPU kernels of distkeras_tpu/ops/pallas/flash_attention.py:
//   flash_bwd_dq_kernel  <- _dq_kernel  (pallas_call in _bwd_call, :247)
//   flash_bwd_dkv_kernel <- _dkv_kernel (pallas_call in _bwd_call, :264)
// and computes the same functions.  Both recompute, for each 64 x 64 tile of
// (query, key) pairs, what _p_ds computes:
//   S  = Q K^T * scale (f32),
//   P  = exp(S - LSE) where the pair is attended, 0 elsewhere (padding rows
//        and columns, and above the diagonal when causal; row >= col kept,
//        aligned at the top-left corner; a row with no key has LSE = 0),
//   dP = dO V^T,
//   dS = P * (dP - Delta), Delta = rowsum(dO * O) computed by the caller;
// then dQ = scale * dS K (accumulated over K tiles) in the first kernel and
// dV = P^T dO, dK = scale * dS^T Q (accumulated over Q tiles) in the second.
// Everything is f32 whatever the input dtype (f32 or bf16); the outputs are
// written in the inputs' dtype.
//
// What bounds them on this card.  At the training path's shape (b*h = 4*12,
// L = 1024, d = 64, causal, f32) the two kernels together do 14*d FLOPs per
// attended pair (S and dP in both, dQ in one, dK and dV in the other):
// about 22.6 GFLOP, against 1.41 GB of traffic (Q, K, V, O, dO read, dQ,
// dK, dV written; LSE and Delta).  At 67 TFLOP/s (f32 outside the tensor
// cores) and 3.35 TB/s that is 0.34 ms of arithmetic against 0.004 ms of
// traffic: bound by operations.  The recompute of S and dP in both kernels
// is the price of having no atomics and no [L, L] matrix in device memory.
//
// What the design does about it.  The TPU kernels carry their accumulator
// in scratch memory across a sequential grid axis; here one thread block
// owns one output tile and walks the other axis in a loop:
//   dQ:   one block per (batch*head, 64-row Q tile); Q and dO stay in
//         shared memory, K and V tiles stream through it; dS goes through
//         a shared tile into dQ += dS K, kept in registers.
//   dK/dV: one block per (batch*head, 64-row K tile); K and V stay, Q and dO
//         tiles stream; P^T and dS^T go through shared tiles into
//         dV += P^T dO and dK += dS^T Q, both kept in registers.
// No block writes another block's output, so there are no atomics and the
// result is the same from run to run.  Tiles wholly above the diagonal are
// skipped when causal (K tiles past the Q tile in the first kernel, Q tiles
// before the K tile in the second).  Every multiply-add is an f32 FMA on
// registers fed from shared memory whose rows are padded by one float
// against bank conflicts.  Q, K, V and dO are read in their
// [batch, seq, heads, dim] layout through strides (no transpose, no padded
// copy); the ragged edge is masked against the true lengths.  Tensor-core
// tiles (wgmma), TMA and warp specialisation are left for a later revision.

#include "flash_attention_common.cuh"

namespace {

template <int D>
struct BwdSmem {
  static constexpr int kStride = D + 1;        // Q, K, V, dO rows
  static constexpr int kPStride = kBlockK + 1;  // P / dS tiles
  // dQ kernel: Q, dO, K, V tiles and one dS tile.
  static constexpr int kDqBytes =
      (4 * 64 * kStride + 64 * kPStride) * static_cast<int>(sizeof(float));
  // dK/dV kernel: K, V, Q, dO tiles, the P^T and dS^T tiles, LSE and Delta.
  static constexpr int kDkvBytes =
      (4 * 64 * kStride + 2 * 64 * kPStride + 2 * kBlockQ) * static_cast<int>(sizeof(float));
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq, int heads, int lq, int lk,
                    Strides q_st, Strides k_st, Strides v_st, Strides do_st, int causal,
                    float scale) {
  using S = BwdSmem<D>;
  constexpr int R = kRowsPerThread;
  constexpr int C = kColsPerThread;
  constexpr int DN = D / kThreadCols;
  constexpr int ST = S::kStride;
  constexpr int PS = S::kPStride;
  extern __shared__ float smem[];
  float* q_tile = smem;
  float* do_tile = q_tile + kBlockQ * ST;
  float* k_tile = do_tile + kBlockQ * ST;
  float* v_tile = k_tile + kBlockK * ST;
  float* ds_tile = v_tile + kBlockK * ST;

  const int n_qblocks = (lq + kBlockQ - 1) / kBlockQ;
  const int bh = blockIdx.x / n_qblocks;
  // heaviest query tile first when causal, as in the forward kernel
  const int qblock = n_qblocks - 1 - static_cast<int>(blockIdx.x % n_qblocks);
  const int b = bh / heads;
  const int h = bh % heads;
  const int q0 = qblock * kBlockQ;
  const int tc = threadIdx.x % kThreadCols;
  const int r0 = (threadIdx.x / kThreadCols) * R;

  const T* qp = q + b * q_st.b + h * q_st.h;
  const T* kp = k + b * k_st.b + h * k_st.h;
  const T* vp = v + b * v_st.b + h * v_st.h;
  const T* dop = dout + b * do_st.b + h * do_st.h;
  load_tile<T, D>(q_tile, ST, qp, q_st.l, q0, lq);
  load_tile<T, D>(do_tile, ST, dop, do_st.l, q0, lq);

  float row_lse[R], row_delta[R], acc[R][DN];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = q0 + r0 + i;
    const long long at = static_cast<long long>(bh) * lq + row;
    row_lse[i] = row < lq ? lse[at] : 0.f;
    row_delta[i] = row < lq ? delta[at] : 0.f;
#pragma unroll
    for (int dd = 0; dd < DN; ++dd) acc[i][dd] = 0.f;
  }

  int n_kblocks = (lk + kBlockK - 1) / kBlockK;
  if (causal) n_kblocks = min(n_kblocks, (q0 + kBlockQ - 1) / kBlockK + 1);

  for (int j = 0; j < n_kblocks; ++j) {
    const int k0 = j * kBlockK;
    __syncthreads();  // the previous tile's K, V and dS are no longer read
    load_tile<T, D>(k_tile, ST, kp, k_st.l, k0, lk);
    load_tile<T, D>(v_tile, ST, vp, v_st.l, k0, lk);
    __syncthreads();

    // S = Q K^T and dP = dO V^T for this thread's 4 rows x 8 columns.
    float s[R][C], dp[R][C];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int c = 0; c < C; ++c) s[i][c] = dp[i][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[R], ov[R], kv[C], vv[C];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        qv[i] = q_tile[(r0 + i) * ST + d];
        ov[i] = do_tile[(r0 + i) * ST + d];
      }
#pragma unroll
      for (int c = 0; c < C; ++c) {
        kv[c] = k_tile[(tc + c * kThreadCols) * ST + d];
        vv[c] = v_tile[(tc + c * kThreadCols) * ST + d];
      }
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int c = 0; c < C; ++c) {
          s[i][c] = fmaf(qv[i], kv[c], s[i][c]);
          dp[i][c] = fmaf(ov[i], vv[c], dp[i][c]);
        }
    }

    // dS = P * (dP - Delta) into shared memory.
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int row = q0 + r0 + i;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int col = k0 + tc + c * kThreadCols;
        const bool live = row < lq && col < lk && (!causal || row >= col);
        const float p = live ? expf(s[i][c] * scale - row_lse[i]) : 0.f;
        ds_tile[(r0 + i) * PS + tc + c * kThreadCols] = p * (dp[i][c] - row_delta[i]);
      }
    }
    __syncthreads();

    // acc += dS K for this thread's 4 rows x d/8 columns (columns tc + 8dd).
#pragma unroll 8
    for (int kk = 0; kk < kBlockK; ++kk) {
      float dsv[R], kv[DN];
#pragma unroll
      for (int i = 0; i < R; ++i) dsv[i] = ds_tile[(r0 + i) * PS + kk];
#pragma unroll
      for (int dd = 0; dd < DN; ++dd) kv[dd] = k_tile[kk * ST + tc + dd * kThreadCols];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int dd = 0; dd < DN; ++dd) acc[i][dd] = fmaf(dsv[i], kv[dd], acc[i][dd]);
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = q0 + r0 + i;
    if (row >= lq) continue;
    T* out = dq + (static_cast<long long>(b) * lq + row) * heads * D + static_cast<long long>(h) * D;
#pragma unroll
    for (int dd = 0; dd < DN; ++dd) store(out + tc + dd * kThreadCols, scale * acc[i][dd]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                     int heads, int lq, int lk, Strides q_st, Strides k_st, Strides v_st,
                     Strides do_st, int causal, float scale) {
  using S = BwdSmem<D>;
  constexpr int R = kRowsPerThread;
  constexpr int C = kColsPerThread;
  constexpr int DN = D / kThreadCols;
  constexpr int ST = S::kStride;
  constexpr int PS = S::kPStride;
  extern __shared__ float smem[];
  float* k_tile = smem;
  float* v_tile = k_tile + kBlockK * ST;
  float* q_tile = v_tile + kBlockK * ST;
  float* do_tile = q_tile + kBlockQ * ST;
  float* p_tile = do_tile + kBlockQ * ST;   // P^T: [key row][query column]
  float* ds_tile = p_tile + kBlockK * PS;   // dS^T
  float* lse_tile = ds_tile + kBlockK * PS;
  float* delta_tile = lse_tile + kBlockQ;

  const int n_kblocks = (lk + kBlockK - 1) / kBlockK;
  const int bh = blockIdx.x / n_kblocks;
  // K tile 0 sees the most Q tiles when causal: natural order issues it first
  const int kblock = static_cast<int>(blockIdx.x % n_kblocks);
  const int b = bh / heads;
  const int h = bh % heads;
  const int k0 = kblock * kBlockK;
  const int tc = threadIdx.x % kThreadCols;
  const int r0 = (threadIdx.x / kThreadCols) * R;  // first key row of this thread

  const T* qp = q + b * q_st.b + h * q_st.h;
  const T* kp = k + b * k_st.b + h * k_st.h;
  const T* vp = v + b * v_st.b + h * v_st.h;
  const T* dop = dout + b * do_st.b + h * do_st.h;
  load_tile<T, D>(k_tile, ST, kp, k_st.l, k0, lk);
  load_tile<T, D>(v_tile, ST, vp, v_st.l, k0, lk);

  float dk_acc[R][DN], dv_acc[R][DN];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int dd = 0; dd < DN; ++dd) dk_acc[i][dd] = dv_acc[i][dd] = 0.f;

  const int n_qblocks = (lq + kBlockQ - 1) / kBlockQ;
  // causal: Q tile i sees this K tile only if its last row i*64 + 63 >= k0
  const int first_qblock = causal ? k0 / kBlockQ : 0;

  for (int iq = first_qblock; iq < n_qblocks; ++iq) {
    const int q0 = iq * kBlockQ;
    __syncthreads();  // the previous tile's Q, dO, P^T and dS^T are no longer read
    load_tile<T, D>(q_tile, ST, qp, q_st.l, q0, lq);
    load_tile<T, D>(do_tile, ST, dop, do_st.l, q0, lq);
    if (threadIdx.x < kBlockQ) {
      const int row = q0 + static_cast<int>(threadIdx.x);
      const long long at = static_cast<long long>(bh) * lq + row;
      lse_tile[threadIdx.x] = row < lq ? lse[at] : 0.f;
      delta_tile[threadIdx.x] = row < lq ? delta[at] : 0.f;
    }
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T for this thread's 4 key rows x 8 query
    // columns (query rows tc + 8c of the tile).
    float s[R][C], dp[R][C];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int c = 0; c < C; ++c) s[i][c] = dp[i][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float kv[R], vv[R], qv[C], ov[C];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        kv[i] = k_tile[(r0 + i) * ST + d];
        vv[i] = v_tile[(r0 + i) * ST + d];
      }
#pragma unroll
      for (int c = 0; c < C; ++c) {
        qv[c] = q_tile[(tc + c * kThreadCols) * ST + d];
        ov[c] = do_tile[(tc + c * kThreadCols) * ST + d];
      }
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int c = 0; c < C; ++c) {
          s[i][c] = fmaf(kv[i], qv[c], s[i][c]);
          dp[i][c] = fmaf(vv[i], ov[c], dp[i][c]);
        }
    }

#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int col = k0 + r0 + i;  // key position
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int qc = tc + c * kThreadCols;
        const int row = q0 + qc;  // query position
        const bool live = row < lq && col < lk && (!causal || row >= col);
        const float p = live ? expf(s[i][c] * scale - lse_tile[qc]) : 0.f;
        p_tile[(r0 + i) * PS + qc] = p;
        ds_tile[(r0 + i) * PS + qc] = p * (dp[i][c] - delta_tile[qc]);
      }
    }
    __syncthreads();

    // dV += P^T dO and dK += dS^T Q for this thread's 4 key rows x d/8 columns.
#pragma unroll 4
    for (int qq = 0; qq < kBlockQ; ++qq) {
      float pv[R], dsv[R], ov[DN], qv[DN];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        pv[i] = p_tile[(r0 + i) * PS + qq];
        dsv[i] = ds_tile[(r0 + i) * PS + qq];
      }
#pragma unroll
      for (int dd = 0; dd < DN; ++dd) {
        ov[dd] = do_tile[qq * ST + tc + dd * kThreadCols];
        qv[dd] = q_tile[qq * ST + tc + dd * kThreadCols];
      }
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int dd = 0; dd < DN; ++dd) {
          dv_acc[i][dd] = fmaf(pv[i], ov[dd], dv_acc[i][dd]);
          dk_acc[i][dd] = fmaf(dsv[i], qv[dd], dk_acc[i][dd]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = k0 + r0 + i;
    if (row >= lk) continue;
    const long long at = (static_cast<long long>(b) * lk + row) * heads * D + static_cast<long long>(h) * D;
#pragma unroll
    for (int dd = 0; dd < DN; ++dd) {
      store(dk + at + tc + dd * kThreadCols, scale * dk_acc[i][dd]);
      store(dv + at + tc + dd * kThreadCols, dv_acc[i][dd]);
    }
  }
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  int batch, heads, lq, lk;
  Strides q_st, k_st, v_st, do_st;
  int causal;
  float scale;
  cudaStream_t stream;
};

int check_grid(long long blocks) {
  return (blocks <= 0 || blocks > 0x7fffffffLL) ? static_cast<int>(cudaErrorInvalidConfiguration)
                                                : 0;
}

template <typename T, int D>
int launch_dq(const Args& a, void* dq) {
  auto kernel = flash_bwd_dq_kernel<T, D>;
  constexpr int bytes = BwdSmem<D>::kDqBytes;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = static_cast<long long>(a.batch) * a.heads * ((a.lq + kBlockQ - 1) / kBlockQ);
  if (int bad = check_grid(blocks)) return bad;
  kernel<<<static_cast<unsigned>(blocks), kThreads, bytes, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), a.lse, a.delta, static_cast<T*>(dq), a.heads, a.lq, a.lk,
      a.q_st, a.k_st, a.v_st, a.do_st, a.causal, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_dkv(const Args& a, void* dk, void* dv) {
  auto kernel = flash_bwd_dkv_kernel<T, D>;
  constexpr int bytes = BwdSmem<D>::kDkvBytes;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = static_cast<long long>(a.batch) * a.heads * ((a.lk + kBlockK - 1) / kBlockK);
  if (int bad = check_grid(blocks)) return bad;
  kernel<<<static_cast<unsigned>(blocks), kThreads, bytes, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), a.lse, a.delta, static_cast<T*>(dk), static_cast<T*>(dv),
      a.heads, a.lq, a.lk, a.q_st, a.k_st, a.v_st, a.do_st, a.causal, a.scale);
  return static_cast<int>(cudaGetLastError());
}

// Dispatch on dtype code (0 = float32, 1 = bfloat16) and head dim.
template <template <typename, int> class Launch, typename... Out>
int dispatch(int dtype, int head_dim, const Args& a, Out... out) {
#define DK_HEAD_DIMS(T)                                     \
  switch (head_dim) {                                       \
    case 16: return Launch<T, 16>::run(a, out...);          \
    case 32: return Launch<T, 32>::run(a, out...);          \
    case 64: return Launch<T, 64>::run(a, out...);          \
    case 128: return Launch<T, 128>::run(a, out...);        \
    default: return static_cast<int>(cudaErrorInvalidValue); \
  }
  if (dtype == 0) { DK_HEAD_DIMS(float) }
  if (dtype == 1) { DK_HEAD_DIMS(__nv_bfloat16) }
#undef DK_HEAD_DIMS
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T, int D>
struct DqLaunch {
  static int run(const Args& a, void* dq) { return launch_dq<T, D>(a, dq); }
};

template <typename T, int D>
struct DkvLaunch {
  static int run(const Args& a, void* dk, void* dv) { return launch_dkv<T, D>(a, dk, dv); }
};

Args make_args(const void* q, const void* k, const void* v, const void* dout, const float* lse,
               const float* delta, int batch, int heads, int lq, int lk, long long q_sb,
               long long q_sl, long long q_sh, long long k_sb, long long k_sl, long long k_sh,
               long long v_sb, long long v_sl, long long v_sh, long long do_sb, long long do_sl,
               long long do_sh, int causal, float scale, void* stream) {
  return Args{q, k, v, dout, lse, delta, batch, heads, lq, lk,
              Strides{q_sb, q_sl, q_sh}, Strides{k_sb, k_sl, k_sh}, Strides{v_sb, v_sl, v_sh},
              Strides{do_sb, do_sl, do_sh}, causal, scale, static_cast<cudaStream_t>(stream)};
}

}  // namespace

// Plain C entries, bound with ctypes.  q, k, v and dO are [batch, seq,
// heads, head_dim] tensors of one dtype with unit stride in the last
// dimension, read through the given element strides; `lse` and `delta` are
// contiguous [batch, heads, lq] f32 tensors; dq, dk and dv are contiguous
// [batch, seq, heads, head_dim] tensors of the input dtype, written whole.
// dtype: 0 = float32, 1 = bfloat16.  Each returns the cudaError_t of its
// launch.
extern "C" int dk_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout, const float* lse,
    const float* delta, void* dq, int batch, int heads, int lq, int lk, int head_dim,
    long long q_sb, long long q_sl, long long q_sh, long long k_sb, long long k_sl, long long k_sh,
    long long v_sb, long long v_sl, long long v_sh, long long do_sb, long long do_sl,
    long long do_sh, int causal, int dtype, float scale, void* stream) {
  const Args a = make_args(q, k, v, dout, lse, delta, batch, heads, lq, lk, q_sb, q_sl, q_sh, k_sb,
                           k_sl, k_sh, v_sb, v_sl, v_sh, do_sb, do_sl, do_sh, causal, scale, stream);
  return dispatch<DqLaunch>(dtype, head_dim, a, dq);
}

extern "C" int dk_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout, const float* lse,
    const float* delta, void* dk, void* dv, int batch, int heads, int lq, int lk, int head_dim,
    long long q_sb, long long q_sl, long long q_sh, long long k_sb, long long k_sl, long long k_sh,
    long long v_sb, long long v_sl, long long v_sh, long long do_sb, long long do_sl,
    long long do_sh, int causal, int dtype, float scale, void* stream) {
  const Args a = make_args(q, k, v, dout, lse, delta, batch, heads, lq, lk, q_sb, q_sl, q_sh, k_sb,
                           k_sl, k_sh, v_sb, v_sl, v_sh, do_sb, do_sl, do_sh, causal, scale, stream);
  return dispatch<DkvLaunch>(dtype, head_dim, a, dk, dv);
}
