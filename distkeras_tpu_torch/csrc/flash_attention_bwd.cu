// FlashAttention backward for NVIDIA Hopper (sm_90a) on the tensor cores:
// the dQ kernel and the dK/dV kernel.
//
// Replaces the Pallas TPU kernels of distkeras_tpu/ops/pallas/flash_attention.py:
//   flash_bwd_dq_kernel  <- _dq_kernel  (pallas_call in _bwd_call, :247)
//   flash_bwd_dkv_kernel <- _dkv_kernel (pallas_call in _bwd_call, :264)
// and computes the same functions.  Both recompute, tile by tile of
// (query, key) pairs, what _p_ds computes:
//   S  = Q K^T * scale,
//   P  = exp(S - LSE) where the pair is attended, 0 elsewhere (padding rows
//        and columns, and above the diagonal when causal; row >= col kept,
//        aligned at the top-left corner; a row with no key has LSE = 0),
//   dP = dO V^T,
//   dS = P * (dP - Delta), Delta = rowsum(dO * O) computed by the caller;
// then dQ = scale * dS K (accumulated over K tiles) in the first kernel and
// dV = P^T dO, dK = scale * dS^T Q (accumulated over Q tiles) in the second.
// Inputs are f32, bf16 or f16; every sum is f32; the outputs are written in
// the inputs' dtype.  Head dims 16, 32, 64, 128 and 256 are built; the
// wrapper zero-pads any other d up to the next of them (zero columns change
// neither S, dP nor Delta, and their gradients are sliced off).
//
// What bounds them on this card.  The two kernels do 14*d FLOPs per attended
// pair (S and dP in both, dQ in one, dK and dV in the other): at the
// training path's shape (b*h = 4*12, L = 1024, d = 64, causal) 9.7 GFLOP in
// the dQ kernel and 12.9 in the dK/dV kernel, against 1.4 GB of traffic.
// They are bound by operations.  On the CUDA cores f32 peaks at 67 TFLOP/s
// (0.14 and 0.19 ms); the tensor cores do TF32 at 495 TFLOP/s, and f32
// accuracy takes three TF32 products (below), so 165 TFLOP/s effective
// (0.059 and 0.078 ms).  With mma.sync (not wgmma) the operand splits and
// fragment loads from shared memory cost more issue slots than the
// products themselves.
//
// What the design does about it.
//   Tensor cores.  Every product runs on mma.sync with f32 accumulators,
//     as flash_attention_common.cuh sets out: f32 inputs in 3xTF32; bf16
//     inputs with S and dP as bf16 products and the second products (P or
//     dS, kept in f32, times a bf16 tile) as two TF32 passes; f16 inputs
//     alike, on the f16 m16n8k16 product.
//   Issue slots.  Three mma.sync a product and a split an operand leave the
//     kernels bound by instructions issued, not by the tensor cores, so the
//     split is the cheapest there is (a mask and a subtraction,
//     tensor_core.cuh), the softmax uses exp2, and only the tiles that cross
//     the diagonal or the ragged edge are masked.
//   Registers, not shared memory, between the two products: P and dS go
//     from the first product's accumulators straight into the second
//     product's A fragments (the permuted k index of the common header).
//   Tiles.  One block of 4 warps owns 64 output rows (16 a warp) and loops
//     over the other axis, as the TPU kernels' sequential grid axis does:
//       dQ:    one block per (batch*head, 64-row Q tile); Q and dO stay in
//              shared memory, K and V tiles stream through it;
//       dK/dV: one block per (batch*head, 64-row K tile); K and V stay,
//              Q, dO, LSE and Delta tiles stream.
//     No block writes another block's output: no atomics, and the result is
//     the same from run to run.  Tiles wholly above the diagonal are skipped
//     when causal, and the heaviest blocks are issued first.  A streamed tile
//     has 64 rows (32 at d = 128, which keeps the dK/dV kernel's 2 x 64
//     accumulators and its S and dP tiles in registers; 16 at d = 256, which
//     keeps the f32 tiles within shared memory: there the dK/dV kernel's
//     2 x 128 accumulators cannot all stay in registers and spill).
//   Copies.  Tiles stay in the input dtype in shared memory and arrive by
//     cp.async, 16 bytes a copy, in a two-stage ring: tile j + 1 is in
//     flight while tile j is multiplied; rows past the ragged edge are
//     zero-filled by the copy's source size.  Rows are padded by 16 bytes,
//     which makes the f32 fragment loads and the bf16 ldmatrix loads free of
//     bank conflicts.  Q, K, V and dO are read in their [batch, seq, heads,
//     dim] layout through strides (the fused QKV views in place); the
//     wrapper copies a tensor whose rows are not 16-byte aligned first.
// wgmma, TMA and a fused one-kernel backward are left for later revisions.

#include <type_traits>

#include "flash_attention_common.cuh"

namespace {

template <typename T, int D>
struct BwdTiles : Tiles<T, D> {
  using Base = Tiles<T, D>;
  // two owned tiles, then two stages of two streamed tiles
  static constexpr int kDqBytes =
      (2 * Base::kOwned + 4 * Base::kStreamed) * static_cast<int>(sizeof(T));
  // the dK/dV kernel also streams LSE and Delta: two stages of two rows
  static constexpr int kDkvBytes = kDqBytes + 4 * Base::kStream * static_cast<int>(sizeof(float));
};

// Start copying entries [row0, row0 + ROWS) of an f32 row vector; entries
// at or past `rows_valid` are zero-filled.
template <int ROWS>
__device__ __forceinline__ void load_vec_async(float* dst, const float* src, int row0,
                                               int rows_valid) {
  if (threadIdx.x < ROWS) {
    const int row = row0 + static_cast<int>(threadIdx.x);
    const bool valid = row < rows_valid;
    cp_async4(dst + threadIdx.x, src + (valid ? row : 0), valid ? 4 : 0);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq, int heads, int lq, int lk,
                    Strides q_st, Strides k_st, Strides v_st, Strides do_st, int causal,
                    float scale) {
  using Tile = Tiles<T, D>;
  constexpr int BN = Tile::kStream;
  constexpr int ST = Tile::kStride;
  extern __shared__ __align__(16) unsigned char smem[];
  T* q_tile = reinterpret_cast<T*>(smem);
  T* do_tile = q_tile + Tile::kOwned;
  T* ring = do_tile + Tile::kOwned;  // stage s: K at ring + 2 s kStreamed, V after it

  const int n_qblocks = (lq + kOwnedRows - 1) / kOwnedRows;
  const int bh = blockIdx.x / n_qblocks;
  // heaviest query tile first when causal, as in the forward kernel
  const int qblock = n_qblocks - 1 - static_cast<int>(blockIdx.x % n_qblocks);
  const int b = bh / heads;
  const int h = bh % heads;
  const int q0 = qblock * kOwnedRows;
  const int lane = threadIdx.x % 32;
  const int wrow = (threadIdx.x / 32) * 16;  // the warp's first row in the tile
  const int g = lane >> 2;
  const int t = lane & 3;

  const T* qp = q + b * q_st.b + h * q_st.h;
  const T* kp = k + b * k_st.b + h * k_st.h;
  const T* vp = v + b * v_st.b + h * v_st.h;
  const T* dop = dout + b * do_st.b + h * do_st.h;

  int n_kblocks = (lk + BN - 1) / BN;
  if (causal) n_kblocks = min(n_kblocks, (q0 + kOwnedRows - 1) / BN + 1);

  load_tile_async<T, D, kOwnedRows, kThreads>(q_tile, qp, q_st.l, q0, lq);
  load_tile_async<T, D, kOwnedRows, kThreads>(do_tile, dop, do_st.l, q0, lq);
  load_tile_async<T, D, BN, kThreads>(ring, kp, k_st.l, 0, lk);
  load_tile_async<T, D, BN, kThreads>(ring + Tile::kStreamed, vp, v_st.l, 0, lk);
  cp_async_commit();

  // exp(S scale - LSE) is taken as exp2(S scale log2e - LSE log2e)
  const float scale_log2 = scale * kLog2e;
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + wrow + g + 8 * i;
    const long long at = static_cast<long long>(bh) * lq + row;
    row_lse[i] = row < lq ? lse[at] * kLog2e : 0.f;
    row_delta[i] = row < lq ? delta[at] : 0.f;
  }
  float acc[D / 8][4];
  zero(acc);

  for (int j = 0; j < n_kblocks; ++j) {
    const int k0 = j * BN;
    if (j + 1 < n_kblocks) {  // the next K and V tiles fly while this one is used
      T* next = ring + ((j + 1) & 1) * 2 * Tile::kStreamed;
      load_tile_async<T, D, BN, kThreads>(next, kp, k_st.l, k0 + BN, lk);
      load_tile_async<T, D, BN, kThreads>(next + Tile::kStreamed, vp, v_st.l, k0 + BN, lk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* k_tile = ring + (j & 1) * 2 * Tile::kStreamed;
    const T* v_tile = k_tile + Tile::kStreamed;

    float s[BN / 8][4], dp[BN / 8][4];
    zero(s);
    zero(dp);
    rows_dot_rows<D, BN>(s, q_tile + wrow * ST, k_tile, lane);
    rows_dot_rows<D, BN>(dp, do_tile + wrow * ST, v_tile, lane);

    // dS = P (dP - Delta), in place of dP; only a tile that crosses the
    // diagonal or the ragged edge is masked
    auto ds_of = [&](auto masked) {
#pragma unroll
      for (int n = 0; n < BN / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = exp2f(s[n][e] * scale_log2 - row_lse[e >> 1]);
          if constexpr (decltype(masked)::value) {
            const int row = q0 + wrow + g + 8 * (e >> 1);
            const int col = k0 + 8 * n + 2 * t + (e & 1);
            if (!(row < lq && col < lk && (!causal || row >= col))) p = 0.f;
          }
          dp[n][e] = p * (dp[n][e] - row_delta[e >> 1]);
        }
      }
    };
    if (q0 + kOwnedRows > lq || k0 + BN > lk || (causal && k0 + BN - 1 > q0)) {
      ds_of(std::true_type());
    } else {
      ds_of(std::false_type());
    }
    tile_times_rows<D, BN>(acc, dp, k_tile, lane);
    __syncthreads();  // the next iteration's copy refills this stage
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + wrow + g + 8 * i;
    if (row >= lq) continue;
    T* out = dq + (static_cast<long long>(b) * lq + row) * heads * D +
             static_cast<long long>(h) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      store2(out + 8 * n, scale * acc[n][2 * i], scale * acc[n][2 * i + 1]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                     int heads, int lq, int lk, Strides q_st, Strides k_st, Strides v_st,
                     Strides do_st, int causal, float scale) {
  using Tile = Tiles<T, D>;
  constexpr int BN = Tile::kStream;
  constexpr int ST = Tile::kStride;
  extern __shared__ __align__(16) unsigned char smem[];
  T* k_tile = reinterpret_cast<T*>(smem);
  T* v_tile = k_tile + Tile::kOwned;
  T* ring = v_tile + Tile::kOwned;  // stage s: Q at ring + 2 s kStreamed, dO after it
  // stage s: LSE at vecs + 2 s BN, Delta after it
  float* vecs = reinterpret_cast<float*>(ring + 4 * Tile::kStreamed);

  const int n_kblocks = (lk + kOwnedRows - 1) / kOwnedRows;
  const int bh = blockIdx.x / n_kblocks;
  // K tile 0 sees the most Q tiles when causal: natural order issues it first
  const int kblock = static_cast<int>(blockIdx.x % n_kblocks);
  const int b = bh / heads;
  const int h = bh % heads;
  const int k0 = kblock * kOwnedRows;
  const int lane = threadIdx.x % 32;
  const int wrow = (threadIdx.x / 32) * 16;  // the warp's first key row in the tile
  const int g = lane >> 2;
  const int t = lane & 3;

  const T* qp = q + b * q_st.b + h * q_st.h;
  const T* kp = k + b * k_st.b + h * k_st.h;
  const T* vp = v + b * v_st.b + h * v_st.h;
  const T* dop = dout + b * do_st.b + h * do_st.h;
  const float* lse_bh = lse + static_cast<long long>(bh) * lq;
  const float* delta_bh = delta + static_cast<long long>(bh) * lq;

  const float scale_log2 = scale * kLog2e;
  const int n_qblocks = (lq + BN - 1) / BN;
  // causal: Q tile i sees this K tile only if its last row i*BN + BN - 1 >= k0
  const int first_qblock = causal ? k0 / BN : 0;

  auto load_stage = [&](int stage, int iq) {
    T* dst = ring + stage * 2 * Tile::kStreamed;
    float* vec = vecs + stage * 2 * BN;
    load_tile_async<T, D, BN, kThreads>(dst, qp, q_st.l, iq * BN, lq);
    load_tile_async<T, D, BN, kThreads>(dst + Tile::kStreamed, dop, do_st.l, iq * BN, lq);
    load_vec_async<BN>(vec, lse_bh, iq * BN, lq);
    load_vec_async<BN>(vec + BN, delta_bh, iq * BN, lq);
  };

  load_tile_async<T, D, kOwnedRows, kThreads>(k_tile, kp, k_st.l, k0, lk);
  load_tile_async<T, D, kOwnedRows, kThreads>(v_tile, vp, v_st.l, k0, lk);
  if (first_qblock < n_qblocks) load_stage(0, first_qblock);
  cp_async_commit();

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
  zero(dk_acc);
  zero(dv_acc);

  for (int iq = first_qblock; iq < n_qblocks; ++iq) {
    const int stage = (iq - first_qblock) & 1;
    const int q0 = iq * BN;
    if (iq + 1 < n_qblocks) {  // the next Q, dO, LSE and Delta tiles fly meanwhile
      load_stage(stage ^ 1, iq + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* q_tile = ring + stage * 2 * Tile::kStreamed;
    const T* do_tile = q_tile + Tile::kStreamed;
    const float* lse_tile = vecs + stage * 2 * BN;
    const float* delta_tile = lse_tile + BN;

    // S^T = K Q^T and dP^T = V dO^T: the warp's 16 key rows x BN query columns
    float s[BN / 8][4], dp[BN / 8][4];
    zero(s);
    zero(dp);
    rows_dot_rows<D, BN>(s, k_tile + wrow * ST, q_tile, lane);
    rows_dot_rows<D, BN>(dp, v_tile + wrow * ST, do_tile, lane);

    // P^T in place of S^T, dS^T in place of dP^T; only a tile that crosses
    // the diagonal or the ragged edge is masked
    auto p_ds_of = [&](auto masked) {
#pragma unroll
      for (int n = 0; n < BN / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = 8 * n + 2 * t + (e & 1);
          float p = exp2f(s[n][e] * scale_log2 - lse_tile[qc] * kLog2e);
          if constexpr (decltype(masked)::value) {
            const int key = k0 + wrow + g + 8 * (e >> 1);
            const int query = q0 + qc;
            if (!(key < lk && query < lq && (!causal || query >= key))) p = 0.f;
          }
          s[n][e] = p;
          dp[n][e] = p * (dp[n][e] - delta_tile[qc]);
        }
      }
    };
    if (k0 + kOwnedRows > lk || q0 + BN > lq || (causal && q0 < k0 + kOwnedRows - 1)) {
      p_ds_of(std::true_type());
    } else {
      p_ds_of(std::false_type());
    }
    tile_times_rows<D, BN>(dv_acc, s, do_tile, lane);
    tile_times_rows<D, BN>(dk_acc, dp, q_tile, lane);
    __syncthreads();  // the next iteration's copy refills this stage
  }
  cp_async_wait<0>();  // no copy outlives the block (a causal block past every query)

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = k0 + wrow + g + 8 * i;
    if (row >= lk) continue;
    const long long at = (static_cast<long long>(b) * lk + row) * heads * D +
                         static_cast<long long>(h) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      store2(dk + at + 8 * n, scale * dk_acc[n][2 * i], scale * dk_acc[n][2 * i + 1]);
      store2(dv + at + 8 * n, dv_acc[n][2 * i], dv_acc[n][2 * i + 1]);
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

template <typename T, int D>
int launch_dq(const Args& a, void* dq) {
  auto kernel = flash_bwd_dq_kernel<T, D>;
  constexpr int bytes = BwdTiles<T, D>::kDqBytes;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks =
      static_cast<long long>(a.batch) * a.heads * ((a.lq + kOwnedRows - 1) / kOwnedRows);
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
  constexpr int bytes = BwdTiles<T, D>::kDkvBytes;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks =
      static_cast<long long>(a.batch) * a.heads * ((a.lk + kOwnedRows - 1) / kOwnedRows);
  if (int bad = check_grid(blocks)) return bad;
  kernel<<<static_cast<unsigned>(blocks), kThreads, bytes, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), a.lse, a.delta, static_cast<T*>(dk), static_cast<T*>(dv),
      a.heads, a.lq, a.lk, a.q_st, a.k_st, a.v_st, a.do_st, a.causal, a.scale);
  return static_cast<int>(cudaGetLastError());
}

// Dispatch on dtype code (0 = float32, 1 = bfloat16, 2 = float16) and head dim.
template <template <typename, int> class Launch, typename... Out>
int dispatch(int dtype, int head_dim, const Args& a, Out... out) {
#define DK_HEAD_DIMS(T)                                     \
  switch (head_dim) {                                       \
    case 16: return Launch<T, 16>::run(a, out...);          \
    case 32: return Launch<T, 32>::run(a, out...);          \
    case 64: return Launch<T, 64>::run(a, out...);          \
    case 128: return Launch<T, 128>::run(a, out...);        \
    case 256: return Launch<T, 256>::run(a, out...);        \
    default: return static_cast<int>(cudaErrorInvalidValue); \
  }
  if (dtype == 0) { DK_HEAD_DIMS(float) }
  if (dtype == 1) { DK_HEAD_DIMS(__nv_bfloat16) }
  if (dtype == 2) { DK_HEAD_DIMS(__half) }
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
// dimension, read through the given element strides; each row (the data
// pointer and every stride) is 16-byte aligned.  `lse` and `delta` are
// contiguous [batch, heads, lq] f32 tensors; dq, dk and dv are contiguous
// [batch, seq, heads, head_dim] tensors of the input dtype, written whole.
// dtype: 0 = float32, 1 = bfloat16, 2 = float16.  head_dim: 16, 32, 64,
// 128 or 256 (the wrapper zero-pads any other d and passes 1/sqrt(d) of the
// true d as `scale`).  Each returns the cudaError_t of its launch.
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
