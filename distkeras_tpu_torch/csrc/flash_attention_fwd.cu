// FlashAttention forward for NVIDIA Hopper (sm_90a) on the tensor cores.
//
// Replaces the Pallas TPU kernel distkeras_tpu/ops/pallas/flash_attention.py
// :: _fwd_kernel (pallas_call in _fwd_call, :114) and computes the same
// function:
//   S = Q K^T * scale in f32, masked with -1e30 (not -inf) outside the valid
//   columns and, when causal, above the diagonal (row >= col kept, aligned
//   at the top-left corner, also when lq != lk); rows past lq are computed
//   on zeros and never written;
//   online softmax with a running max m and denominator l;
//   O = acc / l in the input dtype, LSE = m + log(l) in f32 and natural-log
//   units (the backward kernels read it so), and O = 0, LSE = 0 for a row
//   whose denominator is 0.
// Inputs are f32 or bf16; S, P and every sum are f32.
//
// What bounds it on this card.  The kernel does 4*d FLOPs per attended pair
// (S and P V): at the inference path's shape (b*h = 16*12, L = 1024,
// d = 64, f32) 51.5 GFLOP against 201 MB of traffic (Q, K, V in, O out),
// so it is bound by operations.  On the CUDA cores f32 peaks at 67 TFLOP/s
// (0.77 ms); the tensor cores do TF32 at 495 TFLOP/s, and f32 accuracy takes
// three TF32 products, so 165 TFLOP/s effective (0.31 ms).  With mma.sync
// (not wgmma) the operand splits, the fragment loads from shared memory and
// the softmax cost more issue slots than the products themselves.
//
// What the design does about it.
//   Tensor cores.  S = Q K^T and P V run on mma.sync with f32 accumulators
//     (flash_attention_common.cuh): f32 inputs in 3xTF32; bf16 inputs with S
//     as bf16 products (exact in f32, as on the TPU) and P V as two TF32
//     passes, P kept in f32 (the TPU kernel multiplies it in f32) and V exact
//     in TF32.
//   Registers.  Q's A fragments are read from shared memory once and kept in
//     registers, split into big and small in f32, where they take at most 64
//     a thread (f32 up to d = 64, bf16 at every d); f32 at d = 128 re-reads
//     them for each K tile.  P goes from S's accumulators straight into P V's
//     A fragments.  The softmax runs on the accumulator layout: a thread holds
//     rows g and g + 8, a row's max is taken across its quad by two shuffles,
//     and the denominator is summed across the quad once, at the end.
//   Issue slots.  The softmax runs in exp2 with scale * log2(e) folded into
//     one FMA an element (LSE is converted back once, in the epilogue); only
//     the tiles that cross the diagonal or the ragged key edge are masked;
//     the 3xTF32 split is a mask and a subtraction (tensor_core.cuh).
//   Tiles.  One block of 4 warps owns a 64-row Q tile (16 rows a warp) of one
//     (batch*head) and loops over K/V tiles of 64 rows (32 at d = 128), which
//     replaces the TPU's sequential innermost grid axis.  K tiles wholly
//     above the diagonal are never visited when causal, and the blocks of a
//     (batch, head) are issued heaviest Q tile first so that causal tails do
//     not straggle.  No atomics: the result is the same from run to run.
//   Copies.  Q, K and V stay in the input dtype in shared memory and arrive
//     by cp.async, 16 bytes a copy; K and V in a two-stage ring, tile j + 1
//     in flight while tile j is multiplied; rows past the ragged edge are
//     zero-filled by the copy's source size, and rows are padded by 16 bytes
//     against bank conflicts.  Inputs are read in their [batch, seq, heads,
//     dim] layout through strides (the fused QKV views in place); the
//     wrapper copies a tensor whose rows are not 16-byte aligned first.
// wgmma, TMA and warp specialisation are left for later revisions.

#include <type_traits>

#include "flash_attention_common.cuh"

namespace {

constexpr float kLn2 = 0.6931471805599453f;

template <typename T, int D>
struct FwdTiles : Tiles<T, D> {
  using Base = Tiles<T, D>;
  // the Q tile, then two stages of a K and a V tile
  static constexpr int kBytes =
      (Base::kOwned + 4 * Base::kStreamed) * static_cast<int>(sizeof(T));
  // Q's A fragments stay in registers where they take at most 64 a thread
  // (D of them in f32, big and small; D / 4 in bf16)
  static constexpr bool kQInRegisters = D * static_cast<int>(sizeof(T)) <= 256;
};

// The Q operand of S = Q K^T for the warp's 16 rows: its A fragments held in
// registers (read from shared memory once), or re-read for every K tile.
template <typename T, int D, bool IN_REGISTERS>
struct QOperand;

template <int D>
struct QOperand<float, D, true> {
  unsigned big[D / 8][4], small[D / 8][4];
  __device__ __forceinline__ void load(const float* q, int lane) {
#pragma unroll
    for (int i = 0; i < D / 8; ++i) a_fragment<D>(q, 8 * i, lane, big[i], small[i]);
  }
  template <int BN>
  __device__ __forceinline__ void dot(float (&s)[BN / 8][4], const float* k, int lane) const {
#pragma unroll
    for (int i = 0; i < D / 8; ++i) dot_rows_step<D, BN>(s, big[i], small[i], k, 8 * i, lane);
  }
};

template <int D>
struct QOperand<__nv_bfloat16, D, true> {
  unsigned f[D / 16][4];
  __device__ __forceinline__ void load(const __nv_bfloat16* q, int lane) {
#pragma unroll
    for (int i = 0; i < D / 16; ++i) a_fragment<D>(q, 16 * i, lane, f[i]);
  }
  template <int BN>
  __device__ __forceinline__ void dot(float (&s)[BN / 8][4], const __nv_bfloat16* k,
                                      int lane) const {
#pragma unroll
    for (int i = 0; i < D / 16; ++i) dot_rows_step<D, BN>(s, f[i], k, 16 * i, lane);
  }
};

template <typename T, int D>
struct QOperand<T, D, false> {
  const T* q;
  __device__ __forceinline__ void load(const T* rows, int) { q = rows; }
  template <int BN>
  __device__ __forceinline__ void dot(float (&s)[BN / 8][4], const T* k, int lane) const {
    rows_dot_rows<D, BN>(s, q, k, lane);
  }
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ lse, int heads, int lq, int lk,
                 Strides q_st, Strides k_st, Strides v_st, int causal, float scale) {
  using Tile = FwdTiles<T, D>;
  constexpr int BN = Tile::kStream;
  constexpr int ST = Tile::kStride;
  static_assert(BN / 8 * 4 <= 32, "a tile's live entries fit one 32-bit mask");
  extern __shared__ __align__(16) unsigned char smem[];
  T* q_tile = reinterpret_cast<T*>(smem);
  T* ring = q_tile + Tile::kOwned;  // stage s: K at ring + 2 s kStreamed, V after it

  const int n_qblocks = (lq + kOwnedRows - 1) / kOwnedRows;
  const int bh = blockIdx.x / n_qblocks;
  // heaviest query tile first: when causal it visits the most K tiles
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

  int n_kblocks = (lk + BN - 1) / BN;
  if (causal) n_kblocks = min(n_kblocks, (q0 + kOwnedRows - 1) / BN + 1);

  load_tile_async<T, D, kOwnedRows, kThreads>(q_tile, qp, q_st.l, q0, lq);
  load_tile_async<T, D, BN, kThreads>(ring, kp, k_st.l, 0, lk);
  load_tile_async<T, D, BN, kThreads>(ring + Tile::kStreamed, vp, v_st.l, 0, lk);
  cp_async_commit();

  QOperand<T, D, Tile::kQInRegisters> q_op;
  if constexpr (Tile::kQInRegisters) {
    cp_async_wait<0>();
    __syncthreads();
  }
  q_op.load(q_tile + wrow * ST, lane);

  // the softmax runs in units of S scale log2(e): exp(S scale - m) is
  // exp2(S scale log2(e) - m log2(e))
  const float scale_log2 = scale * kLog2e;
  float m[2] = {kNegBig, kNegBig};  // running max of rows g and g + 8
  float l[2] = {0.f, 0.f};          // this thread's share of their denominators
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

    float s[BN / 8][4];
    zero(s);
    q_op.template dot<BN>(s, k_tile, lane);

    // P in place of S; only a tile that crosses the diagonal or the ragged
    // key edge is masked (-1e30, and P = 0 there)
    auto softmax = [&](auto masked) {
      [[maybe_unused]] unsigned live = 0xffffffffu;  // bit 4n + e: entry e of block n is attended
      float mx[2] = {kNegBig, kNegBig};
#pragma unroll
      for (int n = 0; n < BN / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if constexpr (decltype(masked)::value) {
            const int row = q0 + wrow + g + 8 * (e >> 1);
            const int col = k0 + 8 * n + 2 * t + (e & 1);
            if (!(col < lk && (!causal || row >= col))) {
              s[n][e] = kNegBig;
              live &= ~(1u << (4 * n + e));
            }
          }
          mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
        }
      }
      float alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m[i], mx[i] * scale_log2);  // scale > 0 keeps the order
        alpha[i] = exp2f(m[i] - m_new);
        m[i] = m_new;
        l[i] *= alpha[i];
      }
#pragma unroll
      for (int n = 0; n < BN / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = exp2f(fmaf(s[n][e], scale_log2, -m[e >> 1]));
          if constexpr (decltype(masked)::value) {
            if (!(live >> (4 * n + e) & 1u)) p = 0.f;
          }
          s[n][e] = p;
          l[e >> 1] += p;
        }
      }
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        acc[n][0] *= alpha[0];
        acc[n][1] *= alpha[0];
        acc[n][2] *= alpha[1];
        acc[n][3] *= alpha[1];
      }
    };
    if (k0 + BN > lk || (causal && k0 + BN - 1 > q0)) {
      softmax(std::true_type());
    } else {
      softmax(std::false_type());
    }
    tile_times_rows<D, BN>(acc, s, v_tile, lane);
    __syncthreads();  // the next iteration's copy refills this stage
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {  // the whole quad's denominator
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + wrow + g + 8 * i;
    if (row >= lq) continue;
    const float l_safe = l[i] == 0.f ? 1.f : l[i];
    T* out = o + (static_cast<long long>(b) * lq + row) * heads * D +
             static_cast<long long>(h) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      store2(out + 8 * n, acc[n][2 * i] / l_safe, acc[n][2 * i + 1] / l_safe);
    if (t == 0)
      lse[static_cast<long long>(bh) * lq + row] = l[i] > 0.f ? m[i] * kLn2 + logf(l_safe) : 0.f;
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int batch, int heads,
           int lq, int lk, Strides q_st, Strides k_st, Strides v_st, int causal, float scale,
           cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<T, D>;
  constexpr int bytes = FwdTiles<T, D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks =
      static_cast<long long>(batch) * heads * ((lq + kOwnedRows - 1) / kOwnedRows);
  if (int bad = check_grid(blocks)) return bad;
  kernel<<<static_cast<unsigned>(blocks), kThreads, bytes, stream>>>(
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

// Plain C entry, bound with ctypes.  q, k and v are [batch, seq, heads,
// head_dim] tensors of one dtype with unit stride in the last dimension,
// read through the given element strides; each row (the data pointer and
// every stride) is 16-byte aligned.  `o` is a contiguous [batch, lq, heads,
// head_dim] tensor of the input dtype and `lse` a contiguous [batch, heads,
// lq] f32 tensor, both written whole.  dtype: 0 = float32, 1 = bfloat16.
// Returns the cudaError_t of the launch.
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
