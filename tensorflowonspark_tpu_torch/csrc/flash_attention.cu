// Flash attention forward (B1), dQ (B2) and dK/dV (B3) for Hopper (sm_90a).
//
// Replaces the Pallas kernels of tensorflowonspark_tpu/ops/flash_attention.py:
//   flash_fwd     <- _flash_fwd_kernel     (:127, launched at :465)
//   flash_bwd_dq  <- _flash_bwd_dq_kernel  (:195, launched at :540)
//   flash_bwd_dkv <- _flash_bwd_dkv_kernel (:256, launched at :580)
// Blockwise online-softmax attention, causal or full, with segment masks
// (0 = padding), skipping of blocks outside the causal and valid ranges, and
// GQA without widened K/V. delta = rowsum(dO * O) - g_lse comes in from the
// wrapper, as the JAX package computes it outside its kernels.
//
// Bound. At the training shapes (s = 1024, d = 64, bf16, causal) each
// kernel's least work sits near the H100's ridge point: per (batch, head)
// the forward does 0.13 GFLOP of products on 0.53 MB of q, k, v, out and
// lse, ~250 FLOP per byte against the card's 295, so bytes bound B1 by a
// hair; B2 (three products per visible pair) is bound by the bf16 rate,
// and B3 by its bytes again, its dK/dV leaving in f32. All three would
// take 0.015-0.03 ms at b8 x h12. Below the products, each exponential
// comes with only 2d = 128 tensor-core multiply-adds at d = 64: the f32
// softmax work on the CUDA cores (mask, max, exp, sum, rescale) weighs as
// much as the products and has to overlap them.
//
// Grid. CUDA blocks run in no order, so the TPU's sequential grid axis
// becomes a loop inside the block over the key tiles (B1, B2) or the query
// tiles at or after the key tile (B3); per-row valid lengths and the causal
// diagonal bound every loop. One block (4 warps, warp w owns tile rows
// 16w..16w+15) per (batch * head, 64-row query tile) for B1 and B2, and
// per (batch * kv head, 64-row key tile) for B3, which loops over the
// query heads of its GQA group inside the block and sums their dK/dV in
// registers: no atomics, one f32 store per row. B1 reverses the query-tile
// axis, so the longest causal rows launch first and the short ones fill
// the tail; B3's key-tile axis already runs longest first.
//
// bf16 B1 and B3 (the training path): FlashAttention-2 with mma.sync.
// Every product is an m16n8k16 bf16 tensor-core op with its operands in
// registers: A fragments of the warp's 16 rows (Q for B1, loaded once;
// K and V for B3, loaded once), B fragments read from the staged tiles
// with ldmatrix (.trans where the tile is the product's k x n operand:
// V in P V, dO in P^T dO, Q in dS^T Q). Scores land in accumulator
// registers; the mask, row max, exponentials and row sums run there, the
// max and sums combined across the 4 threads of a quad with shuffles; P
// and dS are packed to bf16 in registers and fed straight back as A
// operands (the accumulator layout of two adjacent n8 tiles is the A layout
// of one k16 slice), and the output or dK/dV accumulators stay in
// registers for the whole loop. No product goes through shared memory.
// K/V tiles (B1) and Q/dO tiles with their lse, delta and segment rows
// (B3) stream through a two-stage cp.async ring: tile i+1 is in flight
// while tile i is multiplied, and one barrier per tile guards the ring
// slot. Rows are padded to 144 bytes, so ldmatrix's eight row addresses
// fall on distinct banks. The element mask runs only on tiles that need
// it (the causal diagonal, a ragged edge, padding or a segment boundary,
// decided per warp); interior tiles skip it. B3 takes each query tile in
// two halves of 32 queries, which keeps 3 blocks on an SM.
//
// What bounds them now (H100 SXM, 700 W, b8 s1024 h12 causal): latency
// of the in-register work, not loads or the tensor cores. B1 reaches
// about 150 TFLOP/s; a build that skips its loads ran 5% faster, one that
// skips its products and softmax took 55% of the time; it runs fastest at
// its most warps (4 blocks of 4 at 128 registers: 3 blocks +6%, 2 blocks
// +30%, 2 query strips a warp +20%), and a 2-instruction exponential in
// place of expf's 8 would save 8%. mma.sync tops out near two thirds of
// the card's bf16 rate; wgmma (warpgroup products reading B from shared
// memory, asynchronous, with TMA loads) is the next step toward the bound.
//
// f32 operands (and bf16 B2 until it is redesigned) keep the first design:
// tiles staged in shared memory with 16-byte loads, each product a block-
// wide pass whose result goes through a shared f32 tile; bf16 B2 through
// 16x16x16 WMMA fragments, f32 through plain FMAs in full f32 (the tensor
// cores would round them to TF32).
//
// Numerics mirror the Pallas kernels: scores = f32(QK^T) * scale, masked
// with an explicit -1e30; m, l and the accumulators in f32; P and dS cast
// to the operand dtype before their products; out = acc / max(l, 1e-30) and
// lse = m + log(max(l, 1e-30)); dQ = (scale * acc) in the operand dtype;
// dK = sum over the group of scale * acc, dV likewise without the scale,
// both f32 (bf16 B3 scales the group's sum once). A fully padded query row
// gives out 0, lse -1e30 and zero gradients.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

using namespace nvcuda;

constexpr int kThreads = 128;  // 4 warps; warp w owns tile rows 16w..16w+15
constexpr int kTile = 64;      // query and key tile rows
constexpr int kD = 64;         // head_dim
constexpr int kPerThread = kTile * kD / kThreads;  // accumulator elements
constexpr int kLdF = kTile + 4;                    // f32 tile row stride
constexpr float kNegInf = -1e30f;

static_assert(kTile == kD, "tiles are square: one row stride per dtype");
static_assert(kTile == 16 * (kThreads / 32), "one 16-row strip per warp");

template <typename T>
struct Num;

template <>
struct Num<float> {
  __device__ static float load(float x) { return x; }
  __device__ static float store(float x) { return x; }
  static constexpr int kLd = kD + 4;
};

template <>
struct Num<__nv_bfloat16> {
  __device__ static float load(__nv_bfloat16 x) { return __bfloat162float(x); }
  __device__ static __nv_bfloat16 store(float x) { return __float2bfloat16(x); }
  // 144-byte rows: WMMA fragment loads stay 32-byte aligned and rows fall
  // on different banks.
  static constexpr int kLd = kD + 8;
};

// Bytes of a 64 x 64 tile in shared memory (multiples of 32 bytes, so tiles
// carved one after another keep WMMA's alignment).
template <typename T>
__host__ __device__ constexpr size_t tile_bytes() {
  return sizeof(T) * kTile * Num<T>::kLd;
}
constexpr size_t kTileF = sizeof(float) * kTile * kLdF;

// Rows [0, rows) of a 64 x 64 head-major tile at src into dst; rows past
// `rows` (a ragged last tile) are zero-filled.
template <typename T>
__device__ void load_tile(const T* __restrict__ src, int rows, T* dst) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = kD / kVec;
  for (int i = threadIdx.x; i < kTile * kPerRow; i += kThreads) {
    const int r = i / kPerRow;
    const int c = (i - r * kPerRow) * kVec;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows)
      val = *reinterpret_cast<const uint4*>(src + static_cast<size_t>(r) * kD +
                                            c);
    *reinterpret_cast<uint4*>(dst + r * Num<T>::kLd + c) = val;
  }
}

// C (64 x 64 f32, stride kLdF) = A (64 x 64, row-major) * B, where B is
// (k x n) row-major, or with B_T stored as (n x k) row-major (B^T of a
// row-major tile). Whole block; C is written, not accumulated.
template <typename T, bool B_T>
__device__ void gemm(const T* A, const T* B, float* C) {
  constexpr int ld = Num<T>::kLd;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    using BLayout =
        typename std::conditional<B_T, wmma::col_major, wmma::row_major>::type;
    const int strip = threadIdx.x / 32;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kTile / 16];
#pragma unroll
    for (int n = 0; n < kTile / 16; ++n) wmma::fill_fragment(acc[n], 0.f);
#pragma unroll
    for (int kk = 0; kk < kD; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major>
          a;
      wmma::load_matrix_sync(a, A + strip * 16 * ld + kk, ld);
#pragma unroll
      for (int n = 0; n < kTile / 16; ++n) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, BLayout> b;
        wmma::load_matrix_sync(b, B_T ? B + n * 16 * ld + kk
                                      : B + kk * ld + n * 16,
                               ld);
        wmma::mma_sync(acc[n], a, b, acc[n]);
      }
    }
#pragma unroll
    for (int n = 0; n < kTile / 16; ++n)
      wmma::store_matrix_sync(C + strip * 16 * kLdF + n * 16, acc[n], kLdF,
                              wmma::mem_row_major);
  } else {
    // Thread t: row t / 2, columns 32 * (t % 2) .. +32, full f32 FMAs.
    const int r = threadIdx.x >> 1;
    const int c0 = (threadIdx.x & 1) * 32;
    float acc[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) acc[j] = 0.f;
    for (int kk = 0; kk < kD; ++kk) {
      const float a = A[r * ld + kk];
#pragma unroll
      for (int j = 0; j < 32; ++j)
        acc[j] = fmaf(a, B_T ? B[(c0 + j) * ld + kk] : B[kk * ld + c0 + j],
                      acc[j]);
    }
#pragma unroll
    for (int j = 0; j < 32; ++j) C[r * kLdF + c0 + j] = acc[j];
  }
}

__device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

// ---------------------------------------------------------------- B1 ----

template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const int* __restrict__ q_seg,
                     const int* __restrict__ k_seg,
                     const int* __restrict__ q_len,
                     const int* __restrict__ k_len, T* __restrict__ out,
                     float* __restrict__ lse, int h, int h_kv, int s_q,
                     int s_k, float scale, int causal) {
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* Ks = reinterpret_cast<T*>(smem + tile_bytes<T>());
  T* Vs = reinterpret_cast<T*>(smem + 2 * tile_bytes<T>());
  T* Ps = reinterpret_cast<T*>(smem + 3 * tile_bytes<T>());
  float* Sf = reinterpret_cast<float*>(smem + 4 * tile_bytes<T>());
  float* corr_s = Sf + kTile * kLdF;  // (64,)
  float* l_s = corr_s + kTile;        // (64,)
  int* kseg_s = reinterpret_cast<int*>(l_s + kTile);

  constexpr int ld = Num<T>::kLd;
  const int bh = blockIdx.x;
  const int b = bh / h;
  const int kv_row = b * h_kv + (bh - b * h) / (h / h_kv);
  const int q0 = blockIdx.y * kTile;
  const int tid = threadIdx.x;
  // Softmax ownership: row r, columns 32 * half .. +32.
  const int r = tid >> 1;
  const int half = tid & 1;
  const int q_pos = q0 + r;
  const int qseg_r = q_pos < s_q ? q_seg[b * s_q + q_pos] : 0;

  const int n_k = cdiv(s_k, kTile);
  int num_k = causal ? min(cdiv(q0 + kTile, kTile), n_k) : n_k;
  num_k = min(num_k, cdiv(k_len[b], kTile));
  if (blockIdx.y >= cdiv(q_len[b], kTile)) num_k = 0;

  load_tile(q + (static_cast<size_t>(bh) * s_q + q0) * kD, s_q - q0, Qs);
  float m = kNegInf, l = 0.f;
  float acc[kPerThread];
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) acc[i] = 0.f;

  for (int kt = 0; kt < num_k; ++kt) {
    const int k0 = kt * kTile;
    const size_t kv_off = (static_cast<size_t>(kv_row) * s_k + k0) * kD;
    load_tile(k + kv_off, s_k - k0, Ks);
    load_tile(v + kv_off, s_k - k0, Vs);
    if (tid < kTile) kseg_s[tid] = k0 + tid < s_k ? k_seg[b * s_k + k0 + tid] : 0;
    __syncthreads();
    gemm<T, true>(Qs, Ks, Sf);  // S = Q K^T
    __syncthreads();

    float* srow = Sf + r * kLdF + half * 32;
    float mx = kNegInf;
#pragma unroll 8
    for (int j = 0; j < 32; ++j) {
      const int c = half * 32 + j;
      const bool ok = qseg_r != 0 && kseg_s[c] == qseg_r &&
                      (!causal || q_pos >= k0 + c);
      const float sc = ok ? srow[j] * scale : kNegInf;
      srow[j] = sc;
      mx = fmaxf(mx, sc);
    }
    mx = fmaxf(mx, __shfl_xor_sync(~0u, mx, 1));
    const float m_new = fmaxf(m, mx);
    const float corr = expf(m - m_new);
    float sum = 0.f;
    T* prow = Ps + r * ld + half * 32;
#pragma unroll 8
    for (int j = 0; j < 32; ++j) {
      const int c = half * 32 + j;
      const bool ok = qseg_r != 0 && kseg_s[c] == qseg_r &&
                      (!causal || q_pos >= k0 + c);
      const float p = ok ? expf(srow[j] - m_new) : 0.f;
      sum += p;
      prow[j] = Num<T>::store(p);
    }
    sum += __shfl_xor_sync(~0u, sum, 1);
    l = l * corr + sum;
    m = m_new;
    if (half == 0) corr_s[r] = corr;
    __syncthreads();
    gemm<T, false>(Ps, Vs, Sf);  // PV
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int e = tid + i * kThreads;
      const int row = e / kD;
      acc[i] = acc[i] * corr_s[row] + Sf[row * kLdF + (e - row * kD)];
    }
    __syncthreads();
  }

  const float l_safe = fmaxf(l, 1e-30f);
  if (half == 0) {
    l_s[r] = l_safe;
    if (q_pos < s_q)
      lse[static_cast<size_t>(bh) * s_q + q_pos] = m + logf(l_safe);
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int e = tid + i * kThreads;
    const int row = e / kD;
    if (q0 + row < s_q)
      out[(static_cast<size_t>(bh) * s_q + q0) * kD + e] =
          Num<T>::store(acc[i] / l_s[row]);
  }
}

// ---------------------------------------------------------------- B2 ----

template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        const int* __restrict__ q_seg,
                        const int* __restrict__ k_seg,
                        const int* __restrict__ q_len,
                        const int* __restrict__ k_len, T* __restrict__ dq,
                        int h, int h_kv, int s_q, int s_k, float scale,
                        int causal) {
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* dOs = reinterpret_cast<T*>(smem + tile_bytes<T>());
  T* Ks = reinterpret_cast<T*>(smem + 2 * tile_bytes<T>());
  T* Vs = reinterpret_cast<T*>(smem + 3 * tile_bytes<T>());
  T* dSs = reinterpret_cast<T*>(smem + 4 * tile_bytes<T>());
  float* Sf = reinterpret_cast<float*>(smem + 5 * tile_bytes<T>());
  float* dPf = Sf + kTile * kLdF;
  int* kseg_s = reinterpret_cast<int*>(dPf + kTile * kLdF);

  constexpr int ld = Num<T>::kLd;
  const int bh = blockIdx.x;
  const int b = bh / h;
  const int kv_row = b * h_kv + (bh - b * h) / (h / h_kv);
  const int q0 = blockIdx.y * kTile;
  const int tid = threadIdx.x;
  const int r = tid >> 1;
  const int half = tid & 1;
  const int q_pos = q0 + r;
  const bool q_in = q_pos < s_q;
  const int qseg_r = q_in ? q_seg[b * s_q + q_pos] : 0;
  const size_t row_off = static_cast<size_t>(bh) * s_q + q_pos;
  const float lse_r = q_in ? lse[row_off] : 0.f;
  const float delta_r = q_in ? delta[row_off] : 0.f;

  const int n_k = cdiv(s_k, kTile);
  int num_k = causal ? min(cdiv(q0 + kTile, kTile), n_k) : n_k;
  num_k = min(num_k, cdiv(k_len[b], kTile));
  if (blockIdx.y >= cdiv(q_len[b], kTile)) num_k = 0;

  const size_t q_off = (static_cast<size_t>(bh) * s_q + q0) * kD;
  load_tile(q + q_off, s_q - q0, Qs);
  load_tile(dout + q_off, s_q - q0, dOs);
  float acc[kPerThread];
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) acc[i] = 0.f;

  for (int kt = 0; kt < num_k; ++kt) {
    const int k0 = kt * kTile;
    const size_t kv_off = (static_cast<size_t>(kv_row) * s_k + k0) * kD;
    load_tile(k + kv_off, s_k - k0, Ks);
    load_tile(v + kv_off, s_k - k0, Vs);
    if (tid < kTile) kseg_s[tid] = k0 + tid < s_k ? k_seg[b * s_k + k0 + tid] : 0;
    __syncthreads();
    gemm<T, true>(Qs, Ks, Sf);    // S = Q K^T
    gemm<T, true>(dOs, Vs, dPf);  // dP = dO V^T
    __syncthreads();
#pragma unroll 8
    for (int j = 0; j < 32; ++j) {
      const int c = half * 32 + j;
      const bool ok = qseg_r != 0 && kseg_s[c] == qseg_r &&
                      (!causal || q_pos >= k0 + c);
      const float p =
          ok ? expf(Sf[r * kLdF + c] * scale - lse_r) : 0.f;
      dSs[r * ld + c] = Num<T>::store(p * (dPf[r * kLdF + c] - delta_r));
    }
    __syncthreads();
    gemm<T, false>(dSs, Ks, Sf);  // dS K
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int e = tid + i * kThreads;
      const int row = e / kD;
      acc[i] += Sf[row * kLdF + (e - row * kD)];
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int e = tid + i * kThreads;
    if (q0 + e / kD < s_q) dq[q_off + e] = Num<T>::store(acc[i] * scale);
  }
}

// ---------------------------------------------------------------- B3 ----

template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         const int* __restrict__ q_seg,
                         const int* __restrict__ k_seg,
                         const int* __restrict__ q_len,
                         const int* __restrict__ k_len,
                         float* __restrict__ dk, float* __restrict__ dv, int h,
                         int h_kv, int s_q, int s_k, float scale, int causal) {
  extern __shared__ __align__(128) unsigned char smem[];
  T* Ks = reinterpret_cast<T*>(smem);
  T* Vs = reinterpret_cast<T*>(smem + tile_bytes<T>());
  T* Qs = reinterpret_cast<T*>(smem + 2 * tile_bytes<T>());
  T* dOs = reinterpret_cast<T*>(smem + 3 * tile_bytes<T>());
  T* Ps = reinterpret_cast<T*>(smem + 4 * tile_bytes<T>());   // P^T
  T* dSs = reinterpret_cast<T*>(smem + 5 * tile_bytes<T>());  // dS^T
  float* Sf = reinterpret_cast<float*>(smem + 6 * tile_bytes<T>());
  float* dPf = Sf + kTile * kLdF;
  float* lse_s = dPf + kTile * kLdF;  // (64,) per query tile
  float* delta_s = lse_s + kTile;
  int* qseg_s = reinterpret_cast<int*>(delta_s + kTile);

  constexpr int ld = Num<T>::kLd;
  const int bkv = blockIdx.x;
  const int b = bkv / h_kv;
  const int grp = h / h_kv;
  const int k0 = blockIdx.y * kTile;
  const int tid = threadIdx.x;
  // Element-wise ownership in transposed space: key row r, query columns
  // 32 * half .. +32.
  const int r = tid >> 1;
  const int half = tid & 1;
  const int k_pos = k0 + r;
  const int kseg_r = k_pos < s_k ? k_seg[b * s_k + k_pos] : 0;

  const int first_q = causal ? k0 / kTile : 0;
  int last_q = min(cdiv(s_q, kTile), cdiv(q_len[b], kTile));
  if (blockIdx.y >= cdiv(k_len[b], kTile)) last_q = first_q;

  const size_t kv_off = (static_cast<size_t>(bkv) * s_k + k0) * kD;
  load_tile(k + kv_off, s_k - k0, Ks);
  load_tile(v + kv_off, s_k - k0, Vs);
  float dk_sum[kPerThread], dv_sum[kPerThread];
  float dk_acc[kPerThread], dv_acc[kPerThread];
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) dk_sum[i] = dv_sum[i] = 0.f;

  for (int g = 0; g < grp; ++g) {
    // Query head (bkv % h_kv) * grp + g of batch b.
    const int q_row = b * h + (bkv - b * h_kv) * grp + g;
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) dk_acc[i] = dv_acc[i] = 0.f;
    for (int qt = first_q; qt < last_q; ++qt) {
      const int q0 = qt * kTile;
      const size_t q_off = (static_cast<size_t>(q_row) * s_q + q0) * kD;
      // Every thread is past the previous iteration's last barrier, so the
      // tiles and row vectors below are free to overwrite.
      load_tile(q + q_off, s_q - q0, Qs);
      load_tile(dout + q_off, s_q - q0, dOs);
      if (tid < kTile) {
        const bool in = q0 + tid < s_q;
        const size_t row = static_cast<size_t>(q_row) * s_q + q0 + tid;
        lse_s[tid] = in ? lse[row] : 0.f;
        delta_s[tid] = in ? delta[row] : 0.f;
        qseg_s[tid] = in ? q_seg[b * s_q + q0 + tid] : 0;
      }
      __syncthreads();
      gemm<T, true>(Ks, Qs, Sf);    // S^T = K Q^T
      gemm<T, true>(Vs, dOs, dPf);  // dP^T = V dO^T
      __syncthreads();
#pragma unroll 8
      for (int j = 0; j < 32; ++j) {
        const int c = half * 32 + j;
        const bool ok = kseg_r != 0 && qseg_s[c] == kseg_r &&
                        (!causal || q0 + c >= k_pos);
        const float p =
            ok ? expf(Sf[r * kLdF + c] * scale - lse_s[c]) : 0.f;
        Ps[r * ld + c] = Num<T>::store(p);
        dSs[r * ld + c] =
            Num<T>::store(p * (dPf[r * kLdF + c] - delta_s[c]));
      }
      __syncthreads();
      gemm<T, false>(Ps, dOs, Sf);   // P^T dO
      gemm<T, false>(dSs, Qs, dPf);  // dS^T Q
      __syncthreads();
#pragma unroll
      for (int i = 0; i < kPerThread; ++i) {
        const int e = tid + i * kThreads;
        const int row = e / kD;
        const int col = e - row * kD;
        dv_acc[i] += Sf[row * kLdF + col];
        dk_acc[i] += dPf[row * kLdF + col];
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      dk_sum[i] += dk_acc[i] * scale;
      dv_sum[i] += dv_acc[i];
    }
  }

#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int e = tid + i * kThreads;
    if (k0 + e / kD < s_k) {
      dk[kv_off + e] = dk_sum[i];
      dv[kv_off + e] = dv_sum[i];
    }
  }
}

// ------------------------------------------- bf16 tensor-core path ----

using bf16 = __nv_bfloat16;
constexpr int kLdB = kD + 8;          // 144-byte rows (conflict-free ldmatrix)
constexpr int kTileB = kTile * kLdB;  // bf16 elements of one staged tile
constexpr int kStages = 2;            // cp.async ring depth

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !in.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(in ? 16 : 0));
}

// 4 bytes, likewise: row vectors whose start need not be 16-byte aligned.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(in ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Waits until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [0, rows) of a 64 x 64 head-major tile at src into dst (row stride
// kLdB), asynchronously, by a block of kThr threads; rows past `rows` (a
// ragged last tile) are zero-filled.
template <int kThr>
__device__ __forceinline__ void load_tile_async(const bf16* __restrict__ src,
                                                int rows, bf16* dst) {
  for (int i = threadIdx.x; i < kTile * (kD / 8); i += kThr) {
    const int r = i / (kD / 8);
    const int c = (i - r * (kD / 8)) * 8;
    const bool in = r < rows;
    cp_async16(dst + r * kLdB + c, src + (in ? r * kD + c : 0), in);
  }
}

// 64 four-byte values (f32 or int32) at src into dst; zero past `valid`.
template <int kThr>
__device__ __forceinline__ void load_row_async(const void* src, int valid,
                                               void* dst) {
  const uint32_t* s = static_cast<const uint32_t*>(src);
  for (int i = threadIdx.x; i < kTile; i += kThr) {
    const bool in = i < valid;
    cp_async4(static_cast<uint32_t*>(dst) + i, s + (in ? i : 0), in);
  }
}

// Four 8x8 b16 matrices from shared memory: lane l gives the address of
// row l % 8 of matrix l / 8 and receives in r[j] its two elements of matrix
// j (row l / 4, columns 2 (l % 4) and +1; of the transpose with .trans).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d (16 x 8 f32) += a (16 x 16 bf16, row) * b (16 x 8 bf16, col). Lane l
// (g = l / 4, t = l % 4) holds a at rows g, g + 8 x columns 2t, 2t + 1 and
// 2t + 8, 2t + 9; b at rows 2t, 2t + 1 and 2t + 8, 2t + 9 of column g; d at
// rows g, g + 8 x columns 2t, 2t + 1.
__device__ __forceinline__ void mma16816(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d = a * b, the same product with a zero accumulator.
__device__ __forceinline__ void mma16816_z(float (&d)[4],
                                           const uint32_t (&a)[4],
                                           uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.f));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// A fragments of the 16 x 64 strip at rows [16w, 16w + 16) of a staged
// tile; a[kk] is its k16 slice kk.
__device__ __forceinline__ void load_a_strip(uint32_t (&a)[4][4],
                                             const bf16* tile, int w,
                                             int lane) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    ldsm_x4(a[kk], tile + (16 * w + (lane & 15)) * kLdB + 16 * kk +
                       (lane >> 4) * 8);
}

// acc (16 x 8 kNJ) = a (the warp's 16 x 64 strip) * B^T, B's rows staged
// row-major in `tile` (K for S = Q K^T; Q and dO for S^T and dP^T): acc[j]
// is the n8 tile of B's rows 8 (kJ0 + j)..+7.
template <int kJ0 = 0, int kNJ = 8>
__device__ __forceinline__ void mma_abt(float (&acc)[kNJ][4],
                                        const uint32_t (&a)[4][4],
                                        const bf16* tile, int lane) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int jp = 0; jp < kNJ / 2; ++jp) {
      uint32_t b[4];
      ldsm_x4(b, tile + (8 * kJ0 + 16 * jp + (lane & 7) +
                         ((lane >> 4) << 3)) * kLdB +
                     16 * kk + ((lane >> 3) & 1) * 8);
      if (kk == 0) {
        mma16816_z(acc[2 * jp], a[kk], b[0], b[1]);
        mma16816_z(acc[2 * jp + 1], a[kk], b[2], b[3]);
      } else {
        mma16816(acc[2 * jp], a[kk], b[0], b[1]);
        mma16816(acc[2 * jp + 1], a[kk], b[2], b[3]);
      }
    }
  }
}

// acc (16 x 64) += p (A fragments of kNK k16 slices) * the tile's staged
// rows 16 (kK0 + kk)..+15 as the k dimension (V in P V; dO and Q in B3).
template <int kK0 = 0, int kNK = 4>
__device__ __forceinline__ void mma_ab(float (&acc)[8][4],
                                       const uint32_t (&p)[kNK][4],
                                       const bf16* tile, int lane) {
#pragma unroll
  for (int kk = 0; kk < kNK; ++kk) {
#pragma unroll
    for (int jp = 0; jp < 4; ++jp) {
      uint32_t b[4];
      ldsm_x4_t(b, tile + (16 * (kK0 + kk) + (lane & 15)) * kLdB + 16 * jp +
                       (lane >> 4) * 8);
      mma16816(acc[2 * jp], p[kk], b[0], b[1]);
      mma16816(acc[2 * jp + 1], p[kk], b[2], b[3]);
    }
  }
}

// N accumulator tiles (16 x 8 f32) as the bf16 A fragments of one 16 x 8N
// operand: its k16 slice kk is n8 tiles 2kk and 2kk + 1.
template <int N>
__device__ __forceinline__ void pack_a(uint32_t (&a)[N / 2][4],
                                       const float (&x)[N][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 2; ++kk) {
    a[kk][0] = pack_bf16(x[2 * kk][0], x[2 * kk][1]);
    a[kk][1] = pack_bf16(x[2 * kk][2], x[2 * kk][3]);
    a[kk][2] = pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]);
    a[kk][3] = pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3]);
  }
}

__device__ __forceinline__ void zero(float (&x)[8][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) x[j][0] = x[j][1] = x[j][2] = x[j][3] = 0.f;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(~0u, x, 1));
  return fmaxf(x, __shfl_xor_sync(~0u, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(~0u, x, 1);
  return x + __shfl_xor_sync(~0u, x, 2);
}

// True when the warp's 16 rows [w0, w0 + 16) of `seg` (length n) all lie
// inside it and share one nonzero segment, which *one receives.
__device__ __forceinline__ bool uniform_rows(const int* __restrict__ seg,
                                             int w0, int n, int lane,
                                             int* one) {
  const int r = w0 + (lane & 15);
  const int s = r < n ? seg[r] : 0;
  *one = __shfl_sync(~0u, s, 0);
  return __all_sync(~0u, s == *one) && *one != 0;
}

// One key tile of B1's online softmax on the warp's scores s (16 x 64,
// unscaled): mask (kMasked: element by element), scale, row max, the
// rescale of the running m, l and o, and P packed to A fragments in p.
template <bool kMasked>
__device__ __forceinline__ void softmax_tile(
    float (&s)[8][4], float (&o)[8][4], float (&m)[2], float (&l)[2],
    uint32_t (&p)[4][4], const int* ks, const int (&row)[2],
    const int (&qseg)[2], int k0, int t, float scale, int causal) {
  uint32_t ok = ~0u;  // bit 4j + e: element e of n8 tile j is visible
  if (kMasked) {
    ok = 0u;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int2 kseg = *reinterpret_cast<const int2*>(ks + 8 * j + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const bool vis = qseg[r] != 0 &&
                         ((e & 1) ? kseg.y : kseg.x) == qseg[r] &&
                         (!causal || row[r] >= k0 + 8 * j + 2 * t + (e & 1));
        ok |= static_cast<uint32_t>(vis) << (4 * j + e);
      }
    }
  }
  // The row max runs on the raw scores: scaling by scale > 0 after the
  // max rounds to the max of the scaled scores. Masked elements enter as
  // -inf, and a row with none visible gets the plain version's -1e30.
  const float minus_inf = __int_as_float(0xff800000);
  float mx[2] = {minus_inf, minus_inf};
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool vis = !kMasked || ((ok >> (4 * j + e)) & 1u);
      mx[e >> 1] = fmaxf(mx[e >> 1], vis ? s[j][e] : minus_inf);
    }
  }
  float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m_new =
        fmaxf(m[r], fmaxf(__fmul_rn(quad_max(mx[r]), scale), kNegInf));
    corr[r] = expf(m[r] - m_new);
    m[r] = m_new;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      // exp(s * scale - m): scale is 1/sqrt(64) = 2^-3, so s * scale is
      // exact and fmaf rounds once, after the subtraction, as the plain
      // version's two steps do.
      float pe = expf(fmaf(s[j][e], scale, -m[e >> 1]));
      if (kMasked && !((ok >> (4 * j + e)) & 1u)) pe = 0.f;
      s[j][e] = pe;
      sum[e >> 1] += pe;
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r)
    l[r] = __fadd_rn(__fmul_rn(l[r], corr[r]), quad_sum(sum[r]));
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    o[j][0] *= corr[0];
    o[j][1] *= corr[0];
    o[j][2] *= corr[1];
    o[j][3] *= corr[1];
  }
  pack_a(p, s);
}

// ------------------------------------------------------------ bf16 B1 ----

// Smem: the Q tile, then kStages ring slots of a K and a V tile, then
// kStages rows of key segment ids: 46.6 KB.
constexpr size_t kFwdSmem =
    (1 + 2 * kStages) * kTileB * sizeof(bf16) + kStages * kTile * 4;

// 4 blocks an SM (16 warps): at most 128 registers a thread, and 4 x 46.6
// KB of shared memory. Fewer warps measured slower, whatever they gained
// in registers.
__global__ void __launch_bounds__(kThreads, 4)
    flash_fwd_bf16_kernel(const bf16* __restrict__ q,
                          const bf16* __restrict__ k,
                          const bf16* __restrict__ v,
                          const int* __restrict__ q_seg,
                          const int* __restrict__ k_seg,
                          const int* __restrict__ q_len,
                          const int* __restrict__ k_len,
                          bf16* __restrict__ out, float* __restrict__ lse,
                          int h, int h_kv, int s_q, int s_k, float scale,
                          int causal) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* ring = Qs + kTileB;  // slot st: K tile at ring + 2 st kTileB, V after
  int* kseg_ring = reinterpret_cast<int*>(ring + 2 * kStages * kTileB);

  const int bh = blockIdx.x;
  const int b = bh / h;
  const int kv_row = b * h_kv + (bh - b * h) / (h / h_kv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;  // longest first
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int t = lane & 3;
  const int w0 = q0 + 16 * warp;  // the warp's first query row
  const int row[2] = {w0 + (lane >> 2), w0 + (lane >> 2) + 8};
  const int* qseg_b = q_seg + static_cast<size_t>(b) * s_q;
  int qseg[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) qseg[r] = row[r] < s_q ? qseg_b[row[r]] : 0;
  int wseg;
  const bool w_uniform = uniform_rows(qseg_b, w0, s_q, lane, &wseg);

  const int n_k = cdiv(s_k, kTile);
  int num_k = causal ? min(cdiv(q0 + kTile, kTile), n_k) : n_k;
  num_k = min(num_k, cdiv(k_len[b], kTile));
  if (q0 >= q_len[b]) num_k = 0;

  const size_t q_base = static_cast<size_t>(bh) * s_q;
  const size_t kv_base = static_cast<size_t>(kv_row) * s_k;
  const int* kseg_b = k_seg + static_cast<size_t>(b) * s_k;
  auto load_kv = [&](int kt) {
    const int k0 = kt * kTile;
    bf16* Ks = ring + 2 * (kt % kStages) * kTileB;
    load_tile_async<kThreads>(k + (kv_base + k0) * kD, s_k - k0, Ks);
    load_tile_async<kThreads>(v + (kv_base + k0) * kD, s_k - k0,
                              Ks + kTileB);
    load_row_async<kThreads>(kseg_b + k0, s_k - k0,
                             kseg_ring + (kt % kStages) * kTile);
  };
  if (num_k > 0) {
    load_tile_async<kThreads>(q + (q_base + q0) * kD, s_q - q0, Qs);
    load_kv(0);
  }
  cp_async_commit();
#pragma unroll
  for (int i = 1; i < kStages - 1; ++i) {
    if (i < num_k) load_kv(i);
    cp_async_commit();
  }

  float o[8][4], m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  zero(o);
  uint32_t qf[4][4];
  for (int kt = 0; kt < num_k; ++kt) {
    // Tile kt has landed, and every warp is done with the slot that tile
    // kt + kStages - 1 overwrites.
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (kt == 0) load_a_strip(qf, Qs, warp, lane);
    if (kt + kStages - 1 < num_k) load_kv(kt + kStages - 1);
    cp_async_commit();

    const int k0 = kt * kTile;
    const bf16* Ks = ring + 2 * (kt % kStages) * kTileB;
    const int* ks = kseg_ring + (kt % kStages) * kTile;
    float s[8][4];
    mma_abt(s, qf, Ks, lane);  // S = Q K^T
    // The element mask runs on the causal diagonal and wherever a row or
    // a key is padding, past the end or in another segment.
    bool masked = !w_uniform || (causal && k0 + kTile - 1 > w0);
    if (!masked)
      masked = !__all_sync(~0u, ks[lane] == wseg && ks[lane + 32] == wseg);
    uint32_t p[4][4];
    if (masked)
      softmax_tile<true>(s, o, m, l, p, ks, row, qseg, k0, t, scale, causal);
    else
      softmax_tile<false>(s, o, m, l, p, ks, row, qseg, k0, t, scale,
                          causal);
    mma_ab(o, p, Ks + kTileB, lane);  // o += P V
  }

  float l_safe[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_safe[r] = fmaxf(l[r], 1e-30f);
    if (t == 0 && row[r] < s_q) lse[q_base + row[r]] = m[r] + logf(l_safe[r]);
  }
  // The warp's 16 output rows go through its own rows of Qs (which only
  // this warp read, at kt = 0), then out in 16-byte stores.
  bf16* Os = Qs + 16 * warp * kLdB;
  const int g = lane >> 2;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    *reinterpret_cast<uint32_t*>(Os + g * kLdB + 8 * j + 2 * t) =
        pack_bf16(o[j][0] / l_safe[0], o[j][1] / l_safe[0]);
    *reinterpret_cast<uint32_t*>(Os + (g + 8) * kLdB + 8 * j + 2 * t) =
        pack_bf16(o[j][2] / l_safe[1], o[j][3] / l_safe[1]);
  }
  __syncwarp();
#pragma unroll
  for (int i = lane; i < 16 * (kD / 8); i += 32) {
    const int r = i / (kD / 8);
    const int c = (i - r * (kD / 8)) * 8;
    if (w0 + r < s_q)
      *reinterpret_cast<uint4*>(out + (q_base + w0 + r) * kD + c) =
          *reinterpret_cast<const uint4*>(Os + r * kLdB + c);
  }
}

// ------------------------------------------------------------ bf16 B3 ----

// A ring slot of B3: the Q and dO tiles, then the lse, delta and segment
// rows of the same 64 queries.
constexpr size_t kDkvSlot = 2 * kTileB * sizeof(bf16) + 3 * kTile * 4;

// 3 blocks an SM (12 warps): at most 168 registers a thread, of which the
// K and V fragments and the dK, dV accumulators hold 96 (the queries of a
// tile go in two halves, so one half's S^T and dP^T, 32 registers, are
// live at a time; the whole tile at once took 224 registers and 2 blocks,
// and measured 17% slower); 3 x 38.4 KB of shared memory.
__global__ void __launch_bounds__(kThreads, 3)
    flash_bwd_dkv_bf16_kernel(const bf16* __restrict__ q,
                              const bf16* __restrict__ k,
                              const bf16* __restrict__ v,
                              const bf16* __restrict__ dout,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              const int* __restrict__ q_seg,
                              const int* __restrict__ k_seg,
                              const int* __restrict__ q_len,
                              const int* __restrict__ k_len,
                              float* __restrict__ dk, float* __restrict__ dv,
                              int h, int h_kv, int s_q, int s_k, float scale,
                              int causal) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int bkv = blockIdx.x;
  const int b = bkv / h_kv;
  const int grp = h / h_kv;
  const int k0 = blockIdx.y * kTile;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int t = lane & 3;
  const int w0 = k0 + 16 * warp;  // the warp's first key row
  const int krow[2] = {w0 + (lane >> 2), w0 + (lane >> 2) + 8};
  const int* kseg_b = k_seg + static_cast<size_t>(b) * s_k;
  int kseg[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) kseg[r] = krow[r] < s_k ? kseg_b[krow[r]] : 0;
  int wseg;
  const bool w_uniform = uniform_rows(kseg_b, w0, s_k, lane, &wseg);

  const int first_q = causal ? k0 / kTile : 0;
  int last_q = min(cdiv(s_q, kTile), cdiv(q_len[b], kTile));
  if (k0 >= k_len[b]) last_q = first_q;
  const int n_qt = max(last_q - first_q, 0);
  const int n_it = grp * n_qt;  // (group member, query tile) pairs

  auto slot = [&](int it) {
    return reinterpret_cast<bf16*>(smem + (it % kStages) * kDkvSlot);
  };
  // The first query of pair it's tile; *q_row gets its (batch, head) row.
  auto tile_of = [&](int it, int* q_row) {
    const int gi = it / n_qt;
    *q_row = b * h + (bkv - b * h_kv) * grp + gi;
    return (first_q + it - gi * n_qt) * kTile;
  };
  auto load_q = [&](int it) {
    int q_row;
    const int q0 = tile_of(it, &q_row);
    const size_t row0 = static_cast<size_t>(q_row) * s_q + q0;
    bf16* Qs = slot(it);
    float* rows = reinterpret_cast<float*>(Qs + 2 * kTileB);
    load_tile_async<kThreads>(q + row0 * kD, s_q - q0, Qs);
    load_tile_async<kThreads>(dout + row0 * kD, s_q - q0, Qs + kTileB);
    load_row_async<kThreads>(lse + row0, s_q - q0, rows);
    load_row_async<kThreads>(delta + row0, s_q - q0, rows + kTile);
    load_row_async<kThreads>(q_seg + static_cast<size_t>(b) * s_q + q0,
                             s_q - q0, rows + 2 * kTile);
  };

  float dk_acc[8][4], dv_acc[8][4];
  zero(dk_acc);
  zero(dv_acc);
  uint32_t kf[4][4], vf[4][4];
  if (n_it > 0) {
    // K and V pass through the last ring slot, which the first tile to
    // reach it (it = kStages - 1) overwrites only after the loop's first
    // barrier.
    bf16* KVs = slot(kStages - 1);
    const size_t kv_off = (static_cast<size_t>(bkv) * s_k + k0) * kD;
    load_tile_async<kThreads>(k + kv_off, s_k - k0, KVs);
    load_tile_async<kThreads>(v + kv_off, s_k - k0, KVs + kTileB);
    cp_async_commit();
#pragma unroll
    for (int i = 0; i < kStages - 1; ++i) {
      if (i < n_it) load_q(i);
      cp_async_commit();
    }
    cp_async_wait<kStages - 1>();
    __syncthreads();
    load_a_strip(kf, KVs, warp, lane);
    load_a_strip(vf, KVs + kTileB, warp, lane);
  }

  for (int it = 0; it < n_it; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (it + kStages - 1 < n_it) load_q(it + kStages - 1);
    cp_async_commit();

    int q_row;
    const int q0 = tile_of(it, &q_row);
    const bf16* Qs = slot(it);
    const bf16* dOs = Qs + kTileB;
    const float* lse_s = reinterpret_cast<const float*>(Qs + 2 * kTileB);
    const float* delta_s = lse_s + kTile;
    const int* qseg_s = reinterpret_cast<const int*>(delta_s + kTile);

    bool masked = !w_uniform || (causal && q0 < w0 + 15);
    if (!masked)
      masked = !__all_sync(~0u, qseg_s[lane] == wseg &&
                                    qseg_s[lane + 32] == wseg);
    // The 64 queries in two halves of 32, so that S^T and dP^T of one half
    // (32 registers) are live at a time.
    auto half = [&](auto half_c) {
      constexpr int H = decltype(half_c)::value;
      float st[4][4], dpt[4][4];  // S^T and dP^T: 16 keys x 32 queries
      mma_abt<4 * H, 4>(st, kf, Qs, lane);    // S^T = K Q^T
      mma_abt<4 * H, 4>(dpt, vf, dOs, lane);  // dP^T = V dO^T
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c0 = 32 * H + 8 * j + 2 * t;
        const float2 lse2 = *reinterpret_cast<const float2*>(lse_s + c0);
        const float2 delta2 =
            *reinterpret_cast<const float2*>(delta_s + c0);
        int2 qseg2 = make_int2(0, 0);
        if (masked) qseg2 = *reinterpret_cast<const int2*>(qseg_s + c0);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int odd = e & 1;
          const int r = e >> 1;
          // P^T = exp(scale S^T - lse) (s * scale exact, as in B1);
          // dS^T = P^T (dP^T - delta).
          float p = expf(fmaf(st[j][e], scale, odd ? -lse2.y : -lse2.x));
          if (masked) {
            const bool vis = kseg[r] != 0 &&
                             (odd ? qseg2.y : qseg2.x) == kseg[r] &&
                             (!causal || q0 + c0 + odd >= krow[r]);
            if (!vis) p = 0.f;
          }
          st[j][e] = p;
          dpt[j][e] = p * (dpt[j][e] - (odd ? delta2.y : delta2.x));
        }
      }
      uint32_t pf[2][4], dsf[2][4];
      pack_a(pf, st);
      pack_a(dsf, dpt);
      mma_ab<2 * H, 2>(dv_acc, pf, dOs, lane);  // dV += P^T dO
      mma_ab<2 * H, 2>(dk_acc, dsf, Qs, lane);  // dK += dS^T Q
    };
    half(std::integral_constant<int, 0>());
    half(std::integral_constant<int, 1>());
  }

  // One f32 store of each key row; dK scaled once for the whole group.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (krow[r] >= s_k) continue;
    const size_t off = (static_cast<size_t>(bkv) * s_k + krow[r]) * kD;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = 8 * j + 2 * t;
      *reinterpret_cast<float2*>(dk + off + c) = make_float2(
          dk_acc[j][2 * r] * scale, dk_acc[j][2 * r + 1] * scale);
      *reinterpret_cast<float2*>(dv + off + c) =
          make_float2(dv_acc[j][2 * r], dv_acc[j][2 * r + 1]);
    }
  }
}

// ------------------------------------------------------------ launches ----

template <typename Kernel>
int prepare(Kernel kernel, size_t smem) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

int check_dims(int b, int h, int h_kv, int s_q, int s_k) {
  if (h_kv <= 0 || h % h_kv || b < 0 || s_q < 0 || s_k < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

template <typename T>
int fwd(const void* q, const void* k, const void* v, const void* q_seg,
        const void* k_seg, const void* q_len, const void* k_len, void* out,
        void* lse, int b, int h, int h_kv, int s_q, int s_k, float scale,
        int causal, cudaStream_t stream) {
  const dim3 grid(b * h, (s_q + kTile - 1) / kTile);
  if constexpr (std::is_same<T, bf16>::value) {
    if (int err = prepare(flash_fwd_bf16_kernel, kFwdSmem)) return err;
    flash_fwd_bf16_kernel<<<grid, kThreads, kFwdSmem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const int*>(q_seg),
        static_cast<const int*>(k_seg), static_cast<const int*>(q_len),
        static_cast<const int*>(k_len), static_cast<bf16*>(out),
        static_cast<float*>(lse), h, h_kv, s_q, s_k, scale, causal);
  } else {
    const size_t smem = 4 * tile_bytes<T>() + kTileF +
                        2 * kTile * sizeof(float) + kTile * sizeof(int);
    auto kernel = flash_fwd_kernel<T>;
    if (int err = prepare(kernel, smem)) return err;
    kernel<<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const int*>(q_seg),
        static_cast<const int*>(k_seg), static_cast<const int*>(q_len),
        static_cast<const int*>(k_len), static_cast<T*>(out),
        static_cast<float*>(lse), h, h_kv, s_q, s_k, scale, causal);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int bwd_dq(const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* delta, const void* q_seg,
           const void* k_seg, const void* q_len, const void* k_len, void* dq,
           int b, int h, int h_kv, int s_q, int s_k, float scale, int causal,
           cudaStream_t stream) {
  const size_t smem = 5 * tile_bytes<T>() + 2 * kTileF + kTile * sizeof(int);
  auto kernel = flash_bwd_dq_kernel<T>;
  if (int err = prepare(kernel, smem)) return err;
  kernel<<<dim3(b * h, (s_q + kTile - 1) / kTile), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int*>(q_seg), static_cast<const int*>(k_seg),
      static_cast<const int*>(q_len), static_cast<const int*>(k_len),
      static_cast<T*>(dq), h, h_kv, s_q, s_k, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
            const void* lse, const void* delta, const void* q_seg,
            const void* k_seg, const void* q_len, const void* k_len, void* dk,
            void* dv, int b, int h, int h_kv, int s_q, int s_k, float scale,
            int causal, cudaStream_t stream) {
  const dim3 grid(b * h_kv, (s_k + kTile - 1) / kTile);
  if constexpr (std::is_same<T, bf16>::value) {
    const size_t smem = kStages * kDkvSlot;
    if (int err = prepare(flash_bwd_dkv_bf16_kernel, smem)) return err;
    flash_bwd_dkv_bf16_kernel<<<grid, kThreads, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<const int*>(q_seg), static_cast<const int*>(k_seg),
        static_cast<const int*>(q_len), static_cast<const int*>(k_len),
        static_cast<float*>(dk), static_cast<float*>(dv), h, h_kv, s_q, s_k,
        scale, causal);
  } else {
    const size_t smem = 6 * tile_bytes<T>() + 2 * kTileF +
                        2 * kTile * sizeof(float) + kTile * sizeof(int);
    auto kernel = flash_bwd_dkv_kernel<T>;
    if (int err = prepare(kernel, smem)) return err;
    kernel<<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<const int*>(q_seg), static_cast<const int*>(k_seg),
        static_cast<const int*>(q_len), static_cast<const int*>(k_len),
        static_cast<float*>(dk), static_cast<float*>(dv), h, h_kv, s_q, s_k,
        scale, causal);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Pointers: q, out, dq, dout (b, h, s_q, 64) and k, v (b, h_kv, s_k, 64),
// contiguous, in the dtype (0 = f32, 1 = bf16); lse, delta (b, h, s_q) f32;
// dk, dv (b, h_kv, s_k, 64) f32; q_seg (b, s_q) and k_seg (b, s_k) int32
// with 0 = padding; q_len, k_len (b,) int32, the tokens through each row's
// last non-padding one. Each returns cudaGetLastError() after its launch
// (0 = launched).

extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         const void* q_seg, const void* k_seg,
                         const void* q_len, const void* k_len, void* out,
                         void* lse, int b, int h, int h_kv, int s_q, int s_k,
                         float scale, int causal, int dtype, void* stream) {
  if (int err = check_dims(b, h, h_kv, s_q, s_k)) return err;
  if (b == 0 || s_q == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return fwd<float>(q, k, v, q_seg, k_seg, q_len, k_len, out, lse, b, h,
                      h_kv, s_q, s_k, scale, causal, s);
  if (dtype == 1)
    return fwd<__nv_bfloat16>(q, k, v, q_seg, k_seg, q_len, k_len, out, lse,
                              b, h, h_kv, s_q, s_k, scale, causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, const void* q_seg,
                            const void* k_seg, const void* q_len,
                            const void* k_len, void* dq, int b, int h,
                            int h_kv, int s_q, int s_k, float scale,
                            int causal, int dtype, void* stream) {
  if (int err = check_dims(b, h, h_kv, s_q, s_k)) return err;
  if (b == 0 || s_q == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return bwd_dq<float>(q, k, v, dout, lse, delta, q_seg, k_seg, q_len,
                         k_len, dq, b, h, h_kv, s_q, s_k, scale, causal, s);
  if (dtype == 1)
    return bwd_dq<__nv_bfloat16>(q, k, v, dout, lse, delta, q_seg, k_seg,
                                 q_len, k_len, dq, b, h, h_kv, s_q, s_k,
                                 scale, causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, const void* q_seg,
                             const void* k_seg, const void* q_len,
                             const void* k_len, void* dk, void* dv, int b,
                             int h, int h_kv, int s_q, int s_k, float scale,
                             int causal, int dtype, void* stream) {
  if (int err = check_dims(b, h, h_kv, s_q, s_k)) return err;
  if (b == 0 || s_k == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return bwd_dkv<float>(q, k, v, dout, lse, delta, q_seg, k_seg, q_len,
                          k_len, dk, dv, b, h, h_kv, s_q, s_k, scale, causal,
                          s);
  if (dtype == 1)
    return bwd_dkv<__nv_bfloat16>(q, k, v, dout, lse, delta, q_seg, k_seg,
                                  q_len, k_len, dk, dv, b, h, h_kv, s_q, s_k,
                                  scale, causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
