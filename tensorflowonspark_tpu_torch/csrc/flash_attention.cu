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
// take 0.015-0.03 ms at b8 x h12. This design reaches neither roof: its
// time goes to latency, as below.
//
// Design. One thread block (4 warps) per (batch * head, 64-row query tile)
// for B1 and B2, and per (batch * kv head, 64-row key tile) for B3. CUDA
// blocks run in no order, so the TPU's sequential grid axis becomes a loop
// inside the block over the key tiles (B1, B2) or the query tiles at or
// after the key tile (B3); per-row valid lengths and the causal diagonal
// bound every loop. B3 loops over the query heads of its GQA group inside
// the block and sums their dK/dV in registers: no atomics, one f32 sum.
// Tiles are staged in shared memory with 16-byte loads; in bf16 every
// product (QK^T, PV, dO V^T, dS K, P^T dO, dS^T Q) runs on the tensor cores
// through 16x16x16 WMMA fragments with f32 accumulation, and each result
// goes through a shared f32 tile where the softmax and gradient
// element-wise math reads it. f32 operands take plain FMAs in full f32
// (the tensor cores would round them to TF32). This first version keeps
// one tile in flight per block and round-trips every product through
// shared memory; register-resident accumulators (mma.sync/wgmma) and
// asynchronous loads (cp.async/TMA) are the next steps toward the bound.
//
// Numerics mirror the Pallas kernels: scores = f32(QK^T) * scale, masked
// with an explicit -1e30; m, l and the accumulators in f32; P and dS cast
// to the operand dtype before their products; out = acc / max(l, 1e-30) and
// lse = m + log(max(l, 1e-30)); dQ = (scale * acc) in the operand dtype;
// dK = sum over the group of scale * acc, dV likewise without the scale,
// both f32. A fully padded query row gives out 0, lse -1e30 and zero
// gradients.

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
  const size_t smem = 4 * tile_bytes<T>() + kTileF +
                      2 * kTile * sizeof(float) + kTile * sizeof(int);
  auto kernel = flash_fwd_kernel<T>;
  if (int err = prepare(kernel, smem)) return err;
  kernel<<<dim3(b * h, (s_q + kTile - 1) / kTile), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(q_seg),
      static_cast<const int*>(k_seg), static_cast<const int*>(q_len),
      static_cast<const int*>(k_len), static_cast<T*>(out),
      static_cast<float*>(lse), h, h_kv, s_q, s_k, scale, causal);
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
  const size_t smem = 6 * tile_bytes<T>() + 2 * kTileF +
                      2 * kTile * sizeof(float) + kTile * sizeof(int);
  auto kernel = flash_bwd_dkv_kernel<T>;
  if (int err = prepare(kernel, smem)) return err;
  kernel<<<dim3(b * h_kv, (s_k + kTile - 1) / kTile), kThreads, smem,
           stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int*>(q_seg), static_cast<const int*>(k_seg),
      static_cast<const int*>(q_len), static_cast<const int*>(k_len),
      static_cast<float*>(dk), static_cast<float*>(dv), h, h_kv, s_q, s_k,
      scale, causal);
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
