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
// Head widths. Every kernel is a template on the head width D and is built
// for D = 32, 64 and 128 (the C entry points take d and return
// cudaErrorInvalidValue for any other). Query and key tiles stay 64 rows at
// every width; operand tiles are 64 x D, score tiles 64 x 64, each with its
// own row stride.
//
// Bound. At the training shapes (s = 1024, d = 64, bf16, causal) each
// kernel's least work sits near the H100's ridge point: per (batch, head)
// the forward does 0.13 GFLOP of products on 0.53 MB of q, k, v, out and
// lse, ~250 FLOP per byte against the card's 295, so bytes bound B1 by a
// hair; B2 (three products per visible pair) is bound by the bf16 rate,
// and B3 by its bytes again, its dK/dV leaving in f32. All three would
// take 0.015-0.03 ms at b8 x h12. Below the products, each exponential
// comes with only 2d = 128 tensor-core multiply-adds at d = 64 (64 at
// d = 32): the f32 softmax work on the CUDA cores (mask, max, exp, sum,
// rescale) weighs as much as the products and has to overlap them.
//
// Grid. CUDA blocks run in no order, so the TPU's sequential grid axis
// becomes a loop inside the block over the key tiles (B1, B2) or the query
// tiles at or after the key tile (B3); per-row valid lengths and the causal
// diagonal bound every loop. One block (4 warps, warp w owns tile rows
// 16w..16w+15) per (batch * head, 64-row query tile) for B1 and B2, and
// per (batch * kv head, 64-row key tile) for B3, which loops over the
// query heads of its GQA group inside the block and sums their dK/dV in
// registers: no atomics, one f32 store per row, and B2 keeps its own
// kernel, so dQ is written once per row too. B1 and B2 reverse the
// query-tile axis, so the longest causal rows launch first and the short
// ones fill the tail; B3's key-tile axis already runs longest first.
//
// bf16 (the training path): FlashAttention-2 with mma.sync. Every product
// is an m16n8k16 bf16 tensor-core op with its operands in registers: A
// fragments of the warp's 16 rows (Q for B1; Q and dO for B2; K and V for
// B3 at d <= 64), loaded once, B fragments read from the staged tiles with
// ldmatrix (.trans where the tile is the product's k x n operand: V in
// P V, K in dS K, dO in P^T dO, Q in dS^T Q). Scores land in accumulator
// registers; the mask, row max, exponentials and row sums run there, the
// max and sums combined across the 4 threads of a quad with shuffles; P
// and dS are packed to bf16 in registers and fed straight back as A
// operands (the accumulator layout of two adjacent n8 tiles is the A layout
// of one k16 slice), and the output, dQ or dK/dV accumulators stay in
// registers for the whole loop. No product goes through shared memory.
// K/V tiles (B1, B2) and Q/dO tiles with their lse, delta and segment rows
// (B3) stream through a two-stage cp.async ring: tile i+1 is in flight
// while tile i is multiplied, and one barrier per tile guards the ring
// slot. Rows are padded by 16 bytes (80, 144 or 272 bytes), so ldmatrix's
// eight row addresses fall on distinct banks. The element mask runs only
// on tiles that need it (the causal diagonal, a ragged edge, padding or a
// segment boundary, decided per warp); interior tiles skip it. B2 and B3
// take each tile in two halves of 32 keys or queries, so that the scores
// and dP of one half are live at a time. At d = 128, B3 reads its K and V
// fragments from shared memory for each product: held in registers beside
// the 128 f32 of the dK and dV accumulators they would need about 192.
//
// What bounds them now (H100 SXM, 700 W, b8 s1024 h12 d64 causal): latency
// of the in-register work, not loads or the tensor cores. B1 reaches
// about 150 TFLOP/s; a build that skips its loads ran 5% faster, one that
// skips its products and softmax took 55% of the time; it runs fastest at
// its most warps (4 blocks of 4 at 128 registers: 3 blocks +6%, 2 blocks
// +30%, 2 query strips a warp +20%), and a 2-instruction exponential in
// place of expf's 8 would save 8%. B2 reaches about 190 TFLOP/s with its
// three products; its loads weigh more than B1's (a build without them ran
// 15% faster, one without its products and softmax took 56% of the time),
// but a third ring stage gained nothing. mma.sync tops out near two thirds
// of the card's bf16 rate; wgmma (warpgroup products reading B from shared
// memory, asynchronous, with TMA loads) is the next step toward the bound.
//
// f32 operands keep the first design: tiles staged in shared memory with
// 16-byte loads, each product a block-wide pass of plain FMAs in full f32
// (the tensor cores would round them to TF32); thread t owns row t / 2 and
// half of its columns in every product and in the softmax, so scores and
// accumulators stay in registers, and P and dS go through shared memory.
//
// Numerics mirror the Pallas kernels: scores = f32(QK^T) * scale, masked
// with an explicit -1e30; m, l and the accumulators in f32; P and dS cast
// to the operand dtype before their products; out = acc / max(l, 1e-30) and
// lse = m + log(max(l, 1e-30)); dQ = (scale * acc) in the operand dtype;
// dK = sum over the group of scale * acc, dV likewise without the scale,
// both f32 (bf16 B3 scales the group's sum once). The exponent rounds the
// scaled score to f32 before it subtracts (scaled_minus): nvcc would fuse
// s * scale - m into one FMA, which rounds once. A fully padded query row
// gives out 0, lse -1e30 and zero gradients.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;  // 4 warps; warp w owns tile rows 16w..16w+15
constexpr int kTile = 64;      // query and key tile rows
constexpr float kNegInf = -1e30f;

static_assert(kTile == 16 * (kThreads / 32), "one 16-row strip per warp");

__host__ __device__ constexpr int cdiv(int a, int b) {
  return (a + b - 1) / b;
}

// The exponent s * scale - m, rounded as the plain versions round it: the
// scaled score to f32, then the difference. At d = 64, scale = 2^-3 makes
// s * scale exact, so one fmaf gives the same value.
template <int D>
__device__ __forceinline__ float scaled_minus(float s, float scale, float m) {
  if constexpr (D == 64)
    return fmaf(s, scale, -m);
  else
    return __fsub_rn(__fmul_rn(s, scale), m);
}

// ------------------------------------------------------------- f32 path ----

template <int D>
constexpr int kLdF = D + 4;       // f32 operand tile (64 x D) row stride
constexpr int kLdP = kTile + 4;   // f32 score-sized tile (64 x 64): P, dS

// Rows [0, rows) of a 64 x D head-major f32 tile at src into dst; rows past
// `rows` (a ragged last tile) are zero-filled.
template <int D>
__device__ void load_tile_f32(const float* __restrict__ src, int rows,
                              float* dst) {
  constexpr int kPerRow = D / 4;
  for (int i = threadIdx.x; i < kTile * kPerRow; i += kThreads) {
    const int r = i / kPerRow;
    const int c = (i - r * kPerRow) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < rows)
      val = *reinterpret_cast<const float4*>(src + static_cast<size_t>(r) * D +
                                             c);
    *reinterpret_cast<float4*>(dst + r * kLdF<D> + c) = val;
  }
}

// out = row t / 2 of A (64 x K, stride lda) times B, at columns
// (t % 2) N / 2 .. + N / 2 of the 64 x N product, for thread t. B is (K x N)
// row-major, or with B_T stored as (N x K) row-major. Full f32 FMAs in k
// order from zero.
template <int N, int K, bool B_T>
__device__ __forceinline__ void gemm_f32(const float* A, int lda,
                                         const float* B, int ldb,
                                         float (&out)[N / 2]) {
  const int r = threadIdx.x >> 1;
  const int c0 = (threadIdx.x & 1) * (N / 2);
#pragma unroll
  for (int j = 0; j < N / 2; ++j) out[j] = 0.f;
  for (int kk = 0; kk < K; ++kk) {
    const float a = A[r * lda + kk];
#pragma unroll
    for (int j = 0; j < N / 2; ++j)
      out[j] = fmaf(a, B_T ? B[(c0 + j) * ldb + kk] : B[kk * ldb + c0 + j],
                    out[j]);
  }
}

// ---------------------------------------------------------- f32 B1 ----

template <int D>
constexpr size_t kFwdSmemF32 =
    (3 * kTile * kLdF<D> + kTile * kLdP) * sizeof(float) + kTile * sizeof(int);

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const int* __restrict__ q_seg,
                     const int* __restrict__ k_seg,
                     const int* __restrict__ q_len,
                     const int* __restrict__ k_len, float* __restrict__ out,
                     float* __restrict__ lse, int h, int h_kv, int s_q,
                     int s_k, float scale, int causal) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int ld = kLdF<D>;
  float* Qs = reinterpret_cast<float*>(smem);
  float* Ks = Qs + kTile * ld;
  float* Vs = Ks + kTile * ld;
  float* Ps = Vs + kTile * ld;  // (64, kLdP)
  int* kseg_s = reinterpret_cast<int*>(Ps + kTile * kLdP);

  const int bh = blockIdx.x;
  const int b = bh / h;
  const int kv_row = b * h_kv + (bh - b * h) / (h / h_kv);
  const int q0 = blockIdx.y * kTile;
  const int tid = threadIdx.x;
  // Row r, key columns 32 * half .. +32, output columns D / 2 * half ..
  const int r = tid >> 1;
  const int half = tid & 1;
  const int q_pos = q0 + r;
  const int qseg_r = q_pos < s_q ? q_seg[b * s_q + q_pos] : 0;

  const int n_k = cdiv(s_k, kTile);
  int num_k = causal ? min(cdiv(q0 + kTile, kTile), n_k) : n_k;
  num_k = min(num_k, cdiv(k_len[b], kTile));
  if (blockIdx.y >= cdiv(q_len[b], kTile)) num_k = 0;

  load_tile_f32<D>(q + (static_cast<size_t>(bh) * s_q + q0) * D, s_q - q0,
                   Qs);
  float m = kNegInf, l = 0.f;
  float acc[D / 2];
#pragma unroll
  for (int j = 0; j < D / 2; ++j) acc[j] = 0.f;

  for (int kt = 0; kt < num_k; ++kt) {
    const int k0 = kt * kTile;
    const size_t kv_off = (static_cast<size_t>(kv_row) * s_k + k0) * D;
    load_tile_f32<D>(k + kv_off, s_k - k0, Ks);
    load_tile_f32<D>(v + kv_off, s_k - k0, Vs);
    if (tid < kTile) kseg_s[tid] = k0 + tid < s_k ? k_seg[b * s_k + k0 + tid] : 0;
    __syncthreads();
    float s[kTile / 2];
    gemm_f32<kTile, D, true>(Qs, ld, Ks, ld, s);  // S = Q K^T

    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < kTile / 2; ++j) {
      const int c = half * 32 + j;
      const bool ok = qseg_r != 0 && kseg_s[c] == qseg_r &&
                      (!causal || q_pos >= k0 + c);
      s[j] = ok ? __fmul_rn(s[j], scale) : kNegInf;
      mx = fmaxf(mx, s[j]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(~0u, mx, 1));
    const float m_new = fmaxf(m, mx);
    const float corr = expf(m - m_new);
    float sum = 0.f;
    float* prow = Ps + r * kLdP + half * 32;
#pragma unroll
    for (int j = 0; j < kTile / 2; ++j) {
      const int c = half * 32 + j;
      const bool ok = qseg_r != 0 && kseg_s[c] == qseg_r &&
                      (!causal || q_pos >= k0 + c);
      const float p = ok ? expf(s[j] - m_new) : 0.f;
      sum += p;
      prow[j] = p;
    }
    sum += __shfl_xor_sync(~0u, sum, 1);
    l = l * corr + sum;
    m = m_new;
    __syncthreads();
    float pv[D / 2];
    gemm_f32<D, kTile, false>(Ps, kLdP, Vs, ld, pv);  // P V
#pragma unroll
    for (int j = 0; j < D / 2; ++j) acc[j] = acc[j] * corr + pv[j];
    __syncthreads();
  }

  const float l_safe = fmaxf(l, 1e-30f);
  if (q_pos < s_q) {
    if (half == 0) lse[static_cast<size_t>(bh) * s_q + q_pos] = m + logf(l_safe);
    float* orow = out + (static_cast<size_t>(bh) * s_q + q_pos) * D +
                  half * (D / 2);
#pragma unroll
    for (int j = 0; j < D / 2; ++j) orow[j] = acc[j] / l_safe;
  }
}

// ---------------------------------------------------------- f32 B2 ----

template <int D>
constexpr size_t kDqSmemF32 =
    (4 * kTile * kLdF<D> + kTile * kLdP) * sizeof(float) + kTile * sizeof(int);

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        const int* __restrict__ q_seg,
                        const int* __restrict__ k_seg,
                        const int* __restrict__ q_len,
                        const int* __restrict__ k_len, float* __restrict__ dq,
                        int h, int h_kv, int s_q, int s_k, float scale,
                        int causal) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int ld = kLdF<D>;
  float* Qs = reinterpret_cast<float*>(smem);
  float* dOs = Qs + kTile * ld;
  float* Ks = dOs + kTile * ld;
  float* Vs = Ks + kTile * ld;
  float* dSs = Vs + kTile * ld;  // (64, kLdP)
  int* kseg_s = reinterpret_cast<int*>(dSs + kTile * kLdP);

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

  const size_t q_off = (static_cast<size_t>(bh) * s_q + q0) * D;
  load_tile_f32<D>(q + q_off, s_q - q0, Qs);
  load_tile_f32<D>(dout + q_off, s_q - q0, dOs);
  float acc[D / 2];
#pragma unroll
  for (int j = 0; j < D / 2; ++j) acc[j] = 0.f;

  for (int kt = 0; kt < num_k; ++kt) {
    const int k0 = kt * kTile;
    const size_t kv_off = (static_cast<size_t>(kv_row) * s_k + k0) * D;
    load_tile_f32<D>(k + kv_off, s_k - k0, Ks);
    load_tile_f32<D>(v + kv_off, s_k - k0, Vs);
    if (tid < kTile) kseg_s[tid] = k0 + tid < s_k ? k_seg[b * s_k + k0 + tid] : 0;
    __syncthreads();
    float s[kTile / 2], dp[kTile / 2];
    gemm_f32<kTile, D, true>(Qs, ld, Ks, ld, s);     // S = Q K^T
    gemm_f32<kTile, D, true>(dOs, ld, Vs, ld, dp);   // dP = dO V^T
#pragma unroll
    for (int j = 0; j < kTile / 2; ++j) {
      const int c = half * 32 + j;
      const bool ok = qseg_r != 0 && kseg_s[c] == qseg_r &&
                      (!causal || q_pos >= k0 + c);
      const float p = ok ? expf(scaled_minus<D>(s[j], scale, lse_r)) : 0.f;
      dSs[r * kLdP + c] = p * (dp[j] - delta_r);
    }
    __syncthreads();
    float ds_k[D / 2];
    gemm_f32<D, kTile, false>(dSs, kLdP, Ks, ld, ds_k);  // dS K
#pragma unroll
    for (int j = 0; j < D / 2; ++j) acc[j] += ds_k[j];
    __syncthreads();
  }

  if (q_in) {
    float* row = dq + row_off * D + half * (D / 2);
#pragma unroll
    for (int j = 0; j < D / 2; ++j) row[j] = acc[j] * scale;
  }
}

// ---------------------------------------------------------- f32 B3 ----

template <int D>
constexpr size_t kDkvSmemF32 =
    (4 * kTile * kLdF<D> + 2 * kTile * kLdP + 2 * kTile) * sizeof(float) +
    kTile * sizeof(int);

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         const int* __restrict__ q_seg,
                         const int* __restrict__ k_seg,
                         const int* __restrict__ q_len,
                         const int* __restrict__ k_len,
                         float* __restrict__ dk, float* __restrict__ dv, int h,
                         int h_kv, int s_q, int s_k, float scale, int causal) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int ld = kLdF<D>;
  float* Ks = reinterpret_cast<float*>(smem);
  float* Vs = Ks + kTile * ld;
  float* Qs = Vs + kTile * ld;
  float* dOs = Qs + kTile * ld;
  float* Ps = dOs + kTile * ld;    // P^T (64, kLdP)
  float* dSs = Ps + kTile * kLdP;  // dS^T
  float* lse_s = dSs + kTile * kLdP;  // (64,) per query tile
  float* delta_s = lse_s + kTile;
  int* qseg_s = reinterpret_cast<int*>(delta_s + kTile);

  const int bkv = blockIdx.x;
  const int b = bkv / h_kv;
  const int grp = h / h_kv;
  const int k0 = blockIdx.y * kTile;
  const int tid = threadIdx.x;
  // In transposed space: key row r, query columns 32 * half .. +32, and
  // dK/dV columns D / 2 * half ..
  const int r = tid >> 1;
  const int half = tid & 1;
  const int k_pos = k0 + r;
  const int kseg_r = k_pos < s_k ? k_seg[b * s_k + k_pos] : 0;

  const int first_q = causal ? k0 / kTile : 0;
  int last_q = min(cdiv(s_q, kTile), cdiv(q_len[b], kTile));
  if (blockIdx.y >= cdiv(k_len[b], kTile)) last_q = first_q;

  const size_t kv_off = (static_cast<size_t>(bkv) * s_k + k0) * D;
  load_tile_f32<D>(k + kv_off, s_k - k0, Ks);
  load_tile_f32<D>(v + kv_off, s_k - k0, Vs);
  float dk_sum[D / 2], dv_sum[D / 2];
  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int j = 0; j < D / 2; ++j) dk_sum[j] = dv_sum[j] = 0.f;

  for (int g = 0; g < grp; ++g) {
    // Query head (bkv % h_kv) * grp + g of batch b.
    const int q_row = b * h + (bkv - b * h_kv) * grp + g;
#pragma unroll
    for (int j = 0; j < D / 2; ++j) dk_acc[j] = dv_acc[j] = 0.f;
    for (int qt = first_q; qt < last_q; ++qt) {
      const int q0 = qt * kTile;
      const size_t q_off = (static_cast<size_t>(q_row) * s_q + q0) * D;
      // Every thread is past the previous iteration's last barrier, so the
      // tiles and row vectors below are free to overwrite.
      load_tile_f32<D>(q + q_off, s_q - q0, Qs);
      load_tile_f32<D>(dout + q_off, s_q - q0, dOs);
      if (tid < kTile) {
        const bool in = q0 + tid < s_q;
        const size_t row = static_cast<size_t>(q_row) * s_q + q0 + tid;
        lse_s[tid] = in ? lse[row] : 0.f;
        delta_s[tid] = in ? delta[row] : 0.f;
        qseg_s[tid] = in ? q_seg[b * s_q + q0 + tid] : 0;
      }
      __syncthreads();
      float st[kTile / 2], dpt[kTile / 2];
      gemm_f32<kTile, D, true>(Ks, ld, Qs, ld, st);    // S^T = K Q^T
      gemm_f32<kTile, D, true>(Vs, ld, dOs, ld, dpt);  // dP^T = V dO^T
#pragma unroll
      for (int j = 0; j < kTile / 2; ++j) {
        const int c = half * 32 + j;
        const bool ok = kseg_r != 0 && qseg_s[c] == kseg_r &&
                        (!causal || q0 + c >= k_pos);
        const float p =
            ok ? expf(scaled_minus<D>(st[j], scale, lse_s[c])) : 0.f;
        Ps[r * kLdP + c] = p;
        dSs[r * kLdP + c] = p * (dpt[j] - delta_s[c]);
      }
      __syncthreads();
      float part[D / 2];
      gemm_f32<D, kTile, false>(Ps, kLdP, dOs, ld, part);  // P^T dO
#pragma unroll
      for (int j = 0; j < D / 2; ++j) dv_acc[j] += part[j];
      gemm_f32<D, kTile, false>(dSs, kLdP, Qs, ld, part);  // dS^T Q
#pragma unroll
      for (int j = 0; j < D / 2; ++j) dk_acc[j] += part[j];
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < D / 2; ++j) {
      dk_sum[j] += dk_acc[j] * scale;
      dv_sum[j] += dv_acc[j];
    }
  }

  if (k_pos < s_k) {
    const size_t off = (static_cast<size_t>(bkv) * s_k + k_pos) * D +
                       half * (D / 2);
#pragma unroll
    for (int j = 0; j < D / 2; ++j) {
      dk[off + j] = dk_sum[j];
      dv[off + j] = dv_sum[j];
    }
  }
}

// ------------------------------------------- bf16 tensor-core path ----

using bf16 = __nv_bfloat16;
template <int D>
constexpr int kLdB = D + 8;  // 80, 144 or 272-byte rows (conflict-free ldmatrix)
template <int D>
constexpr int kTileB = kTile * kLdB<D>;  // bf16 elements of one staged tile
constexpr int kStages = 2;               // cp.async ring depth

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

// Rows [0, rows) of a 64 x D head-major tile at src into dst (row stride
// kLdB<D>), asynchronously, by a block of kThr threads; rows past `rows` (a
// ragged last tile) are zero-filled.
template <int D, int kThr>
__device__ __forceinline__ void load_tile_async(const bf16* __restrict__ src,
                                                int rows, bf16* dst) {
  for (int i = threadIdx.x; i < kTile * (D / 8); i += kThr) {
    const int r = i / (D / 8);
    const int c = (i - r * (D / 8)) * 8;
    const bool in = r < rows;
    cp_async16(dst + r * kLdB<D> + c, src + (in ? r * D + c : 0), in);
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

// A fragments of the 16 x D strip at rows [16w, 16w + 16) of a staged
// 64 x D tile (D = 16 kK); a[kk] is its k16 slice kk.
template <int kK>
__device__ __forceinline__ void load_a_strip(uint32_t (&a)[kK][4],
                                             const bf16* tile, int w,
                                             int lane) {
#pragma unroll
  for (int kk = 0; kk < kK; ++kk)
    ldsm_x4(a[kk], tile + (16 * w + (lane & 15)) * kLdB<16 * kK> + 16 * kk +
                       (lane >> 4) * 8);
}

// acc (16 x 8 kNJ) = a (the warp's 16 x D strip, D = 16 kK) * B^T, B's rows
// staged row-major in the 64 x D `tile` (K for S = Q K^T, V for dP = dO V^T;
// Q and dO for S^T and dP^T): acc[j] is the n8 tile of B's rows
// 8 (kJ0 + j)..+7.
template <int kJ0 = 0, int kNJ = 8, int kK>
__device__ __forceinline__ void mma_abt(float (&acc)[kNJ][4],
                                        const uint32_t (&a)[kK][4],
                                        const bf16* tile, int lane) {
  constexpr int ld = kLdB<16 * kK>;
#pragma unroll
  for (int kk = 0; kk < kK; ++kk) {
#pragma unroll
    for (int jp = 0; jp < kNJ / 2; ++jp) {
      uint32_t b[4];
      ldsm_x4(b, tile + (8 * kJ0 + 16 * jp + (lane & 7) +
                         ((lane >> 4) << 3)) * ld +
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

// acc (16 x D, D = 8 kN8) += p (A fragments of kNK k16 slices) * the 64 x D
// tile's staged rows 16 (kK0 + kk)..+15 as the k dimension (V in P V, K in
// dS K; dO and Q in B3).
template <int kK0 = 0, int kNK = 4, int kN8>
__device__ __forceinline__ void mma_ab(float (&acc)[kN8][4],
                                       const uint32_t (&p)[kNK][4],
                                       const bf16* tile, int lane) {
  constexpr int ld = kLdB<8 * kN8>;
#pragma unroll
  for (int kk = 0; kk < kNK; ++kk) {
#pragma unroll
    for (int jp = 0; jp < kN8 / 2; ++jp) {
      uint32_t b[4];
      ldsm_x4_t(b, tile + (16 * (kK0 + kk) + (lane & 15)) * ld + 16 * jp +
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

template <int N>
__device__ __forceinline__ void zero(float (&x)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j) x[j][0] = x[j][1] = x[j][2] = x[j][3] = 0.f;
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
// rescale of the running m, l and o (16 x D), and P packed to A fragments
// in p.
template <bool kMasked, int D>
__device__ __forceinline__ void softmax_tile(
    float (&s)[8][4], float (&o)[D / 8][4], float (&m)[2], float (&l)[2],
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
      float pe = expf(scaled_minus<D>(s[j][e], scale, m[e >> 1]));
      if (kMasked && !((ok >> (4 * j + e)) & 1u)) pe = 0.f;
      s[j][e] = pe;
      sum[e >> 1] += pe;
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r)
    l[r] = __fadd_rn(__fmul_rn(l[r], corr[r]), quad_sum(sum[r]));
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    o[j][0] *= corr[0];
    o[j][1] *= corr[0];
    o[j][2] *= corr[1];
    o[j][3] *= corr[1];
  }
  pack_a(p, s);
}

// ------------------------------------------------------------ bf16 B1 ----

// Smem: the Q tile, then kStages ring slots of a K and a V tile, then
// kStages rows of key segment ids: 26.1, 46.6 or 87.6 KB at d = 32, 64,
// 128.
template <int D>
constexpr size_t kFwdSmem =
    (1 + 2 * kStages) * kTileB<D> * sizeof(bf16) + kStages * kTile * 4;

// At d = 64, 4 blocks an SM (16 warps): at most 128 registers a thread,
// and 4 x 46.6 KB of shared memory; fewer warps measured slower, whatever
// they gained in registers. At d = 128 the output accumulator (64 f32) and
// the Q fragments (32) double, and shared memory allows 2 blocks.
template <int D>
__global__ void __launch_bounds__(kThreads, D == 128 ? 2 : 4)
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
  constexpr int kTB = kTileB<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* ring = Qs + kTB;  // slot st: K tile at ring + 2 st kTB, V after
  int* kseg_ring = reinterpret_cast<int*>(ring + 2 * kStages * kTB);

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
    bf16* Ks = ring + 2 * (kt % kStages) * kTB;
    load_tile_async<D, kThreads>(k + (kv_base + k0) * D, s_k - k0, Ks);
    load_tile_async<D, kThreads>(v + (kv_base + k0) * D, s_k - k0, Ks + kTB);
    load_row_async<kThreads>(kseg_b + k0, s_k - k0,
                             kseg_ring + (kt % kStages) * kTile);
  };
  if (num_k > 0) {
    load_tile_async<D, kThreads>(q + (q_base + q0) * D, s_q - q0, Qs);
    load_kv(0);
  }
  cp_async_commit();
#pragma unroll
  for (int i = 1; i < kStages - 1; ++i) {
    if (i < num_k) load_kv(i);
    cp_async_commit();
  }

  float o[D / 8][4], m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  zero(o);
  uint32_t qf[D / 16][4];
  for (int kt = 0; kt < num_k; ++kt) {
    // Tile kt has landed, and every warp is done with the slot that tile
    // kt + kStages - 1 overwrites.
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (kt == 0) load_a_strip(qf, Qs, warp, lane);
    if (kt + kStages - 1 < num_k) load_kv(kt + kStages - 1);
    cp_async_commit();

    const int k0 = kt * kTile;
    const bf16* Ks = ring + 2 * (kt % kStages) * kTB;
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
      softmax_tile<true, D>(s, o, m, l, p, ks, row, qseg, k0, t, scale,
                            causal);
    else
      softmax_tile<false, D>(s, o, m, l, p, ks, row, qseg, k0, t, scale,
                             causal);
    mma_ab(o, p, Ks + kTB, lane);  // o += P V
  }

  float l_safe[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_safe[r] = fmaxf(l[r], 1e-30f);
    if (t == 0 && row[r] < s_q) lse[q_base + row[r]] = m[r] + logf(l_safe[r]);
  }
  // The warp's 16 output rows go through its own rows of Qs (which only
  // this warp read, at kt = 0), then out in 16-byte stores.
  bf16* Os = Qs + 16 * warp * kLdB<D>;
  const int g = lane >> 2;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    *reinterpret_cast<uint32_t*>(Os + g * kLdB<D> + 8 * j + 2 * t) =
        pack_bf16(o[j][0] / l_safe[0], o[j][1] / l_safe[0]);
    *reinterpret_cast<uint32_t*>(Os + (g + 8) * kLdB<D> + 8 * j + 2 * t) =
        pack_bf16(o[j][2] / l_safe[1], o[j][3] / l_safe[1]);
  }
  __syncwarp();
#pragma unroll
  for (int i = lane; i < 16 * (D / 8); i += 32) {
    const int r = i / (D / 8);
    const int c = (i - r * (D / 8)) * 8;
    if (w0 + r < s_q)
      *reinterpret_cast<uint4*>(out + (q_base + w0 + r) * D + c) =
          *reinterpret_cast<const uint4*>(Os + r * kLdB<D> + c);
  }
}

// ------------------------------------------------------------ bf16 B2 ----

// Smem: kStages ring slots of a K and a V tile, then kStages rows of key
// segment ids: 21.0, 37.4 or 70.1 KB at d = 32, 64, 128. Q and dO pass
// through the last slot before the loop.
template <int D>
constexpr size_t kDqSmem =
    2 * kStages * kTileB<D> * sizeof(bf16) + kStages * kTile * 4;

// Q and dO fragments and the dQ accumulator stay in registers for the
// whole loop: 64 registers at d = 64, 128 at d = 128. At d = 64, 3 blocks
// an SM (at most 168 registers, no spills); held to 4 blocks (128
// registers) it spilled and measured 5% slower (NVIDIA H100 80GB HBM3,
// 700 W). 2 blocks at d = 128.
template <int D>
__global__ void __launch_bounds__(kThreads, D == 128 ? 2 : (D == 64 ? 3 : 4))
    flash_bwd_dq_bf16_kernel(const bf16* __restrict__ q,
                             const bf16* __restrict__ k,
                             const bf16* __restrict__ v,
                             const bf16* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             const int* __restrict__ q_seg,
                             const int* __restrict__ k_seg,
                             const int* __restrict__ q_len,
                             const int* __restrict__ k_len,
                             bf16* __restrict__ dq, int h, int h_kv, int s_q,
                             int s_k, float scale, int causal) {
  constexpr int kTB = kTileB<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);  // slot st: K, then V
  int* kseg_ring = reinterpret_cast<int*>(ring + 2 * kStages * kTB);

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
  const size_t q_base = static_cast<size_t>(bh) * s_q;
  int qseg[2];
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool in = row[r] < s_q;
    qseg[r] = in ? qseg_b[row[r]] : 0;
    lse_r[r] = in ? lse[q_base + row[r]] : 0.f;
    delta_r[r] = in ? delta[q_base + row[r]] : 0.f;
  }
  int wseg;
  const bool w_uniform = uniform_rows(qseg_b, w0, s_q, lane, &wseg);

  const int n_k = cdiv(s_k, kTile);
  int num_k = causal ? min(cdiv(q0 + kTile, kTile), n_k) : n_k;
  num_k = min(num_k, cdiv(k_len[b], kTile));
  if (q0 >= q_len[b]) num_k = 0;

  const size_t kv_base = static_cast<size_t>(kv_row) * s_k;
  const int* kseg_b = k_seg + static_cast<size_t>(b) * s_k;
  auto load_kv = [&](int kt) {
    const int k0 = kt * kTile;
    bf16* Ks = ring + 2 * (kt % kStages) * kTB;
    load_tile_async<D, kThreads>(k + (kv_base + k0) * D, s_k - k0, Ks);
    load_tile_async<D, kThreads>(v + (kv_base + k0) * D, s_k - k0, Ks + kTB);
    load_row_async<kThreads>(kseg_b + k0, s_k - k0,
                             kseg_ring + (kt % kStages) * kTile);
  };

  float acc[D / 8][4];
  zero(acc);
  uint32_t qf[D / 16][4], dof[D / 16][4];
  if (num_k > 0) {
    // Q and dO pass through the last ring slot, which the first tile to
    // reach it (kt = kStages - 1) overwrites only after the loop's first
    // barrier.
    bf16* Qs = ring + 2 * (kStages - 1) * kTB;
    load_tile_async<D, kThreads>(q + (q_base + q0) * D, s_q - q0, Qs);
    load_tile_async<D, kThreads>(dout + (q_base + q0) * D, s_q - q0,
                                 Qs + kTB);
    cp_async_commit();
#pragma unroll
    for (int i = 0; i < kStages - 1; ++i) {
      if (i < num_k) load_kv(i);
      cp_async_commit();
    }
    cp_async_wait<kStages - 1>();
    __syncthreads();
    load_a_strip(qf, Qs, warp, lane);
    load_a_strip(dof, Qs + kTB, warp, lane);
  }

  for (int kt = 0; kt < num_k; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (kt + kStages - 1 < num_k) load_kv(kt + kStages - 1);
    cp_async_commit();

    const int k0 = kt * kTile;
    const bf16* Ks = ring + 2 * (kt % kStages) * kTB;
    const bf16* Vs = Ks + kTB;
    const int* ks = kseg_ring + (kt % kStages) * kTile;
    bool masked = !w_uniform || (causal && k0 + kTile - 1 > w0);
    if (!masked)
      masked = !__all_sync(~0u, ks[lane] == wseg && ks[lane + 32] == wseg);
    // The 64 keys in two halves of 32, so that S and dP of one half (32
    // registers) are live at a time.
    auto half = [&](auto half_c) {
      constexpr int H = decltype(half_c)::value;
      float s[4][4], dp[4][4];  // S and dP: 16 queries x 32 keys
      mma_abt<4 * H, 4>(s, qf, Ks, lane);   // S = Q K^T
      mma_abt<4 * H, 4>(dp, dof, Vs, lane);  // dP = dO V^T
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c0 = 32 * H + 8 * j + 2 * t;  // key column in the tile
        int2 kseg2 = make_int2(0, 0);
        if (masked) kseg2 = *reinterpret_cast<const int2*>(ks + c0);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int odd = e & 1;
          const int r = e >> 1;
          // P = exp(scale S - lse); dS = P (dP - delta).
          float p = expf(scaled_minus<D>(s[j][e], scale, lse_r[r]));
          if (masked) {
            const bool vis = qseg[r] != 0 &&
                             (odd ? kseg2.y : kseg2.x) == qseg[r] &&
                             (!causal || row[r] >= k0 + c0 + odd);
            if (!vis) p = 0.f;
          }
          dp[j][e] = p * (dp[j][e] - delta_r[r]);
        }
      }
      uint32_t dsf[2][4];
      pack_a(dsf, dp);
      mma_ab<2 * H, 2>(acc, dsf, Ks, lane);  // dQ += dS K
    };
    half(std::integral_constant<int, 0>());
    half(std::integral_constant<int, 1>());
  }

  // dQ = scale * acc, rounded once; each thread's two rows, 4 bytes a
  // column pair.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= s_q) continue;
    bf16* dst = dq + (q_base + row[r]) * D + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(dst + 8 * j) =
          pack_bf16(acc[j][2 * r] * scale, acc[j][2 * r + 1] * scale);
  }
}

// ------------------------------------------------------------ bf16 B3 ----

// A ring slot of B3: the Q and dO tiles, then the lse, delta and segment
// rows of the same 64 queries.
template <int D>
constexpr size_t kDkvSlot = 2 * kTileB<D> * sizeof(bf16) + 3 * kTile * 4;

// K and V fragments held in registers for the whole loop (d <= 64), or
// read from their own region of shared memory for each product (d = 128).
template <int D>
constexpr bool kKVInRegs = D <= 64;

template <int D>
constexpr size_t kDkvSmem =
    kStages * kDkvSlot<D> +
    (kKVInRegs<D> ? 0 : 2 * kTileB<D> * sizeof(bf16));

// At d = 64, 3 blocks an SM (12 warps): at most 168 registers a thread, of
// which the K and V fragments and the dK, dV accumulators hold 96 (the
// queries of a tile go in two halves, so one half's S^T and dP^T, 32
// registers, are live at a time; the whole tile at once took 224
// registers and 2 blocks, and measured 17% slower); 3 x 38.4 KB of shared
// memory. At d = 128 the accumulators alone hold 128 (2 blocks).
template <int D>
__global__ void __launch_bounds__(kThreads, D == 128 ? 2 : (D == 64 ? 3 : 4))
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
  constexpr int kTB = kTileB<D>;
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
    return reinterpret_cast<bf16*>(smem + (it % kStages) * kDkvSlot<D>);
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
    float* rows = reinterpret_cast<float*>(Qs + 2 * kTB);
    load_tile_async<D, kThreads>(q + row0 * D, s_q - q0, Qs);
    load_tile_async<D, kThreads>(dout + row0 * D, s_q - q0, Qs + kTB);
    load_row_async<kThreads>(lse + row0, s_q - q0, rows);
    load_row_async<kThreads>(delta + row0, s_q - q0, rows + kTile);
    load_row_async<kThreads>(q_seg + static_cast<size_t>(b) * s_q + q0,
                             s_q - q0, rows + 2 * kTile);
  };

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
  zero(dk_acc);
  zero(dv_acc);
  uint32_t kf[D / 16][4], vf[D / 16][4];
  // K and V pass through the last ring slot, which the first tile to reach
  // it (it = kStages - 1) overwrites only after the loop's first barrier;
  // at d = 128 they stay in their own region after the ring.
  bf16* KVs = kKVInRegs<D> ? slot(kStages - 1)
                           : reinterpret_cast<bf16*>(smem +
                                                     kStages * kDkvSlot<D>);
  if (n_it > 0) {
    const size_t kv_off = (static_cast<size_t>(bkv) * s_k + k0) * D;
    load_tile_async<D, kThreads>(k + kv_off, s_k - k0, KVs);
    load_tile_async<D, kThreads>(v + kv_off, s_k - k0, KVs + kTB);
    cp_async_commit();
#pragma unroll
    for (int i = 0; i < kStages - 1; ++i) {
      if (i < n_it) load_q(i);
      cp_async_commit();
    }
    cp_async_wait<kStages - 1>();
    __syncthreads();
    if constexpr (kKVInRegs<D>) {
      load_a_strip(kf, KVs, warp, lane);
      load_a_strip(vf, KVs + kTB, warp, lane);
    }
  }

  for (int it = 0; it < n_it; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (it + kStages - 1 < n_it) load_q(it + kStages - 1);
    cp_async_commit();

    int q_row;
    const int q0 = tile_of(it, &q_row);
    const bf16* Qs = slot(it);
    const bf16* dOs = Qs + kTB;
    const float* lse_s = reinterpret_cast<const float*>(Qs + 2 * kTB);
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
      if constexpr (!kKVInRegs<D>) load_a_strip(kf, KVs, warp, lane);
      mma_abt<4 * H, 4>(st, kf, Qs, lane);    // S^T = K Q^T
      if constexpr (!kKVInRegs<D>) load_a_strip(vf, KVs + kTB, warp, lane);
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
          // P^T = exp(scale S^T - lse); dS^T = P^T (dP^T - delta).
          float p = expf(scaled_minus<D>(st[j][e], scale,
                                         odd ? lse2.y : lse2.x));
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
    const size_t off = (static_cast<size_t>(bkv) * s_k + krow[r]) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int c = 8 * j + 2 * t;
      *reinterpret_cast<float2*>(dk + off + c) = make_float2(
          dk_acc[j][2 * r] * scale, dk_acc[j][2 * r + 1] * scale);
      *reinterpret_cast<float2*>(dv + off + c) =
          make_float2(dv_acc[j][2 * r], dv_acc[j][2 * r + 1]);
    }
  }
}

// ------------------------------------------------------------ launches ----

// Shared memory above 48 KB needs the kernel's opt-in; every instance stays
// under the H100's 227 KB a block (the largest, f32 B3 at d = 128, takes
// 170.8 KB).
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

// Launches `kernel` on grid x kThreads with `smem` bytes, after the opt-in.
template <typename Kernel, typename... Args>
int launch(Kernel kernel, dim3 grid, size_t smem, cudaStream_t stream,
           Args... args) {
  if (int err = prepare(kernel, smem)) return err;
  kernel<<<grid, kThreads, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

int check_dims(int b, int h, int h_kv, int s_q, int s_k, int dtype) {
  if (h_kv <= 0 || h % h_kv || b < 0 || s_q < 0 || s_k < 0 ||
      (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

template <int D>
int fwd(const void* q, const void* k, const void* v, const void* q_seg,
        const void* k_seg, const void* q_len, const void* k_len, void* out,
        void* lse, int b, int h, int h_kv, int s_q, int s_k, float scale,
        int causal, int dtype, cudaStream_t stream) {
  const dim3 grid(b * h, cdiv(s_q, kTile));
  const auto* qs = static_cast<const int*>(q_seg);
  const auto* ks = static_cast<const int*>(k_seg);
  const auto* ql = static_cast<const int*>(q_len);
  const auto* kl = static_cast<const int*>(k_len);
  if (dtype == 1)
    return launch(flash_fwd_bf16_kernel<D>, grid, kFwdSmem<D>, stream,
                  static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                  static_cast<const bf16*>(v), qs, ks, ql, kl,
                  static_cast<bf16*>(out), static_cast<float*>(lse), h, h_kv,
                  s_q, s_k, scale, causal);
  return launch(flash_fwd_kernel<D>, grid, kFwdSmemF32<D>, stream,
                static_cast<const float*>(q), static_cast<const float*>(k),
                static_cast<const float*>(v), qs, ks, ql, kl,
                static_cast<float*>(out), static_cast<float*>(lse), h, h_kv,
                s_q, s_k, scale, causal);
}

template <int D>
int bwd_dq(const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* delta, const void* q_seg,
           const void* k_seg, const void* q_len, const void* k_len, void* dq,
           int b, int h, int h_kv, int s_q, int s_k, float scale, int causal,
           int dtype, cudaStream_t stream) {
  const dim3 grid(b * h, cdiv(s_q, kTile));
  const auto* ls = static_cast<const float*>(lse);
  const auto* dl = static_cast<const float*>(delta);
  const auto* qs = static_cast<const int*>(q_seg);
  const auto* ks = static_cast<const int*>(k_seg);
  const auto* ql = static_cast<const int*>(q_len);
  const auto* kl = static_cast<const int*>(k_len);
  if (dtype == 1)
    return launch(flash_bwd_dq_bf16_kernel<D>, grid, kDqSmem<D>, stream,
                  static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                  static_cast<const bf16*>(v),
                  static_cast<const bf16*>(dout), ls, dl, qs, ks, ql, kl,
                  static_cast<bf16*>(dq), h, h_kv, s_q, s_k, scale, causal);
  return launch(flash_bwd_dq_kernel<D>, grid, kDqSmemF32<D>, stream,
                static_cast<const float*>(q), static_cast<const float*>(k),
                static_cast<const float*>(v),
                static_cast<const float*>(dout), ls, dl, qs, ks, ql, kl,
                static_cast<float*>(dq), h, h_kv, s_q, s_k, scale, causal);
}

template <int D>
int bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
            const void* lse, const void* delta, const void* q_seg,
            const void* k_seg, const void* q_len, const void* k_len, void* dk,
            void* dv, int b, int h, int h_kv, int s_q, int s_k, float scale,
            int causal, int dtype, cudaStream_t stream) {
  const dim3 grid(b * h_kv, cdiv(s_k, kTile));
  const auto* ls = static_cast<const float*>(lse);
  const auto* dl = static_cast<const float*>(delta);
  const auto* qs = static_cast<const int*>(q_seg);
  const auto* ks = static_cast<const int*>(k_seg);
  const auto* ql = static_cast<const int*>(q_len);
  const auto* kl = static_cast<const int*>(k_len);
  if (dtype == 1)
    return launch(flash_bwd_dkv_bf16_kernel<D>, grid, kDkvSmem<D>, stream,
                  static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                  static_cast<const bf16*>(v),
                  static_cast<const bf16*>(dout), ls, dl, qs, ks, ql, kl,
                  static_cast<float*>(dk), static_cast<float*>(dv), h, h_kv,
                  s_q, s_k, scale, causal);
  return launch(flash_bwd_dkv_kernel<D>, grid, kDkvSmemF32<D>, stream,
                static_cast<const float*>(q), static_cast<const float*>(k),
                static_cast<const float*>(v),
                static_cast<const float*>(dout), ls, dl, qs, ks, ql, kl,
                static_cast<float*>(dk), static_cast<float*>(dv), h, h_kv,
                s_q, s_k, scale, causal);
}

}  // namespace

// Pointers: q, out, dq, dout (b, h, s_q, d) and k, v (b, h_kv, s_k, d),
// contiguous, in the dtype (0 = f32, 1 = bf16); lse, delta (b, h, s_q) f32;
// dk, dv (b, h_kv, s_k, d) f32; q_seg (b, s_q) and k_seg (b, s_k) int32
// with 0 = padding; q_len, k_len (b,) int32, the tokens through each row's
// last non-padding one. d is 32, 64 or 128. Each returns
// cudaGetLastError() after its launch (0 = launched), or
// cudaErrorInvalidValue for arguments no instance takes.

extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         const void* q_seg, const void* k_seg,
                         const void* q_len, const void* k_len, void* out,
                         void* lse, int b, int h, int h_kv, int s_q, int s_k,
                         int d, float scale, int causal, int dtype,
                         void* stream) {
  if (int err = check_dims(b, h, h_kv, s_q, s_k, dtype)) return err;
  if (b == 0 || s_q == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32: return fwd<32>(q, k, v, q_seg, k_seg, q_len, k_len, out, lse, b,
                            h, h_kv, s_q, s_k, scale, causal, dtype, s);
    case 64: return fwd<64>(q, k, v, q_seg, k_seg, q_len, k_len, out, lse, b,
                            h, h_kv, s_q, s_k, scale, causal, dtype, s);
    case 128: return fwd<128>(q, k, v, q_seg, k_seg, q_len, k_len, out, lse,
                              b, h, h_kv, s_q, s_k, scale, causal, dtype, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, const void* q_seg,
                            const void* k_seg, const void* q_len,
                            const void* k_len, void* dq, int b, int h,
                            int h_kv, int s_q, int s_k, int d, float scale,
                            int causal, int dtype, void* stream) {
  if (int err = check_dims(b, h, h_kv, s_q, s_k, dtype)) return err;
  if (b == 0 || s_q == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32: return bwd_dq<32>(q, k, v, dout, lse, delta, q_seg, k_seg, q_len,
                               k_len, dq, b, h, h_kv, s_q, s_k, scale, causal,
                               dtype, s);
    case 64: return bwd_dq<64>(q, k, v, dout, lse, delta, q_seg, k_seg, q_len,
                               k_len, dq, b, h, h_kv, s_q, s_k, scale, causal,
                               dtype, s);
    case 128: return bwd_dq<128>(q, k, v, dout, lse, delta, q_seg, k_seg,
                                 q_len, k_len, dq, b, h, h_kv, s_q, s_k,
                                 scale, causal, dtype, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, const void* q_seg,
                             const void* k_seg, const void* q_len,
                             const void* k_len, void* dk, void* dv, int b,
                             int h, int h_kv, int s_q, int s_k, int d,
                             float scale, int causal, int dtype,
                             void* stream) {
  if (int err = check_dims(b, h, h_kv, s_q, s_k, dtype)) return err;
  if (b == 0 || s_k == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32: return bwd_dkv<32>(q, k, v, dout, lse, delta, q_seg, k_seg,
                                q_len, k_len, dk, dv, b, h, h_kv, s_q, s_k,
                                scale, causal, dtype, s);
    case 64: return bwd_dkv<64>(q, k, v, dout, lse, delta, q_seg, k_seg,
                                q_len, k_len, dk, dv, b, h, h_kv, s_q, s_k,
                                scale, causal, dtype, s);
    case 128: return bwd_dkv<128>(q, k, v, dout, lse, delta, q_seg, k_seg,
                                  q_len, k_len, dk, dv, b, h, h_kv, s_q, s_k,
                                  scale, causal, dtype, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
