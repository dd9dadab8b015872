// Paged-attention decode step for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_paged_decode_kernel`
// (tensorflowonspark_tpu/ops/paged_attention.py:65, launched by
// `paged_attention` at :143): single-token decode attention in which each
// batch row walks its own page table over a shared K/V pool, with int8
// pages dequantized in registers from per-token, per-KV-head f32 scales.
//
// Bound. The step reads each row's visible K/V (plus scales when the pool
// is int8), q and the table, and writes out: a few FLOPs per byte, so the
// card's memory rate bounds it, never its arithmetic.
//
// Design. One thread block per (row, KV head); a loop inside the block
// walks the row's pages 0 .. seq_len / page_size, taking the place of the
// TPU's sequential chunk grid, and loads its page id itself (no scalar
// prefetch). The reps = h / h_kv query heads of the group share every K/V
// page read, so no widened K/V exists anywhere. Each page's K and then V
// slice for the block's KV head is staged once in shared memory (16-byte
// loads when the head width allows, f32 rows padded by one word so the
// per-token dot products read without bank conflicts). Pages past the
// row's extent are never read. This first version keeps one page in
// flight per block; overlapping the next page's load with this page's
// math is the obvious next step.
//
// Numerics mirror the Pallas kernel op for op (paged_attention.py:91-140):
// scores accumulate in f32, round to the model dtype, upcast, times
// scale; positions k_pos <= seq_len are visible (the step wrote its own
// token first), masked scores are -1e30 and masked p an explicit 0; the
// online-softmax update runs once per page; p is cast to the value dtype
// and the page's PV partial, accumulated in f32, rounds to the value dtype
// before it joins the f32 accumulator; out = acc / max(l, 1e-30) in q's
// dtype. An int8 element dequantizes as (float(x) * scale) cast to q's
// dtype. Page ids outside the pool clamp into it, as XLA's gather clamps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;

// Rounding through the model dtype T, as the JAX reference's dtype casts.
template <typename T>
struct Num;

template <>
struct Num<float> {
  __device__ static float load(float x) { return x; }
  __device__ static float round(float x) { return x; }
  __device__ static float store(float x) { return x; }
};

template <>
struct Num<__nv_bfloat16> {
  __device__ static float load(__nv_bfloat16 x) { return __bfloat162float(x); }
  __device__ static float round(float x) {
    return __bfloat162float(__float2bfloat16(x));
  }
  __device__ static __nv_bfloat16 store(float x) { return __float2bfloat16(x); }
};

template <typename T, bool QUANT>
struct Storage {
  using type = T;
};

template <typename T>
struct Storage<T, true> {
  using type = int8_t;
};

template <typename T, bool QUANT>
__device__ __forceinline__ float element(typename Storage<T, QUANT>::type x,
                                         float s) {
  if constexpr (QUANT) {
    return Num<T>::round(static_cast<float>(x) * s);
  } else {
    return Num<T>::load(x);
  }
}

// Stage page rows [row0, row0 + ps) of KV head g as f32 into dst (row
// stride dp), in the values the compute dtype holds.
template <typename T, bool QUANT>
__device__ void stage_page(const typename Storage<T, QUANT>::type* pages,
                           const float* scales, size_t row0, int g, int h_kv,
                           int d, int ps, float* dst, int dp) {
  using KV = typename Storage<T, QUANT>::type;
  constexpr int kVec = 16 / sizeof(KV);
  if (d % kVec == 0) {
    const int per_row = d / kVec;
    for (int i = threadIdx.x; i < ps * per_row; i += kThreads) {
      const int t = i / per_row;
      const int e0 = (i - t * per_row) * kVec;
      const size_t tok = row0 + t;
      const uint4 raw = *reinterpret_cast<const uint4*>(
          pages + (tok * h_kv + g) * d + e0);
      const KV* vals = reinterpret_cast<const KV*>(&raw);
      const float s = QUANT ? scales[tok * h_kv + g] : 1.f;
      float* out = dst + t * dp + e0;
#pragma unroll
      for (int u = 0; u < kVec; ++u) out[u] = element<T, QUANT>(vals[u], s);
    }
  } else {
    for (int i = threadIdx.x; i < ps * d; i += kThreads) {
      const int t = i / d;
      const int e = i - t * d;
      const size_t tok = row0 + t;
      const float s = QUANT ? scales[tok * h_kv + g] : 1.f;
      dst[t * dp + e] = element<T, QUANT>(pages[(tok * h_kv + g) * d + e], s);
    }
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(~0u, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(~0u, x, o);
  return x;
}

template <typename T, bool QUANT>
__global__ void __launch_bounds__(kThreads)
    paged_decode_kernel(const T* __restrict__ q,
                        const typename Storage<T, QUANT>::type* __restrict__ k_pages,
                        const typename Storage<T, QUANT>::type* __restrict__ v_pages,
                        const float* __restrict__ k_scales,
                        const float* __restrict__ v_scales,
                        const int* __restrict__ page_table,
                        const int* __restrict__ seq_lens, T* __restrict__ out,
                        int h, int h_kv, int d, int ps, int tw, int num_pages,
                        float scale) {
  const int r = blockIdx.x / h_kv;
  const int g = blockIdx.x - r * h_kv;
  const int reps = h / h_kv;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int dp = d + 1;

  extern __shared__ float smem[];
  float* kv_s = smem;                 // (ps, dp)   staged K, then V
  float* p_s = kv_s + ps * dp;        // (reps, ps) scores, then p
  float* q_s = p_s + reps * ps;       // (reps, d)
  float* acc_s = q_s + reps * d;      // (reps, d)
  float* m_s = acc_s + reps * d;      // (reps,)
  float* l_s = m_s + reps;            // (reps,)
  float* corr_s = l_s + reps;         // (reps,)

  // Query heads g*reps .. g*reps+reps-1 share KV head g (the JAX
  // reshape(h_kv, reps, d) grouping).
  const size_t q_off = (static_cast<size_t>(r) * h + g * reps) * d;
  for (int i = tid; i < reps * d; i += kThreads) {
    q_s[i] = Num<T>::load(q[q_off + i]);
    acc_s[i] = 0.f;
  }
  for (int j = tid; j < reps; j += kThreads) {
    m_s[j] = kNegInf;
    l_s[j] = 0.f;
  }
  const int seq_len = seq_lens[r];
  int n_chunks = seq_len / ps + 1;
  if (n_chunks > tw) n_chunks = tw;
  __syncthreads();

  for (int c = 0; c < n_chunks; ++c) {
    int page = page_table[r * tw + c];
    page = page < 0 ? 0 : (page >= num_pages ? num_pages - 1 : page);
    const size_t row0 = static_cast<size_t>(page) * ps;
    const int base = c * ps;

    stage_page<T, QUANT>(k_pages, k_scales, row0, g, h_kv, d, ps, kv_s, dp);
    __syncthreads();
    for (int t = tid; t < ps; t += kThreads) {
      const float* krow = kv_s + t * dp;
      const bool visible = base + t <= seq_len;
      for (int j = 0; j < reps; ++j) {
        const float* qj = q_s + j * d;
        float dot = 0.f;
        for (int e = 0; e < d; ++e) dot = fmaf(qj[e], krow[e], dot);
        p_s[j * ps + t] = visible ? Num<T>::round(dot) * scale : kNegInf;
      }
    }
    __syncthreads();

    // Once-per-page online-softmax update, one warp per query head.
    for (int j = warp; j < reps; j += kThreads / 32) {
      float* pj = p_s + j * ps;
      float mx = kNegInf;
      for (int t = lane; t < ps; t += 32) mx = fmaxf(mx, pj[t]);
      mx = warp_max(mx);
      const float m_prev = m_s[j];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int t = lane; t < ps; t += 32) {
        const float p = base + t <= seq_len ? expf(pj[t] - m_new) : 0.f;
        pj[t] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        corr_s[j] = corr;
        l_s[j] = l_s[j] * corr + sum;
        m_s[j] = m_new;
      }
    }
    // V replaces K in the staging buffer: every K read is behind the
    // barrier above, and the stage touches neither p_s nor the stats.
    stage_page<T, QUANT>(v_pages, v_scales, row0, g, h_kv, d, ps, kv_s, dp);
    __syncthreads();

    for (int i = tid; i < reps * d; i += kThreads) {
      const int j = i / d;
      const int e = i - j * d;
      const float* pj = p_s + j * ps;
      float pv = 0.f;
      for (int t = 0; t < ps; ++t)
        pv = fmaf(Num<T>::round(pj[t]), kv_s[t * dp + e], pv);
      acc_s[i] = acc_s[i] * corr_s[j] + Num<T>::round(pv);
    }
    __syncthreads();
  }

  for (int i = tid; i < reps * d; i += kThreads) {
    const int j = i / d;
    out[q_off + i] = Num<T>::store(acc_s[i] / fmaxf(l_s[j], 1e-30f));
  }
}

template <typename T, bool QUANT>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* k_scales, const void* v_scales, const void* page_table,
           const void* seq_lens, void* out, int b, int h, int h_kv, int d,
           int ps, int tw, int num_pages, float scale, cudaStream_t stream) {
  using KV = typename Storage<T, QUANT>::type;
  const int reps = h / h_kv;
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(ps) * (d + 1) +
                       static_cast<size_t>(reps) * ps +
                       2 * static_cast<size_t>(reps) * d + 3 * reps);
  auto kernel = paged_decode_kernel<T, QUANT>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<b * h_kv, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const KV*>(k_pages),
      static_cast<const KV*>(v_pages), static_cast<const float*>(k_scales),
      static_cast<const float*>(v_scales), static_cast<const int*>(page_table),
      static_cast<const int*>(seq_lens), static_cast<T*>(out), h, h_kv, d, ps,
      tw, num_pages, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = f32, 1 = bf16 (q, out, and the pages unless quant);
// quant: 1 = int8 pages with f32 scales. Returns cudaGetLastError() after
// the launch (0 = launched).
extern "C" int paged_decode(const void* q, const void* k_pages,
                            const void* v_pages, const void* k_scales,
                            const void* v_scales, const void* page_table,
                            const void* seq_lens, void* out, int b, int h,
                            int h_kv, int d, int page_size, int table_width,
                            int num_pages, float scale, int dtype, int quant,
                            void* stream) {
  if (b == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && !quant)
    return launch<float, false>(q, k_pages, v_pages, k_scales, v_scales,
                                page_table, seq_lens, out, b, h, h_kv, d,
                                page_size, table_width, num_pages, scale, s);
  if (dtype == 0 && quant)
    return launch<float, true>(q, k_pages, v_pages, k_scales, v_scales,
                               page_table, seq_lens, out, b, h, h_kv, d,
                               page_size, table_width, num_pages, scale, s);
  if (dtype == 1 && !quant)
    return launch<__nv_bfloat16, false>(q, k_pages, v_pages, k_scales,
                                        v_scales, page_table, seq_lens, out,
                                        b, h, h_kv, d, page_size, table_width,
                                        num_pages, scale, s);
  if (dtype == 1 && quant)
    return launch<__nv_bfloat16, true>(q, k_pages, v_pages, k_scales,
                                       v_scales, page_table, seq_lens, out, b,
                                       h, h_kv, d, page_size, table_width,
                                       num_pages, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
