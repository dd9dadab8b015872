// Paged-attention decode step for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_paged_decode_kernel`
// (tensorflowonspark_tpu/ops/paged_attention.py:65, launched by
// `paged_attention` at :143): single-token decode attention in which each
// batch row walks its own page table over a shared K/V pool, with int8
// pages dequantized in registers from per-token, per-KV-head f32 scales.
//
// Bound. The step reads each row's visible K/V pages (plus scales when the
// pool is int8), q and the table, and writes out: a few FLOPs per byte, so
// the card's memory rate bounds it (bytes), never its arithmetic. At 8 rows
// of GPT-2-small width that is ~14 MB, 4 us at 3.35 TB/s; it is reached
// only with most of the card's SMs loading at once.
//
// What the first design lacked. One block per (row, KV head) walked the
// row's pages one after another (96 blocks at 8 rows x 12 heads, on 132
// SMs), the longest row set the time, and within a page the K stage, the
// scores, the softmax (one warp a query head) and the V stage ran one
// after another with nothing in flight: 5% of the memory rate.
//
// Design. One block per (row, KV head, page): b * h_kv * table_width
// blocks, all independent until the end. A block's (row, KV head) comes
// from its index and its page from that pair's atomic ticket (pages in
// order), so it can only ever wait on a block that is already running; a
// page past its row's extent returns at once. It issues all of its page's
// K and V loads up front (16-byte cp.async, one token's row of the KV head
// contiguous; an int8 load carries 16 values, the token's scale loaded
// beside them), so V lands under the scores and the softmax. The QK and PV
// products spread over all four warps: a group of G lanes shares a token's
// row (G = the row's chunks of 16 bytes, 8 for int8, at most 32), each
// lane a chunk, the query heads of a GQA group sharing every K/V read; PV
// partials are summed over the token groups by shuffles, then over the
// warps in a fixed order. Pages too large for the shared-memory budget are
// walked in token tiles by the same block (then without the V prefetch).
//
// Exactness. The sequential walk's state after page c depends on earlier
// pages only through the running max m_c = max(m_{c-1}, max_t s_{c,t}),
// and page c's p = exp(s - m_c), its row sum and its rounded PV partial
// depend only on page c and m_c. So each block publishes its page maximum
// (a flagged 64-bit word), takes m_c as the max over its own and the
// earlier pages' words (a look-back: exact in any order), and computes its
// p, sum and rounded pv_c against m_c. The last block of a (row, KV head)
// to finish (an atomic count after a __threadfence) runs the walk's
// sequential combine over the row's pages: corr_c = exp(m_{c-1} - m_c),
// l = l * corr_c + sum_c, acc = acc * corr_c + pv_c, each product and sum
// rounded on its own. The usual split-KV (each split's own local max,
// rescaled at the combine) would round p and pv_c elsewhere and differ
// from the walk in a quarter of the bf16 outputs. Sums inside a page run
// in a fixed order (shuffle trees, warps in turn), so two calls give equal
// bits; an atomic decides only which block combines. That block puts the
// counters and flags back to zero, so no memset runs between calls.
//
// Device kernels a call: one. Host side: one scratch allocation (m_c,
// sums and pv_c, f32) and a persistent, zero-initialised state buffer of
// 64-bit words (per-(row, KV head) tickets and counts, page-maximum
// flags).
//
// Numerics mirror the Pallas kernel op for op (paged_attention.py:91-140):
// scores accumulate in f32, round to the model dtype, upcast, times scale
// (its own rounding: __fmul_rn); positions k_pos <= seq_len are visible
// (the step wrote its own token first), masked scores are -1e30 and masked
// p an explicit 0; p = expf(s - m) with the subtraction rounded on its own
// (__fsub_rn: nvcc would contract s * scale - m into one FMA); p is cast to
// the value dtype and the page's PV partial, accumulated in f32, rounds to
// the value dtype before it joins the f32 accumulator; out = acc / max(l,
// 1e-30) in q's dtype. An int8 element dequantizes as (float(x) * scale)
// cast to q's dtype. Page ids outside the pool clamp into it, as XLA's
// gather clamps. Pages past a row's extent are never read.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
// Query heads that share one pass over a page: 1 for MHA, else 4.
constexpr int kRepBatch = 4;
constexpr float kNegInf = -1e30f;
// Shared bytes past which a page is walked in token tiles, and the most a
// block may take.
constexpr int kTileBudget = 160 * 1024;
constexpr int kMaxShared = 227 * 1024;

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
    return Num<T>::round(__fmul_rn(static_cast<float>(x), s));
  } else {
    return Num<T>::load(x);
  }
}

// Lanes that share one token's row: the largest power of two not above
// its chunk count, at most a warp.
__host__ __device__ inline int group_lanes(int chunks) {
  int g = 1;
  while (g * 2 <= chunks && g < 32) g *= 2;
  return g;
}

__host__ __device__ inline int align16(int x) { return (x + 15) & ~15; }

// Elements of one chunk of a staged row: 16 bytes, 8 for int8 (fewer
// registers for its dequantized values; a chunk count that still gives a
// 64-wide head eight lanes).
template <typename KV>
__host__ __device__ constexpr int vec_elems() {
  return sizeof(KV) == 1 ? 8 : 16 / static_cast<int>(sizeof(KV));
}

// Byte offsets of a block's shared arrays.
struct Layout {
  int k, v, ks, vs, s, q, pv, red, stats, bytes;
};

__host__ __device__ inline Layout layout(int reps, int d, int ps, int tile,
                                         int row_bytes, bool quant, int rb,
                                         int vg) {
  Layout L;
  int o = 0;
  L.k = o;  // (tile, d) K rows in the pool's dtype
  o = align16(o + tile * row_bytes);
  L.v = o;  // (tile, d) V rows
  o = align16(o + tile * row_bytes);
  L.ks = o;  // (tile,) K scales
  o = align16(o + (quant ? tile * 4 : 0));
  L.vs = o;  // (tile,) V scales
  o = align16(o + (quant ? tile * 4 : 0));
  L.s = o;  // (reps, ps) scores, then p
  o = align16(o + reps * ps * 4);
  L.q = o;  // (reps, d) q in f32
  o = align16(o + reps * d * 4);
  L.pv = o;  // (reps, d) the page's PV sums
  o = align16(o + reps * d * 4);
  L.red = o;  // (warps, rb, V, G) PV partials of each warp
  o = align16(o + kWarps * rb * vg * 4);
  L.stats = o;  // m_c and sum_c per query head, then two ints
  o = align16(o + 2 * reps * 4 + 8);
  L.bytes = o;
  return L;
}

struct Params {
  const void* q;
  const void* k_pages;
  const void* v_pages;
  const float* k_scales;
  const float* v_scales;
  const int* page_table;
  const int* seq_lens;
  void* out;
  float* m_scr;                // (b, h, tw) m_c
  float* sum_scr;              // (b, h, tw) sum_c
  float* pv_scr;               // (b, h, tw, d) rounded pv_c
  unsigned long long* ticket;  // state: (b, h_kv) pages handed out
  unsigned long long* done;    // then (b, h_kv) pages finished
  unsigned long long* maxima;  // then (b, h, tw) flagged page maxima
  int b, h, h_kv, d, ps, tw, num_pages, tile, unit;
  float scale;
};

template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (N == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
                 "l"(src), "n"(N));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Publish a page maximum: the flag in the high word, the value's bits in
// the low word, one 64-bit store, so a reader never sees one without the
// other.
__device__ __forceinline__ void publish_max(unsigned long long* word,
                                            float m) {
  const unsigned long long w =
      (1ull << 32) | static_cast<unsigned long long>(__float_as_uint(m));
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;\n" ::"l"(word), "l"(w)
               : "memory");
}

// Wait for an earlier page's maximum. Its block holds an earlier ticket, so
// it is running and publishes without waiting on anything; a flag that
// stays clear for seconds means broken state, and the kernel traps (a
// launch error) instead of hanging the card.
__device__ __forceinline__ float wait_max(const unsigned long long* word) {
  unsigned long long w;
  for (unsigned spins = 0;; ++spins) {
    asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];\n"
                 : "=l"(w)
                 : "l"(word)
                 : "memory");
    if (w >> 32) break;
    if (spins > (1u << 26)) __trap();
    __nanosleep(32);
  }
  return __uint_as_float(static_cast<unsigned>(w));
}

// Stage tokens [tok0, tok0 + nt) of KV head g (and their scales) into dst
// with cp.async in units of `unit` bytes (16, 8 or 4; 0 = element copies).
template <typename KV>
__device__ void stage_tile(const KV* pages, const float* scales, size_t tok0,
                           int nt, int g, int h_kv, int d, int unit,
                           unsigned char* dst, float* sc_dst) {
  const int row_bytes = d * static_cast<int>(sizeof(KV));
  const size_t stride = static_cast<size_t>(h_kv) * d;
  const KV* src0 = pages + (tok0 * h_kv + g) * d;
  if (unit) {
    const int per_row = row_bytes / unit;
    for (int i = threadIdx.x; i < nt * per_row; i += kThreads) {
      const int t = i / per_row;
      const int off = (i - t * per_row) * unit;
      const unsigned char* src =
          reinterpret_cast<const unsigned char*>(src0 + t * stride) + off;
      unsigned char* to = dst + t * row_bytes + off;
      if (unit == 16)
        cp_async<16>(to, src);
      else if (unit == 8)
        cp_async<8>(to, src);
      else
        cp_async<4>(to, src);
    }
  } else {
    KV* out = reinterpret_cast<KV*>(dst);
    for (int i = threadIdx.x; i < nt * d; i += kThreads) {
      const int t = i / d;
      out[i] = src0[t * stride + (i - t * d)];
    }
  }
  if (sc_dst != nullptr)
    for (int t = threadIdx.x; t < nt; t += kThreads)
      cp_async<4>(sc_dst + t, scales + (tok0 + t) * h_kv + g);
}

// Chunk k (V elements) of a staged row, in the values the compute dtype
// holds.
template <typename T, bool QUANT, int V>
__device__ __forceinline__ void load_chunk(const unsigned char* row, int k,
                                           float s, float (&x)[V]) {
  using KV = typename Storage<T, QUANT>::type;
  const KV* src = reinterpret_cast<const KV*>(row) + k * V;
  if constexpr (V * sizeof(KV) == 16) {
    const uint4 raw = *reinterpret_cast<const uint4*>(src);
    const KV* vals = reinterpret_cast<const KV*>(&raw);
#pragma unroll
    for (int u = 0; u < V; ++u) x[u] = element<T, QUANT>(vals[u], s);
  } else if constexpr (V * sizeof(KV) == 8) {
    const uint2 raw = *reinterpret_cast<const uint2*>(src);
    const KV* vals = reinterpret_cast<const KV*>(&raw);
#pragma unroll
    for (int u = 0; u < V; ++u) x[u] = element<T, QUANT>(vals[u], s);
  } else {
#pragma unroll
    for (int u = 0; u < V; ++u) x[u] = element<T, QUANT>(src[u], s);
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

// How the block's threads share a page: G lanes a token (lane `lig` takes
// chunks lig, lig + G, ...), token group `tg` of NTG takes tokens tg, tg +
// NTG, ...
struct Lanes {
  int chunks, G, lig, tg, NTG;
};

// Scores of staged tokens [t0, t0 + nt) for every query head of the group
// into s_s[j * ps + t]: the f32 dot rounded to T, times scale; -1e30 where
// the position is past seq_len.
template <typename T, bool QUANT, int V, int RB>
__device__ void qk_tile(const unsigned char* k_s, const float* ks_s,
                        const float* q_s, float* s_s, int reps, int d, int ps,
                        int t0, int nt, int pos0, int seq_len, float scale,
                        const Lanes& ln) {
  const int row_bytes = d * static_cast<int>(sizeof(
      typename Storage<T, QUANT>::type));
  const int iters = (nt + ln.NTG - 1) / ln.NTG;
  for (int j0 = 0; j0 < reps; j0 += RB) {
    for (int it = 0; it < iters; ++it) {
      const int t = ln.tg + it * ln.NTG;
      float dot[RB];
#pragma unroll
      for (int rb = 0; rb < RB; ++rb) dot[rb] = 0.f;
      if (t < nt) {
        const float s = QUANT ? ks_s[t] : 1.f;
        for (int k = ln.lig; k < ln.chunks; k += ln.G) {
          float x[V];
          load_chunk<T, QUANT, V>(k_s + t * row_bytes, k, s, x);
#pragma unroll
          for (int rb = 0; rb < RB; ++rb) {
            if (j0 + rb < reps) {
              const float* qj = q_s + (j0 + rb) * d + k * V;
#pragma unroll
              for (int u = 0; u < V; ++u) dot[rb] = fmaf(qj[u], x[u], dot[rb]);
            }
          }
        }
      }
#pragma unroll
      for (int rb = 0; rb < RB; ++rb)
        for (int o = 1; o < ln.G; o <<= 1)
          dot[rb] += __shfl_xor_sync(~0u, dot[rb], o);
      if (t < nt && ln.lig == 0) {
        const bool visible = pos0 + t0 + t <= seq_len;
#pragma unroll
        for (int rb = 0; rb < RB; ++rb)
          if (j0 + rb < reps)
            s_s[(j0 + rb) * ps + t0 + t] =
                visible ? __fmul_rn(Num<T>::round(dot[rb]), scale) : kNegInf;
      }
    }
  }
}

// pv_s[j * d + e] += sum over staged tokens [t0, t0 + nt) of round_T(p) *
// v, p read from s_s. Each thread sums its token group, shuffles sum the
// groups of a warp, warp 0's first group adds the warps in order.
template <typename T, bool QUANT, int V, int RB>
__device__ void pv_tile(const unsigned char* v_s, const float* vs_s,
                        const float* s_s, float* pv_s, float* red_s, int reps,
                        int d, int ps, int t0, int nt, const Lanes& ln) {
  const int row_bytes = d * static_cast<int>(sizeof(
      typename Storage<T, QUANT>::type));
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int G = ln.G;
  for (int j0 = 0; j0 < reps; j0 += RB) {
    for (int k0 = 0; k0 < ln.chunks; k0 += G) {
      const int k = k0 + ln.lig;
      float acc[RB][V];
#pragma unroll
      for (int rb = 0; rb < RB; ++rb)
#pragma unroll
        for (int u = 0; u < V; ++u) acc[rb][u] = 0.f;
      if (k < ln.chunks) {
        for (int t = ln.tg; t < nt; t += ln.NTG) {
          float x[V];
          load_chunk<T, QUANT, V>(v_s + t * row_bytes, k,
                                  QUANT ? vs_s[t] : 1.f, x);
#pragma unroll
          for (int rb = 0; rb < RB; ++rb) {
            if (j0 + rb < reps) {
              const float p = Num<T>::round(s_s[(j0 + rb) * ps + t0 + t]);
#pragma unroll
              for (int u = 0; u < V; ++u)
                acc[rb][u] = fmaf(p, x[u], acc[rb][u]);
            }
          }
        }
      }
#pragma unroll
      for (int rb = 0; rb < RB; ++rb)
#pragma unroll
        for (int u = 0; u < V; ++u)
          for (int o = G; o < 32; o <<= 1)
            acc[rb][u] += __shfl_xor_sync(~0u, acc[rb][u], o);
      if (lane < G) {
#pragma unroll
        for (int rb = 0; rb < RB; ++rb)
#pragma unroll
          for (int u = 0; u < V; ++u)
            red_s[((warp * RB + rb) * V + u) * G + lane] = acc[rb][u];
      }
      __syncthreads();
      if (tid < G && k < ln.chunks) {
        for (int rb = 0; rb < RB && j0 + rb < reps; ++rb) {
#pragma unroll
          for (int u = 0; u < V; ++u) {
            float s = 0.f;
#pragma unroll
            for (int w = 0; w < kWarps; ++w)
              s += red_s[((w * RB + rb) * V + u) * G + tid];
            pv_s[(j0 + rb) * d + k * V + u] += s;
          }
        }
      }
      __syncthreads();
    }
  }
}

template <typename T, bool QUANT, bool VEC, int RB>
__global__ void __launch_bounds__(kThreads)
    paged_decode_kernel(const Params p) {
  using KV = typename Storage<T, QUANT>::type;
  constexpr int V = VEC ? vec_elems<KV>() : 1;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int reps = p.h / p.h_kv;
  const int d = p.d;
  const int ps = p.ps;
  const int tw = p.tw;
  const int row_bytes = d * static_cast<int>(sizeof(KV));
  Lanes ln;
  ln.chunks = d / V;
  ln.G = group_lanes(ln.chunks);
  ln.lig = tid & (ln.G - 1);
  ln.tg = tid / ln.G;
  ln.NTG = kThreads / ln.G;
  const Layout L =
      layout(reps, d, ps, p.tile, row_bytes, QUANT, RB, V * ln.G);
  unsigned char* k_s = smem + L.k;
  unsigned char* v_s = smem + L.v;
  float* ks_s = reinterpret_cast<float*>(smem + L.ks);
  float* vs_s = reinterpret_cast<float*>(smem + L.vs);
  float* s_s = reinterpret_cast<float*>(smem + L.s);
  float* q_s = reinterpret_cast<float*>(smem + L.q);
  float* pv_s = reinterpret_cast<float*>(smem + L.pv);
  float* red_s = reinterpret_cast<float*>(smem + L.red);
  float* m_s = reinterpret_cast<float*>(smem + L.stats);
  float* sum_s = m_s + reps;
  int* flag_s = reinterpret_cast<int*>(sum_s + reps);

  // The work item: the block's (row, KV head) from its index, its page
  // from that pair's ticket, so pages are handed out in order and a block
  // waits only on pages whose blocks are running.
  const int rows = p.b * p.h_kv;
  const int rg = blockIdx.x % rows;
  const int r = rg / p.h_kv;
  const int g = rg - r * p.h_kv;
  if (tid == 0) {
    const unsigned long long t = atomicAdd(p.ticket + rg, 1ull);
    // The pair's last ticket is taken: put its counter back for the next
    // call.
    if (t == static_cast<unsigned long long>(tw) - 1)
      atomicExch(p.ticket + rg, 0ull);
    flag_s[0] = static_cast<int>(t);
  }
  const int seq_len = p.seq_lens[r];
  // Query heads g*reps .. g*reps+reps-1 share KV head g (the JAX
  // reshape(h_kv, reps, d) grouping).
  const size_t head0 = static_cast<size_t>(r) * p.h + g * reps;
  const T* qp = static_cast<const T*>(p.q) + head0 * d;
  for (int i = tid; i < reps * d; i += kThreads) {
    q_s[i] = Num<T>::load(qp[i]);
    pv_s[i] = 0.f;
  }
  __syncthreads();
  const int c = flag_s[0];
  int n = seq_len / ps + 1;
  if (n > tw) n = tw;
  if (c >= n) return;  // past the row's extent: nothing to read

  int page = p.page_table[r * tw + c];
  page = page < 0 ? 0 : (page >= p.num_pages ? p.num_pages - 1 : page);
  const KV* k_pages = static_cast<const KV*>(p.k_pages);
  const KV* v_pages = static_cast<const KV*>(p.v_pages);
  const size_t tok0 = static_cast<size_t>(page) * ps;
  const int n_tiles = (ps + p.tile - 1) / p.tile;
  stage_tile<KV>(k_pages, p.k_scales, tok0, p.tile < ps ? p.tile : ps, g,
                 p.h_kv, d, p.unit, k_s, QUANT ? ks_s : nullptr);
  cp_async_commit();
  if (n_tiles == 1) {
    // The whole page fits: V's loads fly under the scores and softmax.
    stage_tile<KV>(v_pages, p.v_scales, tok0, ps, g, p.h_kv, d, p.unit, v_s,
                   QUANT ? vs_s : nullptr);
    cp_async_commit();
  }

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int t0 = tile * p.tile;
    const int nt = ps - t0 < p.tile ? ps - t0 : p.tile;
    if (tile > 0) {
      stage_tile<KV>(k_pages, p.k_scales, tok0 + t0, nt, g, p.h_kv, d,
                     p.unit, k_s, QUANT ? ks_s : nullptr);
      cp_async_commit();
    }
    if (n_tiles == 1)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();
    qk_tile<T, QUANT, V, RB>(k_s, ks_s, q_s, s_s, reps, d, ps, t0, nt, c * ps,
                         seq_len, p.scale, ln);
    __syncthreads();
  }

  // Page maximum, published; m_c over it and the earlier pages' maxima;
  // then p = exp(s - m_c) (explicit 0 where masked) and its sum.
  for (int j = warp; j < reps; j += kWarps) {
    float* sj = s_s + j * ps;
    float mx = kNegInf;
    for (int t = lane; t < ps; t += 32) mx = fmaxf(mx, sj[t]);
    mx = warp_max(mx);
    unsigned long long* mj = p.maxima + (head0 + j) * tw;
    if (lane == 0) publish_max(mj + c, mx);
    float m = mx;
    for (int cc = lane; cc < c; cc += 32) m = fmaxf(m, wait_max(mj + cc));
    m = warp_max(m);
    float sum = 0.f;
    for (int t = lane; t < ps; t += 32) {
      const float e = c * ps + t <= seq_len ? expf(__fsub_rn(sj[t], m)) : 0.f;
      sj[t] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      m_s[j] = m;
      sum_s[j] = sum;
    }
  }

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int t0 = tile * p.tile;
    const int nt = ps - t0 < p.tile ? ps - t0 : p.tile;
    if (n_tiles > 1) {
      __syncthreads();  // the previous tile's V reads are done
      stage_tile<KV>(v_pages, p.v_scales, tok0 + t0, nt, g, p.h_kv, d,
                     p.unit, v_s, QUANT ? vs_s : nullptr);
      cp_async_commit();
    }
    cp_async_wait<0>();
    __syncthreads();
    pv_tile<T, QUANT, V, RB>(v_s, vs_s, s_s, pv_s, red_s, reps, d, ps, t0, nt,
                         ln);
  }

  // This page's m_c, sum_c and rounded pv_c, for the combine.
  for (int i = tid; i < reps * d; i += kThreads) {
    const int j = i / d;
    p.pv_scr[((head0 + j) * tw + c) * d + (i - j * d)] =
        Num<T>::round(pv_s[i]);
  }
  for (int j = tid; j < reps; j += kThreads) {
    p.m_scr[(head0 + j) * tw + c] = m_s[j];
    p.sum_scr[(head0 + j) * tw + c] = sum_s[j];
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const unsigned long long prev = atomicAdd(p.done + rg, 1ull);
    flag_s[1] = prev == static_cast<unsigned long long>(n - 1);
  }
  __syncthreads();
  if (!flag_s[1]) return;

  // The last page of this (row, KV head) to finish: the walk's sequential
  // combine over pages 0 .. n-1, eight pages' loads at a time.
  __threadfence();
  T* out = static_cast<T*>(p.out);
  for (int i = tid; i < reps * d; i += kThreads) {
    const int j = i / d;
    const int e = i - j * d;
    const size_t base = (head0 + j) * tw;
    float m_prev = kNegInf;
    float l = 0.f;
    float acc = 0.f;
    for (int c0 = 0; c0 < n; c0 += 8) {
      float mv[8], sv[8], pv[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        if (c0 + u < n) {
          mv[u] = __ldcg(p.m_scr + base + c0 + u);
          sv[u] = __ldcg(p.sum_scr + base + c0 + u);
          pv[u] = __ldcg(p.pv_scr + (base + c0 + u) * d + e);
        }
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        if (c0 + u < n) {
          const float corr = expf(m_prev - mv[u]);
          l = __fadd_rn(__fmul_rn(l, corr), sv[u]);
          acc = __fadd_rn(__fmul_rn(acc, corr), pv[u]);
          m_prev = mv[u];
        }
      }
    }
    out[(head0 + j) * d + e] = Num<T>::store(acc / fmaxf(l, 1e-30f));
  }
  // Every page block of this (row, KV head) has counted itself, so none
  // reads its flags any more: clear them and the count for the next call.
  for (int i = tid; i < reps * n; i += kThreads) {
    const int j = i / n;
    p.maxima[(head0 + j) * tw + (i - j * n)] = 0ull;
  }
  if (tid == 0) p.done[rg] = 0ull;
}

template <typename T, bool QUANT, bool VEC, int RB>
int launch_as(const Params& p, int smem, cudaStream_t stream) {
  auto kernel = paged_decode_kernel<T, QUANT, VEC, RB>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<p.b * p.h_kv * p.tw, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool QUANT>
int launch(Params p, cudaStream_t stream) {
  using KV = typename Storage<T, QUANT>::type;
  const bool vec = p.d % vec_elems<KV>() == 0;
  const int v = vec ? vec_elems<KV>() : 1;
  const int vg = v * group_lanes(p.d / v);
  const int row_bytes = p.d * static_cast<int>(sizeof(KV));
  p.unit = row_bytes % 16 == 0 ? 16
           : row_bytes % 8 == 0 ? 8
           : row_bytes % 4 == 0 ? 4
                                : 0;
  const int reps = p.h / p.h_kv;
  const int rb = reps == 1 ? 1 : kRepBatch;
  int tile = p.ps;
  Layout L = layout(reps, p.d, p.ps, tile, row_bytes, QUANT, rb, vg);
  while (L.bytes > kTileBudget && tile > 1) {
    tile = (tile + 1) / 2;
    L = layout(reps, p.d, p.ps, tile, row_bytes, QUANT, rb, vg);
  }
  if (L.bytes > kMaxShared) return static_cast<int>(cudaErrorInvalidValue);
  p.tile = tile;
  if (reps == 1)
    return vec ? launch_as<T, QUANT, true, 1>(p, L.bytes, stream)
               : launch_as<T, QUANT, false, 1>(p, L.bytes, stream);
  return vec ? launch_as<T, QUANT, true, kRepBatch>(p, L.bytes, stream)
             : launch_as<T, QUANT, false, kRepBatch>(p, L.bytes, stream);
}

}  // namespace

// dtype: 0 = f32, 1 = bf16 (q, out, and the pages unless quant);
// quant: 1 = int8 pages with f32 scales. scratch: f32, b * h * tw * (d +
// 2) values, any contents. state: 64-bit words, 2 * b * h_kv + b * h * tw
// of them, zero before the first call; each call leaves them zero. One
// kernel launch; returns cudaGetLastError() after it (0 = launched).
extern "C" int paged_decode(const void* q, const void* k_pages,
                            const void* v_pages, const void* k_scales,
                            const void* v_scales, const void* page_table,
                            const void* seq_lens, void* out, void* scratch,
                            void* state, int b, int h, int h_kv, int d,
                            int page_size, int table_width, int num_pages,
                            float scale, int dtype, int quant, void* stream) {
  if (b == 0) return 0;
  Params p;
  p.q = q;
  p.k_pages = k_pages;
  p.v_pages = v_pages;
  p.k_scales = static_cast<const float*>(k_scales);
  p.v_scales = static_cast<const float*>(v_scales);
  p.page_table = static_cast<const int*>(page_table);
  p.seq_lens = static_cast<const int*>(seq_lens);
  p.out = out;
  const size_t heads = static_cast<size_t>(b) * h * table_width;
  p.m_scr = static_cast<float*>(scratch);
  p.sum_scr = p.m_scr + heads;
  p.pv_scr = p.sum_scr + heads;
  p.ticket = static_cast<unsigned long long*>(state);
  p.done = p.ticket + static_cast<size_t>(b) * h_kv;
  p.maxima = p.done + static_cast<size_t>(b) * h_kv;
  p.b = b;
  p.h = h;
  p.h_kv = h_kv;
  p.d = d;
  p.ps = page_size;
  p.tw = table_width;
  p.num_pages = num_pages;
  p.tile = page_size;
  p.unit = 0;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && !quant) return launch<float, false>(p, s);
  if (dtype == 0 && quant) return launch<float, true>(p, s);
  if (dtype == 1 && !quant) return launch<__nv_bfloat16, false>(p, s);
  if (dtype == 1 && quant) return launch<__nv_bfloat16, true>(p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
