// Fused ResNet bottleneck kernels for Hopper (sm_90a): the 1x1 conv with
// statistics (B5) and the 3x3 conv with statistics (B6).
//
// Replaces the Pallas kernels of tensorflowonspark_tpu/ops/
// fused_resnet_block.py:
//   matmul_stats  <- _matmul_stats_kernel  (:53, launched by _conv1x1_stats
//                    at :83): y = [relu(x * scale + shift)] . W with f32
//                    accumulation, y stored in the input dtype, and the f32
//                    per-channel sums of y and y^2 of the f32 product;
//   conv3x3_stats <- _conv3x3_stats_kernel (:112, launched by _conv3x3_stats
//                    at :168): the bf16 prologue relu(x * scale + shift),
//                    then a SAME 3x3 conv over the zero-padded image, with
//                    the same statistics.
// stats_reduce sums the per-block partial statistics of both in a fixed
// order; it belongs to both ports and runs inside their launches.
//
// Bound. At the full-width bottleneck shapes (b256; stage 1: 56x56, 256 ->
// 64; stage 3: 14x14, 1024 -> 256) the 1x1 convs move 128-514 MB for 4-26
// GFLOP, well under the H100's ridge of ~295 FLOP per byte: the bytes bound
// them (0.04-0.15 ms at 3.35 TB/s). The 3x3 conv does 59 GFLOP either way;
// at stage 1 its 206 MB and its FLOPs take about the same time (0.06 ms), at
// stage 3 the bf16 tensor-core rate bounds it. This design reaches neither
// roof; it is the simple, exact first version.
//
// Design. Both kernels are one implicit GEMM: a thread block (4 warps) owns
// a 64-column tile of the output channels and walks 64-row tiles of output
// pixels (rows of the flattened NHWC activation), a fixed share of them, in
// order. Per row tile it loops over the taps (1 or 9) and 32-deep chunks of
// the input channels, staging A (64 pixels x 32 channels, the prologue
// applied while staging) and B (32 x 64 of the weights) in shared memory
// with 16-byte loads; bf16 products run on the tensor cores as 16x16x16
// WMMA fragments accumulating in f32 registers across the whole walk, f32
// operands take full-precision FMAs. The 3x3 conv's A rows read the pixel
// shifted by the tap inside the same image; a tap that falls outside the
// image stages zeros AFTER the prologue, so the border is zero in the
// normalised activation (a kernel that loaded zeros and then applied the
// prologue would write relu(shift) there), and no row ever reads a pixel of
// the neighbouring image. The epilogue rounds y once from the f32
// accumulator and sums y and y^2 per column from the same f32 values over
// the tile's valid rows. CUDA blocks run in no order, so where the TPU grid
// revisits one f32 accumulator, each block adds its tiles' sums in tile
// order and writes one partial row of an f32 scratch (groups, channels);
// stats_reduce then sums the rows in a fixed order. No atomics: the result
// is the same in every run. One tile in flight, no asynchronous copies,
// each input pixel staged once per tap: cp.async/TMA pipelining, a halo tile
// shared by the nine taps and wgmma are the next steps toward the bound.
//
// Rounding points follow the Pallas kernels as JAX runs them: B5's prologue
// in f32 (x * scale, then + shift, then relu, rounded once to the operand
// dtype); B6's in the operand dtype with scale and shift rounded to it
// first and every operation rounded (XLA's interpret-mode run on the CPU
// rounds each bf16 operation, not once per fusion); the multiply and add
// are kept apart (__fmul_rn/__fadd_rn) so that no FMA contraction changes
// them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

using namespace nvcuda;

constexpr int kThreads = 128;  // 4 warps; warp w owns tile rows 16w..16w+15
constexpr int kBM = 64;        // output pixels per tile
constexpr int kBN = 64;        // output channels per tile
constexpr int kBK = 32;        // input channels per staged chunk
constexpr int kLdC = kBN + 4;  // f32 result tile row stride
constexpr int kReduceRows = 8;

static_assert(kBM == 16 * (kThreads / 32), "one 16-row strip per warp");

// Prologue of the A operand: none (K1), f32 (K3: relu(x * scale + shift)
// in f32, rounded once), or in the operand dtype (K2: every operation
// rounded).
enum Prologue { kNone = 0, kF32 = 1, kOperand = 2 };

template <typename T>
struct Num;

template <>
struct Num<float> {
  __device__ static float load(float x) { return x; }
  __device__ static float store(float x) { return x; }
  __device__ static float round(float x) { return x; }
  static constexpr int kLdA = kBK + 4;
  static constexpr int kLdB = kBN + 4;
};

template <>
struct Num<__nv_bfloat16> {
  __device__ static float load(__nv_bfloat16 x) { return __bfloat162float(x); }
  __device__ static __nv_bfloat16 store(float x) { return __float2bfloat16(x); }
  __device__ static float round(float x) {
    return __bfloat162float(__float2bfloat16(x));
  }
  // Row strides of 80 and 144 bytes: WMMA fragment loads stay 32-byte
  // aligned at every 16-row and 16-column offset.
  static constexpr int kLdA = kBK + 8;
  static constexpr int kLdB = kBN + 8;
};

template <typename T, int kMode>
__device__ __forceinline__ T prologue(T raw, const float* __restrict__ scale,
                                      const float* __restrict__ shift,
                                      int k) {
  if constexpr (kMode == kNone) {
    return raw;
  } else {
    const float v = Num<T>::load(raw);
    if constexpr (kMode == kF32) {
      return Num<T>::store(
          fmaxf(__fadd_rn(__fmul_rn(v, __ldg(scale + k)), __ldg(shift + k)),
                0.f));
    } else {
      const float t = Num<T>::round(__fmul_rn(v, Num<T>::round(__ldg(scale + k))));
      const float u = Num<T>::round(__fadd_rn(t, Num<T>::round(__ldg(shift + k))));
      return Num<T>::store(fmaxf(u, 0.f));
    }
  }
}

// One kernel for both: kTaps = 1 is the 1x1 conv over rows of (n, cin);
// kTaps = 9 the SAME 3x3 conv over (n = b * h * w) NHWC pixels. w is
// (kTaps, cin, fout) (HWIO flattened). part_s/part_q: (gridDim.x, fout).
template <typename T, int kTaps, int kMode>
__global__ void __launch_bounds__(kThreads)
    conv_stats_kernel(const T* __restrict__ x, const T* __restrict__ w,
                      const float* __restrict__ scale,
                      const float* __restrict__ shift, T* __restrict__ y,
                      float* __restrict__ part_s, float* __restrict__ part_q,
                      int n, int cin, int fout, int height, int width) {
  constexpr int kLdA = Num<T>::kLdA;
  constexpr int kLdB = Num<T>::kLdB;
  constexpr int kVec = 16 / sizeof(T);
  // Raw bytes carved into typed tiles (a bf16 __shared__ array would need
  // its type to be trivially constructible).
  __shared__ __align__(128) unsigned char a_raw[sizeof(T) * kBM * kLdA];
  __shared__ __align__(128) unsigned char b_raw[sizeof(T) * kBK * kLdB];
  __shared__ __align__(128) float Cs[kBM * kLdC];
  T* As = reinterpret_cast<T*>(a_raw);
  T* Bs = reinterpret_cast<T*>(b_raw);
  __shared__ int row_y[kBM], row_x[kBM];
  __shared__ float red_s[kBN], red_q[kBN];

  const int tid = threadIdx.x;
  const int n0 = blockIdx.y * kBN;
  const int n_tiles = (n + kBM - 1) / kBM;
  // Column statistics: thread (col, half) sums rows 32 * half .. +32.
  const int col = tid & (kBN - 1);
  const int half = tid / kBN;
  float blk_s = 0.f, blk_q = 0.f;

  for (int rt = blockIdx.x; rt < n_tiles; rt += gridDim.x) {
    const int p0 = rt * kBM;
    if (tid < kBM) {
      const int p = p0 + tid;
      if (kTaps == 1 || p >= n) {
        // A row past the end never passes the bounds test below.
        row_y[tid] = p < n ? 0 : -4;
        row_x[tid] = 0;
      } else {
        const int rem = p % (height * width);
        row_y[tid] = rem / width;
        row_x[tid] = rem - (rem / width) * width;
      }
    }

    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kBN / 16];
    float facc[32];
    if constexpr (std::is_same<T, __nv_bfloat16>::value) {
#pragma unroll
      for (int j = 0; j < kBN / 16; ++j) wmma::fill_fragment(acc[j], 0.f);
    } else {
#pragma unroll
      for (int j = 0; j < 32; ++j) facc[j] = 0.f;
    }
    __syncthreads();

    for (int tap = 0; tap < kTaps; ++tap) {
      const int dy = kTaps == 1 ? 0 : tap / 3 - 1;
      const int dx = kTaps == 1 ? 0 : tap % 3 - 1;
      for (int k0 = 0; k0 < cin; k0 += kBK) {
        // A: 64 pixels x 32 channels, shifted by the tap; zeros outside the
        // image (after the prologue) and past cin.
        for (int i = tid; i < kBM * (kBK / kVec); i += kThreads) {
          const int r = i / (kBK / kVec);
          const int kc = (i - r * (kBK / kVec)) * kVec;
          const int k = k0 + kc;
          const int yy = row_y[r] + dy, xx = row_x[r] + dx;
          uint4 val = make_uint4(0u, 0u, 0u, 0u);
          if (k < cin && yy >= 0 && yy < height && xx >= 0 && xx < width) {
            const size_t src = static_cast<size_t>(p0 + r + dy * width + dx);
            val = *reinterpret_cast<const uint4*>(x + src * cin + k);
            if constexpr (kMode != kNone) {
              T* v = reinterpret_cast<T*>(&val);
#pragma unroll
              for (int j = 0; j < kVec; ++j)
                v[j] = prologue<T, kMode>(v[j], scale, shift, k + j);
            }
          }
          *reinterpret_cast<uint4*>(As + r * kLdA + kc) = val;
        }
        // B: 32 input channels x 64 output channels of this tap's weights.
        for (int i = tid; i < kBK * (kBN / kVec); i += kThreads) {
          const int kr = i / (kBN / kVec);
          const int c = (i - kr * (kBN / kVec)) * kVec;
          uint4 val = make_uint4(0u, 0u, 0u, 0u);
          if (k0 + kr < cin && n0 + c < fout)
            val = *reinterpret_cast<const uint4*>(
                w + (static_cast<size_t>(tap) * cin + k0 + kr) * fout + n0 +
                c);
          *reinterpret_cast<uint4*>(Bs + kr * kLdB + c) = val;
        }
        __syncthreads();
        if constexpr (std::is_same<T, __nv_bfloat16>::value) {
          const int strip = tid / 32;
#pragma unroll
          for (int kk = 0; kk < kBK; kk += 16) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                           wmma::row_major>
                a;
            wmma::load_matrix_sync(a, As + strip * 16 * kLdA + kk, kLdA);
#pragma unroll
            for (int j = 0; j < kBN / 16; ++j) {
              wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                             wmma::row_major>
                  b;
              wmma::load_matrix_sync(b, Bs + kk * kLdB + j * 16, kLdB);
              wmma::mma_sync(acc[j], a, b, acc[j]);
            }
          }
        } else {
          // Thread t: row t / 2, columns 32 * (t % 2) .. +32.
          const int r = tid >> 1;
          const int c0 = (tid & 1) * 32;
#pragma unroll 4
          for (int kk = 0; kk < kBK; ++kk) {
            const float a = Num<T>::load(As[r * kLdA + kk]);
#pragma unroll
            for (int j = 0; j < 32; ++j)
              facc[j] = fmaf(a, Num<T>::load(Bs[kk * kLdB + c0 + j]), facc[j]);
          }
        }
        __syncthreads();
      }
    }

    if constexpr (std::is_same<T, __nv_bfloat16>::value) {
      const int strip = tid / 32;
#pragma unroll
      for (int j = 0; j < kBN / 16; ++j)
        wmma::store_matrix_sync(Cs + strip * 16 * kLdC + j * 16, acc[j], kLdC,
                                wmma::mem_row_major);
    } else {
      const int r = tid >> 1;
      const int c0 = (tid & 1) * 32;
#pragma unroll
      for (int j = 0; j < 32; ++j) Cs[r * kLdC + c0 + j] = facc[j];
    }
    __syncthreads();

    // y, rounded once from the f32 accumulator.
    for (int e = tid; e < kBM * kBN; e += kThreads) {
      const int r = e / kBN;
      const int c = e - r * kBN;
      if (p0 + r < n && n0 + c < fout)
        y[static_cast<size_t>(p0 + r) * fout + n0 + c] =
            Num<T>::store(Cs[r * kLdC + c]);
    }
    // Column sums of y and y^2 from the same f32 values, rows in order.
    float s = 0.f, q = 0.f;
    const int rows = min(kBM, n - p0);
    for (int r = half * 32; r < min(rows, half * 32 + 32); ++r) {
      const float v = Cs[r * kLdC + col];
      s += v;
      q += v * v;
    }
    if (half == 1) {
      red_s[col] = s;
      red_q[col] = q;
    }
    __syncthreads();
    if (half == 0) {
      blk_s += s + red_s[col];
      blk_q += q + red_q[col];
    }
    __syncthreads();
  }

  if (half == 0 && n0 + col < fout) {
    part_s[static_cast<size_t>(blockIdx.x) * fout + n0 + col] = blk_s;
    part_q[static_cast<size_t>(blockIdx.x) * fout + n0 + col] = blk_q;
  }
}

// s[c] = sum over g of part_s[g, c] (q likewise), in a fixed order: thread
// (c, j) adds rows j, j + 8, ...; then row 0 of the block adds the eight
// partial sums in order.
__global__ void __launch_bounds__(32 * kReduceRows)
    stats_reduce_kernel(const float* __restrict__ part_s,
                        const float* __restrict__ part_q, int groups, int f,
                        float* __restrict__ s, float* __restrict__ q) {
  __shared__ float rs[kReduceRows][33], rq[kReduceRows][33];
  const int c = blockIdx.x * 32 + threadIdx.x;
  float a = 0.f, b = 0.f;
  if (c < f) {
    for (int g = threadIdx.y; g < groups; g += kReduceRows) {
      a += part_s[static_cast<size_t>(g) * f + c];
      b += part_q[static_cast<size_t>(g) * f + c];
    }
  }
  rs[threadIdx.y][threadIdx.x] = a;
  rq[threadIdx.y][threadIdx.x] = b;
  __syncthreads();
  if (threadIdx.y == 0 && c < f) {
    float ta = rs[0][threadIdx.x], tb = rq[0][threadIdx.x];
#pragma unroll
    for (int j = 1; j < kReduceRows; ++j) {
      ta += rs[j][threadIdx.x];
      tb += rq[j][threadIdx.x];
    }
    s[c] = ta;
    q[c] = tb;
  }
}

// ------------------------------------------------------------ launches ----

template <typename T, int kTaps, int kMode>
int launch(const void* x, const void* w, const void* scale, const void* shift,
           void* y, void* part_s, void* part_q, void* s, void* q, int n,
           int cin, int fout, int height, int width, int groups,
           cudaStream_t stream) {
  const dim3 grid(groups, (fout + kBN - 1) / kBN);
  conv_stats_kernel<T, kTaps, kMode><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const float*>(scale), static_cast<const float*>(shift),
      static_cast<T*>(y), static_cast<float*>(part_s),
      static_cast<float*>(part_q), n, cin, fout, height, width);
  if (cudaError_t err = cudaGetLastError()) return static_cast<int>(err);
  stats_reduce_kernel<<<(fout + 31) / 32, dim3(32, kReduceRows), 0,
                        stream>>>(static_cast<const float*>(part_s),
                                  static_cast<const float*>(part_q), groups,
                                  fout, static_cast<float*>(s),
                                  static_cast<float*>(q));
  return static_cast<int>(cudaGetLastError());
}

int check_dims(int n, int cin, int fout, int groups, int dtype) {
  const int vec = dtype == 1 ? 8 : 4;
  if (n <= 0 || cin <= 0 || fout <= 0 || groups <= 0 || cin % vec ||
      fout % vec || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

}  // namespace

// Pointers: x (n, cin) [matmul_stats] or (b, h, w, f) [conv3x3_stats],
// contiguous, in the dtype (0 = f32, 1 = bf16), 16-byte aligned; w (cin,
// fout) or (3, 3, f, f) HWIO in the dtype; scale, shift (cin,) f32 (ignored
// by matmul_stats when prologue = 0); y (n, fout) in the dtype; part_s,
// part_q (groups, fout) f32 scratch; s, q (fout,) f32. cin and fout must be
// multiples of 8 (bf16) or 4 (f32). Each returns cudaGetLastError() after
// its launches (0 = launched).

extern "C" int matmul_stats(const void* x, const void* w, const void* scale,
                            const void* shift, void* y, void* part_s,
                            void* part_q, void* s, void* q, int n, int cin,
                            int fout, int groups, int prologue, int dtype,
                            void* stream) {
  if (int err = check_dims(n, cin, fout, groups, dtype)) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return prologue
               ? launch<__nv_bfloat16, 1, kF32>(x, w, scale, shift, y, part_s,
                                                part_q, s, q, n, cin, fout, 1,
                                                1, groups, st)
               : launch<__nv_bfloat16, 1, kNone>(x, w, scale, shift, y,
                                                 part_s, part_q, s, q, n, cin,
                                                 fout, 1, 1, groups, st);
  return prologue ? launch<float, 1, kF32>(x, w, scale, shift, y, part_s,
                                           part_q, s, q, n, cin, fout, 1, 1,
                                           groups, st)
                  : launch<float, 1, kNone>(x, w, scale, shift, y, part_s,
                                            part_q, s, q, n, cin, fout, 1, 1,
                                            groups, st);
}

extern "C" int conv3x3_stats(const void* x, const void* w, const void* scale,
                             const void* shift, void* y, void* part_s,
                             void* part_q, void* s, void* q, int b,
                             int height, int width, int f, int groups,
                             int dtype, void* stream) {
  if (b <= 0 || height <= 0 || width <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n = b * height * width;
  if (int err = check_dims(n, f, f, groups, dtype)) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch<__nv_bfloat16, 9, kOperand>(x, w, scale, shift, y, part_s,
                                              part_q, s, q, n, f, f, height,
                                              width, groups, st);
  return launch<float, 9, kOperand>(x, w, scale, shift, y, part_s, part_q, s,
                                    q, n, f, f, height, width, groups, st);
}
