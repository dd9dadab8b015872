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
// stage 3 the bf16 tensor-core rate bounds it.
//
// bf16 design (the speed path). One kernel template for both, an implicit
// GEMM of 256 threads (8 warps) a block and one block an SM:
// - Work items. A block owns a column tile of kBN output channels (64, 128
//   or 256; as wide as F up to 256, so that the input is read once per 256
//   output channels) and walks a fixed share of the work items, in order:
//   B5's items are tiles of kBM rows of x (256 rows, 128 at kBN = 256); B6's
//   are groups of strips, a strip being strip_rows output rows of one image
//   (whole small images, several to a block). Warp (wm, wn) owns four m16
//   bands of rows and kWN columns of the tile: 4 x kWN/8 m16n8
//   accumulators. B5's bands are rows 64 wm..+63; B6's are bands wm,
//   wm + 4, .., so that a layout shorter than the tile (196 of 256 rows at
//   14x14) spreads evenly over the warps, and bands past it are skipped.
// - The A operand is staged per 64-deep chunk of input channels: for B5 the
//   item's rows; for B6 a halo tile holding, per strip, its (rows + 2) x
//   (W + 2) pixels, the border zero-filled. The nine taps read that one tile
//   as shifted ldmatrix windows: a lane's A row address is its output
//   pixel's halo pixel plus the tap's offset, so nothing is staged twice.
//   The weights come per (chunk, tap) as a 64 x kBN tile.
// - Pipelining. Steps run over (item, chunk, tap) in one sequence; step u's
//   cp.async group holds its weight tile and, kD steps ahead of its first
//   tap, the next A chunk (B6: the halo a whole chunk early; B5: a 3-stage
//   ring of both). Loads run kL steps ahead of the products, through the
//   epilogue into the next item, with one barrier a step. Where one chunk
//   covers the input channels (cin <= 64: stage 1's B6 and K3) the weights
//   are resident instead, loaded once a block, and a step is a whole item:
//   its taps run back to back behind one barrier.
// - Prologues run once per staged element, in shared memory, by the thread
//   that copied it, right after its own copies land: B5's in f32 rounded
//   once, B6's as rounded bf16x2 operations. A halo pixel outside the image
//   is zero-filled and skipped, so the border is zero AFTER the prologue (a
//   kernel that loaded zeros and then applied the prologue would write
//   relu(shift) there), and no pixel of a neighbouring image is read.
// - Products: mma.sync.m16n8k16 bf16 with f32 accumulators in registers,
//   A and B fragments by ldmatrix (.trans for the k x n weights); rows are
//   padded by 16 bytes so ldmatrix's eight addresses hit distinct banks.
//   The tensor cores truncate as they accumulate, so a long chain drifts
//   toward zero (a 4608-product B6 output at ResNet-50's stage 4 read
//   6.4e-6 of the largest sum off the plain version's f32 sums): B6 with
//   more than one chunk adds each 64-deep step, summed from zero, to its
//   running f32 sums with a rounded add (1.1e-7).
// - Register epilogue. Column sums and sums of squares come from the f32
//   accumulators of valid rows: each lane in row order, then a fixed xor-
//   shuffle tree over the warp's rows, then the warps in order through a
//   small shared array, then the items in order in one register a column.
//   y is rounded once from the f32 accumulators, staged per warp in a
//   16-row tile and written with 16-byte stores, whole 128-byte lines.
// The block writes one row of partial statistics; stats_reduce adds the
// rows in a fixed order. No atomics: the result is the same in every run.
//
// f32 operands keep the first design: a block of 4 warps owns a 64-column
// tile and walks 64-row tiles, staging A (prologue applied) and B with
// 16-byte loads, each thread a 1 x 32 strip of full-precision FMAs; the
// same partial statistics. It is the parity route, not the speed path.
//
// Rounding points follow the Pallas kernels as JAX runs them: B5's prologue
// in f32 (x * scale, then + shift, then relu, rounded once to the operand
// dtype); B6's in the operand dtype with scale and shift rounded to it
// first and every operation rounded (XLA's interpret-mode run on the CPU
// rounds each bf16 operation, not once per fusion); the multiply and add
// are kept apart (__fmul_rn/__fadd_rn, mul.rn/add.rn) so that no FMA
// contraction changes them. A bf16 product or sum computed in f32 and
// rounded once equals the correctly rounded bf16 operation (24 >= 2 x 8 +
// 2 bits), so the bf16x2 instructions give the plain version's values.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kReduceRows = 8;

// Prologue of the A operand: none (K1), f32 (K3: relu(x * scale + shift)
// in f32, rounded once), or in the operand dtype (K2: every operation
// rounded).
enum Prologue { kNone = 0, kF32 = 1, kOperand = 2 };

// ------------------------------------------------------ f32 (parity) ----

constexpr int kThreadsF = 128;  // 4 warps
constexpr int kBMF = 64;        // output pixels per tile
constexpr int kBNF = 64;        // output channels per tile
constexpr int kBKF = 32;        // input channels per staged chunk
constexpr int kLdAF = kBKF + 4;
constexpr int kLdBF = kBNF + 4;
constexpr int kLdCF = kBNF + 4;

template <int kMode>
__device__ __forceinline__ float prologue_f32(float v,
                                              const float* __restrict__ scale,
                                              const float* __restrict__ shift,
                                              int k) {
  if constexpr (kMode == kNone)
    return v;
  else
    return fmaxf(__fadd_rn(__fmul_rn(v, __ldg(scale + k)), __ldg(shift + k)),
                 0.f);
}

// kTaps = 1 is the 1x1 conv over rows of (n, cin); kTaps = 9 the SAME 3x3
// conv over (n = b * h * w) NHWC pixels. w is (kTaps, cin, fout) (HWIO
// flattened). part_s/part_q: (gridDim.x, fout).
template <int kTaps, int kMode>
__global__ void __launch_bounds__(kThreadsF)
    conv_stats_f32_kernel(const float* __restrict__ x,
                          const float* __restrict__ w,
                          const float* __restrict__ scale,
                          const float* __restrict__ shift,
                          float* __restrict__ y, float* __restrict__ part_s,
                          float* __restrict__ part_q, int n, int cin,
                          int fout, int height, int width) {
  __shared__ __align__(16) float As[kBMF * kLdAF];
  __shared__ __align__(16) float Bs[kBKF * kLdBF];
  __shared__ __align__(16) float Cs[kBMF * kLdCF];
  __shared__ int row_y[kBMF], row_x[kBMF];
  __shared__ float red_s[kBNF], red_q[kBNF];

  const int tid = threadIdx.x;
  const int n0 = blockIdx.y * kBNF;
  const int n_tiles = (n + kBMF - 1) / kBMF;
  // Column statistics: thread (col, half) sums rows 32 * half .. +32.
  const int col = tid & (kBNF - 1);
  const int half = tid / kBNF;
  // Products: thread t owns row t / 2, columns 32 * (t % 2) .. +32.
  const int pr = tid >> 1;
  const int pc0 = (tid & 1) * 32;
  float blk_s = 0.f, blk_q = 0.f;

  for (int rt = blockIdx.x; rt < n_tiles; rt += gridDim.x) {
    const int p0 = rt * kBMF;
    if (tid < kBMF) {
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
    float facc[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) facc[j] = 0.f;
    __syncthreads();

    for (int tap = 0; tap < kTaps; ++tap) {
      const int dy = kTaps == 1 ? 0 : tap / 3 - 1;
      const int dx = kTaps == 1 ? 0 : tap % 3 - 1;
      for (int k0 = 0; k0 < cin; k0 += kBKF) {
        // A: 64 pixels x 32 channels, shifted by the tap; zeros outside the
        // image (after the prologue) and past cin.
        for (int i = tid; i < kBMF * (kBKF / 4); i += kThreadsF) {
          const int r = i / (kBKF / 4);
          const int kc = (i - r * (kBKF / 4)) * 4;
          const int k = k0 + kc;
          const int yy = row_y[r] + dy, xx = row_x[r] + dx;
          float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
          if (k < cin && yy >= 0 && yy < height && xx >= 0 && xx < width) {
            const size_t src = static_cast<size_t>(p0 + r + dy * width + dx);
            val = *reinterpret_cast<const float4*>(x + src * cin + k);
            if constexpr (kMode != kNone) {
              val.x = prologue_f32<kMode>(val.x, scale, shift, k);
              val.y = prologue_f32<kMode>(val.y, scale, shift, k + 1);
              val.z = prologue_f32<kMode>(val.z, scale, shift, k + 2);
              val.w = prologue_f32<kMode>(val.w, scale, shift, k + 3);
            }
          }
          *reinterpret_cast<float4*>(As + r * kLdAF + kc) = val;
        }
        // B: 32 input channels x 64 output channels of this tap's weights.
        for (int i = tid; i < kBKF * (kBNF / 4); i += kThreadsF) {
          const int kr = i / (kBNF / 4);
          const int c = (i - kr * (kBNF / 4)) * 4;
          float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
          if (k0 + kr < cin && n0 + c < fout)
            val = *reinterpret_cast<const float4*>(
                w + (static_cast<size_t>(tap) * cin + k0 + kr) * fout + n0 +
                c);
          *reinterpret_cast<float4*>(Bs + kr * kLdBF + c) = val;
        }
        __syncthreads();
#pragma unroll 4
        for (int kk = 0; kk < kBKF; ++kk) {
          const float a = As[pr * kLdAF + kk];
#pragma unroll
          for (int j = 0; j < 32; ++j)
            facc[j] = fmaf(a, Bs[kk * kLdBF + pc0 + j], facc[j]);
        }
        __syncthreads();
      }
    }

#pragma unroll
    for (int j = 0; j < 32; ++j) Cs[pr * kLdCF + pc0 + j] = facc[j];
    __syncthreads();

    for (int e = tid; e < kBMF * kBNF; e += kThreadsF) {
      const int r = e / kBNF;
      const int c = e - r * kBNF;
      if (p0 + r < n && n0 + c < fout)
        y[static_cast<size_t>(p0 + r) * fout + n0 + c] = Cs[r * kLdCF + c];
    }
    // Column sums of y and y^2, rows in order.
    float s = 0.f, q = 0.f;
    const int rows = min(kBMF, n - p0);
    for (int r = half * 32; r < min(rows, half * 32 + 32); ++r) {
      const float v = Cs[r * kLdCF + col];
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

// ------------------------------------------------- bf16 (speed path) ----

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kKC = 64;        // input channels per staged chunk
constexpr int kLdA = kKC + 8;  // 144-byte rows of the A stages
constexpr int kMaxSmem = 232448;  // the H100's 227 KB a block

// Tile geometry by column tile width: warps (kWarpsM x kWarpsN), each
// 64 rows x kWN columns (4 x kN8 m16n8 accumulators).
template <int kBN>
struct Tile {
  static constexpr int kWN = kBN == 64 ? 32 : 64;
  static constexpr int kWarpsN = kBN / kWN;
  static constexpr int kWarpsM = kWarps / kWarpsN;
  static constexpr int kBM = 64 * kWarpsM;  // rows of a B5 item
  static constexpr int kN8 = kWN / 8;
  static constexpr int kLdB = kBN + 8;  // weight tile row stride
  static constexpr int kLdS = kWN + 8;  // y staging row stride
  static constexpr int kWElems = kKC * kLdB;
};

// Ring depths: A stages and weight stages. Loads run kL = kSW - 1 steps
// ahead; an A chunk kD further (B6: the next halo at the current chunk's
// first tap, B5: with its weights). Where one chunk covers the input
// channels (cin <= 64) the weights stay resident instead: kTaps tiles,
// loaded once, and a step is a whole chunk, kSA - 1 chunks ahead.
template <int kTaps>
struct Pipe {
  static constexpr int kSA = kTaps == 1 ? 3 : 2;
  static constexpr int kSW = kTaps == 1 ? 3 : 4;
  static constexpr int kL = kSW - 1;
  static constexpr int kD = (kSA - 1) * kTaps - kL;
  static_assert(kD >= 0 && kD < kTaps + (kTaps == 1), "A lookahead");
};

template <int kTaps>
__host__ __device__ constexpr int w_stages(bool resident) {
  return resident ? kTaps : Pipe<kTaps>::kSW;
}

// Dynamic shared memory of one block: A stages, weight stages, per-warp y
// staging, the cross-warp sums, the item's row table, each thread's
// copy masks. ops/fused_resnet_block.py's _smem_bf16 mirrors it.
template <int kTaps, int kBN>
constexpr int smem_bytes(int a_rows, bool resident) {
  using Tl = Tile<kBN>;
  return Pipe<kTaps>::kSA * a_rows * kLdA * 2 +
         w_stages<kTaps>(resident) * Tl::kWElems * 2 +
         kWarps * 16 * Tl::kLdS * 2 +
         2 * Tl::kWarpsM * kBN * 4 + Tl::kBM * 4 +
         Pipe<kTaps>::kSA * kThreads * 4;
}

struct ConvParams {
  const bf16* x;
  const bf16* w;
  const float* scale;
  const float* shift;
  bf16* y;
  float* part_s;
  float* part_q;
  int n;     // output pixels (rows of y)
  int cin;
  int fout;
  int items;  // work items: B5 row tiles, B6 strip groups
  int a_rows;  // rows of one A stage: kBM (B5) or halo pixels (B6)
  // B6 geometry.
  int height, width, strip_rows, strips_per_image, strips_per_block,
      total_strips;
};

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

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Waits until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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
// (g = l / 4, t = l % 4) holds d at rows g, g + 8 x columns 2t, 2t + 1.
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

// Rounded bf16x2 operations; the explicit .rn keeps ptxas from fusing the
// multiply and the add.
__device__ __forceinline__ uint32_t bf2_mul(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__device__ __forceinline__ uint32_t bf2_add(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("add.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__device__ __forceinline__ uint32_t bf2_relu(uint32_t a) {
  uint32_t d;
  asm("max.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(0u));
  return d;
}

// B6: the output pixel of block row m of item `item`, or -1 (a row past the
// item's strips, of a strip past the last, or past a short last strip).
__device__ __forceinline__ int strip_pixel(const ConvParams& p, int item,
                                           int m) {
  const int per = p.strip_rows * p.width;
  const int g = m / per;
  if (g >= p.strips_per_block) return -1;
  const int rem = m - g * per;
  const int yy = rem / p.width;
  const int xx = rem - yy * p.width;
  const int st = item * p.strips_per_block + g;
  if (st >= p.total_strips) return -1;
  const int img = st / p.strips_per_image;
  const int y0 = (st - img * p.strips_per_image) * p.strip_rows;
  if (y0 + yy >= p.height) return -1;
  return (img * p.height + y0 + yy) * p.width + xx;
}

template <int kTaps, int kMode, int kBN, bool kResident>
__global__ void __launch_bounds__(kThreads, 1)
    conv_stats_bf16_kernel(const ConvParams p) {
  using Tl = Tile<kBN>;
  using Pp = Pipe<kTaps>;
  constexpr int kBM = Tl::kBM;
  constexpr int kN8 = Tl::kN8;
  extern __shared__ __align__(128) unsigned char smem[];
  const int a_elems = p.a_rows * kLdA;
  bf16* a_ring = reinterpret_cast<bf16*>(smem);
  bf16* w_ring = a_ring + Pp::kSA * a_elems;
  bf16* stage_all = w_ring + w_stages<kTaps>(kResident) * Tl::kWElems;
  float* red = reinterpret_cast<float*>(stage_all + kWarps * 16 * Tl::kLdS);
  int* rowtab = reinterpret_cast<int*>(red + 2 * Tl::kWarpsM * kBN);
  uint32_t* masks = reinterpret_cast<uint32_t*>(rowtab + kBM);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int warp_m = warp / Tl::kWarpsN;
  const int warp_n = warp - warp_m * Tl::kWarpsN;
  const int g = lane >> 2, t4 = lane & 3;
  const int n0 = blockIdx.y * kBN;
  const int nc = (p.cin + kKC - 1) / kKC;
  const int my_items = p.items > static_cast<int>(blockIdx.x)
                           ? (p.items - 1 - blockIdx.x) / gridDim.x + 1
                           : 0;
  const int total_chunks = my_items * nc;
  const int total_steps = total_chunks * kTaps;
  // This thread's 8 channels of every staged 64-channel chunk.
  const int cv = (tid & 7) * 8;
  const int hw = p.width + 2 * (kTaps == 9);           // halo row length
  const int hr = p.strip_rows + 2 * (kTaps == 9);      // halo rows a strip
  const int layout = kTaps == 1 ? kBM
                                : p.strips_per_block * p.strip_rows * p.width;

  // The warp's four m16 bands of rows: B5's are rows 64 warp_m..+63; B6's
  // bands warp_m, warp_m + kWarpsM, .., so that the bands holding pixels
  // of a layout shorter than the tile spread evenly over the warps. A
  // fragment addresses: lane (l & 15) gives row (l & 15) of band i; for B6
  // the row of its output pixel's centre in the halo.
  auto band = [&](int i) {
    return kTaps == 1 ? 4 * warp_m + i : warp_m + Tl::kWarpsM * i;
  };
  int a_off[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = 16 * band(i) + (lane & 15);
    int base = m;
    if constexpr (kTaps == 9) {
      if (m < layout) {
        const int per = p.strip_rows * p.width;
        const int gs = m / per;
        const int rem = m - gs * per;
        const int yy = rem / p.width;
        base = (gs * hr + yy + 1) * hw + rem - yy * p.width + 1;
      } else {
        base = hw + 1;  // any pixel whose nine taps stay in the tile
      }
    }
    a_off[i] = base * kLdA + (lane >> 4) * 8;
  }
  // Bands of this warp that hold pixels of the layout (all four in B5).
  const int bands =
      kTaps == 1 ? 4
                 : min(4, max(0, ((layout + 15) / 16 - warp_m + Tl::kWarpsM -
                                  1) / Tl::kWarpsM));

  auto item_of = [&](int item_local) {
    return static_cast<int>(blockIdx.x) + item_local * gridDim.x;
  };

  // A chunk a (item a / nc, channels (a % nc) * 64..) into its stage, zero
  // where out of range; each thread records which of its copies are real.
  auto load_a = [&](int a) {
    const int item = item_of(a / nc);
    const int k = (a % nc) * kKC + cv;
    const int slot = a % Pp::kSA;
    bf16* dst = a_ring + slot * a_elems;
    uint32_t mask = 0;
    if constexpr (kTaps == 1) {
#pragma unroll
      for (int j = 0; j < kBM / 32; ++j) {
        const int r = (tid >> 3) + 32 * j;
        const int row = item * kBM + r;
        const bool in = row < p.n && k < p.cin;
        cp_async16(dst + r * kLdA + cv,
                   in ? p.x + static_cast<size_t>(row) * p.cin + k : p.x, in);
        mask |= static_cast<uint32_t>(in) << j;
      }
    } else {
      // Halo pixel hp = (tid >> 3) + 32 j as (strip gs, row hy, column
      // hx), stepped 32 pixels at a time; a strip's image and first row
      // are recomputed only where gs changes.
      int hp = tid >> 3;
      int gs = hp / (hr * hw);
      int hy = (hp - gs * hr * hw) / hw;
      int hx = hp - (gs * hr + hy) * hw;
      int cur = -1, img = 0, y0 = 0;
      bool live = false;
      for (int j = 0; hp < p.a_rows; ++j) {
        if (gs != cur) {
          cur = gs;
          const int st = item * p.strips_per_block + gs;
          live = st < p.total_strips && k < p.cin;
          img = st / p.strips_per_image;
          y0 = (st - img * p.strips_per_image) * p.strip_rows - 1;
        }
        const int gy = y0 + hy, gx = hx - 1;
        const bool in = live && gy >= 0 && gy < p.height && gx >= 0 &&
                        gx < p.width;
        cp_async16(dst + hp * kLdA + cv,
                   in ? p.x + (static_cast<size_t>(img * p.height + gy) *
                                   p.width + gx) * p.cin + k
                      : p.x,
                   in);
        mask |= static_cast<uint32_t>(in) << j;
        hp += 32;
        for (hx += 32; hx >= hw; hx -= hw) {
          if (++hy == hr) {
            hy = 0;
            ++gs;
          }
        }
      }
    }
    masks[slot * kThreads + tid] = mask;
  };

  // The prologue over this thread's real copies of A chunk a, once landed.
  auto prologue = [&](int a) {
    const int slot = a % Pp::kSA;
    const uint32_t mask = masks[slot * kThreads + tid];
    if (!mask) return;
    const int k = (a % nc) * kKC + cv;
    bf16* dst = a_ring + slot * a_elems + cv;
    if constexpr (kMode == kF32) {
      float sc[8], sh[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        sc[e] = __ldg(p.scale + k + e);
        sh[e] = __ldg(p.shift + k + e);
      }
      for (uint32_t mm = mask; mm; mm &= mm - 1) {
        const int j = __ffs(mm) - 1;
        uint4* ptr = reinterpret_cast<uint4*>(dst + ((tid >> 3) + 32 * j) *
                                                        kLdA);
        uint4 v = *ptr;
        uint32_t* u = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const __nv_bfloat162 h =
              *reinterpret_cast<const __nv_bfloat162*>(&u[e]);
          const float lo = fmaxf(
              __fadd_rn(__fmul_rn(__low2float(h), sc[2 * e]), sh[2 * e]),
              0.f);
          const float hi = fmaxf(__fadd_rn(__fmul_rn(__high2float(h),
                                                     sc[2 * e + 1]),
                                           sh[2 * e + 1]),
                                 0.f);
          u[e] = pack_bf16(lo, hi);
        }
        *ptr = v;
      }
    } else if constexpr (kMode == kOperand) {
      uint32_t sc[4], sh[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[e] = pack_bf16(__ldg(p.scale + k + 2 * e),
                          __ldg(p.scale + k + 2 * e + 1));
        sh[e] = pack_bf16(__ldg(p.shift + k + 2 * e),
                          __ldg(p.shift + k + 2 * e + 1));
      }
      for (uint32_t mm = mask; mm; mm &= mm - 1) {
        const int j = __ffs(mm) - 1;
        uint4* ptr = reinterpret_cast<uint4*>(dst + ((tid >> 3) + 32 * j) *
                                                        kLdA);
        uint4 v = *ptr;
        uint32_t* u = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          u[e] = bf2_relu(bf2_add(bf2_mul(u[e], sc[e]), sh[e]));
        *ptr = v;
      }
    }
  };

  // The weight tile of (chunk c, tap) into weight stage `slot`.
  auto load_w = [&](int c, int tap, int slot) {
    const int kr0 = c * kKC;
    bf16* dst = w_ring + slot * Tl::kWElems;
    const bf16* src =
        p.w + (static_cast<size_t>(tap) * p.cin + kr0) * p.fout + n0;
    for (int v = tid; v < kKC * (kBN / 8); v += kThreads) {
      const int kr = v / (kBN / 8);
      const int c8 = (v - kr * (kBN / 8)) * 8;
      const bool in = kr0 + kr < p.cin && n0 + c8 < p.fout;
      cp_async16(dst + kr * Tl::kLdB + c8,
                 in ? src + static_cast<size_t>(kr) * p.fout + c8 : p.w, in);
    }
  };

  // Group u of the ring: the weight tile of step u and, kD steps before its
  // first tap, A chunk a (chunk 0 with group 0).
  auto issue = [&](int u) {
    if (u < total_steps) {
      const int a = u / kTaps;
      load_w(a % nc, u - a * kTaps, u % Pp::kSW);
    }
    int a = -1;
    if (u == 0)
      a = 0;
    else if ((u + Pp::kD) % kTaps == 0)
      a = (u + Pp::kD) / kTaps;
    if (a >= 0 && a < total_chunks) load_a(a);
  };

  float acc[4][kN8][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kN8; ++j)
      acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;
  float blk_s = 0.f, blk_q = 0.f;  // column tid's sums over the items
  bf16* stage = stage_all + warp * 16 * Tl::kLdS;

  // The products of one tap over one staged chunk: 4 k16 slices. The
  // tensor cores add into their f32 accumulator truncating, so a chain of
  // 9 x f products drifts toward zero: B6 with more than one chunk (up to
  // 4608 products an output) sums each step from zero, a band pair at a
  // time, and adds it to the running sum with a rounded add.
  auto products = [&](const bf16* A, int tap, const bf16* W) {
    int tap_off = 0;
    if constexpr (kTaps == 9)
      tap_off = ((tap / 3 - 1) * hw + tap % 3 - 1) * kLdA;
    if constexpr (kTaps == 9 && !kResident) {
#pragma unroll
      for (int hp = 0; hp < 2; ++hp) {
        if (2 * hp < bands) {
          float part[2][kN8][4];
#pragma unroll
          for (int kk = 0; kk < kKC / 16; ++kk) {
            uint32_t af[2][4];
#pragma unroll
            for (int ii = 0; ii < 2; ++ii)
              if (2 * hp + ii < bands)
                ldsm_x4(af[ii], A + a_off[2 * hp + ii] + tap_off + 16 * kk);
#pragma unroll
            for (int jp = 0; jp < kN8 / 2; ++jp) {
              uint32_t b[4];
              ldsm_x4_t(b, W + (16 * kk + (lane & 15)) * Tl::kLdB +
                               warp_n * Tl::kWN + 16 * jp + (lane >> 4) * 8);
#pragma unroll
              for (int ii = 0; ii < 2; ++ii) {
                if (2 * hp + ii < bands) {
                  if (kk == 0) {
                    mma16816_z(part[ii][2 * jp], af[ii], b[0], b[1]);
                    mma16816_z(part[ii][2 * jp + 1], af[ii], b[2], b[3]);
                  } else {
                    mma16816(part[ii][2 * jp], af[ii], b[0], b[1]);
                    mma16816(part[ii][2 * jp + 1], af[ii], b[2], b[3]);
                  }
                }
              }
            }
          }
#pragma unroll
          for (int ii = 0; ii < 2; ++ii)
            if (2 * hp + ii < bands)
#pragma unroll
              for (int j = 0; j < kN8; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e)
                  acc[2 * hp + ii][j][e] =
                      __fadd_rn(acc[2 * hp + ii][j][e], part[ii][j][e]);
        }
      }
      return;
    }
#pragma unroll
    for (int kk = 0; kk < kKC / 16; ++kk) {
      uint32_t af[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (i < bands) ldsm_x4(af[i], A + a_off[i] + tap_off + 16 * kk);
#pragma unroll
      for (int jp = 0; jp < kN8 / 2; ++jp) {
        uint32_t b[4];
        ldsm_x4_t(b, W + (16 * kk + (lane & 15)) * Tl::kLdB +
                         warp_n * Tl::kWN + 16 * jp + (lane >> 4) * 8);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (i < bands) {
            mma16816(acc[i][2 * jp], af[i], b[0], b[1]);
            mma16816(acc[i][2 * jp + 1], af[i], b[2], b[3]);
          }
        }
      }
    }
  };

  // Epilogue of an item: y and the column sums from the accumulators, which
  // it then clears.
  auto epilogue = [&](int item) {
    for (int m = tid; m < kBM; m += kThreads) {
      if constexpr (kTaps == 1) {
        const int row = item * kBM + m;
        rowtab[m] = row < p.n ? row : -1;
      } else {
        rowtab[m] = m < layout ? strip_pixel(p, item, m) : -1;
      }
    }
    __syncthreads();
    float cs[kN8][2], cq[kN8][2];
#pragma unroll
    for (int j = 0; j < kN8; ++j) cs[j][0] = cs[j][1] = cq[j][0] = cq[j][1] = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r0 = 16 * band(i);
      const bool v0 = rowtab[r0 + g] >= 0, v1 = rowtab[r0 + g + 8] >= 0;
#pragma unroll
      for (int j = 0; j < kN8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float x0 = v0 ? acc[i][j][e] : 0.f;
          const float x1 = v1 ? acc[i][j][2 + e] : 0.f;
          cs[j][e] += x0;
          cq[j][e] += x0 * x0;
          cs[j][e] += x1;
          cq[j][e] += x1 * x1;
        }
        *reinterpret_cast<uint32_t*>(stage + g * Tl::kLdS + 8 * j + 2 * t4) =
            pack_bf16(acc[i][j][0], acc[i][j][1]);
        *reinterpret_cast<uint32_t*>(stage + (g + 8) * Tl::kLdS + 8 * j +
                                     2 * t4) =
            pack_bf16(acc[i][j][2], acc[i][j][3]);
      }
      __syncwarp();
      // 16 rows x kWN columns, 16 bytes a lane, whole rows a pass.
      for (int idx = lane; idx < 16 * kN8; idx += 32) {
        const int r = idx / kN8;
        const int c8 = idx - r * kN8;
        const int row = rowtab[r0 + r];
        const int col = n0 + warp_n * Tl::kWN + 8 * c8;
        if (row >= 0 && col < p.fout)
          *reinterpret_cast<uint4*>(p.y + static_cast<size_t>(row) * p.fout +
                                    col) =
              *reinterpret_cast<const uint4*>(stage + r * Tl::kLdS + 8 * c8);
      }
      __syncwarp();
    }
    // Over the warp's rows: lanes g = 0..7 of each column pair, fixed tree.
#pragma unroll
    for (int j = 0; j < kN8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          cs[j][e] += __shfl_xor_sync(~0u, cs[j][e], off);
          cq[j][e] += __shfl_xor_sync(~0u, cq[j][e], off);
        }
      }
    }
    if (g == 0) {
#pragma unroll
      for (int j = 0; j < kN8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = warp_n * Tl::kWN + 8 * j + 2 * t4 + e;
          red[warp_m * kBN + c] = cs[j][e];
          red[(Tl::kWarpsM + warp_m) * kBN + c] = cq[j][e];
        }
      }
    }
    __syncthreads();
    if (tid < kBN) {
      float ss = 0.f, qq = 0.f;
#pragma unroll
      for (int wm = 0; wm < Tl::kWarpsM; ++wm) {
        ss += red[wm * kBN + tid];
        qq += red[(Tl::kWarpsM + wm) * kBN + tid];
      }
      blk_s += ss;
      blk_q += qq;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < kN8; ++j)
        acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;
  };

  if constexpr (kResident) {
    // Every chunk is an item: the kTaps weight tiles load once, with A
    // chunk 0; one barrier a chunk, its taps back to back.
    if (total_chunks > 0) {
      for (int tap = 0; tap < kTaps; ++tap) load_w(0, tap, tap);
      load_a(0);
    }
    cp_async_commit();
    for (int a = 1; a < Pp::kSA - 1; ++a) {
      if (a < total_chunks) load_a(a);
      cp_async_commit();
    }
    for (int a = 0; a < total_chunks; ++a) {
      cp_async_wait<Pp::kSA - 2>();
      if constexpr (kMode != kNone) prologue(a);
      __syncthreads();
      if (a + Pp::kSA - 1 < total_chunks) load_a(a + Pp::kSA - 1);
      cp_async_commit();
      const bf16* A = a_ring + (a % Pp::kSA) * a_elems;
#pragma unroll 1
      for (int tap = 0; tap < kTaps; ++tap)
        products(A, tap, w_ring + tap * Tl::kWElems);
      epilogue(item_of(a));
    }
  } else {
    for (int u = 0; u < Pp::kL; ++u) {
      issue(u);
      cp_async_commit();
    }
    for (int s = 0; s < total_steps; ++s) {
      cp_async_wait<Pp::kL - 1>();
      const int a = s / kTaps;
      const int tap = s - a * kTaps;
      if constexpr (kMode != kNone) {
        if (tap == 0) prologue(a);
      }
      __syncthreads();
      issue(s + Pp::kL);
      cp_async_commit();
      products(a_ring + (a % Pp::kSA) * a_elems, tap,
               w_ring + (s % Pp::kSW) * Tl::kWElems);
      if (tap == kTaps - 1 && a % nc == nc - 1) epilogue(item_of(a / nc));
    }
  }
  cp_async_wait<0>();

  if (tid < kBN && n0 + tid < p.fout) {
    p.part_s[static_cast<size_t>(blockIdx.x) * p.fout + n0 + tid] = blk_s;
    p.part_q[static_cast<size_t>(blockIdx.x) * p.fout + n0 + tid] = blk_q;
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

int reduce(void* part_s, void* part_q, void* s, void* q, int groups,
           int fout, cudaStream_t stream) {
  stats_reduce_kernel<<<(fout + 31) / 32, dim3(32, kReduceRows), 0,
                        stream>>>(static_cast<const float*>(part_s),
                                  static_cast<const float*>(part_q), groups,
                                  fout, static_cast<float*>(s),
                                  static_cast<float*>(q));
  return static_cast<int>(cudaGetLastError());
}

template <int kTaps, int kMode>
int launch_f32(const void* x, const void* w, const void* scale,
               const void* shift, void* y, void* part_s, void* part_q,
               void* s, void* q, int n, int cin, int fout, int height,
               int width, int groups, cudaStream_t stream) {
  const dim3 grid(groups, (fout + kBNF - 1) / kBNF);
  conv_stats_f32_kernel<kTaps, kMode><<<grid, kThreadsF, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(scale), static_cast<const float*>(shift),
      static_cast<float*>(y), static_cast<float*>(part_s),
      static_cast<float*>(part_q), n, cin, fout, height, width);
  if (cudaError_t err = cudaGetLastError()) return static_cast<int>(err);
  return reduce(part_s, part_q, s, q, groups, fout, stream);
}

// The bf16 launch of a plan made by ops/fused_resnet_block.py: grid
// (groups, column tiles), `smem` bytes, which must be what this source
// computes for the plan.
template <int kTaps, int kMode, int kBN, bool kResident>
int launch_bf16(const ConvParams& p, int groups, int smem, void* s, void* q,
                cudaStream_t stream) {
  if (kResident != (p.cin <= kKC) ||
      smem != smem_bytes<kTaps, kBN>(p.a_rows, kResident) ||
      smem > kMaxSmem || p.a_rows * 8 > 32 * kThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = conv_stats_bf16_kernel<kTaps, kMode, kBN, kResident>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(groups, (p.fout + kBN - 1) / kBN), kThreads, smem, stream>>>(
      p);
  if ((err = cudaGetLastError())) return static_cast<int>(err);
  return reduce(p.part_s, p.part_q, s, q, groups, p.fout, stream);
}

// B5: row tiles of the column tile's kBM rows; resident weights where one
// chunk covers cin.
template <int kMode, int kBN>
int launch_matmul(ConvParams& p, int groups, int smem, void* s, void* q,
                  cudaStream_t stream) {
  p.a_rows = Tile<kBN>::kBM;
  p.items = (p.n + p.a_rows - 1) / p.a_rows;
  return p.cin <= kKC
             ? launch_bf16<1, kMode, kBN, true>(p, groups, smem, s, q, stream)
             : launch_bf16<1, kMode, kBN, false>(p, groups, smem, s, q,
                                                 stream);
}

int check_dims(int n, int cin, int fout, int groups, int dtype) {
  const int vec = dtype == 1 ? 8 : 4;
  if (n <= 0 || cin <= 0 || fout <= 0 || groups <= 0 || cin % vec ||
      fout % vec || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

ConvParams params(const void* x, const void* w, const void* scale,
                  const void* shift, void* y, void* part_s, void* part_q,
                  int n, int cin, int fout) {
  ConvParams p{};
  p.x = static_cast<const bf16*>(x);
  p.w = static_cast<const bf16*>(w);
  p.scale = static_cast<const float*>(scale);
  p.shift = static_cast<const float*>(shift);
  p.y = static_cast<bf16*>(y);
  p.part_s = static_cast<float*>(part_s);
  p.part_q = static_cast<float*>(part_q);
  p.n = n;
  p.cin = cin;
  p.fout = fout;
  return p;
}

}  // namespace

// Pointers: x (n, cin) [matmul_stats] or (b, h, w, f) [conv3x3_stats],
// contiguous, in the dtype (0 = f32, 1 = bf16), 16-byte aligned; w (cin,
// fout) or (3, 3, f, f) HWIO in the dtype; scale, shift (cin,) f32 (ignored
// by matmul_stats when prologue = 0); y (n, fout) in the dtype; part_s,
// part_q (groups, fout) f32 scratch; s, q (fout,) f32. cin and fout must be
// multiples of 8 (bf16) or 4 (f32). The launch plan comes from the wrapper
// (ops/fused_resnet_block.py): groups, the blocks along the rows; block_n,
// the column tile (f32: 64; bf16: 64, 128 or 256 for matmul_stats; for
// conv3x3_stats 64 where f <= 64, with resident weights, else 128);
// strip_rows and strips_per_block, B6's strips
// (bf16 only); smem, the bf16 kernel's dynamic shared bytes (f32: 0). Each
// returns cudaErrorInvalidValue for a plan it cannot run, else
// cudaGetLastError() after its launches (0 = launched).

extern "C" int matmul_stats(const void* x, const void* w, const void* scale,
                            const void* shift, void* y, void* part_s,
                            void* part_q, void* s, void* q, int n, int cin,
                            int fout, int groups, int block_n, int smem,
                            int prologue, int dtype, void* stream) {
  if (int err = check_dims(n, cin, fout, groups, dtype)) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (block_n != kBNF || smem != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    return prologue ? launch_f32<1, kF32>(x, w, scale, shift, y, part_s,
                                          part_q, s, q, n, cin, fout, 1, 1,
                                          groups, st)
                    : launch_f32<1, kNone>(x, w, scale, shift, y, part_s,
                                           part_q, s, q, n, cin, fout, 1, 1,
                                           groups, st);
  }
  ConvParams p = params(x, w, scale, shift, y, part_s, part_q, n, cin, fout);
  switch (block_n) {
    case 64:
      return prologue ? launch_matmul<kF32, 64>(p, groups, smem, s, q, st)
                      : launch_matmul<kNone, 64>(p, groups, smem, s, q, st);
    case 128:
      return prologue ? launch_matmul<kF32, 128>(p, groups, smem, s, q, st)
                      : launch_matmul<kNone, 128>(p, groups, smem, s, q, st);
    case 256:
      return prologue ? launch_matmul<kF32, 256>(p, groups, smem, s, q, st)
                      : launch_matmul<kNone, 256>(p, groups, smem, s, q, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int conv3x3_stats(const void* x, const void* w, const void* scale,
                             const void* shift, void* y, void* part_s,
                             void* part_q, void* s, void* q, int b,
                             int height, int width, int f, int groups,
                             int strip_rows, int strips_per_block,
                             int block_n, int smem, int dtype,
                             void* stream) {
  if (b <= 0 || height <= 0 || width <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n = b * height * width;
  if (int err = check_dims(n, f, f, groups, dtype)) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (block_n != kBNF || smem != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    return launch_f32<9, kOperand>(x, w, scale, shift, y, part_s, part_q, s,
                                   q, n, f, f, height, width, groups, st);
  }
  if (strip_rows <= 0 || strip_rows > height || strips_per_block <= 0 ||
      strips_per_block * strip_rows * width > Tile<128>::kBM)
    return static_cast<int>(cudaErrorInvalidValue);
  ConvParams p = params(x, w, scale, shift, y, part_s, part_q, n, f, f);
  p.height = height;
  p.width = width;
  p.strip_rows = strip_rows;
  p.strips_per_image = (height + strip_rows - 1) / strip_rows;
  p.strips_per_block = strips_per_block;
  p.total_strips = b * p.strips_per_image;
  p.items = (p.total_strips + strips_per_block - 1) / strips_per_block;
  p.a_rows = strips_per_block * (strip_rows + 2) * (width + 2);
  switch (block_n) {
    case 64:
      return launch_bf16<9, kOperand, 64, true>(p, groups, smem, s, q, st);
    case 128:
      return launch_bf16<9, kOperand, 128, false>(p, groups, smem, s, q, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
