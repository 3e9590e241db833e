// Gradient of the MoE grouped matmul (capacity layout) for NVIDIA Hopper
// (sm_90a), bf16 or f32 in and out.
//
// The backward of the kernels in gmm.cu, which replace the Pallas TPU kernel
// src/repro/kernels/moe_gmm/pallas_kernel.py::gmm_pallas.  The Pallas kernel
// has no backward: the JAX package differentiates its plain einsum
// (src/repro/kernels/moe_gmm/ref.py; XLA's einsum off the TPU,
// moe_gmm/ops.py:24-25).  From x (E, C, D), w (E, D, F), the sizes (E,)
// int32 on the device and the output gradient dy (E, C, F), per expert e,
// with dy masked to its live rows r < size_e = min(max(sizes[e], 0), C):
//   dx[e] = mask(dy[e]) . w[e]^T   (E, C, D); rows r >= size_e exactly 0
//   dw[e] = x[e]^T . mask(dy[e])   (E, D, F); summed over live rows only
// with f32 accumulation, rounded to the inputs' dtype.  dy's padding rows
// may hold anything (the model gives zeros there; the kernels never read
// them), and so may x's.
//
// What bounds it on an H100.  At qwen3-moe-30b-a3b's train microbatch
// (E=128, C=80, D=2048, F=768, 1024 tokens top-8: 8192 live rows) each
// product does 2 * 8192 * 2048 * 768 = 2.6e10 flops (0.026 ms at the bf16
// tensor-core peak) but moves the experts' weights once: dx reads w,
// 403 MB, dw writes 403 MB, ~0.12 ms each at 3.35 TB/s.  So at the train
// shape both are bound by bytes, and the weight tensor sets the time.  At
// grok-1-314b's expert shape (E=8, C=1280, D=6144, F=32768, 4096 tokens
// top-2) each is 3.3e12 flops against 3.2 GB of w: bound by operations.
//
// Two kernels, one launch each:
//  * dx: one block per (expert, 128 rows, 128 columns of D), looping over F
//    64 deep at a time.  A row tile at or past the expert's size writes
//    zeros and returns before it loads anything; inside a tile, a warp's
//    16-row slices past the size issue no products and write zeros.  w is
//    read in its own (D, F) layout: a (128 D x 64 F) tile in shared memory
//    is the B operand column by column (F contiguous), loaded by ldmatrix
//    without a transpose, so no transposed copy of w is ever made.
//  * dw: one block per (expert, 128 rows of D, 128 columns of F), looping
//    over that expert's live rows only, 32 at a time (rows past the size
//    load as zeros).  There is no split over rows: no atomics, no second
//    pass, and the order of every sum is fixed by the shapes, so two calls
//    give bitwise-equal results.  An expert with size 0 reads nothing and
//    writes exact zeros.  The x tile (32 rows x 128 D) is the A operand
//    transposed, by ldmatrix.trans.
//  bf16 (both): 8 warps (4 x 2, each 32 x 64 outputs) of warp-level
//  mma.sync m16n8k16 with f32 accumulators, fed by cp.async (16 bytes a
//  thread, zero-filled past the ragged ends) through a ring in dynamic
//  shared memory (dx 3 stages, dw 4, so that a train microbatch's expert
//  of up to 96 live rows has every load in flight at once); rows are padded by 16 bytes so ldmatrix is free
//  of bank conflicts.  Shapes whose rows are not a multiple of 16 bytes
//  (D or F % 8 != 0) or whose pointers are not 16-byte aligned stage
//  through plain loads instead.  The outputs are staged as bf16 in the
//  ring once the K loop is done and written as 16-byte stores, whole
//  rows of the tile at a time (a dw call writes as many bytes as w holds);
//  the unaligned shapes write bf16 straight from the fragments.
//  f32 (both): CUDA-core FMAs in IEEE f32 (no TF32), 64 x 64 tiles, 4 x 4
//  outputs a thread: the path of the f32 tests, not of training.
// Every element offset is 64-bit: grok's dw holds 1.6e9 elements.
//
// Build (plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libgmm_bwd.so gmm_bwd.cu

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstddef>
#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

struct Shape {
  int E, C, D, F;
};

// The rows of expert e that hold tokens: min(max(group_sizes[e], 0), C).
__device__ __forceinline__ int live_size(const int* sizes, int e, int C) {
  return min(max(sizes[e], 0), C);
}

// ===================================================== bf16: tensor cores

namespace tc {

constexpr int kThreads = 256;   // 8 warps: 4 over rows x 2 over columns
constexpr int kWM = 4, kWN = 2;
constexpr int kBM = 128;        // output rows a block
constexpr int kBN = 128;        // output columns a block
constexpr int kBKx = 64;        // depth a stage, dx (F: 768 to 32768)
constexpr int kBKw = 32;        // depth a stage, dw (live rows: ~64 a train
                                // microbatch's expert)
constexpr int kStagesX = 3;     // ring stages, dx
constexpr int kStagesW = 4;     // ring stages, dw: a train microbatch's
                                // expert (K <= 96) issues all its loads at once
constexpr int kWTM = kBM / kWM;   // 32 rows a warp
constexpr int kWTN = kBN / kWN;   // 64 columns a warp
constexpr int kMT = kWTM / 16;    // mma row tiles a warp
constexpr int kNT = kWTN / 8;     // mma column tiles a warp
static_assert(kWM * kWN * 32 == kThreads, "one warp per warp tile");
static_assert(kNT % 2 == 0, "B fragments load two column tiles at a time");

// dx: the dy tile [kBM rows][kBKx deep] and the w tile [kBN columns of D]
// [kBKx deep], both depth-contiguous, rows padded to kKS elements (144
// bytes)
constexpr int kKS = kBKx + 8;
constexpr int kDxStage = (kBM + kBN) * kKS;   // elements
// dw: the x tile [kBKw rows][kBM of D] and the dy tile [kBKw rows][kBN of
// F], rows padded to kMS elements (272 bytes)
constexpr int kMS = kBM + 8;
static_assert(kBN + 8 == kMS, "both dw tiles share one row stride");
constexpr int kDwStage = 2 * kBKw * kMS;      // elements
// the epilogue stages the block's bf16 outputs [kBM][kMS] in the ring
constexpr int kOutElems = kBM * kMS;
constexpr int kDxSmem = kStagesX * kDxStage * (int)sizeof(bf16);  // 110,592
constexpr int kDwSmem = kStagesW * kDwStage * (int)sizeof(bf16);  // 69,632
static_assert(2 * kDxSmem <= 232448 && 2 * kDwSmem <= 232448,
              "two blocks' rings exceed an SM's shared memory");
static_assert(kOutElems <= kStagesX * kDxStage &&
              kOutElems <= kStagesW * kDwStage,
              "the output tile does not fit in the ring");

__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// c (16x8 f32) += a (16x16 bf16, row) . b (16x8 bf16, col)
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 b16 matrices; lane l gives the address of row l % 8 of matrix
// l / 8.  Without .trans lane l receives (row l / 4, columns 2 (l % 4) and
// 2 (l % 4) + 1) of each; with .trans the same of the transposed matrix.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const bf16* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(row)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const bf16* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(row)));
}

// Zeros for output rows [r0, r1) and columns [n0, n0 + kBN) of a row-major
// (rows, cols) matrix at o.  VEC: cols % 8 == 0 and o 16-byte aligned.
template <bool VEC>
__device__ __forceinline__ void zero_tile(bf16* o, int r0, int r1, int n0,
                                          int cols) {
  const int tid = threadIdx.x;
  if (VEC) {
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
    for (int idx = tid; idx < (r1 - r0) * (kBN / 8); idx += kThreads) {
      const int r = r0 + idx / (kBN / 8), n = n0 + (idx % (kBN / 8)) * 8;
      if (n < cols) *reinterpret_cast<uint4*>(o + (size_t)r * cols + n) = zero;
    }
  } else {
    const bf16 zero = __float2bfloat16(0.f);
    for (int idx = tid; idx < (r1 - r0) * kBN; idx += kThreads) {
      const int r = r0 + idx / kBN, n = n0 + idx % kBN;
      if (n < cols) o[(size_t)r * cols + n] = zero;
    }
  }
}

// Fragment layout of mma.m16n8k16 (PTX ISA): with g = lane / 4 and
// t = lane % 4, a thread holds rows g and g + 8 of the 16 x 8 result at
// columns 2t and 2t + 1 (c[0], c[1] for row g; c[2], c[3] for row g + 8).
// Writes the block's accumulators to rows [m0, rows) and columns
// [n0, cols) of the row-major (., cols) matrix o; rows at or past `live`
// as zeros.  VEC: the tile goes as bf16 pairs into shared memory at
// `stage` (the ring, free once every warp left the K loop; rows padded to
// kMS elements, so the pairs meet no bank conflict) and from there as
// 16-byte stores, 16 threads to a 256-byte row; else as pairs or single
// elements straight from the fragments.
template <bool VEC>
__device__ __forceinline__ void store_tile(const float (&acc)[kMT][kNT][4],
                                           bf16* o, int m0, int n0, int rows,
                                           int live, int cols, bf16* stage) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = warp / kWN, wn = warp % kWN;
  if (VEC) __syncthreads();   // every warp is done with the ring
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      const int tc = wn * kWTN + j * 8 + 2 * t, col = n0 + tc;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int tr = wm * kWTM + i * 16 + g + 8 * h, r = m0 + tr;
        const bool ok = r < live;
        const float v0 = ok ? acc[i][j][2 * h] : 0.f;
        const float v1 = ok ? acc[i][j][2 * h + 1] : 0.f;
        if (VEC) {
          *reinterpret_cast<__nv_bfloat162*>(stage + tr * kMS + tc) =
              __floats2bfloat162_rn(v0, v1);
          continue;
        }
        if (r >= rows || col >= cols) continue;
        bf16* dst = o + (size_t)r * cols + col;
        dst[0] = __float2bfloat16(v0);
        if (col + 1 < cols) dst[1] = __float2bfloat16(v1);
      }
    }
  if (!VEC) return;
  __syncthreads();
  // cols % 8 == 0: a 16-byte chunk lies inside or wholly past the row
  for (int idx = threadIdx.x; idx < kBM * (kBN / 8); idx += kThreads) {
    const int tr = idx / (kBN / 8), tc = (idx % (kBN / 8)) * 8;
    const int r = m0 + tr, col = n0 + tc;
    if (r < rows && col < cols)
      *reinterpret_cast<uint4*>(o + (size_t)r * cols + col) =
          *reinterpret_cast<const uint4*>(stage + tr * kMS + tc);
  }
}

__device__ __forceinline__ void zero_acc(float (&acc)[kMT][kNT][4]) {
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
      acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;
}

// The K loop shared by both kernels: a ring of STAGES stages of BK deep,
// STAGES - 1 of them in flight, loaded by load(stage, k0) and consumed by
// step(stage) after every thread's copies of that stage have landed.
template <int BK, int STAGES, typename Load, typename Step>
__device__ __forceinline__ void pipeline(int KT, Load load, Step step) {
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < KT) load(st, st * BK);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES - 2>();    // this thread's copies of tile kt landed
    __syncthreads();                // everyone's did; tile kt-1 is consumed
    const int next = kt + STAGES - 1;
    if (next < KT) load(next % STAGES, next * BK);
    cp_async_commit();
    step(kt % STAGES);
  }
  cp_async_wait<0>();
}

// dx[e, r, n] = sum_f dy[e, r, f] w[e, n, f] for r < size, else 0.
// Block: expert blockIdx.z, rows blockIdx.x * kBM, D columns blockIdx.y * kBN.
template <bool VEC>
__global__ void __launch_bounds__(kThreads, 2)
gmm_bwd_dx_tc(const bf16* __restrict__ dy, const bf16* __restrict__ w,
              const int* __restrict__ sizes, bf16* __restrict__ dx, Shape s) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int e = blockIdx.z;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int tid = threadIdx.x;
  const int size = live_size(sizes, e, s.C);
  bf16* o = dx + (size_t)e * s.C * s.D;
  if (m0 >= size) {   // dead tile: zeros, and not one byte of w read
    zero_tile<VEC>(o, m0, min(m0 + kBM, s.C), n0, s.D);
    return;
  }
  const bf16* dye = dy + (size_t)e * s.C * s.F;
  const bf16* we = w + (size_t)e * s.D * s.F;
  const int live_rows = min(kBM, size - m0);   // rows of the tile with tokens

  auto load = [&](int stage, int k0) {
    bf16* a = smem + stage * kDxStage;
    bf16* b = a + kBM * kKS;
    if (VEC) {
      for (int idx = tid; idx < kBM * (kBKx / 8); idx += kThreads) {
        const int r = idx / (kBKx / 8), k = k0 + (idx % (kBKx / 8)) * 8;
        const bool ok = r < live_rows && k < s.F;
        cp_async16(a + r * kKS + (k - k0),
                   ok ? dye + (size_t)(m0 + r) * s.F + k : dye, ok);
      }
      for (int idx = tid; idx < kBN * (kBKx / 8); idx += kThreads) {
        const int n = idx / (kBKx / 8), k = k0 + (idx % (kBKx / 8)) * 8;
        const bool ok = n0 + n < s.D && k < s.F;
        cp_async16(b + n * kKS + (k - k0),
                   ok ? we + (size_t)(n0 + n) * s.F + k : we, ok);
      }
    } else {
      const bf16 zero = __float2bfloat16(0.f);
      for (int idx = tid; idx < kBM * kBKx; idx += kThreads) {
        const int r = idx / kBKx, k = k0 + idx % kBKx;
        a[r * kKS + (k - k0)] = r < live_rows && k < s.F
                                    ? dye[(size_t)(m0 + r) * s.F + k] : zero;
      }
      for (int idx = tid; idx < kBN * kBKx; idx += kThreads) {
        const int n = idx / kBKx, k = k0 + idx % kBKx;
        b[n * kKS + (k - k0)] = n0 + n < s.D && k < s.F
                                    ? we[(size_t)(n0 + n) * s.F + k] : zero;
      }
    }
  };

  const int warp = tid / 32, lane = tid % 32;
  const int wm = warp / kWN, wn = warp % kWN;
  float acc[kMT][kNT][4];
  zero_acc(acc);
  // this warp's 16-row slices that hold a live row
  const int live_mt = min(kMT, max(0, (live_rows - wm * kWTM + 15) / 16));

  auto step = [&](int stage) {
    if (live_mt == 0) return;
    const bf16* a_s = smem + stage * kDxStage;
    const bf16* b_s = a_s + kBM * kKS;
#pragma unroll
    for (int kk = 0; kk < kBKx; kk += 16) {
      // A (rows x deep, deep contiguous): matrix q = lane / 8 is rows
      // 8 (q & 1), deep 8 (q >> 1) of the 16 x 16 slice
      uint32_t a[kMT][4];
#pragma unroll
      for (int i = 0; i < kMT; ++i)
        if (i < live_mt)
          ldmatrix_x4(a[i], a_s + (wm * kWTM + i * 16 + (lane & 15)) * kKS +
                                kk + (lane >> 4) * 8);
#pragma unroll
      for (int j = 0; j < kNT; j += 2) {
        // B (deep x D columns) is the w tile [column][deep]: matrix q is
        // column tile j + (q >> 1), deep 8 (q & 1); no transpose needed
        uint32_t b[4];
        ldmatrix_x4(b, b_s + (wn * kWTN + j * 8 + (lane >> 4) * 8 +
                              (lane & 7)) * kKS +
                           kk + ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int i = 0; i < kMT; ++i)
          if (i < live_mt) {
            mma(acc[i][j], a[i], b[0], b[1]);
            mma(acc[i][j + 1], a[i], b[2], b[3]);
          }
      }
    }
  };
  pipeline<kBKx, kStagesX>((s.F + kBKx - 1) / kBKx, load, step);
  store_tile<VEC>(acc, o, m0, n0, s.C, size, s.D, smem);
}

// dw[e, m, n] = sum_{r < size} x[e, r, m] dy[e, r, n].
// Block: expert blockIdx.z, D rows blockIdx.x * kBM, F columns
// blockIdx.y * kBN; the loop runs over the expert's live rows only.
template <bool VEC>
__global__ void __launch_bounds__(kThreads, 2)
gmm_bwd_dw_tc(const bf16* __restrict__ x, const bf16* __restrict__ dy,
              const int* __restrict__ sizes, bf16* __restrict__ dw, Shape s) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int e = blockIdx.z;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int tid = threadIdx.x;
  const int size = live_size(sizes, e, s.C);
  bf16* o = dw + (size_t)e * s.D * s.F;
  if (size == 0) {   // an empty expert: zeros, and nothing read
    zero_tile<VEC>(o, m0, min(m0 + kBM, s.D), n0, s.F);
    return;
  }
  const bf16* xe = x + (size_t)e * s.C * s.D;
  const bf16* dye = dy + (size_t)e * s.C * s.F;

  auto load = [&](int stage, int k0) {
    bf16* a = smem + stage * kDwStage;
    bf16* b = a + kBKw * kMS;
    if (VEC) {
      for (int idx = tid; idx < kBKw * (kBM / 8); idx += kThreads) {
        const int k = idx / (kBM / 8), m = m0 + (idx % (kBM / 8)) * 8;
        const bool ok = k0 + k < size && m < s.D;
        cp_async16(a + k * kMS + (m - m0),
                   ok ? xe + (size_t)(k0 + k) * s.D + m : xe, ok);
      }
      for (int idx = tid; idx < kBKw * (kBN / 8); idx += kThreads) {
        const int k = idx / (kBN / 8), n = n0 + (idx % (kBN / 8)) * 8;
        const bool ok = k0 + k < size && n < s.F;
        cp_async16(b + k * kMS + (n - n0),
                   ok ? dye + (size_t)(k0 + k) * s.F + n : dye, ok);
      }
    } else {
      const bf16 zero = __float2bfloat16(0.f);
      for (int idx = tid; idx < kBKw * kBM; idx += kThreads) {
        const int k = idx / kBM, m = m0 + idx % kBM;
        a[k * kMS + (m - m0)] = k0 + k < size && m < s.D
                                    ? xe[(size_t)(k0 + k) * s.D + m] : zero;
      }
      for (int idx = tid; idx < kBKw * kBN; idx += kThreads) {
        const int k = idx / kBN, n = n0 + idx % kBN;
        b[k * kMS + (n - n0)] = k0 + k < size && n < s.F
                                    ? dye[(size_t)(k0 + k) * s.F + n] : zero;
      }
    }
  };

  const int warp = tid / 32, lane = tid % 32;
  const int wm = warp / kWN, wn = warp % kWN;
  float acc[kMT][kNT][4];
  zero_acc(acc);

  auto step = [&](int stage) {
    const bf16* a_s = smem + stage * kDwStage;
    const bf16* b_s = a_s + kBKw * kMS;
#pragma unroll
    for (int kk = 0; kk < kBKw; kk += 16) {
      // A (D rows x live rows) is the x tile [row][D] transposed: matrix q
      // is stored rows kk + 8 (q >> 1), D columns 8 (q & 1) of the slice
      uint32_t a[kMT][4];
#pragma unroll
      for (int i = 0; i < kMT; ++i)
        ldmatrix_x4_trans(a[i], a_s + (kk + (lane >> 4) * 8 + (lane & 7)) *
                                          kMS +
                                    wm * kWTM + i * 16 +
                                    ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int j = 0; j < kNT; j += 2) {
        // B (live rows x F) is the dy tile [row][F] transposed by ldmatrix:
        // matrix q is rows kk + 8 (q & 1), column tile j + (q >> 1)
        uint32_t b[4];
        ldmatrix_x4_trans(b, b_s + (kk + (lane & 15)) * kMS + wn * kWTN +
                                 j * 8 + (lane >> 4) * 8);
#pragma unroll
        for (int i = 0; i < kMT; ++i) {
          mma(acc[i][j], a[i], b[0], b[1]);
          mma(acc[i][j + 1], a[i], b[2], b[3]);
        }
      }
    }
  };
  pipeline<kBKw, kStagesW>((size + kBKw - 1) / kBKw, load, step);
  store_tile<VEC>(acc, o, m0, n0, s.D, s.D, s.F, smem);
}

}  // namespace tc

// ========================================================= f32: CUDA cores

namespace cc {

constexpr int kThreads = 256;      // 16 x 16 threads, 4 x 4 outputs each
constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 16;

// acc (4 x 4 a thread) += sA^T sB over kBK: sA [deep][row], sB [deep][col]
__device__ __forceinline__ void fma_tile(float (&acc)[4][4],
                                         const float (&sA)[kBK][kBM + 4],
                                         const float (&sB)[kBK][kBN + 4],
                                         int tx, int ty) {
#pragma unroll
  for (int k = 0; k < kBK; ++k) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = sA[k][ty * 4 + i];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = sB[k][tx * 4 + j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

__global__ void __launch_bounds__(kThreads)
gmm_bwd_dx_cc(const float* __restrict__ dy, const float* __restrict__ w,
              const int* __restrict__ sizes, float* __restrict__ dx,
              Shape s) {
  __shared__ float sA[kBK][kBM + 4];   // dy tile, transposed: [deep][row]
  __shared__ float sB[kBK][kBN + 4];   // w tile, transposed: [deep][D col]
  const int e = blockIdx.z;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int tid = threadIdx.x;
  const int size = live_size(sizes, e, s.C);
  float* o = dx + (size_t)e * s.C * s.D;
  if (m0 >= size) {   // dead tile: zeros, and not one byte of w read
    const int rows = min(kBM, s.C - m0);
    for (int idx = tid; idx < rows * kBN; idx += kThreads) {
      const int r = idx / kBN, n = n0 + idx % kBN;
      if (n < s.D) o[(size_t)(m0 + r) * s.D + n] = 0.f;
    }
    return;
  }
  const float* dye = dy + (size_t)e * s.C * s.F;
  const float* we = w + (size_t)e * s.D * s.F;
  const int live_rows = min(kBM, size - m0);
  const int tx = tid % 16, ty = tid / 16;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < s.F; k0 += kBK) {
#pragma unroll
    for (int it = 0; it < kBM * kBK / kThreads; ++it) {
      const int idx = tid + it * kThreads;
      const int r = idx / kBK, k = k0 + idx % kBK;
      sA[k - k0][r] = r < live_rows && k < s.F
                          ? dye[(size_t)(m0 + r) * s.F + k] : 0.f;
    }
#pragma unroll
    for (int it = 0; it < kBN * kBK / kThreads; ++it) {
      const int idx = tid + it * kThreads;
      const int n = idx / kBK, k = k0 + idx % kBK;
      sB[k - k0][n] = n0 + n < s.D && k < s.F
                          ? we[(size_t)(n0 + n) * s.F + k] : 0.f;
    }
    __syncthreads();
    fma_tile(acc, sA, sB, tx, ty);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = m0 + ty * 4 + i;
    if (r >= s.C) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < s.D) o[(size_t)r * s.D + n] = r < size ? acc[i][j] : 0.f;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
gmm_bwd_dw_cc(const float* __restrict__ x, const float* __restrict__ dy,
              const int* __restrict__ sizes, float* __restrict__ dw,
              Shape s) {
  __shared__ float sA[kBK][kBM + 4];   // x tile: [row][D col]
  __shared__ float sB[kBK][kBN + 4];   // dy tile: [row][F col]
  const int e = blockIdx.z;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int tid = threadIdx.x;
  const int size = live_size(sizes, e, s.C);
  const float* xe = x + (size_t)e * s.C * s.D;
  const float* dye = dy + (size_t)e * s.C * s.F;
  const int tx = tid % 16, ty = tid / 16;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < size; k0 += kBK) {
#pragma unroll
    for (int it = 0; it < kBM * kBK / kThreads; ++it) {
      const int idx = tid + it * kThreads;
      const int k = idx / kBM, m = m0 + idx % kBM;
      sA[k][m - m0] = k0 + k < size && m < s.D
                          ? xe[(size_t)(k0 + k) * s.D + m] : 0.f;
    }
#pragma unroll
    for (int it = 0; it < kBN * kBK / kThreads; ++it) {
      const int idx = tid + it * kThreads;
      const int k = idx / kBN, n = n0 + idx % kBN;
      sB[k][n - n0] = k0 + k < size && n < s.F
                          ? dye[(size_t)(k0 + k) * s.F + n] : 0.f;
    }
    __syncthreads();
    fma_tile(acc, sA, sB, tx, ty);
    __syncthreads();
  }
  float* o = dw + (size_t)e * s.D * s.F;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= s.D) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < s.F) o[(size_t)m * s.F + n] = acc[i][j];
    }
  }
}

}  // namespace cc

constexpr int kMaxDevices = 64;

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// The dynamic shared memory of the four bf16 instantiations is allowed
// once per device, so a launch costs the host nothing more.
int prepare_tc() {
  static std::atomic<bool> ready[kMaxDevices];
  int device;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (device >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (ready[device].load(std::memory_order_relaxed)) return 0;
  const cudaFuncAttribute a = cudaFuncAttributeMaxDynamicSharedMemorySize;
  if ((err = cudaFuncSetAttribute(tc::gmm_bwd_dx_tc<true>, a, tc::kDxSmem)) ||
      (err = cudaFuncSetAttribute(tc::gmm_bwd_dx_tc<false>, a, tc::kDxSmem)) ||
      (err = cudaFuncSetAttribute(tc::gmm_bwd_dw_tc<true>, a, tc::kDwSmem)) ||
      (err = cudaFuncSetAttribute(tc::gmm_bwd_dw_tc<false>, a, tc::kDwSmem)))
    return (int)err;
  ready[device].store(true, std::memory_order_relaxed);
  return 0;
}

template <bool VEC>
int launch_tc(const void* x, const void* w, const void* sizes, const void* dy,
              void* dx, void* dw, const Shape& s, cudaStream_t stream) {
  using namespace tc;
  const int* sz = static_cast<const int*>(sizes);
  if (dx) {
    const dim3 grid((s.C + kBM - 1) / kBM, (s.D + kBN - 1) / kBN, s.E);
    gmm_bwd_dx_tc<VEC><<<grid, kThreads, kDxSmem, stream>>>(
        static_cast<const bf16*>(dy), static_cast<const bf16*>(w), sz,
        static_cast<bf16*>(dx), s);
    if (int err = (int)cudaGetLastError()) return err;
  }
  if (dw) {
    const dim3 grid((s.D + kBM - 1) / kBM, (s.F + kBN - 1) / kBN, s.E);
    gmm_bwd_dw_tc<VEC><<<grid, kThreads, kDwSmem, stream>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(dy), sz,
        static_cast<bf16*>(dw), s);
    if (int err = (int)cudaGetLastError()) return err;
  }
  return 0;
}

int launch_cc(const void* x, const void* w, const void* sizes, const void* dy,
              void* dx, void* dw, const Shape& s, cudaStream_t stream) {
  using namespace cc;
  const int* sz = static_cast<const int*>(sizes);
  if (dx) {
    const dim3 grid((s.C + kBM - 1) / kBM, (s.D + kBN - 1) / kBN, s.E);
    gmm_bwd_dx_cc<<<grid, kThreads, 0, stream>>>(
        static_cast<const float*>(dy), static_cast<const float*>(w), sz,
        static_cast<float*>(dx), s);
    if (int err = (int)cudaGetLastError()) return err;
  }
  if (dw) {
    const dim3 grid((s.D + kBM - 1) / kBM, (s.F + kBN - 1) / kBN, s.E);
    gmm_bwd_dw_cc<<<grid, kThreads, 0, stream>>>(
        static_cast<const float*>(x), static_cast<const float*>(dy), sz,
        static_cast<float*>(dw), s);
    if (int err = (int)cudaGetLastError()) return err;
  }
  return 0;
}

}  // namespace

extern "C" {

// x (E, C, D), w (E, D, F), dy (E, C, F), dx (E, C, D), dw (E, D, F), all
// contiguous and of one dtype (0: float32, 1: bfloat16), E, C, D, F >= 1;
// sizes (E,) int32, on the device.  dx or dw may be null: that product is
// not launched.  vec = 1 states that D % 8 == F % 8 == 0 and every pointer
// is 16-byte aligned (checked here too).  Launches the dx kernel, then the
// dw kernel, on `stream`, does not synchronise, and returns the
// cudaError_t of the launches (0 on success).
int gmm_bwd(const void* x, const void* w, const void* sizes, const void* dy,
            void* dx, void* dw, int dtype, int E, int C, int D, int F,
            int vec, void* stream) {
  if (E <= 0 || C <= 0 || D <= 0 || F <= 0 || E > 65535)
    return (int)cudaErrorInvalidValue;
  // grid.y: D / 64 column tiles for dx, F / 64 for dw at most
  if ((D + 63) / 64 > 65535 || (F + 63) / 64 > 65535)
    return (int)cudaErrorInvalidValue;
  if (vec && (D % 8 || F % 8 || !aligned16(x) || !aligned16(w) ||
              !aligned16(dy) || (dx && !aligned16(dx)) ||
              (dw && !aligned16(dw))))
    return (int)cudaErrorInvalidValue;
  const Shape s{E, C, D, F};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_cc(x, w, sizes, dy, dx, dw, s, st);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  if (int err = prepare_tc()) return err;
  return vec ? launch_tc<true>(x, w, sizes, dy, dx, dw, s, st)
             : launch_tc<false>(x, w, sizes, dy, dx, dw, s, st);
}

const char* gmm_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
