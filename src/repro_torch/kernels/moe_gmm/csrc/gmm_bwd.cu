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
// may hold anything (the model gives zeros there), and so may x's: no
// padding value reaches a result.  No atomics and no split over K, so the
// order of every sum is fixed by the shapes and two calls are bitwise
// equal.  Every element offset is 64-bit: grok's dw holds 1.6e9 elements.
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
// Two products, one launch each, by one of three kernel pairs; the
// launcher picks them by the rule of `variant_of` (the Python wrapper's
// ops.bwd_variant states the same rule):
//  * wgmma (bf16, D % 8 == F % 8 == 0, 16-byte aligned pointers, E <= 1024,
//    C * D, C * F and D * F < 2^39 (tensor-map strides under 2^40 bytes),
//    fewer than 2^31 items a product): the training path.  Every kernel has
//    gmm.cu's forward shape: persistent and warp specialised, one block per
//    SM, one TMA producer warpgroup (one thread issues the loads, three
//    warps write the zeros no item covers) and two consumer warpgroups of
//    wgmma with f32 accumulators in registers; every block prefix-sums the
//    live items per expert from the sizes in shared memory and walks items
//    blockIdx.x, blockIdx.x + gridDim.x, ... (an expert's items are
//    adjacent, so the blocks that share its operands run together and
//    find them in L2); 3-D tensor maps with a 128-byte swizzle and 64 x 64
//    boxes; stages tracked by full and empty mbarriers.
//    - dx is the forward with B transposed: A = dy (an (F, C, E) map,
//      K-major), B = w as it lies ((F, D, E), F contiguous: K-major, so no
//      transposed copy is made, and no byte of w is read for a dead
//      expert), K = F, 64 deep a stage.  Items are (live expert, up to 384
//      rows, 128 columns of D) in 3 stages of 64 KB, or at C <= 128 up to
//      128 rows in 6 stages of 32 KB: no stage then holds dy boxes that no
//      row fills, and twice the bytes are in flight.  Only the 64-row boxes
//      of dy that hold live rows are loaded and multiplied; the epilogue
//      writes real rows below the size and zeros above by stmatrix into
//      the last ring stage and 16-byte stores; rows past the size rounded
//      up to 64, and dead experts, are zeroed by the producer's idle warps.
//    - dw: K = the expert's live rows, 64 a stage, only the boxes that
//      hold live rows loaded.  A = x^T from x's (rows x D) box: MN-major,
//      wgmma's transpose-A; B = dy's (rows x F) boxes, MN-major.  A
//      consumer's tile is 64 rows of D x 256 columns of F: one m64n256k16
//      a k16 step, 128 accumulators a thread.  In the last box, rows
//      [size, box end) of both operands are zeroed in shared memory
//      before the products read them (0 . NaN is NaN).  The epilogue
//      rounds to bf16 and stores each 64 x 64 box by TMA (a third map,
//      (F, D, E) on dw) from a staging slot that stmatrix fills, one bulk
//      group a box, so a box's store runs on under the next box and the
//      next item; a slot is rewritten only after its group has read it.
//      Above C = 128 an item is 128 rows of D (both consumers, one x box
//      each, sharing the dy tile) in 3 stages of 48 KB, 4 slots a
//      consumer.  At C <= 128, where an item's K is one or two boxes, the
//      consumers play ping-pong: each takes every other item, 64 rows of
//      D, through its own 2 stages of 40 KB, loaded by its own producer
//      thread, and its own 2 slots, so one consumer's tail zeroing and
//      epilogue run under the other's products (on the H100, faster at
//      the train shapes and slower at eval and grok, whose longer K wants
//      the shared dy tile).  F tile 256, not 128: at 85 flops a byte of
//      operand staged (64 at 128) it serves grok's dw, which is bound by
//      operations (on the H100, 128 was slower there and at the train
//      shape).  An empty expert's dw is written as zeros by the producer's
//      idle warps, with nothing read.
//  * mma_sync (bf16 the wgmma kernels do not take): dx one block per
//    (expert, 128 rows, 128 columns of D), looping over F 64 deep; a row
//    tile at or past the size writes zeros and returns before it loads
//    anything.  dw one block per (expert, 128 rows of D, 128 columns of F),
//    looping over the expert's live rows, 32 at a time (rows past the
//    size load as zeros); an empty expert reads nothing and writes zeros.
//    8 warps (4 x 2, each 32 x 64 outputs) of warp-level mma.sync m16n8k16,
//    fed by cp.async (16 bytes a thread, zero-filled past the ragged ends)
//    through rings of 3 (dx) and 4 (dw) stages; w's (D, F) rows are the B
//    operand of dx as they lie, dw's x tile is A transposed by
//    ldmatrix.trans.  Outputs are staged as bf16 in the ring and written
//    as 16-byte stores.  Shapes whose rows are not a multiple of 16 bytes
//    (D or F % 8 != 0) or whose pointers are not 16-byte aligned stage
//    through plain loads and write bf16 straight from the fragments.
//  * f32: CUDA-core FMAs in IEEE f32 (no TF32), 64 x 64 tiles, 4 x 4
//    outputs a thread: the path of the f32 tests, not of training.
//
// Build (plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libgmm_bwd.so gmm_bwd.cu

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstddef>
#include <cstdint>

#include "../../common/hopper.cuh"

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

// ===================================================== bf16: wgmma and TMA

namespace wg {

using namespace hopper;

constexpr int kConsumers = 2;                      // consumer warpgroups
constexpr int kThreads = 128 * (kConsumers + 1);   // + one producer warpgroup
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;   // 2 x 128 x 240 + 128 x 24 <= 65536
constexpr int kMaxE = 1024;          // experts staged in shared memory
constexpr int kBK = 64;              // depth a stage (128 bytes of bf16)
constexpr uint32_t kBoxBytes = 64 * 128;   // one TMA box: 64 rows of 64 bf16

// alignment slack, the ring, the staging slots, full and empty barriers,
// the sizes and the item prefix sum
constexpr size_t smem_bytes(int stages, uint32_t stage_bytes,
                            uint32_t out_bytes) {
  return 1024 + size_t(stages) * stage_bytes + out_bytes + 8 * 2 * stages +
         4 * (2 * kMaxE + 1);
}
constexpr size_t kMaxSmem = 232448;   // a block's shared memory

// dx's items: up to 64 * kBoxes rows x kDxN columns of D; a stage holds
// their dy boxes and w's kDxN columns, 64 deep.  MT = 3 (384 rows, 3
// stages; gmm.cu's forward tile) reads each w tile for the most rows, as
// grok-1-314b's C = 1280 needs; MT = 1 (128 rows) for C <= kSmallC, where
// an expert's live rows fit one item: the stage holds no dead boxes, so six
// of them fit and twice the bytes are in flight (on the H100, faster at
// qwen3's train microbatch and far slower at grok's).
constexpr int kDxN = 128;
constexpr int kSmallC = 128;   // C at or below it takes Dx<1>
template <int MT>
struct Dx {
  static constexpr int kMT = MT;                    // boxes a consumer
  static constexpr int kBoxes = MT * kConsumers;    // dy boxes an item
  static constexpr int kRM = 64 * kBoxes;           // rows an item
  static constexpr int kStages = MT == 1 ? 6 : 3;
  static constexpr uint32_t kABytes = kBoxes * kBoxBytes;                 // dy
  static constexpr uint32_t kStageBytes = kABytes + (kDxN / 64) * kBoxBytes;
  static constexpr size_t kSmem = smem_bytes(kStages, kStageBytes, 0);
  static_assert(kSmem <= kMaxSmem, "the ring exceeds a block's shared memory");
  static_assert(kABytes % 1024 == 0 && kStageBytes % 1024 == 0,
                "every box starts on a 1024-byte swizzle atom");
};

// dw's items: 128 rows of D (64 a consumer) x 256 columns of F; a stage
// holds their x box pair and dy tile over 64 rows, and each consumer
// stages its 64 x 256 outputs in four 64 x 64 slots.
constexpr int kDwM = 64 * kConsumers;
constexpr int kDwN = 256;
constexpr int kDwStages = 3;
constexpr uint32_t kDwABytes = kConsumers * kBoxBytes;                 // x
constexpr uint32_t kDwStageBytes = kDwABytes + (kDwN / 64) * kBoxBytes;   // + dy
constexpr uint32_t kDwOutBytes = kConsumers * (kDwN / 64) * kBoxBytes;
constexpr size_t kDwSmem = smem_bytes(kDwStages, kDwStageBytes, kDwOutBytes);
static_assert(kDwSmem <= kMaxSmem, "the ring exceeds a block's shared memory");
static_assert(kDwStageBytes % 1024 == 0,
              "every box starts on a 1024-byte swizzle atom");
// dw at C <= kSmallC: each consumer's own 2 stages (x box + dy tile) and
// 2 staging slots
constexpr int kPpStages = 2;
constexpr uint32_t kPpStageBytes = kBoxBytes + (kDwN / 64) * kBoxBytes;
constexpr int kPpSlots = 2;
constexpr uint32_t kPpOutBytes = kConsumers * kPpSlots * kBoxBytes;
constexpr size_t kDwPpSmem =
    smem_bytes(kConsumers * kPpStages, kPpStageBytes, kPpOutBytes);
static_assert(kDwPpSmem <= kMaxSmem && kPpStageBytes % 1024 == 0,
              "the ping-pong ring");

struct Smem {
  unsigned char* ring;   // stages, 1024-byte aligned
  unsigned char* out;    // dw's staging slots, after the ring
  uint64_t* full;
  uint64_t* empty;
  int* rows;    // [kMaxE]: live rows of each expert
  int* first;   // [kMaxE + 1]: first item of each expert, then the count
};

__device__ __forceinline__ Smem carve(unsigned char* raw, int stages,
                                      uint32_t stage_bytes,
                                      uint32_t out_bytes) {
  Smem m;
  m.ring = raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
  m.out = m.ring + stages * stage_bytes;
  m.full = reinterpret_cast<uint64_t*>(m.out + out_bytes);
  m.empty = m.full + stages;
  m.rows = reinterpret_cast<int*>(m.empty + stages);
  m.first = m.rows + kMaxE;
  return m;
}

// Warp 0: every expert's live rows, the prefix sum of its items(rows)
// items (every block builds the same list) and the ring's barriers, each
// empty barrier released by `releases` arrivals (lane 0 of each consumer
// warp that reads its stage).
template <typename Items>
__device__ __forceinline__ void plan(const int* sizes, const Shape& s,
                                     const Smem& m, int stages, int releases,
                                     Items items) {
  const int lane = threadIdx.x;
  int carry = 0;
  for (int e0 = 0; e0 < s.E; e0 += 32) {
    const int e = e0 + lane;
    const int n = e < s.E ? live_size(sizes, e, s.C) : 0;
    int v = items(n);
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += u;
    }
    if (e < s.E) {
      m.rows[e] = n;
      m.first[e + 1] = carry + v;
    }
    carry += __shfl_sync(0xffffffffu, v, 31);
  }
  if (lane == 0) {
    m.first[0] = 0;
    for (int st = 0; st < stages; ++st) {
      mbar_init(&m.full[st], 1);
      mbar_init(&m.empty[st], releases);
    }
    mbar_fence_init();
  }
}

// The expert of item w: first[e] <= w < first[e + 1].
__device__ __forceinline__ int expert_of(int w, const int* first, int E) {
  int lo = 0, hi = E;
  while (hi - lo > 1) {
    const int mid = (lo + hi) / 2;
    if (first[mid] <= w) lo = mid; else hi = mid;
  }
  return lo;
}

// The producer warpgroup's idle warps (THREADS threads from kConsumers *
// 128 + 128 - THREADS), while the consumers run: 16-byte zeros over
// span(e, n)[0, n) of every expert, spread over every block.
template <int THREADS, typename Span>
__device__ __forceinline__ void zero_fill(int E, Span span) {
  const int zt = threadIdx.x - (kConsumers * 128 + 128 - THREADS);
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  const size_t stride = (size_t)gridDim.x * THREADS;
  for (int e = 0; e < E; ++e) {
    size_t n;
    uint4* dst = span(e, n);
    const size_t b = (blockIdx.x + 37u * e) % gridDim.x;
    for (size_t c = b * THREADS + zt; c < n; c += stride) dst[c] = zero;
  }
}

__device__ __forceinline__ void arrive(uint64_t* bar, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
}

// ------------------------------------------------------------------- dx

// One live dx item: expert e, its rows [m0, m0 + 64 boxes) of which the
// first rows - m0 hold tokens, D columns [n0, n0 + kDxN).
struct DxItem {
  int e, m0, n0, boxes, rows;
};

template <typename T>
__device__ __forceinline__ DxItem dx_item(int w, const Smem& m,
                                          const Shape& s) {
  DxItem it;
  it.e = expert_of(w, m.first, s.E);
  it.rows = m.rows[it.e];
  const int groups = (it.rows + T::kRM - 1) / T::kRM;
  const int j = w - m.first[it.e];
  it.n0 = (j / groups) * kDxN;
  it.m0 = (j % groups) * T::kRM;
  it.boxes = min(T::kBoxes, (it.rows - it.m0 + 63) / 64);
  return it;
}

// The K loop (over F) and epilogue of one dx item for a consumer warpgroup
// that owns MT live dy boxes (its boxes are 2i + wgi, i < MT).  Ring slots
// ring0 .. ring0 + KT - 1 hold the item's stages.
template <typename T, int MT>
__device__ __forceinline__ void consume_dx(float (&acc)[T::kMT][64],
                                           const DxItem& it, const Shape& s,
                                           int ring0, int KT, const Smem& m,
                                           int wgi, bf16* __restrict__ dx) {
  constexpr int kMT = T::kMT, kStages = T::kStages;
  constexpr uint32_t kStageBytes = T::kStageBytes;
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int e = 0; e < 64; ++e) acc[i][e] = 0.f;
  for (int kt = 0; kt < KT; ++kt) {
    const int r = ring0 + kt, st = r % kStages;
    mbar_wait(&m.full[st], (uint32_t)((r / kStages) & 1));
    if constexpr (MT > 0) {
      const uint32_t ab = smem_u32(m.ring + st * kStageBytes);
      const uint32_t bb = ab + T::kABytes;
#pragma unroll
      for (int i = 0; i < MT; ++i) fence_regs(acc[i]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        // w (K-major, as it lies): 128 rows of D, 16 deep = 32 bytes of
        // each; its two 64-row boxes are adjacent 8-row groups
        const uint64_t db = desc_sw128(bb + kk * 32, 16, 1024);
#pragma unroll
        for (int i = 0; i < MT; ++i)
          Wgmma<kDxN, 0>::ss(
              acc[i],
              desc_sw128(ab + (2 * i + wgi) * kBoxBytes + kk * 32, 16, 1024),
              db, 1);
      }
      wgmma_commit();
      wgmma_wait<1>();   // step kt - 1's products are done: free its stage
#pragma unroll
      for (int i = 0; i < MT; ++i) fence_regs(acc[i]);
      if (kt > 0) arrive(&m.empty[(r - 1) % kStages], lane);
    } else {
      arrive(&m.empty[st], lane);
    }
  }
  if constexpr (MT > 0) {
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < MT; ++i) fence_regs(acc[i]);

    // Epilogue, as gmm.cu's forward: staged through the item's last ring
    // stage, which this warpgroup releases only afterwards (its own dy
    // boxes 2q + wgi are kMT free 64 x 64 slots), by stmatrix of bf16,
    // zeros for rows past the size, into slots whose 16-byte chunks are
    // XOR-swizzled by row % 8; then 16-byte stores, 8 threads to a row.
    unsigned char* last = m.ring + ((ring0 + KT - 1) % kStages) * kStageBytes;
    const auto slot = [&](int q) { return last + (2 * q + wgi) * kBoxBytes; };
    const int mq = lane / 8;   // the matrix whose row address this lane gives
    const int srow = 16 * warp + 8 * (mq & 1) + lane % 8;
#pragma unroll
    for (int h0 = 0; h0 < 2 * MT; h0 += kMT) {
      if (h0 > 0) named_bar_sync(1 + wgi, 128);   // the slots are free again
#pragma unroll
      for (int q = 0; q < kMT && h0 + q < 2 * MT; ++q) {
        const int i = (h0 + q) / 2, half = (h0 + q) % 2;
        if (it.n0 + 64 * half >= s.D) continue;
        const int row = it.m0 + (2 * i + wgi) * 64 + 16 * warp + lane / 4;
        const bool live0 = row < it.rows, live1 = row + 8 < it.rows;
        const uint32_t ob = smem_u32(slot(q));
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const float* a0 = &acc[i][4 * (8 * half + 2 * jj)];
          const float* a1 = a0 + 4;
          const int chunk = 2 * jj + (mq >> 1);
          stmatrix_x4(ob + srow * 128 + ((chunk ^ (srow & 7)) << 4),
                      pack_bf16(live0 ? a0[0] : 0.f, live0 ? a0[1] : 0.f),
                      pack_bf16(live1 ? a0[2] : 0.f, live1 ? a0[3] : 0.f),
                      pack_bf16(live0 ? a1[0] : 0.f, live0 ? a1[1] : 0.f),
                      pack_bf16(live1 ? a1[2] : 0.f, live1 ? a1[3] : 0.f));
        }
      }
      named_bar_sync(1 + wgi, 128);   // the slots are written
#pragma unroll
      for (int q = 0; q < kMT && h0 + q < 2 * MT; ++q) {
        const int i = (h0 + q) / 2, half = (h0 + q) % 2;
        const int row0 = it.m0 + (2 * i + wgi) * 64, col0 = it.n0 + 64 * half;
        const unsigned char* src = slot(q);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int idx = t + 128 * k, r = idx / 8, c = idx % 8;
          const int row = row0 + r, col = col0 + 8 * c;
          if (row < s.C && col < s.D)
            *reinterpret_cast<uint4*>(dx + ((size_t)it.e * s.C + row) * s.D +
                                      col) =
                *reinterpret_cast<const uint4*>(src + r * 128 +
                                                ((c ^ (r & 7)) << 4));
        }
      }
    }
    // the stage goes back to the producer: this thread's reads of it are
    // done, and the coming TMA writes are ordered after them
    fence_proxy_async_shared();
    arrive(&m.empty[(ring0 + KT - 1) % kStages], lane);
  }
}

// consume_dx<mt>, one instantiation per count of live boxes (no branch
// inside a loop of wgmmas).
template <typename T, int MT>
__device__ __forceinline__ void consume_dx_n(int mt,
                                             float (&acc)[T::kMT][64],
                                             const DxItem& it, const Shape& s,
                                             int ring0, int KT, const Smem& m,
                                             int wgi, bf16* __restrict__ dx) {
  if (mt == MT)
    consume_dx<T, MT>(acc, it, s, ring0, KT, m, wgi, dx);
  else if constexpr (MT > 0)
    consume_dx_n<T, MT - 1>(mt, acc, it, s, ring0, KT, m, wgi, dx);
}

// dx[e, r, n] = sum_f dy[e, r, f] w[e, n, f] for r < size, else 0.
template <int TMT>
__global__ void __launch_bounds__(kThreads, 1)
gmm_bwd_dx_wgmma(const __grid_constant__ CUtensorMap tdy,
                 const __grid_constant__ CUtensorMap tw,
                 const int* __restrict__ sizes, bf16* __restrict__ dx,
                 const Shape s) {
  using T = Dx<TMT>;
  constexpr int kStages = T::kStages;
  extern __shared__ __align__(16) unsigned char wg_smem[];
  const Smem m = carve(wg_smem, kStages, T::kStageBytes, 0);
  const int wgi = threadIdx.x / 128;
  const int n_col = (s.D + kDxN - 1) / kDxN;
  if (threadIdx.x < 32)
    plan(sizes, s, m, kStages, 4 * kConsumers,
         [&](int n) { return (n + T::kRM - 1) / T::kRM * n_col; });
  __syncthreads();
  const int n_items = m.first[s.E];
  const int KT = (s.F + kBK - 1) / kBK;

  if (wgi == kConsumers) {
    // ------------------------------------------------------------ producer
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x >= kConsumers * 128 + 32) {
      // rows at or past each expert's size rounded up to 64 (no item
      // covers them): zeros, and nothing read
      zero_fill<96>(s.E, [&](int e, size_t& n) {
        const int z0 = min(s.C, (m.rows[e] + 63) / 64 * 64);
        n = (size_t)(s.C - z0) * (s.D / 8);
        return reinterpret_cast<uint4*>(dx + ((size_t)e * s.C + z0) * s.D);
      });
    } else if (threadIdx.x == kConsumers * 128) {
      tma_prefetch_map(&tdy);
      tma_prefetch_map(&tw);
      int r = 0;   // stages loaded so far
      for (int w = blockIdx.x; w < n_items; w += gridDim.x) {
        const DxItem it = dx_item<T>(w, m, s);
        // w boxes wholly past D are not loaded (their columns are never
        // stored), so the stage waits only for the boxes issued
        const int wboxes = min(kDxN / 64, (s.D - it.n0 + 63) / 64);
        const uint32_t bytes = (uint32_t)(it.boxes + wboxes) * kBoxBytes;
        for (int kt = 0; kt < KT; ++kt, ++r) {
          const int st = r % kStages, k0 = kt * kBK;
          if (r >= kStages)
            mbar_wait(&m.empty[st], (uint32_t)(((r / kStages) - 1) & 1));
          mbar_arrive_expect_tx(&m.full[st], bytes);
          unsigned char* a = m.ring + st * T::kStageBytes;
          for (int b = 0; b < it.boxes; ++b)
            tma_load_3d(a + b * kBoxBytes, &tdy, &m.full[st], k0,
                        it.m0 + 64 * b, it.e);
          for (int c = 0; c < wboxes; ++c)
            tma_load_3d(a + T::kABytes + c * kBoxBytes, &tw, &m.full[st], k0,
                        it.n0 + 64 * c, it.e);
        }
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    setmaxnreg_inc<kConsumerRegs>();
    float acc[TMT][64];
    int r = 0;   // stages consumed so far
    for (int w = blockIdx.x; w < n_items; w += gridDim.x, r += KT) {
      const DxItem it = dx_item<T>(w, m, s);
      const int mt = (it.boxes + 1 - wgi) / 2;   // this warpgroup's boxes
      consume_dx_n<T, TMT>(mt, acc, it, s, r, KT, m, wgi, dx);
    }
  }
}

// ------------------------------------------------------------------- dw

// A consumer's epilogue for its 64 x kDwN outputs (rows row0 .., columns
// n0 ..): bf16, one 64-column box at a time, by stmatrix into one of its
// SLOTS staging slots (16-byte chunks XOR-swizzled by row % 8: the store
// map's 128-byte swizzle), then one TMA store a box from thread 0, a bulk
// group each.  A slot is written again once the group that stored from it
// has read it, so the stores run on under the next boxes and the next
// item.  `bar`: the warpgroup's own named barrier.
template <int SLOTS>
__device__ __forceinline__ void store_boxes(const float (&acc)[kDwN / 2],
                                            unsigned char* slots,
                                            const CUtensorMap* tdw, int e,
                                            int row0, int n0, const Shape& s,
                                            int bar) {
  static_assert((kDwN / 64) % SLOTS == 0, "slots in turn, item after item");
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  const int mq = lane / 8;   // the matrix whose row address this lane gives
  const int srow = 16 * warp + 8 * (mq & 1) + lane % 8;
#pragma unroll
  for (int q = 0; q < kDwN / 64; ++q) {
    unsigned char* slot = slots + (q % SLOTS) * kBoxBytes;
    if (t == 0) bulk_wait_read<SLOTS - 1>();
    named_bar_sync(bar, 128);   // the slot is free
    const uint32_t ob = smem_u32(slot);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const float* a0 = &acc[4 * (8 * q + 2 * jj)];
      const float* a1 = a0 + 4;
      const int chunk = 2 * jj + (mq >> 1);
      stmatrix_x4(ob + srow * 128 + ((chunk ^ (srow & 7)) << 4),
                  pack_bf16(a0[0], a0[1]), pack_bf16(a0[2], a0[3]),
                  pack_bf16(a1[0], a1[1]), pack_bf16(a1[2], a1[3]));
    }
    fence_proxy_async_shared();
    named_bar_sync(bar, 128);   // the slot is written
    if (t == 0) {
      if (row0 < s.D && n0 + 64 * q < s.F)
        tma_store_3d(tdw, slot, n0 + 64 * q, row0, e);
      bulk_commit();
    }
  }
}

// One dw item: expert e (size > 0) over its kt boxes of live rows, D rows
// [m0, m0 + ROWS), F columns [n0, n0 + kDwN).
struct DwItem {
  int e, m0, n0, kt, rows;
};

template <int ROWS>
__device__ __forceinline__ DwItem dw_item(int w, const Smem& m,
                                          const Shape& s, int d_tiles) {
  DwItem it;
  it.e = expert_of(w, m.first, s.E);
  it.rows = m.rows[it.e];
  it.kt = (it.rows + kBK - 1) / kBK;
  const int j = w - m.first[it.e];
  it.m0 = (j % d_tiles) * ROWS;
  it.n0 = (j / d_tiles) * kDwN;
  return it;
}

// dw[e, m, n] = sum_{r < size} x[e, r, m] dy[e, r, n]; an empty expert's
// dw is 0.
__global__ void __launch_bounds__(kThreads, 1)
gmm_bwd_dw_wgmma(const __grid_constant__ CUtensorMap tx,
                 const __grid_constant__ CUtensorMap tdy,
                 const __grid_constant__ CUtensorMap tdw,
                 const int* __restrict__ sizes, bf16* __restrict__ dw,
                 const Shape s) {
  extern __shared__ __align__(16) unsigned char wg_smem[];
  const Smem m = carve(wg_smem, kDwStages, kDwStageBytes, kDwOutBytes);
  const int wgi = threadIdx.x / 128;
  const int d_tiles = (s.D + kDwM - 1) / kDwM;
  const int per_expert = d_tiles * ((s.F + kDwN - 1) / kDwN);
  if (threadIdx.x < 32)
    plan(sizes, s, m, kDwStages, 4 * kConsumers,
         [&](int n) { return n > 0 ? per_expert : 0; });
  __syncthreads();
  const int n_items = m.first[s.E];

  if (wgi == kConsumers) {
    // ------------------------------------------------------------ producer
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x >= kConsumers * 128 + 32) {
      // the dw of an expert without rows: zeros, and nothing read
      zero_fill<96>(s.E, [&](int e, size_t& n) {
        n = m.rows[e] == 0 ? (size_t)s.D * s.F / 8 : 0;
        return reinterpret_cast<uint4*>(dw + (size_t)e * s.D * s.F);
      });
    } else if (threadIdx.x == kConsumers * 128) {
      tma_prefetch_map(&tx);
      tma_prefetch_map(&tdy);
      int r = 0;   // stages loaded so far
      for (int w = blockIdx.x; w < n_items; w += gridDim.x) {
        const DwItem it = dw_item<kDwM>(w, m, s, d_tiles);
        // boxes wholly past D or F are not loaded: their products land in
        // rows or columns that are never stored
        const int xboxes = min(kConsumers, (s.D - it.m0 + 63) / 64);
        const int yboxes = min(kDwN / 64, (s.F - it.n0 + 63) / 64);
        const uint32_t bytes = (uint32_t)(xboxes + yboxes) * kBoxBytes;
        for (int kt = 0; kt < it.kt; ++kt, ++r) {
          const int st = r % kDwStages, k0 = kt * kBK;
          if (r >= kDwStages)
            mbar_wait(&m.empty[st], (uint32_t)(((r / kDwStages) - 1) & 1));
          mbar_arrive_expect_tx(&m.full[st], bytes);
          unsigned char* a = m.ring + st * kDwStageBytes;
          for (int b = 0; b < xboxes; ++b)
            tma_load_3d(a + b * kBoxBytes, &tx, &m.full[st], it.m0 + 64 * b,
                        k0, it.e);
          for (int c = 0; c < yboxes; ++c)
            tma_load_3d(a + kDwABytes + c * kBoxBytes, &tdy, &m.full[st],
                        it.n0 + 64 * c, k0, it.e);
        }
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    setmaxnreg_inc<kConsumerRegs>();
    const int t = threadIdx.x % 128, lane = t % 32;
    unsigned char* slots = m.out + wgi * (kDwN / 64) * kBoxBytes;
    float acc[kDwN / 2];
    int r = 0;   // stages consumed so far
    for (int w = blockIdx.x; w < n_items; w += gridDim.x) {
      const DwItem it = dw_item<kDwM>(w, m, s, d_tiles);
#pragma unroll
      for (int e = 0; e < kDwN / 2; ++e) acc[e] = 0.f;
      for (int kt = 0; kt < it.kt; ++kt, ++r) {
        const int st = r % kDwStages;
        mbar_wait(&m.full[st], (uint32_t)((r / kDwStages) & 1));
        unsigned char* a = m.ring + st * kDwStageBytes;
        const int live = it.rows - kt * kBK;
        if (live < kBK) {
          // The expert's last box: its rows [live, 64) of x and of dy are
          // padding and may hold anything, NaN too (0 . NaN is NaN), so
          // both are zeroed, by both warpgroups, before either reads them.
          // A row of a 128-byte-swizzled box keeps its own 128 bytes, so
          // whole rows are zeroed whatever the swizzle.
          const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
          const int chunks = (kBK - live) * 8;   // 16-byte chunks a box
          for (int idx = threadIdx.x; idx < (kConsumers + kDwN / 64) * chunks;
               idx += kConsumers * 128) {
            const int b = idx / chunks, c = idx % chunks;
            *reinterpret_cast<uint4*>(a + b * kBoxBytes + live * 128 +
                                      c * 16) = zero;
          }
          fence_proxy_async_shared();
          named_bar_sync(1, kConsumers * 128);
        }
        fence_regs(acc);
        wgmma_fence();
        // A = this warpgroup's x box transposed and B = the dy tile, both
        // MN-major: a k16 step is 16 rows of 128 bytes, dy's 64-column
        // blocks are one box apart
        const uint32_t ab = smem_u32(a) + wgi * kBoxBytes;
        const uint32_t bb = smem_u32(a) + kDwABytes;
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk)
          Wgmma<kDwN, 1>::ss<1>(acc,
                                desc_sw128(ab + kk * 16 * 128, kBoxBytes, 1024),
                                desc_sw128(bb + kk * 16 * 128, kBoxBytes, 1024),
                                1);
        wgmma_commit();
        wgmma_wait<1>();   // step kt - 1's products are done: free its stage
        fence_regs(acc);
        if (kt > 0) arrive(&m.empty[(r - 1) % kDwStages], lane);
      }
      wgmma_wait<0>();
      fence_regs(acc);
      arrive(&m.empty[(r - 1) % kDwStages], lane);

      store_boxes<kDwN / 64>(acc, slots, &tdw, it.e, it.m0 + 64 * wgi, it.n0,
                             s, 2 + wgi);
    }
    if (t == 0) bulk_wait<0>();
  }
}


// dw for C <= kSmallC, ping-pong: each consumer warpgroup takes every other
// item of its block, items of 64 rows of D x kDwN columns of F, through its
// own stages (x box and dy tile over 64 rows), loaded by its own producer
// thread, and its own staging slots, so one warpgroup's tail zeroing and
// epilogue run under the other's products.
__global__ void __launch_bounds__(kThreads, 1)
gmm_bwd_dw_pp_wgmma(const __grid_constant__ CUtensorMap tx,
                    const __grid_constant__ CUtensorMap tdy,
                    const __grid_constant__ CUtensorMap tdw,
                    const int* __restrict__ sizes, bf16* __restrict__ dw,
                    const Shape s) {
  extern __shared__ __align__(16) unsigned char wg_smem[];
  const Smem m = carve(wg_smem, kConsumers * kPpStages, kPpStageBytes,
                       kPpOutBytes);
  const int wgi = threadIdx.x / 128;
  const int d_tiles = (s.D + 63) / 64;
  const int per_expert = d_tiles * ((s.F + kDwN - 1) / kDwN);
  if (threadIdx.x < 32)
    plan(sizes, s, m, kConsumers * kPpStages, 4,
         [&](int n) { return n > 0 ? per_expert : 0; });
  __syncthreads();
  const int n_items = m.first[s.E];

  if (wgi == kConsumers) {
    // ------------------------------------------------------------ producer
    setmaxnreg_dec<kProducerRegs>();
    const int pw = (threadIdx.x - kConsumers * 128) / 32;   // producer warp
    if (pw >= kConsumers) {
      // the dw of an expert without rows: zeros, and nothing read
      zero_fill<128 - 32 * kConsumers>(s.E, [&](int e, size_t& n) {
        n = m.rows[e] == 0 ? (size_t)s.D * s.F / 8 : 0;
        return reinterpret_cast<uint4*>(dw + (size_t)e * s.D * s.F);
      });
    } else if (threadIdx.x % 32 == 0) {
      // warp pw's lane 0 loads consumer pw's items
      tma_prefetch_map(&tx);
      tma_prefetch_map(&tdy);
      int r = 0;   // this consumer's stages loaded so far
      for (int w = blockIdx.x + pw * gridDim.x; w < n_items;
           w += kConsumers * gridDim.x) {
        const DwItem it = dw_item<64>(w, m, s, d_tiles);
        const int yboxes = min(kDwN / 64, (s.F - it.n0 + 63) / 64);
        const uint32_t bytes = (uint32_t)(1 + yboxes) * kBoxBytes;
        for (int kt = 0; kt < it.kt; ++kt, ++r) {
          const int st = pw * kPpStages + r % kPpStages, k0 = kt * kBK;
          if (r >= kPpStages)
            mbar_wait(&m.empty[st], (uint32_t)(((r / kPpStages) - 1) & 1));
          mbar_arrive_expect_tx(&m.full[st], bytes);
          unsigned char* a = m.ring + st * kPpStageBytes;
          tma_load_3d(a, &tx, &m.full[st], it.m0, k0, it.e);
          for (int c = 0; c < yboxes; ++c)
            tma_load_3d(a + (1 + c) * kBoxBytes, &tdy, &m.full[st],
                        it.n0 + 64 * c, k0, it.e);
        }
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    setmaxnreg_inc<kConsumerRegs>();
    const int t = threadIdx.x % 128, lane = t % 32;
    unsigned char* slots = m.out + wgi * kPpSlots * kBoxBytes;
    float acc[kDwN / 2];
    int r = 0;   // this warpgroup's stages consumed so far
    for (int w = blockIdx.x + wgi * gridDim.x; w < n_items;
         w += kConsumers * gridDim.x) {
      const DwItem it = dw_item<64>(w, m, s, d_tiles);
#pragma unroll
      for (int e = 0; e < kDwN / 2; ++e) acc[e] = 0.f;
      for (int kt = 0; kt < it.kt; ++kt, ++r) {
        const int st = wgi * kPpStages + r % kPpStages;
        mbar_wait(&m.full[st], (uint32_t)((r / kPpStages) & 1));
        unsigned char* a = m.ring + st * kPpStageBytes;
        const int live = it.rows - kt * kBK;
        if (live < kBK) {
          // the last box's padding rows of x and dy: zeros (as in
          // gmm_bwd_dw_wgmma), read by this warpgroup alone
          const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
          const int chunks = (kBK - live) * 8;   // 16-byte chunks a box
          for (int idx = t; idx < (1 + kDwN / 64) * chunks; idx += 128) {
            const int b = idx / chunks, c = idx % chunks;
            *reinterpret_cast<uint4*>(a + b * kBoxBytes + live * 128 +
                                      c * 16) = zero;
          }
          fence_proxy_async_shared();
          named_bar_sync(1 + wgi, 128);
        }
        fence_regs(acc);
        wgmma_fence();
        const uint32_t ab = smem_u32(a), bb = ab + kBoxBytes;
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk)
          Wgmma<kDwN, 1>::ss<1>(acc,
                                desc_sw128(ab + kk * 16 * 128, kBoxBytes, 1024),
                                desc_sw128(bb + kk * 16 * 128, kBoxBytes, 1024),
                                1);
        wgmma_commit();
        wgmma_wait<1>();   // step kt - 1's products are done: free its stage
        fence_regs(acc);
        if (kt > 0)
          arrive(&m.empty[wgi * kPpStages + (r - 1) % kPpStages], lane);
      }
      wgmma_wait<0>();
      fence_regs(acc);
      arrive(&m.empty[wgi * kPpStages + (r - 1) % kPpStages], lane);
      store_boxes<kPpSlots>(acc, slots, &tdw, it.e, it.m0, it.n0, s,
                            3 + wgi);
    }
    if (t == 0) bulk_wait<0>();
  }
}

}  // namespace wg

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
enum Variant { kF32 = 0, kMmaSync = 1, kWgmma = 2 };

long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }

// Rows of a wgmma dx item at capacity C.
int dx_rows(int C) {
  return C <= wg::kSmallC ? wg::Dx<1>::kRM : wg::Dx<3>::kRM;
}

// The kernels that take a launch (ops.bwd_variant states the same rule), or
// -1.  vec: the caller found D % 8 == F % 8 == 0 and every pointer 16-byte
// aligned.
int variant_of(int dtype, int E, int C, int D, int F, int vec) {
  if (dtype == 0) return kF32;
  if (dtype != 1) return -1;
  const long long strides = 1ll << 39;   // tensor-map strides < 2^40 bytes
  if (vec && E <= wg::kMaxE && (long long)C * D < strides &&
      (long long)C * F < strides && (long long)D * F < strides &&
      E * ceil_div(C, dx_rows(C)) * ceil_div(D, wg::kDxN) < (1ll << 31) &&
      E * ceil_div(D, C <= wg::kSmallC ? 64 : wg::kDwM) *
              ceil_div(F, wg::kDwN) <
          (1ll << 31))
    return kWgmma;
  return kMmaSync;
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// The dynamic shared memory of the four bf16 mma.sync instantiations is
// allowed once per device, so a launch costs the host nothing more.
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
  if (int err = prepare_tc()) return err;
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

// The wgmma kernels' shared-memory attribute is set, and the SM count
// read, once per device, so a launch costs the host only its tensor maps.
int prepare_wg(int* sms) {
  static std::atomic<int> sms_of[kMaxDevices];   // 0: not yet prepared
  int device;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (device >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  int n = sms_of[device].load(std::memory_order_relaxed);
  if (n == 0) {
    const cudaFuncAttribute a = cudaFuncAttributeMaxDynamicSharedMemorySize;
    if ((err = cudaFuncSetAttribute(wg::gmm_bwd_dx_wgmma<1>, a,
                                    (int)wg::Dx<1>::kSmem)) ||
        (err = cudaFuncSetAttribute(wg::gmm_bwd_dx_wgmma<3>, a,
                                    (int)wg::Dx<3>::kSmem)) ||
        (err = cudaFuncSetAttribute(wg::gmm_bwd_dw_wgmma, a,
                                    (int)wg::kDwSmem)) ||
        (err = cudaFuncSetAttribute(wg::gmm_bwd_dw_pp_wgmma, a,
                                    (int)wg::kDwPpSmem)) ||
        (err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount,
                                      device)))
      return (int)err;
    sms_of[device].store(n, std::memory_order_relaxed);
  }
  *sms = n;
  return 0;
}

int launch_wg(const void* x, const void* w, const void* sizes, const void* dy,
              void* dx, void* dw, const Shape& s, cudaStream_t stream) {
  int sms;
  if (int err = prepare_wg(&sms)) return err;
  // dy (E, C, F) as (F, C, E), x (E, C, D) as (D, C, E), w and dw (E, D, F)
  // as (F, D, E); every box 64 x 64 with a 128-byte swizzle
  const uint64_t es = sizeof(bf16);
  const uint32_t box[3] = {64, 64, 1};
  const uint64_t yd[3] = {(uint64_t)s.F, (uint64_t)s.C, (uint64_t)s.E};
  const uint64_t ys[2] = {s.F * es, (uint64_t)s.C * s.F * es};
  const uint64_t wd[3] = {(uint64_t)s.F, (uint64_t)s.D, (uint64_t)s.E};
  const uint64_t ws[2] = {s.F * es, (uint64_t)s.D * s.F * es};
  const uint64_t xd[3] = {(uint64_t)s.D, (uint64_t)s.C, (uint64_t)s.E};
  const uint64_t xs[2] = {s.D * es, (uint64_t)s.C * s.D * es};
  const int* sz = static_cast<const int*>(sizes);
  CUtensorMap tdy;
  int err = hopper::encode_tensor_map_bf16(&tdy, dy, 3, yd, ys, box);
  if (err) return err;
  if (dx) {
    CUtensorMap tw;
    if ((err = hopper::encode_tensor_map_bf16(&tw, w, 3, wd, ws, box)))
      return err;
    constexpr size_t smem1 = wg::Dx<1>::kSmem, smem3 = wg::Dx<3>::kSmem;
    if (s.C <= wg::kSmallC)
      wg::gmm_bwd_dx_wgmma<1><<<sms, wg::kThreads, smem1, stream>>>(
          tdy, tw, sz, static_cast<bf16*>(dx), s);
    else
      wg::gmm_bwd_dx_wgmma<3><<<sms, wg::kThreads, smem3, stream>>>(
          tdy, tw, sz, static_cast<bf16*>(dx), s);
    if ((err = (int)cudaGetLastError())) return err;
  }
  if (dw) {
    CUtensorMap tx, tdw;
    if ((err = hopper::encode_tensor_map_bf16(&tx, x, 3, xd, xs, box)) ||
        (err = hopper::encode_tensor_map_bf16(&tdw, dw, 3, wd, ws, box)))
      return err;
    constexpr size_t smem = wg::kDwSmem, pp = wg::kDwPpSmem;
    if (s.C <= wg::kSmallC)
      wg::gmm_bwd_dw_pp_wgmma<<<sms, wg::kThreads, pp, stream>>>(
          tx, tdy, tdw, sz, static_cast<bf16*>(dw), s);
    else
      wg::gmm_bwd_dw_wgmma<<<sms, wg::kThreads, smem, stream>>>(
          tx, tdy, tdw, sz, static_cast<bf16*>(dw), s);
    if ((err = (int)cudaGetLastError())) return err;
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
// dw kernel, of the variant `gmm_bwd_variant` names, on `stream`, does not
// synchronise, and returns the cudaError_t of the launches (0 on success).
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
  switch (variant_of(dtype, E, C, D, F, vec)) {
    case kWgmma:
      return launch_wg(x, w, sizes, dy, dx, dw, s, st);
    case kMmaSync:
      return vec ? launch_tc<true>(x, w, sizes, dy, dx, dw, s, st)
                 : launch_tc<false>(x, w, sizes, dy, dx, dw, s, st);
    case kF32:
      return launch_cc(x, w, sizes, dy, dx, dw, s, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The kernels a launch with these arguments takes: 0 f32, 1 mma_sync,
// 2 wgmma, -1 none.
int gmm_bwd_variant(int dtype, int E, int C, int D, int F, int vec) {
  return variant_of(dtype, E, C, D, F, vec);
}

// Dynamic shared memory per block of a wgmma kernel, in bytes (ptxas
// reports only static shared memory): 0 dx at C <= 128, 1 dx above, 2 dw
// at C <= 128, 3 dw above; -1 for another number.
int gmm_bwd_wgmma_smem_bytes(int kernel) {
  switch (kernel) {
    case 0: return (int)wg::Dx<1>::kSmem;
    case 1: return (int)wg::Dx<3>::kSmem;
    case 2: return (int)wg::kDwPpSmem;
    case 3: return (int)wg::kDwSmem;
    default: return -1;
  }
}

const char* gmm_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
