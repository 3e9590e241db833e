// Grouped matmul of the MoE expert FFN (capacity layout) for NVIDIA Hopper
// (sm_90a), bf16 or f32 in and out.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/moe_gmm/pallas_kernel.py::gmm_pallas (body _gmm_kernel)
//   and computes the same function:
//   out[e, r, :] = x[e, r, :] . w[e]   (f32 accumulation, rounded to x's
//                                       dtype) for r <  group_sizes[e]
//   out[e, r, :] = 0 exactly           for r >= group_sizes[e]
//   with x (E, C, D), w (E, D, F), group_sizes (E,) int32 on the device and
//   out (E, C, F).  Unlike the Pallas kernel it takes any C, D and F (the
//   ragged edges are masked here), and it reads the sizes on the device: the
//   host never learns them, so a call never waits for the device.
//
// What bounds it on an H100.  At the prefill shape of qwen3-moe-30b-a3b
// (E=128, C=384, D=2048, F=768, two thirds of the rows live) one call reads
// 403 MB of w, ~134 MB of live x rows and writes 75 MB: ~0.18 ms at
// 3.35 TB/s, against ~0.10 ms for its 1.0e11 flops at the bf16 tensor-core
// peak.  At decode (C=8, ~28 of 128 experts live, 1-2 rows each) it is the
// live experts' weights alone: ~90 MB, ~0.027 ms.  So the function is bound
// by bytes, and most of all by the weights of the experts that hold tokens.
//
// Three kernels; the launcher picks one by the rule of `variant_of` (the
// Python wrapper's `ops.variant` states the same rule):
//  * wgmma (bf16, C > 16, D % 8 == F % 8 == 0, D > 0, 16-byte aligned
//    pointers, E <= 1024, C * F < 2^34): the prefill path.  Persistent and
//    warp specialised: one block per SM, one TMA producer warpgroup and
//    two consumer warpgroups.
//    - Work items are (expert, group of 384 rows, 128 output columns), and
//      only live ones: every block stages the E sizes in shared memory,
//      prefix-sums the items per expert, and walks items blockIdx.x,
//      blockIdx.x + gridDim.x, ... (a binary search finds each item's
//      expert).  The items of one expert are adjacent, so the blocks that
//      share its x rows run at the same time and find them in L2.
//    - One item covers all the rows of its expert that hold tokens (C <=
//      384, as at qwen3's prefill): the item's w slab (D x 128) crosses
//      from device memory to the SMs once per call, and no byte of w is
//      read for a dead expert.  Only the 64-row boxes of x that hold live
//      rows are loaded, and only their products issued: a consumer
//      warpgroup owns boxes 0, 2, 4 or 1, 3, 5 of the item and runs a K
//      loop instantiated for 3, 2, 1 or 0 live boxes (no branch inside a
//      loop of wgmmas).
//    - x is a 3-D tensor map (D, C, E), K-major, and w a 3-D tensor map
//      (F, D, E), MN-major, both with a 128-byte swizzle; a stage holds
//      64 deep of up to 384 x rows and 128 w columns (64 KB), three
//      stages deep, tracked by full and empty mbarriers.  Rows past C,
//      depth past D and columns past F load as zeros (TMA's bounds).
//    - Each live box is one wgmma m64n128k16 per 16 deep (f32 in
//      registers, 192 a thread at most); one group of products stays in
//      flight while the previous stage is released.
//    - The epilogue rounds f32 to bf16 and writes the item's boxes: real
//      values for rows < size, exact zeros for the rest of the box, by
//      stmatrix into the item's last ring stage (released only after the
//      epilogue) and from there as coalesced 16-byte stores.  Rows at or
//      past the size rounded up to 64, and whole dead experts, are written
//      as zeros by the producer warpgroup's three idle warps of every
//      block while the consumers run (no loads).  No row is written twice.
//  * mma_sync (bf16 that the wgmma kernel does not take; decode's C <= 16):
//    one block per (expert, row tile, column tile); a tile past its
//    expert's size writes zeros and returns before it loads anything.  x
//    and w tiles go through shared memory by cp.async (16 bytes a thread,
//    zero-filled past the ragged ends), three stages deep, into warp-level
//    mma.sync (m16n8k16, f32 accumulate), the B fragment by
//    ldmatrix.trans from row-major (D, F) w tiles.  A 16-row tile (4 warps
//    of 16 x 32) serves decode's C = 8, a 64-row one (4 warps of 32 x 64)
//    larger C.  Shapes whose rows are not a multiple of 16 bytes (D or
//    F % 8 != 0) or whose pointers are not 16-byte aligned stage through
//    plain loads instead of cp.async.
//  * f32: CUDA-core FMAs in IEEE f32 (no TF32), 64 x 64 tiles, 4 x 4
//    outputs per thread.  It is the path of the f32 tests, not of serving.
//
// Build (plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libgmm.so gmm.cu

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstddef>
#include <cstdint>

#include "../../common/hopper.cuh"

namespace {

struct Shape {
  int E, C, D, F;
};

// The rows of expert e that hold tokens: min(max(group_sizes[e], 0), C).
__device__ __forceinline__ int live_size(const int* sizes, int e, int C) {
  return min(max(sizes[e], 0), C);
}

// ===================================================== bf16: tensor cores

namespace tc {

constexpr int kThreads = 128;      // 4 warps
constexpr int kBN = 128;           // output columns per block
constexpr int kBK = 32;            // depth per stage
constexpr int kStages = 3;
constexpr int kAS = kBK + 8;       // padded x tile row, elements (80 bytes)
constexpr int kBS = kBN + 8;       // padded w tile row, elements (272 bytes)

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

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* ptr) {
  return *reinterpret_cast<const uint32_t*>(ptr);
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

// The B operand (16 deep x 8 columns) from a row-major (depth, column) tile.
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t& b0, uint32_t& b1,
                                                  const __nv_bfloat16* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(b0), "=r"(b1)
      : "r"(smem_addr(row)));
}

// Fragment layout of mma.m16n8k16 (PTX ISA): with g = lane / 4 and
// t = lane % 4, a thread holds rows g and g + 8 of the 16 x 8 result at
// columns 2t and 2t + 1 (c[0], c[1] for row g; c[2], c[3] for row g + 8).
// BM rows per block, split over WM x WN warps.  VEC: 16-byte staging by
// cp.async (D % 8 == F % 8 == 0, 16-byte aligned pointers); else plain
// 2-byte loads.
template <int BM, int WM, int WN, bool VEC>
__global__ void __launch_bounds__(kThreads)
gmm_tc(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
       const int* __restrict__ sizes, __nv_bfloat16* __restrict__ out,
       Shape s) {
  static_assert(WM * WN * 32 == kThreads, "one warp per warp tile");
  constexpr int WTM = BM / WM;             // rows per warp
  constexpr int WTN = kBN / WN;            // columns per warp
  constexpr int MT = WTM / 16;             // mma row tiles per warp
  constexpr int NT = WTN / 8;              // mma column tiles per warp
  static_assert(MT * 16 == WTM && NT * 8 == WTN, "warp tile of whole mmas");
  __shared__ __align__(16) __nv_bfloat16 sA[kStages][BM * kAS];
  __shared__ __align__(16) __nv_bfloat16 sB[kStages][kBK * kBS];

  const int e = blockIdx.z;
  const int n0 = blockIdx.y * kBN, m0 = blockIdx.x * BM;
  const int tid = threadIdx.x;
  const int size = live_size(sizes, e, s.C);
  __nv_bfloat16* o = out + (size_t)e * s.C * s.F;

  if (m0 >= size) {   // dead tile: zeros, and not one byte of w read
    const int rows = min(BM, s.C - m0);
    if (VEC) {
      const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
      for (int idx = tid; idx < rows * (kBN / 8); idx += kThreads) {
        const int r = idx / (kBN / 8), n = n0 + (idx % (kBN / 8)) * 8;
        if (n < s.F)
          *reinterpret_cast<uint4*>(o + (size_t)(m0 + r) * s.F + n) = zero;
      }
    } else {
      const __nv_bfloat16 zero = __float2bfloat16(0.f);
      for (int idx = tid; idx < rows * kBN; idx += kThreads) {
        const int r = idx / kBN, n = n0 + idx % kBN;
        if (n < s.F) o[(size_t)(m0 + r) * s.F + n] = zero;
      }
    }
    return;
  }

  const __nv_bfloat16* xe = x + (size_t)e * s.C * s.D;
  const __nv_bfloat16* we = w + (size_t)e * s.D * s.F;
  const int live_rows = min(BM, size - m0);   // rows of the tile with tokens

  auto load = [&](int stage, int k0) {
    __nv_bfloat16* a = sA[stage];
    __nv_bfloat16* b = sB[stage];
    if (VEC) {
      for (int idx = tid; idx < BM * (kBK / 8); idx += kThreads) {
        const int r = idx / (kBK / 8), k = k0 + (idx % (kBK / 8)) * 8;
        const bool ok = r < live_rows && k < s.D;
        cp_async16(a + r * kAS + (k - k0),
                   ok ? xe + (size_t)(m0 + r) * s.D + k : xe, ok);
      }
      for (int idx = tid; idx < kBK * (kBN / 8); idx += kThreads) {
        const int r = idx / (kBN / 8), n = n0 + (idx % (kBN / 8)) * 8;
        const bool ok = k0 + r < s.D && n < s.F;
        cp_async16(b + r * kBS + (n - n0),
                   ok ? we + (size_t)(k0 + r) * s.F + n : we, ok);
      }
    } else {
      const __nv_bfloat16 zero = __float2bfloat16(0.f);
      for (int idx = tid; idx < BM * kBK; idx += kThreads) {
        const int r = idx / kBK, k = k0 + idx % kBK;
        a[r * kAS + (k - k0)] = r < live_rows && k < s.D
                                    ? xe[(size_t)(m0 + r) * s.D + k] : zero;
      }
      for (int idx = tid; idx < kBK * kBN; idx += kThreads) {
        const int r = idx / kBN, n = n0 + idx % kBN;
        b[r * kBS + (n - n0)] = k0 + r < s.D && n < s.F
                                    ? we[(size_t)(k0 + r) * s.F + n] : zero;
      }
    }
  };

  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = warp / WN, wn = warp % WN;
  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
      acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  const int KT = (s.D + kBK - 1) / kBK;
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < KT) load(st, st * kBK);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<kStages - 2>();   // this thread's copies of tile kt landed
    __syncthreads();                // everyone's did; tile kt-1 is consumed
    const int next = kt + kStages - 1;
    if (next < KT) load(next % kStages, next * kBK);
    cp_async_commit();

    const __nv_bfloat16* a_s = sA[kt % kStages];
    const __nv_bfloat16* b_s = sB[kt % kStages];
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t a[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const __nv_bfloat16* pa =
            a_s + (wm * WTM + i * 16 + g) * kAS + kk + 2 * t;
        a[i][0] = ld_u32(pa);
        a[i][1] = ld_u32(pa + 8 * kAS);
        a[i][2] = ld_u32(pa + 8);
        a[i][3] = ld_u32(pa + 8 * kAS + 8);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        uint32_t b0, b1;
        ldmatrix_x2_trans(b0, b1,
                          b_s + (kk + lane % 16) * kBS + wn * WTN + j * 8);
#pragma unroll
        for (int i = 0; i < MT; ++i) mma(acc[i][j], a[i], b0, b1);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int col = n0 + wn * WTN + j * 8 + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = m0 + wm * WTM + i * 16 + g + 8 * h;
        if (r >= s.C || col >= s.F) continue;
        const bool live = r < size;
        const float v0 = live ? acc[i][j][2 * h] : 0.f;
        const float v1 = live ? acc[i][j][2 * h + 1] : 0.f;
        __nv_bfloat16* dst = o + (size_t)r * s.F + col;
        if (VEC) {    // F even, col even: the pair lies inside the row
          *reinterpret_cast<__nv_bfloat162*>(dst) =
              __floats2bfloat162_rn(v0, v1);
        } else {
          dst[0] = __float2bfloat16(v0);
          if (col + 1 < s.F) dst[1] = __float2bfloat16(v1);
        }
      }
    }
}

}  // namespace tc

// ========================================================= f32: CUDA cores

namespace cc {

constexpr int kThreads = 256;      // 16 x 16 threads, 4 x 4 outputs each
constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 16;

__global__ void __launch_bounds__(kThreads)
gmm_cc(const float* __restrict__ x, const float* __restrict__ w,
       const int* __restrict__ sizes, float* __restrict__ out, Shape s) {
  __shared__ float sA[kBK][kBM + 4];   // x tile, transposed: [depth][row]
  __shared__ float sB[kBK][kBN + 4];   // w tile: [depth][column]

  const int e = blockIdx.z;
  const int n0 = blockIdx.y * kBN, m0 = blockIdx.x * kBM;
  const int tid = threadIdx.x;
  const int size = live_size(sizes, e, s.C);
  float* o = out + (size_t)e * s.C * s.F;

  if (m0 >= size) {   // dead tile: zeros, and not one byte of w read
    const int rows = min(kBM, s.C - m0);
    for (int idx = tid; idx < rows * kBN; idx += kThreads) {
      const int r = idx / kBN, n = n0 + idx % kBN;
      if (n < s.F) o[(size_t)(m0 + r) * s.F + n] = 0.f;
    }
    return;
  }

  const float* xe = x + (size_t)e * s.C * s.D;
  const float* we = w + (size_t)e * s.D * s.F;
  const int live_rows = min(kBM, size - m0);
  const int tx = tid % 16, ty = tid / 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < s.D; k0 += kBK) {
#pragma unroll
    for (int it = 0; it < kBM * kBK / kThreads; ++it) {
      const int idx = tid + it * kThreads;
      const int r = idx / kBK, k = k0 + idx % kBK;
      sA[k - k0][r] = r < live_rows && k < s.D
                          ? xe[(size_t)(m0 + r) * s.D + k] : 0.f;
    }
#pragma unroll
    for (int it = 0; it < kBK * kBN / kThreads; ++it) {
      const int idx = tid + it * kThreads;
      const int r = idx / kBN, n = n0 + idx % kBN;
      sB[r][n - n0] = k0 + r < s.D && n < s.F
                          ? we[(size_t)(k0 + r) * s.F + n] : 0.f;
    }
    __syncthreads();
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
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = m0 + ty * 4 + i;
    if (r >= s.C) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < s.F) o[(size_t)r * s.F + n] = r < size ? acc[i][j] : 0.f;
    }
  }
}

}  // namespace cc

// ===================================================== bf16: wgmma and TMA

namespace wg {

using namespace hopper;

constexpr int kConsumers = 2;                      // consumer warpgroups
constexpr int kThreads = 128 * (kConsumers + 1);   // + one producer warpgroup
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;   // 2 x 128 x 240 + 128 x 24 <= 65536
constexpr int kMT = 3;               // 64-row boxes per consumer warpgroup
constexpr int kBoxes = kMT * kConsumers;   // x boxes per item
constexpr int kRM = 64 * kBoxes;           // rows per item (384)
constexpr int kBN = 128;                   // output columns per item
constexpr int kBK = 64;                    // depth per stage (128 bytes)
constexpr int kStages = 3;
constexpr int kMaxE = 1024;                // experts staged in shared memory
constexpr uint32_t kBoxBytes = 64 * 128;   // 64 rows of 64 bf16
constexpr uint32_t kXBytes = kBoxes * kBoxBytes;
constexpr uint32_t kWBytes = (kBN / 64) * kBoxBytes;
constexpr uint32_t kStageBytes = kXBytes + kWBytes;
constexpr size_t kSmem = 1024 + size_t(kStages) * kStageBytes +
                         8 * 2 * kStages +
                         4 * (2 * kMaxE + 1);
static_assert(kSmem <= 232448, "the ring exceeds a block's shared memory");
static_assert(kXBytes % 1024 == 0 && kStageBytes % 1024 == 0,
              "every box starts on a 1024-byte swizzle atom");

// One live work item: expert e, its rows [m0, m0 + 64 boxes) of which the
// first rows - m0 hold tokens, output columns [n0, n0 + kBN).
struct Item {
  int e, m0, n0, boxes, rows;
};

// Item w of the block-shared list: first[e] is the first item of expert e
// (first[E] the count), rows[e] its live size.  An expert's items run over
// column tiles, and within one over its groups of kRM rows.
__device__ __forceinline__ Item item_of(int w, const int* first,
                                        const int* rows, int E) {
  int lo = 0, hi = E;   // first[lo] <= w < first[hi]
  while (hi - lo > 1) {
    const int mid = (lo + hi) / 2;
    if (first[mid] <= w) lo = mid; else hi = mid;
  }
  Item it;
  it.e = lo;
  it.rows = rows[lo];
  const int groups = (it.rows + kRM - 1) / kRM;
  const int j = w - first[lo];
  it.n0 = (j / groups) * kBN;
  it.m0 = (j % groups) * kRM;
  it.boxes = min(kBoxes, (it.rows - it.m0 + 63) / 64);
  return it;
}

__device__ __forceinline__ void arrive(uint64_t* bar, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
}

// The K loop and epilogue of one item for a consumer warpgroup that owns
// MT live boxes (its boxes are 2i + wgi, i < MT).  Ring slots ring0 ..
// ring0 + KT - 1 hold the item's stages.
template <int MT>
__device__ __forceinline__ void consume(float (&acc)[kMT][64], const Item& it,
                                        const Shape& s, int ring0, int KT,
                                        unsigned char* ring, uint64_t* full,
                                        uint64_t* empty, int wgi,
                                        __nv_bfloat16* __restrict__ out) {
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int e = 0; e < 64; ++e) acc[i][e] = 0.f;
  for (int kt = 0; kt < KT; ++kt) {
    const int r = ring0 + kt, st = r % kStages;
    mbar_wait(&full[st], (uint32_t)((r / kStages) & 1));
    if constexpr (MT > 0) {
      const uint32_t xb = smem_u32(ring + st * kStageBytes);
      const uint32_t wb = xb + kXBytes;
#pragma unroll
      for (int i = 0; i < MT; ++i) fence_regs(acc[i]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        // w (MN-major): 16 deep = 16 rows of 128 bytes; the two 64-column
        // blocks are 64 rows x 128 bytes apart
        const uint64_t db = desc_sw128(wb + kk * 16 * 128, 64 * 128, 1024);
#pragma unroll
        for (int i = 0; i < MT; ++i)
          Wgmma<kBN, 1>::ss(
              acc[i],
              desc_sw128(xb + (2 * i + wgi) * kBoxBytes + kk * 32, 16, 1024),
              db, 1);
      }
      wgmma_commit();
      wgmma_wait<1>();   // step kt - 1's products are done: free its stage
#pragma unroll
      for (int i = 0; i < MT; ++i) fence_regs(acc[i]);
      if (kt > 0) arrive(&empty[(r - 1) % kStages], lane);
    } else {
      arrive(&empty[st], lane);
    }
  }
  if constexpr (MT > 0) {
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < MT; ++i) fence_regs(acc[i]);

    // Epilogue, staged through the item's last ring stage, which this
    // warpgroup releases only afterwards: its own x boxes 2q + wgi (q < 3;
    // the other warpgroup may still be reading its boxes and the w tile)
    // are three free 64 x 64 bf16 slots, 1024-byte aligned.  The
    // accumulator fragment (PTX ISA: rows 16 warp + lane / 4 (+ 8), columns
    // 8j + 2 (lane % 4) + {0, 1}, elements 4j + 2h + {0, 1}) goes into a
    // slot as bf16 by stmatrix, zeros for rows past the size; then each
    // thread stores 16-byte chunks, 8 threads to a 128-byte row.  A slot's
    // 16-byte chunks are XOR-swizzled by row % 8, so neither side has bank
    // conflicts.  The 2 MT half tiles (64 columns each) go three at a time.
    unsigned char* last = ring + ((ring0 + KT - 1) % kStages) * kStageBytes;
    const auto slot = [&](int q) { return last + (2 * q + wgi) * kBoxBytes; };
    const int mq = lane / 8;   // the matrix whose row address this lane gives
    const int srow = 16 * warp + 8 * (mq & 1) + lane % 8;
#pragma unroll
    for (int h0 = 0; h0 < 2 * MT; h0 += kMT) {
      if (h0 > 0) named_bar_sync(1 + wgi, 128);   // the slots are free again
#pragma unroll
      for (int q = 0; q < kMT && h0 + q < 2 * MT; ++q) {
        const int i = (h0 + q) / 2, half = (h0 + q) % 2;
        if (it.n0 + 64 * half >= s.F) continue;
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
          if (row < s.C && col < s.F)
            *reinterpret_cast<uint4*>(out + ((size_t)it.e * s.C + row) * s.F +
                                      col) =
                *reinterpret_cast<const uint4*>(src + r * 128 +
                                                ((c ^ (r & 7)) << 4));
        }
      }
    }
    // the stage goes back to the producer: this thread's reads of it are
    // done, and the coming TMA writes are ordered after them
    fence_proxy_async_shared();
    arrive(&empty[(ring0 + KT - 1) % kStages], lane);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
gmm_wgmma(const __grid_constant__ CUtensorMap tx,
          const __grid_constant__ CUtensorMap tw,
          const int* __restrict__ sizes, __nv_bfloat16* __restrict__ out,
          const Shape s) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * kStageBytes);
  uint64_t* empty = full + kStages;
  int* rows = reinterpret_cast<int*>(empty + kStages);   // [kMaxE]
  int* first = rows + kMaxE;                              // [kMaxE + 1]

  const int wgi = threadIdx.x / 128;
  const int n_col = (s.F + kBN - 1) / kBN;
  if (threadIdx.x < 32) {   // warp 0: sizes and the item prefix sum
    const int lane = threadIdx.x;
    int carry = 0;
    for (int e0 = 0; e0 < s.E; e0 += 32) {
      const int e = e0 + lane;
      const int n = e < s.E ? live_size(sizes, e, s.C) : 0;
      int v = (n + kRM - 1) / kRM * n_col;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int u = __shfl_up_sync(0xffffffffu, v, o);
        if (lane >= o) v += u;
      }
      if (e < s.E) {
        rows[e] = n;
        first[e + 1] = carry + v;
      }
      carry += __shfl_sync(0xffffffffu, v, 31);
    }
    if (lane == 0) {
      first[0] = 0;
#pragma unroll
      for (int st = 0; st < kStages; ++st) {
        mbar_init(&full[st], 1);
        mbar_init(&empty[st], 4 * kConsumers);   // lane 0 of each warp
      }
      mbar_fence_init();
    }
  }
  __syncthreads();
  const int n_items = first[s.E];
  const int KT = (s.D + kBK - 1) / kBK;

  if (wgi == kConsumers) {
    // ------------------------------------------------------------ producer
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x >= kConsumers * 128 + 32) {
      // Warps 1 .. 3: zeros for rows at or past each expert's size rounded
      // up to 64 (no item covers them), 16-byte stores spread over every
      // block, while the consumers work through the items.
      // (C * F / 8 < 2^31 by the variant rule)
      const int zt = threadIdx.x - (kConsumers * 128 + 32);
      const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
      const int stride = gridDim.x * 96;
      for (int e = 0; e < s.E; ++e) {
        const int z0 = min(s.C, (rows[e] + 63) / 64 * 64);
        const int n = (s.C - z0) * (s.F / 8);
        uint4* dst =
            reinterpret_cast<uint4*>(out + ((size_t)e * s.C + z0) * s.F);
        const int b = (int)((blockIdx.x + 37u * e) % gridDim.x);
        for (int c = b * 96 + zt; c < n; c += stride) dst[c] = zero;
      }
    } else if (threadIdx.x == kConsumers * 128) {
      tma_prefetch_map(&tx);
      tma_prefetch_map(&tw);
      int r = 0;   // stages loaded so far
      for (int w = blockIdx.x; w < n_items; w += gridDim.x) {
        const Item it = item_of(w, first, rows, s.E);
        // w boxes wholly past F are not loaded (their columns are never
        // stored), so the stage waits only for the boxes issued
        const int wboxes = min(kBN / 64, (s.F - it.n0 + 63) / 64);
        const uint32_t bytes = (uint32_t)(it.boxes + wboxes) * kBoxBytes;
        for (int kt = 0; kt < KT; ++kt, ++r) {
          const int st = r % kStages, k0 = kt * kBK;
          if (r >= kStages)
            mbar_wait(&empty[st], (uint32_t)(((r / kStages) - 1) & 1));
          mbar_arrive_expect_tx(&full[st], bytes);
          unsigned char* xs = ring + st * kStageBytes;
          for (int b = 0; b < it.boxes; ++b)
            tma_load_3d(xs + b * kBoxBytes, &tx, &full[st], k0,
                        it.m0 + 64 * b, it.e);
          for (int c = 0; c < wboxes; ++c)
            tma_load_3d(xs + kXBytes + c * kBoxBytes, &tw, &full[st],
                        it.n0 + 64 * c, k0, it.e);
        }
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    setmaxnreg_inc<kConsumerRegs>();
    float acc[kMT][64];
    int r = 0;   // stages consumed so far
    for (int w = blockIdx.x; w < n_items; w += gridDim.x, r += KT) {
      const Item it = item_of(w, first, rows, s.E);
      const int mt = (it.boxes + 1 - wgi) / 2;   // this warpgroup's boxes
      static_assert(kMT == 3, "one instantiation per count of live boxes");
      if (mt == 3)
        consume<3>(acc, it, s, r, KT, ring, full, empty, wgi, out);
      else if (mt == 2)
        consume<2>(acc, it, s, r, KT, ring, full, empty, wgi, out);
      else if (mt == 1)
        consume<1>(acc, it, s, r, KT, ring, full, empty, wgi, out);
      else
        consume<0>(acc, it, s, r, KT, ring, full, empty, wgi, out);
    }
  }
}

}  // namespace wg

constexpr int kMaxDevices = 64;
enum Variant { kF32 = 0, kMmaSync = 1, kWgmma = 2 };

// The kernel that takes a launch (ops.variant states the same rule), or -1.
// vec: the caller found D % 8 == F % 8 == 0 and x, w, out 16-byte aligned.
int variant_of(int dtype, int E, int C, int D, int F, int vec) {
  if (dtype == 0) return kF32;
  if (dtype != 1) return -1;
  if (vec && C > 16 && D > 0 && E <= wg::kMaxE &&
      (long long)C * F < (1ll << 34))
    return kWgmma;
  return kMmaSync;
}

int launch_wgmma(const void* x, const void* w, const void* sizes, void* out,
                 const Shape& s, cudaStream_t stream) {
  const long long items = (long long)s.E * ((s.C + wg::kRM - 1) / wg::kRM) *
                          ((s.F + wg::kBN - 1) / wg::kBN);
  if (items > (1ll << 31) - 1) return (int)cudaErrorInvalidValue;
  const uint64_t e = sizeof(__nv_bfloat16);
  // x (E, C, D) as (D, C, E), box 64 deep x 64 rows; w (E, D, F) as
  // (F, D, E), box 64 columns x 64 deep
  const uint64_t xd[3] = {(uint64_t)s.D, (uint64_t)s.C, (uint64_t)s.E};
  const uint64_t xs[2] = {s.D * e, (uint64_t)s.C * s.D * e};
  const uint64_t wd[3] = {(uint64_t)s.F, (uint64_t)s.D, (uint64_t)s.E};
  const uint64_t ws[2] = {s.F * e, (uint64_t)s.D * s.F * e};
  const uint32_t box[3] = {64, 64, 1};
  CUtensorMap tx, tw;
  int err = hopper::encode_tensor_map_bf16(&tx, x, 3, xd, xs, box);
  if (!err) err = hopper::encode_tensor_map_bf16(&tw, w, 3, wd, ws, box);
  if (err) return err;
  // The shared-memory attribute is set, and the SM count read, once per
  // device, so a launch costs the host only the two tensor maps.
  static std::atomic<int> sms_of[kMaxDevices];   // 0: not yet prepared
  int device;
  cudaError_t cerr = cudaGetDevice(&device);
  if (cerr != cudaSuccess) return (int)cerr;
  if (device >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  int sms = sms_of[device].load(std::memory_order_relaxed);
  if (sms == 0) {
    cerr = cudaFuncSetAttribute(wg::gmm_wgmma,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)wg::kSmem);
    if (cerr == cudaSuccess)
      cerr = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device);
    if (cerr != cudaSuccess) return (int)cerr;
    sms_of[device].store(sms, std::memory_order_relaxed);
  }
  wg::gmm_wgmma<<<sms, wg::kThreads, wg::kSmem, stream>>>(
      tx, tw, static_cast<const int*>(sizes),
      static_cast<__nv_bfloat16*>(out), s);
  return (int)cudaGetLastError();
}

template <typename T, typename Kernel>
int launch(Kernel kernel, dim3 grid, int threads, const void* x,
           const void* w, const void* sizes, void* out, const Shape& s,
           cudaStream_t stream) {
  kernel<<<grid, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const int*>(sizes), static_cast<T*>(out), s);
  return (int)cudaGetLastError();
}

// Decode (C <= 16) takes one 16-row tile per expert; larger C 64-row tiles.
template <bool VEC>
int launch_tc(const void* x, const void* w, const void* sizes, void* out,
              const Shape& s, cudaStream_t stream) {
  const int col_tiles = (s.F + tc::kBN - 1) / tc::kBN;
  if (col_tiles > 65535) return (int)cudaErrorInvalidValue;
  if (s.C <= 16)
    return launch<__nv_bfloat16>(tc::gmm_tc<16, 1, 4, VEC>,
                                 dim3(1, col_tiles, s.E), tc::kThreads, x, w,
                                 sizes, out, s, stream);
  return launch<__nv_bfloat16>(tc::gmm_tc<64, 2, 2, VEC>,
                               dim3((s.C + 63) / 64, col_tiles, s.E),
                               tc::kThreads, x, w, sizes, out, s, stream);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

extern "C" {

// x (E, C, D), w (E, D, F), out (E, C, F), all contiguous and of one dtype
// (0: float32, 1: bfloat16); sizes (E,) int32, on the device.  vec = 1
// states that D % 8 == F % 8 == 0 and x, w and out are 16-byte aligned
// (checked here too).  Launches the kernel that `gmm_variant` names on
// `stream`, does not synchronise, and returns the cudaError_t of the
// launch (0 on success).
int gmm(const void* x, const void* w, const void* sizes, void* out, int dtype,
        int E, int C, int D, int F, int vec, void* stream) {
  if (E <= 0 || C <= 0 || D < 0 || F <= 0 || E > 65535)
    return (int)cudaErrorInvalidValue;
  if (vec && (D % 8 || F % 8 || !aligned16(x) || !aligned16(w) ||
              !aligned16(out)))
    return (int)cudaErrorInvalidValue;
  const Shape s{E, C, D, F};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (variant_of(dtype, E, C, D, F, vec)) {
    case kWgmma:
      return launch_wgmma(x, w, sizes, out, s, st);
    case kMmaSync:
      return vec ? launch_tc<true>(x, w, sizes, out, s, st)
                 : launch_tc<false>(x, w, sizes, out, s, st);
    case kF32: {
      const int col_tiles = (F + cc::kBN - 1) / cc::kBN;
      if (col_tiles > 65535) return (int)cudaErrorInvalidValue;
      const dim3 grid((C + cc::kBM - 1) / cc::kBM, col_tiles, E);
      return launch<float>(cc::gmm_cc, grid, cc::kThreads, x, w, sizes, out,
                           s, st);
    }
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The kernel a launch with these arguments takes: 0 f32, 1 mma_sync,
// 2 wgmma, -1 none.
int gmm_variant(int dtype, int E, int C, int D, int F, int vec) {
  return variant_of(dtype, E, C, D, F, vec);
}

// Dynamic shared memory per block of the wgmma kernel, in bytes (ptxas
// reports only static shared memory).
int gmm_wgmma_smem_bytes() { return (int)wg::kSmem; }

const char* gmm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
