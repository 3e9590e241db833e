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
// What the design does about it.
//  * One block per (expert, row tile, column tile).  A block whose first
//    row is at or past its expert's size writes zeros and returns before it
//    loads anything: a dead expert costs no weight bytes.  (The Pallas
//    kernel's BlockSpecs copy each w block in whatever `pl.when` decides.)
//    Row tiles are the fastest grid axis, so the blocks that share a w tile
//    run together and find it in L2.
//  * Inside a live tile, x rows past the size are zero-filled as they load
//    (never read), and the store writes 0 for them: their output is exactly
//    0, not small.
//  * bf16: both operands go through shared memory by cp.async (16 bytes a
//    thread, zero-filled past the ragged ends), three stages deep, and the
//    product runs on the tensor cores with warp-level mma.sync (m16n8k16,
//    f32 accumulate).  The A fragment is read from row-major x tiles, the B
//    fragment by ldmatrix.trans from row-major (D, F) w tiles; rows are padded
//    by 16 bytes, so fragment reads are free of bank conflicts.  A 64-row
//    tile (4 warps of 32 x 64) serves prefill's C=384; a 16-row tile (4 warps
//    of 16 x 32) serves decode's C=8.  Shapes whose rows are not a multiple
//    of 16 bytes (D or F % 8 != 0) or whose pointers are not 16-byte aligned
//    stage through plain loads instead of cp.async.
//  * f32: CUDA-core FMAs in IEEE f32 (no TF32), 64 x 64 tiles, 4 x 4 outputs
//    per thread.  It is the path of the f32 tests, not of serving.
// Not done yet: wgmma, TMA and warp specialisation, and a grid that visits
// only live tiles.
//
// Build (plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libgmm.so gmm.cu

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

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

template <typename T, typename Kernel>
int launch(Kernel kernel, dim3 grid, int threads, const void* x,
           const void* w, const void* sizes, void* out, const Shape& s,
           cudaStream_t stream) {
  kernel<<<grid, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const int*>(sizes), static_cast<T*>(out), s);
  return (int)cudaGetLastError();
}

// Decode (C <= 16) takes one 16-row tile per expert; prefill 64-row tiles.
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

}  // namespace

extern "C" {

// x (E, C, D), w (E, D, F), out (E, C, F), all contiguous and of one dtype
// (0: float32, 1: bfloat16); sizes (E,) int32, on the device.  vec = 1
// promises D % 8 == F % 8 == 0 and 16-byte aligned x, w and out (bf16
// only).  Launches on `stream`, does not synchronise, and returns the
// cudaError_t of the launch (0 on success).
int gmm(const void* x, const void* w, const void* sizes, void* out, int dtype,
        int E, int C, int D, int F, int vec, void* stream) {
  if (E <= 0 || C <= 0 || D < 0 || F <= 0 || E > 65535)
    return (int)cudaErrorInvalidValue;
  const Shape s{E, C, D, F};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return vec ? launch_tc<true>(x, w, sizes, out, s, st)
               : launch_tc<false>(x, w, sizes, out, s, st);
  if (dtype == 0) {
    const int col_tiles = (F + cc::kBN - 1) / cc::kBN;
    if (col_tiles > 65535) return (int)cudaErrorInvalidValue;
    const dim3 grid((C + cc::kBM - 1) / cc::kBM, col_tiles, E);
    return launch<float>(cc::gmm_cc, grid, cc::kThreads, x, w, sizes, out,
                         s, st);
  }
  return (int)cudaErrorInvalidValue;
}

const char* gmm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
