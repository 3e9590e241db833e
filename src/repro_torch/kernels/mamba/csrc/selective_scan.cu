// Mamba-1 selective scan for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/mamba/pallas_kernel.py::selective_scan_pallas
//   (body _mamba_kernel), and computes the same function:
//     h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) B_t
//     y_t = sum_n h_t * C_t + D * x_t
//   with the (d, n) state kept on chip for the whole walk over T, and
//   h_last = h_T.  All arithmetic in float32.  Unlike the Pallas kernel it
//   takes any channel count d (threads past the last channel only help
//   stage shared memory) and any T.
//
// Inputs as the serving path gives them: x and y in float32 or bfloat16
// (template TX); Bm and C in float32 or bfloat16 (template TB), each a
// (B, T, n) view whose batch and time strides are arguments, so the column
// slices of the x_proj output are read in place; dt, A, D, h0 and h_last
// float32.  The wrapper makes no copies.
//
// What bounds it on an H100.  At the serve prefill shape of falcon-mamba-7b
// (B=4, T=1024, d=8192, n=16; x bf16, dt f32) it moves about 273 MB (x,
// dt and y; B, C and the states are small): 81 us at 3.35 TB/s.  It also
// evaluates B*T*d*n = 5.4e8 exponentials; at 16 MUFU results per SM and
// clock (132 SMs, 1.98 GHz) those alone take about 128 us, so the special
// function unit, not memory, sets the lower limit, and next to it the
// instructions issued per state and step: with one MUFU in each, a
// state-step can take no less than the MUFU's 8 cycles per warp.
//
// What the design does about it.
//  * Each thread owns one (b, channel) pair and keeps its n states and its
//    row of A, prescaled once by log2 e, in registers (n is padded to a
//    power of two NP with A = 0 and B = C = 0, which keeps the padded
//    states at 0).  A state-step is one FMUL (dt * A log2 e), one
//    ex2.approx (MUFU; relative error ~2^-22, where expf adds a range
//    reduction of several FP32 instructions), one FMUL (dt x * B) and two
//    FMAs (the state, then C . h in state order).
//  * Up to 168 registers a thread (three blocks of 128 per SM), so the
//    compiler can overlap one step's exponentials with the previous
//    step's C . h chain; a batch's y values are stored after all of its
//    steps.  (Splitting a channel's states over 2 or 4 threads, with
//    shuffles to sum C . h, gave 2-4x the warps but more instructions per
//    state-step, and measured slower on the H100; so did a polynomial
//    2^x on the FMA pipe for 2-4 of the 16 states.)
//  * B_t and C_t are shared by every channel of a batch row: a block of
//    128 channels stages them for kTT = 64 steps at a time in shared memory
//    (as float32) and each thread reads a step's values as float4
//    broadcasts.
//  * x and dt are loaded kU = 8 steps ahead into registers (double
//    buffering), so the serial chain does not wait on device memory.
//    Offsets inside a batch row are 32-bit where T * d < 2^31 (one
//    multiply and add a load: the serving shapes) and 64-bit beyond (a
//    template argument chosen at launch).  Steps past T read dt = 0,
//    x = 0 and B = 0, which leave the state as it is, and store nothing.
//    Every load is unconditional (indices clamped into range) and a select
//    follows all of a batch's loads: a guarded load compiles to a branch,
//    and a bf16 conversion inside it waits for the load, one memory
//    latency per step.
//  * For the backward (selective_scan_bwd.cu), the entry selective_scan_ckpt
//    also writes the states before every ck-th step (ck = 8, a multiple of
//    kU) to ckpt (B, ceil(T / ck), d, n), as float4s where n % 4 == 0 (a
//    warp's scalar stores, 64 bytes apart, took twice the rest of the
//    forward at ck = 8 on an H100); the backward recomputes the states
//    between them with the same arithmetic.  The write is compiled only into the
//    instantiations that take it (template kCk), so the serving
//    instantiations are the kernel as it was.
//
// Build (plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libselective_scan.so selective_scan.cu

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "../../common/hopper.cuh"

namespace {

constexpr int kThreads = 128;  // channels per block
constexpr int kTT = 64;        // time steps per shared-memory tile of B, C
constexpr int kU = 8;          // time steps per register batch of x, dt
constexpr int kMinBlocks = 3;  // resident blocks per SM (<= 168 registers)
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kTT % kU == 0, "a tile holds whole register batches");
static_assert(kTT * 4 % kThreads == 0, "staging splits evenly for NP >= 4");

struct Args {
  const void *x, *dt, *A, *Bm, *C, *D, *h0;
  void *y, *h_last;
  float* ckpt;                        // null: no checkpoints
  int B, T, d, n, ck;
  long long sb_b, sb_t, sc_b, sc_t;   // element strides of Bm and C
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// x and dt of steps t0 .. t0 + kU - 1 of one channel, from xp / dtp at its
// row-0 element (stride d between steps; T >= 1); steps past T, and threads
// without a channel, read 0.  All loads are issued before any select.
// Off: the type of an offset inside a batch row (uint32_t where T * d <
// 2^31, else uint64_t).
template <typename Off, typename TX>
__device__ __forceinline__ void load_batch(const TX* __restrict__ xp,
                                           const float* __restrict__ dtp,
                                           int t0, int T_, int d, bool live,
                                           float (&xb)[kU], float (&db)[kU]) {
  TX xr[kU];
  float dr[kU];
#pragma unroll
  for (int u = 0; u < kU; ++u) {
    const Off off = (Off)min(t0 + u, T_ - 1) * (Off)d;
    xr[u] = xp[off];
    dr[u] = dtp[off];
  }
#pragma unroll
  for (int u = 0; u < kU; ++u) {
    const bool ok = live && t0 + u < T_;
    xb[u] = ok ? to_f32(xr[u]) : 0.f;
    db[u] = ok ? dr[u] : 0.f;
  }
}

// NP consecutive floats of a shared-memory row, as float4 loads.
template <int NP>
__device__ __forceinline__ void ld_row(const float* row, float (&v)[NP]) {
#pragma unroll
  for (int q = 0; q < NP / 4; ++q) {
    const float4 f = reinterpret_cast<const float4*>(row)[q];
    v[4 * q] = f.x; v[4 * q + 1] = f.y; v[4 * q + 2] = f.z;
    v[4 * q + 3] = f.w;
  }
}

template <typename TX, typename TB, int NP, typename Off, bool kCk>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
selective_scan_kernel(const TX* __restrict__ x, const float* __restrict__ dt,
                      const float* __restrict__ A, const TB* __restrict__ Bm,
                      const TB* __restrict__ Cm, const float* __restrict__ Dv,
                      const float* __restrict__ h0, TX* __restrict__ y,
                      float* __restrict__ h_last,
                      float* __restrict__ ckpt, int T_, int d, int n, int ck,
                      long long sb_b, long long sb_t, long long sc_b,
                      long long sc_t) {
  static_assert(NP % 4 == 0, "rows of whole float4s");
  __shared__ __align__(16) float sB[kTT][NP];
  __shared__ __align__(16) float sC[kTT][NP];

  const int b = blockIdx.y;
  const int ch = blockIdx.x * kThreads + threadIdx.x;
  const bool live = ch < d;
  const int chl = live ? ch : 0;

  const size_t hbase = ((size_t)b * d + chl) * n;
  float A2[NP], h[NP];
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    const bool ok = live && i < n;
    A2[i] = ok ? A[(size_t)chl * n + i] * kLog2e : 0.f;
    h[i] = ok ? h0[hbase + i] : 0.f;
  }
  const float Dch = live ? Dv[chl] : 0.f;

  const size_t base = (size_t)b * T_ * d + chl;
  const TX* xp = x + base;
  const float* dtp = dt + base;
  TX* yp = y + base;
  const TB* Bp = Bm + b * sb_b;
  const TB* Cp = Cm + b * sc_b;

  float xr[kU], dr[kU];
  load_batch<Off>(xp, dtp, 0, T_, d, live, xr, dr);
  for (int t0 = 0; t0 < T_; t0 += kTT) {
    // this thread's kS elements of the (kTT, NP) tiles of B and C
    constexpr int kS = kTT * NP / kThreads;
    TB bv[kS], cv[kS];
#pragma unroll
    for (int j = 0; j < kS; ++j) {
      const int idx = threadIdx.x + j * kThreads, r = idx / NP, i = idx % NP;
      const long long t = min(t0 + r, T_ - 1), ic = min(i, n - 1);
      bv[j] = Bp[t * sb_t + ic];
      cv[j] = Cp[t * sc_t + ic];
    }
    __syncthreads();                   // the previous tile's reads are done
#pragma unroll
    for (int j = 0; j < kS; ++j) {
      const int idx = threadIdx.x + j * kThreads, r = idx / NP, i = idx % NP;
      const bool ok = t0 + r < T_ && i < n;
      sB[r][i] = ok ? to_f32(bv[j]) : 0.f;
      sC[r][i] = ok ? to_f32(cv[j]) : 0.f;
    }
    __syncthreads();

    for (int u0 = 0; u0 < kTT && t0 + u0 < T_; u0 += kU) {
      if (kCk && live && (t0 + u0) % ck == 0) {
        const int nck = (T_ + ck - 1) / ck;
        float* cp = ckpt + (((size_t)b * nck + (t0 + u0) / ck) * d + chl) * n;
        if (n % 4 == 0) {   // rows of whole float4s: 16-byte stores
#pragma unroll
          for (int i = 0; i < NP; i += 4)
            if (i < n)
              *reinterpret_cast<float4*>(cp + i) =
                  make_float4(h[i], h[i + 1], h[i + 2], h[i + 3]);
        } else {
#pragma unroll
          for (int i = 0; i < NP; ++i)
            if (i < n) cp[i] = h[i];
        }
      }
      float xn[kU], dn[kU];
      load_batch<Off>(xp, dtp, t0 + u0 + kU, T_, d, live, xn, dn);
      float yv[kU];   // C . h of each step, stored after the batch
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int r = u0 + u;
        const float dtv = dr[u];
        const float dx = dtv * xr[u];
        float bb[NP], cc[NP];
        ld_row<NP>(sB[r], bb);
        ld_row<NP>(sC[r], cc);
        float acc = 0.f;
#pragma unroll
        for (int i = 0; i < NP; ++i) {
          const float da = hopper::ex2_approx(dtv * A2[i]);
          h[i] = fmaf(da, h[i], dx * bb[i]);
          acc = fmaf(h[i], cc[i], acc);
        }
        yv[u] = acc;
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int t = t0 + u0 + u;
        if (live && t < T_)
          yp[(Off)t * (Off)d] = from_f32<TX>(fmaf(Dch, xr[u], yv[u]));
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        xr[u] = xn[u];
        dr[u] = dn[u];
      }
    }
  }
  if (live) {
#pragma unroll
    for (int i = 0; i < NP; ++i)
      if (i < n) h_last[hbase + i] = h[i];
  }
}

template <typename TX, typename TB, int NP, typename Off, bool kCk>
int launch(const Args& a, cudaStream_t stream) {
  const dim3 grid((a.d + kThreads - 1) / kThreads, a.B);
  selective_scan_kernel<TX, TB, NP, Off, kCk><<<grid, kThreads, 0, stream>>>(
      static_cast<const TX*>(a.x), static_cast<const float*>(a.dt),
      static_cast<const float*>(a.A), static_cast<const TB*>(a.Bm),
      static_cast<const TB*>(a.C), static_cast<const float*>(a.D),
      static_cast<const float*>(a.h0), static_cast<TX*>(a.y),
      static_cast<float*>(a.h_last), a.ckpt, a.T, a.d, a.n, a.ck, a.sb_b,
      a.sb_t, a.sc_b, a.sc_t);
  return (int)cudaGetLastError();
}

template <typename TX, typename TB, int NP, bool kCk>
int launch_off(const Args& a, cudaStream_t stream) {
  if ((long long)a.T * a.d < (1ll << 31))
    return launch<TX, TB, NP, uint32_t, kCk>(a, stream);
  return launch<TX, TB, NP, uint64_t, kCk>(a, stream);
}

template <typename TX, typename TB, int NP>
int launch_ck(const Args& a, cudaStream_t stream) {
  if (a.ckpt != nullptr) return launch_off<TX, TB, NP, true>(a, stream);
  return launch_off<TX, TB, NP, false>(a, stream);
}

template <typename TX, typename TB>
int launch_np(const Args& a, cudaStream_t stream) {
  if (a.n <= 4) return launch_ck<TX, TB, 4>(a, stream);
  if (a.n <= 8) return launch_ck<TX, TB, 8>(a, stream);
  if (a.n <= 16) return launch_ck<TX, TB, 16>(a, stream);
  return (int)cudaErrorInvalidValue;
}

template <typename TX>
int launch_bc(int bc_dtype, const Args& a, cudaStream_t stream) {
  if (bc_dtype == 0) return launch_np<TX, float>(a, stream);
  if (bc_dtype == 1) return launch_np<TX, __nv_bfloat16>(a, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// x, dt, y (B, T, d) contiguous, x and y of dtype x_dtype (0: float32,
// 1: bfloat16), dt float32; A (d, n), D (d,), h0 and h_last (B, d, n)
// float32 and contiguous; Bm and C (B, T, n) of dtype bc_dtype with element
// strides (sb_b, sb_t) and (sc_b, sc_t) and a contiguous last axis;
// 1 <= n <= 16, T >= 1.  Launches on `stream`, does not
// synchronise, and returns the cudaError_t of the launch (0 on success).
// selective_scan_ckpt also writes the states before steps 0, ck, 2 ck, ...
// to ckpt (B, ceil(T / ck), d, n) float32 contiguous (null: none); ck is a
// positive multiple of 8.  selective_scan writes none.
int selective_scan_ckpt(const void* x, const void* dt, const void* A,
                        const void* Bm, const void* C, const void* D,
                        const void* h0, void* y, void* h_last, void* ckpt,
                        int x_dtype, int bc_dtype, int B, int T, int d, int n,
                        int ck, long long sb_b, long long sb_t,
                        long long sc_b, long long sc_t, void* stream) {
  if (B <= 0 || B > 65535 || d <= 0 || T < 1 || n < 1 || n > 16 || ck <= 0 ||
      ck % kU)
    return (int)cudaErrorInvalidValue;
  const Args a{x, dt, A, Bm, C, D, h0, y, h_last, static_cast<float*>(ckpt),
               B, T, d, n, ck, sb_b, sb_t, sc_b, sc_t};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0) return launch_bc<float>(bc_dtype, a, s);
  if (x_dtype == 1) return launch_bc<__nv_bfloat16>(bc_dtype, a, s);
  return (int)cudaErrorInvalidValue;
}

int selective_scan(const void* x, const void* dt, const void* A,
                   const void* Bm, const void* C, const void* D,
                   const void* h0, void* y, void* h_last, int x_dtype,
                   int bc_dtype, int B, int T, int d, int n, long long sb_b,
                   long long sb_t, long long sc_b, long long sc_t,
                   void* stream) {
  return selective_scan_ckpt(x, dt, A, Bm, C, D, h0, y, h_last, nullptr,
                             x_dtype, bc_dtype, B, T, d, n, kU, sb_b, sb_t,
                             sc_b, sc_t, stream);
}

const char* selective_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
