// RG-LRU linear recurrence h_t = a_t * h_{t-1} + x_t, for NVIDIA Hopper
// (sm_90a), x and a in float32 or bfloat16.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/rglru/pallas_kernel.py::linear_scan_pallas
//   (body _rglru_kernel), and computes the same function: per channel, the
//   running state h (float32, from h0) walks T in order; y[:, t] = h_t in
//   x's dtype; h_last = h_T in float32.  Unlike the Pallas kernel it takes
//   any channel count C (the Pallas kernel asserts C % 256 == 0): threads
//   past the last channel return, and the ragged tail of T is masked.
//
// What bounds it on an H100.  The recurrence is one FMA per element, so the
// function is bound by bytes: at the serve prefill shape of recurrentgemma-2b
// (B=4, T=1024, C=2560, x and a float32) it reads x and a and writes y,
// about 126 MB, 38 us at 3.35 TB/s, against 10.5 M FMAs (0.3 us at the f32
// peak).
//
// What the design does about it.  Each thread owns one (b, c) channel and
// keeps h in a register for the whole walk.  Neighbouring threads own
// neighbouring channels, so every load and store of a warp is one coalesced
// row segment.  The chain of FMAs is serial, so the loads must not wait on
// it: the thread loads the next kU steps of x and a into registers before it
// runs the FMAs of the current kU steps (double buffering), which keeps
// 2 * kU steps of loads in flight per thread.  The loads are unconditional
// (the step index is clamped to T - 1) and a select afterwards gives steps
// past T a = 1 and x = 0, which leave h as it is; they store nothing.  A
// guarded load would compile to a branch per step, and for bf16 its
// conversion would wait on the load inside that branch: one memory latency
// per step (a first version that did so took 0.48 ms with bf16 inputs at
// the serve shape, 6x its f32 time).
// Not done yet: at the serve shape B * C = 10,240 threads are 160 blocks of
// 64, about 2.4 warps on each of the 132 SMs (under 4% of the 64 warps an SM
// can hold).  A chunked two-pass scan over T would fill the card.
//
// Build (plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o liblinear_scan.so linear_scan.cu

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 64;   // channels per block
constexpr int kU = 16;         // steps per register batch

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

// Steps t0 .. t0 + kU - 1 of one channel (stride C between steps; T >= 1);
// steps past T give a = 1, x = 0.  All loads are issued before any select.
template <typename T>
__device__ __forceinline__ void load_batch(const T* __restrict__ xp,
                                           const T* __restrict__ ap, int t0,
                                           int T_, int C, float (&xb)[kU],
                                           float (&ab)[kU]) {
  T xr[kU], ar[kU];
#pragma unroll
  for (int u = 0; u < kU; ++u) {
    const size_t off = (size_t)min(t0 + u, T_ - 1) * C;
    xr[u] = xp[off];
    ar[u] = ap[off];
  }
#pragma unroll
  for (int u = 0; u < kU; ++u) {
    const bool ok = t0 + u < T_;
    xb[u] = ok ? to_f32(xr[u]) : 0.f;
    ab[u] = ok ? to_f32(ar[u]) : 1.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
linear_scan_kernel(const T* __restrict__ x, const T* __restrict__ a,
                   const float* __restrict__ h0, T* __restrict__ y,
                   float* __restrict__ h_last, int B, int T_, int C) {
  const long long ch = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (ch >= (long long)B * C) return;
  const long long b = ch / C, c = ch % C;
  const size_t base = (size_t)b * T_ * C + c;
  const T* xp = x + base;
  const T* ap = a + base;
  T* yp = y + base;

  float h = h0[ch];                      // h0 is (B, C): index b * C + c
  float xb[kU], ab[kU];
  load_batch(xp, ap, 0, T_, C, xb, ab);
  for (int t0 = 0; t0 < T_; t0 += kU) {
    float xn[kU], an[kU];
    load_batch(xp, ap, t0 + kU, T_, C, xn, an);
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      h = fmaf(ab[u], h, xb[u]);
      if (t0 + u < T_) yp[(size_t)(t0 + u) * C] = from_f32<T>(h);
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      xb[u] = xn[u];
      ab[u] = an[u];
    }
  }
  h_last[ch] = h;
}

template <typename T>
int launch(const void* x, const void* a, const void* h0, void* y,
           void* h_last, int B, int T_, int C, cudaStream_t stream) {
  const long long channels = (long long)B * C;
  const long long blocks = (channels + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  linear_scan_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(a),
      static_cast<const float*>(h0), static_cast<T*>(y),
      static_cast<float*>(h_last), B, T_, C);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x, a, y (B, T, C) of one dtype (0: float32, 1: bfloat16), T >= 1; h0 and
// h_last (B, C) float32; all contiguous.  Launches on `stream`, does not
// synchronise, and returns the cudaError_t of the launch (0 on success).
int linear_scan(const void* x, const void* a, const void* h0, void* y,
                void* h_last, int dtype, int B, int T, int C, void* stream) {
  if (B <= 0 || C <= 0 || T < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, a, h0, y, h_last, B, T, C, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, a, h0, y, h_last, B, T, C, s);
  return (int)cudaErrorInvalidValue;
}

const char* linear_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
