// Gradient of the RG-LRU linear recurrence h_t = a_t * h_{t-1} + x_t, for
// NVIDIA Hopper (sm_90a), x and a in float32 or bfloat16.
//
// The backward of the kernel in linear_scan.cu, which replaces the Pallas
// TPU kernel src/repro/kernels/rglru/pallas_kernel.py::linear_scan_pallas.
// The Pallas kernel has no backward: the JAX package differentiates its XLA
// scan (src/repro/kernels/rglru/xla.py).  Per channel, from the output
// gradients dy and dh_last, the reverse scan
//   g_T = dy_T + dh_last,  g_t = dy_t + a_{t+1} g_{t+1}
//   dx_t = g_t,  da_t = g_t h_{t-1} (h_0 = h0),  dh0 = a_1 g_1
// in float32; dx and da in the inputs' dtype, dh0 float32.
//
// Where h_{t-1} comes from.  For float32 inputs the forward's y is h
// itself, and the reverse pass reads it.  For bfloat16 inputs y was rounded,
// so a first kernel recomputes the states in float32 (the forward's
// arithmetic) into a scratch buffer hs that the wrapper allocates, and the
// reverse pass reads that.
//
// What bounds it on an H100.  One FMA and one multiply per element: bound
// by bytes.  At recurrentgemma-2b's train shape (a microbatch of B=2,
// T=1024, C=2560, float32) the reverse pass reads dy, a and y and writes dx
// and da, 5 x 21 MB = 105 MB, 31 us at 3.35 TB/s.  bf16 adds the recompute:
// x and a read, hs written and read again.
//
// What the design does about it.  As the forward: one thread a (b, c)
// channel walking T (here from the end), neighbouring threads on
// neighbouring channels so every load and store is one coalesced row
// segment, and the next kU steps' loads issued before the current ones'
// serial chain (unconditional loads at clamped indices, then selects:
// steps before 0 read dy = 0 and a = 1, which leave the carry as it is,
// and store nothing).  No sums cross threads, so two calls are bitwise
// equal.  Not done yet: as the forward, B * C threads are few warps per SM
// at these shapes; a chunked two-pass scan would fill the card.
//
// Build (plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o liblinear_scan_bwd.so linear_scan_bwd.cu

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

// The forward's states in float32: hs[b, t, c] = h_t (bf16 inputs).
template <typename T>
__global__ void __launch_bounds__(kThreads)
states_kernel(const T* __restrict__ x, const T* __restrict__ a,
              const float* __restrict__ h0, float* __restrict__ hs, int B,
              int T_, int C) {
  const long long ch = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (ch >= (long long)B * C) return;
  const long long b = ch / C, c = ch % C;
  const size_t base = (size_t)b * T_ * C + c;
  float h = h0[ch];
  for (int t0 = 0; t0 < T_; t0 += kU) {
    T xr[kU], ar[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const size_t off = base + (size_t)min(t0 + u, T_ - 1) * C;
      xr[u] = x[off];
      ar[u] = a[off];
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      h = fmaf(to_f32(ar[u]), h, to_f32(xr[u]));   // the forward's FMA
      if (t0 + u < T_) hs[base + (size_t)(t0 + u) * C] = h;
    }
  }
}

// dy, a and h_{t-1} of steps t1, t1 - 1, ..., t1 - kU + 1 of one channel;
// steps before 0 read dy = 0 and a = 1.  All loads before any select.
template <typename T>
__device__ __forceinline__ void load_rev(const T* __restrict__ dyp,
                                         const T* __restrict__ ap,
                                         const float* __restrict__ hp,
                                         float h0v, int t1, int C,
                                         float (&dyb)[kU], float (&ab)[kU],
                                         float (&hb)[kU]) {
  T dr[kU], ar[kU];
  float hr[kU];
#pragma unroll
  for (int u = 0; u < kU; ++u) {
    const int t = t1 - u;
    const size_t off = (size_t)max(t, 0) * C;
    dr[u] = dyp[off];
    ar[u] = ap[off];
    hr[u] = hp[(size_t)max(t - 1, 0) * C];
  }
#pragma unroll
  for (int u = 0; u < kU; ++u) {
    const int t = t1 - u;
    dyb[u] = t >= 0 ? to_f32(dr[u]) : 0.f;
    ab[u] = t >= 0 ? to_f32(ar[u]) : 1.f;
    hb[u] = t >= 1 ? hr[u] : h0v;
  }
}

// The reverse scan; hs (B, T, C) float32 holds h_t.
template <typename T>
__global__ void __launch_bounds__(kThreads)
reverse_kernel(const T* __restrict__ a, const float* __restrict__ h0,
               const float* __restrict__ hs, const T* __restrict__ dy,
               const float* __restrict__ dh_last, T* __restrict__ dx,
               T* __restrict__ da, float* __restrict__ dh0, int B, int T_,
               int C) {
  const long long ch = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (ch >= (long long)B * C) return;
  const long long b = ch / C, c = ch % C;
  const size_t base = (size_t)b * T_ * C + c;
  const T* ap = a + base;
  const T* dyp = dy + base;
  const float* hp = hs + base;
  T* dxp = dx + base;
  T* dap = da + base;

  const float h0v = h0[ch];
  float carry = dh_last[ch];             // a_{t+1} g_{t+1}; dh_last at T
  float dyb[kU], ab[kU], hb[kU];
  load_rev(dyp, ap, hp, h0v, T_ - 1, C, dyb, ab, hb);
  for (int t1 = T_ - 1; t1 >= 0; t1 -= kU) {
    float dyn[kU], an[kU], hn[kU];
    load_rev(dyp, ap, hp, h0v, t1 - kU, C, dyn, an, hn);
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int t = t1 - u;
      const float g = dyb[u] + carry;
      carry = ab[u] * g;
      if (t >= 0) {
        dxp[(size_t)t * C] = from_f32<T>(g);
        dap[(size_t)t * C] = from_f32<T>(g * hb[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      dyb[u] = dyn[u];
      ab[u] = an[u];
      hb[u] = hn[u];
    }
  }
  dh0[ch] = carry;
}

int grid_of(int B, int C, unsigned* blocks) {
  const long long n = ((long long)B * C + kThreads - 1) / kThreads;
  if (n > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  *blocks = (unsigned)n;
  return 0;
}

}  // namespace

extern "C" {

// x, a, y, dy, dx, da (B, T, C) of one dtype (0: float32, 1: bfloat16),
// T >= 1; h0, dh_last, dh0 (B, C) float32; hs (B, T, C) float32 scratch for
// bfloat16 inputs (unused, may be null, for float32); all contiguous.
// Launches on `stream`, does not synchronise, and returns the cudaError_t
// of the launches (0 on success).
int linear_scan_bwd(const void* x, const void* a, const void* h0,
                    const void* y, const void* dy, const void* dh_last,
                    void* hs, void* dx, void* da, void* dh0, int dtype, int B,
                    int T, int C, void* stream) {
  if (B <= 0 || C <= 0 || T < 1) return (int)cudaErrorInvalidValue;
  unsigned blocks;
  if (int err = grid_of(B, C, &blocks)) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* fh0 = static_cast<const float*>(h0);
  const float* fdh = static_cast<const float*>(dh_last);
  float* fdh0 = static_cast<float*>(dh0);
  if (dtype == 0) {
    reverse_kernel<float><<<blocks, kThreads, 0, s>>>(
        static_cast<const float*>(a), fh0, static_cast<const float*>(y),
        static_cast<const float*>(dy), fdh, static_cast<float*>(dx),
        static_cast<float*>(da), fdh0, B, T, C);
    return (int)cudaGetLastError();
  }
  if (dtype == 1) {
    using bf = __nv_bfloat16;
    if (hs == nullptr) return (int)cudaErrorInvalidValue;
    states_kernel<bf><<<blocks, kThreads, 0, s>>>(
        static_cast<const bf*>(x), static_cast<const bf*>(a), fh0,
        static_cast<float*>(hs), B, T, C);
    if (int err = (int)cudaGetLastError()) return err;
    reverse_kernel<bf><<<blocks, kThreads, 0, s>>>(
        static_cast<const bf*>(a), fh0, static_cast<const float*>(hs),
        static_cast<const bf*>(dy), fdh, static_cast<bf*>(dx),
        static_cast<bf*>(da), fdh0, B, T, C);
    return (int)cudaGetLastError();
  }
  return (int)cudaErrorInvalidValue;
}

const char* linear_scan_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
