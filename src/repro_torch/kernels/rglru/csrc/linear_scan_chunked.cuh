// The chunked RG-LRU scan shared by the forward (linear_scan.cu) and the
// backward's state pass (linear_scan_bwd.cu): one copy of the device code,
// so the states the backward differentiates are those whose rounding is the
// forward's y.  The design and what bounds it: linear_scan.cu.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

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

namespace chunked {

constexpr int kCh = 32;                  // channels a block: a lane each
constexpr int kChunks = 8;               // chunks a segment: a warp each
constexpr int kL = 16;                   // steps a chunk
constexpr int kThreads = kCh * kChunks;

// Warps a block, and so chunks a segment: kChunks, or as many as T fills
// (at T = 1 the other warps would only add threads; the chunks they would
// hold lie past T and fold as the identity, so the result is the same).
inline int warps_for(int T_) {
  const int n = (T_ + kL - 1) / kL;
  return n < kChunks ? n : kChunks;
}

// Steps t0 .. t0 + kL - 1 of one channel (stride C between steps; T >= 1)
// at clamped indices: every load is issued, none waits on a branch.
template <typename T>
__device__ __forceinline__ void load_chunk(const T* __restrict__ xp,
                                           const T* __restrict__ ap, int t0,
                                           int T_, int C, T (&xr)[kL],
                                           T (&ar)[kL]) {
#pragma unroll
  for (int u = 0; u < kL; ++u) {
    const size_t off = (size_t)min(t0 + u, T_ - 1) * C;
    xr[u] = xp[off];
    ar[u] = ap[off];
  }
}

// y[b, t, c] = h_t in Y (x's dtype in the forward, float32 for the
// backward's states); h_last[b, c] = h_T where h_last is not null.
// Two blocks an SM, so at most 128 registers a thread.
template <typename T, typename Y>
__global__ void __launch_bounds__(kThreads, 2)
linear_scan_kernel(const T* __restrict__ x, const T* __restrict__ a,
                   const float* __restrict__ h0, Y* __restrict__ y,
                   float* __restrict__ h_last, int B, int T_, int C) {
  __shared__ float sL[2][kChunks][kCh], sP[2][kChunks][kCh];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const long long ch = (long long)blockIdx.x * kCh + lane;
  const bool live = ch < (long long)B * C;
  const long long chl = live ? ch : 0;
  const long long b = chl / C, c = chl % C;
  const size_t base = (size_t)b * T_ * C + c;
  const T* xp = x + base;
  const T* ap = a + base;
  Y* yp = y + base;
  const int nw = blockDim.x >> 5, seg = nw * kL;   // chunks, steps
  float carry = h0[chl];                 // into the segment's first step
  const int nseg = (T_ + seg - 1) / seg;
  T xr[kL], ar[kL];
  load_chunk(xp, ap, w * kL, T_, C, xr, ar);
  for (int sg = 0; sg < nseg; ++sg) {
    const int par = sg & 1;
    const int t0 = sg * seg + w * kL;    // this warp's chunk
    float xv[kL], av[kL];
#pragma unroll
    for (int u = 0; u < kL; ++u) {
      const bool ok = t0 + u < T_;
      xv[u] = ok ? to_f32(xr[u]) : 0.f;
      av[u] = ok ? to_f32(ar[u]) : 1.f;
    }
    if (sg + 1 < nseg)   // the next segment's loads, before the stores
      load_chunk(xp, ap, t0 + seg, T_, C, xr, ar);
    // 1. the chunk from a carry of 0: carry out L, product of a's P
    float L = 0.f, P = 1.f;
#pragma unroll
    for (int u = 0; u < kL; ++u) {
      L = fmaf(av[u], L, xv[u]);
      P = __fmul_rn(P, av[u]);
    }
    // 2. the earlier chunks folded into the segment's carry, first first
    float cin = carry, cout;
    if (nw == 1) {   // T within one chunk: the fold is this one step, and
                     // with no barrier the two passes overlap
      cout = fmaf(P, cin, L);
    } else {
      sL[par][w][lane] = L;
      sP[par][w][lane] = P;
      __syncthreads();
#pragma unroll
      for (int j = 0; j < kChunks - 1; ++j)
        if (j < w) cin = fmaf(sP[par][j][lane], cin, sL[par][j][lane]);
      cout = cin;
#pragma unroll
      for (int j = 0; j < kChunks; ++j)
        if (j >= w && j < nw)
          cout = fmaf(sP[par][j][lane], cout, sL[par][j][lane]);
    }
    // 3. the chunk again from its carry in
    float h = cin;
#pragma unroll
    for (int u = 0; u < kL; ++u) {
      h = fmaf(av[u], h, xv[u]);
      if (live && t0 + u < T_) yp[(size_t)(t0 + u) * C] = from_f32<Y>(h);
    }
    carry = cout;
  }
  if (h_last != nullptr && live && w == 0) h_last[chl] = carry;
}

}  // namespace chunked

}  // namespace
