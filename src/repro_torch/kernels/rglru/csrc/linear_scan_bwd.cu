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
// so a first kernel recomputes the states in float32 into a scratch buffer
// hs that the wrapper allocates, and the reverse pass reads that.  That
// kernel is the forward's own chunked scan (linear_scan_chunked.cuh, the
// same grouping and fold order) writing float32: bf16(hs) is the forward's
// y bit for bit, so the gradient is that of the states the forward made.
//
// What bounds it on an H100.  One FMA and one multiply per element: bound
// by bytes.  At recurrentgemma-2b's train shape (a microbatch of B=2,
// T=1024, C=2560, float32) the reverse pass reads dy, a and y and writes dx
// and da, 5 x 21 MB = 105 MB, 31 us at 3.35 TB/s.  bf16 adds the state pass:
// x and a read, hs written and read again.  Reaching the bound takes some
// 5 MB of loads in flight (3.35 TB/s times a microsecond of latency); B * C
// = 5,120 threads walking T one step at a time hold too few.
//
// The design: a chunked reverse scan, each element read once.  A block is
// kCh = 32 channels (a lane each, neighbouring channels on neighbouring
// addresses) by kChunks = 8 warps; it walks T in segments of kChunks chunks
// of kL = 16 steps, the last segment first, warp w taking chunk w of a
// segment.  In a segment:
//  1. each thread loads its chunk's dy, a and h_{t-1} into registers (48
//     loads in flight a thread, unconditional at clamped indices; steps
//     past T read dy = 0 and a = 1, which leave the carry as it is), and
//     from a carry of 0 computes the chunk's carry out L (the carry after
//     its first step) and its product of a's P, so that the chunk turns a
//     carry c into L + P c;
//  2. after a barrier each warp folds the later chunks' (L, P) of its
//     channel into the segment's carry, chunk kChunks - 1 first, down to
//     its own: its carry in; it folds on down to chunk 0 for the next
//     segment's carry, the same operations in the same order in every
//     warp, so all hold the same value;
//  3. each thread reruns its chunk from its carry in and writes dx and da.
// (L, P) go through shared memory, double-buffered by segment, one barrier
// a segment.  The grouping of the sums is fixed by the shapes: two calls
// are bitwise equal.
//
// Build (plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o liblinear_scan_bwd.so linear_scan_bwd.cu

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "linear_scan_chunked.cuh"

namespace {

// The reverse pass groups T as the forward does (one set of constants).
using chunked::kCh;
using chunked::kChunks;
using chunked::kL;
using chunked::kThreads;
constexpr int kSeg = kL * kChunks;       // steps a segment

// The chunked reverse scan; hs (B, T, C) float32 holds h_t.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
linear_scan_bwd_reverse(const T* __restrict__ a, const float* __restrict__ h0,
               const float* __restrict__ hs, const T* __restrict__ dy,
               const float* __restrict__ dh_last, T* __restrict__ dx,
               T* __restrict__ da, float* __restrict__ dh0, int B, int T_,
               int C) {
  __shared__ float sL[2][kChunks][kCh], sP[2][kChunks][kCh];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const long long ch = (long long)blockIdx.x * kCh + lane;
  const bool live = ch < (long long)B * C;
  const long long chl = live ? ch : 0;
  const long long b = chl / C, c = chl % C;
  const size_t base = (size_t)b * T_ * C + c;
  const float h0v = h0[chl];
  const float dhv = dh_last[chl];
  float carry = live ? dhv : 0.f;   // into the segment's last step
  const int nseg = (T_ + kSeg - 1) / kSeg;
  for (int sg = nseg - 1; sg >= 0; --sg) {
    const int par = sg & 1;
    const int t0 = sg * kSeg + w * kL;       // this warp's chunk
    T dr[kL], ar[kL];
    float hr[kL];
#pragma unroll
    for (int u = 0; u < kL; ++u) {
      const int t = t0 + u;
      const size_t off = (size_t)min(t, T_ - 1) * C;
      dr[u] = dy[base + off];
      ar[u] = a[base + off];
      hr[u] = hs[base + (size_t)max(min(t, T_) - 1, 0) * C];
    }
    float dyv[kL], av[kL], hp[kL];
#pragma unroll
    for (int u = 0; u < kL; ++u) {
      const bool ok = live && t0 + u < T_;
      dyv[u] = ok ? to_f32(dr[u]) : 0.f;
      av[u] = ok ? to_f32(ar[u]) : 1.f;
      hp[u] = t0 + u >= 1 ? hr[u] : h0v;
    }
    // 1. the chunk from a carry of 0: carry out L, product of a's P
    float L = 0.f, P = 1.f;
#pragma unroll
    for (int u = kL - 1; u >= 0; --u) {
      L = av[u] * (dyv[u] + L);
      P *= av[u];
    }
    sL[par][w][lane] = L;
    sP[par][w][lane] = P;
    __syncthreads();
    // 2. the later chunks folded into the segment's carry, last first
    float cin = carry;
#pragma unroll
    for (int j = kChunks - 1; j > 0; --j)
      if (j > w) cin = fmaf(sP[par][j][lane], cin, sL[par][j][lane]);
    float cout = cin;
#pragma unroll
    for (int j = kChunks - 1; j >= 0; --j)
      if (j <= w) cout = fmaf(sP[par][j][lane], cout, sL[par][j][lane]);
    // 3. the chunk again from its carry in
    float cr = cin;
#pragma unroll
    for (int u = kL - 1; u >= 0; --u) {
      const int t = t0 + u;
      const float g = dyv[u] + cr;
      cr = av[u] * g;
      if (live && t < T_) {
        dx[base + (size_t)t * C] = from_f32<T>(g);
        da[base + (size_t)t * C] = from_f32<T>(g * hp[u]);
      }
    }
    carry = cout;
  }
  if (live) dh0[chl] = carry;
}

int grid_of(int B, int C, int per_block, unsigned* blocks) {
  const long long n = ((long long)B * C + per_block - 1) / per_block;
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
  if (int err = grid_of(B, C, kCh, &blocks)) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* fh0 = static_cast<const float*>(h0);
  const float* fdh = static_cast<const float*>(dh_last);
  float* fdh0 = static_cast<float*>(dh0);
  if (dtype == 0) {
    linear_scan_bwd_reverse<float><<<blocks, kThreads, 0, s>>>(
        static_cast<const float*>(a), fh0, static_cast<const float*>(y),
        static_cast<const float*>(dy), fdh, static_cast<float*>(dx),
        static_cast<float*>(da), fdh0, B, T, C);
    return (int)cudaGetLastError();
  }
  if (dtype == 1) {
    using bf = __nv_bfloat16;
    if (hs == nullptr) return (int)cudaErrorInvalidValue;
    chunked::linear_scan_kernel<bf, float>
        <<<blocks, kCh * chunked::warps_for(T), 0, s>>>(
        static_cast<const bf*>(x), static_cast<const bf*>(a), fh0,
        static_cast<float*>(hs), nullptr, B, T, C);
    if (int err = (int)cudaGetLastError()) return err;
    linear_scan_bwd_reverse<bf><<<blocks, kThreads, 0, s>>>(
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
