// Gradient of the Mamba-1 selective scan, for NVIDIA Hopper (sm_90a).
//
// The backward of the kernel in selective_scan.cu, which replaces the
// Pallas TPU kernel src/repro/kernels/mamba/pallas_kernel.py::
// selective_scan_pallas.  The Pallas kernel has no backward: the JAX
// package differentiates its XLA scan (src/repro/kernels/mamba/xla.py).
// Forward: h_t = exp(dt_t A) h_{t-1} + (dt_t x_t) B_t, y_t = C_t . h_t +
// D x_t.  From dy and dh_last, with g the gradient of h_t (dh_last at T),
// each step t from the last, with e = exp(dt_t A) and h_{t-1} the state
// before it:
//   g += dy_t C_t;  dC_t += dy_t h_t;  dD += dy_t x_t
//   dA += g h_{t-1} e dt_t;  ddt_t = sum_n g (h_{t-1} e A + x_t B_t)
//   dx_t = dt_t sum_n g B_t + D dy_t;  dB_t += g dt_t x_t;  g *= e
// and dh0 = g.  All arithmetic in float32; dx in x's dtype, dBm and dC
// (contiguous) in Bm's, the rest float32.
//
// States.  The forward (entry selective_scan_ckpt) writes the state before
// every kK-th step to ckpt.  For each chunk of kK steps, last chunk first,
// a thread reloads its channel's n states from ckpt and recomputes the
// chunk's states with the forward's own arithmetic (ex2 of dt times A
// prescaled by log2 e, then one FMA), so they are the forward's bitwise;
// it keeps the state before each step in shared memory, then runs the
// chunk's steps in reverse with its n gradients g in registers.
//
// Sums.  dx_t and ddt_t are a channel's own.  dA (d, n) and dD (d) sum over
// B and T: each thread sums its channel's over T in registers and writes
// them per batch row (part_ad); a last kernel sums the rows in order.
// dBm_t and dC_t sum over the d channels: each step's 2 NP values are
// summed over a warp by a butterfly reduce-scatter (31 shuffles for 32
// values; lane j ends with value j), over the block's warps in order
// through shared memory, and written per block (part_bc); a second kernel
// sums the blocks in order.  No float atomics: two calls are bitwise
// equal.
//
// What bounds it on an H100.  At falcon-mamba-7b's train shape (B=4,
// T=1024, d=8192, n=16; x bf16, dt f32) it reads x, dt, dy, the
// checkpoints and writes dx, ddt: (2 + 4 + 2 + 4 + 2) bytes x 33.6 M, 470
// MB with the checkpoints (134 MB) and the partials (67 MB each way), 0.14
// ms at 3.35 TB/s.  It evaluates 2 x B T d n = 1.07e9 exponentials (the
// recompute and the reverse), 0.26 ms at 16 MUFU results per SM and clock:
// the special function unit sets the floor, twice the forward's.
//
// What the design does about it (a first, simple version).  One thread a
// (b, channel), 64 channels a block (the chunk's states, kK x NP x 64
// floats, take 64 KB of shared memory at NP = 16); x and dt of a chunk are
// loaded once and kept in registers for both passes; B_t and C_t are
// staged in shared memory as float32 and read as broadcasts.  Offsets in a
// batch row are 32-bit where T * d < 2^31 and 64-bit beyond, as the
// forward's.  Not done yet: overlap of the loads with the serial chain, and
// more than 6 warps per SM.
//
// Build (plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libselective_scan_bwd.so selective_scan_bwd.cu

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "../../common/hopper.cuh"

namespace {

constexpr int kThreads = 64;   // channels per block (ops.BWD_CHANNELS)
constexpr int kWarps = kThreads / 32;
constexpr int kK = 16;         // steps a chunk (ops.CKPT_STEPS)
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Args {
  const void *x, *dt, *A, *Bm, *C, *D, *ckpt, *dy, *dh_last;
  void *dx, *ddt, *dA, *dBm, *dC, *dD, *dh0;
  float *part_bc, *part_ad;
  int B, T, d, n;
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

// The warp's sum of each of the V values of v (V a power of two, <= 32),
// by a butterfly reduce-scatter: lane l returns the sum of value l % V.
template <int V>
__device__ __forceinline__ float reduce_scatter(float (&v)[V], int lane) {
#pragma unroll
  for (int w = V / 2; w >= 1; w /= 2) {
    const bool upper = lane & w;
#pragma unroll
    for (int j = 0; j < w; ++j) {
      const float send = upper ? v[j] : v[j + w];
      const float keep = upper ? v[j + w] : v[j];
      v[j] = keep + __shfl_xor_sync(0xffffffffu, send, w);
    }
  }
  float r = v[0];
#pragma unroll
  for (int w = V; w < 32; w *= 2) r += __shfl_xor_sync(0xffffffffu, r, w);
  return r;
}

template <int NP>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         ((size_t)kK * NP * kThreads + 2 * kK * NP + kWarps * kK * 2 * NP);
}

template <typename TX, typename TB, int NP, typename Off>
__global__ void __launch_bounds__(kThreads)
selective_scan_bwd_kernel(const TX* __restrict__ x,
                          const float* __restrict__ dt,
                          const float* __restrict__ A,
                          const TB* __restrict__ Bm,
                          const TB* __restrict__ Cm,
                          const float* __restrict__ Dv,
                          const float* __restrict__ ckpt,
                          const TX* __restrict__ dy,
                          const float* __restrict__ dh_last,
                          TX* __restrict__ dx, float* __restrict__ ddt,
                          float* __restrict__ dh0,
                          float* __restrict__ part_bc,
                          float* __restrict__ part_ad, int T_, int d, int n,
                          long long sb_b, long long sb_t, long long sc_b,
                          long long sc_t) {
  constexpr int V = 2 * NP;           // dB and dC values of a step
  extern __shared__ __align__(16) float smem[];
  float* sH = smem;                               // [kK][NP][kThreads]
  float* sB = sH + kK * NP * kThreads;            // [kK][NP]
  float* sC = sB + kK * NP;                       // [kK][NP]
  float* sRed = sC + kK * NP;                     // [kWarps][kK][V]

  const int b = blockIdx.y, blk = blockIdx.x, nblk = gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ch = blk * kThreads + tid;
  const bool live = ch < d;
  const int chl = live ? ch : 0;
  const int nck = (T_ + kK - 1) / kK;

  const size_t hbase = ((size_t)b * d + chl) * n;
  float A2[NP], g[NP], dA[NP];
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    const bool ok = live && i < n;
    A2[i] = ok ? A[(size_t)chl * n + i] * kLog2e : 0.f;   // the forward's
    g[i] = ok ? dh_last[hbase + i] : 0.f;
    dA[i] = 0.f;
  }
  const float Dch = live ? Dv[chl] : 0.f;
  float dD = 0.f;

  const size_t base = (size_t)b * T_ * d + chl;
  const TB* Bp = Bm + b * sb_b;
  const TB* Cp = Cm + b * sc_b;

  for (int c = nck - 1; c >= 0; --c) {
    const int t0 = c * kK;
    __syncthreads();                    // the previous chunk's smem is read
    for (int idx = tid; idx < kK * NP; idx += kThreads) {
      const int r = idx / NP, i = idx % NP, t = t0 + r;
      const bool ok = t < T_ && i < n;
      const long long tc = min(t, T_ - 1), ic = min(i, n - 1);
      const float bv = to_f32(Bp[tc * sb_t + ic]);
      const float cv = to_f32(Cp[tc * sc_t + ic]);
      sB[idx] = ok ? bv : 0.f;
      sC[idx] = ok ? cv : 0.f;
    }
    // x, dt of the chunk's steps (0 past T and off the channels), kept for
    // both passes; the chunk's first state from the checkpoint
    float xs[kK], dts[kK], h[NP];
#pragma unroll
    for (int u = 0; u < kK; ++u) {
      const Off off = (Off)min(t0 + u, T_ - 1) * (Off)d;
      const float xv = to_f32(x[base + off]);
      const float dv = dt[base + off];
      const bool ok = live && t0 + u < T_;
      xs[u] = ok ? xv : 0.f;
      dts[u] = ok ? dv : 0.f;
    }
    const float* cp = ckpt + (((size_t)b * nck + c) * d + chl) * n;
#pragma unroll
    for (int i = 0; i < NP; ++i) h[i] = live && i < n ? cp[i] : 0.f;
    __syncthreads();                    // sB, sC staged

    // recompute: the state before each step, as the forward computes it
#pragma unroll
    for (int u = 0; u < kK; ++u) {
      const float dtv = dts[u];
      const float dtx = dtv * xs[u];
#pragma unroll
      for (int i = 0; i < NP; ++i) {
        sH[(u * NP + i) * kThreads + tid] = h[i];
        const float e = hopper::ex2_approx(dtv * A2[i]);
        h[i] = fmaf(e, h[i], dtx * sB[u * NP + i]);
      }
    }

    // the chunk's steps in reverse
#pragma unroll
    for (int u = kK - 1; u >= 0; --u) {
      const int t = t0 + u;
      const Off off = (Off)min(t, T_ - 1) * (Off)d;
      const float dyr = to_f32(dy[base + off]);
      const bool ok = live && t < T_;
      const float dyv = ok ? dyr : 0.f;
      const float dtv = dts[u], xv = xs[u];
      const float dtx = dtv * xv;
      float vals[V];                    // dB (NP), then dC (NP), this step
      float gb = 0.f, gea = 0.f;
#pragma unroll
      for (int i = 0; i < NP; ++i) {
        const float bi = sB[u * NP + i];
        const float hp = sH[(u * NP + i) * kThreads + tid];
        g[i] = fmaf(dyv, sC[u * NP + i], g[i]);
        const float e = hopper::ex2_approx(dtv * A2[i]);
        const float ht = fmaf(e, hp, dtx * bi);      // h_t, the forward's
        vals[NP + i] = dyv * ht;
        vals[i] = g[i] * dtx;
        const float ghe = g[i] * hp * e;
        dA[i] = fmaf(ghe, dtv, dA[i]);
        gea = fmaf(ghe, A2[i], gea);
        gb = fmaf(g[i], bi, gb);
        g[i] *= e;
      }
      dD = fmaf(dyv, xv, dD);
      if (ok) {
        dx[base + off] = from_f32<TX>(fmaf(gb, dtv, Dch * dyv));
        ddt[base + off] = fmaf(gea, kLn2, gb * xv);
      }
      const float s = reduce_scatter<V>(vals, lane);
      if (lane < V) sRed[(warp * kK + u) * V + lane] = s;
    }
    __syncthreads();                    // every warp's sums are in sRed
    for (int idx = tid; idx < kK * V; idx += kThreads) {
      const int u = idx / V, j = idx % V, t = t0 + u;
      if (t >= T_) continue;
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += sRed[(w * kK + u) * V + j];
      part_bc[(((size_t)b * nblk + blk) * T_ + t) * V + j] = s;
    }
  }
  if (live) {
    float* pa = part_ad + ((size_t)b * d + ch) * (n + 1);
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      if (i < n) {
        dh0[hbase + i] = g[i];
        pa[i] = dA[i];
      }
    }
    pa[n] = dD;
  }
}

// dBm, dC (B, T, n) contiguous: the blocks' partial sums, in block order.
template <typename TB, int NP>
__global__ void reduce_bc_kernel(const float* __restrict__ part_bc,
                                 TB* __restrict__ dBm, TB* __restrict__ dC,
                                 int B, int T_, int n, int nblk) {
  constexpr int V = 2 * NP;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)B * T_ * V) return;
  const int j = idx % V;
  const size_t bt = idx / V;                      // b * T + t
  const int b = bt / T_, t = bt % T_;
  const int i = j % NP;
  if (i >= n) return;
  float s = 0.f;
  for (int k = 0; k < nblk; ++k)
    s += part_bc[(((size_t)b * nblk + k) * T_ + t) * V + j];
  (j < NP ? dBm : dC)[bt * n + i] = from_f32<TB>(s);
}

// dA (d, n) and dD (d): the batch rows' partial sums, in row order.
__global__ void reduce_ad_kernel(const float* __restrict__ part_ad,
                                 float* __restrict__ dA,
                                 float* __restrict__ dD, int B, int d,
                                 int n) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)d * (n + 1)) return;
  float s = 0.f;
  for (int b = 0; b < B; ++b) s += part_ad[(size_t)b * d * (n + 1) + idx];
  const size_t ch = idx / (n + 1), i = idx % (n + 1);
  if (i < (size_t)n)
    dA[ch * n + i] = s;
  else
    dD[ch] = s;
}

template <typename TX, typename TB, int NP, typename Off>
int launch(const Args& a, cudaStream_t stream) {
  auto kernel = selective_scan_bwd_kernel<TX, TB, NP, Off>;
  constexpr size_t smem = smem_bytes<NP>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int nblk = (a.d + kThreads - 1) / kThreads;
  kernel<<<dim3(nblk, a.B), kThreads, smem, stream>>>(
      static_cast<const TX*>(a.x), static_cast<const float*>(a.dt),
      static_cast<const float*>(a.A), static_cast<const TB*>(a.Bm),
      static_cast<const TB*>(a.C), static_cast<const float*>(a.D),
      static_cast<const float*>(a.ckpt), static_cast<const TX*>(a.dy),
      static_cast<const float*>(a.dh_last), static_cast<TX*>(a.dx),
      static_cast<float*>(a.ddt), static_cast<float*>(a.dh0), a.part_bc,
      a.part_ad, a.T, a.d, a.n, a.sb_b, a.sb_t, a.sc_b, a.sc_t);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  constexpr int kR = 256;
  const size_t nbc = (size_t)a.B * a.T * 2 * NP;
  reduce_bc_kernel<TB, NP><<<(unsigned)((nbc + kR - 1) / kR), kR, 0, stream>>>(
      a.part_bc, static_cast<TB*>(a.dBm), static_cast<TB*>(a.dC), a.B, a.T,
      a.n, nblk);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const size_t nad = (size_t)a.d * (a.n + 1);
  reduce_ad_kernel<<<(unsigned)((nad + kR - 1) / kR), kR, 0, stream>>>(
      a.part_ad, static_cast<float*>(a.dA), static_cast<float*>(a.dD), a.B,
      a.d, a.n);
  return (int)cudaGetLastError();
}

template <typename TX, typename TB, int NP>
int launch_off(const Args& a, cudaStream_t stream) {
  if ((long long)a.T * a.d < (1ll << 31))
    return launch<TX, TB, NP, uint32_t>(a, stream);
  return launch<TX, TB, NP, uint64_t>(a, stream);
}

template <typename TX, typename TB>
int launch_np(const Args& a, cudaStream_t stream) {
  if (a.n <= 4) return launch_off<TX, TB, 4>(a, stream);
  if (a.n <= 8) return launch_off<TX, TB, 8>(a, stream);
  if (a.n <= 16) return launch_off<TX, TB, 16>(a, stream);
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

// The forward's inputs as selective_scan takes them, its checkpoints ckpt
// (B, ceil(T / ck), d, n) float32 from selective_scan_ckpt with ck = 16, dy
// (B, T, d) in x's dtype and dh_last (B, d, n) float32, contiguous.
// Writes dx (x's dtype), ddt (B, T, d), dA (d, n), dD (d), dh0 (B, d, n)
// float32 and dBm, dC (B, T, n) contiguous in bc_dtype; part_bc
// (B, ceil(d / 64), T, 2 NP) and part_ad (B, d, n + 1) float32 are scratch
// (NP: n padded to 4, 8 or 16).  Launches on `stream`, does not
// synchronise, and returns the cudaError_t of the launches (0 on success).
int selective_scan_bwd(const void* x, const void* dt, const void* A,
                       const void* Bm, const void* C, const void* D,
                       const void* ckpt, const void* dy, const void* dh_last,
                       void* dx, void* ddt, void* dA, void* dBm, void* dC,
                       void* dD, void* dh0, void* part_bc, void* part_ad,
                       int x_dtype, int bc_dtype, int B, int T, int d, int n,
                       int ck, long long sb_b, long long sb_t, long long sc_b,
                       long long sc_t, void* stream) {
  if (B <= 0 || B > 65535 || d <= 0 || T < 1 || n < 1 || n > 16 || ck != kK)
    return (int)cudaErrorInvalidValue;
  const Args a{x, dt, A, Bm, C, D, ckpt, dy, dh_last, dx, ddt, dA, dBm, dC,
               dD, dh0, static_cast<float*>(part_bc),
               static_cast<float*>(part_ad), B, T, d, n, sb_b, sb_t, sc_b,
               sc_t};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0) return launch_bc<float>(bc_dtype, a, s);
  if (x_dtype == 1) return launch_bc<__nv_bfloat16>(bc_dtype, a, s);
  return (int)cudaErrorInvalidValue;
}

const char* selective_scan_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
