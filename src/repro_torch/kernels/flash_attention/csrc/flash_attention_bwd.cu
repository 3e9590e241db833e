// Flash attention, backward, for NVIDIA Hopper (sm_90a), bf16 or f32.
//
// The gradient of the Pallas TPU kernel
//   src/repro/kernels/flash_attention/pallas_kernel.py::flash_attention_pallas
// which has no backward of its own: the JAX package trains through XLA
// autodiff of its chunked path with jax.checkpoint recompute
// (src/repro/kernels/flash_attention/xla.py:118-126).  Given q, k, v, the
// forward's o and its natural-log log-sum-exp lse (B, H, Sq) f32
// (flash_attention_fwd.cu), and dO, it computes
//   s  = mask(softcap(scale * q.k^T))      (recomputed)
//   P  = exp(s - lse)                      (0 where masked)
//   dP = dO . v^T,  Delta = rowsum(dO * O)
//   dS = P * (dP - Delta) * scale * (1 - (s / softcap)^2)
//   dq = dS . k,  dk = dS^T . q,  dv = P^T . dO
// with dk and dv summed over the G q heads of each kv head, and the
// forward's masks: causal, window, q_offset, segment ids, ragged tails.
// Fully masked rows give zero gradients.
//
// What bounds it on an H100.  Five products of the live (q, k) area (s,
// dP, dv, dk, dq; this design recomputes s and dP once more for dq), at
// the gemma2-2b train shape (B=2, S=1024, H=8, KH=4, D=256, causal) about
// 21.5 GFLOP: 21.7 us at the bf16 tensor-core peak (989 TFLOP/s), against
// 29 MB moved (q, k, v, o, dO, dq, dk, dv once), 8.7 us at 3.35 TB/s.  So
// it is bound by operations.
//
// Design: right and simple first (a wgmma/TMA redesign is later work).
//  * Delta: one warp per row, f32 sums of dO * O.
//  * dK/dV: one block per (b, kv head, 64-position kv tile).  It loops over
//    the G q heads of its kv head and the 64-position q tiles that the
//    causal and window masks leave live; per q tile it computes s^T and
//    dP^T (kv rows x q columns), forms P and dS into shared memory, and
//    adds P^T . dO and dS^T . q into dv and dk, which stay in registers and
//    are written once.  No atomics: every output has one writer and a
//    fixed summation order, so two calls give bitwise-equal gradients.
//  * dQ: one block per (b, q head, 64-position q tile), looping over the
//    live kv tiles: s and dP again, dS into shared memory, dq += dS . k.
//  * bf16: warp-level mma.sync m16n8k16 with f32 accumulation.  Registers
//    bound the tile: at D = 256 the dk and dv accumulators of 64 kv rows
//    are 2 x 64 x 256 f32.  The block has 4 x (D / 64) warps (4 for D <=
//    64): warp w owns kv rows 16 (w % 4) .. + 16 and output columns
//    64 (w / 4) .. + 64, so each thread holds 64 accumulator floats at
//    every D; in the s/dP phase the same warp takes q columns
//    (64 / splits) (w / 4) .. of its rows.  The tanh of the softcap is the
//    forward's bounded tanh_ex2 and the exponential ex2.approx, so P's rows
//    sum as the forward's did.  P and dS are rounded to bf16 for their
//    products (as the forward rounds P).
//  * f32: the same structure on CUDA cores (32-position tiles, 256
//    threads), tanhf and expf as the f32 forward.
//
// Build (plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libflash_attention_bwd.so flash_attention_bwd.cu

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "../../common/hopper.cuh"

namespace {

constexpr size_t kSmemLimit = 232448;   // dynamic shared memory of a block
constexpr int kMaxGroup = 64;           // q heads per kv head (the forward's)
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  int B, Sq, Sk, H, KH, G;
  int causal, window, q_offset;
  float softcap, scale;
  const int* seg_q;    // (B, Sq) or null
  const int* seg_kv;   // (B, Sk), null with seg_q
};

// Whether q position i (0-based in q) sees kv position kp, by every mask
// but the segments.
__device__ __forceinline__ bool visible(const Params& p, int i, int kp) {
  const int qpos = p.q_offset + i;
  bool ok = i < p.Sq && kp < p.Sk;
  if (p.causal) ok = ok && kp <= qpos;
  if (p.window > 0) ok = ok && qpos - kp < p.window;
  return ok;
}

// The q positions [begin, end) that can see some position of the kv tile
// [k0, k0 + tile), begin rounded down to a multiple of `tile`.
__device__ __forceinline__ void q_range(const Params& p, int k0, int tile,
                                        int& begin, int& end) {
  begin = p.causal ? max(0, k0 - p.q_offset) : 0;
  end = p.window > 0 ? min(p.Sq, k0 + tile - 1 + p.window - p.q_offset)
                     : p.Sq;
  begin = (begin / tile) * tile;
}

// The kv positions [begin, end) that the q tile [i0, i0 + tile) can see,
// begin rounded down to a multiple of `tile`.
__device__ __forceinline__ void kv_range(const Params& p, int i0, int tile,
                                         int& begin, int& end) {
  const int q_lo = p.q_offset + i0;
  const int q_hi = p.q_offset + min(i0 + tile, p.Sq) - 1;
  end = p.causal ? min(p.Sk, q_hi + 1) : p.Sk;
  begin = p.window > 0 ? max(0, q_lo - p.window + 1) : 0;
  begin = (begin / tile) * tile;
}

__device__ __forceinline__ int seg_at(const int* seg, int b, int S, int i) {
  return seg && i < S ? seg[(size_t)b * S + i] : 0;
}

// Row index of (b, head h, position i) in (B, H, Sq) lse and delta.
__device__ __forceinline__ size_t row_index(const Params& p, int b, int h,
                                            int i) {
  return ((size_t)b * p.H + h) * p.Sq + i;
}

// dS of one entry from its raw dot products: dot = q.k, dpv = dO.v.  For
// bf16 (kFast) the softcap's tanh is tanh_ex2 and the exponential ex2,
// as in the wgmma forward; for f32 tanhf and expf, as in the f32 forward.
// Returns P; writes dS (with the chain factor scale (1 - t^2)).
template <bool kFast>
__device__ __forceinline__ float grad_entry(const Params& p, float dot,
                                            float dpv, float lse, float delta,
                                            bool ok, float& ds) {
  float x = dot * p.scale, chain = p.scale;
  if (p.softcap > 0.f) {
    const float t = kFast ? hopper::tanh_ex2(x * (2.f * kLog2e / p.softcap))
                          : tanhf(x / p.softcap);
    x = t * p.softcap;
    chain *= 1.f - t * t;
  }
  float pr = 0.f;
  if (ok)
    pr = kFast ? hopper::ex2_approx((x - lse) * kLog2e) : expf(x - lse);
  ds = pr * (dpv - delta) * chain;
  return pr;
}

// ============================================================== Delta

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// delta[b, h, i] = sum_d dO[b, i, h, d] * O[b, i, h, d], one warp a row.
template <typename T>
__global__ void __launch_bounds__(256)
flash_attention_bwd_delta(const T* __restrict__ o, const T* __restrict__ dO,
                          float* __restrict__ delta, Params p, int D) {
  const long long row = (long long)blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= (long long)p.B * p.Sq * p.H) return;
  const int h = (int)(row % p.H);
  const long long bi = row / p.H;
  const int i = (int)(bi % p.Sq), b = (int)(bi / p.Sq);
  const T* orow = o + row * D;
  const T* drow = dO + row * D;
  float sum = 0.f;
  for (int d = lane; d < D; d += 32)
    sum = fmaf(to_f32(orow[d]), to_f32(drow[d]), sum);
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (lane == 0) delta[row_index(p, b, h, i)] = sum;
}

// ==================================================== bf16: mma.sync

namespace tc {

using hopper::cp_async16;
using hopper::cp_async_wait_all;
using hopper::ld_u32;
using hopper::ldmatrix_x2_trans;
using hopper::mma_16816;
using hopper::pack_bf16;
using bf16 = __nv_bfloat16;

constexpr int kTile = 64;   // q and kv positions per tile

template <int D>
struct Cfg {
  static constexpr int kSplit = D >= 64 ? D / 64 : 1;   // column groups
  static constexpr int kWarps = 4 * kSplit;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int NC = kTile / kSplit;   // s/dP columns per warp
  static constexpr int DC = D / kSplit;       // output columns per warp
  static constexpr int RS = D + 8;            // q, k, v, dO row stride
  static constexpr int PS = kTile + 8;        // P, dS row stride
  static constexpr size_t kSmem =
      sizeof(bf16) * (4 * size_t(kTile) * RS + 2 * size_t(kTile) * PS) +
      3 * sizeof(float) * kTile;
  static_assert(kSmem <= kSmemLimit, "tiles exceed a block");
  static_assert(NC % 8 == 0 && DC % 8 == 0, "whole 8-column mma tiles");
};

// 64 rows of a (B, S, heads, D) tensor from row `r0` of head `h` into a
// tile of row stride RS, zero past S.
template <int D>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, int b,
                                          int r0, int S, int heads, int h,
                                          int tid, int nthreads) {
  constexpr int RC = D / 8, RS = Cfg<D>::RS;
  for (int idx = tid; idx < kTile * RC; idx += nthreads) {
    const int r = idx / RC, ch = idx % RC;
    const bool ok = r0 + r < S;
    const size_t off = (((size_t)b * S + r0 + r) * heads + h) * D + ch * 8;
    cp_async16(dst + r * RS + ch * 8, ok ? src + off : src, ok);
  }
}

// c (16 x NC) = A (16 rows at a) . B^T (NC rows at bt), over D; a and bt
// are tiles of row stride RS.
template <int D, int NC>
__device__ __forceinline__ void dot_rows(float (&c)[NC / 8][4],
                                         const bf16* a, const bf16* bt,
                                         int lane) {
  constexpr int RS = Cfg<D>::RS;
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int n = 0; n < NC / 8; ++n) c[n][0] = c[n][1] = c[n][2] = c[n][3] = 0.f;
#pragma unroll 2
  for (int kk = 0; kk < D; kk += 16) {
    const bf16* ap = a + g * RS + kk + 2 * t;
    const uint32_t af[4] = {ld_u32(ap), ld_u32(ap + 8 * RS), ld_u32(ap + 8),
                            ld_u32(ap + 8 * RS + 8)};
#pragma unroll
    for (int n = 0; n < NC / 8; ++n) {
      const bf16* bp = bt + (n * 8 + g) * RS + kk + 2 * t;
      mma_16816(c[n], af, ld_u32(bp), ld_u32(bp + 8));
    }
  }
}

// c (16 x DC) += A (16 x 64, rows at a, stride PS) . B (64 x DC, the rows
// of the tile at b from column c0, stride RS).
template <int D>
__device__ __forceinline__ void add_product(float (&c)[Cfg<D>::DC / 8][4],
                                            const bf16* a, const bf16* b,
                                            int c0, int lane) {
  constexpr int RS = Cfg<D>::RS, PS = Cfg<D>::PS, DC = Cfg<D>::DC;
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int kk = 0; kk < kTile; kk += 16) {
    const bf16* ap = a + g * PS + kk + 2 * t;
    const uint32_t af[4] = {ld_u32(ap), ld_u32(ap + 8 * PS), ld_u32(ap + 8),
                            ld_u32(ap + 8 * PS + 8)};
    const bf16* brow = b + (kk + lane % 16) * RS + c0;
#pragma unroll
    for (int j = 0; j < DC / 8; ++j) {
      uint32_t b0, b1;
      ldmatrix_x2_trans(b0, b1, brow + j * 8);
      mma_16816(c[j], af, b0, b1);
    }
  }
}

// The 16 x DC accumulator of rows r0 + 16 (warp % 4) .. of a (B, S, heads,
// D) output at head h, columns c0 .., as bf16 (rows past S skipped).
template <int D>
__device__ __forceinline__ void store_rows(bf16* out,
                                           const float (&c)[Cfg<D>::DC / 8][4],
                                           int b, int r0, int S, int heads,
                                           int h, int c0, int lane) {
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + g + 8 * half;
    if (r >= S) continue;
    bf16* row = out + (((size_t)b * S + r) * heads + h) * D + c0 + 2 * t;
#pragma unroll
    for (int j = 0; j < Cfg<D>::DC / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * j) = __floats2bfloat162_rn(
          c[j][2 * half], c[j][2 * half + 1]);
  }
}

template <int D>
__global__ void __launch_bounds__(Cfg<D>::kThreads, 1)
flash_attention_bwd_dkdv_tc(const bf16* __restrict__ q,
                            const bf16* __restrict__ k,
                            const bf16* __restrict__ v,
                            const bf16* __restrict__ dO,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            bf16* __restrict__ dk, bf16* __restrict__ dv,
                            Params p) {
  using C = Cfg<D>;
  constexpr int RS = C::RS, PS = C::PS, NC = C::NC, DC = C::DC;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);
  bf16* sV = sK + kTile * RS;
  bf16* sQ = sV + kTile * RS;
  bf16* sdO = sQ + kTile * RS;
  bf16* sP = sdO + kTile * RS;
  bf16* sdS = sP + kTile * PS;
  float* sLse = reinterpret_cast<float*>(sdS + kTile * PS);
  float* sDelta = sLse + kTile;
  int* sSeg = reinterpret_cast<int*>(sDelta + kTile);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int rg = warp % 4, cg = warp / 4;
  const int b = blockIdx.y / p.KH, kh = blockIdx.y % p.KH;
  const int k0 = blockIdx.x * kTile;

  load_rows<D>(sK, k, b, k0, p.Sk, p.KH, kh, tid, C::kThreads);
  load_rows<D>(sV, v, b, k0, p.Sk, p.KH, kh, tid, C::kThreads);
  int kp[2], sk[2];   // the thread's two kv rows in the s^T phase
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    kp[e] = k0 + rg * 16 + g + 8 * e;
    sk[e] = seg_at(p.seg_kv, b, p.Sk, kp[e]);
  }
  float acc_k[DC / 8][4], acc_v[DC / 8][4];
#pragma unroll
  for (int j = 0; j < DC / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[j][e] = acc_v[j][e] = 0.f;

  int i_begin, i_end;
  q_range(p, k0, kTile, i_begin, i_end);
  for (int gh = 0; gh < p.G; ++gh) {
    const int h = kh * p.G + gh;
    for (int i0 = i_begin; i0 < i_end; i0 += kTile) {
      __syncthreads();   // the last tile's reads of sQ, sdO, sP, sdS done
      load_rows<D>(sQ, q, b, i0, p.Sq, p.H, h, tid, C::kThreads);
      load_rows<D>(sdO, dO, b, i0, p.Sq, p.H, h, tid, C::kThreads);
      if (tid < kTile) {
        const bool ok = i0 + tid < p.Sq;
        sLse[tid] = ok ? lse[row_index(p, b, h, i0 + tid)] : 0.f;
        sDelta[tid] = ok ? delta[row_index(p, b, h, i0 + tid)] : 0.f;
        sSeg[tid] = seg_at(p.seg_q, b, p.Sq, i0 + tid);
      }
      cp_async_wait_all();
      __syncthreads();

      // s^T and dP^T: kv rows 16 rg .., q columns NC cg ..
      float s[NC / 8][4], dp[NC / 8][4];
      dot_rows<D, NC>(s, sK + rg * 16 * RS, sQ + cg * NC * RS, lane);
      dot_rows<D, NC>(dp, sV + rg * 16 * RS, sdO + cg * NC * RS, lane);
#pragma unroll
      for (int n = 0; n < NC / 8; ++n)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = rg * 16 + g + 8 * half;
          const int col = cg * NC + n * 8 + 2 * t;
          float pr[2], ds[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = col + e;
            const bool ok = visible(p, i0 + c, kp[half]) &&
                            sSeg[c] == sk[half];
            pr[e] = grad_entry<true>(p, s[n][2 * half + e],
                                     dp[n][2 * half + e], sLse[c], sDelta[c],
                                     ok, ds[e]);
          }
          *reinterpret_cast<uint32_t*>(sP + row * PS + col) =
              pack_bf16(pr[0], pr[1]);
          *reinterpret_cast<uint32_t*>(sdS + row * PS + col) =
              pack_bf16(ds[0], ds[1]);
        }
      __syncthreads();

      // dv += P^T . dO, dk += dS^T . q: kv rows 16 rg .., columns DC cg ..
      add_product<D>(acc_v, sP + rg * 16 * PS, sdO, cg * DC, lane);
      add_product<D>(acc_k, sdS + rg * 16 * PS, sQ, cg * DC, lane);
    }
  }
  store_rows<D>(dk, acc_k, b, k0 + rg * 16, p.Sk, p.KH, kh, cg * DC, lane);
  store_rows<D>(dv, acc_v, b, k0 + rg * 16, p.Sk, p.KH, kh, cg * DC, lane);
}

template <int D>
__global__ void __launch_bounds__(Cfg<D>::kThreads, 1)
flash_attention_bwd_dq_tc(const bf16* __restrict__ q,
                          const bf16* __restrict__ k,
                          const bf16* __restrict__ v,
                          const bf16* __restrict__ dO,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          bf16* __restrict__ dq, Params p) {
  using C = Cfg<D>;
  constexpr int RS = C::RS, PS = C::PS, NC = C::NC, DC = C::DC;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sdO = sQ + kTile * RS;
  bf16* sK = sdO + kTile * RS;
  bf16* sV = sK + kTile * RS;
  bf16* sdS = sV + kTile * RS;
  int* sSeg = reinterpret_cast<int*>(sdS + 2 * kTile * PS);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int rg = warp % 4, cg = warp / 4;
  const int b = blockIdx.y / p.H, h = blockIdx.y % p.H, kh = h / p.G;
  const int i0 = blockIdx.x * kTile;

  load_rows<D>(sQ, q, b, i0, p.Sq, p.H, h, tid, C::kThreads);
  load_rows<D>(sdO, dO, b, i0, p.Sq, p.H, h, tid, C::kThreads);
  int qi[2], sq[2];   // the thread's two q rows in the s phase
  float ls[2], dl[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    qi[e] = i0 + rg * 16 + g + 8 * e;
    const bool ok = qi[e] < p.Sq;
    ls[e] = ok ? lse[row_index(p, b, h, qi[e])] : 0.f;
    dl[e] = ok ? delta[row_index(p, b, h, qi[e])] : 0.f;
    sq[e] = seg_at(p.seg_q, b, p.Sq, qi[e]);
  }
  float acc[DC / 8][4];
#pragma unroll
  for (int j = 0; j < DC / 8; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  int kv_begin, kv_end;
  kv_range(p, i0, kTile, kv_begin, kv_end);
  for (int k0 = kv_begin; k0 < kv_end; k0 += kTile) {
    __syncthreads();   // the last tile's reads of sK, sV, sdS done
    load_rows<D>(sK, k, b, k0, p.Sk, p.KH, kh, tid, C::kThreads);
    load_rows<D>(sV, v, b, k0, p.Sk, p.KH, kh, tid, C::kThreads);
    if (tid < kTile) sSeg[tid] = seg_at(p.seg_kv, b, p.Sk, k0 + tid);
    cp_async_wait_all();
    __syncthreads();

    // s and dP: q rows 16 rg .., kv columns NC cg ..
    float s[NC / 8][4], dp[NC / 8][4];
    dot_rows<D, NC>(s, sQ + rg * 16 * RS, sK + cg * NC * RS, lane);
    dot_rows<D, NC>(dp, sdO + rg * 16 * RS, sV + cg * NC * RS, lane);
#pragma unroll
    for (int n = 0; n < NC / 8; ++n)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = rg * 16 + g + 8 * half;
        const int col = cg * NC + n * 8 + 2 * t;
        float ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = col + e;
          const bool ok = visible(p, qi[half], k0 + c) && sSeg[c] == sq[half];
          grad_entry<true>(p, s[n][2 * half + e], dp[n][2 * half + e],
                           ls[half], dl[half], ok, ds[e]);
        }
        *reinterpret_cast<uint32_t*>(sdS + row * PS + col) =
            pack_bf16(ds[0], ds[1]);
      }
    __syncthreads();

    // dq += dS . k: q rows 16 rg .., columns DC cg ..
    add_product<D>(acc, sdS + rg * 16 * PS, sK, cg * DC, lane);
  }
  store_rows<D>(dq, acc, b, i0 + rg * 16, p.Sq, p.H, h, cg * DC, lane);
}

}  // namespace tc

// ========================================================= f32: CUDA cores

namespace cc {

constexpr int kTile = 32;       // q and kv positions per tile
constexpr int kThreads = 256;   // 8 threads a row of a 32-row tile
constexpr int kLanes = 8;

template <int D>
struct Cfg {
  static constexpr int RS = D + 4;        // q, k, v, dO row stride (floats)
  static constexpr int PS = kTile + 1;    // P, dS row stride
  static constexpr int CH = (D / 4 + kLanes - 1) / kLanes;   // float4 / lane
  static constexpr size_t kSmem =
      sizeof(float) * (4 * size_t(kTile) * RS + 2 * size_t(kTile) * PS +
                       3 * kTile);
  static_assert(kSmem <= kSmemLimit, "tiles exceed a block");
};

template <int D>
__device__ __forceinline__ void load_rows(float* dst, const float* src, int b,
                                          int r0, int S, int heads, int h,
                                          int tid) {
  constexpr int RC = D / 4, RS = Cfg<D>::RS;
  for (int idx = tid; idx < kTile * RC; idx += kThreads) {
    const int r = idx / RC, ch = idx % RC;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < S)
      val = *reinterpret_cast<const float4*>(
          src + (((size_t)b * S + r0 + r) * heads + h) * D + ch * 4);
    *reinterpret_cast<float4*>(dst + r * RS + ch * 4) = val;
  }
}

template <int D>
__device__ __forceinline__ float dot(const float* a, const float* b) {
  float s = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    const float4 x = *reinterpret_cast<const float4*>(a + d);
    const float4 y = *reinterpret_cast<const float4*>(b + d);
    s = fmaf(x.x, y.x, s);
    s = fmaf(x.y, y.y, s);
    s = fmaf(x.z, y.z, s);
    s = fmaf(x.w, y.w, s);
  }
  return s;
}

// c[j] (row r of a 32 x D output, float4 chunks lane + 8 j) += sum_k
// A[r][k] B[k][.] over the tile's 32 k rows.
template <int D>
__device__ __forceinline__ void add_product(float4 (&c)[Cfg<D>::CH],
                                            const float* a, const float* b,
                                            int r, int lane) {
  constexpr int RS = Cfg<D>::RS, PS = Cfg<D>::PS;
  for (int kk = 0; kk < kTile; ++kk) {
    const float x = a[r * PS + kk];
#pragma unroll
    for (int j = 0; j < Cfg<D>::CH; ++j) {
      const int ch = lane + kLanes * j;
      if (ch < D / 4) {
        const float4 y = *reinterpret_cast<const float4*>(b + kk * RS + 4 * ch);
        c[j].x = fmaf(x, y.x, c[j].x);
        c[j].y = fmaf(x, y.y, c[j].y);
        c[j].z = fmaf(x, y.z, c[j].z);
        c[j].w = fmaf(x, y.w, c[j].w);
      }
    }
  }
}

template <int D>
__device__ __forceinline__ void store_row(float* out,
                                          const float4 (&c)[Cfg<D>::CH], int b,
                                          int r, int S, int heads, int h,
                                          int lane) {
  if (r >= S) return;
  float* row = out + (((size_t)b * S + r) * heads + h) * D;
#pragma unroll
  for (int j = 0; j < Cfg<D>::CH; ++j) {
    const int ch = lane + kLanes * j;
    if (ch < D / 4) *reinterpret_cast<float4*>(row + 4 * ch) = c[j];
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_bwd_dkdv_cc(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            const float* __restrict__ dO,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            float* __restrict__ dk, float* __restrict__ dv,
                            Params p) {
  using C = Cfg<D>;
  constexpr int RS = C::RS, PS = C::PS;
  extern __shared__ __align__(16) float smem[];
  float* sK = smem;
  float* sV = sK + kTile * RS;
  float* sQ = sV + kTile * RS;
  float* sdO = sQ + kTile * RS;
  float* sP = sdO + kTile * RS;      // P^T: kv rows, q columns
  float* sdS = sP + kTile * PS;
  float* sLse = sdS + kTile * PS;
  float* sDelta = sLse + kTile;
  int* sSeg = reinterpret_cast<int*>(sDelta + kTile);

  const int tid = threadIdx.x, r = tid / kLanes, lane = tid % kLanes;
  const int b = blockIdx.y / p.KH, kh = blockIdx.y % p.KH;
  const int k0 = blockIdx.x * kTile;
  load_rows<D>(sK, k, b, k0, p.Sk, p.KH, kh, tid);
  load_rows<D>(sV, v, b, k0, p.Sk, p.KH, kh, tid);
  const int kp = k0 + r, sk = seg_at(p.seg_kv, b, p.Sk, kp);
  float4 acc_k[C::CH], acc_v[C::CH];
#pragma unroll
  for (int j = 0; j < C::CH; ++j)
    acc_k[j] = acc_v[j] = make_float4(0.f, 0.f, 0.f, 0.f);

  int i_begin, i_end;
  q_range(p, k0, kTile, i_begin, i_end);
  for (int gh = 0; gh < p.G; ++gh) {
    const int h = kh * p.G + gh;
    for (int i0 = i_begin; i0 < i_end; i0 += kTile) {
      __syncthreads();   // the last tile's reads done
      load_rows<D>(sQ, q, b, i0, p.Sq, p.H, h, tid);
      load_rows<D>(sdO, dO, b, i0, p.Sq, p.H, h, tid);
      if (tid < kTile) {
        const bool ok = i0 + tid < p.Sq;
        sLse[tid] = ok ? lse[row_index(p, b, h, i0 + tid)] : 0.f;
        sDelta[tid] = ok ? delta[row_index(p, b, h, i0 + tid)] : 0.f;
        sSeg[tid] = seg_at(p.seg_q, b, p.Sq, i0 + tid);
      }
      __syncthreads();
      // P^T and dS^T: kv row r, q columns lane + 8 m
#pragma unroll
      for (int m = 0; m < kTile / kLanes; ++m) {
        const int c = lane + kLanes * m;
        const bool ok = visible(p, i0 + c, kp) && sSeg[c] == sk;
        float ds;
        sP[r * PS + c] = grad_entry<false>(
            p, dot<D>(sK + r * RS, sQ + c * RS),
            dot<D>(sV + r * RS, sdO + c * RS), sLse[c], sDelta[c], ok, ds);
        sdS[r * PS + c] = ds;
      }
      __syncthreads();
      add_product<D>(acc_v, sP, sdO, r, lane);
      add_product<D>(acc_k, sdS, sQ, r, lane);
    }
  }
  store_row<D>(dk, acc_k, b, kp, p.Sk, p.KH, kh, lane);
  store_row<D>(dv, acc_v, b, kp, p.Sk, p.KH, kh, lane);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_bwd_dq_cc(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const float* __restrict__ dO,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          float* __restrict__ dq, Params p) {
  using C = Cfg<D>;
  constexpr int RS = C::RS, PS = C::PS;
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;
  float* sdO = sQ + kTile * RS;
  float* sK = sdO + kTile * RS;
  float* sV = sK + kTile * RS;
  float* sdS = sV + kTile * RS;      // q rows, kv columns
  int* sSeg = reinterpret_cast<int*>(sdS + 2 * kTile * PS);

  const int tid = threadIdx.x, r = tid / kLanes, lane = tid % kLanes;
  const int b = blockIdx.y / p.H, h = blockIdx.y % p.H, kh = h / p.G;
  const int i0 = blockIdx.x * kTile, qi = i0 + r;
  load_rows<D>(sQ, q, b, i0, p.Sq, p.H, h, tid);
  load_rows<D>(sdO, dO, b, i0, p.Sq, p.H, h, tid);
  const bool q_ok = qi < p.Sq;
  const float ls = q_ok ? lse[row_index(p, b, h, qi)] : 0.f;
  const float dl = q_ok ? delta[row_index(p, b, h, qi)] : 0.f;
  const int sq = seg_at(p.seg_q, b, p.Sq, qi);
  float4 acc[C::CH];
#pragma unroll
  for (int j = 0; j < C::CH; ++j) acc[j] = make_float4(0.f, 0.f, 0.f, 0.f);

  int kv_begin, kv_end;
  kv_range(p, i0, kTile, kv_begin, kv_end);
  for (int k0 = kv_begin; k0 < kv_end; k0 += kTile) {
    __syncthreads();
    load_rows<D>(sK, k, b, k0, p.Sk, p.KH, kh, tid);
    load_rows<D>(sV, v, b, k0, p.Sk, p.KH, kh, tid);
    if (tid < kTile) sSeg[tid] = seg_at(p.seg_kv, b, p.Sk, k0 + tid);
    __syncthreads();
#pragma unroll
    for (int m = 0; m < kTile / kLanes; ++m) {
      const int c = lane + kLanes * m;
      const bool ok = visible(p, qi, k0 + c) && sSeg[c] == sq;
      float ds;
      grad_entry<false>(p, dot<D>(sQ + r * RS, sK + c * RS),
                        dot<D>(sdO + r * RS, sV + c * RS), ls, dl, ok, ds);
      sdS[r * PS + c] = ds;
    }
    __syncthreads();
    add_product<D>(acc, sdS, sK, r, lane);
  }
  store_row<D>(dq, acc, b, qi, p.Sq, p.H, h, lane);
}

}  // namespace cc

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* o,
           const float* lse, const void* dO, float* delta, void* dq, void* dk,
           void* dv, const Params& p, cudaStream_t stream) {
  const T* q_ = static_cast<const T*>(q);
  const T* k_ = static_cast<const T*>(k);
  const T* v_ = static_cast<const T*>(v);
  const T* o_ = static_cast<const T*>(o);
  const T* dO_ = static_cast<const T*>(dO);
  const long long rows = (long long)p.B * p.Sq * p.H;
  const long long delta_blocks = (rows + 7) / 8;
  if (delta_blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  flash_attention_bwd_delta<T><<<(unsigned)delta_blocks, 256, 0, stream>>>(
      o_, dO_, delta, p, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if constexpr (sizeof(T) == 2) {
    using C = tc::Cfg<D>;
    auto dkdv = tc::flash_attention_bwd_dkdv_tc<D>;
    auto dqk = tc::flash_attention_bwd_dq_tc<D>;
    if ((err = prepare(dkdv, C::kSmem)) != cudaSuccess) return (int)err;
    if ((err = prepare(dqk, C::kSmem)) != cudaSuccess) return (int)err;
    const dim3 g1((p.Sk + tc::kTile - 1) / tc::kTile, p.B * p.KH);
    dkdv<<<g1, C::kThreads, C::kSmem, stream>>>(
        q_, k_, v_, dO_, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
        p);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    const dim3 g2((p.Sq + tc::kTile - 1) / tc::kTile, p.B * p.H);
    dqk<<<g2, C::kThreads, C::kSmem, stream>>>(q_, k_, v_, dO_, lse, delta,
                                               static_cast<T*>(dq), p);
  } else {
    using C = cc::Cfg<D>;
    auto dkdv = cc::flash_attention_bwd_dkdv_cc<D>;
    auto dqk = cc::flash_attention_bwd_dq_cc<D>;
    if ((err = prepare(dkdv, C::kSmem)) != cudaSuccess) return (int)err;
    if ((err = prepare(dqk, C::kSmem)) != cudaSuccess) return (int)err;
    const dim3 g1((p.Sk + cc::kTile - 1) / cc::kTile, p.B * p.KH);
    dkdv<<<g1, cc::kThreads, C::kSmem, stream>>>(
        q_, k_, v_, dO_, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
        p);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    const dim3 g2((p.Sq + cc::kTile - 1) / cc::kTile, p.B * p.H);
    dqk<<<g2, cc::kThreads, C::kSmem, stream>>>(q_, k_, v_, dO_, lse, delta,
                                                static_cast<T*>(dq), p);
  }
  return (int)cudaGetLastError();
}

template <int D>
int launch_d(int dtype, const void* q, const void* k, const void* v,
             const void* o, const float* lse, const void* dO, float* delta,
             void* dq, void* dk, void* dv, const Params& p,
             cudaStream_t stream) {
  if (dtype == 0)
    return launch<float, D>(q, k, v, o, lse, dO, delta, dq, dk, dv, p, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16, D>(q, k, v, o, lse, dO, delta, dq, dk, dv, p,
                                    stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// q, o, dO, dq (B, Sq, H, D); k, v, dk, dv (B, Sk, KH, D); all contiguous,
// 16-byte aligned and of one dtype (0: float32, 1: bfloat16); lse (B, H,
// Sq) f32 from the forward with the same arguments; seg_q (B, Sq) and
// seg_kv (B, Sk) int32, both or neither (null); delta: (B, H, Sq) f32
// scratch.  Sq, Sk > 0.  Launches three kernels on `stream` (delta, dk/dv,
// dq), does not synchronise, and returns the first cudaError_t (0 on
// success).
int flash_attention_bwd(const void* q, const void* k, const void* v,
                        const void* o, const float* lse, const void* dO,
                        const int* seg_q, const int* seg_kv, float* delta,
                        void* dq, void* dk, void* dv, int dtype, int B, int Sq,
                        int Sk, int H, int KH, int D, int causal, int window,
                        float softcap, float scale, int q_offset,
                        void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || KH <= 0 || H % KH != 0 ||
      H / KH > kMaxGroup || B * KH > 65535 || B * H > 65535 ||
      (seg_q == nullptr) != (seg_kv == nullptr))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.B = B; p.Sq = Sq; p.Sk = Sk; p.H = H; p.KH = KH; p.G = H / KH;
  p.causal = causal; p.window = window; p.q_offset = q_offset;
  p.softcap = softcap; p.scale = scale;
  p.seg_q = seg_q; p.seg_kv = seg_kv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch_d<16>(dtype, q, k, v, o, lse, dO, delta, dq, dk, dv, p, s);
    case 32: return launch_d<32>(dtype, q, k, v, o, lse, dO, delta, dq, dk, dv, p, s);
    case 64: return launch_d<64>(dtype, q, k, v, o, lse, dO, delta, dq, dk, dv, p, s);
    case 128: return launch_d<128>(dtype, q, k, v, o, lse, dO, delta, dq, dk, dv, p, s);
    case 256: return launch_d<256>(dtype, q, k, v, o, lse, dO, delta, dq, dk, dv, p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* flash_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
