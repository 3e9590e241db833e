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
// dP, dv, dk, dq; the dQ items below recompute s and dP, so seven are run),
// at the gemma2-2b train shape (B=2, S=1024, H=8, KH=4, D=256, causal)
// about 21.5 GFLOP: 21.7 us at the bf16 tensor-core peak (989 TFLOP/s),
// against 29 MB moved (q, k, v, o, dO, dq, dk, dv once), 8.7 us at
// 3.35 TB/s.  So it is bound by operations.
//
// Kernels, chosen by dtype and head dim (ops.bwd_variant states the rule):
//  * Delta (every variant): one warp per row, f32 sums of dO * O.
//  * wgmma (bf16, D = 64, 128, 256: the training path).  One persistent,
//    warp-specialised kernel runs two kinds of work item:
//    - dK/dV item: the 64 kv positions of one kv tile of (b, kv head),
//      resident k and v; it streams the folded q and dO tiles that the
//      causal and window masks leave live.  A folded tile is 64 rows =
//      BQ = 64 / G positions x the G q heads of the kv head (row = position
//      * G + head, as the forward folds q), so dk and dv sum over the heads
//      inside one operand.  Where B * KH * Sk / 64 items would leave SMs
//      idle or one item would outlast the rest, each kv tile's q tiles are
//      cut into nchunk contiguous chunks; each chunk writes f32 partials to
//      a workspace, and a second kernel sums them in chunk order.
//    - dQ item: one folded q tile (64 rows), resident q and dO; it streams
//      the live 64-position k and v tiles, reading each once for the G
//      heads of the group.
//    Both kinds run the same four steps per streamed tile (R: resident, T:
//    streamed; dK/dV: R = k, v and T = q, dO; dQ: R = q, dO and T = k, v):
//      X = R0 . T0^T and Y = R1 . T1^T       (s^T, dP^T, or s, dP)
//      P = exp2(X' log2 e - lse log2 e), dS = P (Y - Delta) chain
//      acc1 += dS . T0 (dk, or dq);  acc0 += P . T1 (dv; dK/dV only)
//    X and Y are SS wgmmas (both operands K-major in shared memory); each of
//    the two consumer warpgroups takes 32 of the 64 columns (m64n32k16), so
//    no product is computed twice.  P and dS go to shared memory as bf16 by
//    stmatrix (128-byte swizzle, the K-major A layout), and the accumulating
//    products are SS wgmmas with the streamed tile as the MN-major B operand:
//    the same swizzled q (or k) tile serves K-major in X and MN-major here.
//    Each warpgroup accumulates half of D (both halves at D = 64, where a
//    32-wide MN-major operand is below the swizzle atom: the products are
//    run twice and warpgroup 0 stores), so dk and dv of a 64-row kv tile at
//    D = 256 are 128 floats a thread.  Two named barriers order the
//    warpgroups' writes of the P/dS tiles against their products.  The
//    elementwise step (three special-function results per entry under a
//    softcap) was half the time at D = 128 when nothing overlapped it:
//    where the ring has 3 or more stages (D = 64, 128) X and Y of tile
//    i + 1 are issued before the accumulating products of tile i, and the
//    elementwise step of i + 1 runs while those products do; at D = 256 (2
//    stages) the products of tile i go first, so that their wait releases
//    tile i's stage a whole X/Y product before the producer must refill it.
//    - Producer: two warps of a third warpgroup (setmaxnreg 40; consumers
//      232).  Warp 0 loads R once per item and T tiles into a ring of
//      kStages stages by TMA (128-byte swizzle, zero fill past the ragged
//      ends); warp 1 writes each dK/dV tile's q rows' lse and Delta into
//      its stage, so the consumers hold no registers for them across a
//      wait.  Full/empty mbarriers; the ring runs on across items.
//    - With segment ids, a first kernel writes each tile's (min, max) id;
//      tile pairs whose ranges cannot meet are not streamed at all (both
//      producer warps find the live tiles of an item by ballot and warp 0
//      publishes their count with R), which packed training batches
//      benefit from; one segment of all-zero ids skips nothing.
//    - Schedule: items are dealt to one block per SM by a host-side plan
//      (longest processing time first over both kinds, so the long dK/dV
//      items of early kv tiles and the long dQ items of late q tiles share
//      the blocks), built by the launcher on a shape's first launch and
//      kept on the device for the most recently used shapes.  The dK/dV
//      partials and the segment-id ranges are stream-ordered allocations
//      from a memory pool that keeps what it is given.
//    - Masks run only on edge tiles: tiles cut by the causal diagonal, the
//      window edge or Sk, and tiles whose segment ids are not all one value
//      (from the ranges); an edge tile's visible entries become a 16-bit
//      mask per thread while the products run.  Rows a folded box leaves
//      unwritten, and q positions past Sq, get lse = +inf and Delta = 0,
//      so their P and dS are 0 without a mask (the tile buffers are zeroed
//      once, so those rows hold finite values).
//    - Arithmetic as the mma.sync kernel's: the softcap's tanh is tanh_ex2
//      and the exponential ex2.approx with log2 e folded into one FMA; P and
//      dS are rounded to bf16 for their products; f32 sums in a fixed order
//      (no atomics anywhere), so two calls give bitwise-equal gradients.
//  * mma.sync (bf16, D = 16, 32: the reduced configurations; a 32- or
//    64-byte row is below TMA's 128-byte swizzle atom):
//    - dK/dV: one block per (b, kv head, 64-position kv tile), looping over
//      the G q heads and the live 64-position q tiles: s^T and dP^T, P and
//      dS into shared memory, dv += P^T . dO and dk += dS^T . q in
//      registers, written once.
//    - dQ: one block per (b, q head, 64-position q tile), looping over the
//      live kv tiles: s and dP again, dS into shared memory, dq += dS . k.
//    - Warp-level mma.sync m16n8k16 with f32 accumulation; 4 x (D / 64)
//      warps (4 for D <= 64), warp w owning kv rows 16 (w % 4) .. + 16 and
//      output columns 64 (w / 4) .. + 64.
//  * f32: the mma.sync structure on CUDA cores (32-position tiles, 256
//    threads), tanhf and expf as the f32 forward.
//
// Build (plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libflash_attention_bwd.so flash_attention_bwd.cu

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <array>
#include <atomic>
#include <climits>
#include <cstddef>
#include <cstdint>
#include <mutex>
#include <queue>
#include <utility>
#include <vector>

#include "../../common/hopper.cuh"

namespace {

constexpr size_t kSmemLimit = 232448;   // dynamic shared memory of a block
constexpr int kMaxGroup = 64;           // q heads per kv head (the forward's)
constexpr int kMaxDevices = 64;
constexpr int kMaxChunks = 8;           // dK/dV chunks per kv tile
constexpr size_t kMaxPlans = 32;        // wgmma schedules kept on the device
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  int B, Sq, Sk, H, KH, G;
  int causal, window, q_offset;
  float softcap, scale;
  const int* seg_q;    // (B, Sq) or null
  const int* seg_kv;   // (B, Sk), null with seg_q
  // wgmma kernel only: folded positions per q tile (64 / G), kv tiles,
  // folded q tiles, dK/dV chunks per kv tile; with segment ids, the (min,
  // max) of each tile's ids, [B][nq folded q tiles, then nkv kv tiles]
  int BQ, nkv, nq, nchunk;
  const int2* seg_range;
};

__host__ __device__ __forceinline__ int imin(int a, int b) {
  return a < b ? a : b;
}
__host__ __device__ __forceinline__ int imax(int a, int b) {
  return a > b ? a : b;
}

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

// ============================================== bf16: wgmma, TMA, mbarrier

namespace wg {

using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr int kConsumers = 2;                      // consumer warpgroups
constexpr int kThreads = 128 * (kConsumers + 1);   // + one producer warpgroup
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;   // 2 x 128 x 232 + 128 x 40 <= 65536
constexpr int kT = 64;       // rows of every tile: kv positions or folded q rows
constexpr int kHalf = kT / kConsumers;       // X and Y columns per consumer
constexpr uint32_t kEBytes = kT * kT * 2;    // one 64 x 64 bf16 P or dS tile
constexpr int kBarFree = 1, kBarFull = 2;    // the consumers' named barriers

template <int D>
struct Tile {
  static constexpr int kBlocks = D / 64;            // 128-byte column blocks
  static constexpr int ON = D >= 128 ? D / 2 : D;   // accumulator columns
  static constexpr uint32_t kTileBytes = kT * D * 2;
  static constexpr int kStages = D == 256 ? 2 : 4;
  // 1 KB alignment slack, R0 and R1, the ring, the P and dS tiles, the
  // mbarriers, the folded-row table, each stage's q rows' lse and Delta,
  // each stage's tile index, the item's live tile count
  static constexpr size_t kSmem = 1024 + (2 + 2 * size_t(kStages)) * kTileBytes +
                                  2 * size_t(kEBytes) + 8 * (2 + 2 * kStages) +
                                  4 * kT + 8 * kT * size_t(kStages) +
                                  4 * size_t(kStages) + 4;
  static_assert(D % 64 == 0 && ON % 64 == 0 && ON <= 128,
                "accumulators of whole 64-wide column blocks");
  static_assert(kSmem <= kSmemLimit, "tiles and ring exceed a block");
};

__host__ __device__ __forceinline__ long long lmin(long long a, long long b) {
  return a < b ? a : b;
}
__host__ __device__ __forceinline__ long long lmax(long long a, long long b) {
  return a > b ? a : b;
}

// A work item.  dK/dV (dq false): kv tile t of (b, kv head kh), chunk
// `chunk` of its live folded q tiles, which are [first, first + n).  dQ:
// folded q tile t (positions t BQ .. + BQ) of (b, kh), its live kv tiles
// [first, first + n).
struct Item {
  bool dq;
  int b, kh, t, chunk, first, n;
};

// The folded q tiles [first, first + n) that hold a q position seeing some
// position of kv tile tk under the causal and window masks.
__host__ __device__ __forceinline__ void dkdv_tiles(const Params& p, int tk,
                                                    int& first, int& n) {
  const long long k0 = (long long)tk * kT;
  const long long lo = p.causal ? lmax(0, k0 - p.q_offset) : 0;
  const long long hi =
      p.window > 0 ? lmin(p.Sq, k0 + kT - 1 + p.window - p.q_offset) : p.Sq;
  first = (int)(lo / p.BQ);
  n = lo < hi ? (int)((hi - 1) / p.BQ) - first + 1 : 0;
}

// The kv tiles [first, first + n) that hold a position seen by some q
// position of folded q tile tq.
__host__ __device__ __forceinline__ void dq_tiles(const Params& p, int tq,
                                                  int& first, int& n) {
  const long long q0 = (long long)tq * p.BQ;
  const long long q_lo = p.q_offset + q0;
  const long long q_hi = p.q_offset + lmin(q0 + p.BQ, p.Sq) - 1;
  const long long end = p.causal ? lmin(p.Sk, q_hi + 1) : p.Sk;
  const long long begin = p.window > 0 ? lmax(0, q_lo - p.window + 1) : 0;
  first = (int)(begin / kT);
  n = begin < end ? (int)((end - 1) / kT) - first + 1 : 0;
}

__host__ __device__ __forceinline__ int n_items(const Params& p) {
  return p.B * p.KH * (p.nkv * p.nchunk + p.nq);
}

// Item `id`: the dK/dV items ((b KH + kh) nkv + tile) nchunk + chunk first,
// then the dQ items (b KH + kh) nq + tile.
__host__ __device__ __forceinline__ Item item_of(const Params& p, int id) {
  Item it;
  const int n1 = p.B * p.KH * p.nkv * p.nchunk;
  it.dq = id >= n1;
  if (!it.dq) {
    it.chunk = id % p.nchunk;
    int r = id / p.nchunk;
    it.t = r % p.nkv;
    r /= p.nkv;
    it.kh = r % p.KH;
    it.b = r / p.KH;
    int first, n;
    dkdv_tiles(p, it.t, first, n);
    const int s0 = (int)((long long)n * it.chunk / p.nchunk);
    const int s1 = (int)((long long)n * (it.chunk + 1) / p.nchunk);
    it.first = first + s0;
    it.n = s1 - s0;
  } else {
    id -= n1;
    it.chunk = 0;
    it.t = id % p.nq;
    const int r = id / p.nq;
    it.kh = r % p.KH;
    it.b = r / p.KH;
    dq_tiles(p, it.t, it.first, it.n);
  }
  return it;
}

// The item of this block's k-th turn, or -1 past its last, from the plan:
// gridDim.x + 1 offsets, then the blocks' item ids.
__device__ __forceinline__ int next_item(const int* plan, int k) {
  const int at = plan[blockIdx.x] + k;
  return at < plan[blockIdx.x + 1] ? plan[gridDim.x + 1 + at] : -1;
}

struct Smem {
  unsigned char* r;   // R0, R1: the item's resident tiles
  unsigned char* t;   // the ring: stage s holds T0 at t + 2 s kTileBytes, T1 next
  unsigned char* e;   // E0 (P), E1 (dS): 64 x 64 bf16 each
  uint64_t *r_full, *r_empty, *t_full, *t_empty;
  const int* fold;    // folded row r: (r / G) | (r % G) << 16
  float* lse;         // stage s: lse (log2 units) of T's 64 folded q rows at
                      // lse + 2 kT s, Delta at lse + 2 kT s + kT (dK/dV)
  int* tile;          // stage s: the index of the tile it holds
  int* item_n;        // the current item's live stream tiles
};

// lse in log2 units and Delta of folded row r of the q tile at q0 of
// (b, kv head kh), and its q position: lse +inf and Delta 0 for a row past
// the folded box or past Sq (P and dS become 0), lse 0 for a fully masked
// row's -inf (its entries are all masked).
__device__ __forceinline__ void q_meta(const Params& p, const int* fold,
                                       int b, int kh, int q0, int r,
                                       const float* __restrict__ lse,
                                       const float* __restrict__ delta,
                                       float& l2, float& dl, int& pos) {
  const int f = fold[r];
  pos = q0 + (f & 0xffff);
  const bool ok = r < p.G * p.BQ && pos < p.Sq;
  const size_t i =
      ((size_t)b * p.H + kh * p.G + (f >> 16)) * p.Sq + imin(pos, p.Sq - 1);
  const float L = lse[i], dlt = delta[i];
  l2 = ok ? (L == -INFINITY ? 0.f : L * kLog2e) : INFINITY;
  dl = ok ? dlt : 0.f;
}

// The (min, max) segment ids of folded q tile tq and of kv tile tk of
// batch row b.
__device__ __forceinline__ void seg_ranges(const Params& p, int b, int tq,
                                           int tk, int2& qr, int2& kr) {
  const int2* r = p.seg_range + (size_t)b * (p.nq + p.nkv);
  qr = r[tq];
  kr = r[p.nq + tk];
}

// Whether the (folded q tile at q0, kv tile at k0) pair needs the masks:
// it crosses the causal diagonal, the window edge or Sk, or its segment ids
// are not all one value (from the tiles' id ranges).
__device__ __forceinline__ bool tile_edge(const Params& p, int b, int q0,
                                          int k0) {
  const int q_last = p.q_offset + imin(q0 + p.BQ, p.Sq) - 1;
  bool edge = k0 + kT > p.Sk ||
              (p.causal && k0 + kT - 1 > p.q_offset + q0) ||
              (p.window > 0 && q_last - k0 >= p.window);
  if (p.seg_range) {
    int2 qr, kr;
    seg_ranges(p, b, q0 / p.BQ, k0 / kT, qr, kr);
    edge = edge || qr.x != qr.y || kr.x != kr.y || qr.x != kr.x;
  }
  return edge;
}

// Whether no q position of folded q tile tq can share a segment with a kv
// position of kv tile tk (their id ranges do not meet): a tile pair with
// no live entry, which the kernel skips.
__device__ __forceinline__ bool tile_dead(const Params& p, int b, int tq,
                                          int tk) {
  if (!p.seg_range) return false;
  int2 qr, kr;
  seg_ranges(p, b, tq, tk, qr, kr);
  return qr.y < kr.x || kr.y < qr.x;
}

// (min, max) of the segment ids of every folded q tile (BQ positions) and
// every 64-position kv tile of each batch row, one warp a tile: the
// p.seg_range table.
__global__ void __launch_bounds__(256)
flash_attention_bwd_seg_ranges(const Params p, int2* __restrict__ ranges) {
  const int w = blockIdx.x * 8 + threadIdx.x / 32, lane = threadIdx.x % 32;
  const int per_b = p.nq + p.nkv;
  if (w >= p.B * per_b) return;
  const int b = w / per_b, t = w % per_b;
  const bool q = t < p.nq;
  const int* seg = q ? p.seg_q + (size_t)b * p.Sq : p.seg_kv + (size_t)b * p.Sk;
  const int S = q ? p.Sq : p.Sk, first = q ? t * p.BQ : (t - p.nq) * kT;
  const int len = q ? p.BQ : kT;
  int lo = INT_MAX, hi = INT_MIN;
  for (int j = lane; j < len; j += 32) {
    const int id = seg[imin(first + j, S - 1)];
    lo = min(lo, id);
    hi = max(hi, id);
  }
  lo = __reduce_min_sync(0xffffffffu, lo);
  hi = __reduce_max_sync(0xffffffffu, hi);
  if (lane == 0) ranges[w] = make_int2(lo, hi);
}

// The visible elements of the thread's fragment (bit e, as in grads) of
// an edge tile: rows at positions rpos with segment ids rseg (kv positions
// for dK/dV, absolute q positions for dQ), columns c of the warpgroup's
// half: folded q rows of the tile at q0 (dK/dV) or kv positions k0 + c.
template <bool kDQ>
__device__ __forceinline__ uint32_t live_bits(const Params& p,
                                              const int* fold, int b, int q0,
                                              int k0, int wgi, int lane,
                                              const int (&rpos)[2],
                                              const int (&rseg)[2]) {
  uint32_t live = 0;
#pragma unroll
  for (int m = 0; m < 8; ++m) {   // column m: elements 4 (m / 2) + m % 2 + 2h
    const int c = kHalf * wgi + 8 * (m / 2) + 2 * (lane % 4) + m % 2;
    int cp, cs;   // the column's position and segment id
    if (kDQ) {
      cp = k0 + c;
      cs = p.seg_kv ? p.seg_kv[(size_t)b * p.Sk + imin(cp, p.Sk - 1)] : 0;
    } else {
      const int pos = q0 + (fold[c] & 0xffff);
      cp = p.q_offset + pos;
      cs = p.seg_q ? p.seg_q[(size_t)b * p.Sq + imin(pos, p.Sq - 1)] : 0;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int qp = kDQ ? rpos[h] : cp, kp = kDQ ? cp : rpos[h];
      bool ok = kp < p.Sk && cs == rseg[h];
      if (p.causal) ok = ok && kp <= qp;
      if (p.window > 0) ok = ok && qp - kp < p.window;
      live |= (uint32_t)ok << (4 * (m / 2) + m % 2 + 2 * h);
    }
  }
  return live;
}

// X and Y of this warpgroup's 64 x 32 half (wgmma fragment: element
// e = 4j + 2h + {0, 1} at row 16 warp + lane / 4 + 8h, column 32 wgi + 8j +
// 2 (lane % 4) + {0, 1}) -> P and dS as bf16 pairs pp[k], dd[k], pair k =
// elements 2k, 2k + 1.  Rows are kv positions and columns folded q rows for
// dK/dV, the other way round for dQ; the q side's lse (log2 units) and
// Delta come per column (cl2, cdl: shared memory, at the thread's column
// 8j + {0, 1}) or per row (rl2, rdl).  kMask: bit e of `live` says whether element e is visible.
template <bool kDQ, bool kMask, bool kCap>
__device__ __forceinline__ void grads(
    const Params& p, const float (&xs)[16], const float (&ys)[16],
    const float* cl2, const float* cdl, const float (&rl2)[2],
    const float (&rdl)[2], uint32_t live, float in_scale, float mult,
    uint32_t (&pp)[8], uint32_t (&dd)[8]) {
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int h = k % 2;
    float pv[2], dv[2];
#pragma unroll
    for (int ee = 0; ee < 2; ++ee) {
      const int e = 2 * k + ee, c = 8 * (k / 2) + ee;
      const float l2 = kDQ ? rl2[h] : cl2[c];
      const float dlt = kDQ ? rdl[h] : cdl[c];
      float lg, chain = p.scale;
      if (kCap) {
        const float t = tanh_ex2(xs[e] * in_scale);
        lg = fmaf(t, mult, -l2);
        chain *= fmaf(-t, t, 1.f);
      } else {
        lg = fmaf(xs[e], mult, -l2);
      }
      float pr = ex2_approx(lg);
      if (kMask) pr = (live >> e) & 1u ? pr : 0.f;
      pv[ee] = pr;
      dv[ee] = pr * (ys[e] - dlt) * chain;
    }
    pp[k] = pack_bf16(pv[0], pv[1]);
    dd[k] = pack_bf16(dv[0], dv[1]);
  }
}

// This warpgroup's 64 x 32 half of a P or dS tile, pairs v as grads gives
// them, into the 64 x 64 tile at shared address `base` (128-byte rows, the
// 16-byte chunks of row r XOR-swizzled by r % 8: the K-major A layout).
__device__ __forceinline__ void store_half(uint32_t base,
                                           const uint32_t (&v)[8], int wgi,
                                           int warp, int lane) {
  const int mq = lane / 8;   // stmatrix: lanes 8m .. 8m + 7 address matrix m
  const int row = 16 * warp + 8 * (mq & 1) + lane % 8;
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int chunk = 4 * wgi + 2 * c + (mq >> 1);
    stmatrix_x4(base + row * 128 + ((chunk ^ (row & 7)) << 4), v[4 * c],
                v[4 * c + 1], v[4 * c + 2], v[4 * c + 3]);
  }
}

// One work item on a consumer warpgroup: its n live stream tiles (ring
// slots ring .., each naming its tile in sm.tile), R loaded and r_full
// passed.
template <int D, bool kDQ>
__device__ __forceinline__ void consume(const Smem& sm, const Params& p,
                                        const Item& it, int n, int ring,
                                        const float* __restrict__ lse,
                                        const float* __restrict__ delta,
                                        bf16* __restrict__ dq,
                                        bf16* __restrict__ dk,
                                        bf16* __restrict__ dv,
                                        float* __restrict__ ws) {
  using T = Tile<D>;
  constexpr int S = T::kStages, ON = T::ON;
  const int wgi = threadIdx.x / 128, t = threadIdx.x % 128;
  const int warp = t / 32, lane = t % 32;
  const bool capped = p.softcap > 0.f;
  // dot -> the tanh's argument in ex2 units; t (or dot) -> log2 units
  const float in_scale = capped ? 2.f * kLog2e * p.scale / p.softcap : 0.f;
  const float mult = (capped ? p.softcap : p.scale) * kLog2e;
  const int b = it.b, kh = it.kh;
  const int fixed0 = kDQ ? it.t * p.BQ : it.t * kT;   // q0 (dQ) or k0

  // the rows of the thread's fragment, fixed for the item
  int row[2], rpos[2], rseg[2];
  float rl2[2] = {0.f, 0.f}, rdl[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    row[h] = 16 * warp + lane / 4 + 8 * h;
    if (kDQ) {
      int pos;
      q_meta(p, sm.fold, b, kh, fixed0, row[h], lse, delta, rl2[h], rdl[h],
             pos);
      rpos[h] = p.q_offset + pos;
      rseg[h] = p.seg_q ? p.seg_q[(size_t)b * p.Sq + imin(pos, p.Sq - 1)] : 0;
    } else {
      rpos[h] = fixed0 + row[h];
      rseg[h] = p.seg_kv
                    ? p.seg_kv[(size_t)b * p.Sk + imin(rpos[h], p.Sk - 1)]
                    : 0;
    }
  }

  float acc0[ON / 2], acc1[ON / 2];
#pragma unroll
  for (int e = 0; e < ON / 2; ++e) acc0[e] = acc1[e] = 0.f;
  float xs[16], ys[16];
  uint32_t pp[8], dd[8];

  const uint32_t r0 = smem_u32(sm.r), r1 = r0 + T::kTileBytes;
  const uint32_t e0 = smem_u32(sm.e), e1 = e0 + kEBytes;
  auto stage = [&](int r) {
    return smem_u32(sm.t) + (uint32_t)(r % S) * 2 * T::kTileBytes;
  };
  // X = R0 . T0^T, Y = R1 . T1^T over D, this warpgroup's 32 columns (T
  // rows 32 wgi ..): both operands K-major
  auto issue_xy = [&](int r) {
    const uint32_t t0 = stage(r), t1 = t0 + T::kTileBytes;
    const uint32_t half = kHalf * wgi * 128;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk / 4) * kT * 128 + (kk % 4) * 32;
      Wgmma<kHalf, 0>::ss(xs, desc_sw128(r0 + off, 16, 1024),
                          desc_sw128(t0 + off + half, 16, 1024), kk > 0);
      Wgmma<kHalf, 0>::ss(ys, desc_sw128(r1 + off, 16, 1024),
                          desc_sw128(t1 + off + half, 16, 1024), kk > 0);
    }
    wgmma_commit();
  };
  // acc1 += dS . T0 and (dK/dV) acc0 += P . T1 over the tile's 64 rows: A
  // from the P/dS tiles (K-major), B the streamed tile (MN-major), this
  // warpgroup's ON columns
  constexpr uint32_t kColBytes = D >= 128 ? (ON / 64) * kT * 128 : 0;
  auto issue_acc = [&](int r) {
    const uint32_t t0 = stage(r), t1 = t0 + T::kTileBytes;
#pragma unroll
    for (int kk = 0; kk < kT / 16; ++kk) {
      const uint32_t bo = wgi * kColBytes + kk * 16 * 128;
      if constexpr (!kDQ)
        Wgmma<ON, 1>::ss(acc0, desc_sw128(e0 + kk * 32, 16, 1024),
                         desc_sw128(t1 + bo, kT * 128, 1024), 1);
      Wgmma<ON, 1>::ss(acc1, desc_sw128(e1 + kk * 32, 16, 1024),
                       desc_sw128(t0 + bo, kT * 128, 1024), 1);
    }
    wgmma_commit();
  };
  auto tiles_of = [&](int i, int& q0, int& k0) {
    const int tile = sm.tile[(ring + i) % S];
    q0 = kDQ ? fixed0 : tile * p.BQ;
    k0 = kDQ ? tile * kT : fixed0;
  };
  // Whether step i needs the masks and, if so, its visible elements; run
  // while a product is in flight.
  bool edge;
  uint32_t live;
  int step_ring;   // the ring slot of the step that step_meta described
  auto step_meta = [&](int i) {
    int q0, k0;
    tiles_of(i, q0, k0);
    step_ring = ring + i;
    edge = tile_edge(p, b, q0, k0);
    live = edge ? live_bits<kDQ>(p, sm.fold, b, q0, k0, wgi, lane, rpos, rseg)
                : 0xffffu;
  };
  // P and dS of the step that step_meta described, in registers
  auto step_grads = [&]() {
    const float* cl2 = sm.lse + 2 * kT * (step_ring % S) + kHalf * wgi +
                       2 * (lane % 4);
    const float* cdl = cl2 + kT;
#define FA_GRADS(M, C)                                                 \
  grads<kDQ, M, C>(p, xs, ys, cl2, cdl, rl2, rdl, live, in_scale, mult, \
                   pp, dd)
    if (edge && capped) FA_GRADS(true, true);
    else if (edge) FA_GRADS(true, false);
    else if (capped) FA_GRADS(false, true);
    else FA_GRADS(false, false);
#undef FA_GRADS
  };
  // ... written to the shared tiles once both warpgroups' products of the
  // last step are done
  auto publish = [&]() {
    named_bar_sync(kBarFree, 128 * kConsumers);
    if constexpr (!kDQ) store_half(e0, pp, wgi, warp, lane);
    store_half(e1, dd, wgi, warp, lane);
    fence_proxy_async_shared();
    named_bar_sync(kBarFull, 128 * kConsumers);
  };
  auto arrive = [&](uint64_t* bar) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };
  auto fence_acc = [&]() {
    if constexpr (!kDQ) fence_regs(acc0);
    fence_regs(acc1);
  };
  auto fence_xy = [&]() {
    fence_regs(xs);
    fence_regs(ys);
  };

  if (n == 0) arrive(sm.r_empty);
  if (n > 0) {
    mbar_wait(&sm.t_full[ring % S], (ring / S) & 1);
    fence_xy();
    wgmma_fence();
    issue_xy(ring);
    step_meta(0);
    wgmma_wait<0>();
    fence_xy();
    if (n == 1) arrive(sm.r_empty);
    step_grads();
    publish();
    // Step i: the products of step i and X, Y of step i + 1, then the
    // elementwise step of i + 1.  With 3 or more ring stages X and Y go
    // first, so the elementwise step overlaps the products of step i; with
    // 2 (D = 256) the products go first, so step i's stage is released
    // (and refilled) while X and Y of step i + 1 still run.
    for (int i = 0; i + 1 < n; ++i) {
      const int r = ring + i;
      if constexpr (S >= 3) {
        mbar_wait(&sm.t_full[(r + 1) % S], ((r + 1) / S) & 1);
        fence_xy();
        fence_acc();
        wgmma_fence();
        issue_xy(r + 1);
        issue_acc(r);
        step_meta(i + 1);
        wgmma_wait<1>();
        fence_xy();
        if (i + 2 == n) arrive(sm.r_empty);   // the item's last use of R
        step_grads();
        wgmma_wait<0>();
        fence_acc();
        arrive(&sm.t_empty[r % S]);
      } else {
        fence_acc();
        wgmma_fence();
        issue_acc(r);
        mbar_wait(&sm.t_full[(r + 1) % S], ((r + 1) / S) & 1);
        fence_xy();
        wgmma_fence();
        issue_xy(r + 1);
        step_meta(i + 1);
        wgmma_wait<1>();
        fence_acc();
        arrive(&sm.t_empty[r % S]);
        wgmma_wait<0>();
        fence_xy();
        if (i + 2 == n) arrive(sm.r_empty);
        step_grads();
      }
      publish();
    }
    const int r = ring + n - 1;
    fence_acc();
    wgmma_fence();
    issue_acc(r);
    wgmma_wait<0>();
    fence_acc();
    arrive(&sm.t_empty[r % S]);
  }

  // epilogue: dQ: acc1 -> dq; dK/dV: acc0 -> dv, acc1 -> dk, bf16 or (with
  // chunks) f32 partials of this chunk.  At D = 64 both warpgroups hold the
  // whole row and warpgroup 0 stores it.
  if (D == 64 && wgi != 0) return;
  const int col = (D >= 128 ? wgi * ON : 0) + 2 * (lane % 4);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (kDQ) {
      const int f = sm.fold[row[h]], pos = fixed0 + (f & 0xffff);
      if (row[h] >= p.G * p.BQ || pos >= p.Sq) continue;
      bf16* out = dq + (((size_t)b * p.Sq + pos) * p.H + kh * p.G + (f >> 16)) *
                           D + col;
#pragma unroll
      for (int j = 0; j < ON / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(out + 8 * j) = __floats2bfloat162_rn(
            acc1[4 * j + 2 * h], acc1[4 * j + 2 * h + 1]);
    } else {
      const int kp = rpos[h];
      if (kp >= p.Sk) continue;
      const size_t off = (((size_t)b * p.Sk + kp) * p.KH + kh) * D + col;
      if (p.nchunk == 1) {
#pragma unroll
        for (int j = 0; j < ON / 8; ++j) {
          *reinterpret_cast<__nv_bfloat162*>(dv + off + 8 * j) =
              __floats2bfloat162_rn(acc0[4 * j + 2 * h], acc0[4 * j + 2 * h + 1]);
          *reinterpret_cast<__nv_bfloat162*>(dk + off + 8 * j) =
              __floats2bfloat162_rn(acc1[4 * j + 2 * h], acc1[4 * j + 2 * h + 1]);
        }
      } else {
        const size_t part = (size_t)p.B * p.Sk * p.KH * D;
        float* w0 = ws + (size_t)it.chunk * part + off;               // dv
        float* w1 = ws + (size_t)(p.nchunk + it.chunk) * part + off;  // dk
#pragma unroll
        for (int j = 0; j < ON / 8; ++j) {
          *reinterpret_cast<float2*>(w0 + 8 * j) =
              make_float2(acc0[4 * j + 2 * h], acc0[4 * j + 2 * h + 1]);
          *reinterpret_cast<float2*>(w1 + 8 * j) =
              make_float2(acc1[4 * j + 2 * h], acc1[4 * j + 2 * h + 1]);
        }
      }
    }
  }
}

// A folded q tile (the box of tensor map m at folded tile q0 of (b, kh):
// G x BQ rows of 128 bytes per column block) into dst.
template <int D>
__device__ __forceinline__ void load_fold(unsigned char* dst,
                                          const CUtensorMap* m, uint64_t* bar,
                                          int b, int kh, int q0) {
#pragma unroll
  for (int c = 0; c < D / 64; ++c)
    tma_load_5d(dst + c * kT * 128, m, bar, c * 64, 0, kh, q0, b);
}

// A 64-position kv tile at k0 of (b, kh) into dst.
template <int D>
__device__ __forceinline__ void load_kv(unsigned char* dst,
                                        const CUtensorMap* m, uint64_t* bar,
                                        int b, int kh, int k0) {
#pragma unroll
  for (int c = 0; c < D / 64; ++c)
    tma_load_4d(dst + c * kT * 128, m, bar, c * 64, kh, k0, b);
}

// Persistent: gridDim.x blocks (at most one per SM) each walk their items
// (next_item).  tq, tdo: q and dO as (D, G, KH, Sq, B), box 64 x G x 1 x BQ
// x 1 (a folded tile); tk, tv: k and v as (D, KH, Sk, B), box 64 x 1 x 64 x
// 1.  ws: with p.nchunk > 1, the f32 partials [2][nchunk][B][Sk][KH][D]
// (dv, then dk) that flash_attention_bwd_reduce sums.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_bwd_wgmma(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tdo,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          bf16* __restrict__ dq, bf16* __restrict__ dk,
                          bf16* __restrict__ dv, float* __restrict__ ws,
                          const int* __restrict__ plan, const Params p) {
  using T = Tile<D>;
  constexpr int S = T::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  Smem sm;
  sm.r = base;
  sm.t = base + 2 * T::kTileBytes;
  sm.e = sm.t + 2 * S * T::kTileBytes;
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm.e + 2 * kEBytes);
  sm.r_full = bars;
  sm.r_empty = bars + 1;
  sm.t_full = bars + 2;
  sm.t_empty = bars + 2 + S;
  int* fold = reinterpret_cast<int*>(bars + 2 + 2 * S);
  sm.fold = fold;
  sm.lse = reinterpret_cast<float*>(fold + kT);
  sm.tile = reinterpret_cast<int*>(sm.lse + 2 * kT * S);
  sm.item_n = sm.tile + S;

  // Zero the tiles once: the rows a folded box leaves unwritten then hold
  // finite values (zeros, or an earlier tile's), which lse = +inf turns
  // into P = dS = 0.
  int4* z = reinterpret_cast<int4*>(base);
  for (int i = threadIdx.x; i < (2 + 2 * S) * (int)T::kTileBytes / 16;
       i += kThreads)
    z[i] = make_int4(0, 0, 0, 0);
  if (threadIdx.x < kT)
    fold[threadIdx.x] = threadIdx.x / p.G | (threadIdx.x % p.G) << 16;
  fence_proxy_async_shared();
  if (threadIdx.x == 0) {
    mbar_init(sm.r_full, 1);
    mbar_init(sm.r_empty, 4 * kConsumers);   // lane 0 of each consumer warp
#pragma unroll
    for (int s = 0; s < S; ++s) {
      mbar_init(&sm.t_full[s], 2);   // the producer's two warps
      mbar_init(&sm.t_empty[s], 4 * kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x / 128 == kConsumers) {
    // ------------------------------------------------------------ producer
    // Two warps walk the same items and, per item, the same live stream
    // tiles (candidates whose segment ids can meet the resident tile's,
    // 32 at a time by ballot).  Warp 0 counts them and publishes the count
    // with R, then loads each live tile into the ring (lane 0: its index
    // and the TMA loads); warp 1 writes a dK/dV tile's lse and Delta into
    // its stage.  One arrival each on the stage's full barrier.
    setmaxnreg_dec<kProducerRegs>();
    const int pw = threadIdx.x / 32 - 4 * kConsumers, lane = threadIdx.x % 32;
    if (pw < 2) {
      if (pw == 0 && lane == 0) {
        tma_prefetch_map(&tq);
        tma_prefetch_map(&tdo);
        tma_prefetch_map(&tk);
        tma_prefetch_map(&tv);
      }
      const uint32_t fold_bytes = 2 * T::kBlocks * p.G * p.BQ * 128;
      const uint32_t kv_bytes = 2 * T::kTileBytes;
      int ring = 0;
      for (int u = 0, id; (id = next_item(plan, u)) >= 0; ++u) {
        const Item it = item_of(p, id);
        auto live = [&](int i) {   // candidate i of the item is live
          const int tile = it.first + i;
          return i < it.n && !(it.dq ? tile_dead(p, it.b, it.t, tile)
                                     : tile_dead(p, it.b, tile, it.t));
        };
        if (pw == 0) {
          int n_live = 0;
          for (int c0 = 0; c0 < it.n; c0 += 32)
            n_live += __popc(__ballot_sync(0xffffffffu, live(c0 + lane)));
          if (u > 0) mbar_wait(sm.r_empty, (u - 1) & 1);
          if (lane == 0) {
            *sm.item_n = n_live;
            unsigned char* r1 = sm.r + T::kTileBytes;
            if (n_live == 0) {
              mbar_arrive(sm.r_full);
            } else if (it.dq) {
              mbar_arrive_expect_tx(sm.r_full, fold_bytes);
              load_fold<D>(sm.r, &tq, sm.r_full, it.b, it.kh, it.t * p.BQ);
              load_fold<D>(r1, &tdo, sm.r_full, it.b, it.kh, it.t * p.BQ);
            } else {
              mbar_arrive_expect_tx(sm.r_full, kv_bytes);
              load_kv<D>(sm.r, &tk, sm.r_full, it.b, it.kh, it.t * kT);
              load_kv<D>(r1, &tv, sm.r_full, it.b, it.kh, it.t * kT);
            }
          }
        }
        for (int c0 = 0; c0 < it.n; c0 += 32) {
          for (uint32_t bits = __ballot_sync(0xffffffffu, live(c0 + lane));
               bits; bits &= bits - 1, ++ring) {
            const int s = ring % S, tile = it.first + c0 + __ffs(bits) - 1;
            if (ring >= S) mbar_wait(&sm.t_empty[s], ((ring / S) - 1) & 1);
            if (pw == 0) {
              if (lane == 0) {
                unsigned char* t0 = sm.t + 2 * s * T::kTileBytes;
                unsigned char* t1 = t0 + T::kTileBytes;
                sm.tile[s] = tile;
                if (it.dq) {
                  mbar_arrive_expect_tx(&sm.t_full[s], kv_bytes);
                  load_kv<D>(t0, &tk, &sm.t_full[s], it.b, it.kh, tile * kT);
                  load_kv<D>(t1, &tv, &sm.t_full[s], it.b, it.kh, tile * kT);
                } else {
                  mbar_arrive_expect_tx(&sm.t_full[s], fold_bytes);
                  load_fold<D>(t0, &tq, &sm.t_full[s], it.b, it.kh,
                               tile * p.BQ);
                  load_fold<D>(t1, &tdo, &sm.t_full[s], it.b, it.kh,
                               tile * p.BQ);
                }
              }
            } else {
              if (!it.dq) {
                float* slot = sm.lse + 2 * kT * s;
#pragma unroll
                for (int c = lane; c < kT; c += 32) {
                  int pos;
                  q_meta(p, fold, it.b, it.kh, tile * p.BQ, c, lse, delta,
                         slot[c], slot[kT + c], pos);
                }
              }
              __syncwarp();
              if (lane == 0) mbar_arrive(&sm.t_full[s]);
            }
          }
        }
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    setmaxnreg_inc<kConsumerRegs>();
    int ring = 0;
    for (int u = 0, id; (id = next_item(plan, u)) >= 0; ++u) {
      const Item it = item_of(p, id);
      mbar_wait(sm.r_full, u & 1);
      const int n = *sm.item_n;
      if (it.dq)
        consume<D, true>(sm, p, it, n, ring, lse, delta, dq, dk, dv, ws);
      else
        consume<D, false>(sm, p, it, n, ring, lse, delta, dq, dk, dv, ws);
      ring += n;
    }
  }
}

// dv, dk = the sums of the nchunk f32 partials in ws, in chunk order.
__global__ void __launch_bounds__(256)
flash_attention_bwd_reduce(const float* __restrict__ ws, bf16* __restrict__ dv,
                           bf16* __restrict__ dk, long long part, int nchunk) {
  const long long n4 = part / 4;
  for (long long i = (long long)blockIdx.x * 256 + threadIdx.x; i < 2 * n4;
       i += (long long)gridDim.x * 256) {
    const int which = i >= n4;   // 0: dv, 1: dk
    const long long at = i - which * n4;
    const float4* src =
        reinterpret_cast<const float4*>(ws + (size_t)which * nchunk * part) + at;
    float4 s = src[0];
    for (int c = 1; c < nchunk; ++c) {
      const float4 x = src[c * n4];
      s.x += x.x;
      s.y += x.y;
      s.z += x.z;
      s.w += x.w;
    }
    __nv_bfloat162* out =
        reinterpret_cast<__nv_bfloat162*>((which ? dk : dv) + 4 * at);
    out[0] = __floats2bfloat162_rn(s.x, s.y);
    out[1] = __floats2bfloat162_rn(s.z, s.w);
  }
}

}  // namespace wg

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

// The wgmma kernel's tile counts for `nchunk` chunks per kv tile.
void set_tiles(Params& p, int nchunk) {
  p.BQ = wg::kT / p.G;
  p.nkv = (p.Sk + wg::kT - 1) / wg::kT;
  p.nq = (p.Sq + p.BQ - 1) / p.BQ;
  p.nchunk = nchunk;
}

// The wgmma kernel's schedule for `sms` blocks: items (both kinds) sorted
// by estimated cost, longest first (ties by id), each given to the block
// with the least cost so far (longest processing time first).  Cost of an
// item: its products (4 per streamed tile for dK/dV, 3 for dQ) plus 2 for
// its resident load and store.  nchunk: 1, or enough chunks that the
// longest dK/dV item is near the blocks' mean when it would exceed it by
// more than a quarter.  Writes grid, nchunk and the plan: grid + 1 offsets,
// then the item ids in each block's order.
void build_plan(Params p, int sms, std::vector<int>& plan, int& grid,
                int& nchunk) {
  auto cost = [](const wg::Item& it) {
    return (it.dq ? 3ll : 4ll) * it.n + 2;
  };
  set_tiles(p, 1);
  long long total = 0, longest = 0;
  int items = wg::n_items(p);
  for (int id = 0; id < items; ++id) {
    const long long c = cost(wg::item_of(p, id));
    total += c;
    longest = c > longest ? c : longest;
  }
  grid = imin(items, sms);
  const long long mean = (total + grid - 1) / grid;
  nchunk = 1;
  if (4 * longest > 5 * mean)
    nchunk = (int)std::min<long long>(kMaxChunks, (longest + mean - 1) / mean);
  set_tiles(p, nchunk);
  items = wg::n_items(p);
  grid = imin(items, sms);
  std::vector<std::pair<long long, int>> order(items);
  for (int id = 0; id < items; ++id)
    order[id] = {-cost(wg::item_of(p, id)), id};
  std::sort(order.begin(), order.end());
  using Load = std::pair<long long, int>;   // (cost so far, block)
  std::priority_queue<Load, std::vector<Load>, std::greater<Load>> heap;
  for (int j = 0; j < grid; ++j) heap.push({0, j});
  std::vector<std::vector<int>> lists(grid);
  for (const auto& [neg, id] : order) {
    const Load top = heap.top();
    heap.pop();
    lists[top.second].push_back(id);
    heap.push({top.first - neg, top.second});
  }
  plan.assign((size_t)grid + 1 + items, 0);
  int at = 0;
  for (int j = 0; j < grid; ++j) {
    plan[j] = at;
    for (int id : lists[j]) plan[grid + 1 + at++] = id;
  }
  plan[grid] = at;
}

// A schedule of the wgmma kernel on the device, for one device and launch
// shape.
struct Plan {
  std::array<int, 10> key;   // device, B, Sq, Sk, H, KH, D, causal, window,
                             // q_offset
  int* dev;                  // build_plan's plan in device memory
  int grid, nchunk;
  unsigned long long used;   // the launch count at its last use
};

// The schedule of a launch on the current device `device`, built on the
// first launch of its shape and copied to the device in order on `stream`;
// the kMaxPlans most recently used are kept, and evicting one waits for
// its device to finish what it has queued before freeing it.
int cached_plan(const Params& p, int D, int sms, int device,
                cudaStream_t stream, Plan* out) {
  static std::mutex mu;
  static std::vector<Plan> plans;
  static unsigned long long launches = 0;
  const std::array<int, 10> key{device, p.B, p.Sq, p.Sk, p.H, p.KH, D,
                                p.causal, p.window, p.q_offset};
  std::lock_guard<std::mutex> lock(mu);
  ++launches;
  for (Plan& e : plans)
    if (e.key == key) {
      e.used = launches;
      *out = e;
      return 0;
    }
  if (plans.size() == kMaxPlans) {
    auto lru = std::min_element(
        plans.begin(), plans.end(),
        [](const Plan& a, const Plan& b) { return a.used < b.used; });
    cudaError_t err = cudaSetDevice(lru->key[0]);
    if (err == cudaSuccess) err = cudaDeviceSynchronize();
    if (err == cudaSuccess) err = cudaFree(lru->dev);
    const cudaError_t back = cudaSetDevice(device);
    if (err != cudaSuccess || back != cudaSuccess)
      return (int)(err != cudaSuccess ? err : back);
    plans.erase(lru);
  }
  std::vector<int> host;
  Plan e{key, nullptr, 0, 1, launches};
  build_plan(p, sms, host, e.grid, e.nchunk);
  const size_t bytes = host.size() * sizeof(int);
  cudaError_t err = cudaMalloc(&e.dev, bytes);
  if (err == cudaSuccess)
    err = cudaMemcpyAsync(e.dev, host.data(), bytes, cudaMemcpyHostToDevice,
                          stream);
  // the plan is complete before any stream can launch with it
  if (err == cudaSuccess) err = cudaStreamSynchronize(stream);
  if (err != cudaSuccess) {
    cudaFree(e.dev);
    return (int)err;
  }
  plans.push_back(e);
  *out = e;
  return 0;
}

// The memory pool of device `device` for the wgmma launch's scratch (the
// dK/dV partials, the tiles' segment-id ranges): created on first use with
// no release threshold, so it keeps the memory its allocations were given
// and a launch of a known shape maps none.
int scratch_pool(int device, cudaMemPool_t* pool) {
  static std::mutex mu;
  static cudaMemPool_t pools[kMaxDevices] = {};
  std::lock_guard<std::mutex> lock(mu);
  if (pools[device] == nullptr) {
    cudaMemPoolProps props{};
    props.allocType = cudaMemAllocationTypePinned;
    props.location.type = cudaMemLocationTypeDevice;
    props.location.id = device;
    cudaMemPool_t made;
    cudaError_t err = cudaMemPoolCreate(&made, &props);
    if (err != cudaSuccess) return (int)err;
    uint64_t keep = UINT64_MAX;
    err = cudaMemPoolSetAttribute(made, cudaMemPoolAttrReleaseThreshold,
                                  &keep);
    if (err != cudaSuccess) {
      cudaMemPoolDestroy(made);
      return (int)err;
    }
    pools[device] = made;
  }
  *pool = pools[device];
  return 0;
}

// The SM count and index of the current device; the shared-memory
// attribute of the wgmma kernel at head dim D is set on the first call per
// device, so a launch costs the host only its tensor maps.
template <int D, typename Kernel>
int prepare_once(Kernel kernel, size_t smem, int* sms, int* device) {
  static std::atomic<int> sms_of[kMaxDevices];   // 0: not yet prepared
  cudaError_t err = cudaGetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (*device >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  *sms = sms_of[*device].load(std::memory_order_relaxed);
  if (*sms == 0) {
    err = prepare(kernel, smem);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount,
                                   *device);
    if (err != cudaSuccess) return (int)err;
    sms_of[*device].store(*sms, std::memory_order_relaxed);
  }
  return 0;
}

template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, const void* dO,
                 const float* lse, const float* delta, void* dq, void* dk,
                 void* dv, Params p, cudaStream_t stream) {
  using T = wg::Tile<D>;
  set_tiles(p, kMaxChunks);
  if ((long long)p.B * p.KH * ((long long)p.nkv * p.nchunk + p.nq) >
      INT_MAX)
    return (int)cudaErrorInvalidValue;
  const uint64_t e = sizeof(__nv_bfloat16);
  // q, dO (B, Sq, H = KH x G, D) as 5-D (D, G, KH, Sq, B); box 64 x G x 1 x
  // BQ x 1 lands as G * BQ rows of 128 bytes, row = position * G + head
  const uint64_t qd[5] = {(uint64_t)D, (uint64_t)p.G, (uint64_t)p.KH,
                          (uint64_t)p.Sq, (uint64_t)p.B};
  const uint64_t qs[4] = {D * e, p.G * D * e, p.H * D * e,
                          (uint64_t)p.Sq * p.H * D * e};
  const uint32_t qb[5] = {64, (uint32_t)p.G, 1, (uint32_t)p.BQ, 1};
  // k, v (B, Sk, KH, D) as 4-D (D, KH, Sk, B); box 64 x 1 x 64 x 1
  const uint64_t kd[4] = {(uint64_t)D, (uint64_t)p.KH, (uint64_t)p.Sk,
                          (uint64_t)p.B};
  const uint64_t ks[3] = {D * e, p.KH * D * e, (uint64_t)p.Sk * p.KH * D * e};
  const uint32_t kb[4] = {64, 1, (uint32_t)wg::kT, 1};
  CUtensorMap tq, tdo, tk, tv;
  int err = hopper::encode_tensor_map_bf16(&tq, q, 5, qd, qs, qb);
  if (!err) err = hopper::encode_tensor_map_bf16(&tdo, dO, 5, qd, qs, qb);
  if (!err) err = hopper::encode_tensor_map_bf16(&tk, k, 4, kd, ks, kb);
  if (!err) err = hopper::encode_tensor_map_bf16(&tv, v, 4, kd, ks, kb);
  if (err) return err;
  auto kernel = wg::flash_attention_bwd_wgmma<D>;
  int sms, device;
  if ((err = prepare_once<D>(kernel, T::kSmem, &sms, &device))) return err;
  Plan plan;
  if ((err = cached_plan(p, D, sms, device, stream, &plan))) return err;
  set_tiles(p, plan.nchunk);
  const long long part = (long long)p.B * p.Sk * p.KH * D;
  const long long tiles = (long long)p.B * (p.nq + p.nkv);
  cudaMemPool_t pool = nullptr;
  if ((p.nchunk > 1 || p.seg_q) && (err = scratch_pool(device, &pool)))
    return err;
  // stream-ordered scratch, freed on the stream after the kernels
  float* ws = nullptr;
  int2* ranges = nullptr;
  cudaError_t cerr = cudaSuccess;
  if (p.nchunk > 1)
    cerr = cudaMallocFromPoolAsync(&ws, 2 * p.nchunk * part * sizeof(float),
                                   pool, stream);
  if (cerr == cudaSuccess && p.seg_q) {
    cerr = cudaMallocFromPoolAsync(&ranges, tiles * sizeof(int2), pool,
                                   stream);
    if (cerr == cudaSuccess) {
      wg::flash_attention_bwd_seg_ranges<<<(unsigned)((tiles + 7) / 8), 256,
                                           0, stream>>>(p, ranges);
      cerr = cudaGetLastError();
      p.seg_range = ranges;
    }
  }
  using bf16 = __nv_bfloat16;
  if (cerr == cudaSuccess) {
    kernel<<<plan.grid, wg::kThreads, T::kSmem, stream>>>(
        tq, tdo, tk, tv, lse, delta, static_cast<bf16*>(dq),
        static_cast<bf16*>(dk), static_cast<bf16*>(dv), ws, plan.dev, p);
    cerr = cudaGetLastError();
  }
  if (cerr == cudaSuccess && p.nchunk > 1) {
    const long long blocks = (2 * part / 4 + 255) / 256;
    wg::flash_attention_bwd_reduce<<<(unsigned)(blocks < 4 * sms ? blocks
                                                                  : 4 * sms),
                                     256, 0, stream>>>(
        ws, static_cast<bf16*>(dv), static_cast<bf16*>(dk), part, p.nchunk);
    cerr = cudaGetLastError();
  }
  for (void* scratch : {(void*)ws, (void*)ranges}) {
    if (scratch == nullptr) continue;
    const cudaError_t ferr = cudaFreeAsync(scratch, stream);
    if (cerr == cudaSuccess) cerr = ferr;
  }
  return (int)cerr;
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
  if constexpr (sizeof(T) == 2 && D >= 64) {
    return launch_wgmma<D>(q, k, v, dO, lse, delta, dq, dk, dv, p, stream);
  } else if constexpr (sizeof(T) == 2) {
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
    return launch<float, D>(q, k, v, o, lse, dO, delta, dq, dk, dv, p,
                            stream);
  if (dtype == 1)
    return launch<__nv_bfloat16, D>(q, k, v, o, lse, dO, delta, dq, dk, dv, p,
                                    stream);
  return (int)cudaErrorInvalidValue;
}

bool valid_shape(int B, int Sq, int Sk, int H, int KH) {
  return B > 0 && Sq > 0 && Sk > 0 && KH > 0 && H % KH == 0 &&
         H / KH <= kMaxGroup;
}

}  // namespace

extern "C" {

// q, o, dO, dq (B, Sq, H, D); k, v, dk, dv (B, Sk, KH, D); all contiguous,
// 16-byte aligned and of one dtype (0: float32, 1: bfloat16); lse (B, H,
// Sq) f32 from the forward with the same arguments; seg_q (B, Sq) and
// seg_kv (B, Sk) int32, both or neither (null); delta: (B, H, Sq) f32
// scratch.  Sq, Sk > 0.  Launches its kernels on `stream` (delta, then
// dk/dv and dq), does not synchronise except on the first launch of a
// shape of the wgmma kernel (its schedule is copied to the device), and
// returns the first cudaError_t (0 on success).
int flash_attention_bwd(const void* q, const void* k, const void* v,
                        const void* o, const float* lse, const void* dO,
                        const int* seg_q, const int* seg_kv, float* delta,
                        void* dq, void* dk, void* dv, int dtype, int B, int Sq,
                        int Sk, int H, int KH, int D, int causal, int window,
                        float softcap, float scale, int q_offset,
                        void* stream) {
  if (!valid_shape(B, Sq, Sk, H, KH) || B * KH > 65535 || B * H > 65535 ||
      (seg_q == nullptr) != (seg_kv == nullptr))
    return (int)cudaErrorInvalidValue;
  Params p{};
  p.B = B; p.Sq = Sq; p.Sk = Sk; p.H = H; p.KH = KH; p.G = H / KH;
  p.causal = causal; p.window = window; p.q_offset = q_offset;
  p.softcap = softcap; p.scale = scale;
  p.seg_q = seg_q; p.seg_kv = seg_kv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FA_LAUNCH(DD) \
  launch_d<DD>(dtype, q, k, v, o, lse, dO, delta, dq, dk, dv, p, s)
  switch (D) {
    case 16: return FA_LAUNCH(16);
    case 32: return FA_LAUNCH(32);
    case 64: return FA_LAUNCH(64);
    case 128: return FA_LAUNCH(128);
    case 256: return FA_LAUNCH(256);
    default: return (int)cudaErrorInvalidValue;
  }
#undef FA_LAUNCH
}

// Dynamic shared memory per block of the wgmma kernel at head dim D (64,
// 128 or 256), or -1 (ptxas reports only static shared memory).
int flash_attention_bwd_smem_bytes(int D) {
  switch (D) {
    case 64: return (int)wg::Tile<64>::kSmem;
    case 128: return (int)wg::Tile<128>::kSmem;
    case 256: return (int)wg::Tile<256>::kSmem;
    default: return -1;
  }
}

const char* flash_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
