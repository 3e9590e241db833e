// Flash attention, forward, for NVIDIA Hopper (sm_90a), bf16 or f32 in and out.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention/pallas_kernel.py::flash_attention_pallas
//   (body _attn_kernel), and computes the same function:
//   o = softmax(mask(softcap(scale * q.k^T))) . v
//   with causal, sliding-window (q - k < window) and q_offset masks, tanh
//   softcap, the scale applied after the dot, GQA (H = G * KH), online
//   softmax with f32 m, l and acc, fully masked rows giving 0 and fully
//   masked kv tiles skipped.  Unlike the Pallas kernel it takes any
//   sequence lengths (the ragged q and kv tails are masked here) and
//   segment ids (int32 seg_q (B, Sq) and seg_kv (B, Sk), or null; an entry
//   is live only where seg_q[b, i] == seg_kv[b, j]), which the Pallas
//   kernel rejects: the spec is the XLA path and ref.  Given an lse
//   pointer, every kernel also writes each row's natural-log log-sum-exp
//   of its masked scores, f32 (B, H, Sq), -inf for a fully masked row: the
//   backward (flash_attention_bwd.cu) recomputes P = exp(s - lse) from it.
//
// What bounds it on an H100.  The function needs 4*D flops per unmasked
// (q, k) pair and q head, and moves q, k, v and o once.  At the serve
// prefill shapes (B=4, S=1024, causal) that is, at the data-sheet bf16
// tensor-core peak (989 TFLOP/s) and 3.35 TB/s:
//   gemma2-2b       (H=8,  KH=4, D=256)  17 GFLOP, 50 MB: 17.4 us (ops)
//   recurrentgemma  (H=10, KH=1, D=256)  21 GFLOP, 46 MB: 21.7 us (ops)
//   qwen3-moe       (H=32, KH=4, D=128)  34 GFLOP, 71 MB: 34.8 us (ops)
// So the function is bound by operations, and only wgmma, Hopper's
// warpgroup tensor-core product, reaches the full bf16 rate.
//
// Three kernels, chosen by dtype and head dim (the rule is also written in
// ops.py, which counts each one's launches):
//  * wgmma (bf16, D = 64, 128, 256: the serving path).
//    - Work items.  An item is the G * BQ <= 128 folded rows of the G q
//      heads that share one kv head, BQ = 128 / G positions each (row r is
//      position r / G, head r % G), so the group reads each k and v tile
//      once; it visits only the kv tiles that its causal and window masks
//      leave live.  The grid is persistent (one block per SM); items are
//      numbered longest first and dealt to the blocks in snake order, so
//      the blocks' sums of kv tiles are close.
//    - Warp roles.  384 threads: two consumer warpgroups of 64 rows each
//      and one producer warpgroup; setmaxnreg gives the producer 24
//      registers and the consumers 240.  One producer thread loads an
//      item's q once and k and v tiles of BK positions by TMA (128-byte
//      swizzle, zero fill past the ragged ends) into a ring of 2 stages.
//      Per stage, "k full" and "v full" mbarriers carry the TMA bytes and
//      "k empty" and "v empty" ones the consumers' releases, so a k stage
//      is refilled as soon as its q.k^T is done, a v stage after its P.V.
//      The ring runs on across items: the next item's tiles load while
//      the consumers finish the current one.
//    - Products.  S = q.k^T is a wgmma with both operands in shared memory
//      (k is a K-major operand).  O += P.V is a wgmma with P from
//      registers (the S accumulator converted once to bf16, in place: its
//      fragment layout is wgmma's A layout) and v an MN-major operand.  A
//      consumer issues tile i's q.k^T, rescales O while it runs, issues
//      tile i-1's P.V, and runs tile i's softmax while P.V is in flight;
//      the two consumers take turns to issue (named barriers), so one's
//      softmax also overlaps the other's products.
//    - Softmax.  f32 m, l and O; exp2 with log2 e folded into the scale
//      (or into the softcap's output scale) inside one FMA; tanh is
//      1 - 2 / (2^y + 1) from ex2.approx and rcp.approx (absolute error
//      below 1e-6; tanh.approx.f32's 2^-11 becomes a logit error of 0.025
//      under a softcap of 50, which scores near the cap turn into output
//      errors past the bf16 tolerance); the masks run only on tiles that
//      cross the causal diagonal, the window edge or Sk.
//    - Shared memory per block (1 KB alignment slack, q, 2 x (k + v),
//      18 mbarriers):
//        D = 256: BK 64:  1 + 64 + 2 x (32 + 32) KB = 197,712 bytes
//        D = 128: BK 128: 1 + 32 + 2 x (32 + 32) KB = 164,944 bytes
//        D = 64:  BK 128: 1 + 16 + 2 x (16 + 16) KB =  83,024 bytes
//      Registers per consumer thread: S (BK / 2) and O (D / 2) f32 plus P
//      (BK / 4) bf16 pairs: 176 at D = 256, 160 at D = 128; no spills.
//    What this does about the bound: both products run on wgmma, the
//    loads run ahead of the consumers, and the exponentials, the other main
//    cost, overlap the other warpgroup's products.  Not done: cheaper
//    diagonal tiles (at D = 128 the last tile of a 16-position item is on
//    average half masked; a half-width last tile behind a branch made
//    ptxas serialize the products and was slower).  Times in PERF.md.
//  * mma.sync (bf16, D = 16, 32: the reduced configurations).  64 folded
//    rows, 4 warps of 16 rows, warp-level mma.sync m16n8k16; tiles by
//    cp.async; p split into bf16 hi + lo parts for p.v.  A 32-byte row is
//    below TMA's 128-byte swizzle atom, so these head dims keep it.
//  * f32 (CUDA cores): FMAs in f32, exact against the f32 reference.
//
// Build (plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libflash_attention_fwd.so flash_attention_fwd.cu

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <climits>
#include <cstddef>
#include <cstdint>

#include "../../common/hopper.cuh"

namespace {

constexpr int kRows = 64;          // folded q rows per block of tc and cc
constexpr size_t kSmemLimit = 232448;   // dynamic shared memory of a block
constexpr int kMaxDevices = 64;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  int B, Sq, Sk, H, KH, G, BQ;
  int causal, window, q_offset;
  float softcap, scale;
  const int* seg_q;    // (B, Sq) or null: no segment mask
  const int* seg_kv;   // (B, Sk), null with seg_q
  float* lse;          // (B, H, Sq) or null: not written
};
// The kv range [begin, end) that can hold a live entry for some row of the
// q tile starting at q0, with begin rounded down to a multiple of `tile`.
__device__ __forceinline__ void kv_range(const Params& p, int q0, int tile,
                                         int& begin, int& end) {
  const int q_lo = p.q_offset + q0;
  const int q_hi = p.q_offset + min(q0 + p.BQ, p.Sq) - 1;
  end = p.causal ? min(p.Sk, q_hi + 1) : p.Sk;
  begin = p.window > 0 ? max(0, q_lo - p.window + 1) : 0;
  begin = (begin / tile) * tile;
}

// Scaled, softcapped score, or kNegInf where the masks hide (qpos, kp);
// seg_ok: the segment ids of the two match (true without segment ids).
__device__ __forceinline__ float masked_score(const Params& p, float dot,
                                              bool q_valid, int qpos, int kp,
                                              bool seg_ok) {
  bool ok = q_valid && seg_ok && kp < p.Sk;
  if (p.causal) ok = ok && kp <= qpos;
  if (p.window > 0) ok = ok && (qpos - kp < p.window);
  float x = dot * p.scale;
  if (p.softcap > 0.f) x = tanhf(x / p.softcap) * p.softcap;
  return ok ? x : kNegInf;
}

// Offset of folded row r of the q tile at q0 in a (B, Sq, H, D) tensor.
__device__ __forceinline__ size_t q_offset_of(const Params& p, int b, int kh,
                                              int q0, int r, int D) {
  return (((size_t)b * p.Sq + q0 + r % p.BQ) * p.H + kh * p.G + r / p.BQ) *
         (size_t)D;
}

// Index of (b, head h, position i) in the (B, H, Sq) lse.
__device__ __forceinline__ size_t lse_index(const Params& p, int b, int h,
                                            int i) {
  return ((size_t)b * p.H + h) * p.Sq + i;
}

// Segment id of q position i (clamped into the sequence) of batch b, or 0
// without segment ids.
__device__ __forceinline__ int seg_of_q(const Params& p, int b, int i) {
  return p.seg_q ? p.seg_q[(size_t)b * p.Sq + min(i, p.Sq - 1)] : 0;
}

// kv tile [k0, k0 + tile) -> sseg[0 .. tile): its segment ids (0 past Sk),
// by threads tid of nthreads; nothing without segment ids.
__device__ __forceinline__ void stage_kv_segments(const Params& p, int b,
                                                  int k0, int tile,
                                                  int* sseg, int tid,
                                                  int nthreads) {
  if (!p.seg_kv) return;
  for (int c = tid; c < tile; c += nthreads)
    sseg[c] = k0 + c < p.Sk ? p.seg_kv[(size_t)b * p.Sk + k0 + c] : 0;
}

// ================================= bf16, D = 16 and 32: warp-level mma.sync

namespace tc {

constexpr int kThreads = 128;      // 4 warps x 16 rows
constexpr int kBK = 64;            // kv positions per tile

template <int D>
constexpr size_t smem_bytes() {    // q, k, v tiles, rows padded by 8 bf16
  return sizeof(__nv_bfloat16) * size_t(kRows + 2 * kBK) * (D + 8);
}

using hopper::cp_async16;
using hopper::cp_async_wait_all;
using hopper::ld_u32;
using hopper::ldmatrix_x2_trans;
using hopper::pack_bf16;

// Fragment layout of mma.m16n8k16 (PTX ISA): with g = lane / 4 and
// t = lane % 4, a thread holds rows g and g + 8 of the 16 x 8 result at
// columns 2t and 2t + 1 (c[0], c[1] for row g; c[2], c[3] for row g + 8).
// kExt: segment ids and lse compiled in (as in the wgmma kernel).
template <int D, bool kExt>
__global__ void __launch_bounds__(kThreads, 2)
flash_attention_fwd_tc(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       __nv_bfloat16* __restrict__ o, Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int sSeg[kBK];                  // the kv tile's segment ids
  constexpr int RS = D + 8;                  // padded row stride, elements
  constexpr int RC = D / 8;                  // 16-byte chunks per row
  constexpr int NT = kBK / 8;                // score tiles of 8 keys
  constexpr int DT = D / 8;                  // output tiles of 8 dims
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + kRows * RS;
  __nv_bfloat16* sV = sK + kBK * RS;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int b = blockIdx.y / p.KH, kh = blockIdx.y % p.KH;
  const int q0 = blockIdx.x * p.BQ;
  const int rows = p.G * p.BQ;

  for (int idx = tid; idx < kRows * RC; idx += kThreads) {
    const int r = idx / RC, ch = idx % RC;
    const bool valid = r < rows && q0 + r % p.BQ < p.Sq;
    cp_async16(sQ + r * RS + ch * 8,
               valid ? q + q_offset_of(p, b, kh, q0, r, D) + ch * 8 : q,
               valid);
  }

  int row[2], qpos[2], sq[2];
  bool valid[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    row[h] = warp * 16 + g + 8 * h;
    qpos[h] = p.q_offset + q0 + row[h] % p.BQ;
    valid[h] = row[h] < rows && q0 + row[h] % p.BQ < p.Sq;
    sq[h] = kExt ? seg_of_q(p, b, q0 + row[h] % p.BQ) : 0;
  }
  float acc[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};  // l: this lane's part

  int kv_begin, kv_end;
  kv_range(p, q0, kBK, kv_begin, kv_end);
  for (int k0 = kv_begin; k0 < kv_end; k0 += kBK) {
    __syncthreads();  // the previous tile's sK, sV reads are done
    for (int idx = tid; idx < kBK * RC; idx += kThreads) {
      const int c = idx / RC, ch = idx % RC, kp = k0 + c;
      const bool ok = kp < p.Sk;
      const size_t off = (((size_t)b * p.Sk + kp) * p.KH + kh) * D + ch * 8;
      cp_async16(sK + c * RS + ch * 8, ok ? k + off : k, ok);
      cp_async16(sV + c * RS + ch * 8, ok ? v + off : v, ok);
    }
    if (kExt) stage_kv_segments(p, b, k0, kBK, sSeg, tid, kThreads);
    cp_async_wait_all();
    __syncthreads();

    // s = q . k^T for this warp's 16 rows and the tile's 64 keys
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < D; kk += 16) {
      const __nv_bfloat16* qa = sQ + (warp * 16 + g) * RS + kk + 2 * t;
      const uint32_t a[4] = {ld_u32(qa), ld_u32(qa + 8 * RS), ld_u32(qa + 8),
                             ld_u32(qa + 8 * RS + 8)};
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const __nv_bfloat16* kb = sK + (n * 8 + g) * RS + kk + 2 * t;
        hopper::mma_16816(s[n], a, ld_u32(kb), ld_u32(kb + 8));
      }
    }

    // online softmax over the tile (each row's 4 lanes hold 16 keys each)
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e / 2, c = n * 8 + 2 * t + (e % 2);
        s[n][e] = masked_score(p, s[n][e], valid[h], qpos[h], k0 + c,
                               !kExt || !p.seg_q || sSeg[c] == sq[h]);
        mx[h] = fmaxf(mx[h], s[n][e]);
      }
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      corr[h] = expf(m[h] - m_new);
      m[h] = m_new;
      l[h] *= corr[h];
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e / 2;
        const float pe = s[n][e] > 0.5f * kNegInf ? expf(s[n][e] - m[h]) : 0.f;
        s[n][e] = pe;
        l[h] += pe;
      }
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      acc[j][0] *= corr[0]; acc[j][1] *= corr[0];
      acc[j][2] *= corr[1]; acc[j][3] *= corr[1];
    }

    // acc += p . v, 16 keys at a time: score tiles 2kk and 2kk + 1 are the
    // A fragment of keys 16kk .. 16kk + 15, split into bf16 hi + lo parts
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
      const float* s0 = s[2 * kk];
      const float* s1 = s[2 * kk + 1];
      const float pv[8] = {s0[0], s0[1], s0[2], s0[3],
                           s1[0], s1[1], s1[2], s1[3]};
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        hi[i] = pack_bf16(pv[2 * i], pv[2 * i + 1]);
        const float2 hf = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&hi[i]));
        lo[i] = pack_bf16(pv[2 * i] - hf.x, pv[2 * i + 1] - hf.y);
      }
      const __nv_bfloat16* vrow = sV + (kk * 16 + lane % 16) * RS;
#pragma unroll
      for (int j = 0; j < DT; ++j) {
        uint32_t b0, b1;
        ldmatrix_x2_trans(b0, b1, vrow + j * 8);
        hopper::mma_16816(acc[j], hi, b0, b1);
        hopper::mma_16816(acc[j], lo, b0, b1);
      }
    }
  }
  cp_async_wait_all();  // the q copies, when no kv tile was live

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    if (!valid[h]) continue;
    if (kExt && p.lse && t == 0)
      p.lse[lse_index(p, b, kh * p.G + row[h] / p.BQ, q0 + row[h] % p.BQ)] =
          l[h] > 0.f ? m[h] + logf(l[h]) : -INFINITY;
    const float denom = fmaxf(l[h], 1e-30f);
    __nv_bfloat16* out = o + q_offset_of(p, b, kh, q0, row[h], D) + 2 * t;
#pragma unroll
    for (int j = 0; j < DT; ++j)
      *reinterpret_cast<__nv_bfloat162*>(out + j * 8) = __floats2bfloat162_rn(
          acc[j][2 * h] / denom, acc[j][2 * h + 1] / denom);
  }
}

}  // namespace tc

// ========================================================= f32: CUDA cores

namespace cc {

constexpr int kThreads = 256;
constexpr int kLanesPerRow = 4;                       // threads sharing a row
constexpr int kBK = 32;                               // kv positions per tile
constexpr int kColsPerLane = kBK / kLanesPerRow;      // scores per thread
static_assert(kThreads / kLanesPerRow == kRows, "one row per 4 threads");

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (size_t(kRows) * (D + 4) + 2 * size_t(kBK) * (D + 4) +
          size_t(kRows) * (kBK + 1));
}

// Thread t works on row t / 4; its 4 lanes split the kv columns of a tile
// (c = lane + 4 i) and the head dim of the accumulator in 4-wide chunks
// (d = 4 (lane + 4 j) + 0..3).  Shared-memory rows are padded to D + 4
// floats, so every 16-byte read is aligned and the 8 rows (or 4 columns) a
// warp reads at once fall in distinct banks.  kExt as in the tc kernel.
template <int D, bool kExt>
__global__ void __launch_bounds__(kThreads)
flash_attention_fwd_cc(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o,
                       Params p) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int sSeg[kBK];                    // the kv tile's segment ids
  constexpr int DP = D + 4;
  constexpr int DC = D / (4 * kLanesPerRow);   // 4-wide chunks per lane
  constexpr int SP = kBK + 1;
  constexpr int RC = D / 4;                    // 16-byte chunks per row
  constexpr int KIT = (kBK * RC + kThreads - 1) / kThreads;
  float* sQ = smem;                 // kRows x DP
  float* sK = sQ + kRows * DP;      // kBK x DP
  float* sV = sK + kBK * DP;        // kBK x DP
  float* sP = sV + kBK * DP;        // kRows x SP

  const int tid = threadIdx.x;
  const int b = blockIdx.y / p.KH, kh = blockIdx.y % p.KH;
  const int q0 = blockIdx.x * p.BQ;
  const int rows = p.G * p.BQ;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int idx = tid; idx < kRows * RC; idx += kThreads) {
    const int r = idx / RC, ch = idx % RC;
    float4 val = zero;
    if (r < rows && q0 + r % p.BQ < p.Sq)
      val = *reinterpret_cast<const float4*>(
          q + q_offset_of(p, b, kh, q0, r, D) + ch * 4);
    *reinterpret_cast<float4*>(&sQ[r * DP + ch * 4]) = val;
  }

  const int r = tid / kLanesPerRow, lane = tid % kLanesPerRow;
  const bool q_valid = r < rows && q0 + r % p.BQ < p.Sq;
  const int qpos = p.q_offset + q0 + r % p.BQ;
  const int sq = kExt ? seg_of_q(p, b, q0 + r % p.BQ) : 0;

  float4 acc[DC];
#pragma unroll
  for (int j = 0; j < DC; ++j) acc[j] = zero;
  float m = kNegInf, l = 0.f;

  int kv_begin, kv_end;
  kv_range(p, q0, kBK, kv_begin, kv_end);
  for (int k0 = kv_begin; k0 < kv_end; k0 += kBK) {
    // all of a tile's loads are issued before the barrier: they wait for
    // one memory latency and overlap the other warps' work
    float4 kraw[KIT], vraw[KIT];
#pragma unroll
    for (int it = 0; it < KIT; ++it) {
      const int idx = tid + it * kThreads, kp = k0 + idx / RC;
      kraw[it] = vraw[it] = zero;
      if (idx < kBK * RC && kp < p.Sk) {
        const size_t off =
            (((size_t)b * p.Sk + kp) * p.KH + kh) * D + (idx % RC) * 4;
        kraw[it] = *reinterpret_cast<const float4*>(k + off);
        vraw[it] = *reinterpret_cast<const float4*>(v + off);
      }
    }
    __syncthreads();  // sQ written; previous tile's sK, sV, sP read
#pragma unroll
    for (int it = 0; it < KIT; ++it) {
      const int idx = tid + it * kThreads;
      if (idx < kBK * RC) {
        const int at = (idx / RC) * DP + (idx % RC) * 4;
        *reinterpret_cast<float4*>(&sK[at]) = kraw[it];
        *reinterpret_cast<float4*>(&sV[at]) = vraw[it];
      }
    }
    if (kExt) stage_kv_segments(p, b, k0, kBK, sSeg, tid, kThreads);
    __syncthreads();

    float s[kColsPerLane];
#pragma unroll
    for (int i = 0; i < kColsPerLane; ++i) s[i] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; d += 4) {
      const float4 qd = *reinterpret_cast<const float4*>(&sQ[r * DP + d]);
#pragma unroll
      for (int i = 0; i < kColsPerLane; ++i) {
        const float4 kd = *reinterpret_cast<const float4*>(
            &sK[(lane + kLanesPerRow * i) * DP + d]);
        s[i] = fmaf(qd.x, kd.x, s[i]);
        s[i] = fmaf(qd.y, kd.y, s[i]);
        s[i] = fmaf(qd.z, kd.z, s[i]);
        s[i] = fmaf(qd.w, kd.w, s[i]);
      }
    }

    float mloc = kNegInf;
#pragma unroll
    for (int i = 0; i < kColsPerLane; ++i) {
      const int c = lane + kLanesPerRow * i;
      s[i] = masked_score(p, s[i], q_valid, qpos, k0 + c,
                          !kExt || !p.seg_q || sSeg[c] == sq);
      mloc = fmaxf(mloc, s[i]);
    }
    // the 4 lanes of a row are neighbouring lanes of one warp
    mloc = fmaxf(mloc, __shfl_xor_sync(0xffffffffu, mloc, 1));
    mloc = fmaxf(mloc, __shfl_xor_sync(0xffffffffu, mloc, 2));
    const float m_new = fmaxf(m, mloc);
    const float corr = expf(m - m_new);
    float lsum = 0.f;
#pragma unroll
    for (int i = 0; i < kColsPerLane; ++i) {
      const float pi = s[i] > 0.5f * kNegInf ? expf(s[i] - m_new) : 0.f;
      lsum += pi;
      sP[r * SP + lane + kLanesPerRow * i] = pi;
    }
    lsum += __shfl_xor_sync(0xffffffffu, lsum, 1);
    lsum += __shfl_xor_sync(0xffffffffu, lsum, 2);
    l = l * corr + lsum;
    m = m_new;
    __syncwarp();  // the row's probabilities are written by its own warp

#pragma unroll
    for (int j = 0; j < DC; ++j) {
      acc[j].x *= corr; acc[j].y *= corr; acc[j].z *= corr; acc[j].w *= corr;
    }
    for (int c = 0; c < kBK; ++c) {
      const float pc = sP[r * SP + c];
#pragma unroll
      for (int j = 0; j < DC; ++j) {
        const float4 vd = *reinterpret_cast<const float4*>(
            &sV[c * DP + 4 * (lane + kLanesPerRow * j)]);
        acc[j].x = fmaf(pc, vd.x, acc[j].x);
        acc[j].y = fmaf(pc, vd.y, acc[j].y);
        acc[j].z = fmaf(pc, vd.z, acc[j].z);
        acc[j].w = fmaf(pc, vd.w, acc[j].w);
      }
    }
  }

  if (q_valid) {
    if (kExt && p.lse && lane == 0)
      p.lse[lse_index(p, b, kh * p.G + r / p.BQ, q0 + r % p.BQ)] =
          l > 0.f ? m + logf(l) : -INFINITY;
    const float denom = fmaxf(l, 1e-30f);
    float* out = o + q_offset_of(p, b, kh, q0, r, D);
#pragma unroll
    for (int j = 0; j < DC; ++j) {
      const float4 a = acc[j];
      *reinterpret_cast<float4*>(out + 4 * (lane + kLanesPerRow * j)) =
          make_float4(a.x / denom, a.y / denom, a.z / denom, a.w / denom);
    }
  }
}

}  // namespace cc

// =============================================== bf16: wgmma, TMA, mbarrier

namespace wg {

using namespace hopper;

constexpr int kConsumers = 2;                    // consumer warpgroups
constexpr int kRows = 64 * kConsumers;           // folded q rows per block
constexpr int kThreads = 128 * (kConsumers + 1);  // + one producer warpgroup
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;  // 2 x 128 x 240 + 128 x 24 <= 65536

template <int D>
struct Tile {
  static constexpr int BK = D == 256 ? 64 : 128;   // kv positions per stage
  static constexpr int kStages = 2;
  static constexpr int kBlocks = D / 64;           // 64-wide column blocks
  static constexpr int ON = D < 128 ? D : 128;     // output cols per wgmma
  static constexpr uint32_t kQBytes = kRows * D * 2;
  static constexpr uint32_t kTileBytes = BK * D * 2;   // one k or v stage
  static constexpr size_t kSmem =
      1024 + kQBytes + 2 * size_t(kStages) * kTileBytes + 8 * (2 + 4 * kStages);
  static_assert(D % 64 == 0 && BK % 64 == 0, "rows of whole 128-byte atoms");
  static_assert(kSmem <= kSmemLimit, "q and the kv ring exceed a block");
};

// S (64 x BK, this thread's fragment) -> t = tanh_ex2(S * in_scale) =
// tanh(S * scale / softcap) when kCap (in_scale = 2 log2 e scale / softcap),
// else S, and -inf where kMask's masks hide the entry (segk: batch b's
// seg_kv, or null; sq: the thread's two rows' segment ids); the row maxima
// of t are folded into mx (two partial maxima per row for ILP).  The score
// in log2 units is t * mult (mult = softcap * log2 e, or scale * log2 e),
// which the exponent's FMA applies.
template <int BK, bool kMask, bool kCap>
__device__ __forceinline__ void scores(float (&sc)[BK / 2], const Params& p,
                                       float in_scale, int k0, int lane,
                                       const int (&qpos)[2],
                                       const int* segk, const int (&sq)[2],
                                       float (&mx)[2]) {
  float mp[2][2] = {{mx[0], mx[0]}, {mx[1], mx[1]}};
#pragma unroll
  for (int e = 0; e < BK / 2; ++e) {
    float x = kCap ? tanh_ex2(sc[e] * in_scale) : sc[e];
    const int h = (e / 2) % 2;
    if (kMask) {
      const int kp = k0 + 8 * (e / 4) + 2 * (lane % 4) + (e % 2);
      bool ok = kp < p.Sk;
      if (p.causal) ok = ok && kp <= qpos[h];
      if (p.window > 0) ok = ok && qpos[h] - kp < p.window;
      if (segk) ok = ok && segk[kp] == sq[h];
      x = ok ? x : -INFINITY;
    }
    sc[e] = x;
    mp[h][e % 2] = fmaxf(mp[h][e % 2], x);
  }
  mx[0] = fmaxf(mp[0][0], mp[0][1]);
  mx[1] = fmaxf(mp[1][0], mp[1][1]);
}

// One work item: the q tile of BQ positions at q0 of batch b, kv head kh,
// and the kv tiles [kv_begin, kv_begin + n_tiles * BK) its masks leave live.
// Items are numbered longest first: item w has q tile nq - 1 - w / (B KH).
struct Work {
  int b, kh, q0, kv_begin, n_tiles;
};

// The item of this block's pass k (snake order), or -1 past the last one.
__device__ __forceinline__ int work_index(int k, int n_work) {
  const int j = (k & 1) ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const long long w = (long long)k * gridDim.x + j;
  return w < n_work ? (int)w : -1;
}

template <int BK>
__device__ __forceinline__ Work work_item(const Params& p, int w) {
  const int nq = (p.Sq + p.BQ - 1) / p.BQ, bh = w % (p.B * p.KH);
  Work it;
  it.b = bh / p.KH;
  it.kh = bh % p.KH;
  it.q0 = (nq - 1 - w / (p.B * p.KH)) * p.BQ;
  int kv_end;
  kv_range(p, it.q0, BK, it.kv_begin, kv_end);
  it.n_tiles = kv_end > it.kv_begin ? (kv_end - it.kv_begin + BK - 1) / BK : 0;
  return it;
}

// Fragment layout of a wgmma accumulator (64 x N f32, PTX ISA): thread t of
// the warpgroup, in warp w = t / 32 with lane l, holds rows 16w + l/4 (h=0)
// and 16w + l/4 + 8 (h=1) at columns 8j + 2(l%4) + {0, 1}: element
// e = 4j + 2h + {0, 1}.  The A operand of wgmma from registers (64 x 16
// bf16) has the same layout, so S's elements 8kk .. 8kk + 7 are P's A
// fragment for keys 16kk .. 16kk + 15.
//
// Persistent: gridDim.x blocks (at most one per SM) walk the work items in
// passes of gridDim.x, forwards in even passes and backwards in odd ones
// (block j takes items j, 2 gridDim.x - 1 - j, 2 gridDim.x + j, ...), so
// with items longest first every block gets a similar sum of kv tiles.
// The kv ring's stage and phase run on across items, so the producer loads
// the next item's q and first kv tiles while the consumers finish the
// current one.
//
// kExt: the kernel reads segment ids and writes lse where Params holds them
// (training).  Without it neither is compiled in, so the serving path runs
// the code it ran before either existed (a branch between a wgmma's issue
// and its wait costs even when not taken).
template <int D, bool kExt>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_fwd_wgmma(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          __nv_bfloat16* __restrict__ o, const Params p) {
  using T = Tile<D>;
  constexpr int BK = T::BK, S = T::kStages, ON = T::ON;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sQ = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* sK = sQ + T::kQBytes;
  unsigned char* sV = sK + S * T::kTileBytes;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sV + S * T::kTileBytes);
  uint64_t* q_empty = q_full + 1;
  uint64_t* k_full = q_empty + 1;
  uint64_t* v_full = k_full + S;
  uint64_t* k_empty = v_full + S;
  uint64_t* v_empty = k_empty + S;

  const int n_work = p.B * p.KH * ((p.Sq + p.BQ - 1) / p.BQ);
  const int wgi = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, 4 * kConsumers);       // lane 0 of each consumer warp
#pragma unroll
    for (int s = 0; s < S; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&k_empty[s], 4 * kConsumers);
      mbar_init(&v_empty[s], 4 * kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wgi == kConsumers) {
    // ------------------------------------------------------------ producer
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == kConsumers * 128) {
      tma_prefetch_map(&tq);
      tma_prefetch_map(&tk);
      tma_prefetch_map(&tv);
      int ring = 0, u = 0;   // kv tiles and work items loaded so far
      for (int w; (w = work_index(u, n_work)) >= 0; ++u) {
        const Work it = work_item<BK>(p, w);
        if (u > 0) mbar_wait(q_empty, (u - 1) & 1);
        mbar_arrive_expect_tx(q_full, T::kBlocks * p.G * p.BQ * 128);
#pragma unroll
        for (int c = 0; c < T::kBlocks; ++c)
          tma_load_5d(sQ + c * kRows * 128, &tq, q_full, c * 64, 0, it.kh,
                      it.q0, it.b);
        for (int i = 0; i < it.n_tiles; ++i, ++ring) {
          const int s = ring % S;
          const uint32_t reuse = ((ring / S) - 1) & 1;
          const int k0 = it.kv_begin + i * BK;
          unsigned char* ks = sK + s * T::kTileBytes;
          unsigned char* vs = sV + s * T::kTileBytes;
          if (ring >= S) mbar_wait(&k_empty[s], reuse);
          mbar_arrive_expect_tx(&k_full[s], T::kTileBytes);
#pragma unroll
          for (int c = 0; c < T::kBlocks; ++c)
            tma_load_4d(ks + c * BK * 128, &tk, &k_full[s], c * 64, it.kh, k0,
                        it.b);
          if (ring >= S) mbar_wait(&v_empty[s], reuse);
          mbar_arrive_expect_tx(&v_full[s], T::kTileBytes);
#pragma unroll
          for (int c = 0; c < T::kBlocks; ++c)
            tma_load_4d(vs + c * BK * 128, &tv, &v_full[s], c * 64, it.kh, k0,
                        it.b);
        }
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    setmaxnreg_inc<kConsumerRegs>();
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    const int rows = p.G * p.BQ;
    const bool capped = p.softcap > 0.f;
    const float in_scale = capped ? 2.f * kLog2e * p.scale / p.softcap : 1.f;
    const float mult = (capped ? p.softcap : p.scale) * kLog2e;
    const uint32_t q_base = smem_u32(sQ) + wgi * 64 * 128;

    float acc[D / ON][ON / 2];
    float m[2], l[2];          // running max (t units), lane's part of l
    int qpos[2], sq[2];        // the thread's rows' positions, segment ids
    int q_lo, q_hi, kv_begin;  // of the current work item
    const int* segk = nullptr;   // the item's batch row of seg_kv

    // S = q . k^T for ring slot r: A = q, B = k, both K-major
    auto issue_qk = [&](int r, float (&sc)[BK / 2]) {
      const uint32_t k_base = smem_u32(sK + (r % S) * T::kTileBytes);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t col = (kk % 4) * 32;
        Wgmma<BK, 0>::ss(
            sc, desc_sw128(q_base + (kk / 4) * kRows * 128 + col, 16, 1024),
            desc_sw128(k_base + (kk / 4) * BK * 128 + col, 16, 1024), kk > 0);
      }
      wgmma_commit();
    };
    // O += P . V for ring slot r: A = P from registers, B = v (MN-major)
    auto issue_pv = [&](int r, const uint32_t (&pa)[BK / 16][4]) {
      const uint32_t v_base = smem_u32(sV + (r % S) * T::kTileBytes);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int c = 0; c < D / ON; ++c)
          Wgmma<ON, 1>::rs(
              acc[c], pa[kk],
              desc_sw128(v_base + c * (ON / 64) * BK * 128 + kk * 16 * 128,
                         BK * 128, 1024),
              1);
      wgmma_commit();
    };
    // Whether tile i needs the segment mask in this warp: some kv segment
    // id of the tile differs from one of the warp's rows' (a warp-wide min
    // and max of the tile's ids; false without segment ids).  Called before
    // a wgmma wait, so its loads overlap the product in flight.
    auto seg_edge = [&](int i) -> bool {
      if (!kExt || !segk) return false;
      const int k0 = kv_begin + i * BK;
      int lo = INT_MAX, hi = INT_MIN;
#pragma unroll
      for (int j = lane; j < BK; j += 32) {
        const int kp = min(k0 + j, p.Sk - 1);
        lo = min(lo, segk[kp]);
        hi = max(hi, segk[kp]);
      }
      lo = __reduce_min_sync(0xffffffffu, lo);
      hi = __reduce_max_sync(0xffffffffu, hi);
      return __any_sync(0xffffffffu, lo != hi || sq[0] != lo || sq[1] != lo);
    };
    // Online softmax of tile i's S (masks only on edge tiles): S becomes P
    // = exp2(t * mult - m * mult) in place, l is rescaled and summed, corr
    // is the factor that takes O to the new running max m (in t units).
    auto softmax = [&](int i, float (&sc)[BK / 2], float (&corr)[2],
                       bool seg_mask) {
      const int k0 = kv_begin + i * BK;
      const bool edge = seg_mask || k0 + BK > p.Sk ||
                        (p.causal && k0 + BK - 1 > q_lo) ||
                        (p.window > 0 && q_hi - k0 >= p.window);
      const int* sk = seg_mask ? segk : nullptr;
      float mx[2] = {m[0], m[1]};
      if (edge && capped)
        scores<BK, true, true>(sc, p, in_scale, k0, lane, qpos, sk, sq, mx);
      else if (edge)
        scores<BK, true, false>(sc, p, in_scale, k0, lane, qpos, sk, sq, mx);
      else if (capped)
        scores<BK, false, true>(sc, p, in_scale, k0, lane, qpos, sk, sq, mx);
      else
        scores<BK, false, false>(sc, p, in_scale, k0, lane, qpos, sk, sq,
                                 mx);
      float neg_m[2], ls[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float m_use = mx[h] == -INFINITY ? 0.f : mx[h];
        corr[h] = ex2_approx((m[h] - m_use) * mult);   // 0 while m is -inf
        neg_m[h] = -m_use * mult;
        m[h] = mx[h];
        l[h] *= corr[h];
      }
#pragma unroll
      for (int e = 0; e < BK / 2; ++e) {
        const int h = (e / 2) % 2;
        sc[e] = ex2_approx(fmaf(sc[e], mult, neg_m[h]));
        ls[h][e % 2] += sc[e];
      }
      l[0] += ls[0][0] + ls[0][1];
      l[1] += ls[1][0] + ls[1][1];
    };
    auto to_bf16 = [&](const float (&sc)[BK / 2], uint32_t (&pa)[BK / 16][4]) {
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          pa[kk][j] = pack_bf16(sc[8 * kk + 2 * j], sc[8 * kk + 2 * j + 1]);
    };
    auto rescale = [&](const float (&corr)[2]) {
#pragma unroll
      for (int c = 0; c < D / ON; ++c)
#pragma unroll
        for (int e = 0; e < ON / 2; ++e) acc[c][e] *= corr[(e / 2) % 2];
    };
    auto arrive = [&](uint64_t* bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };
    auto parity = [](int r) { return (uint32_t)((r / S) & 1); };
    // The two consumer warpgroups take turns to issue their products
    // (named barriers 1 and 2), so one's softmax overlaps the other's
    // products; warpgroup 0 goes first.
    auto my_turn = [&]() { named_bar_sync(1 + wgi, 256); };
    auto pass_turn = [&]() { named_bar_arrive(2 - wgi, 256); };
    if (wgi == 1) pass_turn();

    int ring = 0, u = 0;   // kv tiles and work items consumed so far
    for (int w; (w = work_index(u, n_work)) >= 0; ++u) {
      const Work it = work_item<BK>(p, w);
      const int n = it.n_tiles;
      bool valid[2];
      size_t out_off[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wgi * 64 + warp * 16 + lane / 4 + 8 * h;
        const int sl = r / p.G, g = r % p.G;
        valid[h] = r < rows && it.q0 + sl < p.Sq;
        qpos[h] = p.q_offset + it.q0 + sl;
        sq[h] = kExt ? seg_of_q(p, it.b, it.q0 + sl) : 0;
        out_off[h] = (((size_t)it.b * p.Sq + it.q0 + sl) * p.H +
                      it.kh * p.G + g) * (size_t)D;
        m[h] = -INFINITY;
        l[h] = 0.f;
      }
      q_lo = p.q_offset + it.q0;
      q_hi = p.q_offset + min(it.q0 + p.BQ, p.Sq) - 1;
      kv_begin = it.kv_begin;
      if (kExt && p.seg_kv) segk = p.seg_kv + (size_t)it.b * p.Sk;
#pragma unroll
      for (int c = 0; c < D / ON; ++c)
#pragma unroll
        for (int e = 0; e < ON / 2; ++e) acc[c][e] = 0.f;

      mbar_wait(q_full, u & 1);
      uint32_t pa[BK / 16][4];   // P(i - 1), read by the product in flight
      if (n == 0) arrive(q_empty);
      float corr[2];   // takes O to the running max of the last softmax
      if (n > 0) {     // tile 0: S and its softmax
        float sc[BK / 2];
#pragma unroll
        for (int e = 0; e < BK / 2; ++e) sc[e] = 0.f;
        mbar_wait(&k_full[ring % S], parity(ring));
        my_turn();
        fence_regs(sc);
        wgmma_fence();
        issue_qk(ring, sc);
        pass_turn();
        const bool seg_mask = seg_edge(0);
        wgmma_wait<0>();
        fence_regs(sc);
        arrive(&k_empty[ring % S]);
        if (n == 1) arrive(q_empty);
        softmax(0, sc, corr, seg_mask);
        to_bf16(sc, pa);
      }
      // Tile i: issue S(i), rescale O while it runs, issue P(i-1) . v(i-1);
      // the softmax of S(i) runs while the second product is in flight.
      for (int i = 1; i < n; ++i) {
        const int r = ring + i;
        float sc[BK / 2];
#pragma unroll
        for (int e = 0; e < BK / 2; ++e) sc[e] = 0.f;
        mbar_wait(&k_full[r % S], parity(r));
        my_turn();
        fence_regs(sc);
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) fence_regs(pa[kk]);
        wgmma_fence();
        issue_qk(r, sc);
        rescale(corr);
        mbar_wait(&v_full[(r - 1) % S], parity(r - 1));
#pragma unroll
        for (int c = 0; c < D / ON; ++c) fence_regs(acc[c]);
        wgmma_fence();
        issue_pv(r - 1, pa);
        pass_turn();
        const bool seg_mask = seg_edge(i);
        wgmma_wait<1>();
        fence_regs(sc);
        arrive(&k_empty[r % S]);
        if (i == n - 1) arrive(q_empty);   // the item's last use of q
        softmax(i, sc, corr, seg_mask);
        wgmma_wait<0>();
#pragma unroll
        for (int c = 0; c < D / ON; ++c) fence_regs(acc[c]);
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) fence_regs(pa[kk]);
        arrive(&v_empty[(r - 1) % S]);
        to_bf16(sc, pa);
      }
      if (n > 0) {   // the last tile's P . V
        const int r = ring + n - 1;
        mbar_wait(&v_full[r % S], parity(r));
        my_turn();
        rescale(corr);
#pragma unroll
        for (int c = 0; c < D / ON; ++c) fence_regs(acc[c]);
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) fence_regs(pa[kk]);
        wgmma_fence();
        issue_pv(r, pa);
        pass_turn();
        wgmma_wait<0>();
#pragma unroll
        for (int c = 0; c < D / ON; ++c) fence_regs(acc[c]);
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) fence_regs(pa[kk]);
        arrive(&v_empty[r % S]);
      }
      ring += n;

#pragma unroll
      for (int h = 0; h < 2; ++h) {
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
        if (!valid[h]) continue;
        if (kExt && p.lse && lane % 4 == 0) {
          // ln sum 2^(t mult) = (m mult + log2 l) ln 2
          const int r = wgi * 64 + warp * 16 + lane / 4 + 8 * h;
          p.lse[lse_index(p, it.b, it.kh * p.G + r % p.G,
                          it.q0 + r / p.G)] =
              l[h] > 0.f ? (m[h] * mult + log2f(l[h])) * 0.6931471805599453f
                         : -INFINITY;
        }
        const float inv = l[h] > 0.f ? 1.f / l[h] : 0.f;
        __nv_bfloat16* out = o + out_off[h] + 2 * (lane % 4);
#pragma unroll
        for (int c = 0; c < D / ON; ++c)
#pragma unroll
          for (int j = 0; j < ON / 8; ++j) {
            const int e = 4 * j + 2 * h;
            *reinterpret_cast<__nv_bfloat162*>(out + c * ON + 8 * j) =
                __floats2bfloat162_rn(acc[c][e] * inv, acc[c][e + 1] * inv);
          }
      }
    }
    if (wgi == 0) my_turn();   // warpgroup 1's last pass
  }
}

}  // namespace wg

// G <= kRows q heads per kv head (checked at the C entry) fold into every
// kernel's block: BQ = rows / G >= 1.
static_assert(wg::kRows >= kRows && tc::kThreads / 32 * 16 == kRows,
              "a block folds at least kRows rows");

template <int D, bool kExt>
int launch_wgmma(const void* q, const void* k, const void* v, void* o,
                 Params p, cudaStream_t stream) {
  using T = wg::Tile<D>;
  p.BQ = wg::kRows / p.G;
  const int n_q_tiles = (p.Sq + p.BQ - 1) / p.BQ;
  const uint64_t e = sizeof(__nv_bfloat16);
  // q (B, Sq, H = KH x G, D) as 5-D (D, G, KH, Sq, B); box 64 x G x 1 x BQ
  // x 1 lands as G * BQ rows of 128 bytes, row = position * G + head
  const uint64_t qd[5] = {(uint64_t)D, (uint64_t)p.G, (uint64_t)p.KH,
                          (uint64_t)p.Sq, (uint64_t)p.B};
  const uint64_t qs[4] = {D * e, p.G * D * e, p.H * D * e,
                          (uint64_t)p.Sq * p.H * D * e};
  const uint32_t qb[5] = {64, (uint32_t)p.G, 1, (uint32_t)p.BQ, 1};
  // k, v (B, Sk, KH, D) as 4-D (D, KH, Sk, B); box 64 x 1 x BK x 1
  const uint64_t kd[4] = {(uint64_t)D, (uint64_t)p.KH, (uint64_t)p.Sk,
                          (uint64_t)p.B};
  const uint64_t ks[3] = {D * e, p.KH * D * e, (uint64_t)p.Sk * p.KH * D * e};
  const uint32_t kb[4] = {64, 1, (uint32_t)T::BK, 1};
  CUtensorMap tq, tk, tv;
  int err = hopper::encode_tensor_map_bf16(&tq, q, 5, qd, qs, qb);
  if (!err) err = hopper::encode_tensor_map_bf16(&tk, k, 4, kd, ks, kb);
  if (!err) err = hopper::encode_tensor_map_bf16(&tv, v, 4, kd, ks, kb);
  if (err) return err;
  auto kernel = wg::flash_attention_fwd_wgmma<D, kExt>;
  // The shared-memory attribute is set, and the SM count read, once per
  // device, so a launch costs the host only the three tensor maps.
  static std::atomic<int> sms_of[kMaxDevices];   // 0: not yet prepared
  int device;
  cudaError_t cerr = cudaGetDevice(&device);
  if (cerr != cudaSuccess) return (int)cerr;
  if (device >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  int sms = sms_of[device].load(std::memory_order_relaxed);
  if (sms == 0) {
    cerr = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::kSmem);
    if (cerr == cudaSuccess)
      cerr = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device);
    if (cerr != cudaSuccess) return (int)cerr;
    sms_of[device].store(sms, std::memory_order_relaxed);
  }
  const long long n_work = (long long)p.B * p.KH * n_q_tiles;
  if (n_work > (1ll << 31) - 1) return (int)cudaErrorInvalidValue;
  const int grid = (int)(n_work < sms ? n_work : sms);
  kernel<<<grid, wg::kThreads, T::kSmem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), p);
  return (int)cudaGetLastError();
}

template <typename T, typename Kernel>
int launch(Kernel kernel, int threads, size_t smem, const void* q,
           const void* k, const void* v, void* o, Params p,
           cudaStream_t stream) {
  p.BQ = kRows / p.G;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.Sq + p.BQ - 1) / p.BQ, p.B * p.KH);
  kernel<<<grid, threads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), p);
  return (int)cudaGetLastError();
}

template <int D>
int launch_d(int dtype, const void* q, const void* k, const void* v, void* o,
             const Params& p, cudaStream_t stream) {
  static_assert(cc::smem_bytes<D>() <= kSmemLimit &&
                tc::smem_bytes<D>() <= kSmemLimit, "tiles exceed a block");
  const bool ext = p.seg_q || p.lse;
  if (dtype == 0)
    return launch<float>(ext ? cc::flash_attention_fwd_cc<D, true>
                             : cc::flash_attention_fwd_cc<D, false>,
                         cc::kThreads, cc::smem_bytes<D>(), q, k, v, o, p,
                         stream);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  if constexpr (D >= 64)
    return ext ? launch_wgmma<D, true>(q, k, v, o, p, stream)
               : launch_wgmma<D, false>(q, k, v, o, p, stream);
  else
    return launch<__nv_bfloat16>(ext ? tc::flash_attention_fwd_tc<D, true>
                                     : tc::flash_attention_fwd_tc<D, false>,
                                 tc::kThreads, tc::smem_bytes<D>(), q, k, v,
                                 o, p, stream);
}

// Dynamic shared memory of the kernel that takes (dtype, D).
template <int D>
int smem_d(int dtype) {
  if (dtype == 0) return (int)cc::smem_bytes<D>();
  if constexpr (D >= 64)
    return (int)wg::Tile<D>::kSmem;
  else
    return (int)tc::smem_bytes<D>();
}

}  // namespace

extern "C" {

// q (B, Sq, H, D), k and v (B, Sk, KH, D), o (B, Sq, H, D), all contiguous,
// 16-byte aligned and of one dtype (0: float32, 1: bfloat16); Sk > 0.
// seg_q (B, Sq) and seg_kv (B, Sk) int32, both or neither (null); lse
// (B, H, Sq) f32 or null.  Launches on `stream`, does not synchronise, and
// returns the cudaError_t of the launch (0 on success).
int flash_attention_fwd_seg(const void* q, const void* k, const void* v,
                            void* o, const int* seg_q, const int* seg_kv,
                            float* lse, int dtype, int B, int Sq, int Sk,
                            int H, int KH, int D, int causal, int window,
                            float softcap, float scale, int q_offset,
                            void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || KH <= 0 || H % KH != 0 ||
      H / KH > kRows || (seg_q == nullptr) != (seg_kv == nullptr))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.B = B; p.Sq = Sq; p.Sk = Sk; p.H = H; p.KH = KH; p.G = H / KH;
  p.BQ = 0;   // set by the launcher: rows per block / G
  p.causal = causal; p.window = window; p.q_offset = q_offset;
  p.softcap = softcap; p.scale = scale;
  p.seg_q = seg_q; p.seg_kv = seg_kv; p.lse = lse;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch_d<16>(dtype, q, k, v, o, p, s);
    case 32: return launch_d<32>(dtype, q, k, v, o, p, s);
    case 64: return launch_d<64>(dtype, q, k, v, o, p, s);
    case 128: return launch_d<128>(dtype, q, k, v, o, p, s);
    case 256: return launch_d<256>(dtype, q, k, v, o, p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The same without segment ids or lse: the entry that earlier sources of
// this kernel have too, so that one caller can time them all (chip_smoke.py
// --baseline).
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        int dtype, int B, int Sq, int Sk, int H, int KH, int D,
                        int causal, int window, float softcap, float scale,
                        int q_offset, void* stream) {
  return flash_attention_fwd_seg(q, k, v, o, nullptr, nullptr, nullptr, dtype,
                                 B, Sq, Sk, H, KH, D, causal, window, softcap,
                                 scale, q_offset, stream);
}

// Dynamic shared memory per block, in bytes, of the kernel that a launch
// with (dtype, D) takes (ptxas reports only static shared memory), or -1
// for a pair that no kernel takes.
int flash_attention_fwd_smem_bytes(int dtype, int D) {
  if (dtype != 0 && dtype != 1) return -1;
  switch (D) {
    case 16: return smem_d<16>(dtype);
    case 32: return smem_d<32>(dtype);
    case 64: return smem_d<64>(dtype);
    case 128: return smem_d<128>(dtype);
    case 256: return smem_d<256>(dtype);
    default: return -1;
  }
}

const char* flash_attention_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
