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
// What bounds it on an H100.  At falcon-mamba-7b's train shape (B=4,
// T=1024, d=8192, n=16; x bf16, dt f32) the function reads x, dt, dy and
// writes dx, ddt, (2 + 4 + 2 + 2 + 4) bytes x 33.6 M = 470 MB with B, C and
// the states, 0.14 ms at 3.35 TB/s; its 22 n + 10 operations a channel and
// step take 0.18 ms at the f32 peak; its B T d n = 5.4e8 exponentials 0.128
// ms at 16 MUFU results per SM and clock.  A design also issues its loads,
// shuffles and shared-memory traffic: at the rate of one warp instruction
// per scheduler and clock, each instruction per state and step costs about
// 0.018 ms at this shape, so the instruction count, not memory, is the
// limit.
//
// The design.
//  * Lanes.  Four lanes share a channel, each holding 4 of its states
//    (n padded to 16 with A = B = C = 0, whose states stay 0).  A block is
//    128 channels of one batch row, 512 threads, one block an SM; the
//    grid, ceil(d / 128) x B, is 1.94 waves of 132 SMs at the train shape.
//    Up to 128 registers a thread, no spills, 16 warps an SM.
//  * States.  The forward (entry selective_scan_ckpt) writes the state
//    before every kK-th step to ckpt.  For each chunk of kK = 8 steps, last
//    chunk first, a thread starts from the checkpoint and recomputes its 4
//    states with the forward's own arithmetic (ex2 of dt times A prescaled
//    by log2 e, then one FMA), so they are the forward's bitwise.  It keeps
//    each state before a step in shared memory (8 x 16 bytes a thread) and
//    each exponential in registers (8 x 4), and the reverse pass reads
//    both: every exponential is evaluated once, 5.4e8 at the train shape.
//    (Chunks of 16 steps held 64 exponentials a thread and left the kernel
//    at the 128-register cap with spills, 1.00 ms at the train shape on an
//    H100; checkpoints every 8 steps cost the forward 134 MB more writes
//    there, 0.03 ms.)
//  * Loads.  A chunk's x, dt, dy (as float32, one row of 128 channels a
//    step) and B_t, C_t live in shared memory, double-buffered: the next
//    chunk's are loaded into registers as a chunk starts and stored after
//    its reverse pass, so the serial chain never waits on device memory.
//  * Sums over a channel's states.  dx_t and ddt_t: each lane sums its 4
//    states in order, then the 4 lanes by two butterfly shuffles (xor 1,
//    then 2), which leave the same sum in all 4.  Lane 0 puts dx, lane 1
//    ddt into shared memory; after the chunk the block writes both as
//    whole rows.
//  * Sums over channels.  dBm_t and dC_t sum over d.  The 8 channels of a
//    warp are summed by a reduce-scatter of the 8 values a lane holds (4
//    states x dB, dC): lane bit 4 halves the states, bit 3 halves them
//    again, bit 2 sums dB and dC whole, 8 shuffles.  The halving takes no
//    selects because a lane's 4 states are permuted by its lane bits 3-4
//    (slot s holds state 4 q + (s ^ p), p = (lane >> 3) & 3): every lane
//    sends slots 2, 3 and keeps 0, 1, then sends 1 and keeps 0; B_t and
//    C_t are staged in 4 copies, one for each p.  Each warp's 32 sums a
//    step go to shared memory; after the chunk the block sums its 16
//    warps in order and writes one partial a block (part_bc, B x
//    ceil(d / 128) x T x 32, 33.5 MB at the train shape), which a second
//    kernel sums over the blocks in order.
//  * dA and dD sum over B and T: a lane sums its states' over T in
//    registers and writes them per batch row (part_ad); a last kernel sums
//    the rows in order.  No float atomics: two calls are bitwise equal.
//  * Offsets in a batch row are 32-bit where T * d < 2^31 and 64-bit
//    beyond, as the forward's.
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

constexpr int kNP = 16;                 // states, n padded (ops.BWD_STATES)
constexpr int kLanes = 4;               // lanes a channel
constexpr int kS = kNP / kLanes;        // states a lane
constexpr int kCh = 128;                // channels a block (ops.BWD_CHANNELS)
constexpr int kThreads = kCh * kLanes;  // 512
constexpr int kWarps = kThreads / 32;   // 16
constexpr int kK = 8;                   // steps a chunk (ops.CKPT_STEPS)
constexpr int kV = 2 * kNP;             // dB and dC sums of a step
constexpr int kPerm = 4;                // permuted copies of B_t and C_t
constexpr int kRows = kThreads / kCh;   // rows of a chunk a thread stages
constexpr int kPer = kK / kRows;        // elements of x (dt, dy) a thread
constexpr int kBC = kK * kNP;           // elements of B (of C) a chunk
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

static_assert(kS == 4, "a lane's states are one float4");
static_assert(kThreads >= kK * kV, "the block sum: one thread a value");
static_assert(kThreads >= 2 * kBC, "B and C: one element a thread");

// Shared memory in floats: the states [kK][kThreads] (float4 each), two
// stages of a chunk's inputs, the warps' sums [kK][kWarps][kV], and the
// chunk's dx and ddt [2][kK][kCh].
constexpr int kStageDt = 0;
constexpr int kStageX = kK * kCh;
constexpr int kStageDy = 2 * kK * kCh;
constexpr int kStageB = 3 * kK * kCh;               // [kPerm][kK][kNP]
constexpr int kStageC = kStageB + kPerm * kK * kNP;
constexpr int kStage = kStageC + kPerm * kK * kNP;
constexpr int kSmemH = kK * kThreads * 4;
constexpr int kSmemRed = kK * kWarps * kV;
constexpr int kSmemOut = 2 * kK * kCh;
constexpr size_t kSmemBytes =
    sizeof(float) * ((size_t)kSmemH + 2 * kStage + kSmemRed + kSmemOut);
static_assert(kSmemBytes <= 232448, "one block an SM");

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

// One thread's share of a chunk's inputs while they are in flight: kPer
// elements of x, dt and dy (rows tid / kCh + kRows k of the chunk, channel
// tid % kCh), one of B or C (threads below kBC: B, then C; step
// (tid % kBC) / 16, state tid % 16; the rest load one again) and its own 4
// checkpointed states.
template <typename TX, typename TB>
struct Staged {
  TX x[kPer];
  float dt[kPer];
  TX dy[kPer];
  TB bc;
  float ck[kS];
};

struct Pos {            // where a thread is
  int b, c0, tid, q, p; // batch row, first channel of the block, thread,
                        // state group, permutation of its states
  int chl;              // its channel, clamped into range
  bool live;            // its channel exists
};

// Issue the loads of chunk c (all unconditional, at indices clamped into
// range; the store selects).
template <typename Off, typename TX, typename TB>
__device__ __forceinline__ void stage_load(
    Staged<TX, TB>& s, const TX* __restrict__ x, const float* __restrict__ dt,
    const TX* __restrict__ dy, const TB* __restrict__ Bm,
    const TB* __restrict__ Cm, const float* __restrict__ ckpt, long long sb_b,
    long long sb_t, long long sc_b, long long sc_t, const Pos& ps, int c,
    int T_, int d, int n) {
  const int t0 = c * kK;
  const size_t row = (size_t)ps.b * T_ * d;
  const Off chan = (Off)min(ps.c0 + (ps.tid & (kCh - 1)), d - 1);
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int u = ps.tid / kCh + kRows * k;
    const Off off = (Off)min(t0 + u, T_ - 1) * (Off)d + chan;
    s.x[k] = x[row + off];
    s.dt[k] = dt[row + off];
    s.dy[k] = dy[row + off];
  }
  const int r = ps.tid % kBC, u = r / kNP, i = r % kNP;
  const bool isC = (ps.tid / kBC) & 1;
  const TB* P = isC ? Cm + ps.b * sc_b : Bm + ps.b * sb_b;
  const long long st = isC ? sc_t : sb_t;
  s.bc = P[(long long)min(t0 + u, T_ - 1) * st + min(i, n - 1)];
  const int nck = (T_ + kK - 1) / kK;
  const float* cp = ckpt + (((size_t)ps.b * nck + c) * d + ps.chl) * n;
#pragma unroll
  for (int k = 0; k < kS; ++k)
    s.ck[k] = cp[min(kS * ps.q + (k ^ ps.p), n - 1)];
}

// Store chunk c's staged inputs into stage `stg` (0 past T, past d and
// past n) and hand the checkpointed states to h.
template <typename TX, typename TB>
__device__ __forceinline__ void stage_store(const Staged<TX, TB>& s,
                                            float* __restrict__ stg,
                                            const Pos& ps, int c, int T_,
                                            int d, int n, float (&h)[kS]) {
  const int t0 = c * kK;
  const int cc = ps.tid & (kCh - 1);
  const bool okc = ps.c0 + cc < d;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int u = ps.tid / kCh + kRows * k;
    const bool ok = okc && t0 + u < T_;
    stg[kStageX + u * kCh + cc] = ok ? to_f32(s.x[k]) : 0.f;
    stg[kStageDt + u * kCh + cc] = ok ? s.dt[k] : 0.f;
    stg[kStageDy + u * kCh + cc] = ok ? to_f32(s.dy[k]) : 0.f;
  }
  if (ps.tid < 2 * kBC) {
    const int r = ps.tid % kBC, u = r / kNP, i = r % kNP;
    const bool isC = ps.tid >= kBC;
    const float v = t0 + u < T_ && i < n ? to_f32(s.bc) : 0.f;
    float* base = stg + (isC ? kStageC : kStageB);
#pragma unroll
    for (int p = 0; p < kPerm; ++p)
      base[(p * kK + u) * kNP + ((i & ~3) | ((i & 3) ^ p))] = v;
  }
#pragma unroll
  for (int k = 0; k < kS; ++k)
    h[k] = ps.live && kS * ps.q + (k ^ ps.p) < n ? s.ck[k] : 0.f;
}

// threadIdx.x, blockIdx.x and blockIdx.y read from their special registers
// at this point (volatile: not merged with an earlier read, so a value
// needed only at a kernel's end need not stay in a register until then).
__device__ __forceinline__ int thread_index() {
  int v;
  asm volatile("mov.u32 %0, %%tid.x;\n" : "=r"(v));
  return v;
}

__device__ __forceinline__ int block_index_x() {
  int v;
  asm volatile("mov.u32 %0, %%ctaid.x;\n" : "=r"(v));
  return v;
}

__device__ __forceinline__ int block_index_y() {
  int v;
  asm volatile("mov.u32 %0, %%ctaid.y;\n" : "=r"(v));
  return v;
}

__device__ __forceinline__ void ld4(const float* p, float (&v)[kS]) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
}

template <typename TX, typename TB, typename Off>
__global__ void __launch_bounds__(kThreads, 1)
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
  extern __shared__ __align__(16) float smem[];
  float* sH = smem;                          // [kK][kThreads] float4
  float* stage0 = sH + kSmemH;
  float* sRed = stage0 + 2 * kStage;         // [kK][kWarps][kV]
  float* sOut = sRed + kSmemRed;             // [2][kK][kCh]: dx, ddt

  Pos ps;
  ps.b = blockIdx.y;
  ps.c0 = blockIdx.x * kCh;
  ps.tid = threadIdx.x;
  ps.q = ps.tid & 3;
  const int lane = ps.tid & 31, warp = ps.tid >> 5;
  ps.p = (lane >> 3) & 3;
  const int b2 = (lane >> 2) & 1;
  const int cl = ps.tid >> 2;                // channel in the block
  const int ch = ps.c0 + cl;
  ps.live = ch < d;
  ps.chl = ps.live ? ch : 0;
  const int nck = (T_ + kK - 1) / kK;

  // this lane's states, slot k holding state kS q + (k ^ p)
  const size_t hbase = ((size_t)ps.b * d + ps.chl) * n;
  float A2[kS], g[kS], dA[kS], h[kS];
#pragma unroll
  for (int k = 0; k < kS; ++k) {
    const int i = kS * ps.q + (k ^ ps.p);
    const bool ok = ps.live && i < n;
    const int ic = min(i, n - 1);
    const float av = A[(size_t)ps.chl * n + ic];
    const float gv = dh_last[hbase + ic];
    A2[k] = ok ? av * kLog2e : 0.f;         // the forward's
    g[k] = ok ? gv : 0.f;
    dA[k] = 0.f;
  }
  const float Dch = ps.live ? Dv[ps.chl] : 0.f;
  float dD = 0.f;
  // where this lane's sums of a step go: its slot of the warp's 32 after
  // the shuffles below (lane bit 2 picks dB or dC, state kS q + p), and
  // lane 0's dx, lane 1's ddt
  float* myRed = sRed + warp * kV + b2 * kNP + kS * ps.q + ps.p;
  float* myOut = sOut + (ps.q & 1) * kK * kCh + cl;

  {
    Staged<TX, TB> s;
    stage_load<Off>(s, x, dt, dy, Bm, Cm, ckpt, sb_b, sb_t, sc_b, sc_t, ps,
                    nck - 1, T_, d, n);
    stage_store(s, stage0 + ((nck - 1) & 1) * kStage, ps, nck - 1, T_, d, n,
                h);
  }

  for (int c = nck - 1; c >= 0; --c) {
    const int t0 = c * kK;
    const float* stg = stage0 + (c & 1) * kStage;
    const float* sDt = stg + kStageDt;
    const float* sX = stg + kStageX;
    const float* sDy = stg + kStageDy;
    const float* sB = stg + kStageB + ps.p * kK * kNP + kS * ps.q;
    const float* sC = stg + kStageC + ps.p * kK * kNP + kS * ps.q;
    __syncthreads();   // chunk c staged; the previous chunk's sums read
    // the next chunk's loads (chunk 0: itself again), stored after the
    // reverse pass
    Staged<TX, TB> s;
    stage_load<Off>(s, x, dt, dy, Bm, Cm, ckpt, sb_b, sb_t, sc_b, sc_t, ps,
                    c > 0 ? c - 1 : 0, T_, d, n);

    // recompute: the state before each step into shared memory, each
    // exponential into e, as the forward computes them
    float e[kK][kS];
#pragma unroll
    for (int u = 0; u < kK; ++u) {
      const float dtv = sDt[u * kCh + cl];
      const float dtx = dtv * sX[u * kCh + cl];
      float bb[kS];
      ld4(sB + u * kNP, bb);
      *reinterpret_cast<float4*>(sH + ((size_t)u * kThreads + ps.tid) * 4) =
          make_float4(h[0], h[1], h[2], h[3]);
#pragma unroll
      for (int k = 0; k < kS; ++k) {
        e[u][k] = hopper::ex2_approx(dtv * A2[k]);
        h[k] = fmaf(e[u][k], h[k], dtx * bb[k]);
      }
    }

    // the chunk's steps in reverse; h_t starts as the chunk's last state
#pragma unroll
    for (int u = kK - 1; u >= 0; --u) {
      const float dtv = sDt[u * kCh + cl];
      const float xv = sX[u * kCh + cl];
      const float dyv = sDy[u * kCh + cl];
      const float dtx = dtv * xv;
      float bb[kS], cc[kS], hp[kS];
      ld4(sB + u * kNP, bb);
      ld4(sC + u * kNP, cc);
      ld4(sH + ((size_t)u * kThreads + ps.tid) * 4, hp);
      float vB[kS], vC[kS];
      float gb = 0.f, gea = 0.f;
#pragma unroll
      for (int k = 0; k < kS; ++k) {
        g[k] = fmaf(dyv, cc[k], g[k]);
        vC[k] = dyv * h[k];                    // dC: dy_t h_t
        vB[k] = g[k] * dtx;                    // dB: g dt_t x_t
        const float ge = g[k] * e[u][k];
        const float ghe = ge * hp[k];
        dA[k] = fmaf(ghe, dtv, dA[k]);
        gea = fmaf(ghe, A2[k], gea);
        gb = fmaf(g[k], bb[k], gb);
        g[k] = ge;
        h[k] = hp[k];
      }
      dD = fmaf(dyv, xv, dD);
      // the channel's 16 states: its 4 lanes
      gb += __shfl_xor_sync(0xffffffffu, gb, 1);
      gea += __shfl_xor_sync(0xffffffffu, gea, 1);
      gb += __shfl_xor_sync(0xffffffffu, gb, 2);
      gea += __shfl_xor_sync(0xffffffffu, gea, 2);
      if (ps.q < 2)
        myOut[u * kCh] = ps.q ? fmaf(gea, kLn2, gb * xv)
                              : fmaf(gb, dtv, Dch * dyv);
      // the warp's 8 channels: keep slots 0-1, add the partner's 2-3
      // (lane bit 4); keep 0, add 1 (bit 3); all-reduce (bit 2)
      const float b0 = vB[0] + __shfl_xor_sync(0xffffffffu, vB[2], 16);
      const float b1 = vB[1] + __shfl_xor_sync(0xffffffffu, vB[3], 16);
      const float c0 = vC[0] + __shfl_xor_sync(0xffffffffu, vC[2], 16);
      const float c1 = vC[1] + __shfl_xor_sync(0xffffffffu, vC[3], 16);
      float sb = b0 + __shfl_xor_sync(0xffffffffu, b1, 8);
      float sc = c0 + __shfl_xor_sync(0xffffffffu, c1, 8);
      sb += __shfl_xor_sync(0xffffffffu, sb, 4);
      sc += __shfl_xor_sync(0xffffffffu, sc, 4);
      myRed[u * kWarps * kV] = b2 ? sc : sb;
    }
    if (c > 0)
      stage_store(s, stage0 + ((c - 1) & 1) * kStage, ps, c - 1, T_, d, n,
                  h);
    __syncthreads();   // every warp's sums and outputs of the chunk

    // the block's sums: thread (u, j) adds the 16 warps' in order
    if (ps.tid < kK * kV) {
      const int u = ps.tid / kV, j = ps.tid % kV, t = t0 + u;
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) sum += sRed[(u * kWarps + w) * kV + j];
      if (t < T_)
        part_bc[(((size_t)ps.b * gridDim.x + blockIdx.x) * T_ + t) * kV + j] =
            sum;
    }
    // dx and ddt of the chunk, a row of 128 channels a step
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int u = ps.tid / kCh + kRows * k, cc = ps.tid % kCh;
      const int t = t0 + u, chan = ps.c0 + cc;
      if (t < T_ && chan < d) {
        const size_t at =
            (size_t)ps.b * T_ * d + (Off)t * (Off)d + (Off)chan;
        dx[at] = from_f32<TX>(sOut[u * kCh + cc]);
        ddt[at] = sOut[(kK + u) * kCh + cc];
      }
    }
  }
  // the last values: indices read afresh (nothing kept across the loop
  // for them)
  const int tid = thread_index(), q = tid & 3, p = (tid >> 3) & 3;
  const int chn = block_index_x() * kCh + (tid >> 2);
  if (chn < d) {
    const size_t at = (size_t)block_index_y() * d + chn;
    float* pa = part_ad + at * (n + 1);
#pragma unroll
    for (int k = 0; k < kS; ++k) {
      const int i = kS * q + (k ^ p);
      if (i < n) {
        dh0[at * n + i] = g[k];
        pa[i] = dA[k];
      }
    }
    if (q == 0) pa[n] = dD;
  }
}

// dBm, dC (B, T, n) contiguous: the blocks' partial sums, in block order.
template <typename TB>
__global__ void selective_scan_bwd_reduce_bc(const float* __restrict__ part_bc,
                                 TB* __restrict__ dBm, TB* __restrict__ dC,
                                 int B, int T_, int n, int nblk) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)B * T_ * kV) return;
  const int j = idx % kV;
  const size_t bt = idx / kV;                     // b * T + t
  const int b = bt / T_, t = bt % T_;
  const int i = j % kNP;
  if (i >= n) return;
  float s = 0.f;
  for (int k = 0; k < nblk; ++k)
    s += part_bc[(((size_t)b * nblk + k) * T_ + t) * kV + j];
  (j < kNP ? dBm : dC)[bt * n + i] = from_f32<TB>(s);
}

// dA (d, n) and dD (d): the batch rows' partial sums, in row order.
__global__ void selective_scan_bwd_reduce_ad(const float* __restrict__ part_ad,
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

struct Args {
  const void *x, *dt, *A, *Bm, *C, *D, *ckpt, *dy, *dh_last;
  void *dx, *ddt, *dA, *dBm, *dC, *dD, *dh0;
  float *part_bc, *part_ad;
  int B, T, d, n;
  long long sb_b, sb_t, sc_b, sc_t;   // element strides of Bm and C
};

template <typename TX, typename TB, typename Off>
int launch(const Args& a, cudaStream_t stream) {
  auto kernel = selective_scan_bwd_kernel<TX, TB, Off>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const int nblk = (a.d + kCh - 1) / kCh;
  kernel<<<dim3(nblk, a.B), kThreads, kSmemBytes, stream>>>(
      static_cast<const TX*>(a.x), static_cast<const float*>(a.dt),
      static_cast<const float*>(a.A), static_cast<const TB*>(a.Bm),
      static_cast<const TB*>(a.C), static_cast<const float*>(a.D),
      static_cast<const float*>(a.ckpt), static_cast<const TX*>(a.dy),
      static_cast<const float*>(a.dh_last), static_cast<TX*>(a.dx),
      static_cast<float*>(a.ddt), static_cast<float*>(a.dh0), a.part_bc,
      a.part_ad, a.T, a.d, a.n, a.sb_b, a.sb_t, a.sc_b, a.sc_t);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  constexpr int kR = 256;
  const size_t nbc = (size_t)a.B * a.T * kV;
  selective_scan_bwd_reduce_bc<TB><<<(unsigned)((nbc + kR - 1) / kR), kR, 0, stream>>>(
      a.part_bc, static_cast<TB*>(a.dBm), static_cast<TB*>(a.dC), a.B, a.T,
      a.n, nblk);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const size_t nad = (size_t)a.d * (a.n + 1);
  selective_scan_bwd_reduce_ad<<<(unsigned)((nad + kR - 1) / kR), kR, 0, stream>>>(
      a.part_ad, static_cast<float*>(a.dA), static_cast<float*>(a.dD), a.B,
      a.d, a.n);
  return (int)cudaGetLastError();
}

template <typename TX, typename TB>
int launch_off(const Args& a, cudaStream_t stream) {
  if ((long long)a.T * a.d < (1ll << 31))
    return launch<TX, TB, uint32_t>(a, stream);
  return launch<TX, TB, uint64_t>(a, stream);
}

template <typename TX>
int launch_bc(int bc_dtype, const Args& a, cudaStream_t stream) {
  if (bc_dtype == 0) return launch_off<TX, float>(a, stream);
  if (bc_dtype == 1) return launch_off<TX, __nv_bfloat16>(a, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// The forward's inputs as selective_scan takes them, its checkpoints ckpt
// (B, ceil(T / ck), d, n) float32 from selective_scan_ckpt with ck = 8, dy
// (B, T, d) in x's dtype and dh_last (B, d, n) float32, contiguous.
// Writes dx (x's dtype), ddt (B, T, d), dA (d, n), dD (d), dh0 (B, d, n)
// float32 and dBm, dC (B, T, n) contiguous in bc_dtype; part_bc
// (B, ceil(d / 128), T, 32) and part_ad (B, d, n + 1) float32 are scratch.
// Launches on `stream`, does not synchronise, and returns the cudaError_t
// of the launches (0 on success).
int selective_scan_bwd(const void* x, const void* dt, const void* A,
                       const void* Bm, const void* C, const void* D,
                       const void* ckpt, const void* dy, const void* dh_last,
                       void* dx, void* ddt, void* dA, void* dBm, void* dC,
                       void* dD, void* dh0, void* part_bc, void* part_ad,
                       int x_dtype, int bc_dtype, int B, int T, int d, int n,
                       int ck, long long sb_b, long long sb_t, long long sc_b,
                       long long sc_t, void* stream) {
  if (B <= 0 || B > 65535 || d <= 0 || T < 1 || n < 1 || n > kNP || ck != kK)
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

// Dynamic shared memory per block of the backward kernel, in bytes.
int selective_scan_bwd_smem_bytes() { return (int)kSmemBytes; }

const char* selective_scan_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
