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
//   sequence lengths: the ragged q and kv tails are masked here.  Segment
//   ids are not taken (the wrapper raises on them, as the Pallas kernel
//   does).
//
// What bounds it on an H100.  At the serve prefill shape of gemma2-2b
// (B=4, S=1024, H=8, KH=4, D=256, causal) the function needs about
// 17 GFLOP (4*D flops per unmasked (q, k) pair and head) and moves about
// 50 MB (q, k, v read once, o written once): about 17 us at the data-sheet
// bf16 tensor-core peak (989 TFLOP/s) and 15 us at 3.35 TB/s.  So the
// function is bound by operations, and only the tensor cores can come near
// that bound.
//
// What the design does about it.  Both kernels keep every intermediate out
// of device memory, as the Pallas kernel does: a block owns the G*BQ = 64
// folded rows of the G q heads that share one kv head (so the group reads
// each k and v tile once), keeps them for the whole kv loop, streams k and
// v tiles through shared memory, keeps the running max and sum and the
// 64 x D output accumulator in registers, and visits only the kv tiles that
// the causal and window masks leave live.
//  * bf16 (the serving path): the two products run on the tensor cores with
//    warp-level mma.sync (m16n8k16, f32 accumulate); 4 warps own 16 rows
//    each.  q.k^T multiplies the bf16 inputs exactly.  For p.v the f32
//    probabilities are split into a bf16 high part and a bf16 remainder and
//    both are multiplied, so p keeps about 16 bits as the f32 reference's
//    does.  Tiles arrive by cp.async (zero-filled past the ragged end), the
//    v operand by ldmatrix.trans; shared-memory rows are padded by 16 bytes,
//    so fragment reads are free of bank conflicts.  About 100 KB of shared
//    memory lets two blocks share an SM, so one block's loads overlap the
//    other's products.
//  * f32: CUDA-core FMAs in f32, exact against the f32 reference.  Reads go
//    16 bytes at a time from device and shared memory.
// Not done yet: wgmma, TMA, warp specialisation and double buffering, which
// a kernel needs to come near the bound.
//
// Build (plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libflash_attention_fwd.so flash_attention_fwd.cu

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kRows = 64;          // folded q rows per block (G * BQ <= 64)
constexpr float kNegInf = -1e30f;

struct Params {
  int B, Sq, Sk, H, KH, G, BQ;
  int causal, window, q_offset;
  float softcap, scale;
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

// Scaled, softcapped score, or kNegInf where the masks hide (qpos, kp).
__device__ __forceinline__ float masked_score(const Params& p, float dot,
                                              bool q_valid, int qpos,
                                              int kp) {
  bool ok = q_valid && kp < p.Sk;
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

// ===================================================== bf16: tensor cores

namespace tc {

constexpr int kThreads = 128;      // 4 warps x 16 rows
constexpr int kBK = 64;            // kv positions per tile

template <int D>
constexpr size_t smem_bytes() {    // q, k, v tiles, rows padded by 8 bf16
  return sizeof(__nv_bfloat16) * size_t(kRows + 2 * kBK) * (D + 8);
}

__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
}

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* ptr) {
  return *reinterpret_cast<const uint32_t*>(ptr);
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// c (16x8 f32) += a (16x16 bf16, row) . b (16x8 bf16, col)
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The B operand (16 keys x 8 dims) of p.v from row-major v in shared memory.
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t& b0, uint32_t& b1,
                                                  const __nv_bfloat16* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(b0), "=r"(b1)
      : "r"(smem_addr(row)));
}

// Fragment layout of mma.m16n8k16 (PTX ISA): with g = lane / 4 and
// t = lane % 4, a thread holds rows g and g + 8 of the 16 x 8 result at
// columns 2t and 2t + 1 (c[0], c[1] for row g; c[2], c[3] for row g + 8).
template <int D>
__global__ void __launch_bounds__(kThreads, 2)
flash_attention_fwd_tc(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       __nv_bfloat16* __restrict__ o, Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
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

  int row[2], qpos[2];
  bool valid[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    row[h] = warp * 16 + g + 8 * h;
    qpos[h] = p.q_offset + q0 + row[h] % p.BQ;
    valid[h] = row[h] < rows && q0 + row[h] % p.BQ < p.Sq;
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
        mma(s[n], a, ld_u32(kb), ld_u32(kb + 8));
      }
    }

    // online softmax over the tile (each row's 4 lanes hold 16 keys each)
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e / 2, kp = k0 + n * 8 + 2 * t + (e % 2);
        s[n][e] = masked_score(p, s[n][e], valid[h], qpos[h], kp);
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
        hi[i] = pack(pv[2 * i], pv[2 * i + 1]);
        const float2 hf = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&hi[i]));
        lo[i] = pack(pv[2 * i] - hf.x, pv[2 * i + 1] - hf.y);
      }
      const __nv_bfloat16* vrow = sV + (kk * 16 + lane % 16) * RS;
#pragma unroll
      for (int j = 0; j < DT; ++j) {
        uint32_t b0, b1;
        ldmatrix_x2_trans(b0, b1, vrow + j * 8);
        mma(acc[j], hi, b0, b1);
        mma(acc[j], lo, b0, b1);
      }
    }
  }
  cp_async_wait_all();  // the q copies, when no kv tile was live

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    if (!valid[h]) continue;
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
// warp reads at once fall in distinct banks.
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_fwd_cc(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o,
                       Params p) {
  extern __shared__ __align__(16) float smem[];
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
      s[i] = masked_score(p, s[i], q_valid, qpos,
                          k0 + lane + kLanesPerRow * i);
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

template <typename T, typename Kernel>
int launch(Kernel kernel, int threads, size_t smem, const void* q,
           const void* k, const void* v, void* o, const Params& p,
           cudaStream_t stream) {
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
  if (dtype == 1)
    return launch<__nv_bfloat16>(tc::flash_attention_fwd_tc<D>, tc::kThreads,
                                 tc::smem_bytes<D>(), q, k, v, o, p, stream);
  if (dtype == 0)
    return launch<float>(cc::flash_attention_fwd_cc<D>, cc::kThreads,
                         cc::smem_bytes<D>(), q, k, v, o, p, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// q (B, Sq, H, D), k and v (B, Sk, KH, D), o (B, Sq, H, D), all contiguous,
// 16-byte aligned and of one dtype (0: float32, 1: bfloat16).  Launches on
// `stream`, does not synchronise, and returns the cudaError_t of the launch
// (0 on success).
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        int dtype, int B, int Sq, int Sk, int H, int KH, int D,
                        int causal, int window, float softcap, float scale,
                        int q_offset, void* stream) {
  if (B <= 0 || Sq <= 0 || KH <= 0 || H % KH != 0 || H / KH > kRows)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.B = B; p.Sq = Sq; p.Sk = Sk; p.H = H; p.KH = KH; p.G = H / KH;
  p.BQ = kRows / p.G;
  p.causal = causal; p.window = window; p.q_offset = q_offset;
  p.softcap = softcap; p.scale = scale;
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

const char* flash_attention_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
