// RG-LRU linear recurrence h_t = a_t * h_{t-1} + x_t, for NVIDIA Hopper
// (sm_90a), x and a in float32 or bfloat16.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/rglru/pallas_kernel.py::linear_scan_pallas
//   (body _rglru_kernel), and computes the same function: per channel, the
//   state h (float32, from h0) runs over T in order; y[:, t] = h_t in x's
//   dtype; h_last = h_T in float32.  Unlike the Pallas kernel it takes any
//   channel count C (the Pallas kernel asserts C % 256 == 0): lanes past
//   the last channel store nothing, and the ragged tail of T is masked.
//
// What bounds it on an H100.  The recurrence is one FMA per element, so the
// function is bound by bytes: at the serve prefill shape of recurrentgemma-2b
// (B=4, T=1024, C=2560, x and a float32) it reads x and a and writes y,
// about 126 MB, 38 us at 3.35 TB/s, against 10.5 M FMAs (0.3 us at the f32
// peak); at the train microbatch (B=2) half that, 19 us.  Reaching the
// bound takes some 5 MB of loads in flight across the card (3.35 TB/s
// times a microsecond of latency).  A walk with one thread a channel holds
// too few: B * C = 5,120 to 10,240 threads are 1.2 to 2.4 warps an SM, and
// each waits a memory latency per batch of steps.
//
// The design: a chunked scan over T, each element read once and written
// once.  A block is kCh = 32 channels (a lane each, neighbouring channels on
// neighbouring addresses, so every load and store of a warp is one
// coalesced row segment) by kChunks warps; it walks T in segments of
// kChunks chunks of kL steps (fewer chunks when T is shorter than that),
// the first segment first, warp w taking chunk w of a segment.  In a
// segment:
//  1. each thread holds its chunk's x and a in registers (loaded
//     unconditionally at clamped indices; steps past T read a = 1 and
//     x = 0, which leave the state as it is), and from a carry of 0
//     computes the chunk's carry out L (the state after its last step) and
//     its product of a's P, so that the chunk turns a carry c into L + P c;
//  2. after a barrier each warp folds the earlier chunks' (L, P) of its
//     channel into the segment's carry, chunk 0 first, up to its own: its
//     carry in; it folds on to the last chunk for the next segment's
//     carry, the same operations in the same order in every warp, so all
//     hold the same value;
//  3. each thread reruns its chunk from its carry in with the sequential
//     FMAs and writes y.  The last segment's carry is h_last.
// The next segment's loads are issued before this segment's folds and
// stores, so every thread keeps 2 kL loads in flight while it computes.
// (L, P) go through shared memory, double-buffered by segment, one
// barrier a segment.  The grouping is fixed by the shapes (kChunks,
// kL), never by the grid: two calls are bitwise equal, and the backward's
// state pass (linear_scan_bwd.cu), which runs this code with float32
// outputs, gives the states whose rounding is y.  The fold regroups the
// products against a sequential walk: f32 states move by about 1e-6
// relative.
//
// Build (plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o liblinear_scan.so linear_scan.cu

#include "linear_scan_chunked.cuh"

namespace {

using namespace chunked;

template <typename T>
int launch(const void* x, const void* a, const void* h0, void* y,
           void* h_last, int B, int T_, int C, cudaStream_t stream) {
  const long long blocks = ((long long)B * C + kCh - 1) / kCh;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  linear_scan_kernel<T, T>
      <<<(unsigned)blocks, kCh * warps_for(T_), 0, stream>>>(
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
