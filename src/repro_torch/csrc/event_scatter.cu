// The event form's update half, event driven:
//   out[b, (delay[r] + t) mod d_slots, tgt[r]] += x[b, s] * w[r]
// for every source s with x[b, s] != 0 and every row r of s, the rows of s
// being row_ptr[s] .. row_ptr[s + 1] of the source-major arrays w (R,) f32,
// delay (R,) int32 in [1, d_slots) and tgt (R,) int32.  x (B, S) f32 is
// read through its two strides (in elements), so an input edge's column
// slice of the step's train goes in without a copy.  out (B, d_slots, T)
// f32, contiguous and zeroed by the caller.
//
// Replaces no Pallas kernel: the reference's event form is XLA's
// segment_sum over every row (repro/core/runtime/serial_runtime.py), and
// the port swept every row the same way (a gather, a product and an
// index_add_ over all B x R pairs).  This is how the paper's ARM core
// walks a spike: the master population table gives the source's row
// block, and only that block is read.
//
// Bound on the H100: device-memory bytes, 12 a synaptic event (a weight,
// a delay and a target index read, the current's atomic add kept in L2),
// against 3.35 TB/s; the few spikes of the step are read once.  At the
// microcircuit's rates a step is ~1.5 % of the sources firing, so what
// costs is finding the fired ones and keeping enough rows in flight.
//
// Design: one grid over all (chunk of kChunk sources, lane b), fixed for
// a shape, so no host read and no compaction sized on the host: a CUDA
// graph records it as it is.  The block's first kChunk threads read the
// chunk's spikes (coalesced along s when the source stride is 1), a
// ballot a warp compacts the fired sources into shared memory, in order,
// and a block with none leaves.  Then all kThreads threads walk each fired
// source's rows in turn: coalesced loads of weight, delay and target,
// kUnroll rows a thread in flight before their adds, and a float
// atomicAdd a row (a fire-and-forget reduction: its result is not read).
// With integer weights below 2^7 in magnitude and every current an
// integer below 2^24, each partial sum is exact, so the atomics' order
// changes no bit and the result equals the plain version's sweep.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 64;          // sources a block; a multiple of 32
constexpr int kUnroll = 4;          // rows a thread loads before adding
constexpr int kChunkWarps = kChunk / 32;

__global__ void __launch_bounds__(kThreads)
event_scatter_kernel(const float* __restrict__ w,
                     const int32_t* __restrict__ delay,
                     const int32_t* __restrict__ tgt,
                     const int32_t* __restrict__ row_ptr,
                     const float* __restrict__ x, float* __restrict__ out,
                     int64_t S, int64_t sx_b, int64_t sx_s, int t_mod,
                     int d_slots, int64_t T) {
  __shared__ int32_t fired[kChunk];
  __shared__ float spike[kChunk];
  __shared__ int warp_fired[kChunkWarps];
  const int64_t b = blockIdx.y;
  const int64_t s0 = (int64_t)blockIdx.x * kChunk;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float xv = 0.f;
  unsigned mask = 0;
  if (warp < kChunkWarps) {
    const int64_t s = s0 + threadIdx.x;
    if (s < S) xv = __ldg(x + b * sx_b + s * sx_s);
    mask = __ballot_sync(0xffffffffu, xv != 0.f);
    if (lane == 0) warp_fired[warp] = __popc(mask);
  }
  __syncthreads();
  int n = 0, before = 0;
#pragma unroll
  for (int k = 0; k < kChunkWarps; ++k) {
    if (k < warp) before += warp_fired[k];
    n += warp_fired[k];
  }
  if (n == 0) return;               // the whole block leaves together
  if (warp < kChunkWarps && xv != 0.f) {
    const int at = before + __popc(mask & ((1u << lane) - 1u));
    fired[at] = threadIdx.x;
    spike[at] = xv;
  }
  __syncthreads();
  float* ob = out + b * (int64_t)d_slots * T;
  for (int f = 0; f < n; ++f) {
    const int64_t src = s0 + fired[f];
    const float v = spike[f];
    const int64_t r1 = __ldg(row_ptr + src + 1);
    for (int64_t r = __ldg(row_ptr + src) + threadIdx.x; r < r1;
         r += kUnroll * kThreads) {
      float wv[kUnroll];
      int dv[kUnroll], tv[kUnroll];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        const int64_t rr = r + k * kThreads;
        if (rr < r1) {
          wv[k] = __ldg(w + rr);
          dv[k] = __ldg(delay + rr);
          tv[k] = __ldg(tgt + rr);
        }
      }
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        if (r + k * kThreads < r1) {
          int slot = dv[k] + t_mod;
          if (slot >= d_slots) slot -= d_slots;
          atomicAdd(ob + (int64_t)slot * T + tv[k], v * wv[k]);
        }
      }
    }
  }
}

}  // namespace

extern "C" int event_scatter_f32(const float* w, const int32_t* delay,
                                 const int32_t* tgt, const int32_t* row_ptr,
                                 const float* x, float* out, int64_t S,
                                 int64_t B, int64_t sx_b, int64_t sx_s,
                                 int64_t t, int64_t d_slots, int64_t T,
                                 void* stream) {
  if (S == 0 || B == 0) return 0;
  const int64_t chunks = (S + kChunk - 1) / kChunk;
  if (chunks > 0x7fffffff || B > 65535 || d_slots < 1 || d_slots > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  const int t_mod = (int)(((t % d_slots) + d_slots) % d_slots);
  event_scatter_kernel<<<dim3((unsigned int)chunks, (unsigned int)B), kThreads,
                         0, (cudaStream_t)stream>>>(
      w, delay, tgt, row_ptr, x, out, S, sx_b, sx_s, t_mod, (int)d_slots, T);
  return (int)cudaGetLastError();
}
