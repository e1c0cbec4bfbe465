// K3: ELL gather-accumulate, out[r, b] = sum_l val[r, l] * x[idx[r, l], b].
//
// val (R, L) f32 and idx (R, L) int32, contiguous: one ELL row per (delay
// slot, target) pair, padding lanes weight 0 / index 0 (safe to read).
// x (S, B) f32 read through its two strides (in elements), so the fused
// step can hand its (B, S) spikes as the transposed view without a copy.
// out (R, B) f32, contiguous.
//
// Replaces the TPU kernel src/repro/kernels/sparse_gather/kernel.py
// (sparse_gather_pallas / _gather_kernel), which keeps x resident in VMEM
// and streams row blocks of the ELL operands.
//
// Bound on the H100: latency at the served shapes, device-memory bytes
// at scale.  The ELL operands are read once (8 bytes a lane) and each lane
// gathers a B-wide spike row; the flops are two a gathered element.  x is
// small next to the operands (2048 x 8 f32 on the gesture path) and stays
// in L2, so it is not staged: an 80k-neuron source would not fit in a
// block's shared memory anyway.  At the gesture shape (R 40, L 78, B 8)
// the whole call is 25k multiply-adds, so what costs is the chain of
// dependent loads (an index, then the spike it points at) each thread
// waits on; the design cuts that chain short.
//
// Design, by the number of columns B:
//  * B <= 32 (a served micro-batch): W lanes of a warp share one ELL row,
//    W the power of two >= L capped at 32 (so 32 / W rows a warp when L is
//    short).  Lane k reads lanes k, k + W, ... of its row once, each with
//    one index and one weight load, and accumulates the row's B columns in
//    registers (B rounded up to a power of two at compile time); a
//    __shfl_xor butterfly over the W lanes finishes the sums.  At L 78
//    that is 3 rounds of loads a lane instead of 78 in series.
//  * B > 32 (the temporal path's T.B columns): a block takes one ELL row
//    and up to 64 columns.  It stages the row's indices and weights in
//    shared memory, kLaneChunk lanes at a time, and puts threads over b, so
//    the reads of a spike row are coalesced when x is source-major.  (The
//    temporal path hands over a strided view instead, one sector a column:
//    slower per gather, but faster than copying x source-major first.)
//    One row a block (400 blocks at R 40, B 600) measured faster on the
//    card than two or four rows (fewer blocks, longer chains of loads).
// With integer weights and 0/1 spikes every f32 partial sum is an exact
// integer below 2^24, so the order of the sums is free and the result is
// bit-equal to the plain version; fmaf is exact here too.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLaneThreads = 128;   // B <= 32: 4 warps a block
constexpr int kLaneChunk = 64;      // B > 32: lanes staged at a time
constexpr int kMaxCols = 64;        // B > 32: columns a block

template <int kB>
__global__ void __launch_bounds__(kLaneThreads)
gather_lanes_kernel(const float* __restrict__ val,
                    const int32_t* __restrict__ idx,
                    const float* __restrict__ x, float* __restrict__ out,
                    int64_t R, int64_t L, int B, int64_t sx_s, int64_t sx_b,
                    int width_log2) {
  const int width = 1 << width_log2;
  const int sub = threadIdx.x & (width - 1);
  const int64_t row =
      ((int64_t)blockIdx.x * kLaneThreads + threadIdx.x) >> width_log2;
  const bool live = row < R;
  float acc[kB];
#pragma unroll
  for (int b = 0; b < kB; ++b) acc[b] = 0.f;
  if (live) {
    const float* vr = val + row * L;
    const int32_t* ir = idx + row * L;
#pragma unroll 2
    for (int64_t l = sub; l < L; l += width) {
      const float v = __ldg(vr + l);
      const float* xr = x + (int64_t)__ldg(ir + l) * sx_s;
#pragma unroll
      for (int b = 0; b < kB; ++b)
        if (b < B) acc[b] = fmaf(v, __ldg(xr + b * sx_b), acc[b]);
    }
  }
  // every lane of the warp takes part in the butterfly (groups of width
  // lanes are aligned, so xor offsets below width stay inside the group)
  for (int off = width >> 1; off > 0; off >>= 1) {
#pragma unroll
    for (int b = 0; b < kB; ++b)
      acc[b] += __shfl_xor_sync(0xffffffffu, acc[b], off);
  }
  if (live) {
#pragma unroll
    for (int b = 0; b < kB; ++b)
      if (b < B && (b & (width - 1)) == sub) out[row * B + b] = acc[b];
  }
}

__global__ void __launch_bounds__(kMaxCols)
gather_cols_kernel(const float* __restrict__ val,
                   const int32_t* __restrict__ idx,
                   const float* __restrict__ x, float* __restrict__ out,
                   int64_t L, int64_t B, int64_t sx_s, int64_t sx_b) {
  __shared__ float sv[kLaneChunk];
  __shared__ int32_t si[kLaneChunk];
  const int64_t row = blockIdx.x;
  const int64_t b = (int64_t)blockIdx.y * blockDim.x + threadIdx.x;
  const float* xb = x + (b < B ? b : 0) * sx_b;
  float acc = 0.f;
  for (int64_t l0 = 0; l0 < L; l0 += kLaneChunk) {
    const int n = (int)(L - l0 < kLaneChunk ? L - l0 : kLaneChunk);
    for (int ll = threadIdx.x; ll < n; ll += blockDim.x) {
      sv[ll] = val[row * L + l0 + ll];
      si[ll] = idx[row * L + l0 + ll];
    }
    __syncthreads();
#pragma unroll 8
    for (int ll = 0; ll < n; ++ll)
      acc = fmaf(sv[ll], __ldg(xb + (int64_t)si[ll] * sx_s), acc);
    __syncthreads();
  }
  if (b < B) out[row * B + b] = acc;
}

template <int kB>
cudaError_t launch_lanes(const float* val, const int32_t* idx, const float* x,
                         float* out, int64_t R, int64_t L, int B, int64_t sx_s,
                         int64_t sx_b, cudaStream_t stream) {
  int width_log2 = 0;
  while ((1 << width_log2) < L && width_log2 < 5) ++width_log2;
  const int64_t threads = R << width_log2;
  const int64_t blocks = (threads + kLaneThreads - 1) / kLaneThreads;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  gather_lanes_kernel<kB><<<(unsigned int)blocks, kLaneThreads, 0, stream>>>(
      val, idx, x, out, R, L, B, sx_s, sx_b, width_log2);
  return cudaGetLastError();
}

}  // namespace

extern "C" int sparse_gather_f32(const float* val, const int32_t* idx,
                                 const float* x, float* out, int64_t R,
                                 int64_t L, int64_t B, int64_t sx_s,
                                 int64_t sx_b, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (B <= 32) {
    const int b = (int)B;
    if (b <= 1) return (int)launch_lanes<1>(val, idx, x, out, R, L, b, sx_s, sx_b, st);
    if (b <= 2) return (int)launch_lanes<2>(val, idx, x, out, R, L, b, sx_s, sx_b, st);
    if (b <= 4) return (int)launch_lanes<4>(val, idx, x, out, R, L, b, sx_s, sx_b, st);
    if (b <= 8) return (int)launch_lanes<8>(val, idx, x, out, R, L, b, sx_s, sx_b, st);
    if (b <= 16) return (int)launch_lanes<16>(val, idx, x, out, R, L, b, sx_s, sx_b, st);
    return (int)launch_lanes<32>(val, idx, x, out, R, L, b, sx_s, sx_b, st);
  }
  const int threads = (int)(B < kMaxCols ? (B + 31) / 32 * 32 : kMaxCols);
  const int64_t col_blocks = (B + threads - 1) / threads;
  if (R > 0x7fffffff || col_blocks > 65535) return (int)cudaErrorInvalidValue;
  gather_cols_kernel<<<dim3((unsigned int)R, (unsigned int)col_blocks), threads, 0, st>>>(
      val, idx, x, out, L, B, sx_s, sx_b);
  return (int)cudaGetLastError();
}
