// K2: int8 weight-delay-map x int8 stacked spikes -> int32, no saturation;
// and the parallel projection's whole current, with the stacked spikes
// gathered from the spike-history ring inside the kernel.
//
//   out[n, m] = sum_k wdm[m, k] * stacked[n, k]
//
// wdm (M, K) int8 row-major: M = target neurons, K = WDM columns.
// stacked (N, K) int8 row-major: N = request batch, one row per lane
// (batch-major).  out (N, M) int32 row-major: the batch-major current the
// executor sums.  This is the reference's (M, K) @ (K, N) product,
// transposed on both sides so that no transpose is ever materialised.
//
// The projection (spike_wdm_project_s8) reads stacked row n straight from
// the (N, d, S) int8 ring through the input merging table:
//
//   stacked[n, c] = ring[n, floor_mod(t - col_delay[c], d), col_source[c]]
//
// and writes f32 (__int2float_rn: exact, every |sum| < 2^24 here, and the
// rounding of .to(torch.float32) anyway).  C's % truncates toward zero, so
// the slot adds d back when t - delay is negative.
//
// Replaces the TPU kernel src/repro/kernels/spike_wdm_matmul/kernel.py
// (spike_wdm_matmul_pallas / _matmul_kernel), an MXU product accumulated
// over a K grid axis in 128/512 tiles.
//
// Bound on the H100: at the gesture path's shape, (20, 965) x (965, 8),
// the operands are ~27 KB and the work 0.3 M int8 MACs, so one launch is
// latency; at larger shapes the int8 operand bytes bound it long before
// the int8 tensor cores would.  Around the standalone kernel the parallel
// projection used to spend about ten eager ops a step (slot arithmetic,
// an index_select copy of the stacked rows, the cast); the projection
// entry makes that one launch.
//
// Design: a warp per (row m of wdm, lane n), 8 warps a block; the block
// shares lane n's stacked row.  The lane is the grid's y index; the y
// axis holds at most 65,535 blocks, so above that batch a second variant
// of the kernel has each block walk the lanes blockIdx.y, blockIdx.y +
// gridDim.y, ...  (Up to that batch the kernel keeps no loop, so the
// served shapes run the body as before.)  The operands are a few KB, so
// the time is the launch and the chains of dependent loads, and the design keeps those
// chains short.  A tile of 1 KB of K at a time:
//   1. each lane loads its 8 words of the warp's WDM row, all at once;
//      rows start at any byte for odd K, so each word is two aligned 4-byte
//      loads joined by a funnel shift, masked at the row's end;
//   2. meanwhile the block stages lane n's stacked row in shared memory,
//      4 columns a thread: the merging-table loads of all 4 first, then the
//      ring bytes they address (or, standalone, the row's bytes);
//   3. after one barrier each lane multiplies its words against the row's
//      aligned words with __dp4a (signed 8-bit dot products into a 32-bit
//      sum), then a shuffle reduction across the lanes.
// Bytes past the tile's end are zero on the WDM side, so the row's words
// need no padding.  Exact like the reference's int32 product: |sum| <=
// 2^14 * K stays in int32 for K < 2^17, and integer addition does not care
// about the order.  At M 20 and N <= 8 there is no tile for the int8
// tensor cores to fill.
#include <cstdint>
#include <cuda_runtime.h>

constexpr int kWarps = 8;                  // rows (warps) a block
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 1024;                // bytes of K a pass
constexpr int kWordsPerLane = kTile / 128;           // 4 bytes x 32 lanes
constexpr int kColsPerThread = kTile / kThreads;

// The 4 bytes at byte `at` of an array whose aligned words are `words` (the
// last one holding a byte of it at index `last`), as one little-endian word.
__device__ __forceinline__ int load4(const unsigned* words, int64_t at,
                                     int64_t last) {
  const int64_t w = at >> 2;
  const unsigned shift = 8u * (unsigned)(at & 3);
  const unsigned lo = words[w];
  const unsigned hi = shift != 0 && w < last ? words[w + 1] : 0u;
  return (int)__funnelshift_r(lo, hi, shift);
}

__device__ __forceinline__ void store(int32_t* out, int acc) { *out = acc; }
__device__ __forceinline__ void store(float* out, int acc) {
  *out = __int2float_rn(acc);
}

// kRing: x is the (N, depth, n_source) ring, read through the merging
// table; else x is the (N, K) stacked matrix.  One block's rows for lane n.
template <bool kRing, typename Out>
__device__ __forceinline__ void wdm_lane(
    const int8_t* __restrict__ wdm, const int8_t* __restrict__ x,
    const int32_t* __restrict__ col_source,
    const int32_t* __restrict__ col_delay, Out* __restrict__ out, int M, int K,
    int depth, int n_source, int64_t t, int64_t n) {
  __shared__ __align__(16) int8_t row[kTile];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int m = blockIdx.x * kWarps + warp;
  const int mis = (int)((uintptr_t)wdm & 3);           // wdm's first byte
  const unsigned* words = reinterpret_cast<const unsigned*>(wdm - mis);
  const int64_t last = (mis + (int64_t)M * K - 1) >> 2;
  const int8_t* xn = x + n * (kRing ? (int64_t)depth * n_source : K);
  int acc = 0;
  for (int k0 = 0; k0 < K; k0 += kTile) {
    const int len = min(kTile, K - k0);
    int a[kWordsPerLane];
#pragma unroll
    for (int j = 0; j < kWordsPerLane; ++j) {
      const int k = 4 * lane + 128 * j, left = len - k;
      a[j] = 0;
      if (m < M && left > 0) {
        a[j] = load4(words, mis + (int64_t)m * K + k0 + k, last);
        if (left < 4) a[j] &= (1 << (8 * left)) - 1;   // the next row's bytes
      }
    }
    int src[kColsPerThread];
    int64_t slot[kColsPerThread];
#pragma unroll
    for (int u = 0; u < kColsPerThread; ++u) {
      const int c = threadIdx.x + kThreads * u;
      if (kRing && c < len) {
        src[u] = col_source[k0 + c];
        slot[u] = (t - col_delay[k0 + c]) % depth;     // C's % truncates:
        if (slot[u] < 0) slot[u] += depth;              // make it a floor-mod
      }
    }
#pragma unroll
    for (int u = 0; u < kColsPerThread; ++u) {
      const int c = threadIdx.x + kThreads * u;
      if (c < len)
        row[c] = kRing ? xn[slot[u] * n_source + src[u]] : xn[k0 + c];
    }
    __syncthreads();
    const int* x4 = reinterpret_cast<const int*>(row);
#pragma unroll
    for (int j = 0; j < kWordsPerLane; ++j)
      acc = __dp4a(a[j], x4[lane + 32 * j], acc);
    __syncthreads();                        // the row is refilled next tile
  }
  if (m >= M) return;                       // the whole warp leaves together
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  if (lane == 0) store(out + n * M + m, acc);
}

// The grid's y axis is the lane n up to 65,535 lanes (kLoop false); above
// that each block walks the lanes blockIdx.y, blockIdx.y + gridDim.y, ...
// The loop is uniform in a block, so every thread reaches every barrier.
template <bool kRing, bool kLoop, typename Out>
__global__ void __launch_bounds__(kThreads)
wdm_kernel(const int8_t* __restrict__ wdm, const int8_t* __restrict__ x,
           const int32_t* __restrict__ col_source,
           const int32_t* __restrict__ col_delay, Out* __restrict__ out,
           int M, int K, int N, int depth, int n_source, int64_t t) {
  if (!kLoop) {
    wdm_lane<kRing, Out>(wdm, x, col_source, col_delay, out, M, K, depth,
                         n_source, t, (int)blockIdx.y);
    return;
  }
  for (int64_t n = blockIdx.y; n < N; n += gridDim.y)
    wdm_lane<kRing, Out>(wdm, x, col_source, col_delay, out, M, K, depth,
                         n_source, t, n);
}

constexpr int kMaxGridY = 65535;

static dim3 grid_of(int M, int N) {
  return dim3((M + kWarps - 1) / kWarps, N < kMaxGridY ? N : kMaxGridY);
}

template <bool kRing, typename Out>
static void launch_wdm(const int8_t* wdm, const int8_t* x,
                       const int32_t* col_source, const int32_t* col_delay,
                       Out* out, int M, int K, int N, int depth, int n_source,
                       int64_t t, cudaStream_t s) {
  if (N <= kMaxGridY)
    wdm_kernel<kRing, false, Out><<<grid_of(M, N), kThreads, 0, s>>>(
        wdm, x, col_source, col_delay, out, M, K, N, depth, n_source, t);
  else
    wdm_kernel<kRing, true, Out><<<grid_of(M, N), kThreads, 0, s>>>(
        wdm, x, col_source, col_delay, out, M, K, N, depth, n_source, t);
}

extern "C" int spike_wdm_matmul_s8(const int8_t* wdm, const int8_t* stacked,
                                   int32_t* out, int M, int K, int N,
                                   void* stream) {
  launch_wdm<false, int32_t>(wdm, stacked, nullptr, nullptr, out, M, K, N, 1, K,
                             0, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

extern "C" int spike_wdm_project_s8(const int8_t* wdm, const int8_t* ring,
                                    const int32_t* col_source,
                                    const int32_t* col_delay, float* out,
                                    int M, int K, int N, int depth,
                                    int n_source, int64_t t, void* stream) {
  launch_wdm<true, float>(wdm, ring, col_source, col_delay, out, M, K, N, depth,
                          n_source, t, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}
