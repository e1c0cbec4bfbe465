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
// The projection (spike_wdm_project_s8, spike_wdm_stream_s8) reads stacked
// row n straight from the (N, d, S) int8 ring through the input merging
// table:
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
// Bound on the H100: a call reads the map once, M K bytes, and does 2 M K
// int8 operations a lane, so up to batch ~295 the map's bytes bound it, not
// the int8 tensor cores.  Two designs, one entry each; the wrapper picks
// one by the map's bytes and the batch (ops.py, wdm_design):
//
// * The latency design (wdm_kernel<kRing, kLoop, Out>) for small maps: at
//   the gesture path's shape, (20, 965) x (965, 8), the operands are ~27 KB
//   and the work 0.3 M int8 MACs, so one launch is latency.  Around the
//   standalone kernel the parallel projection used to spend about ten eager
//   ops a step (slot arithmetic, an index_select copy of the stacked rows,
//   the cast); the projection entry makes that one launch.
// * The streamed design (streamed::wdm_kernel<kRing, kLanes>, the ring
//   path only) for maps of megabytes, larger together than the 50 MB L2:
//   the map is read once a call for every lane.
//
// The latency design: a warp per (row m of wdm, lane n), 8 warps a block;
// the block shares lane n's stacked row.  The lane is the grid's y index;
// the y axis holds at most 65,535 blocks, so above that batch a second
// variant of the kernel has each block walk the lanes blockIdx.y,
// blockIdx.y + gridDim.y, ...  (Up to that batch the kernel keeps no loop,
// so the served shapes run the body as before.)  The operands are a few
// KB, so the time is the launch and the chains of dependent loads, and the
// design keeps those chains short.  A tile of 1 KB of K at a time:
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
//
// The streamed design (B <= 8 lanes): a block owns a tile of up to 64 rows
// and a slice of K; the slices of one tile are the blocks of a thread-block
// cluster.  Rows, split, slice and lanes a row come from the wrapper
// (ops.py, stream_tiling), chosen so that a call puts two blocks on an SM.
// On an H100 a block's time is the chain of dependent loads between one of
// its warps' map reads and the next, so the design keeps the work between
// them short:
//   1. The block stages its slice's stacked spikes, every lane's, in shared
//      memory once a pass (the merging-table and ring loads amortised over
//      the tile's rows, not 8), while its warps' first map loads fly, and
//      then 15 copies of them, each a byte further on.
//   2. A segment of 4 to 32 lanes streams a row, four aligned 16-byte
//      chunks a lane in flight (__ldcs: evict-first, the map is read once a
//      step and must not push the event form's rows out of the L2).  A row
//      starts at any byte for odd K; the spikes of each chunk then start at
//      an aligned word of one copy, so a chunk is multiplied as it was
//      loaded: one shared load and four __dp4a a lane of the batch.  An
//      aligned chunk that holds a byte of the map never crosses a page, and
//      the bytes around the slice meet staged zeros.
//   3. A row's sums are reduced across its segment by shuffles into shared
//      memory; the cluster's blocks then add their partial sums through
//      distributed shared memory, each block writing a share of the tile's
//      (B, rows) currents: no atomics, no zero fill, every element written
//      once, the sums exact and so bitwise those of the latency design.
#include <cooperative_groups.h>
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

// ---------------------------------------------------------------------------
// The streamed design.
namespace streamed {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxRows = 64;      // rows a block (ops.py's too)
constexpr int kSpikeBytes = 2048; // columns x lanes staged at a time (ops.py's too)
constexpr int kUnroll = 4;        // 16-byte chunks a lane has in flight
constexpr int kShifts = 16;       // copies of the staged spikes, a byte apart

// Grid: (ceil(M / rows) * split) blocks in clusters of `split`; block
// blockIdx.x is slice blockIdx.x % split (columns [rank * width, + width))
// of tile blockIdx.x / split.  `slice` (a multiple of 16, at most
// kSpikeBytes / kLanes - 16) is how many of its columns the block stages at
// a time, and `lpr` (4, 8, 16 or 32) how many lanes stream a row.  kRing is
// always true (the standalone matmul keeps the latency design); it keeps
// K2's ring launches under the one name wdm_kernel<true in a trace.
//
// A row's slice starts `mis` bytes into its first aligned 16-byte chunk, so
// chunk q holds columns 16 q - mis ... 16 q - mis + 15.  Copy s of the
// staged spikes is the slice's spikes (16 zero columns before it, zeros
// after) s bytes on, so that the spikes of every chunk start at an aligned
// 16-byte word of copy (16 - mis) % 16: a lane multiplies each chunk as it
// was loaded, with one shared load a lane of the batch.
//
// At most 64 registers, four blocks an SM: fewer registers spill, more cost
// occupancy, and either keeps fewer loads in flight.
template <bool kRing, int kLanes>
__global__ void __launch_bounds__(kThreads, 4)
wdm_kernel(const int8_t* __restrict__ wdm, const int8_t* __restrict__ ring,
           const int32_t* __restrict__ col_source,
           const int32_t* __restrict__ col_delay, float* __restrict__ out,
           int M, int K, int N, int depth, int n_source, int64_t t, int rows,
           int split, int width, int slice, int lpr) {
  static_assert(kRing, "the streamed design reads the ring");
  constexpr int kPitch = kSpikeBytes / kLanes + 32;  // bytes of a copy a lane
  __shared__ __align__(16) int8_t xs[kShifts][kLanes][kPitch];
  __shared__ int psum[kMaxRows * kLanes];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rank = (int)(blockIdx.x % split);
  const int m0 = (int)(blockIdx.x / split) * rows;
  const int tile_rows = min(rows, M - m0);
  const int k_begin = min(K, rank * width), k_end = min(K, k_begin + width);
  const int sl = lane & (lpr - 1), seg = lane / lpr, segs = 32 / lpr;
  const int step = kWarps * segs;           // rows the block streams at once
  int tm = (int)(t % depth);
  if (tm < 0) tm += depth;
  for (int e = tid; e < kMaxRows * kLanes; e += kThreads) psum[e] = 0;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int c0 = k_begin; c0 < k_end; c0 += slice) {
    const int len = min(slice, k_end - c0), len16 = (len + 15) & ~15;
    const int words = (len16 + 32) >> 2;    // words of a copy in use
    // one turn of a segment: up to kUnroll chunks a lane of row rb + seg
    // from chunk g0 on, as loaded
    int r, mis, n_chunks;
    const uint4* chunk;
    auto at_row = [&](int rb) {
      r = rb + seg;
      const int8_t* p = wdm + (int64_t)(m0 + min(r, tile_rows - 1)) * K + c0;
      mis = (int)((uintptr_t)p & 15);
      chunk = reinterpret_cast<const uint4*>(p - mis);
      n_chunks = r < tile_rows ? (mis + len + 15) >> 4 : 0;
    };
    uint4 c[kUnroll];
    auto load = [&](int g0) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int q = g0 + u * lpr + sl;
        c[u] = q < n_chunks ? __ldcs(chunk + q) : zero;
      }
    };
    __syncthreads();                        // the last slice's readers are done
    const int rb0 = warp * segs;
    at_row(rb0);
    load(0);                                // in flight while the spikes stage
    // 1. copy 0: the slice's stacked spikes after 16 zero columns, 4
    // columns a thread at a time, their table loads first
    for (int cb = tid; cb < len16 + 16; cb += 4 * kThreads) {
      int src[4], slot[4];
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int cc = cb + v * kThreads;
        if (cc < len) {
          src[v] = col_source[c0 + cc];
          int s = tm - col_delay[c0 + cc] % depth;  // floor_mod(t - delay, d)
          if (s < 0) s += depth;
          if (s >= depth) s -= depth;
          slot[v] = s;
        }
      }
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int cc = cb + v * kThreads;
        if (cc >= len16 + 16) continue;
#pragma unroll
        for (int n = 0; n < kLanes; ++n)
          if (n < N)
            xs[0][n][16 + cc] =
                cc < len ? ring[((int64_t)n * depth + slot[v]) * n_source + src[v]]
                         : (int8_t)0;
      }
    }
    if (tid < 16)
      for (int n = 0; n < N; ++n) xs[0][n][tid] = 0;
    __syncthreads();
    // the other copies: a thread takes a word of copy 0 and writes its 15
    // shifts
    for (int n = 0; n < N; ++n) {
      const unsigned* from = reinterpret_cast<const unsigned*>(xs[0][n]);
      for (int w = tid; w < words; w += kThreads) {
        unsigned v[5];
#pragma unroll
        for (int j = 0; j < 5; ++j) v[j] = w + j < words ? from[w + j] : 0u;
#pragma unroll
        for (int s = 1; s < kShifts; ++s)
          reinterpret_cast<unsigned*>(xs[s][n])[w] =
              __funnelshift_r(v[s >> 2], v[(s >> 2) + 1], 8u * (unsigned)(s & 3));
      }
    }
    __syncthreads();
    // 2-3. stream the tile's rows, `step` at a time
    for (int rb = rb0; rb < tile_rows; rb += step) {
      if (rb != rb0) at_row(rb);
      const int shift = (16 - mis) & 15, skip = mis == 0 ? 16 : 0;
      int acc[kLanes];
#pragma unroll
      for (int n = 0; n < kLanes; ++n) acc[n] = 0;
      for (int g0 = 0; g0 < n_chunks; g0 += kUnroll * lpr) {
        if (rb != rb0 || g0 != 0) load(g0);
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int q = g0 + u * lpr + sl;
          if (q < n_chunks) {
#pragma unroll
            for (int n = 0; n < kLanes; ++n) {
              if (n < N) {
                const int4 x4 =
                    *reinterpret_cast<const int4*>(&xs[shift][n][16 * q + skip]);
                acc[n] = __dp4a((int)c[u].x, x4.x, acc[n]);
                acc[n] = __dp4a((int)c[u].y, x4.y, acc[n]);
                acc[n] = __dp4a((int)c[u].z, x4.z, acc[n]);
                acc[n] = __dp4a((int)c[u].w, x4.w, acc[n]);
              }
            }
          }
        }
      }
      // segments of one warp may take different turns at a row's end: the
      // reduction waits for all of them
      __syncwarp();
#pragma unroll
      for (int n = 0; n < kLanes; ++n)
        for (int off = lpr >> 1; off > 0; off >>= 1)
          acc[n] += __shfl_xor_sync(0xffffffffu, acc[n], off);
      if (r < tile_rows && sl == 0)
#pragma unroll
        for (int n = 0; n < kLanes; ++n)
          if (n < N) psum[r * kLanes + n] += acc[n];
    }
  }
  // 4. the tile's currents, each written once
  if (split == 1) {
    __syncthreads();
    for (int e = tid; e < tile_rows * N; e += kThreads) {
      const int n = e / tile_rows, r = e - n * tile_rows;
      out[(int64_t)n * M + m0 + r] = __int2float_rn(psum[r * kLanes + n]);
    }
    return;
  }
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();                           // every block's partial sums
  for (int e = rank * kThreads + tid; e < tile_rows * N; e += split * kThreads) {
    const int n = e / tile_rows, r = e - n * tile_rows;
    int sum = 0;
    for (int s = 0; s < split; ++s)
      sum += cluster.map_shared_rank(psum, s)[r * kLanes + n];
    out[(int64_t)n * M + m0 + r] = __int2float_rn(sum);
  }
  cluster.sync();                           // keep psum until all have read
}

template <int kLanes>
static cudaError_t launch(const int8_t* wdm, const int8_t* ring,
                          const int32_t* col_source, const int32_t* col_delay,
                          float* out, int M, int K, int N, int depth,
                          int n_source, int64_t t, int rows, int split,
                          int width, int slice, int lpr, cudaStream_t s) {
  void (*kernel)(const int8_t*, const int8_t*, const int32_t*, const int32_t*,
                 float*, int, int, int, int, int, int64_t, int, int, int, int,
                 int) = wdm_kernel<true, kLanes>;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = (unsigned)split;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(((M + rows - 1) / rows) * split));
  cfg.blockDim = dim3(kThreads);
  cfg.stream = s;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, wdm, ring, col_source, col_delay, out,
                            M, K, N, depth, n_source, t, rows, split, width,
                            slice, lpr);
}

}  // namespace streamed

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

// The streamed design at N <= 8 lanes (ops.py, stream_tiling, gives the rest).
extern "C" int spike_wdm_stream_s8(const int8_t* wdm, const int8_t* ring,
                                   const int32_t* col_source,
                                   const int32_t* col_delay, float* out, int M,
                                   int K, int N, int depth, int n_source,
                                   int64_t t, int rows, int split, int width,
                                   int slice, int lpr, void* stream) {
  cudaError_t (*launch)(const int8_t*, const int8_t*, const int32_t*,
                        const int32_t*, float*, int, int, int, int, int,
                        int64_t, int, int, int, int, int, cudaStream_t) =
      N <= 1 ? streamed::launch<1> : N <= 2 ? streamed::launch<2>
      : N <= 4 ? streamed::launch<4> : streamed::launch<8>;
  const cudaError_t err =
      launch(wdm, ring, col_source, col_delay, out, M, K, N, depth, n_source, t,
             rows, split, width, slice, lpr, (cudaStream_t)stream);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}
