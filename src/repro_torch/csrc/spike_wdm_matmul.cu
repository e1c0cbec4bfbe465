// K2: int8 weight-delay-map x int8 stacked spikes -> int32, no saturation.
//
//   out[n, m] = sum_k wdm[m, k] * stacked[n, k]
//
// wdm (M, K) int8 row-major: M = target neurons, K = WDM columns.
// stacked (N, K) int8 row-major: N = request batch, one row per lane, as
// the parallel projection's ring gather writes it (batch-major).
// out (N, M) int32 row-major: the batch-major current the executor sums.
// This is the reference's (M, K) @ (K, N) product, transposed on both
// sides so that no transpose is ever materialised around the call.
//
// Replaces the TPU kernel src/repro/kernels/spike_wdm_matmul/kernel.py
// (spike_wdm_matmul_pallas / _matmul_kernel), an MXU product accumulated
// over a K grid axis in 128/512 tiles.
//
// Bound on the H100: at the gesture path's shape, (20, 965) x (965, 8),
// the operands are ~27 KB and the work 0.3 M int8 MACs, so one launch is
// latency; at larger shapes the int8 operand bytes bound it long before
// the int8 tensor cores would.
//
// Design (simple kernel): one warp per output (n, m).  The TPU grid's
// sequential K axis becomes the warp's 32 lanes striding over K in packs
// of four bytes, each pack one __dp4a (signed 8-bit dot product into a
// 32-bit accumulator), then a shuffle reduction across the lanes: a K of
// about a thousand is 8 packs a lane instead of 240 serial ones in a
// single thread.  Neighbouring lanes read neighbouring bytes (coalesced),
// and the warps of a block share one stacked row (blockIdx.y = n), which
// stays in L1.  The bytes are packed one by one, so no row needs 4-byte
// alignment for any K.  Exact like the reference's int32 product:
// |sum| <= 2^14 * K stays in int32 for K < 2^17, and integer addition
// does not care about the order of the reduction.
#include <cstdint>
#include <cuda_runtime.h>

constexpr int kWarps = 8;   // outputs (warps) per block

__device__ __forceinline__ int pack4(const int8_t* p) {
  return (int)(uint8_t)p[0] | ((int)(uint8_t)p[1] << 8) |
         ((int)(uint8_t)p[2] << 16) | ((int)(uint8_t)p[3] << 24);
}

__global__ void spike_wdm_matmul_kernel(const int8_t* __restrict__ wdm,
                                        const int8_t* __restrict__ stacked,
                                        int32_t* __restrict__ out, int M,
                                        int K) {
  const int lane = threadIdx.x & 31;
  const int m = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int n = blockIdx.y;
  if (m >= M) return;                       // the whole warp leaves together
  const int8_t* a = wdm + (int64_t)m * K;
  const int8_t* x = stacked + (int64_t)n * K;
  const int k4 = K & ~3;
  int acc = 0;
  for (int k = 4 * lane; k < k4; k += 128)
    acc = __dp4a(pack4(a + k), pack4(x + k), acc);
  const int kt = k4 + lane;                 // masked tail: at most 3 bytes
  if (kt < K) acc += (int)a[kt] * (int)x[kt];
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  if (lane == 0) out[(int64_t)n * M + m] = acc;
}

extern "C" int spike_wdm_matmul_s8(const int8_t* wdm, const int8_t* stacked,
                                   int32_t* out, int M, int K, int N,
                                   void* stream) {
  const dim3 grid((M + kWarps - 1) / kWarps, N);   // the wrapper: N <= 65535
  spike_wdm_matmul_kernel<<<grid, 32 * kWarps, 0, (cudaStream_t)stream>>>(
      wdm, stacked, out, M, K);
  return (int)cudaGetLastError();
}
