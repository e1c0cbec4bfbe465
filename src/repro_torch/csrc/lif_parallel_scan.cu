// K4: reset-free affine membrane scan, v[t] = alpha*v[t-1] + c[t], v[-1] = 0,
// over a contiguous (T, F) f32 current train.
//
// Replaces the TPU kernel src/repro/kernels/lif_parallel_scan/kernel.py
// (affine_scan_pallas / _scan_kernel), which evaluates chunks of Q = 128
// steps as one lower-triangular matmul L[i, j] = alpha^(i-j) on the MXU and
// carries v[Q-1] between chunks in VMEM.  That chunked matmul does not carry
// over: Hopper's tensor cores have no IEEE f32 product, and TF32 would round
// the integer currents the temporal paradigm's exactness rests on.
//
// Bound on the H100: device-memory bytes, 8 a element (one f32 read of c,
// one f32 write of v) for 2 flops.  At the gesture path's shapes (T 75,
// F 160 or 32) that is under 100 KB: one launch is latency, and the T
// dependent multiply-adds of a thread set its time.
//
// Design (simple first kernel): one thread per feature f walks T in order.
// Neighbouring threads hold neighbouring features, so every step's load of
// c[t, :] and store of v[t, :] is coalesced.  The recurrence is spelled as
// __fadd_rn(__fmul_rn(alpha, v), c) (and the build passes --fmad=false):
// the sequential order with separately rounded ops is exactly the plain
// version's, so the two agree bit for bit at any alpha, not only where all
// arithmetic is exact.  v[0] = c[0] is stored as it is, as the reference's
// inclusive scan does.
//
// Later work: with long T and few features (F well below the card's ~17k
// resident threads) a chunked scan - each warp scans a chunk of T for its
// features, then a second pass adds alpha^(t+1) times the chunk carries -
// would shorten the serial chain; it changes the rounding order, so it
// would be exact only inside the integer window.
#include <cstdint>
#include <cuda_runtime.h>

__global__ void affine_scan_kernel(const float* __restrict__ c,
                                   float* __restrict__ v, int64_t steps,
                                   int64_t feat, float alpha) {
  int64_t f = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (f >= feat) return;
  float acc = c[f];
  v[f] = acc;
  for (int64_t t = 1; t < steps; ++t) {
    int64_t k = t * feat + f;
    acc = __fadd_rn(__fmul_rn(alpha, acc), c[k]);
    v[k] = acc;
  }
}

extern "C" int affine_scan_f32(const float* c, float* v, int64_t steps,
                               int64_t feat, float alpha, void* stream) {
  const int threads = 128;
  const int64_t blocks = (feat + threads - 1) / threads;
  affine_scan_kernel<<<(unsigned int)blocks, threads, 0,
                       (cudaStream_t)stream>>>(c, v, steps, feat, alpha);
  return (int)cudaGetLastError();
}
