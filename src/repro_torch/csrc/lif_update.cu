// K1: fused LIF update, v' = (i + alpha*v) - z*v_th, z' = [v' >= v_th].
//
// Replaces the TPU kernel src/repro/kernels/lif_update/kernel.py
// (lif_update_pallas / _lif_kernel), which runs over (N, B) VMEM tiles.
//
// Bound on the H100: device-memory bytes.  Each element reads three f32
// (i, v, z) and writes two (v', z'): 20 bytes for 5 flops, far below the
// card's flop-per-byte balance.  At the gesture path's shapes (a few
// hundred elements) one launch is all latency.
//
// Design: an elementwise map does not care about layout, so the executor
// keeps v and z in its batch-major (B, N) carry and passes flat contiguous
// buffers; one thread per element, neighbouring threads on neighbouring
// addresses (coalesced).  Every step is a separately rounded f32 op
// (__fmul_rn / __fadd_rn / __fsub_rn, and the build passes --fmad=false):
// the reference evaluates the same expression without fused multiply-add,
// and with a non-dyadic alpha (0.9) an FMA rounds differently and can flip
// a spike at threshold.
#include <cstdint>
#include <cuda_runtime.h>

__global__ void lif_update_kernel(const float* __restrict__ i,
                                  const float* __restrict__ v,
                                  const float* __restrict__ z,
                                  float* __restrict__ v_out,
                                  float* __restrict__ z_out,
                                  int64_t n, float alpha, float v_th) {
  int64_t k = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n) return;
  float vn = __fsub_rn(__fadd_rn(i[k], __fmul_rn(alpha, v[k])),
                       __fmul_rn(z[k], v_th));
  v_out[k] = vn;
  z_out[k] = vn >= v_th ? 1.0f : 0.0f;
}

extern "C" int lif_update_f32(const float* i, const float* v, const float* z,
                              float* v_out, float* z_out, int64_t n,
                              float alpha, float v_th, void* stream) {
  const int threads = 256;
  const int64_t blocks = (n + threads - 1) / threads;
  lif_update_kernel<<<(unsigned int)blocks, threads, 0,
                      (cudaStream_t)stream>>>(i, v, z, v_out, z_out, n,
                                              alpha, v_th);
  return (int)cudaGetLastError();
}
