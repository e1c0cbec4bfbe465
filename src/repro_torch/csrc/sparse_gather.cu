// K3: ELL gather-accumulate, out[r, b] = sum_l val[r, l] * x[idx[r, l], b].
//
// val (R, L) f32 and idx (R, L) int32: one ELL row per (delay slot,
// target) pair, padding lanes weight 0 / index 0 (safe to read).
// x (S, B) f32: this step's presynaptic spikes, source-major.
// out (R, B) f32.
//
// Replaces the TPU kernel src/repro/kernels/sparse_gather/kernel.py
// (sparse_gather_pallas / _gather_kernel), which keeps x resident in VMEM
// and streams row blocks of the ELL operands.
//
// Bound on the H100: device-memory bytes.  The ELL operands are read once
// (8 bytes a lane) and each lane gathers a B-wide spike row; the flops are
// two a gathered element.  x is small next to the operands (2048 x 8 f32
// on the gesture path) and stays in L2, so no shared-memory staging: an
// 80k-neuron source would not fit in a block's shared memory anyway.
//
// Design (simple first kernel): one thread per (r, b), b fastest, looping
// over the row's L lanes; neighbouring threads read neighbouring lanes of
// the same spike row, so the gathers of x are coalesced over b.  With
// integer weights and 0/1 spikes every f32 partial sum is an exact integer
// below 2^24, so the summation order is free and the result is bit-equal
// to the plain version.
#include <cstdint>
#include <cuda_runtime.h>

__global__ void sparse_gather_kernel(const float* __restrict__ val,
                                     const int32_t* __restrict__ idx,
                                     const float* __restrict__ x,
                                     float* __restrict__ out, int R, int L,
                                     int B) {
  int64_t k = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= (int64_t)R * B) return;
  const int b = (int)(k % B);
  const int64_t r = k / B;
  const float* vr = val + r * L;
  const int32_t* ir = idx + r * L;
  float acc = 0.0f;
  for (int l = 0; l < L; ++l)
    acc = __fadd_rn(acc, __fmul_rn(vr[l], x[(int64_t)ir[l] * B + b]));
  out[k] = acc;
}

extern "C" int sparse_gather_f32(const float* val, const int32_t* idx,
                                 const float* x, float* out, int R, int L,
                                 int B, void* stream) {
  const int threads = 256;
  const int64_t blocks = ((int64_t)R * B + threads - 1) / threads;
  sparse_gather_kernel<<<(unsigned int)blocks, threads, 0,
                         (cudaStream_t)stream>>>(val, idx, x, out, R, L, B);
  return (int)cudaGetLastError();
}
