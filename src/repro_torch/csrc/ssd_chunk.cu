// K5: Mamba-2 SSD intra-chunk block over G chunks at once.
//
//   cs      = running sum of la over the chunk            (per head)
//   Y[i, p] = sum_{j<=i} (C[i].B[j]) * exp(cs[i] - cs[j]) * X[j, p]
//   S[n, p] = sum_j B[j, n] * exp(cs[Q-1] - cs[j]) * X[j, p]
//
// Operands are contiguous f32: x (G, Q, H, P) already scaled by dt,
// b and c (G, Q, H, N), la (G, Q, H); outputs y (G, Q, H, P) and the chunk
// state (G, H, N, P).  G = 1 is the reference's single-chunk call.
//
// Replaces the TPU kernel src/repro/kernels/ssd_chunk/kernel.py
// (ssd_chunk_pallas / _ssd_kernel), one grid cell per head that forms the
// whole (Q, Q) score matrix in VMEM and runs its three products on the MXU.
//
// Bound on the H100: operations.  At mamba2-130m's prefill (G 16 = batch 4
// x 4 chunks, Q 256, H 24, P 64, N 128) one launch moves about 164 MB
// (0.049 ms at 3.35 TB/s) and needs 6.5 GFLOP with the causal half skipped
// (11.3 without), 0.096 ms at the card's 67 TFLOP/s f32 rate outside the
// tensor cores.  The tensor cores are not used: TF32 keeps about three
// decimal digits and the block is held to 1e-4.
//
// Design (simple first kernel): one block of 256 threads per (chunk, head).
//  1. One thread forms cs in shared memory as a running sum in order: the
//     plain version's cumsum runs in that order on the card too, and the
//     decays exp(cs[i] - cs[j]) carry the rounding of cs (an ulp of |cs|)
//     onto terms whose sum may cancel, so the two form cs alike (Q dependent
//     adds from shared memory: about a microsecond at Q = 256).  The block
//     then forms the decays to the chunk's end, exp(cs[Q-1] - cs).
//  2. Y in 64 x 64 (i, p) tiles.  For each tile of rows i, only the tiles
//     of columns j up to the diagonal are visited.  A 64 x 64 score tile is
//     C.B^T over N in slices of 32 (C and B staged transposed, padded
//     against bank conflicts), then scaled by exp(cs[i] - cs[j]) where
//     j <= i and zeroed above the diagonal: exp never sees a positive
//     difference, which with a mamba2 layer's decays would overflow.  The
//     score tile times the staged X tile accumulates into Y.
//  3. The chunk state in 64 x 64 (n, p) tiles: B scaled by the decay to
//     the chunk's end, times X, over all rows j.
// Each thread holds a 4 x 4 micro-tile (rows ty + 16 r, columns tx + 16 c)
// and accumulates with explicit fmaf: the build's --fmad=false (which K1
// and K4 need for bitwise agreement) stops only implicit contraction.
// expf is the accurate libm version (the build has no fast-math).
// Any Q, H, P and N: edges are masked, and P or N above 64 loop over tiles.
//
// Later work: the products on the tensor cores (mma.sync / wgmma) with a
// 3xTF32 split to hold 1e-4, and the diagonal tile's masked half skipped
// inside the tile as well.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;     // 16 x 16 threads, a 4 x 4 micro-tile each
constexpr int kTile = 64;         // rows and columns of an output tile
constexpr int kDepth = 32;        // N-slice of a score tile's dot products
constexpr int kPad = kTile + 1;   // row pitch of the transposed tiles

size_t smem_bytes(int64_t q_len) {
  // cs[Q] | dec[Q] | ct[kDepth][kPad] | bt[kDepth][kPad] | sc[kTile][kPad]
  // | xs[kTile][kTile]; the state phase reuses sc as bw[kTile][kTile]
  return sizeof(float) * (2 * q_len + 2 * kDepth * kPad + kTile * kPad +
                          kTile * kTile);
}

__global__ void __launch_bounds__(kThreads)
ssd_chunk_kernel(const float* __restrict__ x, const float* __restrict__ b,
                 const float* __restrict__ c, const float* __restrict__ la,
                 float* __restrict__ y, float* __restrict__ state,
                 int64_t q_len, int64_t heads, int64_t p_dim, int64_t n_dim) {
  extern __shared__ float smem[];
  float* cs = smem;
  float* dec = cs + q_len;
  float* ct = dec + q_len;
  float* bt = ct + kDepth * kPad;
  float* sc = bt + kDepth * kPad;
  float* xs = sc + kTile * kPad;

  const int64_t g = blockIdx.x / heads;
  const int64_t h = blockIdx.x % heads;
  const int64_t row0 = g * q_len;        // first row of this chunk
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;

  // 1. cs = running sum of la, in order (staged, then one thread sums);
  //    dec = exp(cs[Q-1] - cs)
  for (int64_t r = tid; r < q_len; r += kThreads) cs[r] = la[(row0 + r) * heads + h];
  __syncthreads();
  if (tid == 0) {
    float acc = 0.f;
    for (int64_t r = 0; r < q_len; ++r) {
      acc = __fadd_rn(acc, cs[r]);
      cs[r] = acc;
    }
  }
  __syncthreads();
  const float cs_last = cs[q_len - 1];
  for (int64_t r = tid; r < q_len; r += kThreads) dec[r] = expf(cs_last - cs[r]);
  __syncthreads();

  // 2. Y, one (i, p) tile at a time, over the j tiles up to the diagonal
  for (int64_t p0 = 0; p0 < p_dim; p0 += kTile) {
    for (int64_t i0 = 0; i0 < q_len; i0 += kTile) {
      float acc_y[4][4] = {};
      for (int64_t j0 = 0; j0 <= i0; j0 += kTile) {
        // 2a. score tile C[i0.., :] . B[j0.., :]^T, N in slices of kDepth
        float acc_s[4][4] = {};
        for (int64_t n0 = 0; n0 < n_dim; n0 += kDepth) {
          for (int e = tid; e < kTile * kDepth; e += kThreads) {
            const int rr = e / kDepth, kk = e % kDepth;
            const int64_t n = n0 + kk, ri = i0 + rr, rj = j0 + rr;
            ct[kk * kPad + rr] =
                (ri < q_len && n < n_dim) ? c[((row0 + ri) * heads + h) * n_dim + n] : 0.f;
            bt[kk * kPad + rr] =
                (rj < q_len && n < n_dim) ? b[((row0 + rj) * heads + h) * n_dim + n] : 0.f;
          }
          __syncthreads();
#pragma unroll 8
          for (int kk = 0; kk < kDepth; ++kk) {
            float a[4], bb[4];
#pragma unroll
            for (int r = 0; r < 4; ++r) a[r] = ct[kk * kPad + ty + 16 * r];
#pragma unroll
            for (int q = 0; q < 4; ++q) bb[q] = bt[kk * kPad + tx + 16 * q];
#pragma unroll
            for (int r = 0; r < 4; ++r)
#pragma unroll
              for (int q = 0; q < 4; ++q) acc_s[r][q] = fmaf(a[r], bb[q], acc_s[r][q]);
          }
          __syncthreads();
        }
        // 2b. decay below the diagonal, zero above; stage X[j0.., p0..]
#pragma unroll
        for (int r = 0; r < 4; ++r) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int64_t i = i0 + ty + 16 * r, j = j0 + tx + 16 * q;
            sc[(ty + 16 * r) * kPad + tx + 16 * q] =
                (j <= i && i < q_len) ? acc_s[r][q] * expf(cs[i] - cs[j]) : 0.f;
          }
        }
        for (int e = tid; e < kTile * kTile; e += kThreads) {
          const int rr = e / kTile, pp = e % kTile;
          const int64_t j = j0 + rr, p = p0 + pp;
          xs[rr * kTile + pp] =
              (j < q_len && p < p_dim) ? x[((row0 + j) * heads + h) * p_dim + p] : 0.f;
        }
        __syncthreads();
        // 2c. Y tile += score tile . X tile
#pragma unroll 8
        for (int jj = 0; jj < kTile; ++jj) {
          float a[4], bb[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) a[r] = sc[(ty + 16 * r) * kPad + jj];
#pragma unroll
          for (int q = 0; q < 4; ++q) bb[q] = xs[jj * kTile + tx + 16 * q];
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int q = 0; q < 4; ++q) acc_y[r][q] = fmaf(a[r], bb[q], acc_y[r][q]);
        }
        __syncthreads();
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int64_t i = i0 + ty + 16 * r, p = p0 + tx + 16 * q;
          if (i < q_len && p < p_dim) y[((row0 + i) * heads + h) * p_dim + p] = acc_y[r][q];
        }
      }
    }
  }

  // 3. chunk state: (B * dec)^T . X, one (n, p) tile at a time
  float* bw = sc;
  for (int64_t n0 = 0; n0 < n_dim; n0 += kTile) {
    for (int64_t p0 = 0; p0 < p_dim; p0 += kTile) {
      float acc[4][4] = {};
      for (int64_t j0 = 0; j0 < q_len; j0 += kTile) {
        for (int e = tid; e < kTile * kTile; e += kThreads) {
          const int rr = e / kTile, cc = e % kTile;
          const int64_t j = j0 + rr, n = n0 + cc, p = p0 + cc;
          bw[rr * kTile + cc] =
              (j < q_len && n < n_dim) ? b[((row0 + j) * heads + h) * n_dim + n] * dec[j] : 0.f;
          xs[rr * kTile + cc] =
              (j < q_len && p < p_dim) ? x[((row0 + j) * heads + h) * p_dim + p] : 0.f;
        }
        __syncthreads();
#pragma unroll 8
        for (int jj = 0; jj < kTile; ++jj) {
          float a[4], bb[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) a[r] = bw[jj * kTile + ty + 16 * r];
#pragma unroll
          for (int q = 0; q < 4; ++q) bb[q] = xs[jj * kTile + tx + 16 * q];
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(a[r], bb[q], acc[r][q]);
        }
        __syncthreads();
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int64_t n = n0 + ty + 16 * r, p = p0 + tx + 16 * q;
          if (n < n_dim && p < p_dim) state[((g * heads + h) * n_dim + n) * p_dim + p] = acc[r][q];
        }
      }
    }
  }
}

}  // namespace

extern "C" int ssd_chunk_f32(const float* x, const float* b, const float* c,
                             const float* la, float* y, float* state,
                             int64_t chunks, int64_t q_len, int64_t heads,
                             int64_t p_dim, int64_t n_dim, void* stream) {
  // Above 48 KB a block's dynamic shared memory must be allowed explicitly;
  // allow the card's whole opt-in limit once (it does not change occupancy,
  // which follows the size each launch asks for).
  static int smem_limit = -1;
  if (smem_limit < 0) {
    int dev = 0, limit = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(ssd_chunk_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, limit);
    if (err != cudaSuccess) return (int)err;
    smem_limit = limit;
  }
  const size_t smem = smem_bytes(q_len);
  const int64_t blocks = chunks * heads;
  if (smem > (size_t)smem_limit || blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  ssd_chunk_kernel<<<(unsigned int)blocks, kThreads, smem, (cudaStream_t)stream>>>(
      x, b, c, la, y, state, q_len, heads, p_dim, n_dim);
  return (int)cudaGetLastError();
}
