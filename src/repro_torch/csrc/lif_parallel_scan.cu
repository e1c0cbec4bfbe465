// K4: reset-free affine membrane scan, v[t] = alpha*v[t-1] + c[t], v[-1] = 0,
// over a contiguous (T, F) f32 current train; and the iterative temporal
// mode's whole fixed point on top of it, in one launch.
//
// Replaces the TPU kernel src/repro/kernels/lif_parallel_scan/kernel.py
// (affine_scan_pallas / _scan_kernel), which evaluates chunks of Q = 128
// steps as one lower-triangular matmul L[i, j] = alpha^(i-j) on the MXU and
// carries v[Q-1] between chunks in VMEM.  That chunked matmul does not carry
// over: Hopper's tensor cores have no IEEE f32 product, and TF32 would round
// the integer currents the temporal paradigm's exactness rests on.
//
// Bound on the H100: device-memory bytes, 8 an element (one f32 read of c,
// one f32 write of v) for 2 flops.  At the gesture path's shapes (T 75,
// F 160 or 32) that is under 100 KB: one launch is latency, and the T
// dependent multiply-adds of a thread set its time.  The fixed point moves
// the same 8 bytes an element once, but its chain is passes x T steps
// long (72 x 75 at the gesture net's output population), far above that
// bound.
//
// affine_scan_kernel (one scan): one thread per feature f walks T in order.
// Neighbouring threads hold neighbouring features, so every step's load of
// c[t, :] and store of v[t, :] is coalesced.  The recurrence is
// affine_step, __fadd_rn(__fmul_rn(alpha, v), c) (and the build passes
// --fmad=false): the sequential order with separately rounded ops is
// exactly the plain version's, so the two agree bit for bit at any alpha,
// not only where all arithmetic is exact.  v[0] = c[0] is stored as it is,
// as the reference's inclusive scan does.
//
// fixed_point_kernel (the iterative reset mode, temporal_runtime): pass k
// feeds the spikes of pass k-1 into the reset currents c[t] = i[t] -
// z[t-1]*v_th, scans, and thresholds; the reference repeats passes until
// no spike flips or a cap is reached, reading the flip count back each
// pass.  Column f of a pass reads only column f of the currents and of the
// previous spikes, and a column with one pass free of flips never changes
// again, so each column can run its own passes: the global pass count is
// min(cap, max_f k_f), k_f the first flip-free pass of column f, and the
// residual is the sum of the last pass's flips over the columns the cap
// cut.  One thread per feature, 32 features a block (one warp), so F = 160
// fills 5 SMs; no grid-wide synchronisation.  A warp reduction, then
// atomicMax/atomicAdd put the pass count and residual into two ints.
//
// Its time is the dependent chain of the slowest column, passes x T steps
// of one multiply and one add, and the instructions a warp issues around
// it: alone on its SM, the warp has no other warp to hide them behind.  So
// the design keeps a step's instructions few and free of branches:
//   - the spikes are bits, 32 steps a word, in shared memory: a step tests
//     one bit of the old word and sets one in the new, and a pass counts
//     its flips with one popcount a word;
//   - the block stages its currents once with cp.async, each thread's
//     column contiguous (rows 4 words apart mod 32 banks), so a chunk of
//     32 steps loads with eight 16-byte loads; above what the opt-in
//     shared memory holds, the currents are read from device memory on
//     each pass instead (the spike bits still fit up to ~58k steps), and
//     above that the spike words too live in device memory, in a scratch
//     buffer the wrapper allocates (kFeat words of a chunk side by side,
//     so a warp's loads and stores of them stay coalesced);
//   - a chunk's 32 steps are unrolled with no branch (the last chunk runs
//     past the train's end and drops those bits), so the compiler
//     interleaves the steps' independent work around the chain.
// Each step is the plain version's separately rounded ops: the reset
// current, then affine_step.
#include <cstdint>
#include <cuda_runtime.h>

__device__ __forceinline__ float affine_step(float alpha, float v, float c) {
  return __fadd_rn(__fmul_rn(alpha, v), c);
}

__global__ void affine_scan_kernel(const float* __restrict__ c,
                                   float* __restrict__ v, int64_t steps,
                                   int64_t feat, float alpha) {
  int64_t f = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (f >= feat) return;
  float acc = c[f];
  v[f] = acc;
  for (int64_t t = 1; t < steps; ++t) {
    int64_t k = t * feat + f;
    acc = affine_step(alpha, acc, c[k]);
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

constexpr int kFeat = 32;                    // features (threads) a block
constexpr int kChunk = 32;                   // steps one spike word holds

// Where a block keeps its train: currents and spike words in shared memory;
// spike words only (currents read from device memory each pass); or
// neither (spike words in a device-memory scratch buffer).
enum Mode { kAllShared = 0, kWordsShared = 1, kWordsDevice = 2 };

// Floats a staged column holds: the chunks rounded up, plus 4 so that rows
// are 16-byte aligned and 4 words apart mod 32 banks (conflict-free
// 16-byte loads).
__host__ __device__ constexpr int64_t staged_row(int64_t steps) {
  return (steps + kChunk - 1) / kChunk * kChunk + 4;
}
__host__ __device__ constexpr int64_t words_of(int64_t steps) {
  return (steps + kChunk - 1) / kChunk;
}
// Shared memory of a block: its spike words, and its staged currents.
static size_t smem_bytes(int64_t steps, int mode) {
  return (mode == kWordsDevice ? 0 : (size_t)words_of(steps) * kFeat * 4) +
         (mode == kAllShared ? (size_t)staged_row(steps) * kFeat * 4 : 0);
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

// A chunk's currents: eight 16-byte loads from the staged column, or 32
// loads `feat` apart from device memory (0 past the end).
template <bool kStaged>
__device__ __forceinline__ void load_chunk(float (&c)[kChunk], const float* col,
                                           int64_t t0, int64_t steps,
                                           int64_t feat) {
  if (kStaged) {
    const float4* p = reinterpret_cast<const float4*>(col + t0);
#pragma unroll
    for (int q = 0; q < kChunk / 4; ++q) {
      const float4 w = p[q];
      c[4 * q] = w.x, c[4 * q + 1] = w.y, c[4 * q + 2] = w.z, c[4 * q + 3] = w.w;
    }
  } else {
#pragma unroll
    for (int u = 0; u < kChunk; ++u)
      c[u] = t0 + u < steps ? col[(t0 + u) * feat] : 0.f;
  }
}

// The 32 steps of one chunk of a pass, with no branch, so the compiler
// interleaves the steps around the membrane chain.  `old` holds the
// previous pass's spikes of the chunk, one bit a step; returns the new
// ones.  v and zprev (z[t-1] of the previous pass) carry from chunk to
// chunk.  The reset current takes z[t-1] * v_th as one of its two values
// (z is 0 or 1): the plain version's own f32 products.
template <bool kFirst>
__device__ __forceinline__ unsigned chunk_pass(const float (&c)[kChunk],
                                               unsigned old, float& v,
                                               bool& zprev, float alpha,
                                               float vth, float reset0,
                                               float reset1) {
  unsigned fired = 0;
#pragma unroll
  for (int u = 0; u < kChunk; ++u) {
    const float cur = __fsub_rn(c[u], zprev ? reset1 : reset0);
    v = kFirst && u == 0 ? cur : affine_step(alpha, v, cur);   // v[0] = c[0]
    if (v >= vth) fired |= 1u << u;
    zprev = (old >> u) & 1u;
  }
  return fired;
}

// One pass over a thread's column: its spike words (`words`, kFeat apart)
// are replaced by the new pass's; returns the flips.  The last chunk runs
// all 32 steps too, on whatever lies past the train's end, and drops
// their bits: the pass ends there, so nothing reads their membrane.
template <bool kStaged>
__device__ int one_pass(const float* col, unsigned* words, int64_t steps,
                        int64_t feat, float alpha, float vth, float reset0,
                        float reset1) {
  int flips = 0;
  float v = 0.f, c[kChunk];
  bool zprev = false;                        // z[-1] = 0
  for (int64_t k = 0; k < words_of(steps); ++k) {
    load_chunk<kStaged>(c, col, k * kChunk, steps, feat);
    const unsigned old = words[k * kFeat];
    unsigned fired = k == 0
        ? chunk_pass<true>(c, old, v, zprev, alpha, vth, reset0, reset1)
        : chunk_pass<false>(c, old, v, zprev, alpha, vth, reset0, reset1);
    const int64_t n = steps - k * kChunk;
    if (n < kChunk) fired &= (1u << n) - 1u;
    flips += __popc(fired ^ old);
    words[k * kFeat] = fired;
  }
  return flips;
}

template <int kMode>
__global__ void __launch_bounds__(kFeat)
fixed_point_kernel(const float* __restrict__ cur, float* __restrict__ z,
                   int* __restrict__ stats, unsigned* __restrict__ scratch,
                   int64_t steps, int64_t feat, float alpha, float vth,
                   int cap) {
  constexpr bool kStaged = kMode == kAllShared;
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x;
  const int64_t f = (int64_t)blockIdx.x * kFeat + lane;
  const int64_t n_words = words_of(steps);
  unsigned* words =                                                // (words, kFeat)
      (kMode == kWordsDevice ? scratch + blockIdx.x * n_words * kFeat
                             : reinterpret_cast<unsigned*>(smem)) + lane;
  float* cs = reinterpret_cast<float*>(smem + n_words * kFeat * 4) +
              lane * staged_row(steps);                            // (kFeat, row)
  int iters = 0, flips = 0;
  if (f < feat) {
    // each thread stages and reads only its own column: no barrier needed
    if (kStaged)
      for (int64_t t = 0; t < steps; ++t) cp_async4(cs + t, cur + t * feat + f);
    for (int64_t k = 0; k < n_words; ++k) words[k * kFeat] = 0u;
    if (kStaged) asm volatile("cp.async.wait_all;\n" ::: "memory");
    const float reset0 = __fmul_rn(0.f, vth), reset1 = __fmul_rn(1.f, vth);
    do {
      flips = one_pass<kStaged>(kStaged ? cs : cur + f, words, steps, feat,
                                alpha, vth, reset0, reset1);
      ++iters;
    } while (flips > 0 && iters < cap);
    for (int64_t t = 0; t < steps; ++t)
      z[t * feat + f] = (words[t / kChunk * kFeat] >> (t % kChunk)) & 1u ? 1.f : 0.f;
  }
  // a converged column's last pass has no flips, so the flips left are the
  // cut columns' flips at pass `cap`, the reference's residual
  const unsigned most = __reduce_max_sync(0xffffffffu, (unsigned)iters);
  const unsigned sum = __reduce_add_sync(0xffffffffu, (unsigned)flips);
  if (lane == 0) {
    atomicMax(stats, (int)most);
    atomicAdd(stats + 1, (int)sum);
  }
}

// The longest trains the current device's opt-in shared memory takes:
// staged (currents and spikes), and with its spike words (the currents are
// then read from device memory on each pass); longer trains keep their
// spike words in device memory too.  -1 if it cannot be read.
extern "C" int fixed_point_limits(int64_t* staged, int64_t* most) {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return -1;
  // bytes(T) = 4 kFeat words(T) (1 + kChunk) + 16 kFeat, spikes alone 4 kFeat words(T)
  *staged = (optin - 16 * kFeat) / (4 * kFeat * (1 + kChunk)) * kChunk;
  *most = optin / (4 * kFeat) * kChunk;
  return 0;
}

template <int kMode>
static cudaError_t launch_fixed_point(const float* cur, float* z, int* stats,
                                      unsigned* scratch, int64_t steps,
                                      int64_t feat, float alpha, float vth,
                                      int cap, cudaStream_t s) {
  static size_t opted_in = 48 * 1024;        // the default dynamic limit
  const size_t bytes = smem_bytes(steps, kMode);
  if (bytes > opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        fixed_point_kernel<kMode>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return err;
    opted_in = bytes;
  }
  const unsigned int blocks = (unsigned int)((feat + kFeat - 1) / kFeat);
  fixed_point_kernel<kMode><<<blocks, kFeat, bytes, s>>>(
      cur, z, stats, scratch, steps, feat, alpha, vth, cap);
  return cudaGetLastError();
}

// stats: int32[2] <- (passes, residual).  mode: a Mode, kAllShared and
// kWordsShared only for steps within the limits above; scratch: for
// kWordsDevice, ceil(feat / kFeat) * kFeat * ceil(steps / kChunk) words of
// device memory (else unused).  steps > 0, feat > 0 and cap >= 1.
extern "C" int lif_fixed_point_f32(const float* cur, float* z, int* stats,
                                   unsigned* scratch, int64_t steps,
                                   int64_t feat, float alpha, float vth,
                                   int cap, int mode, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(stats, 0, 2 * sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  switch (mode) {
    case kAllShared:
      return (int)launch_fixed_point<kAllShared>(cur, z, stats, scratch, steps,
                                              feat, alpha, vth, cap, s);
    case kWordsShared:
      return (int)launch_fixed_point<kWordsShared>(cur, z, stats, scratch, steps,
                                                 feat, alpha, vth, cap, s);
    case kWordsDevice:
      return (int)launch_fixed_point<kWordsDevice>(cur, z, stats, scratch,
                                                   steps, feat, alpha, vth,
                                                   cap, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
