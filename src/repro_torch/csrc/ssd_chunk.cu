// K5: Mamba-2 SSD intra-chunk block over G chunks at once.
//
//   cs      = running sum of la over the chunk            (per head)
//   Y[i, p] = sum_{j<=i} (C[i].B[j]) * exp(cs[i] - cs[j]) * X[j, p]
//   S[n, p] = sum_j B[j, n] * exp(cs[Q-1] - cs[j]) * X[j, p]
//
// Operands are contiguous f32: x (G, Q, H, P) already scaled by dt,
// b and c (G, Q, Hg, N) shared by groups of H / Hg heads (head h reads
// group h / (H / Hg); Hg = H is the per-head call), la (G, Q, H); outputs
// y (G, Q, H, P) and the chunk state (G, H, N, P).  G = 1 is the
// reference's single-chunk call.  The caller's scratch buffer holds the
// group scores: T(T+1)/2 x G x Hg tiles of 64 x 64 f32, T = ceil(Q / 64).
//
// Replaces the TPU kernel src/repro/kernels/ssd_chunk/kernel.py
// (ssd_chunk_pallas / _ssd_kernel), one grid cell per head that forms the
// whole (Q, Q) score matrix in VMEM and runs its three products on the MXU.
//
// Bound on the H100: operations.  At mamba2-130m's prefill (G 16 = batch 4
// x 4 chunks, Q 256, H 24, Hg 1, P 64, N 128) the products need 6.46 GFLOP
// with the causal half skipped; run as three TF32 products each (below)
// that is 19.4 GFLOP, 0.039 ms at the card's 495 TFLOP/s TF32 rate.  One
// launch moves about 67.5 MB (x, y, la, the state, and B and C once per
// group), 0.020 ms at 3.35 TB/s.  (That count takes the score C.B^T once a
// head, as the reference does; this kernel forms it once a group.)
//
// Design:
//  * Products on the tensor cores, mma.sync m16n8k8 TF32 with f32
//    accumulation, split 3xTF32: each operand a = big + small with
//    big = tf32(a) (round to nearest) and small = a - big, and each
//    product accumulates big.small + small.big + big.big, small terms
//    first.  Only small.small and the cut of small to TF32 (each at most
//    about 2^-21 of a product) are lost, so the block stays within the
//    reference's 1e-4 where one TF32 product (three decimal digits) would
//    not.  The tensor cores cut their sums toward zero; three such cuts of
//    the running sum every k step summed to 2.4e-4 on y at the path shape
//    on the H100 (against a tolerance of 1e-4 + 1e-4 |y|), so each k
//    step's three products go into a zeroed accumulator that is then added
//    to the running sum, rounded to nearest.
//  * Two grids, launched one after the other on the caller's stream:
//    1. The group scores C.B^T (no decay: it is the same for every head of
//       a group), one 64 x 64 tile a block for each pair of row and column
//       tiles at or below the diagonal, over N in slices of 32, written to
//       the scratch buffer.  Inside a diagonal tile warp w computes only
//       the 2w + 2 column blocks of 8 at or below its rows.
//    2. Per (chunk, head) one block for each 64-row tile of Y and one for
//       the chunk state, heaviest first (the last Y tile, which visits
//       every j tile, then the state, then the earlier Y tiles): at the
//       path shape 384 x 5 = 1,920 blocks, 120 at the reference's single
//       chunk.  A Y tile reads the score tiles of its row, scales each
//       entry by exp(cs[i] - cs[j]) where j <= i and zeroes it above the
//       diagonal (exp never sees a positive difference, which with a mamba2
//       layer's decays would overflow), splits it and multiplies it into
//       X.  The state block: (B . dec)^T X in 64 x 64 (n, p) tiles; B is
//       scaled by dec = exp(cs[Q-1] - cs[j]) in f32 (the plain version's
//       product) before the split.
//  * cs is one running sum in order, as the plain version's cumsum along Q
//    is on the card: the decays exp(cs[i] - cs[j]) carry the rounding of
//    cs onto terms that may cancel, so both form cs alike.  Each block
//    stages la in shared memory, then one thread adds it in order, 32
//    values at a time from registers: every block forms the same bits.
//  * Four warps a block, 16 rows each.  Operands are staged by cp.async
//    (16 bytes a copy when every row is 16-byte aligned, else 4) into two
//    stages of shared memory: the next tiles load while the current ones
//    are multiplied.  Row pitches of 36, 68 and 72 floats keep every
//    fragment load free of bank conflicts.
// Any Q, H, Hg, P and N: edges are zero-filled on load and masked on store;
// P and N above 64 loop over tiles.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;               // 4 warps x 16 rows
constexpr int kTile = 64;                   // rows and columns of a tile
constexpr int kSlice = 32;                  // N-slice of a score product
constexpr int kCPitch = kSlice + 4;         // C and B slices, [row][n]
constexpr int kXPitch = kTile + 4;          // X tiles and state B tiles, [j][col]
constexpr int kSPitch = kTile + 8;          // score tiles, [i][j]
constexpr int kScoreStage = 2 * kTile * kCPitch;               // floats
constexpr int kStage = kTile * kSPitch + kTile * kXPitch;      // floats: 35,840 bytes
static_assert(2 * kTile * kXPitch <= kStage, "state step fits a stage");

struct Dims {
  int64_t g, q, h, hg, p, n;
};

// a block's position in its sequence of staged steps (three counters)
struct Step {
  int a, b, c;
};

__host__ __device__ __forceinline__ int64_t ceil_div(int64_t a, int64_t b) {
  return (a + b - 1) / b;
}

int64_t qpad_of(int64_t q_len) { return ceil_div(q_len, kTile) * kTile; }

// -- cp.async -----------------------------------------------------------------
__device__ __forceinline__ void cp_async(float* dst, const float* src, bool ok,
                                         const float* fallback, int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  const float* g = ok ? src : fallback;      // never read: src-size 0 zero-fills
  const int n = ok ? bytes : 0;
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(g), "r"(n));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(g), "r"(n));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_wait_all_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}
__device__ __forceinline__ void cp_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

// Stage rows x cols of a matrix whose rows lie row_stride floats apart
// (row r0 + r, column c0 + c of base), zero outside row_end x col_end.
template <bool kVec>
__device__ __forceinline__ void load_tile(float* dst, int pitch, const float* base,
                                          int64_t row_stride, int64_t r0,
                                          int64_t row_end, int64_t c0,
                                          int64_t col_end, int rows, int cols) {
  constexpr int kW = kVec ? 4 : 1;
  const int per_row = cols / kW;
  for (int e = threadIdx.x; e < rows * per_row; e += kThreads) {
    const int r = e / per_row, cc = (e % per_row) * kW;
    const bool ok = r0 + r < row_end && c0 + cc < col_end;
    cp_async(dst + r * pitch + cc, base + (r0 + r) * row_stride + c0 + cc, ok, base,
             4 * kW);
  }
}

// -- 3xTF32 ---------------------------------------------------------------------
__device__ __forceinline__ uint32_t tf32_bits(float f) {
  // round to nearest (ties away) at TF32's 10 mantissa bits
  return (__float_as_uint(f) + 0x1000u) & 0xffffe000u;
}
// big = tf32(f); small = f - big (exact in f32), which the tensor cores
// read cut to TF32 (they ignore the low 13 bits)
__device__ __forceinline__ void split(float f, uint32_t& big, uint32_t& small) {
  big = tf32_bits(f);
  small = __float_as_uint(f - __uint_as_float(big));
}
__device__ __forceinline__ void mma_tf32(float (&d)[4], uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}
// d += a.b, a (16 x 8) given split (it is reused across the n tiles of a
// k step) and b (8 x 8) as its two f32 fragment values: the three products
// into a zeroed accumulator, then added to d rounded to nearest
__device__ __forceinline__ void mma3_split(float (&d)[4], const uint32_t (&ab)[4],
                                           const uint32_t (&as)[4], float b0,
                                           float b1) {
  uint32_t bb0, bs0, bb1, bs1;
  split(b0, bb0, bs0);
  split(b1, bb1, bs1);
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(t, ab[0], ab[1], ab[2], ab[3], bs0, bs1);
  mma_tf32(t, as[0], as[1], as[2], as[3], bb0, bb1);
  mma_tf32(t, ab[0], ab[1], ab[2], ab[3], bb0, bb1);
#pragma unroll
  for (int e = 0; e < 4; ++e) d[e] = __fadd_rn(d[e], t[e]);
}

// cs[0, rows) = running sum of la for (g, h), in order; cs[rows, qpad) = 0
__device__ void running_sum(float* cs, const float* la, const Dims& d, int64_t g,
                            int64_t h, int64_t rows, int64_t qpad) {
  for (int64_t r = threadIdx.x; r < qpad; r += kThreads)
    cs[r] = r < rows ? la[(g * d.q + r) * d.h + h] : 0.f;
  __syncthreads();
  if (threadIdx.x == 0) {
    float acc = 0.f;
    for (int64_t r0 = 0; r0 < rows; r0 += 32) {
      float v[32];
#pragma unroll
      for (int k = 0; k < 32; ++k) v[k] = cs[r0 + k];   // qpad is a multiple of 64
#pragma unroll
      for (int k = 0; k < 32; ++k) {
        if (r0 + k < rows) acc = __fadd_rn(acc, v[k]);
        v[k] = acc;
      }
#pragma unroll
      for (int k = 0; k < 32; ++k)
        if (r0 + k < rows) cs[r0 + k] = v[k];
    }
  }
  __syncthreads();
}

// -- 1. the group scores -------------------------------------------------------------
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
ssd_scores_kernel(const float* __restrict__ b, const float* __restrict__ c,
                  float* __restrict__ scores, Dims d) {
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane >> 2, tig = lane & 3;
  const int r_lo = 16 * warp + gid, r_hi = r_lo + 8;
  // block -> (pair, chunk, group); pair -> (row tile, column tile <= it)
  const int64_t per_pair = d.g * d.hg;
  const int pair = (int)(blockIdx.x / per_pair);
  const int64_t gg = blockIdx.x % per_pair;             // g * Hg + group
  int it = 0;
  while ((it + 1) * (it + 2) / 2 <= pair) ++it;
  const int jt = pair - it * (it + 1) / 2;
  const int64_t i0 = (int64_t)it * kTile, j0 = (int64_t)jt * kTile;
  const int64_t g = gg / d.hg, hg = gg % d.hg;
  const float* bg = b + (g * d.q * d.hg + hg) * d.n;   // row j at bg + j * Hg * N
  const float* cg = c + (g * d.q * d.hg + hg) * d.n;
  const int nk = (int)ceil_div(d.n, kSlice);
  const int live = it == jt ? 2 * warp + 2 : 8;         // column blocks of 8 needed

  auto issue = [&](int k) {
    float* buf = smem + (k & 1) * kScoreStage;
    load_tile<kVec>(buf, kCPitch, cg, d.hg * d.n, i0, d.q, k * kSlice, d.n, kTile, kSlice);
    load_tile<kVec>(buf + kTile * kCPitch, kCPitch, bg, d.hg * d.n, j0, d.q, k * kSlice,
                    d.n, kTile, kSlice);
    cp_commit();
  };

  float acc[8][4];
#pragma unroll
  for (int t = 0; t < 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;
  issue(0);
  for (int k = 0; k < nk; ++k) {
    if (k + 1 < nk) {
      issue(k + 1);
      cp_wait_all_but_one();
    } else {
      cp_wait_all();
    }
    __syncthreads();
    const float* cs_ = smem + (k & 1) * kScoreStage;
    const float* bs_ = cs_ + kTile * kCPitch;
#pragma unroll
    for (int kk = 0; kk < kSlice; kk += 8) {
      uint32_t ab[4], as[4];
      split(cs_[r_lo * kCPitch + kk + tig], ab[0], as[0]);
      split(cs_[r_hi * kCPitch + kk + tig], ab[1], as[1]);
      split(cs_[r_lo * kCPitch + kk + tig + 4], ab[2], as[2]);
      split(cs_[r_hi * kCPitch + kk + tig + 4], ab[3], as[3]);
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        if (t < live) {
          const float* br = bs_ + (t * 8 + gid) * kCPitch + kk + tig;
          mma3_split(acc[t], ab, as, br[0], br[4]);
        }
      }
    }
    __syncthreads();
  }
  float* out = scores + ((int64_t)pair * per_pair + gg) * (kTile * kTile);
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    *reinterpret_cast<float2*>(out + r_lo * kTile + t * 8 + 2 * tig) =
        make_float2(acc[t][0], acc[t][1]);
    *reinterpret_cast<float2*>(out + r_hi * kTile + t * 8 + 2 * tig) =
        make_float2(acc[t][2], acc[t][3]);
  }
}

// -- 2a. one 64-row tile of Y -----------------------------------------------------------
template <bool kVec>
__device__ void y_tile(const float* __restrict__ x, const float* __restrict__ scores,
                       const float* __restrict__ la, float* __restrict__ y, float* stage,
                       float* cs, const Dims& d, int64_t g, int64_t h, int tile) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane >> 2, tig = lane & 3;
  const int r_lo = 16 * warp + gid, r_hi = r_lo + 8;   // rows of this thread in the tile
  const int64_t i0 = (int64_t)tile * kTile;
  const int64_t hg = h / (d.h / d.hg);
  const int64_t qpad = ceil_div(d.q, kTile) * kTile;
  const float* xg = x + (g * d.q * d.h + h) * d.p;     // row j at xg + j * H * P
  // this row's score tiles: pairs tile (tile + 1) / 2 + j, j = 0 .. tile
  const float* srow = scores + ((int64_t)tile * (tile + 1) / 2 * d.g * d.hg + g * d.hg + hg) *
                                   (kTile * kTile);
  const int64_t pair_stride = d.g * d.hg * kTile * kTile;
  // a step is (p tile, j tile): the score tile and the X tile
  const int n_j = tile + 1;
  const int steps = (int)ceil_div(d.p, kTile) * n_j;
  auto advance = [&](Step t) {
    if (++t.b == n_j) t.b = 0, ++t.a;
    return t;
  };
  auto issue = [&](int s, Step t) {
    float* buf = stage + (s & 1) * kStage;
    load_tile<true>(buf, kSPitch, srow + t.b * pair_stride, kTile, 0, kTile, 0, kTile, kTile,
                    kTile);
    load_tile<kVec>(buf + kTile * kSPitch, kXPitch, xg, d.h * d.p, (int64_t)t.b * kTile, d.q,
                    (int64_t)t.a * kTile, d.p, kTile, kTile);
    cp_commit();
  };

  Step cur{0, 0, 0};
  issue(0, cur);
  running_sum(cs, la, d, g, h, i0 + kTile < d.q ? i0 + kTile : d.q, qpad);

  float acc[8][4];
#pragma unroll
  for (int u = 0; u < 8; ++u)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[u][e] = 0.f;
  const int64_t i_lo = i0 + r_lo, i_hi = i0 + r_hi;

  for (int s = 0; s < steps; ++s) {
    const Step nxt = advance(cur);
    if (s + 1 < steps) {
      issue(s + 1, nxt);
      cp_wait_all_but_one();
    } else {
      cp_wait_all();
    }
    __syncthreads();
    const float* ss = stage + (s & 1) * kStage;
    const float* xs = ss + kTile * kSPitch;
    const int64_t p0 = (int64_t)cur.a * kTile, j0 = (int64_t)cur.b * kTile;
    cur = nxt;
    const bool diag = j0 == i0;
    const int live = diag ? 2 * warp + 2 : 8;          // k steps of 8 at or below the rows
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      if (t < live) {
        // A-fragment k slot tig | tig+4 <- column j = 8t + 2tig | 8t + 2tig + 1
        const int jj = t * 8 + 2 * tig;
        const float2 lo = *reinterpret_cast<const float2*>(ss + r_lo * kSPitch + jj);
        const float2 hi = *reinterpret_cast<const float2*>(ss + r_hi * kSPitch + jj);
        const int64_t ja = j0 + jj, jb = ja + 1;
        const float a[4] = {
            (ja <= i_lo && i_lo < d.q) ? lo.x * expf(cs[i_lo] - cs[ja]) : 0.f,
            (ja <= i_hi && i_hi < d.q) ? hi.x * expf(cs[i_hi] - cs[ja]) : 0.f,
            (jb <= i_lo && i_lo < d.q) ? lo.y * expf(cs[i_lo] - cs[jb]) : 0.f,
            (jb <= i_hi && i_hi < d.q) ? hi.y * expf(cs[i_hi] - cs[jb]) : 0.f};
        uint32_t ab[4], as[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) split(a[k], ab[k], as[k]);
        const float* x0 = xs + jj * kXPitch + gid;
#pragma unroll
        for (int u = 0; u < 8; ++u)        // n tiles of 8 columns p
          mma3_split(acc[u], ab, as, x0[u * 8], x0[kXPitch + u * 8]);
      }
    }
    if (diag) {                              // the last j tile of this p tile
#pragma unroll
      for (int u = 0; u < 8; ++u) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int64_t i = e < 2 ? i_lo : i_hi;
          const int64_t p = p0 + u * 8 + 2 * tig + (e & 1);
          if (i < d.q && p < d.p) y[((g * d.q + i) * d.h + h) * d.p + p] = acc[u][e];
          acc[u][e] = 0.f;
        }
      }
    }
    __syncthreads();
  }
}

// -- 2b. the chunk state ----------------------------------------------------------
template <bool kVec>
__device__ void state_tile(const float* __restrict__ x, const float* __restrict__ b,
                           const float* __restrict__ la, float* __restrict__ state,
                           float* stage, float* cs, float* dec, const Dims& d, int64_t g,
                           int64_t h) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane >> 2, tig = lane & 3;
  const int r_lo = 16 * warp + gid, r_hi = r_lo + 8;   // rows n of this thread in the tile
  const int64_t hg = h / (d.h / d.hg);
  const int64_t qpad = ceil_div(d.q, kTile) * kTile;
  const float* xg = x + (g * d.q * d.h + h) * d.p;
  const float* bg = b + (g * d.q * d.hg + hg) * d.n;
  // a step is (n tile, p tile, j tile), the j tile fastest
  const int n_jt = (int)ceil_div(d.q, kTile);
  const int n_pt = (int)ceil_div(d.p, kTile);
  const int steps = (int)ceil_div(d.n, kTile) * n_pt * n_jt;
  auto advance = [&](Step t) {
    if (++t.c == n_jt) {
      t.c = 0;
      if (++t.b == n_pt) t.b = 0, ++t.a;
    }
    return t;
  };
  auto issue = [&](int s, Step t) {
    float* buf = stage + (s & 1) * kStage;
    const int64_t j0 = (int64_t)t.c * kTile;
    load_tile<kVec>(buf, kXPitch, bg, d.hg * d.n, j0, d.q, (int64_t)t.a * kTile, d.n, kTile,
                    kTile);
    load_tile<kVec>(buf + kTile * kXPitch, kXPitch, xg, d.h * d.p, j0, d.q,
                    (int64_t)t.b * kTile, d.p, kTile, kTile);
    cp_commit();
  };

  Step cur{0, 0, 0};
  issue(0, cur);
  running_sum(cs, la, d, g, h, d.q, qpad);
  const float cs_last = cs[d.q - 1];
  for (int64_t r = threadIdx.x; r < qpad; r += kThreads)
    dec[r] = r < d.q ? expf(cs_last - cs[r]) : 0.f;
  // the first __syncthreads of the loop publishes dec

  float acc[8][4];
#pragma unroll
  for (int u = 0; u < 8; ++u)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[u][e] = 0.f;

  for (int s = 0; s < steps; ++s) {
    const Step nxt = advance(cur);
    if (s + 1 < steps) {
      issue(s + 1, nxt);
      cp_wait_all_but_one();
    } else {
      cp_wait_all();
    }
    __syncthreads();
    const float* bs = stage + (s & 1) * kStage;
    const float* xs = bs + kTile * kXPitch;
    const int64_t n0 = (int64_t)cur.a * kTile, p0 = (int64_t)cur.b * kTile;
    const int64_t j0 = (int64_t)cur.c * kTile;
    const bool last_j = cur.c == n_jt - 1;
    cur = nxt;
#pragma unroll
    for (int t = 0; t < kTile / 8; ++t) {
      // A = (B . dec)^T: row n, k slot (tig | tig+4) <- j = 2tig | 2tig+1
      const int j = t * 8 + 2 * tig;
      const float d0 = dec[j0 + j], d1 = dec[j0 + j + 1];
      const float* b0 = bs + j * kXPitch;
      const float a[4] = {b0[r_lo] * d0, b0[r_hi] * d0, b0[kXPitch + r_lo] * d1,
                          b0[kXPitch + r_hi] * d1};
      uint32_t ab[4], as[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) split(a[k], ab[k], as[k]);
      const float* x0 = xs + j * kXPitch + gid;
#pragma unroll
      for (int u = 0; u < 8; ++u)
        mma3_split(acc[u], ab, as, x0[u * 8], x0[kXPitch + u * 8]);
    }
    if (last_j) {                            // the last j tile of this (n, p) tile
#pragma unroll
      for (int u = 0; u < 8; ++u) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int64_t n = n0 + (e < 2 ? r_lo : r_hi);
          const int64_t p = p0 + u * 8 + 2 * tig + (e & 1);
          if (n < d.n && p < d.p) state[((g * d.h + h) * d.n + n) * d.p + p] = acc[u][e];
          acc[u][e] = 0.f;
        }
      }
    }
    __syncthreads();
  }
}

// three blocks an SM: their stages fill its shared memory (3 x 73.7 KB at
// Q = 256), and ptxas may then use up to 168 registers a thread
template <bool kVec>
__global__ void __launch_bounds__(kThreads, 3)
ssd_chunk_kernel(const float* __restrict__ x, const float* __restrict__ b,
                 const float* __restrict__ la, const float* __restrict__ scores,
                 float* __restrict__ y, float* __restrict__ state, Dims d) {
  extern __shared__ __align__(16) float smem[];
  const int64_t qpad = ceil_div(d.q, kTile) * kTile;
  float* stage = smem;
  float* cs = smem + 2 * kStage;
  float* dec = cs + qpad;

  // block -> (kind, chunk, head); kinds heaviest first: the last Y tile,
  // the state, then the Y tiles before the last, last to first
  const int64_t per_kind = d.g * d.h;
  const int64_t kind = blockIdx.x / per_kind;
  const int64_t g = (blockIdx.x % per_kind) / d.h;
  const int64_t h = blockIdx.x % d.h;
  const int n_yt = (int)ceil_div(d.q, kTile);
  if (kind == 1) {
    state_tile<kVec>(x, b, la, state, stage, cs, dec, d, g, h);
  } else {
    y_tile<kVec>(x, scores, la, y, stage, cs, d, g, h,
                 kind == 0 ? n_yt - 1 : n_yt - (int)kind);
  }
}

// Above 48 KB a block's dynamic shared memory must be allowed explicitly;
// allow the card's whole opt-in limit once per kernel (it does not change
// occupancy, which follows the size each launch asks for).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int* limit) {
  if (*limit >= 0) return cudaSuccess;
  int dev = 0, lim = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&lim, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, lim);
  if (err == cudaSuccess) *limit = lim;
  return err;
}

template <bool kVec>
cudaError_t launch(const float* x, const float* b, const float* c, const float* la,
                   float* y, float* state, float* scores, const Dims& d,
                   cudaStream_t stream) {
  static int limit = -1;
  cudaError_t err = allow_smem(ssd_chunk_kernel<kVec>, &limit);
  if (err != cudaSuccess) return err;
  const int64_t n_yt = ceil_div(d.q, kTile);
  const int64_t pairs = n_yt * (n_yt + 1) / 2;
  const size_t smem = sizeof(float) * (2 * (size_t)kStage + 2 * (size_t)qpad_of(d.q));
  const int64_t score_blocks = pairs * d.g * d.hg;
  const int64_t blocks = (n_yt + 1) * d.g * d.h;
  if (smem > (size_t)limit || blocks > INT_MAX || score_blocks > INT_MAX)
    return cudaErrorInvalidValue;
  ssd_scores_kernel<kVec><<<(unsigned int)score_blocks, kThreads,
                            sizeof(float) * 2 * kScoreStage, stream>>>(b, c, scores, d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_chunk_kernel<kVec><<<(unsigned int)blocks, kThreads, smem, stream>>>(x, b, la, scores,
                                                                          y, state, d);
  return cudaGetLastError();
}

}  // namespace

// The scratch buffer ssd_chunk_f32 needs for these dimensions, in floats.
extern "C" int64_t ssd_chunk_scratch_floats(int64_t chunks, int64_t q_len,
                                            int64_t groups) {
  const int64_t n_yt = ceil_div(q_len, kTile);
  return n_yt * (n_yt + 1) / 2 * chunks * groups * kTile * kTile;
}

extern "C" int ssd_chunk_f32(const float* x, const float* b, const float* c,
                             const float* la, float* y, float* state, float* scores,
                             int64_t chunks, int64_t q_len, int64_t heads,
                             int64_t groups, int64_t p_dim, int64_t n_dim,
                             int vec, void* stream) {
  if (groups <= 0 || heads % groups != 0) return (int)cudaErrorInvalidValue;
  const Dims d{chunks, q_len, heads, groups, p_dim, n_dim};
  const cudaStream_t st = (cudaStream_t)stream;
  return (int)(vec ? launch<true>(x, b, c, la, y, state, scores, d, st)
                   : launch<false>(x, b, c, la, y, state, scores, d, st));
}
