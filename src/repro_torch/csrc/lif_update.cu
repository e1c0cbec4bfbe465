// K1: fused LIF update, v' = (i + alpha*v) - z*v_th, z' = [v' >= v_th];
// and the population step around it, one launch a population and step.
//
// Replaces the TPU kernel src/repro/kernels/lif_update/kernel.py
// (lif_update_pallas / _lif_kernel), which runs over (N, B) VMEM tiles.
//
// Bound on the H100: device-memory bytes.  Each element reads three f32
// (i, v, z) and writes two (v', z'): 20 bytes for 5 flops, far below the
// card's flop-per-byte balance.  At the gesture path's shapes (a few
// hundred elements) one launch is all latency.
//
// lif_update_kernel: an elementwise map does not care about layout, so the
// executor keeps v and z in its batch-major (B, N) carry and passes flat
// contiguous buffers; one thread per element, neighbouring threads on
// neighbouring addresses (coalesced).  Every step is a separately rounded
// f32 op (__fmul_rn / __fadd_rn / __fsub_rn, and the build passes
// --fmad=false): the reference evaluates the same expression without fused
// multiply-add, and with a non-dyadic alpha (0.9) an FMA rounds differently
// and can flip a spike at threshold.
//
// lif_step_kernel (the executor's population step): at the path's shapes
// the update itself is all launch latency, and the eager ops around it
// (summing the in-edges' currents, the serial edges' delay-ring roll, add,
// copy-out and zero fill, the f32/int8 casts of the spike carry, the copy
// into the output train) were about 11 of a step's 15 device launches.  One
// launch does all of it.  Thread k = b*N + n over the batch-major carry:
//   1. for each in-edge in order, its current at (b, n): a current edge
//      (a parallel projection's (B, N) output) is read through its strides;
//      a ring edge (a serial projection) first adds its update into its own
//      (d_slots, B, N) delay ring, ring[(d + shift) mod d_slots] += upd[d]
//      for every d (upd read through three strides, without a copy), then
//      takes slot t mod d_slots as its current and zeroes it.  No two
//      threads touch one ring element, so the read-modify-writes need no
//      atomics; a thread loads all its slots and updates before it stores
//      any, up to 8 slots (see deliver).  The mods are floor-mods (C's % truncates);
//   2. sums the currents in in-edge order (exact: every current is an f32
//      integer under the int8-weight invariant, but the order is kept);
//   3. fires with the update above, reading v (f32) and z (int8) from the
//      carry and writing both back in place;
//   4. writes the f32 spike into the population's output row.
// The edge descriptors (at most kMaxEdges) travel by value in the launch's
// parameters (__grid_constant__): nothing is allocated, copied to the
// device or read back, so a step can be captured in a CUDA graph.  A
// population with more in-edges takes several launches: each but the last
// writes its partial sum into the spike row instead of firing (fire == 0),
// and the next one reads that row as its first, current, edge, so the sum
// keeps the in-edge order.  Bytes per element: 4 a current edge,
// 12*d_slots a ring edge (each slot read and written once, the current
// one written as 0, and one update read a slot), 8 for v, 2 for z, 4 for
// the spike row.
#include <cstdint>
#include <cuda_runtime.h>

__device__ __forceinline__ float lif_fire(float i, float alpha, float v, float z,
                                          float v_th) {
  return __fsub_rn(__fadd_rn(i, __fmul_rn(alpha, v)), __fmul_rn(z, v_th));
}

__global__ void lif_update_kernel(const float* __restrict__ i,
                                  const float* __restrict__ v,
                                  const float* __restrict__ z,
                                  float* __restrict__ v_out,
                                  float* __restrict__ z_out,
                                  int64_t n, float alpha, float v_th) {
  int64_t k = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n) return;
  float vn = lif_fire(i[k], alpha, v[k], z[k], v_th);
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

constexpr int kMaxEdges = 8;

// One in-edge of a population.  ring == nullptr: a current edge, upd is its
// (B, N) current with strides (s1, s2).  Otherwise a ring edge: ring is the
// contiguous (d_slots, B, N) delay ring and upd the (d_slots, B, N) update
// with strides (s0, s1, s2), landing `shift` slots on.  The Python wrapper
// mirrors this layout (seven 8-byte fields) with ctypes.
struct Edge {
  const float* upd;
  float* ring;
  int64_t s0, s1, s2;
  int64_t shift;
  int64_t d_slots;
};

struct StepParams {
  Edge edge[kMaxEdges];
  float* v;
  int8_t* z;
  float* out;
  int64_t batch, n, t;
  float alpha, v_th;
  int n_edges;
  int fire;          // 0: write the summed current into out, touch no carry
};

__device__ __forceinline__ int64_t floor_mod(int64_t a, int64_t m) {
  const int64_t r = a % m;
  return r < 0 ? r + m : r;
}

// A ring of D <= 8 slots (D a template constant, so the slots sit in
// registers): the thread loads every slot and the update landing in it
// (slot j takes upd[(j - shift) mod D]) before it stores anything, so the
// loads are in flight together; a slot-by-slot read-modify-write waits a
// memory round trip a slot, since the compiler cannot tell the ring from
// the update.  Same f32 adds on the same operands, and the current slot is
// taken from its sum and stored as 0: bitwise the slot-by-slot sequence,
// which deeper rings run as it stands (lif_step_kernel).
template <int D>
__device__ __forceinline__ float deliver(const Edge& E, const float* upd,
                                         float* ring, int64_t plane,
                                         int64_t t) {
  const int s = (int)floor_mod(E.shift, D), now = (int)floor_mod(t, D);
  float x[D];
#pragma unroll
  for (int j = 0; j < D; ++j)
    x[j] = __fadd_rn(ring[j * plane], upd[(j >= s ? j - s : j - s + D) * E.s0]);
  float cur = 0.0f;
#pragma unroll
  for (int j = 0; j < D; ++j) {
    if (j == now) cur = x[j];
    ring[j * plane] = j == now ? 0.0f : x[j];
  }
  return cur;
}

// Slot by slot, for rings deeper than 8.
__device__ __forceinline__ float deliver_deep(const Edge& E, const float* upd,
                                              float* ring, int64_t plane,
                                              int64_t t) {
  for (int64_t d = 0; d < E.d_slots; ++d) {
    float* slot = ring + floor_mod(d + E.shift, E.d_slots) * plane;
    *slot = __fadd_rn(*slot, upd[d * E.s0]);
  }
  float* now = ring + floor_mod(t, E.d_slots) * plane;
  const float cur = *now;
  *now = 0.0f;
  return cur;
}

__global__ void lif_step_kernel(const __grid_constant__ StepParams p) {
  const int64_t k = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t plane = p.batch * p.n;
  if (k >= plane) return;
  const int64_t b = k / p.n, n = k - b * p.n;
  // no edge's buffers overlap the carry, so its loads go out first
  const float v = p.v[k], z = p.z[k] ? 1.0f : 0.0f;
  float i = 0.0f;
  for (int e = 0; e < p.n_edges; ++e) {
    const Edge& E = p.edge[e];
    const float* upd = E.upd + b * E.s1 + n * E.s2;
    float* ring = E.ring + k;
    float cur;
    if (E.ring == nullptr) {                           // a current edge
      cur = *upd;
    } else switch (E.d_slots) {
      case 1: cur = deliver<1>(E, upd, ring, plane, p.t); break;
      case 2: cur = deliver<2>(E, upd, ring, plane, p.t); break;
      case 3: cur = deliver<3>(E, upd, ring, plane, p.t); break;
      case 4: cur = deliver<4>(E, upd, ring, plane, p.t); break;
      case 5: cur = deliver<5>(E, upd, ring, plane, p.t); break;
      case 6: cur = deliver<6>(E, upd, ring, plane, p.t); break;
      case 7: cur = deliver<7>(E, upd, ring, plane, p.t); break;
      case 8: cur = deliver<8>(E, upd, ring, plane, p.t); break;
      default: cur = deliver_deep(E, upd, ring, plane, p.t);
    }
    i = e == 0 ? cur : __fadd_rn(i, cur);
  }
  if (!p.fire) {                       // a partial sum for the next launch
    p.out[k] = i;
    return;
  }
  const float vn = lif_fire(i, p.alpha, v, z, p.v_th);
  const bool fired = vn >= p.v_th;
  p.v[k] = vn;
  p.z[k] = fired ? 1 : 0;
  p.out[k] = fired ? 1.0f : 0.0f;
}

// edges: n_edges (<= kMaxEdges) descriptors in host memory, copied into the
// launch's parameters.  fire != 0: v (B, N) f32 and z (B, N) int8 are
// updated in place and out is the (B, N) f32 spike row; fire == 0: out
// takes the summed current and v, z are left as they are.  batch * n > 0.
extern "C" int lif_step_f32(const Edge* edges, int n_edges, float* v, int8_t* z,
                            float* out, int64_t batch, int64_t n, int64_t t,
                            float alpha, float v_th, int fire, void* stream) {
  if (n_edges < 0 || n_edges > kMaxEdges) return (int)cudaErrorInvalidValue;
  StepParams p;
  for (int e = 0; e < n_edges; ++e) p.edge[e] = edges[e];
  p.v = v, p.z = z, p.out = out;
  p.batch = batch, p.n = n, p.t = t;
  p.alpha = alpha, p.v_th = v_th;
  p.n_edges = n_edges;
  p.fire = fire;
  const int threads = 256;
  const int64_t blocks = (batch * n + threads - 1) / threads;
  lif_step_kernel<<<(unsigned int)blocks, threads, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

__global__ void empty_kernel() {}

// One launch of a kernel that does nothing: graph-replayed, its device time
// is the card's floor for any launch (the lif_step rows are held against it).
extern "C" int empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
