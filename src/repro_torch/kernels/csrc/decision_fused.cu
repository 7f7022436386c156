// Fused per-round decision over the client vector: Theorem-2 solve,
// activity mask, Bernoulli selection, Eq. 9 queue update and the per-lane
// accounting summands, in one pass.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/decision_fused.py:
// decision_fused (one (N,) client vector, its 14 operands by value) and
// decision_fused_batched (the service's (B, N) bucket rows, one operand row
// each, in device memory); both run the lanes of _decision_lanes, here
// decide(). The 14 operands are the reference's packed vector: SolveCoeffs'
// 11 fields in declaration order, then AccountCoeffs' ell, bw, n0. The
// guarantee-one fallback (a global argmax per row) and the accounting folds
// stay outside, as in the reference.
//
// What bounds it on this card, three floors (chip_smoke.py prints each
// beside the kernel's time):
// - bytes: 12 B read (gains, Z, u; each mask 1 B more) and 21 B written
//   (sel as 1 byte, q, P, Z', tc, pq) per lane, 33-34 B, and 56 B of
//   operands per row;
// - issue: the bit-exact contract (-fmad=false; IEEE expf, logf, log2f,
//   sqrtf and division, each division a branch around its slow path; the
//   reference's op order) fixes 739 (K2) and 762 (K3) SASS instructions of
//   a lane's main path (cuobjdump, sm_90a), so at 2^20 lanes the four
//   schedulers of 132 SMs need over twice the byte bound's time just to
//   issue them;
// - launch: decision_launch_floor below, an empty kernel with the batched
//   kernel's arguments and grid. At the service's 32 K lanes and the
//   paper's N = 100 the launch and one lane's dependent chain are all
//   there is.
//
// What the design does about them:
// - One templated body for both kernels, <kActive, kValid, kRowOps>: the
//   masks are compile-time, as in the reference's _make_kernel; K2 is one
//   row with its operands in the kernel's parameters (uniform registers),
//   K3 B rows with theirs in device memory.
// - A row-tiled grid: blockIdx.y is the row (rows past gridDim.y's limit
//   loop), blockIdx.x a tile of the row. A row's 14 operands are loaded
//   once per block into shared memory; no lane divides an index.
// - One lane a thread, in blocks of at most 128: 32 registers for K2 (K3
//   44-46, its row's operands in registers; capping it spills), so 64 (40)
//   warps an SM hide the latency of each lane's chain, and blocks short
//   enough that rows of 32 spread over every SM. The chain is a string of
//   division regions (convergence barrier, fast path, slow-path call) that
//   ptxas does not schedule across, so several lanes a thread, with wide
//   loads and stores, only added registers and ran slower.
// - tc reuses the rate the solve computed for the kept candidate when the
//   row's accounting bw and n0 are the solve's, bit for bit (a test once
//   per row), and computes it again otherwise: the same value either way.
// Every lane's arithmetic is decide()'s, so the outputs equal the plain
// PyTorch versions bit for bit whatever the grid.
#include "theorem2.cuh"

namespace {

constexpr int kOps = 14;
constexpr int kMaxThreads = 128;

// The unpacked operand vector of one row.
struct DecisionScalars {
  float a_coef;
  t2::SolveScalars s;
  float ell, bw, n0;
};

__device__ __forceinline__ DecisionScalars unpack(const float* v) {
  return DecisionScalars{
      v[0], t2::SolveScalars{v[1], v[2], v[3], v[4], v[5], v[6], v[7], v[8],
                             v[9], v[10]},
      v[11], v[12], v[13]};
}

// True when tc's rate is the solve's: the accounting's bw and n0 are the
// solve's, bit for bit.
__device__ __forceinline__ bool same_rate(const DecisionScalars& d) {
  return __float_as_uint(d.bw) == __float_as_uint(d.s.bw) &&
         __float_as_uint(d.n0) == __float_as_uint(d.s.n0);
}

struct LaneOut {
  float q, p, z_new, tc, pq;
  bool sel;
};

// One lane of the decision, in the reference's op order.
template <bool kActive, bool kValid>
__device__ __forceinline__ LaneOut decide(const DecisionScalars& d,
                                          bool reuse_rate, float g, float z,
                                          float u, bool active, bool valid) {
  const float zs = t2::max_nan(z, t2::kEps);
  const float a = (d.a_coef * g) / zs;
  LaneOut o;
  float r;
  t2::solve(g, z, a, d.s, &o.q, &o.p, &r);
  if (kActive && !active) o.q = 0.0f;
  o.sel = u < o.q;
  o.z_new = t2::max_nan((z + o.p * o.q) - d.s.p_bar, 0.0f);
  if (!reuse_rate) r = t2::rate(g, o.p, d.bw, d.n0);
  o.tc = d.ell / t2::max_nan(r, 1e-9f);
  const float pq = o.p * o.q;
  o.pq = (kValid && !valid) ? 0.0f : pq;
  return o;
}

struct Lanes {
  const float* __restrict__ gains;
  const float* __restrict__ z;
  const float* __restrict__ u;
  const bool* __restrict__ active;   // null unless kActive
  const bool* __restrict__ valid;    // null unless kValid
  const float* __restrict__ row_ops; // (rows, 14); null unless kRowOps
  bool* __restrict__ sel;
  float* __restrict__ q;
  float* __restrict__ p;
  float* __restrict__ z_new;
  float* __restrict__ tc;
  float* __restrict__ pq;
  long long rows, n;  // (rows, n) row-major
};

struct DecisionOps {
  float v[kOps];
};

template <bool kActive, bool kValid>
__device__ __forceinline__ void decide_lane(const Lanes& a,
                                            const DecisionScalars& d,
                                            bool reuse, long long i) {
  const LaneOut o = decide<kActive, kValid>(
      d, reuse, __ldg(a.gains + i), __ldg(a.z + i), __ldg(a.u + i),
      kActive ? a.active[i] : true, kValid ? a.valid[i] : true);
  a.sel[i] = o.sel;
  a.q[i] = o.q;
  a.p[i] = o.p;
  a.z_new[i] = o.z_new;
  a.tc[i] = o.tc;
  a.pq[i] = o.pq;
}

// Thread t of block (bx, by) takes lane bx * blockDim.x + t of rows by,
// by + gridDim.y, ...
template <bool kActive, bool kValid, bool kRowOps>
__global__ void __launch_bounds__(kMaxThreads)
    decision_kernel(const Lanes a, const DecisionOps ops) {
  __shared__ float row_ops[kOps];
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  DecisionScalars d;
  bool reuse = false;
  if (!kRowOps) {
    d = unpack(ops.v);
    reuse = same_rate(d);
  }
  for (long long r = blockIdx.y; r < a.rows; r += gridDim.y) {
    if (kRowOps) {
      __syncthreads();  // the previous row's operands are read
      if (threadIdx.x < kOps)
        row_ops[threadIdx.x] = a.row_ops[r * kOps + threadIdx.x];
      __syncthreads();
      d = unpack(row_ops);
      reuse = same_rate(d);
    }
    if (j < a.n) decide_lane<kActive, kValid>(a, d, reuse, r * a.n + j);
  }
}

__global__ void decision_launch_floor_kernel(const Lanes, const DecisionOps) {}

using Kernel = void (*)(const Lanes, const DecisionOps);

template <bool kRowOps>
Kernel pick(bool active, bool valid) {
  if (active)
    return valid ? decision_kernel<true, true, kRowOps>
                 : decision_kernel<true, false, kRowOps>;
  return valid ? decision_kernel<false, true, kRowOps>
               : decision_kernel<false, false, kRowOps>;
}

// out: the (5, rows, n) slab of q, P, Z', tc and pq.
Lanes lanes(const float* gains, const float* z, const float* u,
            const bool* active, const bool* valid, const float* row_ops,
            bool* sel, float* out, long long rows, long long n) {
  const long long total = rows * n;
  return Lanes{gains, z, u, active, valid, row_ops, sel, out,
               out + total, out + 2 * total, out + 3 * total,
               out + 4 * total, rows, n};
}

// Blocks are whole warps, at least 32 threads so the first 14 load a row's
// operands; the grid covers every lane of a row (grid_x * block >= n), and
// rows past grid_y are reached through the row loop.
int launch(Kernel kernel, const Lanes& a, const DecisionOps& ops, int block,
           unsigned grid_x, unsigned grid_y, void* stream) {
  if (block < 32 || block > kMaxThreads || block % 32 != 0 || grid_y < 1 ||
      grid_y > 65535 ||
      (long long)grid_x * block < a.n)
    return (int)cudaErrorInvalidConfiguration;
  kernel<<<dim3(grid_x, grid_y), block, 0, (cudaStream_t)stream>>>(a, ops);
  return (int)cudaGetLastError();
}

}  // namespace

// Lanes (n,), out the (5, n) slab of q, P, Z', tc and pq; ops: host
// memory, the 14 float32 operands (copied into the launch's parameters).
// active/valid may be null (all lanes on). block and grid_x are the
// wrapper's launch plan. Returns cudaGetLastError() after the launch.
extern "C" int decision_fused_f32(const float* gains, const float* z,
                                  const float* u, const bool* active,
                                  const bool* valid, bool* sel, float* out,
                                  long long n, const float* ops, int block,
                                  unsigned grid_x, void* stream) {
  DecisionOps o;
  for (int k = 0; k < kOps; ++k) o.v[k] = ops[k];
  return launch(pick<false>(active != nullptr, valid != nullptr),
                lanes(gains, z, u, active, valid, nullptr, sel, out, 1, n), o,
                block, grid_x, 1, stream);
}

// Every array in device memory: lanes (rows, n) row-major, out the (5,
// rows, n) slab of q, P, Z', tc and pq, ops (rows, 14). valid may be null
// (all lanes on). block, grid_x and grid_y are the wrapper's launch plan.
// Returns cudaGetLastError() after the launch.
extern "C" int decision_fused_batched_f32(const float* gains, const float* z,
                                          const float* u, const float* ops,
                                          const bool* valid, bool* sel,
                                          float* out, long long rows,
                                          long long n, int block,
                                          unsigned grid_x, unsigned grid_y,
                                          void* stream) {
  return launch(pick<true>(false, valid != nullptr),
                lanes(gains, z, u, nullptr, valid, ops, sel, out, rows, n),
                DecisionOps{}, block, grid_x, grid_y, stream);
}

// The launch floor: an empty kernel with decision_fused_batched_f32's
// arguments, launched on the same plan. Its time is what any kernel of
// that grid costs before it does work.
extern "C" int decision_launch_floor(const float* gains, const float* z,
                                     const float* u, const float* ops,
                                     const bool* valid, bool* sel, float* out,
                                     long long rows, long long n, int block,
                                     unsigned grid_x, unsigned grid_y,
                                     void* stream) {
  return launch(decision_launch_floor_kernel,
                lanes(gains, z, u, nullptr, valid, ops, sel, out, rows, n),
                DecisionOps{}, block, grid_x, grid_y, stream);
}
