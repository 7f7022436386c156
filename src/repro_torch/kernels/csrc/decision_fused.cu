// Fused per-round decision over the client vector: Theorem-2 solve,
// activity mask, Bernoulli selection, Eq. 9 queue update and the per-lane
// accounting summands, in one pass.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/decision_fused.py:
// decision_fused (one (N,) client vector, here decision_fused_kernel) and
// decision_fused_batched (the service's (B, N) bucket rows, one operand row
// each, here decision_fused_batched_kernel); both share the lanes of
// _decision_lanes, here decide_lane. The 14 operands are the reference's
// packed vector: SolveCoeffs' 11 fields in declaration order, then
// AccountCoeffs' ell, bw, n0. The guarantee-one fallback (a global argmax
// per row) and the accounting folds stay outside, as in the reference.
//
// Bound on the card: 12 B read (gains, Z, u; masks add 1 B each) and 21 B
// written (sel as 1 byte, q, P, Z', tc, pq) per lane, plus 56 B of operands
// per row for the batched form; ~10 transcendentals and the Halley
// divisions per lane. At the service's 32 K-65 K lanes and the paper's
// N = 100 the launch latency is all there is; at N ~ 1e6 it is memory. One
// thread per lane, a grid-stride loop with a bounds check in place of the
// TPU's padded blocks, intermediates in registers, coalesced stores. The
// batched kernel has each lane read its row's operands straight from
// global memory: the lanes of a warp share a row (or two), so the loads
// are broadcasts that L1 serves.
#include "theorem2.cuh"

namespace {

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

// One lane of the decision; the body both kernels run. active/valid may be
// null (all lanes on).
__device__ __forceinline__ void decide_lane(
    int64_t i, const DecisionScalars& d, const float* __restrict__ gains,
    const float* __restrict__ z, const float* __restrict__ u,
    const bool* __restrict__ active, const bool* __restrict__ valid,
    bool* __restrict__ sel, float* __restrict__ q_out,
    float* __restrict__ p_out, float* __restrict__ z_out,
    float* __restrict__ tc_out, float* __restrict__ pq_out) {
  const float g = gains[i];
  const float zz = z[i];
  const float zs = t2::max_nan(zz, t2::kEps);
  const float a = (d.a_coef * g) / zs;
  float q, p;
  t2::solve(g, zz, a, d.s, &q, &p);
  if (active != nullptr && !active[i]) q = 0.0f;
  sel[i] = u[i] < q;
  q_out[i] = q;
  p_out[i] = p;
  z_out[i] = t2::max_nan((zz + p * q) - d.s.p_bar, 0.0f);
  tc_out[i] = d.ell / t2::max_nan(t2::rate(g, p, d.bw, d.n0), 1e-9f);
  const float pq = p * q;
  pq_out[i] = (valid != nullptr && !valid[i]) ? 0.0f : pq;
}

struct DecisionOps {
  float v[14];
};

__global__ void decision_fused_kernel(
    const float* __restrict__ gains, const float* __restrict__ z,
    const float* __restrict__ u, const bool* __restrict__ active,
    const bool* __restrict__ valid, bool* __restrict__ sel,
    float* __restrict__ q_out, float* __restrict__ p_out,
    float* __restrict__ z_out, float* __restrict__ tc_out,
    float* __restrict__ pq_out, int64_t n, DecisionOps ops) {
  const DecisionScalars d = unpack(ops.v);
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    decide_lane(i, d, gains, z, u, active, valid, sel, q_out, p_out, z_out,
                tc_out, pq_out);
  }
}

// (rows, n) row-major lanes; ops is (rows, 14) in device memory.
__global__ void decision_fused_batched_kernel(
    const float* __restrict__ gains, const float* __restrict__ z,
    const float* __restrict__ u, const float* __restrict__ ops,
    const bool* __restrict__ valid, bool* __restrict__ sel,
    float* __restrict__ q_out, float* __restrict__ p_out,
    float* __restrict__ z_out, float* __restrict__ tc_out,
    float* __restrict__ pq_out, int64_t rows, int64_t n) {
  const int64_t total = rows * n;
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
       i < total; i += (int64_t)gridDim.x * blockDim.x) {
    const DecisionScalars d = unpack(ops + (i / n) * 14);
    decide_lane(i, d, gains, z, u, nullptr, valid, sel, q_out, p_out, z_out,
                tc_out, pq_out);
  }
}

}  // namespace

// ops: host memory, the 14 float32 operands. active/valid may be null
// (all lanes on). Returns cudaGetLastError() after the launch.
extern "C" int decision_fused_f32(const float* gains, const float* z,
                                  const float* u, const bool* active,
                                  const bool* valid, bool* sel, float* q,
                                  float* p, float* z_new, float* tc,
                                  float* pq, long long n, const float* ops,
                                  void* stream) {
  DecisionOps o;
  for (int k = 0; k < 14; ++k) o.v[k] = ops[k];
  decision_fused_kernel<<<t2::grid_for(n), t2::kThreads, 0,
                          (cudaStream_t)stream>>>(
      gains, z, u, active, valid, sel, q, p, z_new, tc, pq, (int64_t)n, o);
  return (int)cudaGetLastError();
}

// Every array in device memory: lanes (rows, n) row-major, ops (rows, 14).
// valid may be null (all lanes on). Returns cudaGetLastError() after the
// launch.
extern "C" int decision_fused_batched_f32(const float* gains, const float* z,
                                          const float* u, const float* ops,
                                          const bool* valid, bool* sel,
                                          float* q, float* p, float* z_new,
                                          float* tc, float* pq,
                                          long long rows, long long n,
                                          void* stream) {
  decision_fused_batched_kernel<<<t2::grid_for((int64_t)rows * n),
                                  t2::kThreads, 0, (cudaStream_t)stream>>>(
      gains, z, u, ops, valid, sel, q, p, z_new, tc, pq, (int64_t)rows,
      (int64_t)n);
  return (int)cudaGetLastError();
}
