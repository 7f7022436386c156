// Fused per-round decision over the client vector: Theorem-2 solve,
// activity mask, Bernoulli selection, Eq. 9 queue update and the per-lane
// accounting summands, in one pass.
//
// Replaces the Pallas TPU kernel src/repro/kernels/decision_fused.py
// (decision_fused, lanes _decision_lanes). The 14 operands are the
// reference's packed vector: SolveCoeffs' 11 fields in declaration order,
// then AccountCoeffs' ell, bw, n0; they travel as a by-value kernel
// argument. The guarantee-one fallback (a global argmax) and the
// accounting folds stay outside, as in the reference.
//
// Bound on the card: 12 B read (gains, Z, u; masks add 1 B each) and 21 B
// written (sel as 1 byte, q, P, Z', tc, pq) per lane, ~10
// transcendentals and the Halley divisions per lane. At the paper's
// N = 100 the launch latency is all there is; at N ~ 1e6 it is memory. One
// thread per lane, a grid-stride loop with a bounds check in place of the
// TPU's padded blocks, intermediates in registers, coalesced stores.
#include "theorem2.cuh"

namespace {

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
  const float a_coef = ops.v[0];
  const t2::SolveScalars s{ops.v[1], ops.v[2], ops.v[3], ops.v[4],
                           ops.v[5], ops.v[6], ops.v[7], ops.v[8],
                           ops.v[9], ops.v[10]};
  const float ell = ops.v[11], acct_bw = ops.v[12], acct_n0 = ops.v[13];
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    const float g = gains[i];
    const float zz = z[i];
    const float zs = t2::max_nan(zz, t2::kEps);
    const float a = (a_coef * g) / zs;
    float q, p;
    t2::solve(g, zz, a, s, &q, &p);
    if (active != nullptr && !active[i]) q = 0.0f;
    sel[i] = u[i] < q;
    q_out[i] = q;
    p_out[i] = p;
    z_out[i] = t2::max_nan((zz + p * q) - s.p_bar, 0.0f);
    tc_out[i] = ell / t2::max_nan(t2::rate(g, p, acct_bw, acct_n0), 1e-9f);
    const float pq = p * q;
    pq_out[i] = (valid != nullptr && !valid[i]) ? 0.0f : pq;
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
