// Theorem-2 solve over the client vector: (gains, Z) -> (q, P).
//
// Replaces the Pallas TPU kernel src/repro/kernels/scheduler_solve.py
// (scheduler_solve, body _solve_block). Like that kernel it takes the
// scalars of the configs directly and forms the Eq. 16 argument as
// v*lam*ell*gains*LN2 / (noise*bandwidth*zs), the host folding the pure
// scalar products as Python folds them; the fused kernel uses the
// SolveCoeffs form a_coef*gains/zs instead, so the two differ by ulps,
// exactly as their references do.
//
// Bound on the card: one thread per lane, 8 B read and 8 B written per
// lane. At the paper's N = 100 the launch latency is all there is; at
// N ~ 1e6 it is memory (16 B/lane), with ~10 transcendentals and the
// Halley divisions per lane well under the f32 rate. The design therefore
// does one pass, keeps every intermediate in registers, uses a grid-stride
// loop with a bounds check instead of the TPU's padded blocks (no pad
// lanes are ever materialised), and coalesced 4-byte loads and stores.
// scheduler_solve_launch_floor below is an empty kernel with the same
// arguments and grid: the least time a launch of this kernel can take.
#include "theorem2.cuh"

namespace {

__global__ void scheduler_solve_kernel(const float* __restrict__ gains,
                                       const float* __restrict__ z,
                                       float* __restrict__ q,
                                       float* __restrict__ p, int64_t n,
                                       float vle, float ln2, float nb,
                                       t2::SolveScalars s) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    const float g = gains[i];
    const float zz = z[i];
    const float zs = t2::max_nan(zz, t2::kEps);
    const float a = ((vle * g) * ln2) / (nb * zs);
    t2::solve(g, zz, a, s, &q[i], &p[i]);
  }
}

__global__ void scheduler_solve_launch_floor_kernel(
    const float* __restrict__, const float* __restrict__, float* __restrict__,
    float* __restrict__, int64_t, float, float, float, t2::SolveScalars) {}

t2::SolveScalars solve_scalars(const float* scalars) {
  return t2::SolveScalars{scalars[3], scalars[4],  scalars[5],
                          scalars[6], scalars[7],  scalars[8],
                          scalars[9], scalars[10], scalars[11],
                          scalars[12]};
}

}  // namespace

// scalars (host memory, 13 floats): v*lam*ell, LN2, noise*bandwidth, then
// n0, bw, p_max, lam*ell*n, n/v, q_floor, n, lam*ell, v, p_bar, each
// already rounded to float32. Returns cudaGetLastError() after the launch.
extern "C" int scheduler_solve_f32(const float* gains, const float* z,
                                   float* q, float* p, long long n,
                                   const float* scalars, void* stream) {
  scheduler_solve_kernel<<<t2::grid_for(n), t2::kThreads, 0,
                           (cudaStream_t)stream>>>(
      gains, z, q, p, (int64_t)n, scalars[0], scalars[1], scalars[2],
      solve_scalars(scalars));
  return (int)cudaGetLastError();
}

// The launch floor: scheduler_solve_f32's arguments and grid, an empty
// kernel.
extern "C" int scheduler_solve_launch_floor(const float* gains,
                                            const float* z, float* q,
                                            float* p, long long n,
                                            const float* scalars,
                                            void* stream) {
  scheduler_solve_launch_floor_kernel<<<t2::grid_for(n), t2::kThreads, 0,
                                        (cudaStream_t)stream>>>(
      gains, z, q, p, (int64_t)n, scalars[0], scalars[1], scalars[2],
      solve_scalars(scalars));
  return (int)cudaGetLastError();
}
