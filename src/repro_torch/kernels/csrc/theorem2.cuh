// Per-lane Theorem-2 solve shared by the two kernels of this directory.
//
// Every expression keeps the op order of the reference (the Pallas kernels
// and repro/core/scheduler.py) and of the plain PyTorch versions beside the
// wrappers. The build passes -fmad=false so no multiply-add is contracted
// into an FMA: each operation rounds once, as in the reference and in
// PyTorch's eager elementwise kernels. No --use_fast_math: expf, logf,
// log2f, sqrtf and division are the IEEE-accurate library forms; Eq. 17
// uses rsqrtf, the same function torch.rsqrt calls on the card.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace t2 {

constexpr float kEps = 1e-12f;
constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 8192;

// jnp.maximum / jnp.minimum semantics: a NaN operand propagates (fmaxf
// and fminf would drop it).
__device__ __forceinline__ float max_nan(float a, float b) {
  return (isnan(a) || a > b) ? a : b;
}
__device__ __forceinline__ float min_nan(float a, float b) {
  return (isnan(a) || a < b) ? a : b;
}
__device__ __forceinline__ float clip(float x, float lo, float hi) {
  return min_nan(max_nan(x, lo), hi);
}

// The solve's scalars after the Eq. 16 argument a: the fields of
// SolveCoeffs other than a_coef.
struct SolveScalars {
  float n0, bw, p_max, lle_n, n_over_v, q_floor, n, lle, v, p_bar;
};

// W0(z), z >= 0: piecewise initial guess, then four Halley steps with the
// 1e-30 denominator guard (repro/core/lambertw.py).
__device__ __forceinline__ float lambertw0(float z) {
  z = max_nan(z, 0.0f);
  const float safe = max_nan(z, 2.718282f);
  const float lz = logf(safe);
  const float llz = logf(lz);
  const float asym = (lz - llz) + llz / lz;
  const float series = z * ((1.0f - z) + (1.5f * z) * z);
  float w = (z < 1.0f) ? series : asym;
#pragma unroll
  for (int it = 0; it < 4; ++it) {
    const float ew = expf(w);
    const float f = w * ew - z;
    float denom = ew * (w + 1.0f) - ((w + 2.0f) * f) / (2.0f * w + 2.0f);
    denom = (fabsf(denom) < 1e-30f) ? 1e-30f : denom;
    w = w - f / denom;
  }
  return w;
}

__device__ __forceinline__ float rate(float g, float p, float bw, float n0) {
  return bw * log2f(1.0f + (g * p) / n0);
}

// Eq. 17 for a given power, clipped into [q_floor, 1]; r is the power's
// rate(g, p, bw, n0), before its kEps floor.
__device__ __forceinline__ float q_eq17(float r, float p, float z,
                                        const SolveScalars& s) {
  r = max_nan(r, kEps);
  const float inv_sq = s.lle_n / r + (s.n_over_v * z) * p;
  return clip(rsqrtf(max_nan(inv_sq, kEps)), s.q_floor, 1.0f);
}

// Per-client drift-plus-penalty objective of Eq. 15; r as for q_eq17.
__device__ __forceinline__ float objective(float r, float q, float p, float z,
                                           const SolveScalars& s) {
  r = max_nan(r, kEps);
  const float y0 = 1.0f / (s.n * q) + (s.lle * q) / r;
  return s.v * y0 + z * (p * q - s.p_bar);
}

// Interior and boundary candidates from the Eq. 16 argument a; keeps the
// interior one where its objective is finite and not larger. Each
// candidate's rate is computed once, for Eq. 17 and the objective both;
// the kept one's goes to *r_out (before the kEps floor) where asked.
__device__ __forceinline__ void solve(float g, float z, float a,
                                      const SolveScalars& s, float* q_out,
                                      float* p_out, float* r_out = nullptr) {
  const float w = lambertw0(sqrtf(a / 4.0f));
  float p_int = (s.n0 / g) * (a / (4.0f * max_nan(w * w, kEps)) - 1.0f);
  p_int = clip(p_int, 0.0f, s.p_max);
  const float r_int = rate(g, p_int, s.bw, s.n0);
  const float q_int = q_eq17(r_int, p_int, z, s);
  const float p_bnd = s.p_max;
  const float r_bnd = rate(g, p_bnd, s.bw, s.n0);
  const float q_bnd = q_eq17(r_bnd, p_bnd, z, s);
  const float f_int = objective(r_int, q_int, p_int, z, s);
  const float f_bnd = objective(r_bnd, q_bnd, p_bnd, z, s);
  const bool use_int = isfinite(f_int) && (f_int <= f_bnd);
  *q_out = use_int ? q_int : q_bnd;
  *p_out = use_int ? p_int : p_bnd;
  if (r_out != nullptr) *r_out = use_int ? r_int : r_bnd;
}

inline unsigned int grid_for(int64_t n) {
  int64_t blocks = (n + kThreads - 1) / kThreads;
  return (unsigned int)(blocks < kMaxBlocks ? blocks : kMaxBlocks);
}

}  // namespace t2
