// Mamba-2 chunked SSD scan: h[t] = exp(dt[t] a) h[t-1] + dt[t] B[t] (x) x[t],
// y[t] = C[t] . h[t], in the chunked dual form (arXiv 2405.21060), with the
// final state written out when the caller asks for it.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan.py (ssd_scan,
// body _ssd_kernel). That kernel runs a (batch, heads, chunks) grid whose
// chunk axis is sequential on the TPU's one core, carrying the (N, P) state
// in VMEM scratch and never writing it out. Here one block owns one
// (batch, head) pair and loops over the chunks itself (blocks run in no
// order, so nothing can carry between them); the state lives in shared
// memory across the loop and, unlike the TPU kernel, is stored after the
// last chunk, which is what lets the serving prefill run this kernel.
// Per chunk, in the TPU kernel's order: g = dt a and its inclusive cumsum
// lc (sequential, one thread); w = where(s <= t, exp(min(lc_t - lc_s, 0)),
// 0), selected and never multiplied by a mask, since exp overflows above
// the diagonal; m = (C_t . B_s) w dt_s; y = m @ x + (C exp(lc)) @ state;
// state = exp(lc_last) state + (B exp(lc_last - lc) dt)^T @ x.
//
// Bound on the card: at the prefill shape (b, S, H, P, N, L) = (4, 2048,
// 24, 64, 128, 128) a call moves ~113 MB (x and y 50 MB each, B and C
// 4 MB each, the state 3 MB): 0.034 ms at 3.35 TB/s; its float32 work,
// counting C.B^T once per (batch, chunk) and the (L, L) products over the
// causal triangle, is ~8.4 GFLOP: 0.125 ms at 67 TFLOP/s. So it is bound
// by operations. This design recomputes C.B^T in every head's block (H
// times the needed work) and runs every product in full float32 on the
// CUDA cores (no TF32, no tensor cores), so it agrees with the plain
// version to float32's tolerance. What it does about the bound:
// - one chunk's x, B, C, the state and m stay in shared memory (dynamic,
//   220 KB at the widths above), so each input byte is read from device
//   memory once;
// - the (L, L) work skips the blocks of columns past the causal diagonal:
//   their m entries are exact zeros for finite inputs, so y sums only
//   s < t0 + 32 (62.5% of the full products at L = 128);
// - each product is an outer-product loop in registers: a warp owns 4
//   rows t (or 32 rows n) and a lane 1-4 columns, so per step one
//   broadcast float4 load of one operand and one conflict-free load per
//   column of the other feed 8-32 products. B rows are padded to N + 1
//   floats and C is stored transposed with rows of L + 4, so the column
//   reads of a warp hit distinct banks and the float4 reads stay aligned;
// - a warp computes m and then y for its own 4 rows, so the tile loop
//   needs no block-wide barrier;
// - the products accumulate with explicit fused multiply-adds (fmaf), one
//   instruction and one rounding per product, as cuBLAS computes the
//   plain version's einsums; the build's -fmad=false, which keeps the
//   decision kernels' separate roundings, does not apply to them.
// One block per (batch, head) gives 96 blocks at the prefill shape, under
// the card's 132 SMs, each with 8 warps: a chunk-parallel design and the
// tensor cores are later work.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 4 * kWarps;  // rows t per tile: 4 per warp
constexpr int kLdm = kTile + 4;    // row of the transposed m tile

// Dynamic shared memory, in floats: C^T (N, L + 4), m^T (L, kLdm), x
// (L, P), B (L, N + 1), the state (N, P + 1), and lc, dt, exp(lc) and the
// B weights (L each). The float4-read arrays come first, each a multiple
// of 4 floats long, so every float4 read is 16-byte aligned.
__host__ __device__ inline int64_t smem_floats(int chunk, int n, int p) {
  return (int64_t)n * (chunk + 4) + (int64_t)chunk * kLdm +
         (int64_t)chunk * p + (int64_t)chunk * (n + 1) +
         (int64_t)n * (p + 1) + 4 * (int64_t)chunk;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__global__ void __launch_bounds__(kThreads)
    ssd_scan_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ a, const float* __restrict__ bm,
                    const float* __restrict__ cm,
                    const float* __restrict__ h0, float* __restrict__ y,
                    float* __restrict__ h_out, int S, int H, int P, int N,
                    int L) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int ldc = L + 4, ldb = N + 1, lds = P + 1;
  float* ct = smem;              // (N, L + 4): C transposed
  float* mt = ct + N * ldc;      // (L, kLdm): m transposed, one tile
  float* xs = mt + L * kLdm;     // (L, P)
  float* bs = xs + L * P;        // (L, N + 1)
  float* st = bs + L * ldb;      // (N, P + 1): the carried state
  float* lc = st + N * lds;      // (L) inclusive cumsum of dt a
  float* dts = lc + L;           // (L)
  float* elc = dts + L;          // (L) exp(lc)
  float* bw = elc + L;           // (L) exp(lc_last - lc) dt

  const float ah = a[h];
  const int64_t hoff = ((int64_t)b * H + h) * N * P;
  for (int e = tid; e < N * P; e += kThreads) {
    const int n = e / P, p = e - n * P;
    st[n * lds + p] = h0 != nullptr ? h0[hoff + e] : 0.0f;
  }

  for (int c = 0; c < S / L; ++c) {
    const int64_t row0 = (int64_t)b * S + (int64_t)c * L;  // (b, t) row
    for (int e = tid; e < L * P; e += kThreads) {
      const int l = e / P, p = e - l * P;
      xs[e] = x[((row0 + l) * H + h) * P + p];
    }
    for (int e = tid; e < L * N; e += kThreads) {
      const int l = e / N, n = e - l * N;
      bs[l * ldb + n] = bm[(row0 + l) * N + n];
      ct[n * ldc + l] = cm[(row0 + l) * N + n];
    }
    for (int l = tid; l < L; l += kThreads) {
      dts[l] = dt[(row0 + l) * H + h];
    }
    __syncthreads();
    if (tid == 0) {
      float acc = dts[0] * ah;
      lc[0] = acc;
      for (int l = 1; l < L; ++l) {
        acc = acc + dts[l] * ah;
        lc[l] = acc;
      }
    }
    __syncthreads();
    const float lc_last = lc[L - 1];
    for (int l = tid; l < L; l += kThreads) {
      elc[l] = expf(lc[l]);
      bw[l] = expf(lc_last - lc[l]) * dts[l];
    }
    __syncthreads();

    // Rows t = t0 + i0 .. t0 + i0 + 3 belong to this warp, in m and in y.
    const int i0 = 4 * warp;
    for (int t0 = 0; t0 < L; t0 += kTile) {
      const int ncols = t0 + kTile;  // columns s past it are masked
      // m[t][s] = (C_t . B_s) * w * dt_s for s = lane + 32 j < ncols
      {
        float acc[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[j][r] = 0.0f;
#pragma unroll 4
        for (int k = 0; k < N; ++k) {
          const float4 c4 = ld4(&ct[k * ldc + t0 + i0]);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (32 * j < ncols) {
              const float bv = bs[(lane + 32 * j) * ldb + k];
              acc[j][0] = fmaf(c4.x, bv, acc[j][0]);
              acc[j][1] = fmaf(c4.y, bv, acc[j][1]);
              acc[j][2] = fmaf(c4.z, bv, acc[j][2]);
              acc[j][3] = fmaf(c4.w, bv, acc[j][3]);
            }
          }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int s = lane + 32 * j;
          if (32 * j < ncols) {
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              const int t = t0 + i0 + r;
              const float d = lc[t] - lc[s];
              // min(d, 0) that keeps a NaN, as jnp.minimum does
              const float w = s <= t ? expf(d > 0.0f ? 0.0f : d) : 0.0f;
              mt[s * kLdm + i0 + r] = acc[j][r] * w * dts[s];
            }
          }
        }
      }
      // this warp's rows of C become C exp(lc); no other warp reads them
      __syncwarp();
      for (int e = lane; e < 4 * N; e += 32) {
        const int n = e / 4, t = t0 + i0 + (e & 3);
        ct[n * ldc + t] = ct[n * ldc + t] * elc[t];
      }
      __syncwarp();
      // y[t][p] = m @ x + (C exp(lc)) @ state for p = lane + 32 q
      {
        const int nq = P / 32;
        float acc[2][4], inter[2][4];
#pragma unroll
        for (int q = 0; q < 2; ++q)
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[q][r] = inter[q][r] = 0.0f;
#pragma unroll 4
        for (int k = 0; k < ncols; ++k) {
          const float4 m4 = ld4(&mt[k * kLdm + i0]);
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            if (q < nq) {
              const float xv = xs[k * P + lane + 32 * q];
              acc[q][0] = fmaf(m4.x, xv, acc[q][0]);
              acc[q][1] = fmaf(m4.y, xv, acc[q][1]);
              acc[q][2] = fmaf(m4.z, xv, acc[q][2]);
              acc[q][3] = fmaf(m4.w, xv, acc[q][3]);
            }
          }
        }
#pragma unroll 4
        for (int k = 0; k < N; ++k) {
          const float4 c4 = ld4(&ct[k * ldc + t0 + i0]);
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            if (q < nq) {
              const float sv = st[k * lds + lane + 32 * q];
              inter[q][0] = fmaf(c4.x, sv, inter[q][0]);
              inter[q][1] = fmaf(c4.y, sv, inter[q][1]);
              inter[q][2] = fmaf(c4.z, sv, inter[q][2]);
              inter[q][3] = fmaf(c4.w, sv, inter[q][3]);
            }
          }
        }
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          if (q < nq) {
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              y[((row0 + t0 + i0 + r) * H + h) * P + lane + 32 * q] =
                  acc[q][r] + inter[q][r];
            }
          }
        }
      }
      __syncwarp();
    }
    __syncthreads();

    // state = exp(lc_last) state + (B bw)^T @ x: rows n = lane + 32 j,
    // columns p0 .. p0 + P/8 - 1 of this warp
    for (int e = tid; e < L * N; e += kThreads) {
      const int l = e / N, n = e - l * N;
      bs[l * ldb + n] = bs[l * ldb + n] * bw[l];
    }
    __syncthreads();
    {
      const float carry = expf(lc_last);
      const int ncol4 = P / 32;  // float4 columns per warp: P / 8 floats
      const int p0 = warp * (P / 8);
      float acc[4][8];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int u = 0; u < 8; ++u) acc[j][u] = 0.0f;
#pragma unroll 2
      for (int k = 0; k < L; ++k) {
        float bv[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = lane + 32 * j;
          bv[j] = n < N ? bs[k * ldb + n] : 0.0f;
        }
#pragma unroll
        for (int v = 0; v < 2; ++v) {
          if (v < ncol4) {
            const float4 x4 = ld4(&xs[k * P + p0 + 4 * v]);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              acc[j][4 * v + 0] = fmaf(bv[j], x4.x, acc[j][4 * v + 0]);
              acc[j][4 * v + 1] = fmaf(bv[j], x4.y, acc[j][4 * v + 1]);
              acc[j][4 * v + 2] = fmaf(bv[j], x4.z, acc[j][4 * v + 2]);
              acc[j][4 * v + 3] = fmaf(bv[j], x4.w, acc[j][4 * v + 3]);
            }
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = lane + 32 * j;
        if (n < N) {
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            if (u < 4 * ncol4) {
              float* sp = &st[n * lds + p0 + u];
              *sp = carry * *sp + acc[j][u];
            }
          }
        }
      }
    }
    __syncthreads();
  }

  if (h_out != nullptr) {
    for (int e = tid; e < N * P; e += kThreads) {
      const int n = e / P, p = e - n * P;
      h_out[hoff + e] = st[n * lds + p];
    }
  }
}

}  // namespace

// x (batch, S, H, P), dt (batch, S, H), a (H,), bm / cm (batch, S, N),
// all contiguous float32 on the device; S a multiple of chunk; chunk in
// {32, 64, 128}, P in {32, 64}, N at most 128 (kernels/ssd_scan.py checks
// the shape and the shared memory before the launch). h0 (batch, H, N, P)
// or NULL for a zero state; h_out the same shape, or NULL to skip the
// final state. Launches on ``stream`` and returns cudaGetLastError() (or
// the error of raising the block's shared memory limit).
extern "C" int ssd_scan_f32(const float* x, const float* dt, const float* a,
                            const float* bm, const float* cm, const float* h0,
                            float* y, float* h_out, int batch, int S, int H,
                            int P, int N, int chunk, void* stream) {
  const int bytes =
      (int)(smem_floats(chunk, N, P) * (int64_t)sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(H, batch);
  ssd_scan_kernel<<<grid, kThreads, bytes, (cudaStream_t)stream>>>(
      x, dt, a, bm, cm, h0, y, h_out, S, H, P, N, chunk);
  return (int)cudaGetLastError();
}
