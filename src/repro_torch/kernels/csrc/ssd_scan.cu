// Mamba-2 chunked SSD scan: h[t] = exp(dt[t] a) h[t-1] + dt[t] B[t] (x) x[t],
// y[t] = C[t] . h[t], in the chunked dual form (arXiv 2405.21060), with an
// initial state and the final state written out when the caller asks.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan.py (ssd_scan,
// body _ssd_kernel). That kernel runs a (batch, heads, chunks) grid whose
// chunk axis is sequential on the TPU's one core, carrying the (N, P) state
// in VMEM scratch. Per chunk, in its order: g = dt a and its inclusive
// cumsum lc (sequential); w = where(s <= t, exp(min(lc_t - lc_s, 0)), 0),
// selected and never multiplied by a mask, since exp overflows above the
// diagonal; m = (C_t . B_s) w dt_s; y = m @ x + (C exp(lc)) @ state;
// state = exp(lc_last) state + (B exp(lc_last - lc) dt)^T @ x.
//
// Bound on the card at the prefill shape (b, S, H, P, N, L) = (4, 2048, 24,
// 64, 128, 128) with the final state: 113 MB read and written once (x and
// y 50 MB each), 0.034 ms at 3.35 TB/s; 8.20 GFLOP of products (C.B^T once
// per (batch, chunk) over the causal tiles, then per (batch, head, chunk)
// m @ x, (C exp(lc)) @ state and the state update), three TF32 tensor-core
// products each (3xTF32) at 495 TFLOP/s: 0.050 ms; 0.17 GFLOP of
// elementwise work on the CUDA cores, 0.0025 ms. So it is bound by
// tensor-core operations.
//
// The chunks are independent but for the state carried between them, and
// that carry is elementwise. So the scan runs as four kernels, launched in
// order on the caller's stream, each with a grid of more blocks than the
// card's 132 SMs (one block per (batch, head) would be 96):
//
// 1. ssd_scan_chunk_state, block (chunk, head, batch), 1,536 blocks at the
//    shape above: lc (one thread, sequential, as the reference orders it;
//    written to a (b, H, S) scratch so that pass 4 uses the same values),
//    bw = exp(lc_last - lc) dt, and the chunk's own state contribution
//    U^T = x^T (B bw) (P x N, K = L) on the tensor cores, written to a
//    (b, chunks, H, P, Np) scratch (Np = N rounded up to 32, 50 MB).
// 2. ssd_scan_state_pass, block (32 state columns, head, batch): for each
//    chunk in order, state = exp(lc_last) state + U (the reference's
//    order, on the CUDA cores), overwriting U with the state entering the
//    chunk; from h0 or zeros; the final state to h_out. Elementwise, 16
//    steps of 8,192 values per (batch, head), loads run 4 chunks ahead.
// 3. ssd_scan_cb, block (64 rows, chunk, batch): CB = C B^T (L x L, K = N)
//    once per (batch, chunk), not once per head (B and C are shared by the
//    heads), and only the 64-row tiles' columns on or left of the
//    diagonal; to a (b, chunks, L, L) scratch that pass 4 reads from L2.
// 4. ssd_scan_chunk_out, block (64 rows, chunk, head, batch), 3,072
//    blocks, the longer rows first: m = CB w dt over the live columns,
//    y = m @ x + (C exp(lc)) @ state on the tensor cores.
//
// Bytes of this design at the shape above: x read twice (100 MB), the
// state scratch written, read, written and read (~200 MB, partly in the
// 50 MB L2), y 50 MB, B, C, CB and lc ~20 MB: ~370 MB, 0.11 ms at the HBM
// rate, over the operations bound. A single pass with a chained state
// (a block waiting on its predecessor chunk's flag) would save the state
// traffic but serialise the chunks of each (batch, head) at the rate of
// one block's latency; with chunk-parallel passes every product runs in
// parallel over 1,536-3,072 blocks.
//
// Products: 3xTF32 wgmma. Each operand x is split into hi = tf32(x) and
// lo = tf32(x - hi); a product is lo.hi + hi.lo + hi.hi (small terms
// first), wgmma m64nNk8 with both operands from shared memory. TF32 wgmma
// takes its operands K-major only, so each operand tile is stored in
// shared memory as rows of 32 K-values (128 bytes, swizzled: row r's
// 16-byte chunk c at c ^ (r % 8)), transposed on the way where the
// product's K is the row index in device memory (x^T and (B bw)^T in pass
// 1, x^T in pass 4). A block is two warpgroups (256 threads): both take
// the tile's 64 rows, each half of its columns, so a thread holds half the
// sums and stores half the operands, within the 128 registers that let two
// blocks (16 warps) share an SM; the passes are bound by load latency, and
// one warpgroup a block held up to 254 registers (12 warps an SM). K runs in
// slabs of 32; each slab's 12 wgmma go into a fresh accumulator, added on
// the CUDA cores to the product's float32 sum once the next slab is
// stored: the tensor cores truncate as they add, so a sum held on them
// across a whole product (48 wgmma at K = 128) drifts by up to an ulp of
// |y| (~60 here) per product step, most of the tolerance's margin (found
// for flash_attention.cu too). Rows past the shape (P = 32, L = 32,
// N < Np) are zeros in shared memory.
//
// Loads: passes 1 and 4 copy each slab's sources raw (rows as they lie in
// device memory) into one of two shared-memory stages by cp.async, two
// slabs ahead, and split, transpose and weight them from there; pass 4
// stores slab k + 1's operands in a second buffer while slab k's products
// run. Pass 3 (a tenth of the time) loads through registers. Not TMA:
// every operand is rewritten before the product reads it, so a copy
// engine would only land the raw rows, which cp.async does without tensor
// maps. Each block needs at most 99 KB of shared memory and 128 registers
// a thread: two blocks, 16 warps, an SM.
//
// The CUDA-core arithmetic keeps the reference's roundings: the build's
// -fmad=false keeps every multiply and add separate, as the plain version
// computes them.
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"
#include "tf32_slabs.cuh"

namespace {

using namespace hopper;

// Two warpgroups: both compute the tile's 64 rows (wgmma's M), each for
// half of the B tile's rows (the output's columns).
constexpr int kThreads = 256;
constexpr int kAPer = kRows * 8 / kThreads;  // A chunks a thread stores
constexpr int kMaxChunk = 128;

// Two operand buffers (tf32_slabs.cuh buf_bytes: passes 3 and 4; pass 1
// has one and two raw stages, as many bytes).
__host__ __device__ constexpr int block_smem(int nb) {
  return 2 * buf_bytes(nb) + 1024;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

// Four values of a row that may be ragged: v[j] = p[j] for k0 + j < n.
__device__ __forceinline__ float4 ld4_upto(const float* p, int k0, int n) {
  return make_float4(k0 < n ? p[0] : 0.0f, k0 + 1 < n ? p[1] : 0.0f,
                     k0 + 2 < n ? p[2] : 0.0f, k0 + 3 < n ? p[3] : 0.0f);
}

// ------------------------------------------------ raw sources

// Raw sources, copied by cp.async into stages ahead of their split
// (a byte count under the copy's size zero-fills the rest): pass 4's
// stage holds two 8 KB tiles.
constexpr int kRawHalf = kRows * kSlab * 4;
constexpr int kRawBytes = 2 * kRawHalf;

// ------------------------------------------------ pass 1: chunk states

// Bytes of a pass-1 stage: x rows (32 x P) and B rows (32 x NP).
__host__ __device__ constexpr int raw1_bytes(int np) {
  return kSlab * kRows * 4 + kSlab * np * 4;
}

// Block (chunk c, head h, batch b): lc to the scratch, and U^T (P x NP) =
// x^T (B bw) to the state scratch at (b, c, h). NP = N rounded up to 32.
// Each slab's x rows and B rows are copied raw by cp.async into one of two
// stages two slabs ahead (the first two before the cumsum, which they do
// not depend on), then split, transposed and weighted from there into the
// operand buffer.
template <int NP>
__global__ void __launch_bounds__(kThreads, 2)
    ssd_scan_chunk_state(const float* __restrict__ x,
                         const float* __restrict__ dt,
                         const float* __restrict__ a, int a_group,
                         const float* __restrict__ bm,
                         float* __restrict__ lc_out,
                         float* __restrict__ states, int S, int H, int P,
                         int N, int L) {
  __shared__ float dts[kMaxChunk], lcs[kMaxChunk], bws[kMaxChunk];
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int nc = S / L, nk = L / kSlab;
  const int64_t row0 = (int64_t)b * S + (int64_t)c * L;  // (b, t) row
  const int64_t xrow = (int64_t)H * P;  // x's stride from one t to the next
  const float* xh = x + row0 * xrow + (int64_t)h * P;
  const uint32_t buf = smem_base();
  const uint32_t raw = buf + buf_bytes(NP);
  constexpr int kRaw = raw1_bytes(NP);
  const bool b_aligned = N % 4 == 0;
  // a's row for this batch element (formed here: inside the cumsum's
  // branch the division costs pass 1 a spill at NP = 128)
  const float* arow = a + (b / a_group) * H + h;

  auto fetch = [&](int k) {
    if (k < nk) {
      const uint32_t st = raw + (k & 1) * kRaw;
      const int64_t r0 = row0 + kSlab * k;
      for (int e = tid; e < kSlab * P / 4; e += kThreads) {  // x rows
        const int r = e / (P / 4), c4 = e % (P / 4);
        cp16(st + (r * P + 4 * c4) * 4, xh + (kSlab * k + r) * xrow + 4 * c4,
             16);
      }
#pragma unroll
      for (int i = 0; i < NP / 32; ++i) {  // B rows, zeros past N
        const int e = tid + kThreads * i, r = e / (NP / 4);
        const int n = 4 * (e % (NP / 4));
        const uint32_t dst = st + kSlab * kRows * 4 + (r * NP + n) * 4;
        const float* src = bm + (r0 + r) * N + n;
        if (b_aligned) {
          cp16(dst, n < N ? src : bm, n < N ? 16 : 0);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            cp4(dst + 4 * j, n + j < N ? src + j : bm, n + j < N ? 4 : 0);
        }
      }
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  };
  fetch(0);
  fetch(1);

  for (int l = tid; l < L; l += kThreads) dts[l] = dt[(row0 + l) * H + h];
  __syncthreads();
  if (tid == 0) {
    const float ah = *arow;
    float acc = dts[0] * ah;
    lcs[0] = acc;
#pragma unroll 8
    for (int l = 1; l < L; ++l) {
      acc = acc + dts[l] * ah;
      lcs[l] = acc;
    }
  }
  __syncthreads();
  const float lc_last = lcs[L - 1];
  for (int l = tid; l < L; l += kThreads) {
    bws[l] = expf(lc_last - lcs[l]) * dts[l];
    lc_out[((int64_t)b * H + h) * S + (int64_t)c * L + l] = lcs[l];
  }

  float acc[NP / 4], fresh[NP / 4];
#pragma unroll
  for (int i = 0; i < NP / 4; ++i) acc[i] = 0.0f;
  for (int k = 0; k < nk; ++k) {
    // slab k's copies landed, in every thread; the operand buffer's last
    // products done, in every warp
    asm volatile("cp.async.wait_group 1;" ::: "memory");
    wgmma_wait<0>();
    __syncthreads();
    const uint32_t st = raw + (k & 1) * kRaw;
    const int l0 = kSlab * k;
    // A = x^T: rows p (zeros past P), K = l; a warp reads 32 neighbouring
    // p of one staged row
#pragma unroll
    for (int i = 0; i < kAPer; ++i) {
      const int e = tid + kThreads * i, p = e % kRows, c4 = e / kRows;
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (p < P) {
        const uint32_t src = st + (4 * c4 * P + p) * 4;
        v = make_float4(lds(src), lds(src + P * 4), lds(src + 2 * P * 4),
                        lds(src + 3 * P * 4));
      }
      put4(buf, kATile, p, c4, v);
    }
    // B = (B bw)^T: rows n, K = l (rolled: unrolled, it passes the
    // 128 registers that two blocks an SM allow)
#pragma unroll 1
    for (int i = 0; i < NP / 32; ++i) {
      const int e = tid + kThreads * i, n = e % NP, c4 = e / NP;
      const int l = l0 + 4 * c4;
      const uint32_t src = st + kSlab * kRows * 4 + (4 * c4 * NP + n) * 4;
      put4(buf + 2 * kATile, NP * 128, n, c4,
           make_float4(lds(src) * bws[l], lds(src + NP * 4) * bws[l + 1],
                       lds(src + 2 * NP * 4) * bws[l + 2],
                       lds(src + 3 * NP * 4) * bws[l + 3]));
    }
    run_slab<NP>(fresh, acc, k > 0, buf);
    fetch(k + 2);  // into the stage just read (every thread is past it)
  }
  absorb<NP>(acc, fresh);

  const Frag f(NP);
  float* out = states + (((int64_t)b * nc + c) * H + h) * P * NP;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int p = f.r0 + 8 * i;
    if (p < P) {
#pragma unroll
      for (int j = 0; j < NP / 16; ++j)
        *reinterpret_cast<float2*>(out + (int64_t)p * NP + 8 * j + f.c0) =
            make_float2(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
    }
  }
}

// ------------------------------------------------ pass 2: the state carry

constexpr int kCarryThreads = 256;
constexpr int kAhead = 4;  // chunks whose loads are in flight

// Block (32 state columns n0.., head h, batch b), 256 threads; a thread
// owns up to two (p, 4 columns) entries of the (P, 32) slab. For each
// chunk c in order: slot c of the scratch gets the state entering chunk c,
// and state = exp(lc_last of c) state + U_c.
__global__ void __launch_bounds__(kCarryThreads)
    ssd_scan_state_pass(const float* __restrict__ lc,
                        const float* __restrict__ h0,
                        float* __restrict__ states,
                        float* __restrict__ h_out, int S, int H, int P, int N,
                        int NP, int L) {
  __shared__ float tile[32][64 + 1];  // (n, p): h0 in, the final state out
  const int n0 = 32 * blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, nc = S / L;
  const int64_t hoff = ((int64_t)b * H + h) * N * P;
  for (int e = tid; e < 32 * P; e += kCarryThreads) {
    const int r = e / P, p = e % P, n = n0 + r;
    tile[r][p] = h0 != nullptr && n < N ? h0[hoff + (int64_t)n * P + p] : 0.0f;
  }
  __syncthreads();
  float4 st[2];
  int off[2];
  bool mine[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int e = tid + kCarryThreads * i, p = e / 8, q = e % 8;
    mine[i] = p < P;
    off[i] = p * NP + n0 + 4 * q;
    st[i] = mine[i] ? make_float4(tile[4 * q][p], tile[4 * q + 1][p],
                                  tile[4 * q + 2][p], tile[4 * q + 3][p])
                    : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  const float* lcb = lc + ((int64_t)b * H + h) * S + L - 1;
  const int64_t cstride = (int64_t)H * P * NP;  // from chunk c to c + 1
  float* sb = states + (int64_t)b * nc * cstride + (int64_t)h * P * NP;

  float4 u[kAhead][2];
  float lcl[kAhead];
#pragma unroll
  for (int k = 0; k < kAhead; ++k) {
    if (k < nc) {
      lcl[k] = lcb[(int64_t)k * L];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        if (mine[i]) u[k][i] = ld4(sb + k * cstride + off[i]);
    }
  }
  for (int c0 = 0; c0 < nc; c0 += kAhead) {
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      const int c = c0 + k;
      if (c < nc) {
        const float carry = expf(lcl[k]);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          if (mine[i]) {
            st4(sb + c * cstride + off[i], st[i]);
            st[i] = make_float4(carry * st[i].x + u[k][i].x,
                                carry * st[i].y + u[k][i].y,
                                carry * st[i].z + u[k][i].z,
                                carry * st[i].w + u[k][i].w);
          }
        }
        const int cn = c + kAhead;
        if (cn < nc) {
          lcl[k] = lcb[(int64_t)cn * L];
#pragma unroll
          for (int i = 0; i < 2; ++i)
            if (mine[i]) u[k][i] = ld4(sb + cn * cstride + off[i]);
        }
      }
    }
  }
  if (h_out == nullptr) return;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int e = tid + kCarryThreads * i, p = e / 8, q = e % 8;
    if (mine[i]) {
      tile[4 * q][p] = st[i].x;
      tile[4 * q + 1][p] = st[i].y;
      tile[4 * q + 2][p] = st[i].z;
      tile[4 * q + 3][p] = st[i].w;
    }
  }
  __syncthreads();
  for (int e = tid; e < 32 * P; e += kCarryThreads) {
    const int r = e / P, p = e % P, n = n0 + r;
    if (n < N) h_out[hoff + (int64_t)n * P + p] = tile[r][p];
  }
}

// ------------------------------------------------ pass 3: C B^T per chunk

// Rows t0 .. t0 + 63 of CB = C B^T, columns 0 .. NB - 1 (NB = min(t0 +
// 64, L): the tile's columns on or left of the diagonal), K = n in slabs.
template <int NB>
__device__ __forceinline__ void cb_tile(const float* __restrict__ bm,
                                        const float* __restrict__ cm,
                                        float* __restrict__ out, int64_t row0,
                                        int t0, int N, int NP, int L) {
  const int tid = threadIdx.x;
  const uint32_t base = smem_base();
  float acc[NB / 4], fresh[NB / 4];
#pragma unroll
  for (int i = 0; i < NB / 4; ++i) acc[i] = 0.0f;
  for (int k = 0; k < NP / kSlab; ++k) {
    const int n0 = k * kSlab;
    // A = C rows t, B = B rows s, both K = n: element e is row e / 8,
    // chunk e % 8 (a row's 8 chunks in neighbouring threads)
    float4 av[kAPer], bv[NB / 32];
#pragma unroll
    for (int i = 0; i < kAPer; ++i) {
      const int e = tid + kThreads * i, r = e / 8, n = n0 + 4 * (e % 8);
      const int t = t0 + r;
      av[i] = t < L ? ld4_upto(cm + (row0 + t) * N + n, n, N)
                    : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
#pragma unroll
    for (int i = 0; i < NB / 32; ++i) {
      const int e = tid + kThreads * i, s = e / 8, n = n0 + 4 * (e % 8);
      bv[i] = ld4_upto(bm + (row0 + s) * N + n, n, N);
    }
    __syncthreads();
    const uint32_t buf = base + (k & 1) * buf_bytes(NB);
#pragma unroll
    for (int i = 0; i < kAPer; ++i) {
      const int e = tid + kThreads * i;
      put4(buf, kATile, e / 8, e % 8, av[i]);
    }
#pragma unroll
    for (int i = 0; i < NB / 32; ++i) {
      const int e = tid + kThreads * i;
      put4(buf + 2 * kATile, NB * 128, e / 8, e % 8, bv[i]);
    }
    run_slab<NB>(fresh, acc, k > 0, buf);
  }
  absorb<NB>(acc, fresh);
  const Frag f(NB);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = t0 + f.r0 + 8 * i;
    if (t < L) {
#pragma unroll
      for (int j = 0; j < NB / 16; ++j)
        *reinterpret_cast<float2*>(out + (int64_t)t * L + 8 * j + f.c0) =
            make_float2(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
    }
  }
}

// Block (64-row tile mt, chunk c, batch b): the tile's rows of CB into the
// (b, chunks, L, L) scratch.
__global__ void __launch_bounds__(kThreads, 2)
    ssd_scan_cb(const float* __restrict__ bm, const float* __restrict__ cm,
                float* __restrict__ cb, int S, int N, int NP, int L) {
  const int mt = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int nc = S / L, t0 = kRows * mt;
  const int64_t row0 = (int64_t)b * S + (int64_t)c * L;
  float* out = cb + ((int64_t)b * nc + c) * L * L;
  switch (min(t0 + kRows, L)) {
    case 32:
      cb_tile<32>(bm, cm, out, row0, t0, N, NP, L);
      break;
    case 64:
      cb_tile<64>(bm, cm, out, row0, t0, N, NP, L);
      break;
    default:
      cb_tile<128>(bm, cm, out, row0, t0, N, NP, L);
  }
}

// ------------------------------------------------ pass 4: the outputs

// Block (64-row tile mt and chunk c, head h, batch b), the longest tiles
// first: y rows t0 .. t0 + 63 (those below L) = m @ x over the columns
// s < min(t0 + 64, L), plus (C exp(lc)) @ state entering c. PP = P. Each
// slab's sources are copied raw into one of two stages by cp.async two
// slabs ahead (CB rows and x rows for m @ x, C rows and state^T rows for
// the rest; rows past the shape zero-filled), then split from there into
// the operand buffers, so no thread waits on a load it just issued.
template <int PP>
__global__ void __launch_bounds__(kThreads, 2)
    ssd_scan_chunk_out(const float* __restrict__ x,
                       const float* __restrict__ dt,
                       const float* __restrict__ cm,
                       const float* __restrict__ lc,
                       const float* __restrict__ cb,
                       const float* __restrict__ states,
                       float* __restrict__ y, int S, int H, int N, int NP,
                       int L) {
  __shared__ float dts[kMaxChunk], lcs[kMaxChunk], elc[kMaxChunk];
  const int nc = S / L, mtiles = (L + kRows - 1) / kRows;
  const int mt = mtiles - 1 - (int)blockIdx.x / nc;
  const int c = blockIdx.x % nc, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, t0 = kRows * mt;
  const int64_t row0 = (int64_t)b * S + (int64_t)c * L;
  const int64_t xrow = (int64_t)H * PP;
  const float* xh = x + row0 * xrow + (int64_t)h * PP;
  const float* cbc = cb + ((int64_t)b * nc + c) * L * L;
  const float* hst =
      states + (((int64_t)b * nc + c) * H + h) * PP * (int64_t)NP;
  const uint32_t base = smem_base();
  const uint32_t raw = base + 2 * buf_bytes(PP);
  // slabs 0 .. ni - 1: m @ x over s0 = 32 q; then (C exp(lc)) @ state
  // over n0 = 32 (q - ni)
  const int ni = min(t0 + kRows, L) / kSlab, nslabs = ni + NP / kSlab;
  const bool c_aligned = N % 4 == 0;

  // Slab q's sources into stage q % 2, one cp.async group (empty past the
  // last slab, so that the group count stays one per slab).
  auto fetch = [&](int q) {
    if (q < nslabs) {
      const uint32_t st = raw + (q & 1) * kRawBytes;
      if (q < ni) {
        const int s0 = kSlab * q;
#pragma unroll
        for (int i = 0; i < kAPer; ++i) {  // CB rows t: 8 chunks each
          const int e = tid + kThreads * i, r = e / 8, c4 = e % 8;
          const int t = t0 + r;
          cp16(st + r * 128 + c4 * 16,
               t < L ? cbc + (int64_t)t * L + s0 + 4 * c4 : cbc,
               t < L ? 16 : 0);
        }
#pragma unroll
        for (int i = 0; i < PP / 32; ++i) {  // x rows s: PP / 4 chunks each
          const int e = tid + kThreads * i, r = e / (PP / 4);
          const int c4 = e % (PP / 4);
          cp16(st + kRawHalf + r * PP * 4 + c4 * 16,
               xh + (s0 + r) * xrow + 4 * c4, 16);
        }
      } else {
        const int n0 = kSlab * (q - ni);
#pragma unroll
        for (int i = 0; i < kAPer; ++i) {  // C rows t: 8 chunks each
          const int e = tid + kThreads * i, r = e / 8, c4 = e % 8;
          const int t = t0 + r, n = n0 + 4 * c4;
          const uint32_t dst = st + r * 128 + c4 * 16;
          const float* src = cm + (row0 + (t < L ? t : 0)) * N + n;
          if (c_aligned) {
            cp16(dst, t < L && n < N ? src : cm, t < L && n < N ? 16 : 0);
          } else {
#pragma unroll
            for (int j = 0; j < 4; ++j)
              cp4(dst + 4 * j, t < L && n + j < N ? src + j : cm,
                  t < L && n + j < N ? 4 : 0);
          }
        }
#pragma unroll
        for (int i = 0; i < PP / 32; ++i) {  // state^T rows p: 8 chunks
          const int e = tid + kThreads * i, r = e / 8, c4 = e % 8;
          cp16(st + kRawHalf + r * 128 + c4 * 16,
               hst + (int64_t)r * NP + n0 + 4 * c4, 16);
        }
      }
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  };
  fetch(0);
  fetch(1);

  for (int l = tid; l < L; l += kThreads) {
    dts[l] = dt[(row0 + l) * H + h];
    const float v = lc[((int64_t)b * H + h) * S + (int64_t)c * L + l];
    lcs[l] = v;
    elc[l] = expf(v);
  }

  // y: every slab's fresh sum of both products, added in turn
  float acc[PP / 4], fresh[PP / 4];
#pragma unroll
  for (int i = 0; i < PP / 4; ++i) acc[i] = 0.0f;
  for (int q = 0; q < nslabs; ++q) {
    // slab q's copies landed (q + 1's may be in flight), in every thread;
    // the operand buffer's last products were awaited in every warp
    asm volatile("cp.async.wait_group 1;" ::: "memory");
    __syncthreads();
    const uint32_t st = raw + (q & 1) * kRawBytes;
    const uint32_t buf = base + (q & 1) * buf_bytes(PP);
    if (q < ni) {
      // A = m rows t, K = s: m = CB w dt, w = exp(min(lc_t - lc_s, 0))
      const int s0 = kSlab * q;
#pragma unroll
      for (int i = 0; i < kAPer; ++i) {
        const int e = tid + kThreads * i, r = e / 8, c4 = e % 8;
        const int t = t0 + r, s = s0 + 4 * c4;
        const float4 v = lds4(st + r * 128 + c4 * 16);
        float4 m = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (t < L) {
          const float lt = lcs[t];
          float* mv = &m.x;
          const float* cv = &v.x;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (s + j <= t) {
              // min(d, 0) that keeps a NaN, as the reference's minimum does
              const float d = lt - lcs[s + j];
              mv[j] = cv[j] * expf(d > 0.0f ? 0.0f : d) * dts[s + j];
            }
          }
        }
        put4(buf, kATile, r, c4, m);
      }
      // B = x^T rows p, K = s: a warp reads 32 neighbouring p of a row
#pragma unroll
      for (int i = 0; i < PP / 32; ++i) {
        const int e = tid + kThreads * i, p = e % PP, c4 = e / PP;
        const uint32_t src = st + kRawHalf + (4 * c4 * PP + p) * 4;
        put4(buf + 2 * kATile, PP * 128, p, c4,
             make_float4(lds(src), lds(src + PP * 4), lds(src + 2 * PP * 4),
                         lds(src + 3 * PP * 4)));
      }
    } else {
      // A = C exp(lc) rows t, K = n; B = state^T rows p, K = n
#pragma unroll
      for (int i = 0; i < kAPer; ++i) {
        const int e = tid + kThreads * i, r = e / 8, c4 = e % 8;
        const int t = t0 + r;
        float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (t < L) {
          v = lds4(st + r * 128 + c4 * 16);
          const float sc = elc[t];
          v = make_float4(v.x * sc, v.y * sc, v.z * sc, v.w * sc);
        }
        put4(buf, kATile, r, c4, v);
      }
#pragma unroll
      for (int i = 0; i < PP / 32; ++i) {
        const int e = tid + kThreads * i, p = e / 8, c4 = e % 8;
        put4(buf + 2 * kATile, PP * 128, p, c4,
             lds4(st + kRawHalf + p * 128 + c4 * 16));
      }
    }
    run_slab<PP>(fresh, acc, q > 0, buf);
    fetch(q + 2);  // into the stage just read (every thread is past it)
  }
  absorb<PP>(acc, fresh);

  const Frag f(PP);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = t0 + f.r0 + 8 * i;
    if (t < L) {
      float* out = y + (row0 + t) * xrow + (int64_t)h * PP + f.c0;
#pragma unroll
      for (int j = 0; j < PP / 16; ++j)
        *reinterpret_cast<float2*>(out + 8 * j) =
            make_float2(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
    }
  }
}

// ------------------------------------------------------------------ host

int state_cols(int n) { return n <= 32 ? 32 : n <= 64 ? 64 : 128; }

template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int NP>
cudaError_t launch_chunk_state(const float* x, const float* dt, const float* a,
                               int a_group, const float* bm, float* lc,
                               float* states, int batch, int S, int H, int P,
                               int N, int L, cudaStream_t stream) {
  const int bytes = buf_bytes(NP) + 2 * raw1_bytes(NP) + 1024;
  cudaError_t err = allow_smem(ssd_scan_chunk_state<NP>, bytes);
  if (err != cudaSuccess) return err;
  ssd_scan_chunk_state<NP><<<dim3(S / L, H, batch), kThreads, bytes,
                             stream>>>(x, dt, a, a_group, bm, lc, states, S,
                                       H, P, N, L);
  return cudaGetLastError();
}

template <int PP>
cudaError_t launch_chunk_out(const float* x, const float* dt, const float* cm,
                             const float* lc, const float* cb,
                             const float* states, float* y, int batch, int S,
                             int H, int N, int NP, int L,
                             cudaStream_t stream) {
  const int bytes = block_smem(PP) + 2 * kRawBytes;
  cudaError_t err = allow_smem(ssd_scan_chunk_out<PP>, bytes);
  if (err != cudaSuccess) return err;
  const int mtiles = (L + kRows - 1) / kRows;
  ssd_scan_chunk_out<PP><<<dim3(mtiles * (S / L), H, batch), kThreads, bytes,
                           stream>>>(x, dt, cm, lc, cb, states, y, S, H, N,
                                     NP, L);
  return cudaGetLastError();
}

}  // namespace

// x (batch, S, H, P), dt (batch, S, H), a (batch / a_group, H): batch
// element i reads row i / a_group; bm / cm (batch, S, N), all contiguous
// float32 on the device; S a multiple of chunk; chunk in {32, 64, 128}, P
// in {32, 64}, N at most 128 (kernels/ssd_scan.py checks the shape before
// the launch). h0 (batch, H, N, P) or NULL for a zero state; h_out the
// same shape, or NULL to skip the final state. The passes' scratch, which
// the backward (csrc/ssd_scan_bwd.cu) reads, 16-byte aligned: lc (batch,
// H, S), the states entering each chunk (batch, S / chunk, H, P, Np) with
// Np = N rounded up to 32, and C B^T (batch, S / chunk, chunk, chunk).
// Launches the four passes on ``stream`` and returns the first cudaError
// (of raising a kernel's shared memory limit or of a launch), 0 if none.
extern "C" int ssd_scan_f32(const float* x, const float* dt, const float* a,
                            int a_group, const float* bm, const float* cm,
                            const float* h0, float* y, float* h_out,
                            float* lc, float* states, float* cb, int batch,
                            int S, int H, int P, int N, int chunk,
                            void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int L = chunk, nc = S / L, NP = state_cols(N);
  cudaError_t err;
  switch (NP) {
    case 32:
      err = launch_chunk_state<32>(x, dt, a, a_group, bm, lc, states,
                                   batch, S, H, P, N, L, st);
      break;
    case 64:
      err = launch_chunk_state<64>(x, dt, a, a_group, bm, lc, states,
                                   batch, S, H, P, N, L, st);
      break;
    default:
      err = launch_chunk_state<128>(x, dt, a, a_group, bm, lc, states,
                                    batch, S, H, P, N, L, st);
  }
  if (err != cudaSuccess) return (int)err;

  ssd_scan_state_pass<<<dim3(NP / 32, H, batch), kCarryThreads, 0, st>>>(
      lc, h0, states, h_out, S, H, P, N, NP, L);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int cb_bytes = block_smem(L < 128 ? L : 128);
  err = allow_smem(ssd_scan_cb, cb_bytes);
  if (err != cudaSuccess) return (int)err;
  ssd_scan_cb<<<dim3((L + kRows - 1) / kRows, nc, batch), kThreads, cb_bytes,
                st>>>(bm, cm, cb, S, N, NP, L);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  err = P == 32 ? launch_chunk_out<32>(x, dt, cm, lc, cb, states, y, batch, S,
                                       H, N, NP, L, st)
                : launch_chunk_out<64>(x, dt, cm, lc, cb, states, y, batch, S,
                                       H, N, NP, L, st);
  return (int)err;
}
