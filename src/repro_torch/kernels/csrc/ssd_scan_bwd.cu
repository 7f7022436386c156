// Backward of the Mamba-2 chunked SSD scan (csrc/ssd_scan.cu): the
// gradients of y and the final state with respect to x, dt, a, B, C and the
// initial state.
//
// A kernel of the port's own: the Pallas TPU kernel
// src/repro/kernels/ssd_scan.py has no backward (the reference trains
// through its jnp chunked scan, src/repro/kernels/ref.py ssd_chunked_ref,
// under jax.grad). The function is kernels/ref.py ssd_scan_bwd_ref's. Per
// (batch, head) and chunk of length L, with lc the cumsum of dt a,
// w_ts = exp(min(lc_t - lc_s, 0)) for s <= t, M = (C B^T) w dt_s,
// bw = exp(lc_L - lc) dt, S the state entering the chunk and dS the
// gradient of the state leaving it:
//   dS before the chunk = exp(lc_L) dS + sum_t exp(lc_t) C_t dy_t^T;
//   G = dy x^T; dx = M^T dy + bw (B dS);
//   dC = (sum_h G w dt_s) B + sum_h exp(lc) (dy S^T);
//   dB = (sum_h G w dt_s)^T C + sum_h bw (x dS^T);
//   dlc: row sums less column sums of G M below the diagonal, plus
//   dy . y_inter, plus the state update's terms; dg its reverse cumsum in
//   the chunk; ddt = a dg + sum_t G (C.B) w + exp(lc_L - lc) <B x^T, dS>;
//   da = sum over (b, S) of dt dg.
// Only exponentials of differences that are <= 0 are formed (and exp(lc),
// lc <= 0 for a < 0), as the forward forms them.
//
// Five device kernels on the caller's stream, chunk-parallel as the
// forward's passes:
//
// 1. ssd_bwd_chunk_dstate, block (chunk, head, batch): V = sum_t exp(lc_t)
//    C_t dy_t^T (P x Np, K = L) into a (b, chunks, H, P, Np) scratch, the
//    forward's state layout; lc is the forward's, saved with its entering
//    states and C B^T (kernels/ssd_scan.py SsdScan).
// 2. ssd_bwd_state_pass, block (32 state columns, head, batch): the
//    forward's carry reversed, chunk by chunk from the last: slot c gets
//    dS leaving chunk c, then dS = exp(lc_L of c) dS + V_c; from dh_final
//    or zeros; dh0 out.
// 3. ssd_bwd_chunk, block (chunk, head, batch), the rest of the chunk's
//    gradients: G over the chunk with M and dCB = G w dt_s from it; dx;
//    this head's shares of dB and dC written to (b, S, H, N) scratches; the
//    lc terms, dg, ddt, and this chunk's share of da.
// 4. ssd_bwd_reduce_bc: dB and dC summed over the heads in order.
// 5. ssd_bwd_reduce_a: da summed over (batch element, chunk) in order.
//
// Deterministic: no atomics. Every sum has one owner and one fixed order
// (the heads' shares of dB / dC and the chunks' of da go through scratch
// to the reductions), so two runs give the same bits.
//
// Bound at mamba2-130m's training shape (b, S, H, P, N, L) = (4, 2048, 24,
// 64, 128, 128) (chip_smoke.py ssd_bwd_bound): 16.7 GFLOP of products
// (dCB B and dCB^T C counted once per (batch, chunk), the heads' dCB summed
// first), 0.10 ms as 3xTF32 on the tensor cores; 169 MB read and written
// once, 0.051 ms. At jamba-v0.1-52b's (4, 2048, 128, 64, 16): 816 MB,
// 0.24 ms, so bytes.
//
// Products: mma.sync m16n8k8 with TF32 operands, each float32 value split
// into hi = tf32(v) and lo = tf32(v - hi) as its fragment is loaded, three
// products a step (lo.hi + hi.lo + hi.hi), a fresh float32 sum per 32-deep
// slab added on the CUDA cores (the tensor cores truncate as they add).
// Dead tiles of the causal products (G below the diagonal; M^T dy, dCB B
// and dCB^T C over K >= or <= the row) are skipped. Two warp layouts: G
// and V on a 2 x 4 grid of 16 x 8 tiles, interleaved (Lane); the products
// whose A operand spans the chunk's L rows (M^T dy, B dS and the slab
// loop's dC and dB terms) with one warp per 16-row tile (RowLane), so each
// row is loaded and split once a block, the two warps of a scheduler on
// tiles from opposite ends (the causal K ranges balance). Fragments are
// read from shared memory with scalar loads, at leading dimensions of n +
// 4 or n + 8 floats (by the direction a tile is mostly read), so that a
// fragment's 32 lanes hit 32 banks (2-way conflicts where a tile is read
// the other way too). mma.sync, not wgmma: every operand is read in both
// orientations and most are rewritten (weighted, split) as they are read,
// which wgmma's K-major shared-memory tiles would need copies for.
//
// What bounds it: one block of 256 threads an SM (pass 3 holds the chunk's
// dy, x, M and dCB, 218 KB), so little hides its latencies: its loads are
// not overlapped with another block's products, and the slab loop (32
// state columns at a time, for the shared memory) loads its four slabs
// and resplits its operands once a slab. The reverse carry keeps 4
// chunks' loads in flight; the chunk tail (dlc, dg, da) runs on one warp
// with a suffix scan. The elementwise terms keep the plain version's order
// of operations under the build's -fmad=false.
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

using hopper::to_tf32;

constexpr int kThreads = 256;
constexpr int kWR = 2, kWC = 4;  // the 8 warps as 2 rows x 4 columns of tiles
constexpr int kSlab = 32;        // K per fresh sum; state columns per slab

// Leading dimensions (floats) of the shared-memory tiles, by how the
// fragment loads read them: rows of n + 4 for a tile read along its rows
// (the K index contiguous: 32 banks for 8 rows x 4 K of a fragment), n + 8
// for one read down its columns (8 columns x 4 K).
__host__ __device__ constexpr int ld4(int n) { return n + 4; }
__host__ __device__ constexpr int ld8(int n) { return n + 8; }

// hi = tf32(v), lo = tf32(v - hi), as bit patterns for mma.
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  const float h = to_tf32(v);
  hi = __float_as_uint(h);
  lo = __float_as_uint(to_tf32(v - h));
}

// D (16 x 8) += A (16 x 8) B (8 x 8), TF32 in, float32 accumulate.
__device__ __forceinline__ void mma8(float* d, const uint32_t* a,
                                     const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A warp's place in the 2 x 4 grid and its lane's in an mma fragment:
// the warp's tile i covers rows row(i) .. + 15 and tile j columns col(j)
// .. + 7, interleaved with the other warps' (so that a causal product's
// live tiles spread over all of them); lane (g, t) holds rows g and g + 8,
// columns 2t and 2t + 1 of each tile's D.
struct Lane {
  int wr, wc, g, t;
  __device__ Lane() {
    const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
    wr = w / kWC;
    wc = w % kWC;
    g = lane / 4;
    t = lane % 4;
  }
  __device__ int row(int i) const { return 16 * (kWR * i + wr); }
  __device__ int col(int j) const { return 8 * (kWC * j + wc); }
  // D element e of tile (i, j): its row and column
  __device__ int drow(int i, int e) const { return row(i) + g + 8 * (e >> 1); }
  __device__ int dcol(int j, int e) const { return col(j) + 2 * t + (e & 1); }
};

// A warp's place where each 16-row tile goes to one warp (L / 16 row
// tiles, 8 / (L / 16) interleaved column groups): in the products whose A
// operand spans the chunk's L rows (M, dCB, dy, x, B), each row is loaded
// and split once a block, not once per column group. The two warps of a
// scheduler (w and w + 4) take tiles from opposite ends, so the causal
// products' K ranges balance between schedulers.
template <int L>
struct RowLane {
  static constexpr int R = L / 16, C = 8 / R;
  int tile, cg, g, t;
  __device__ RowLane() {
    const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int p = w % 4, half = w / 4;
    tile = half ? R - 1 - p % R : p % R;
    cg = p / R + half * (4 / R);
    g = lane / 4;
    t = lane % 4;
  }
  __device__ int row(int) const { return 16 * tile; }
  __device__ int col(int j) const { return 8 * (C * j + cg); }
  __device__ int drow(int i, int e) const { return row(i) + g + 8 * (e >> 1); }
  __device__ int dcol(int j, int e) const { return col(j) + 2 * t + (e & 1); }
};

template <int MT, int NT>
__device__ __forceinline__ void zero(float (&d)[MT][NT][4]) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) d[i][j][e] = 0.0f;
}

// acc += A B over K = k0 .. k1 - 1 (multiples of 8) in 3xTF32 (lo.hi +
// hi.lo + hi.hi, small terms first): a(row, k) and b(k, col) read the
// operands from shared memory; tile (i, j) takes K step kk only where
// live(i, j, kk) (a causal product's zero tiles). Each 32-deep slab sums
// into fresh registers, added to acc on the CUDA cores: the tensor cores
// truncate as they add, and a sum held on them over a long K drifts.
template <int MT, int NT, class LN, class FA, class FB, class FL>
__device__ __forceinline__ void mma3(float (&acc)[MT][NT][4], const LN& ln,
                                     int k0, int k1, FA a, FB b, FL live) {
  for (int ks = k0; ks < k1; ks += kSlab) {
    float fr[MT][NT][4];
    zero(fr);
    const int ke = ks + kSlab < k1 ? ks + kSlab : k1;
    for (int kk = ks; kk < ke; kk += 8) {
      uint32_t ah[MT][4], al[MT][4], bh[NT][2], bl[NT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          split(a(ln.row(i) + ln.g + 8 * (e & 1), kk + ln.t + 4 * (e >> 1)),
                ah[i][e], al[i][e]);
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          split(b(kk + ln.t + 4 * e, ln.col(j) + ln.g), bh[j][e], bl[j][e]);
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
          if (live(i, j, kk)) {
            mma8(fr[i][j], al[i], bh[j]);
            mma8(fr[i][j], ah[i], bl[j]);
            mma8(fr[i][j], ah[i], bh[j]);
          }
    }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += fr[i][j][e];
  }
}

struct Always {
  __device__ bool operator()(int, int, int) const { return true; }
};

// Sums over the lanes of a fragment row (t = 0..3) or column (g = 0..7),
// in a fixed order.
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}
__device__ __forceinline__ float group_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  return v + __shfl_xor_sync(0xffffffffu, v, 16);
}

// ------------------------------------------------ pass 1: V per chunk

// Shared memory of a pass-1 block, in floats: dy (L rows of P + 8), exp(lc)
// C (L rows of NP + 8), exp(lc).
__host__ __device__ constexpr int dstate_smem_floats(int L, int P, int NP) {
  return L * ld8(P) + L * ld8(NP) + L;
}

// Block (chunk c, head h, batch b): V (P x NP) = sum_t dy_t^T (exp(lc_t)
// C_t), written as (p, n) rows of NP to ``ds`` at (b, c, h); columns past N
// are zeros.
template <int P, int NP>
__global__ void __launch_bounds__(kThreads)
    ssd_bwd_chunk_dstate(const float* __restrict__ dy,
                         const float* __restrict__ cm,
                         const float* __restrict__ lc, float* __restrict__ ds,
                         int S, int H, int N, int L) {
  constexpr int LDY = ld8(P), LDC = ld8(NP);
  extern __shared__ float sm[];
  float* dys = sm;              // [L][LDY]
  float* ces = dys + L * LDY;   // [L][LDC]
  float* elc = ces + L * LDC;   // [L]
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int nc = S / L;
  const int64_t row0 = (int64_t)b * S + (int64_t)c * L;
  const float* lcc = lc + ((int64_t)b * H + h) * S + (int64_t)c * L;
  for (int t = tid; t < L; t += kThreads) elc[t] = expf(lcc[t]);
  for (int e = tid; e < L * P; e += kThreads) {
    const int t = e / P, p = e % P;
    dys[t * LDY + p] = dy[((row0 + t) * H + h) * P + p];
  }
  __syncthreads();
  for (int e = tid; e < L * NP; e += kThreads) {
    const int t = e / NP, n = e % NP;
    ces[t * LDC + n] = n < N ? cm[(row0 + t) * N + n] * elc[t] : 0.0f;
  }
  __syncthreads();
  constexpr int MT = P / (16 * kWR), NT = NP / (8 * kWC);
  const Lane ln;
  float acc[MT][NT][4];
  zero(acc);
  mma3(acc, ln, 0, L, [&](int p, int t) { return dys[t * LDY + p]; },
       [&](int t, int n) { return ces[t * LDC + n]; }, Always());
  float* out = ds + (((int64_t)b * nc + c) * H + h) * P * NP;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        out[ln.drow(i, e) * NP + ln.dcol(j, e)] = acc[i][j][e];
}

// ------------------------------------------------ pass 2: the reverse carry

constexpr int kCarryThreads = 256;
constexpr int kAhead = 4;  // chunks whose loads are in flight

// Block (32 state columns n0.., head h, batch b); a thread owns up to two
// (p, 4 columns) entries of the (P, 32) slab. For each chunk c from the
// last: read V_c, write dS leaving c into its slot, dS = exp(lc_L of c) dS
// + V_c. From dh (b, H, N, P) or zeros; the last dS (the gradient of the
// initial state) to dh0.
__global__ void __launch_bounds__(kCarryThreads)
    ssd_bwd_state_pass(const float* __restrict__ lc,
                       const float* __restrict__ dh, float* __restrict__ ds,
                       float* __restrict__ dh0, int S, int H, int P, int N,
                       int NP, int L) {
  __shared__ float tile[32][64 + 1];  // (n, p): dh in, dh0 out
  const int n0 = 32 * blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, nc = S / L;
  const int64_t hoff = ((int64_t)b * H + h) * N * P;
  for (int e = tid; e < 32 * P; e += kCarryThreads) {
    const int r = e / P, p = e % P, n = n0 + r;
    tile[r][p] = dh != nullptr && n < N ? dh[hoff + (int64_t)n * P + p] : 0.0f;
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
  float* sb = ds + (int64_t)b * nc * cstride + (int64_t)h * P * NP;
  // V and lc_L of the next kAhead chunks in flight (read before their
  // slots are overwritten)
  float4 u[kAhead][2];
  float lcl[kAhead];
#pragma unroll
  for (int k = 0; k < kAhead; ++k) {
    const int c = nc - 1 - k;
    if (c >= 0) {
      lcl[k] = lcb[(int64_t)c * L];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        if (mine[i])
          u[k][i] = *reinterpret_cast<const float4*>(sb + c * cstride +
                                                     off[i]);
    }
  }
  for (int k0 = 0; k0 < nc; k0 += kAhead) {
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      const int c = nc - 1 - (k0 + k);
      if (c >= 0) {
        const float carry = expf(lcl[k]);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          if (mine[i]) {
            *reinterpret_cast<float4*>(sb + c * cstride + off[i]) = st[i];
            st[i] = make_float4(carry * st[i].x + u[k][i].x,
                                carry * st[i].y + u[k][i].y,
                                carry * st[i].z + u[k][i].z,
                                carry * st[i].w + u[k][i].w);
          }
        }
        const int cn = c - kAhead;
        if (cn >= 0) {
          lcl[k] = lcb[(int64_t)cn * L];
#pragma unroll
          for (int i = 0; i < 2; ++i)
            if (mine[i])
              u[k][i] = *reinterpret_cast<const float4*>(sb + cn * cstride +
                                                         off[i]);
        }
      }
    }
  }
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
    if (n < N) dh0[hoff + (int64_t)n * P + p] = tile[r][p];
  }
}

// ------------------------------------------------ pass 3: the chunk

// Leading dimensions of pass 3's tiles (floats): dy and x (L x P), M and
// dCB (L x L), and the slabs of B, C (L x 32), S and dS (P x 32).
template <int L, int P>
struct ChunkLayout {
  static constexpr int dy = ld4(P), x = ld4(P), m = ld8(L), dcb = ld4(L);
  static constexpr int b = ld4(kSlab), c = ld8(kSlab), s = ld8(kSlab),
                       ds = ld4(kSlab);
  static constexpr int slabs = L * b + L * c + P * s + P * ds;
  static constexpr int area = L * m > slabs ? L * m : slabs;  // M, then slabs
  // dy, x, the M / slab area, dCB, row partials (2 x 4 x L), column
  // partials (2 x 2 x L), ten arrays of L and 32 floats
  static constexpr int floats =
      L * dy + L * x + area + L * dcb + 2 * kWC * L + 2 * kWR * L + 10 * L +
      32;
};

// Block (chunk c, head h, batch b), 8 warps: G on the 2 x 4 grid (Lane),
// the L-row products one warp a row tile (RowLane).
template <int L, int P>
__global__ void __launch_bounds__(kThreads, 1)
    ssd_bwd_chunk(const float* __restrict__ x, const float* __restrict__ dt,
                  const float* __restrict__ a, int a_group,
                  const float* __restrict__ bm, const float* __restrict__ cm,
                  const float* __restrict__ dy, const float* __restrict__ lc,
                  const float* __restrict__ states,
                  const float* __restrict__ cb, const float* __restrict__ ds,
                  float* __restrict__ dx, float* __restrict__ ddt,
                  float* __restrict__ dbh, float* __restrict__ dch,
                  float* __restrict__ dapart, int S, int H, int N, int NP) {
  using Ly = ChunkLayout<L, P>;
  // tiles a warp holds: of an L x L product (columns in NG groups of NTG
  // tiles), of an L x P one and of an L x 32 slab
  constexpr int ML = L / (16 * kWR), NL = L / (8 * kWC);
  constexpr int NTG = NL < 2 ? NL : 2, NG = NL / NTG;
  // tiles a warp holds in the RowLane products: of an L x P output and of
  // an L x 32 slab
  constexpr int RC = RowLane<L>::C;
  constexpr int NPS = P / (8 * RC), NSS = kSlab / (8 * RC);
  extern __shared__ float sm[];
  float* dys = sm;                    // [L][Ly::dy]
  float* xs = dys + L * Ly::dy;       // [L][Ly::x]
  float* ms = xs + L * Ly::x;         // [L][Ly::m]; then the slabs
  float* bsl = ms;                    // [L][Ly::b]: B, columns n0 ..
  float* csl = bsl + L * Ly::b;       // [L][Ly::c]: C
  float* sps = csl + L * Ly::c;       // [P][Ly::s]: S entering, (p, n)
  float* dss = sps + P * Ly::s;       // [P][Ly::ds]: dS leaving, (p, n)
  float* dcbs = ms + Ly::area;        // [L][Ly::dcb]
  float* rowp = dcbs + L * Ly::dcb;   // [4][L]: row partials of G M, then r
  float* yp = rowp + kWC * L;         // [4][L]: row partials of dy . y_inter
  float* colq = yp + kWC * L;         // [2][L]: column partials of G M
  float* cold = colq + kWR * L;       // [2][L]: column partials of G CB w
  float* lcs = cold + kWR * L;
  float* dts = lcs + L;
  float* bws = dts + L;
  float* elcs = bws + L;
  float* rq = elcs + L;    // row sums of G M; then dlc
  float* cq = rq + L;      // column sums of G M
  float* dd = cq + L;      // sum_t G CB w
  float* rs = dd + L;      // <B_s x_s^T, dS>
  float* yint = rs + L;    // dy . y_inter
  float* dgs = yint + L;
  float* red = dgs + L;    // [32]

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int nc = S / L;
  const int64_t row0 = (int64_t)b * S + (int64_t)c * L;
  const int64_t xrow = (int64_t)H * P;
  const float* cbc = cb + ((int64_t)b * nc + c) * L * L;
  const int64_t soff = (((int64_t)b * nc + c) * H + h) * P * (int64_t)NP;
  const Lane ln;
  const RowLane<L> sl;

  for (int t = tid; t < L; t += kThreads) {
    lcs[t] = lc[((int64_t)b * H + h) * S + (int64_t)c * L + t];
    dts[t] = dt[(row0 + t) * H + h];
  }
  for (int e = tid; e < L * P; e += kThreads) {
    const int t = e / P, p = e % P;
    dys[t * Ly::dy + p] = dy[(row0 + t) * xrow + (int64_t)h * P + p];
    xs[t * Ly::x + p] = x[(row0 + t) * xrow + (int64_t)h * P + p];
  }
  __syncthreads();
  for (int t = tid; t < L; t += kThreads) {
    elcs[t] = expf(lcs[t]);
    bws[t] = expf(lcs[L - 1] - lcs[t]) * dts[t];
  }

  // G = dy x^T over the causal tiles, NTG column tiles at a time; M, dCB
  // and the lc / dt terms from it
  {
    float rowq[ML][2];
#pragma unroll
    for (int i = 0; i < ML; ++i) rowq[i][0] = rowq[i][1] = 0.0f;
#pragma unroll 1
    for (int jg = 0; jg < NG; ++jg) {
      const int j0 = jg * NTG;
      float g[ML][NTG][4];
      zero(g);
      // mma3 numbers this group's tiles from 0: column s of its tile j is
      // column s + 8 kWC j0 of G
      mma3(g, ln, 0, P, [&](int t, int p) { return dys[t * Ly::dy + p]; },
           [&](int p, int s) { return xs[(s + 8 * kWC * j0) * Ly::x + p]; },
           [&](int i, int j, int) {
             return ln.col(j0 + j) <= ln.row(i) + 15;
           });
#pragma unroll
      for (int j = 0; j < NTG; ++j) {
        float colqv[2] = {0.0f, 0.0f}, coldv[2] = {0.0f, 0.0f};
#pragma unroll
        for (int i = 0; i < ML; ++i) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int t = ln.drow(i, e), s = ln.dcol(j0 + j, e);
            const float gv = g[i][j][e];
            float m = 0.0f, dcb = 0.0f;
            if (s <= t) {
              // min(d, 0) that keeps a NaN, as the forward's
              const float d = lcs[t] - lcs[s];
              const float w = expf(d > 0.0f ? 0.0f : d);
              const float cbv = cbc[(int64_t)t * L + s];
              m = cbv * w * dts[s];
              dcb = gv * w * dts[s];
              if (s < t && d <= 0.0f) {
                const float q = gv * m;
                rowq[i][e >> 1] += q;
                colqv[e & 1] += q;
              }
              coldv[e & 1] += gv * cbv * w;
            }
            ms[t * Ly::m + s] = m;
            dcbs[t * Ly::dcb + s] = dcb;
          }
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float q = group_sum(colqv[e]), w = group_sum(coldv[e]);
          if (ln.g == 0) {
            const int s = ln.dcol(j0 + j, e);
            colq[ln.wr * L + s] = q;
            cold[ln.wr * L + s] = w;
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < ML; ++i)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const float v = quad_sum(rowq[i][hf]);
        if (ln.t == 0) rowp[ln.wc * L + ln.drow(i, 2 * hf)] = v;
      }
  }
  __syncthreads();
  for (int r = tid; r < L; r += kThreads) {
    float q = 0.0f;
    for (int w = 0; w < kWC; ++w) q += rowp[w * L + r];
    rq[r] = q;
    float cqv = 0.0f, cdv = 0.0f;
    for (int w = 0; w < kWR; ++w) {
      cqv += colq[w * L + r];
      cdv += cold[w * L + r];
    }
    cq[r] = cqv;
    dd[r] = cdv;
  }

  // dx's first term: M^T dy (rows s, columns p; K = t >= s)
  float dxm[1][NPS][4], bds[1][NPS][4];
  zero(dxm);
  zero(bds);
  mma3(dxm, sl, 0, L, [&](int s, int t) { return ms[t * Ly::m + s]; },
       [&](int t, int p) { return dys[t * Ly::dy + p]; },
       [&](int, int, int kk) { return kk + 7 >= sl.row(0); });
  __syncthreads();  // M is read; its space takes the slabs

  // slabs of 32 state columns: B dS (for dx), this head's dC and dB
  float yi[2] = {0.0f, 0.0f}, sd = 0.0f;
#pragma unroll 1
  for (int n0 = 0; n0 < NP; n0 += kSlab) {
    for (int e = tid; e < L * kSlab; e += kThreads) {
      const int t = e / kSlab, k = e % kSlab, n = n0 + k;
      bsl[t * Ly::b + k] = n < N ? bm[(row0 + t) * N + n] : 0.0f;
      csl[t * Ly::c + k] = n < N ? cm[(row0 + t) * N + n] : 0.0f;
    }
    for (int e = tid; e < P * kSlab; e += kThreads) {
      const int pp = e / kSlab, k = e % kSlab;
      sps[pp * Ly::s + k] = states[soff + (int64_t)pp * NP + n0 + k];
      dss[pp * Ly::ds + k] = ds[soff + (int64_t)pp * NP + n0 + k];
    }
    __syncthreads();
    for (int e = tid; e < P * kSlab; e += kThreads) {
      const int pp = e / kSlab, k = e % kSlab;
      sd += sps[pp * Ly::s + k] * dss[pp * Ly::ds + k];
    }
    // B dS: rows s, columns p, K = the slab's n
    mma3(bds, sl, 0, kSlab, [&](int s, int k) { return bsl[s * Ly::b + k]; },
         [&](int k, int pp) { return dss[pp * Ly::ds + k]; }, Always());
    // dC = dCB B + exp(lc) (dy S^T): rows t, the slab's columns
    {
      float acc[1][NSS][4], st[1][NSS][4];
      zero(acc);
      zero(st);
      mma3(acc, sl, 0, L, [&](int t, int s) { return dcbs[t * Ly::dcb + s]; },
           [&](int s, int k) { return bsl[s * Ly::b + k]; },
           [&](int, int, int kk) { return kk <= sl.row(0) + 15; });
      mma3(st, sl, 0, P, [&](int t, int pp) { return dys[t * Ly::dy + pp]; },
           [&](int pp, int k) { return sps[pp * Ly::s + k]; }, Always());
#pragma unroll
      for (int j = 0; j < NSS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = sl.drow(0, e), k = sl.dcol(j, e), n = n0 + k;
          const float dcs = elcs[t] * st[0][j][e];
          yi[e >> 1] += dcs * csl[t * Ly::c + k];
          if (n < N) dch[((row0 + t) * H + h) * N + n] = acc[0][j][e] + dcs;
        }
    }
    // dB = dCB^T C + bw (x dS^T): rows s, the slab's columns
    {
      float acc[1][NSS][4], st[1][NSS][4];
      zero(acc);
      zero(st);
      mma3(acc, sl, 0, L, [&](int s, int t) { return dcbs[t * Ly::dcb + s]; },
           [&](int t, int k) { return csl[t * Ly::c + k]; },
           [&](int, int, int kk) { return kk + 7 >= sl.row(0); });
      mma3(st, sl, 0, P, [&](int s, int pp) { return xs[s * Ly::x + pp]; },
           [&](int pp, int k) { return dss[pp * Ly::ds + k]; }, Always());
#pragma unroll
      for (int j = 0; j < NSS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int s = sl.drow(0, e), n = n0 + sl.dcol(j, e);
          if (n < N)
            dbh[((row0 + s) * H + h) * N + n] =
                acc[0][j][e] + bws[s] * st[0][j][e];
        }
    }
    __syncthreads();  // the slabs are read
  }

  // dx = M^T dy + bw (B dS); r_s = <B_s x_s^T, dS> = x_s . (B dS)_s
  {
    float r[2] = {0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < NPS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int s = sl.drow(0, e), pp = sl.dcol(j, e);
        r[e >> 1] += xs[s * Ly::x + pp] * bds[0][j][e];
        dx[(row0 + s) * xrow + (int64_t)h * P + pp] =
            dxm[0][j][e] + bws[s] * bds[0][j][e];
      }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const float rv = quad_sum(r[hf]), yv = quad_sum(yi[hf]);
      if (sl.t == 0) {
        rowp[sl.cg * L + sl.drow(0, 2 * hf)] = rv;
        yp[sl.cg * L + sl.drow(0, 2 * hf)] = yv;
      }
    }
  }
  // <S, dS> over the block, in a fixed order
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sd += __shfl_xor_sync(0xffffffffu, sd, o);
  if (tid % 32 == 0) red[tid / 32] = sd;
  __syncthreads();
  for (int r = tid; r < L; r += kThreads) {
    float rv = 0.0f, yv = 0.0f;
    for (int w = 0; w < RC; ++w) {
      rv += rowp[w * L + r];
      yv += yp[w * L + r];
    }
    rs[r] = rv;
    yint[r] = yv;
  }
  __syncthreads();

  // dlc row by row; then warp 0: the state update's last-row terms, dg
  // (the reverse cumsum of dlc in the chunk: each lane a run of L / 32
  // rows, the runs above it by a suffix scan over the lanes) and da's
  // share, each sum in a fixed order
  for (int t = tid; t < L; t += kThreads) {
    const float term = bws[t] * rs[t];
    rq[t] = rq[t] - cq[t] + yint[t] - term;
    cq[t] = term;  // the column sums are spent: cq holds the terms
  }
  __syncthreads();
  if (tid < 32) {
    constexpr int R = L / 32;
    const int lane = tid;
    float terms = 0.0f, total = 0.0f;
    for (int t = lane; t < L; t += 32) terms += cq[t];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      terms += __shfl_xor_sync(0xffffffffu, terms, o);
    for (int w = 0; w < kThreads / 32; ++w) total += red[w];
    float dl[R], run = 0.0f;
#pragma unroll
    for (int k = 0; k < R; ++k) dl[k] = rq[lane * R + k];
    if (lane == 31) dl[R - 1] += elcs[L - 1] * total + terms;
#pragma unroll
    for (int k = R - 1; k >= 0; --k) run += dl[k];
    float above = run;  // inclusive suffix over lanes, then shifted
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float v = __shfl_down_sync(0xffffffffu, above, o);
      if (lane + o < 32) above += v;
    }
    above = __shfl_down_sync(0xffffffffu, above, 1);
    if (lane == 31) above = 0.0f;
    float da = 0.0f;
#pragma unroll
    for (int k = R - 1; k >= 0; --k) {
      above += dl[k];
      dgs[lane * R + k] = above;
      da += dts[lane * R + k] * above;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) da += __shfl_xor_sync(0xffffffffu, da, o);
    if (lane == 0) dapart[((int64_t)b * nc + c) * H + h] = da;
  }
  __syncthreads();
  const float ah = a[(b / a_group) * H + h];
  for (int s = tid; s < L; s += kThreads)
    ddt[(row0 + s) * H + h] =
        ah * dgs[s] + dd[s] + expf(lcs[L - 1] - lcs[s]) * rs[s];
}

// ------------------------------------------------ passes 4 and 5: the sums

// dB and dC at (b, t, n): the heads' shares summed in head order.
__global__ void __launch_bounds__(kThreads)
    ssd_bwd_reduce_bc(const float* __restrict__ dbh,
                      const float* __restrict__ dch, float* __restrict__ dbm,
                      float* __restrict__ dcm, int64_t rows, int H, int N) {
  const int64_t e = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (e >= rows * N) return;
  const int64_t r = e / N;
  const int n = (int)(e % N);
  const float* pb = dbh + r * H * N + n;
  const float* pc = dch + r * H * N + n;
  float sb = 0.0f, sc = 0.0f;
  for (int h = 0; h < H; ++h) {
    sb += pb[(int64_t)h * N];
    sc += pc[(int64_t)h * N];
  }
  dbm[e] = sb;
  dcm[e] = sc;
}

// da at (row, h): the chunks' shares of the row's batch elements, summed
// by element, then chunk.
__global__ void __launch_bounds__(kThreads)
    ssd_bwd_reduce_a(const float* __restrict__ dapart, float* __restrict__ da,
                     int rows, int a_group, int nc, int H) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= rows * H) return;
  const int row = e / H, h = e % H;
  float acc = 0.0f;
  for (int bi = row * a_group; bi < (row + 1) * a_group; ++bi)
    for (int c = 0; c < nc; ++c) acc += dapart[((int64_t)bi * nc + c) * H + h];
  da[e] = acc;
}

// ------------------------------------------------------------------ host

int state_cols(int n) { return n <= 32 ? 32 : n <= 64 ? 64 : 128; }

template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int P, int NP>
cudaError_t launch_dstate(const float* dy, const float* cm, const float* lc,
                          float* ds, int batch, int S, int H, int N, int L,
                          cudaStream_t st) {
  const int bytes = 4 * dstate_smem_floats(L, P, NP);
  cudaError_t err = allow_smem(ssd_bwd_chunk_dstate<P, NP>, bytes);
  if (err != cudaSuccess) return err;
  ssd_bwd_chunk_dstate<P, NP><<<dim3(S / L, H, batch), kThreads, bytes, st>>>(
      dy, cm, lc, ds, S, H, N, L);
  return cudaGetLastError();
}

template <int P>
cudaError_t dstate_np(const float* dy, const float* cm, const float* lc,
                      float* ds, int batch, int S, int H, int N, int NP,
                      int L, cudaStream_t st) {
  switch (NP) {
    case 32:
      return launch_dstate<P, 32>(dy, cm, lc, ds, batch, S, H, N, L, st);
    case 64:
      return launch_dstate<P, 64>(dy, cm, lc, ds, batch, S, H, N, L, st);
    default:
      return launch_dstate<P, 128>(dy, cm, lc, ds, batch, S, H, N, L, st);
  }
}

struct ChunkArgs {
  const float *x, *dt, *a;
  int a_group;
  const float *bm, *cm, *dy, *lc, *states, *cb, *ds;
  float *dx, *ddt, *dbh, *dch, *dapart;
  int batch, S, H, N, NP;
};

template <int L, int P>
cudaError_t launch_chunk(const ChunkArgs& g, cudaStream_t st) {
  const int bytes = 4 * ChunkLayout<L, P>::floats;
  cudaError_t err = allow_smem(ssd_bwd_chunk<L, P>, bytes);
  if (err != cudaSuccess) return err;
  ssd_bwd_chunk<L, P><<<dim3(g.S / L, g.H, g.batch), kThreads, bytes, st>>>(
      g.x, g.dt, g.a, g.a_group, g.bm, g.cm, g.dy, g.lc, g.states, g.cb, g.ds,
      g.dx, g.ddt, g.dbh, g.dch, g.dapart, g.S, g.H, g.N, g.NP);
  return cudaGetLastError();
}

template <int P>
cudaError_t chunk_l(const ChunkArgs& g, int L, cudaStream_t st) {
  switch (L) {
    case 32:
      return launch_chunk<32, P>(g, st);
    case 64:
      return launch_chunk<64, P>(g, st);
    default:
      return launch_chunk<128, P>(g, st);
  }
}

}  // namespace

// The gradients of ssd_scan_f32 (csrc/ssd_scan.cu) at x (batch, S, H, P),
// dt (batch, S, H), a (batch / a_group, H), bm / cm (batch, S, N), given
// dy (batch, S, H, P) and dh (batch, H, N, P) or NULL for zeros, and what
// that forward wrote: lc (batch, H, S), the states entering each chunk
// (batch, S / chunk, H, P, Np) and C B^T (batch, S / chunk, chunk, chunk).
// All contiguous float32 on the device; chunk in {32, 64, 128}, P in {32,
// 64}, N at most 128, Np = N rounded up to 32, 64 or 128
// (kernels/ssd_scan.py checks the shape). Writes dx, ddt, da (batch /
// a_group, H), dbm, dcm and dh0 (batch, H, N, P); work holds
// kernels/ssd_scan.py::bwd_work_floats floats: dS (batch, S / chunk, H, P,
// Np), the heads' dB and dC shares (batch, S, H, N) each, the chunks' da
// shares (batch, S / chunk, H). Launches the five passes on ``stream`` and
// returns the first cudaError, 0 if none.
extern "C" int ssd_scan_bwd_f32(
    const float* x, const float* dt, const float* a, int a_group,
    const float* bm, const float* cm, const float* dy, const float* dh,
    const float* lc, const float* states, const float* cb, float* dx,
    float* ddt, float* da, float* dbm, float* dcm, float* dh0, float* work,
    int batch, int S, int H, int P, int N, int chunk, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int L = chunk, nc = S / L, NP = state_cols(N);
  float* ds = work;
  float* dbh = ds + (int64_t)batch * nc * H * P * NP;
  float* dch = dbh + (int64_t)batch * S * H * N;
  float* dapart = dch + (int64_t)batch * S * H * N;

  cudaError_t err =
      P == 32 ? dstate_np<32>(dy, cm, lc, ds, batch, S, H, N, NP, L, st)
              : dstate_np<64>(dy, cm, lc, ds, batch, S, H, N, NP, L, st);
  if (err != cudaSuccess) return (int)err;

  ssd_bwd_state_pass<<<dim3(NP / 32, H, batch), kCarryThreads, 0, st>>>(
      lc, dh, ds, dh0, S, H, P, N, NP, L);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const ChunkArgs g{x,  dt,  a,   a_group, bm,     cm,    dy, lc, states, cb,
                    ds, dx,  ddt, dbh,     dch,    dapart, batch, S, H, N,
                    NP};
  err = P == 32 ? chunk_l<32>(g, L, st) : chunk_l<64>(g, L, st);
  if (err != cudaSuccess) return (int)err;

  const int64_t rows = (int64_t)batch * S;
  ssd_bwd_reduce_bc<<<(unsigned)((rows * N + kThreads - 1) / kThreads),
                      kThreads, 0, st>>>(dbh, dch, dbm, dcm, rows, H, N);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int a_rows = batch / a_group;
  ssd_bwd_reduce_a<<<(a_rows * H + kThreads - 1) / kThreads, kThreads, 0,
                     st>>>(dapart, da, a_rows, a_group, nc, H);
  return (int)cudaGetLastError();
}
