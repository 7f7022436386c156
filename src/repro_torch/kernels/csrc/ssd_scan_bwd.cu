// Backward of the Mamba-2 chunked SSD scan (csrc/ssd_scan.cu): the
// gradients of y and the final state with respect to x, dt, a, B, C and the
// initial state.
//
// A kernel of the port's own: the Pallas TPU kernel
// src/repro/kernels/ssd_scan.py has no backward (the reference trains
// through its jnp chunked scan, src/repro/kernels/ref.py ssd_chunked_ref,
// under jax.grad). The function is kernels/ref.py ssd_scan_bwd_ref's, and
// the order of its sums ssd_scan_bwd_gemm_ref's. Per (batch, head) and
// chunk of length L, with lc the cumsum of dt a, w_ts = exp(min(lc_t -
// lc_s, 0)) for s <= t, M = (C B^T) w dt_s, bw = exp(lc_L - lc) dt, S the
// state entering the chunk and dS the gradient of the state leaving it:
//   dS before the chunk = exp(lc_L) dS + sum_t exp(lc_t) C_t dy_t^T;
//   U = B dS^T and Y = C S^T (L x P a head, K = N);
//   G = dy x^T; dx = M^T dy + bw U;
//   dCB = sum_h G w dt_s;
//   dC = dCB B + sum_h (exp(lc) dy) S: one product of depth L + H P;
//   dB = dCB^T C + sum_h (bw x) dS: likewise;
//   dlc: row sums less column sums of G M below the diagonal, plus
//   exp(lc) dy . Y (dy . y_inter), plus the state update's terms (r = x .
//   U); dg its reverse cumsum in the chunk; ddt = a dg + sum_t G (C.B) w +
//   exp(lc_L - lc) r; da = sum over (b, S) of dt dg.
// Only exponentials of differences that are <= 0 are formed (and exp(lc),
// lc <= 0 for a < 0), as the forward forms them.
//
// Seven device kernels on the caller's stream:
//
// 0. ssd_bwd_gemm<V>, block (head, (batch, chunk)): V = (exp(lc) dy)^T C
//    (P x Np, K = L) into the dS scratch (b, chunks, H, P, Np), the
//    forward's state layout; lc is the forward's, saved with its entering
//    states and C B^T (kernels/ssd_scan.py SsdScan).
// 1. ssd_bwd_state_pass, block (32 state columns, head, batch): the
//    forward's carry reversed, chunk by chunk from the last: slot c gets
//    dS leaving chunk c, then dS = exp(lc_L of c) dS + V_c; from dh_final
//    or zeros; dh0 out.
// 2. ssd_bwd_gemm<UY>, block (64 rows, NB columns of H P, U or Y and
//    (batch, chunk)): U = B dS^T and Y = C S^T for every head at once,
//    K = Np, into (b, S, H, P) scratches.
// 3. ssd_bwd_chunk, block (chunk, group of hg heads, batch): C B^T stays in
//    shared memory for the group; each head's dy, x, lc and dt are copied
//    by cp.async into one of two buffers while the head before computes.
//    Per head: G, its lc terms and this head's dCB (summed over the group
//    in registers, in head order); M^T dy with M's fragments formed from
//    C B^T, lc and dt as they are read (no M tile), over the K steps from
//    the warp's rows on; dx; r and dy . Y; <S, dS>; dlc, dg, ddt and the
//    chunk's share of da. Then the group's dCB.
// 4. ssd_bwd_reduce_cb: dCB summed over the groups in order.
// 5. ssd_bwd_gemm<BC>, block (64 rows, dC or dB and (batch, chunk)): dC =
//    [dCB | exp(lc) dy] [B ; S] and dB = [dCB^T | bw x] [C ; dS] over K =
//    the causal part of L, then H P: the heads' state terms summed inside
//    one product, so no head's share of dB or dC goes through memory.
// 6. ssd_bwd_reduce_a: da summed over (batch element, chunk) in order.
//
// Deterministic: no atomics. Every sum has one owner and one fixed order
// (the groups' dCB and the chunks' da go through scratch to the
// reductions), so two runs give the same bits.
//
// Bound at mamba2-130m's training shape (b, S, H, P, N, L) = (4, 2048, 24,
// 64, 128, 128) (chip_smoke.py ssd_bwd_bound): 16.4 GFLOP of products,
// 0.0994 ms as 3xTF32 on the tensor cores; 169 MB read and written once,
// 0.051 ms. At jamba-v0.1-52b's (4, 2048, 128, 64, 16): 816 MB, 0.244 ms,
// so bytes; 25.9 GFLOP, 0.157 ms.
// This design at mamba's shape (hg = 3, 8 groups): 19.9 GFLOP of products
// (the chunk pass's G and M^T dy over the causal half; dC and dB over the
// whole K = L + H P), 0.121 ms as 3xTF32; ~1.07 GB through memory (pass
// 0 106 MB, 1 101, 2 210, 3 392, 4 38, 5 222), 0.32 ms at 3.35 TB/s: U and
// Y (50 MB each) are written and read back, dy and x are read by passes
// 3 and 5, S and dS by passes 2 and 3. At jamba's (hg = 8, 16 groups; N
// padded to 32 state columns): 38.9 GFLOP, 0.236 ms; ~3.46 GB, 1.03 ms (U
// and Y 268 MB each, dy and x 268 MB each, twice).
//
// Products. Passes 0, 2 and 5 (GEMMs with both operands stored K-major in
// shared memory): 3xTF32 wgmma, K4's slabs (csrc/ssd_scan.cu): each
// operand split once into hi = tf32(v), lo = tf32(v - hi) as it is stored,
// 32-deep slabs of 128-byte swizzled rows, lo.hi + hi.lo + hi.hi into a
// fresh float32 sum per slab added on the CUDA cores; raw rows copied by
// cp.async two slabs ahead into two stages, transposed (B, C, S, dS as the
// products' K-major B operand; dy^T, dCB^T), scaled (exp(lc), bw) and
// split from there. 99 KB of shared memory: two blocks an SM. Pass 3:
// mma.sync m16n8k8, TF32 operands split as their fragments are loaded:
// pass 3's operands are read in both orientations (dy as G's A and M^T
// dy's B), M is formed as it is read, and a warpgroup's 64-row tiles do
// not fit the chunk's triangle; its tiles as the earlier design's (G on
// a 2 x 4 warp grid, the L-row products one warp a 16-row tile), 216 KB
// of shared memory (C B^T L rows of L + 8, two head buffers of dy and x,
// L rows of P + 4, and lc, dt; 20 arrays of L): one block of 8 warps an
// SM, its loads overlapped by the next head's cp.async.
//
// What bounds it: pass 3, near half the time at mamba's shape and 60% at
// jamba's (PERF.md §6): one block of 8 warps an SM, latency-bound, its
// products (G and M^T dy: mma.sync, operands split as loaded, M formed
// with an exp per element) and its chunk tail serialised by the block's
// barriers; then the GEMM passes, a few slabs' loads in flight a block,
// at 40-60% of their bytes' time. N = 16 keeps 32 state columns: the
// forward's tiles and the carry's 32-column blocks take them
// (kernels/ssd_scan.py state_cols). The elementwise terms keep the plain
// version's order of operations under the build's -fmad=false.
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"
#include "tf32_slabs.cuh"

namespace {

using namespace hopper;

constexpr int kThreads = 256;
constexpr int kWR = 2, kWC = 4;  // the 8 warps as 2 rows x 4 columns of tiles

// Leading dimensions (floats) of the mma.sync passes' shared-memory tiles,
// by how the fragment loads read them: rows of n + 4 for a tile read
// along its rows (the K index contiguous: 32 banks for 8 rows x 4 K of a
// fragment), n + 8 for one read down its columns (8 columns x 4 K).
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
// operand spans the chunk's L rows, each row is loaded and split once a
// block, not once per column group. The two warps of a scheduler (w and
// w + 4) take tiles from opposite ends, so the causal products' K ranges
// balance between schedulers.
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

// ------------------------------------------------ GEMM slabs

constexpr int kRawA = kRows * kSlab * 4;  // a raw A slab, 8 KB

__host__ __device__ constexpr int stage_bytes(int nb) {
  return kRawA + nb * 128;
}
// The GEMM block: one operand buffer (tf32_slabs.cuh), two raw stages (A,
// and B's 32 x NB or NB x 32 floats), 1 KB for the swizzle's alignment.
__host__ __device__ constexpr int gemm_smem(int nb) {
  return buf_bytes(nb) + 2 * stage_bytes(nb) + 1024;
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}
// Four floats of column ``col`` from four rows ``stride`` bytes apart.
__device__ __forceinline__ float4 lds_col(uint32_t addr, int stride) {
  return make_float4(lds(addr), lds(addr + stride), lds(addr + 2 * stride),
                     lds(addr + 3 * stride));
}

// ------------------------------------------------ pass 1: the reverse carry

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

// ------------------------------------------------ passes 0, 2 and 5: GEMMs

enum GemmKind { kV = 0, kUY = 1, kBC = 2 };

struct GemmArgs {
  const float *bm, *cm, *states, *ds, *dy, *x, *dt, *lc, *dcb;
  float *v, *u, *y, *dbm, *dcm;  // v: the dS scratch, V written there
  int batch, S, H, P, N, NP, L;
  int tiles;  // UY: column tiles a block (1 for V and BC)
};

// Block (64 rows from t0, NB columns, (which, batch, chunk)); 64 x NB of
// the output as 3xTF32 wgmma over K slabs of 32 (csrc/ssd_scan.cu's slab
// loop: each slab's raw rows by cp.async into one of two stages two slabs
// ahead, then split, transposed and scaled into the operand buffer). A
// UY block takes ``tiles`` column tiles in turn, the slabs of all of them
// in one stream.
//
// V (NB = NP; blockIdx.y the head h): V (P x NP) = (exp(lc) dy)^T C over
// K = t: A = dy^T (rows p, transposed from dy's rows t, scaled by
// exp(lc_t)), B = C rows t, transposed to rows n. Out to the dS scratch at
// (b, c, h), rows of NP.
// UY (which 0: U, 1: Y): rows t, columns NB of H P from (blockIdx.y
// tiles + tile) NB, K = n: A = B (or C) rows t, B = dS (or S) rows (h,
// p), both K-major as they lie. Out to U (or Y) (b, S, H, P).
// BC (which 0: dC, 1: dB; NB = NP): rows t (dB: s), K = the dCB slabs of
// the causal part (dC: s < t0 + 64; dB: t >= t0), then H P: A = dCB (dB:
// dCB^T, transposed from its rows) then exp(lc) dy (dB: bw x), a slab of
// H P lying in one head; B = B (dB: C) rows, then S (dB: dS) rows (h, p),
// transposed to rows n. Out to dC (dB) (b, S, N).
template <int NB, int KIND>
__global__ void __launch_bounds__(kThreads, 2)
    ssd_bwd_gemm(const GemmArgs g) {
  const int tid = threadIdx.x, L = g.L, N = g.N, NP = g.NP;
  const int nc = g.S / L, nbc = g.batch * nc;
  const int which = blockIdx.z / nbc, bc = blockIdx.z % nbc;
  const int b = bc / nc, c = bc % nc, t0 = kRows * blockIdx.x;
  const int HP = g.H * g.P;
  const int64_t row0 = (int64_t)b * g.S + (int64_t)c * L;
  const uint32_t buf = smem_base(), raw = buf + buf_bytes(NB);
  constexpr int kStage = stage_bytes(NB);
  const bool n_aligned = N % 4 == 0;
  int nd = 0, dlo = 0, nk;
  __shared__ float elcs[128];  // V: exp(lc) of the chunk's rows
  if constexpr (KIND == kV) {
    nk = L / kSlab;
    const float* lch =
        g.lc + ((int64_t)b * g.H + blockIdx.y) * g.S + (int64_t)c * L;
    for (int t = tid; t < L; t += kThreads) elcs[t] = expf(lch[t]);
  } else if constexpr (KIND == kUY) {
    nk = NP / kSlab;
  } else {
    dlo = which == 0 ? 0 : t0 / kSlab;
    const int dhi = (which == 0 ? min(L, t0 + kRows) : L) / kSlab;
    nd = dhi - dlo;
    nk = nd + HP / kSlab;
  }

  // 4 values of a (rows, N) row of B or C from column n, zeros past N
  auto cp_bc = [&](uint32_t dst, const float* m, int64_t row, int n,
                   bool ok) {
    const float* src = m + row * N + n;
    if (n_aligned) {
      cp16(dst, ok && n < N ? src : m, ok && n < N ? 16 : 0);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        cp4(dst + 4 * j, ok && n + j < N ? src + j : m,
            ok && n + j < N ? 4 : 0);
    }
  };
  // slab j of the stream: tile j / nk, K slab k = j % nk
  const int nj = g.tiles * nk;
  auto fetch = [&](int j) {
    if (j < nj) {
      const int k = j % nk, col0 = NB * (blockIdx.y * g.tiles + j / nk);
      const uint32_t st = raw + (j & 1) * kStage, sb = st + kRawA;
      if constexpr (KIND == kV) {
        const float* d = g.dy + (row0 + kSlab * k) * HP + blockIdx.y * g.P;
#pragma unroll
        for (int i = 0; i < 2; ++i) {  // dy rows t, columns p: [32][64]
          const int e = tid + kThreads * i, r = e / 16, q = e % 16;
          const bool ok = 4 * q < g.P;
          cp16(st + (r * 64 + 4 * q) * 4, ok ? d + (int64_t)r * HP + 4 * q : d,
               ok ? 16 : 0);
        }
#pragma unroll 1
        for (int i = 0; i < NB / 32; ++i) {  // C raw [32][NB]
          const int e = tid + kThreads * i, r = e / (NB / 4);
          const int n = 4 * (e % (NB / 4));
          cp_bc(sb + (r * NB + n) * 4, g.cm, row0 + kSlab * k + r, n, true);
        }
      } else if constexpr (KIND == kUY) {
        const float* m = which ? g.cm : g.bm;
        const int n0 = kSlab * k;
#pragma unroll
        for (int i = 0; i < 2; ++i) {  // A raw [64][32]
          const int e = tid + kThreads * i, r = e / 8, q = e % 8;
          cp_bc(st + (r * 32 + 4 * q) * 4, m, row0 + t0 + r, n0 + 4 * q,
                t0 + r < L);
        }
        const float* s_ =
            (which ? g.states : g.ds) + ((int64_t)bc * HP + col0) * NP + n0;
#pragma unroll
        for (int i = 0; i < NB / 32; ++i) {  // B raw [NB][32]
          const int e = tid + kThreads * i, r = e / 8, q = e % 8;
          cp16(sb + (r * 32 + 4 * q) * 4, s_ + (int64_t)r * NP + 4 * q, 16);
        }
      } else {
        if (k < nd) {
          const int kk = dlo + k;  // 32-row slab of the chunk
          const float* d = g.dcb + (int64_t)bc * L * L;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int e = tid + kThreads * i;
            if (which == 0) {  // dCB rows t0 + r, columns 32 kk ..: [64][32]
              const int r = e / 8, q = e % 8;
              const bool ok = t0 + r < L;
              cp16(st + (r * 32 + 4 * q) * 4,
                   ok ? d + (int64_t)(t0 + r) * L + 32 * kk + 4 * q : d,
                   ok ? 16 : 0);
            } else {  // dCB rows 32 kk + r, columns t0 ..: [32][64]
              const int r = e / 16, q = e % 16;
              const bool ok = t0 + 4 * q < L;
              cp16(st + (r * 64 + 4 * q) * 4,
                   ok ? d + (int64_t)(32 * kk + r) * L + t0 + 4 * q : d,
                   ok ? 16 : 0);
            }
          }
          const float* m = which == 0 ? g.bm : g.cm;
#pragma unroll 1
          for (int i = 0; i < NB / 32; ++i) {  // B raw [32][NB], rows s / t
            const int e = tid + kThreads * i, r = e / (NB / 4);
            const int n = 4 * (e % (NB / 4));
            cp_bc(sb + (r * NB + n) * 4, m, row0 + 32 * kk + r, n, true);
          }
        } else {
          const int k0 = kSlab * (k - nd);  // column of H P
          const float* src = which == 0 ? g.dy : g.x;
#pragma unroll
          for (int i = 0; i < 2; ++i) {  // A raw [64][32]
            const int e = tid + kThreads * i, r = e / 8, q = e % 8;
            const bool ok = t0 + r < L;
            cp16(st + (r * 32 + 4 * q) * 4,
                 ok ? src + (row0 + t0 + r) * HP + k0 + 4 * q : src,
                 ok ? 16 : 0);
          }
          const float* s_ =
              (which == 0 ? g.states : g.ds) + ((int64_t)bc * HP + k0) * NP;
          for (int e = tid; e < 8 * NB; e += kThreads)  // B raw [32][NB]
            cp16(sb + 16 * e, s_ + 4 * e, 16);
        }
      }
    }
    cp_commit();
  };

  auto put = [&](int j) {
    const int k = j % nk;
    const uint32_t st = raw + (j & 1) * kStage, sb = st + kRawA;
    const uint32_t bb = buf + 2 * kATile;
    if constexpr (KIND == kV) {
      // A = (exp(lc) dy)^T: row p, K = t, down the raw rows t
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int e = tid + kThreads * i, p = e % 64, c4 = e / 64;
        const float* w = elcs + kSlab * k + 4 * c4;
        const float4 v = lds_col(st + (4 * c4 * 64 + p) * 4, 256);
        put4(buf, kATile, p, c4,
             make_float4(v.x * w[0], v.y * w[1], v.z * w[2], v.w * w[3]));
      }
    } else if constexpr (KIND == kUY) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int e = tid + kThreads * i, r = e / 8, c4 = e % 8;
        put4(buf, kATile, r, c4, lds4(st + (r * 32 + 4 * c4) * 4));
      }
#pragma unroll
      for (int i = 0; i < NB / 32; ++i) {
        const int e = tid + kThreads * i, r = e / 8, c4 = e % 8;
        put4(bb, NB * 128, r, c4, lds4(sb + (r * 32 + 4 * c4) * 4));
      }
    } else {
      if (k < nd && which == 1) {
        // A = dCB^T: row s, K = t, down the raw rows t
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int e = tid + kThreads * i, s = e % 64, c4 = e / 64;
          put4(buf, kATile, s, c4, lds_col(st + (4 * c4 * 64 + s) * 4, 256));
        }
      } else {
#pragma unroll 1
        for (int i = 0; i < 2; ++i) {
          const int e = tid + kThreads * i, r = e / 8, c4 = e % 8;
          float4 v = lds4(st + (r * 32 + 4 * c4) * 4);
          if (k >= nd) {
            // exp(lc_t) (dC) or bw_s = exp(lc_L - lc_s) dt_s (dB) of the
            // slab's head; rows past the chunk are zeros
            const int h = kSlab * (k - nd) / g.P, t = t0 + r;
            float sc = 0.0f;
            if (t < L) {
              const float* lch = g.lc + ((int64_t)b * g.H + h) * g.S +
                                 (int64_t)c * L;
              sc = which == 0 ? expf(lch[t])
                              : expf(lch[L - 1] - lch[t]) *
                                    g.dt[(row0 + t) * g.H + h];
            }
            v = make_float4(v.x * sc, v.y * sc, v.z * sc, v.w * sc);
          }
          put4(buf, kATile, r, c4, v);
        }
      }
    }
    if constexpr (KIND != kUY) {
      // B: rows n, K down the raw [32][NB] rows (rolled: unrolled, it
      // passes the 128 registers that two blocks an SM allow, as in K4)
#pragma unroll 1
      for (int i = 0; i < NB / 32; ++i) {
        const int e = tid + kThreads * i, n = e % NB, c4 = e / NB;
        put4(bb, NB * 128, n, c4, lds_col(sb + (4 * c4 * NB + n) * 4,
                                          NB * 4));
      }
    }
  };

  float acc[NB / 4], fresh[NB / 4];
#pragma unroll
  for (int i = 0; i < NB / 4; ++i) acc[i] = 0.0f;
  const Frag f(NB);
  // acc, the 64 x NB output of column tile ``tile``
  auto store = [&](int tile) {
    if constexpr (KIND == kV) {
      float* out = g.v + ((int64_t)bc * g.H + blockIdx.y) * g.P * NP;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = f.r0 + 8 * i;
        if (r < g.P) {
#pragma unroll
          for (int j = 0; j < NB / 16; ++j)
            *reinterpret_cast<float2*>(out + (int64_t)r * NP + 8 * j +
                                       f.c0) =
                make_float2(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
        }
      }
    } else if constexpr (KIND == kUY) {
      float* out = (which ? g.y : g.u) + (row0 + t0) * HP +
                   NB * (blockIdx.y * g.tiles + tile);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = f.r0 + 8 * i;
        if (t0 + r < L) {
#pragma unroll
          for (int j = 0; j < NB / 16; ++j)
            *reinterpret_cast<float2*>(out + (int64_t)r * HP + 8 * j +
                                       f.c0) =
                make_float2(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
        }
      }
    } else {
      float* out = (which ? g.dbm : g.dcm) + (row0 + t0) * N;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = f.r0 + 8 * i;
        if (t0 + r < L) {
#pragma unroll
          for (int j = 0; j < NB / 16; ++j) {
            const int n = 8 * j + f.c0;
            if (n < N) out[(int64_t)r * N + n] = acc[4 * j + 2 * i];
            if (n + 1 < N)
              out[(int64_t)r * N + n + 1] = acc[4 * j + 2 * i + 1];
          }
        }
      }
    }
  };

  fetch(0);
  fetch(1);
  for (int j = 0; j < nj; ++j) {
    // slab j's copies landed, in every thread; the buffer's last products
    // done, in every warp
    cp_wait<1>();
    wgmma_wait<0>();
    __syncthreads();
    put(j);
    run_slab<NB>(fresh, acc, j % nk != 0, buf);
    fetch(j + 2);  // into the stage just read (every thread is past it)
    if constexpr (KIND == kUY) {
      if (j % nk == nk - 1) {  // the tile's last slab: out, a fresh sum
        absorb<NB>(acc, fresh);
        store(j / nk);
#pragma unroll
        for (int i = 0; i < NB / 4; ++i) acc[i] = 0.0f;
      }
    }
  }
  if constexpr (KIND != kUY) {
    absorb<NB>(acc, fresh);
    store(0);
  }
}

// ------------------------------------------------ pass 3: the chunk

// Pass 3's shared memory (floats): C B^T (L rows of L + 8), two head
// buffers (dy and x, L rows of P + 4 each, lc, dt), eight arrays of L,
// 4 + 4 + 2 + 2 rows of L of partial sums, 32 floats.
template <int L, int P>
struct ChunkLayout {
  static constexpr int cb = ld8(L), dy = ld4(P), x = ld4(P);
  static constexpr int head = L * dy + L * x + 2 * L;
  static constexpr int floats =
      L * cb + 2 * head + 8 * L + 2 * kWC * L + 2 * kWR * L + 32;
};

// Block (chunk c, group of hg heads, batch b), 8 warps: for each head of
// the group in order, G on the 2 x 4 grid (Lane), M^T dy one warp a row
// tile (RowLane); the group's dCB held in registers in G's fragments.
template <int L, int P>
__global__ void __launch_bounds__(kThreads, 1)
    ssd_bwd_chunk(const float* __restrict__ x, const float* __restrict__ dt,
                  const float* __restrict__ a, int a_group,
                  const float* __restrict__ dy, const float* __restrict__ lc,
                  const float* __restrict__ states,
                  const float* __restrict__ cb, const float* __restrict__ ds,
                  const float* __restrict__ u, const float* __restrict__ yv,
                  float* __restrict__ dx,
                  float* __restrict__ ddt, float* __restrict__ dcbg,
                  float* __restrict__ dapart, int S, int H, int NP, int hg) {
  using Ly = ChunkLayout<L, P>;
  // tiles a warp holds: of an L x L product (columns in NG groups of NTG
  // tiles); of the L x P output of M^T dy
  constexpr int ML = L / (16 * kWR), NL = L / (8 * kWC);
  constexpr int NTG = NL < 2 ? NL : 2, NG = NL / NTG;
  constexpr int RC = RowLane<L>::C;
  constexpr int NPS = P / (8 * RC);
  extern __shared__ __align__(16) float smc[];
  float* cbs = smc;                   // [L][Ly::cb]
  float* hbuf = cbs + L * Ly::cb;     // 2 x (dy, x, lc, dt)
  float* bws = hbuf + 2 * Ly::head;
  float* elcs = bws + L;
  float* rq = elcs + L;    // row sums of G M; then dlc
  float* cq = rq + L;      // column sums of G M; then the update's terms
  float* dd = cq + L;      // sum_t G CB w
  float* rs = dd + L;      // r_s = <B_s x_s^T, dS> = x_s . U_s
  float* yint = rs + L;    // dy . y_inter
  float* dgs = yint + L;
  float* rowp = dgs + L;              // [4][L]: row partials of G M, then r
  float* yp = rowp + kWC * L;         // [4][L]: row partials of dy . Y
  float* colq = yp + kWC * L;         // [2][L]: column partials of G M
  float* cold = colq + kWR * L;       // [2][L]: column partials of G CB w
  float* red = cold + kWR * L;        // [32]

  const int c = blockIdx.x, grp = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int nc = S / L;
  const int64_t row0 = (int64_t)b * S + (int64_t)c * L;
  const int64_t xrow = (int64_t)H * P;
  const Lane ln;
  const RowLane<L> sl;

  // head j's dy and x rows, lc and dt by cp.async into buffer j % 2, one
  // committed group (empty past the last head)
  auto fetch = [&](int j) {
    if (j < hg) {
      const int h = grp * hg + j;
      float* hb = hbuf + (j & 1) * Ly::head;
      const uint32_t bd = smem_u32(hb), bx = smem_u32(hb + L * Ly::dy);
      const uint32_t bl = smem_u32(hb + 2 * L * Ly::dy), bt = bl + 4 * L;
      for (int e = tid; e < L * P / 4; e += kThreads) {
        const int t = e / (P / 4), q = e % (P / 4);
        const int64_t src = (row0 + t) * xrow + (int64_t)h * P + 4 * q;
        cp16(bd + (t * Ly::dy + 4 * q) * 4, dy + src, 16);
        cp16(bx + (t * Ly::x + 4 * q) * 4, x + src, 16);
      }
      const float* lch = lc + ((int64_t)b * H + h) * S + (int64_t)c * L;
      for (int e = tid; e < L / 4; e += kThreads)
        cp16(bl + 16 * e, lch + 4 * e, 16);
      for (int t = tid; t < L; t += kThreads)
        cp4(bt + 4 * t, dt + (row0 + t) * H + h, 4);
    }
    cp_commit();
  };
  {  // C B^T, with the first head
    const float* cbc = cb + ((int64_t)b * nc + c) * L * L;
    const uint32_t dst = smem_u32(cbs);
    for (int e = tid; e < L * L / 4; e += kThreads) {
      const int t = e / (L / 4), q = e % (L / 4);
      cp16(dst + (t * Ly::cb + 4 * q) * 4, cbc + (int64_t)t * L + 4 * q, 16);
    }
  }
  fetch(0);

  float dcba[ML][NL][4];  // the group's dCB, summed in head order
  zero(dcba);
#pragma unroll 1
  for (int j = 0; j < hg; ++j) {
    fetch(j + 1);
    cp_wait<1>();
    __syncthreads();
    const int h = grp * hg + j;
    const float* hb = hbuf + (j & 1) * Ly::head;
    const float* dys = hb;
    const float* xs = hb + L * Ly::dy;
    const float* lcs = hb + 2 * L * Ly::dy;
    const float* dts = lcs + L;
    for (int t = tid; t < L; t += kThreads) {
      elcs[t] = expf(lcs[t]);
      bws[t] = expf(lcs[L - 1] - lcs[t]) * dts[t];
    }

    // G = dy x^T over the causal tiles, NTG column tiles at a time; the
    // group's dCB and the lc / dt terms from it, M from C B^T
    {
      float rowq[ML][2];
#pragma unroll
      for (int i = 0; i < ML; ++i) rowq[i][0] = rowq[i][1] = 0.0f;
#pragma unroll
      for (int jg = 0; jg < NG; ++jg) {
        const int j0 = jg * NTG;
        float gt[ML][NTG][4];
        zero(gt);
        // mma3 numbers this group's tiles from 0: column s of its tile jj
        // is column s + 8 kWC j0 of G
        mma3(gt, ln, 0, P, [&](int t, int p) { return dys[t * Ly::dy + p]; },
             [&](int p, int s) { return xs[(s + 8 * kWC * j0) * Ly::x + p]; },
             [&](int i, int jj, int) {
               return ln.col(j0 + jj) <= ln.row(i) + 15;
             });
#pragma unroll
        for (int jj = 0; jj < NTG; ++jj) {
          float colqv[2] = {0.0f, 0.0f}, coldv[2] = {0.0f, 0.0f};
#pragma unroll
          for (int i = 0; i < ML; ++i) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int t = ln.drow(i, e), s = ln.dcol(j0 + jj, e);
              const float gv = gt[i][jj][e];
              if (s <= t) {
                // min(d, 0) that keeps a NaN, as the forward's
                const float d = lcs[t] - lcs[s];
                const float w = expf(d > 0.0f ? 0.0f : d);
                const float cbv = cbs[t * Ly::cb + s];
                const float m = cbv * w * dts[s];
                dcba[i][j0 + jj][e] += gv * w * dts[s];
                if (s < t && d <= 0.0f) {
                  const float q = gv * m;
                  rowq[i][e >> 1] += q;
                  colqv[e & 1] += q;
                }
                coldv[e & 1] += gv * cbv * w;
              }
            }
          }
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float q = group_sum(colqv[e]), w = group_sum(coldv[e]);
            if (ln.g == 0) {
              const int s = ln.dcol(j0 + jj, e);
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
    __syncthreads();  // rowp is read; it takes r's partials below

    // M^T dy (rows s, columns p; K = t >= s, from the warp's row tile),
    // M_ts formed as read
    float dxm[1][NPS][4];
    zero(dxm);
    mma3(dxm, sl, sl.row(0), L,
         [&](int s, int t) {
           const float d = lcs[t] - lcs[s];
           const float w = expf(d > 0.0f ? 0.0f : d);
           return s <= t ? cbs[t * Ly::cb + s] * w * dts[s] : 0.0f;
         },
         [&](int t, int p) { return dys[t * Ly::dy + p]; },
         [](int, int, int) { return true; });

    // dx = M^T dy + bw U; r_s = x_s . U_s; dy_t . Y_t
    {
      const float* uh = u + row0 * xrow + (int64_t)h * P;
      const float* yh = yv + row0 * xrow + (int64_t)h * P;
      float r[2] = {0.0f, 0.0f}, yi[2] = {0.0f, 0.0f};
#pragma unroll
      for (int jj = 0; jj < NPS; ++jj)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int s = sl.drow(0, 2 * hf), pp = sl.dcol(jj, 0);
          const float2 uv =
              *reinterpret_cast<const float2*>(uh + s * xrow + pp);
          const float2 yy =
              *reinterpret_cast<const float2*>(yh + s * xrow + pp);
          r[hf] += xs[s * Ly::x + pp] * uv.x;
          r[hf] += xs[s * Ly::x + pp + 1] * uv.y;
          yi[hf] += dys[s * Ly::dy + pp] * yy.x;
          yi[hf] += dys[s * Ly::dy + pp + 1] * yy.y;
          *reinterpret_cast<float2*>(dx + (row0 + s) * xrow + (int64_t)h * P +
                                     pp) =
              make_float2(dxm[0][jj][2 * hf] + bws[s] * uv.x,
                          dxm[0][jj][2 * hf + 1] + bws[s] * uv.y);
        }
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const float rv = quad_sum(r[hf]), yv2 = quad_sum(yi[hf]);
        if (sl.t == 0) {
          rowp[sl.cg * L + sl.drow(0, 2 * hf)] = rv;
          yp[sl.cg * L + sl.drow(0, 2 * hf)] = yv2;
        }
      }
    }
    // <S, dS> over the head, in a fixed order
    float sd = 0.0f;
    {
      const int64_t soff = (((int64_t)b * nc + c) * H + h) * P * (int64_t)NP;
      const float4* sp = reinterpret_cast<const float4*>(states + soff);
      const float4* dp = reinterpret_cast<const float4*>(ds + soff);
      for (int e = tid; e < P * NP / 4; e += kThreads) {
        const float4 sv = sp[e], dv = dp[e];
        sd += sv.x * dv.x;
        sd += sv.y * dv.y;
        sd += sv.z * dv.z;
        sd += sv.w * dv.w;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sd += __shfl_xor_sync(0xffffffffu, sd, o);
    if (tid % 32 == 0) red[tid / 32] = sd;
    __syncthreads();
    for (int r = tid; r < L; r += kThreads) {
      float rv = 0.0f, yv2 = 0.0f;
      for (int w = 0; w < RC; ++w) {
        rv += rowp[w * L + r];
        yv2 += yp[w * L + r];
      }
      rs[r] = rv;
      yint[r] = elcs[r] * yv2;
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
      for (int o = 16; o > 0; o >>= 1)
        da += __shfl_xor_sync(0xffffffffu, da, o);
      if (lane == 0) dapart[((int64_t)b * nc + c) * H + h] = da;
    }
    __syncthreads();
    const float ah = a[(b / a_group) * H + h];
    for (int s = tid; s < L; s += kThreads)
      ddt[(row0 + s) * H + h] =
          ah * dgs[s] + dd[s] + expf(lcs[L - 1] - lcs[s]) * rs[s];
    __syncthreads();  // the head's buffer and arrays are free
  }

  // the group's dCB, (t, s) rows of L at (b, c, group)
  float* out = dcbg + (((int64_t)b * nc + c) * gridDim.y + grp) * L * L;
#pragma unroll
  for (int i = 0; i < ML; ++i)
#pragma unroll
    for (int jj = 0; jj < NL; ++jj)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        *reinterpret_cast<float2*>(out + ln.drow(i, 2 * hf) * L +
                                   ln.dcol(jj, 0)) =
            make_float2(dcba[i][jj][2 * hf], dcba[i][jj][2 * hf + 1]);
}

// ------------------------------------------------ passes 4 and 6: the sums

// dCB at (b, c): the groups' shares summed in group order, 4 floats a
// thread.
__global__ void __launch_bounds__(kThreads)
    ssd_bwd_reduce_cb(const float* __restrict__ dcbg, float* __restrict__ dcb,
                      int64_t quads, int ngrp, int tile_quads) {
  const int64_t e = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (e >= quads) return;
  const int64_t tile = e / tile_quads, o = e % tile_quads;
  const float4* src =
      reinterpret_cast<const float4*>(dcbg) + tile * ngrp * tile_quads + o;
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int gi = 0; gi < ngrp; ++gi) {
    const float4 v = src[(int64_t)gi * tile_quads];
    acc = make_float4(acc.x + v.x, acc.y + v.y, acc.z + v.z, acc.w + v.w);
  }
  reinterpret_cast<float4*>(dcb)[e] = acc;
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

template <int NB, int KIND>
cudaError_t launch_gemm(const GemmArgs& g, int cols, cudaStream_t st) {
  const int bytes = gemm_smem(NB);
  cudaError_t err = allow_smem(ssd_bwd_gemm<NB, KIND>, bytes);
  if (err != cudaSuccess) return err;
  // V: one row tile (P <= 64), a head a block; UY and BC: (which, b, c)
  const dim3 grid(KIND == kV ? 1 : (g.L + kRows - 1) / kRows,
                  KIND == kV ? g.H : cols / NB / g.tiles,
                  (KIND == kV ? 1 : 2) * g.batch * (g.S / g.L));
  ssd_bwd_gemm<NB, KIND><<<grid, kThreads, bytes, st>>>(g);
  return cudaGetLastError();
}

// NB columns a block: UY the widest of 128, 64, 32 dividing H P; V and BC
// the state columns
template <int KIND>
cudaError_t gemm_nb(const GemmArgs& g, int nb, int cols, cudaStream_t st) {
  switch (nb) {
    case 32:
      return launch_gemm<32, KIND>(g, cols, st);
    case 64:
      return launch_gemm<64, KIND>(g, cols, st);
    default:
      return launch_gemm<128, KIND>(g, cols, st);
  }
}

struct ChunkArgs {
  const float *x, *dt, *a;
  int a_group;
  const float *dy, *lc, *states, *cb, *ds, *u, *y;
  float *dx, *ddt, *dcbg, *dapart;
  int batch, S, H, NP, hg;
};

template <int L, int P>
cudaError_t launch_chunk(const ChunkArgs& g, cudaStream_t st) {
  const int bytes = 4 * ChunkLayout<L, P>::floats;
  cudaError_t err = allow_smem(ssd_bwd_chunk<L, P>, bytes);
  if (err != cudaSuccess) return err;
  ssd_bwd_chunk<L, P>
      <<<dim3(g.S / L, g.H / g.hg, g.batch), kThreads, bytes, st>>>(
          g.x, g.dt, g.a, g.a_group, g.dy, g.lc, g.states, g.cb, g.ds, g.u,
          g.y, g.dx, g.ddt, g.dcbg, g.dapart, g.S, g.H, g.NP, g.hg);
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
// 64}, N at most 128, Np = N rounded up to 32, 64 or 128, hg (heads a
// chunk-pass block) dividing H (kernels/ssd_scan.py checks the shape and
// picks hg). Writes dx, ddt, da (batch / a_group, H), dbm, dcm and dh0
// (batch, H, N, P); work holds kernels/ssd_scan.py::bwd_work_floats
// floats: dS (batch, S / chunk, H, P, Np), U and Y (batch, S, H, P) each,
// the groups' dCB (batch, S / chunk, H / hg, chunk, chunk), dCB (batch, S
// / chunk, chunk, chunk), the chunks' da shares (batch, S / chunk, H).
// Launches the seven passes on ``stream`` in order, or with ``only`` >= 0
// pass ``only`` alone (to time it on the scratch an earlier call left);
// returns the first cudaError, 0 if none.
extern "C" int ssd_scan_bwd_f32(
    const float* x, const float* dt, const float* a, int a_group,
    const float* bm, const float* cm, const float* dy, const float* dh,
    const float* lc, const float* states, const float* cb, float* dx,
    float* ddt, float* da, float* dbm, float* dcm, float* dh0, float* work,
    int batch, int S, int H, int P, int N, int chunk, int hg, int only,
    void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int L = chunk, nc = S / L, NP = state_cols(N);
  if (hg < 1 || H % hg != 0) return (int)cudaErrorInvalidValue;
  const int64_t rows = (int64_t)batch * S, nbc = (int64_t)batch * nc;
  float* ds = work;
  float* u = ds + nbc * H * P * NP;
  float* y = u + rows * H * P;
  float* dcbg = y + rows * H * P;
  float* dcb = dcbg + nbc * (H / hg) * L * L;
  float* dapart = dcb + nbc * L * L;
  const int HP = H * P;
  const int nb = HP % 128 == 0 ? 128 : HP % 64 == 0 ? 64 : 32;
  // UY: the most column tiles a block (up to 8 slabs of them) that divide
  // the H P / nb tiles
  int uy_tiles = 1;
  for (int t = 2; t * (NP / kSlab) <= 8; ++t)
    if ((HP / nb) % t == 0) uy_tiles = t;
  GemmArgs gm{bm, cm, states, ds, dy, x,   dt,  lc, dcb, ds, u, y,
              dbm, dcm, batch, S, H, P, N, NP, L,  1};
  const ChunkArgs ch{x,  dt,  a,  a_group, dy,   lc,     states, cb,
                     ds, u,   y,  dx,      ddt,  dcbg,   dapart, batch,
                     S,  H,   NP, hg};
  cudaError_t err = cudaSuccess;
  for (int pass = 0; pass < 7 && err == cudaSuccess; ++pass) {
    if (only >= 0 && pass != only) continue;
    switch (pass) {
      case 0:
        err = gemm_nb<kV>(gm, NP, NP, st);
        break;
      case 1:
        ssd_bwd_state_pass<<<dim3(NP / 32, H, batch), kCarryThreads, 0,
                             st>>>(lc, dh, ds, dh0, S, H, P, N, NP, L);
        err = cudaGetLastError();
        break;
      case 2:
        gm.tiles = uy_tiles;
        err = gemm_nb<kUY>(gm, nb, HP, st);
        gm.tiles = 1;
        break;
      case 3:
        err = P == 32 ? chunk_l<32>(ch, L, st) : chunk_l<64>(ch, L, st);
        break;
      case 4: {
        const int tq = L * L / 4;
        const int64_t quads = nbc * tq;
        ssd_bwd_reduce_cb<<<(unsigned)((quads + kThreads - 1) / kThreads),
                            kThreads, 0, st>>>(dcbg, dcb, quads, H / hg, tq);
        err = cudaGetLastError();
        break;
      }
      case 5:
        err = gemm_nb<kBC>(gm, NP, NP, st);
        break;
      default: {
        const int a_rows = batch / a_group;
        ssd_bwd_reduce_a<<<(a_rows * H + kThreads - 1) / kThreads, kThreads,
                           0, st>>>(dapart, da, a_rows, a_group, nc, H);
        err = cudaGetLastError();
      }
    }
  }
  return (int)err;
}
