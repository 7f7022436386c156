// The backward of flash attention (csrc/flash_attention.cu) over flattened
// (BH, S, D) tensors on Hopper's tensor cores: given q, k, v, the
// forward's output o, its per-row log-sum-exp lse and the output's
// gradient dO, the gradients dq, dk and dv of
//
//     o = softmax(mask((q scale) k^T)) v
//
// with the forward's mask (causal k <= q, a one-sided window k > q -
// window, keys past Sk), positions from 0 on both sides, and query
// row-block bh reading KV head bh / kv_group: dk and dv of KV head j sum
// over query heads j g .. j g + g - 1.
//
// The TPU kernel this completes, src/repro/kernels/flash_attention.py
// (flash_attention_bhsd), has no backward: the reference's models train
// through jnp attention. The port's models run K5 on the card, so their
// gradients go through this kernel (kernels/flash_attention.py,
// FlashAttention, which has K5 write lse beside o).
//
// The standard recomputation: with P = exp(s - lse) on the live (q, k)
// pairs and 0 elsewhere, delta = rowsum(dO o),
//
//     dV = P^T dO,  dP = dO V^T,  dS = P (dP - delta),
//     dQ = scale (dS K),  dK = dS^T (q scale).
//
// Bound on the card: at yi-6b's shape (BH, S, D) = (128, 2048, 128),
// causal, the five products over the live half are 5 x 2 D per pair,
// 343.8 GFLOP; as three TF32 products each at 495 TFLOP/s that is 2.08 ms
// (operations, not the 604 MB of q, k, v, o, dO and the gradients). This
// design runs seven products (S and dP in both kernels below), 2.92 ms at
// that rate.
//
// Float32 accuracy on TF32 tensor cores (3xTF32, as the forward): each
// operand x is split into hi = tf32(x) and lo = tf32(x - hi), and each
// product is lo.hi + hi.lo + hi.hi in float32 accumulators, small terms
// first. bfloat16 inputs widen exactly into hi (lo = 0). Each step's
// gradient product goes into a fresh accumulator that is added to the
// running sum on the CUDA cores: the tensor cores truncate as they add,
// and dK / dV sum over up to kv_group x 64 steps.
//
// Three device kernels, launched in order on one stream:
//
// (a) flash_bwd_prepare, one warp a row: q scale, dO, K and V split into
//     hi and lo float32 rows of a scratch buffer (rows padded with zeros
//     to a multiple of 64 a head, so no tile crosses a head and TMA needs
//     no bounds), delta, and lse copied to the same padded rows (so the
//     producer of (b) can copy a step's 32 values of each beside its
//     tiles). wgmma takes TF32 operands K-major only (no
//     transpose flag for .tf32); every operand below is read either as
//     stored (rows along D) by wgmma from shared memory, or transposed by
//     the threads into register fragments, so no transposed copy is made.
// (b) flash_bwd_dkdv, one block of 384 threads per (KV head, 64 keys):
//     the keys are resident, the group's query heads stream through in
//     steps of 32 rows (query tiles last to first, the g heads of a tile
//     in turn, so the blocks of a KV head read the same rows at about the
//     same time and L2 serves them).
// (c) flash_bwd_dq, one block per (head bh, 64 query rows), blocks ordered
//     KV head by KV head and, within one, the longest causal rows first:
//     the rows are resident, the visible keys stream through in steps of
//     32.
//
// (b) and (c) are one design with the roles of keys and rows swapped.
// Warpgroup 2 is the producer: one of its threads keeps the streamed
// tiles in flight with TMA (2-D tensor maps, 128-byte swizzle) into a
// ring of stages (2 at D = 128, 4 below), each holding X0 and X1 (hi and
// lo): Q and dO in (b), K and V in (c); a stage completes on a "full"
// mbarrier by its bytes and is released on an "empty" one by the 256
// consumer threads. It drops to 24 registers (setmaxnreg) so that the two
// consumer warpgroups run at 240. Each consumer warpgroup holds its
// resident operand's hi part as TF32 A fragments in registers and its lo
// part in shared memory (as the forward holds Q): warpgroup 0 holds K (b)
// or q scale (c), warpgroup 1 V (b) or dO (c). Per step:
//
//   warpgroup 0: T0 = its resident rows . X0^T (m64n32k8, 3 D / 8
//       products: (b) S^T, (c) S); P = exp(T0 - lse) on the live pairs, 0
//       elsewhere; P stored hi and lo into a 64 x 32 exchange tile in the
//       swizzled K-major layout wgmma reads (rows the resident rows), and
//       handed to warpgroup 1 (named barrier 3; barrier 4 hands the tile
//       back). In (b) it then adds dV^T += dO^T P (below).
//   warpgroup 1: T1 = its resident rows . X1^T ((b) dP^T, (c) dP); dS = P
//       (T1 - delta) with P read back from the exchange tile (hi + lo);
//       dS stored hi and lo into its own exchange tile; then (b) dK^T +=
//       (q scale)^T dS, (c) dQ^T += K^T dS^T. In (c) at D <= 64 it issues
//       the next step's dP behind that product.
//
// The gradient products have M = D (in 64-row chunks; D = 32 runs one
// chunk with zero rows past D), N = the 64 resident rows, K = the 32
// streamed rows: A is a streamed tile read transposed from its stage into
// TF32 fragments (dO or q scale in (b), K in (c)), B the exchange tile, so
// no operand needs a second layout. m64n64k8, 12 products a chunk into a
// fresh sum, waited for and added on the CUDA cores. The exchange tiles
// order each 8 streamed rows 0 2 4 6 1 3 5 7, and the fragments' K
// dimension takes the same order, so those transposed loads hit 32
// banks (in natural order the swizzle gave 2-way conflicts).
//
// What bounds it on the card (PERF.md, the ablations of PR 24): each step
// streams 64 KB (two tiles, hi and lo) from L2 for 3 x 64 x 32 x D x 4
// multiply-adds, and shared memory carries those bytes, the products'
// operands and the transposed loads; at yi's shape (b) and (c) each move
// 8.9 GB through L2. Fewer streamed bytes (a 128-row resident tile, TMA
// multicast across a cluster) are the lever.
//
// Every sum has one owner and a fixed order: no atomics, so the result is
// the same from run to run; dq of head bh reads only KV head bh / g, so it
// is bit-equal to the call on the expanded KV. The tile skip (``skip``)
// only leaves out steps whose pairs are all masked; such a step has P = 0
// and dS = 0, its fresh sums are exact zeros, and adding them leaves the
// running sums' bits alone, so skipping or running them gives the same
// bits.
//
// Shared memory of one block (both kernels), ``Layout``: the two resident
// lo tiles (64 x D each), the stages (4 x 32 x D each, and in (b) the 32
// rows' lse and delta, copied by the producer beside the tiles), the two
// exchange tiles (hi and lo, 64 x 32 each), the mbarriers and 1 KB to
// align the base: 230,944 B at D = 128 (2 stages), 198,720 at 64 and
// 116,800 at 32 (4 stages); one block per SM. kernels/flash_attention.py's
// bwd_smem_bytes is the same sum. Registers: a consumer of (b) at D =
// 128 holds its resident hi fragments (64), dK^T or dV^T (64), a step's
// fresh sum (32) and its A fragments (32), near the 240 setmaxnreg gives
// it; per-thread offsets are kept opaque (recomputed each step, not held
// as tables) for that. ptxas -v reports each kernel (0 spills), and
// chip_smoke.py fails on a spill.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kRes = 64;    // resident rows of a block: keys (b), rows (c)
constexpr int kStep = 32;   // streamed rows a step: query rows (b), keys (c)
constexpr int kConsumers = 256;  // warpgroups 0 and 1
constexpr int kThreads = kConsumers + 128;  // and the producer warpgroup
constexpr int kAtom = 128;  // bytes in a swizzled row (32 floats)
constexpr int kExBytes = kRes * kStep * 4;  // an exchange tile's hi or lo

template <int D>
struct Layout {
  static constexpr int kStages = D == 128 ? 2 : 4;
  static constexpr int kResBytes = kRes * D * 4;     // a resident lo tile
  static constexpr int kTileBytes = kStep * D * 4;   // a streamed hi or lo
  static constexpr int kStageBytes = 4 * kTileBytes;  // X0 hi, lo, X1 hi, lo
  static constexpr int kStage0 = 2 * kResBytes;
  static constexpr int kP = kStage0 + kStages * kStageBytes;  // P hi, lo
  static constexpr int kDs = kP + 2 * kExBytes;               // dS hi, lo
  // (b): per stage its 32 rows' lse and delta
  static constexpr int kStats = kDs + 2 * kExBytes;
  static constexpr int kStatBytes = 2 * kStep * 4;
  static constexpr int kBar = kStats + kStages * kStatBytes;  // full, empty
  static constexpr int kBytes = kBar + 16 * kStages + 1024;  // + align
};

struct Shape {
  int sq, sk, sqp, skp, kv_group, causal, window, skip;
  float scale;
};

__device__ __forceinline__ bool live(int row, int key, const Shape& s) {
  return row < s.sq && key < s.sk && (!s.causal || key <= row) &&
         (s.window <= 0 || key > row - s.window);
}

// ------------------------------------------------------------ loads, stores

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ uint32_t ld_shared(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];" : "=r"(v) : "r"(addr) : "memory");
  return v;
}

// A value the compiler must recompute where it is used, so that it holds
// no loop-invariant descriptor in a register across the loop.
__device__ __forceinline__ uint32_t opaque(uint32_t x) {
  asm volatile("mov.b32 %0, %0;" : "+r"(x));
  return x;
}

// exp(x) as 2^(x log2(e)) on the special-function unit (~2 ulp), as the
// forward computes it.
__device__ __forceinline__ float fast_exp(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}

// This warpgroup's shared-memory stores visible to wgmma, once all 4 of
// its warps made them (named barrier 1 + w over its 128 threads).
__device__ __forceinline__ void smem_ready(int w) {
  fence_async_smem();
  bar_sync(1 + w, 128);
}

// Byte offset, in 16-byte descriptor units, of k step kk (8 floats =
// 32 bytes) in a K-major operand of ``rows`` rows stored as 32-float column
// atoms of (rows x 128 B).
__host__ __device__ constexpr int k_step(int kk, int rows) {
  return ((kk / 4) * rows * kAtom + (kk % 4) * 32) / 16;
}

// ------------------------------------------------------------------ pieces

// This warpgroup's resident rows r0 .. r0 + 63 of a split scratch pair:
// hi into its A fragments (rh[4 kk + r]: row lr + 8 (r % 2), column 8 kk +
// t + 4 (r / 2)), lo into shared memory at ``lo`` as D / 32 column atoms of
// (64 rows x 128 B), 16-byte chunk c of row r at chunk c ^ (r % 8).
template <int D>
__device__ __forceinline__ void load_resident(uint32_t* rh, uint32_t lo,
                                              const float* __restrict__ hi_src,
                                              const float* __restrict__ lo_src,
                                              int64_t r0, int wt, int lr,
                                              int t) {
  const float* h = hi_src + r0 * D;
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      rh[4 * kk + r] = __float_as_uint(
          h[(lr + 8 * (r % 2)) * D + 8 * kk + t + 4 * (r / 2)]);
  const float* l = lo_src + r0 * D;
  for (int e = wt; e < kRes * D / 4; e += 128) {
    const int r = e / (D / 4), c4 = e % (D / 4);
    const float4 x = *reinterpret_cast<const float4*>(l + r * D + 4 * c4);
    const int off =
        (c4 / 8) * kRes * kAtom + r * kAtom + (((c4 % 8) ^ (r % 8)) << 4);
    asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};" ::"r"(lo + off),
                 "f"(x.x), "f"(x.y), "f"(x.z), "f"(x.w)
                 : "memory");
  }
}

// The k steps KK.. of T = R X^T: R_lo X_hi^T (both from shared memory),
// R_hi X_lo^T, R_hi X_hi^T (R_hi as A fragments, rh[4 kk ..] for k step
// kk); R 64 rows, X a 32-row streamed tile.
template <int D, int KK>
__device__ __forceinline__ void scores_from(float* sc, const uint32_t* rh,
                                            uint64_t rlo, uint64_t xhi,
                                            uint64_t xlo) {
  if constexpr (KK < D / 8) {
    WgmmaSS<32, k_step(KK, kRes), k_step(KK, kStep)>::run(sc, rlo, xhi);
    scores_from<D, KK + 1>(sc, rh, rlo, xhi, xlo);
  } else if constexpr (KK < 2 * (D / 8)) {
    constexpr int kk = KK - D / 8;
    wgmma_rs32<k_step(kk, kStep)>(sc, rh + 4 * kk, xlo);
    scores_from<D, KK + 1>(sc, rh, rlo, xhi, xlo);
  } else if constexpr (KK < 3 * (D / 8)) {
    constexpr int kk = KK - 2 * (D / 8);
    wgmma_rs32<k_step(kk, kStep)>(sc, rh + 4 * kk, xhi);
    scores_from<D, KK + 1>(sc, rh, rlo, xhi, xlo);
  }
}

// T (64 x 32: sc[4 j + 2 i + e] is resident row lr + 8 i, streamed row 8 j
// + 2 t + e) of the resident rows (rh, lo tile at rlo) against the
// streamed tile at x (its lo at x + kTileBytes), issued and committed as
// one group.
template <int D>
__device__ __forceinline__ void issue_scores(float* sc, const uint32_t* rh,
                                             uint32_t rlo, uint32_t x) {
  rlo = opaque(rlo);
  x = opaque(x);
#pragma unroll
  for (int i = 0; i < 16; ++i) sc[i] = 0.0f;
  fence_regs<16>(sc);
  wgmma_fence();
  scores_from<D, 0>(sc, rh, sw128_desc(rlo), sw128_desc(x),
                    sw128_desc(x + Layout<D>::kTileBytes));
  wgmma_commit();
}

// The exchange tiles (64 rows x 32 floats, one swizzled atom: 16-byte
// chunk c of row r at c ^ (r % 8)) hold their 32 columns, the streamed
// rows, permuted within each group of 8: column 8 j + p holds streamed
// row 8 j + s(p), s(p) = 2 p and s(p + 4) = 2 p + 1 (p < 4). The gradient
// products' A fragments take the same order in their K dimension (see
// load_frags), which keeps those loads free of bank conflicts. So sc[4 j
// + 2 i + e] (row lr + 8 i, streamed row 8 j + 2 t + e) sits at column
// 8 j + t + 4 e: chunk 2 j + e, float t; and r % 8 = lr % 8.
//
// The per-thread parts (lr kAtom + 4 t, and the swizzle (lr % 8) << 4) are
// made opaque where a tile is stored or loaded, so that the compiler keeps
// no table of the 16 offsets in registers across the loop.
struct ExBase {
  uint32_t at, x;
  __device__ ExBase(uint32_t p, int lr, int t)
      : at(opaque(p + lr * kAtom + 4 * t)), x(opaque((lr % 8) << 4)) {}
  __device__ uint32_t operator()(int i, int j, int e) const {
    return at + i * 8 * kAtom + (((2 * j + e) << 4) ^ x);
  }
};

__device__ __forceinline__ void st_shared(uint32_t addr, float a) {
  asm volatile("st.shared.f32 [%0], %1;" ::"r"(addr), "f"(a) : "memory");
}
__device__ __forceinline__ float ld_sharedf(uint32_t addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];" : "=f"(v) : "r"(addr) : "memory");
  return v;
}

// sc split into hi and lo, into the exchange tile at p (lo at p +
// kExBytes), in the layout wgmma reads as a K-major operand.
__device__ __forceinline__ void store_tile(const float* sc, uint32_t p,
                                           int lr, int t) {
  const ExBase ex(p, lr, t);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const uint32_t at = ex(i, j, e);
        const float x = sc[4 * j + 2 * i + e], h = to_tf32(x);
        st_shared(at, h);
        st_shared(at + kExBytes, to_tf32(x - h));
      }
}

// The same positions read back as hi + lo.
__device__ __forceinline__ void load_tile(float* pv, uint32_t p, int lr,
                                          int t) {
  const ExBase ex(p, lr, t);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const uint32_t at = ex(i, j, e);
        pv[4 * j + 2 * i + e] = ld_sharedf(at) + ld_sharedf(at + kExBytes);
      }
}

// A fragments of column chunk c of a streamed tile x (32 rows x D, hi at x,
// lo at x + kTileBytes), transposed: A[m][k] = x[8 kk + s(k')][64 c + m]
// for m = lr + 8 (r % 2) and K position k' = t + 4 (r / 2), i.e. streamed
// row 8 kk + 2 t + r / 2 (s as the exchange tiles' columns), at ah /
// al[4 kk + r]; columns past D (D = 32) are zeros. With lr = 16 w + g,
// column 64 c + m is in atom 2 c + w / 2, 16-byte chunk 4 (w % 2) + g / 4 +
// 2 (r % 2), float g % 4, and the row's swizzle XORs the chunk with 2 t +
// r / 2: a per-thread base, a constant and one XOR; and the 32 lanes of a
// load hit 32 banks.
template <int D>
__device__ __forceinline__ void load_frags(uint32_t* ah, uint32_t* al,
                                           uint32_t x, int c, int lr, int t) {
  const int w = lr / 16, g = lr % 8;
  const uint32_t base = opaque(x + (w / 2) * (kStep * kAtom) +
                               2 * t * kAtom + (g % 4) * 4);
  const uint32_t chunk = opaque(((4 * (w % 2) + g / 4) ^ (2 * t)) << 4);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      uint32_t h = 0, l = 0;
      if (64 * c + lr + 8 * (r % 2) < D) {
        const uint32_t at =
            base + 2 * c * (kStep * kAtom) + (8 * kk + r / 2) * kAtom +
            (chunk ^ ((2 * (r % 2) + r / 2) << 4));
        h = ld_shared(at);
        l = ld_shared(at + Layout<D>::kTileBytes);
      }
      ah[4 * kk + r] = h;
      al[4 * kk + r] = l;
    }
}

// The k steps J.. of a gradient chunk: A_lo B_hi, A_hi B_lo, A_hi B_hi (B
// the exchange tile: its 32 columns are one atom, k step kk 32 bytes = 2
// descriptor units into it).
template <int J>
__device__ __forceinline__ void grad_from(float* tmp, const uint32_t* ah,
                                          const uint32_t* al, uint64_t bh,
                                          uint64_t bl) {
  if constexpr (J < 12) {
    constexpr int kk = J % 4;
    wgmma_rs64<2 * kk>(tmp, (J < 4 ? al : ah) + 4 * kk,
                       J >= 4 && J < 8 ? bl : bh);
    grad_from<J + 1>(tmp, ah, al, bh, bl);
  }
}

// One gradient chunk into a fresh sum tmp: 12 products, A_lo B_hi, A_hi
// B_lo, A_hi B_hi over the 4 k steps, B the exchange tile at b; issued
// and committed as one group.
__device__ __forceinline__ void issue_grad(float* tmp, const uint32_t* ah,
                                           const uint32_t* al, uint32_t b) {
#pragma unroll
  for (int i = 0; i < 32; ++i) tmp[i] = 0.0f;
  fence_regs<32>(tmp);
  wgmma_fence();
  b = opaque(b);
  grad_from<0>(tmp, ah, al, sw128_desc(b), sw128_desc(b + kExBytes));
  wgmma_commit();
}

// This step's gradient: acc (D x 64 in chunks of 64 rows, chunk c at
// acc[32 c ..]: acc[32 c + 4 j + 2 i + e] is row 64 c + lr + 8 i, column
// 8 j + 2 t + e) += x^T B, x a streamed tile, B the exchange tile at b,
// each chunk a fresh sum added on the CUDA cores. With More, the next
// step's T (into sc, of the streamed tile at nx once its stage is full)
// is issued behind the first chunk, so the tensor cores run it while this
// warpgroup adds that chunk (and loads the next one's fragments). More is
// a template argument so that every wait is static (ptxas keeps the
// products asynchronous).
template <int D, bool More>
__device__ __forceinline__ void grads(float* acc, uint32_t x, uint32_t b,
                                      int lr, int t, float* sc = nullptr,
                                      const uint32_t* rh = nullptr,
                                      uint32_t rlo = 0, uint32_t nx = 0,
                                      uint32_t nfull = 0, int nparity = 0) {
  uint32_t ah[16], al[16];
  float tmp[32];
  load_frags<D>(ah, al, x, 0, lr, t);
  issue_grad(tmp, ah, al, b);
  if constexpr (More) {
    mbar_wait(nfull, nparity);
    issue_scores<D>(sc, rh, rlo, nx);
    wgmma_wait<1>();
  } else {
    wgmma_wait<0>();
  }
  fence_regs<32>(tmp);
  fence_regs<16>(ah);
  fence_regs<16>(al);
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] += tmp[i];
  if constexpr (D > 64) {
    load_frags<D>(ah, al, x, 1, lr, t);
    issue_grad(tmp, ah, al, b);
    wgmma_wait<0>();
    fence_regs<32>(tmp);
    fence_regs<16>(ah);
    fence_regs<16>(al);
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[32 + i] += tmp[i];
  } else if constexpr (More) {
    wgmma_wait<0>();
  }
  if constexpr (More) fence_regs<16>(sc);
}

// acc (as in grads) times ``mul`` into out (n_max rows of D): row n0 +
// 8 j + 2 t + e, column 64 c + lr + 8 i.
template <int D, typename T>
__device__ __forceinline__ void store_out(const float* acc, T* out, int n0,
                                          int n_max, float mul, int lr,
                                          int t) {
#pragma unroll
  for (int c = 0; c < (D + 63) / 64; ++c)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int col = 64 * c + lr + 8 * i;
      if (col >= D) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + 8 * j + 2 * t + e;
          if (n < n_max)
            store1(out + (int64_t)n * D + col,
                   mul * acc[32 * c + 4 * j + 2 * i + e]);
        }
    }
}

// -------------------------------------------------------------------- work

// (b): KV head kvh, keys k0 .. k0 + 63, query tiles [t0, t1) of 32 rows
// (every tile some row of which sees a key of the block; all with !skip).
struct KvWork {
  int kvh, k0, t0, t1;
};

__device__ __forceinline__ KvWork kv_work(const Shape& s) {
  const int nkt = (s.sk + kRes - 1) / kRes;
  KvWork w;
  w.kvh = blockIdx.x / nkt;
  w.k0 = (blockIdx.x % nkt) * kRes;
  int lo = 0, hi = s.sq;
  if (s.skip) {
    const int last = min(w.k0 + kRes, s.sk) - 1;
    if (s.causal) lo = w.k0;
    if (s.window > 0) hi = min(hi, last + s.window);
  }
  w.t0 = lo / kStep;
  w.t1 = hi > lo ? (hi + kStep - 1) / kStep : w.t0;
  return w;
}

// (c): head bh (KV head kvh), rows q0 .. q0 + 63, key tiles [t0, t1) of
// 32 keys; blocks KV head by KV head, the longest causal rows first.
struct QWork {
  int bh, kvh, q0, t0, t1;
};

__device__ __forceinline__ QWork q_work(const Shape& s) {
  const int g = s.kv_group, nqt = (s.sq + kRes - 1) / kRes;
  QWork w;
  w.kvh = blockIdx.x / (nqt * g);
  const int rem = blockIdx.x % (nqt * g);
  w.bh = w.kvh * g + rem % g;
  w.q0 = (nqt - 1 - rem / g) * kRes;
  int lo = 0, hi = s.sk;
  if (s.skip) {
    const int last = min(w.q0 + kRes, s.sq) - 1;
    if (s.causal) hi = min(hi, last + 1);
    if (s.window > 0) lo = max(lo, w.q0 - s.window + 1);
  }
  w.t0 = lo / kStep;
  w.t1 = hi > lo ? (hi + kStep - 1) / kStep : w.t0;
  return w;
}

// The producer (one thread): each step's X0 hi, X0 lo, X1 hi, X1 lo boxes
// (32 rows x 32 floats, one per column atom) at scratch row next_row(),
// called once a step in order; with stats (b), those rows' lse and delta
// (the scratch's rows, so the same index) beside them.
template <int D, typename NextRow>
__device__ __forceinline__ void produce(const CUtensorMap* x0h,
                                        const CUtensorMap* x0l,
                                        const CUtensorMap* x1h,
                                        const CUtensorMap* x1l, int n_steps,
                                        NextRow next_row,
                                        const float* lse = nullptr,
                                        const float* delta = nullptr) {
  using L = Layout<D>;
  constexpr int kS = L::kStages;
  const uint32_t base = smem_base();
  for (int n = 0; n < n_steps; ++n) {
    const int s = n % kS;
    const uint32_t full = base + L::kBar + 16 * s;
    if (n >= kS) mbar_wait(full + 8, ((n / kS) - 1) & 1);
    mbar_expect_tx(full, L::kStageBytes + (lse ? L::kStatBytes : 0));
    const int row = next_row();
    if (lse) {
      const uint32_t at = base + L::kStats + s * L::kStatBytes;
      bulk_load(at, lse + row, kStep * 4, full);
      bulk_load(at + kStep * 4, delta + row, kStep * 4, full);
    }
    const uint32_t st = base + L::kStage0 + s * L::kStageBytes;
#pragma unroll
    for (int a = 0; a < D / 32; ++a) {
      const uint32_t at = st + a * kStep * kAtom;
      tma_load(at, x0h, full, 32 * a, row);
      tma_load(at + L::kTileBytes, x0l, full, 32 * a, row);
      tma_load(at + 2 * L::kTileBytes, x1h, full, 32 * a, row);
      tma_load(at + 3 * L::kTileBytes, x1l, full, 32 * a, row);
    }
  }
}

template <int D>
__device__ __forceinline__ void init_barriers() {
  if (threadIdx.x == 0) {
    const uint32_t bars = smem_base() + Layout<D>::kBar;
    for (int s = 0; s < Layout<D>::kStages; ++s) {
      mbar_init(bars + 16 * s, 1);
      mbar_init(bars + 16 * s + 8, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
}

// ---------------------------------------------------------- (b) dK and dV

// Warpgroup w of (b): resident K (w = 0, with lse, writing dv) or V (w =
// 1, with delta, writing dk); see the header for a step. Each step's T
// is issued behind the previous step's gradient (grads).
template <int D, typename T>
__device__ __forceinline__ void dkdv_consume(
    const float* __restrict__ res_hi, const float* __restrict__ res_lo,
    T* __restrict__ out, const Shape& sh) {
  using L = Layout<D>;
  const KvWork wk = kv_work(sh);
  const int g = sh.kv_group, n_steps = (wk.t1 - wk.t0) * g;
  const int w = threadIdx.x / 128, wt = threadIdx.x % 128;
  const int t = wt % 4, lr = 16 * (wt / 32) + (wt % 32) / 4;
  const uint32_t base = smem_base(), rlo = base + w * L::kResBytes;
  const uint32_t p = base + L::kP, ds = base + L::kDs;
  uint32_t rh[D / 2];
  load_resident<D>(rh, rlo, res_hi, res_lo,
                   (int64_t)wk.kvh * sh.skp + wk.k0, wt, lr, t);
  smem_ready(w);
  float acc[32 * ((D + 63) / 64)];
#pragma unroll
  for (int i = 0; i < 32 * ((D + 63) / 64); ++i) acc[i] = 0.0f;

  // step n: head kvh g + n % g, query rows q0 .. q0 + 31 (tiles last to
  // first); its stage, full barrier (empty at + 8) and parity
  auto stage = [&](int n) {
    return base + L::kStage0 + (n % L::kStages) * L::kStageBytes;
  };
  auto full = [&](int n) { return base + L::kBar + 16 * (n % L::kStages); };
  auto parity = [&](int n) { return (n / L::kStages) & 1; };
  // lse (w = 0) or delta (w = 1) of column 8 j + 2 t + e, in the stage
  auto stat = [&](int n, int j, int e) {
    return ld_sharedf(opaque(base + L::kStats + w * kStep * 4 + 8 * t) +
                      (n % L::kStages) * L::kStatBytes + 4 * (8 * j + e));
  };
  float sc[16];
  // S^T (w = 0) or dP^T (w = 1) against stage n's Q or dO
  const uint32_t mine = 2 * w * L::kTileBytes;
  if (n_steps > 0) {
    mbar_wait(full(0), 0);
    issue_scores<D>(sc, rh, rlo, stage(0) + mine);
    wgmma_wait<0>();
    fence_regs<16>(sc);
  }
  auto step = [&](int n, auto more) {
    constexpr bool kMore = decltype(more)::value;
    const int q0 = (wk.t1 - 1 - n / g) * kStep;
    const uint32_t st = stage(n);
    uint32_t x, b;
    if (w == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& v = sc[4 * j + 2 * i + e];
            v = live(q0 + 8 * j + 2 * t + e, wk.k0 + lr + 8 * i, sh)
                    ? fast_exp(v - stat(n, j, e))
                    : 0.0f;
          }
      if (n > 0) bar_sync(4, kConsumers);  // warpgroup 1 has read P
      store_tile(sc, p, lr, t);
      smem_ready(0);
      bar_arrive(3, kConsumers);
      x = st + 2 * L::kTileBytes;  // dV^T += dO^T P
      b = p;
    } else {
      float pv[16];
      bar_sync(3, kConsumers);
      load_tile(pv, p, lr, t);
      if (kMore) bar_arrive(4, kConsumers);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int v = 4 * j + 2 * i + e;
            sc[v] = pv[v] * (sc[v] - stat(n, j, e));
          }
      store_tile(sc, ds, lr, t);
      smem_ready(1);
      x = st;  // dK^T += (q scale)^T dS
      b = ds;
    }
    if constexpr (kMore)
      grads<D, true>(acc, x, b, lr, t, sc, rh, rlo, stage(n + 1) + mine,
                     full(n + 1), parity(n + 1));
    else
      grads<D, false>(acc, x, b, lr, t);
    mbar_arrive(full(n) + 8);
  };
  for (int n = 0; n + 1 < n_steps; ++n) step(n, std::true_type{});
  if (n_steps > 0) step(n_steps - 1, std::false_type{});
  store_out<D, T>(acc, out + (int64_t)wk.kvh * sh.sk * D, wk.k0, sh.sk, 1.0f,
                  lr, t);
}

template <int D, typename T>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkdv(const __grid_constant__ CUtensorMap tm_qhi,
                   const __grid_constant__ CUtensorMap tm_qlo,
                   const __grid_constant__ CUtensorMap tm_dohi,
                   const __grid_constant__ CUtensorMap tm_dolo,
                   const float* __restrict__ khi,
                   const float* __restrict__ klo,
                   const float* __restrict__ vhi,
                   const float* __restrict__ vlo,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, T* __restrict__ dk,
                   T* __restrict__ dv, Shape sh) {
  init_barriers<D>();
  if (threadIdx.x >= kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    if (threadIdx.x == kConsumers) {
      // the consumers' order: query tiles last to first, the group's
      // heads in turn (counted, not divided: the producer has 24
      // registers)
      const KvWork wk = kv_work(sh);
      const int g = sh.kv_group;
      const int head_rows = sh.sqp, row0 = wk.kvh * g * head_rows;
      int gi = 0, q0 = (wk.t1 - 1) * kStep;
      produce<D>(&tm_qhi, &tm_qlo, &tm_dohi, &tm_dolo, (wk.t1 - wk.t0) * g,
                 [&]() {
                   const int row = row0 + gi * head_rows + q0;
                   if (++gi == g) {
                     gi = 0;
                     q0 -= kStep;
                   }
                   return row;
                 },
                 lse, delta);
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");
    const bool w = threadIdx.x >= 128;
    dkdv_consume<D, T>(w ? vhi : khi, w ? vlo : klo, w ? dk : dv, sh);
  }
}

// ------------------------------------------------------------------ (c) dQ

// Warpgroup w of (c): resident q scale (w = 0, with lse) or dO (w = 1,
// with delta, writing dq); see the header for a step. At D <= 64
// warpgroup 1 issues each step's dP behind the previous step's gradient
// (grads); at D = 128 it has no registers for that.
template <int D, typename T>
__device__ __forceinline__ void dq_consume(const float* __restrict__ res_hi,
                                           const float* __restrict__ res_lo,
                                           const float* __restrict__ stats,
                                           T* __restrict__ dq,
                                           const Shape& sh) {
  using L = Layout<D>;
  const QWork wk = q_work(sh);
  const int n_steps = wk.t1 - wk.t0;
  const int w = threadIdx.x / 128, wt = threadIdx.x % 128;
  const int t = wt % 4, lr = 16 * (wt / 32) + (wt % 32) / 4;
  const uint32_t base = smem_base(), rlo = base + w * L::kResBytes;
  const uint32_t p = base + L::kP, ds = base + L::kDs;
  uint32_t rh[D / 2];
  load_resident<D>(rh, rlo, res_hi, res_lo,
                   (int64_t)wk.bh * sh.sqp + wk.q0, wt, lr, t);
  smem_ready(w);
  // lse (w = 0) or delta (w = 1) of this thread's rows q0 + lr + 8 i
  float stat[2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
    stat[i] = stats[(int64_t)wk.bh * sh.sqp + wk.q0 + lr + 8 * i];
  auto stage = [&](int n) {
    return base + L::kStage0 + (n % L::kStages) * L::kStageBytes;
  };
  auto full = [&](int n) { return base + L::kBar + 16 * (n % L::kStages); };
  auto parity = [&](int n) { return (n / L::kStages) & 1; };
  float sc[16];

  if (w == 0) {
    for (int n = 0; n < n_steps; ++n) {
      const int k0 = (wk.t0 + n) * kStep;
      mbar_wait(full(n), parity(n));
      issue_scores<D>(sc, rh, rlo, stage(n));  // S against the K tile
      wgmma_wait<0>();
      fence_regs<16>(sc);
      mbar_arrive(full(n) + 8);  // done with the stage
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = sc[4 * j + 2 * i + e];
            x = live(wk.q0 + lr + 8 * i, k0 + 8 * j + 2 * t + e, sh)
                    ? fast_exp(x - stat[i])
                    : 0.0f;
          }
      if (n > 0) bar_sync(4, kConsumers);  // warpgroup 1 has read P
      store_tile(sc, p, lr, t);
      bar_arrive(3, kConsumers);
    }
    return;
  }

  constexpr bool kPipe = D <= 64;
  const uint32_t v_tile = 2 * L::kTileBytes;
  auto issue_dp = [&](int n) {  // dP against the V tile
    mbar_wait(full(n), parity(n));
    issue_scores<D>(sc, rh, rlo, stage(n) + v_tile);
    wgmma_wait<0>();
    fence_regs<16>(sc);
  };
  float acc[32 * ((D + 63) / 64)];
#pragma unroll
  for (int i = 0; i < 32 * ((D + 63) / 64); ++i) acc[i] = 0.0f;
  if (n_steps > 0) issue_dp(0);
  auto step = [&](int n, auto more) {
    constexpr bool kMore = decltype(more)::value;
    float pv[16];
    bar_sync(3, kConsumers);
    load_tile(pv, p, lr, t);
    if (kMore) bar_arrive(4, kConsumers);
#pragma unroll
    for (int v = 0; v < 16; ++v) sc[v] = pv[v] * (sc[v] - stat[(v / 2) % 2]);
    store_tile(sc, ds, lr, t);
    smem_ready(1);
    // dQ^T += K^T dS^T
    if constexpr (kMore && kPipe)
      grads<D, true>(acc, stage(n), ds, lr, t, sc, rh, rlo,
                     stage(n + 1) + v_tile, full(n + 1), parity(n + 1));
    else
      grads<D, false>(acc, stage(n), ds, lr, t);
    mbar_arrive(full(n) + 8);
    if constexpr (kMore && !kPipe) issue_dp(n + 1);
  };
  for (int n = 0; n + 1 < n_steps; ++n) step(n, std::true_type{});
  if (n_steps > 0) step(n_steps - 1, std::false_type{});
  store_out<D, T>(acc, dq + (int64_t)wk.bh * sh.sq * D, wk.q0, sh.sq,
                  sh.scale, lr, t);
}

template <int D, typename T>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq(const __grid_constant__ CUtensorMap tm_khi,
                 const __grid_constant__ CUtensorMap tm_klo,
                 const __grid_constant__ CUtensorMap tm_vhi,
                 const __grid_constant__ CUtensorMap tm_vlo,
                 const float* __restrict__ qhi, const float* __restrict__ qlo,
                 const float* __restrict__ dohi,
                 const float* __restrict__ dolo,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, T* __restrict__ dq,
                 Shape sh) {
  init_barriers<D>();
  if (threadIdx.x >= kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    if (threadIdx.x == kConsumers) {
      const QWork wk = q_work(sh);
      int row = wk.kvh * sh.skp + wk.t0 * kStep - kStep;
      produce<D>(&tm_khi, &tm_klo, &tm_vhi, &tm_vlo, wk.t1 - wk.t0,
                 [&]() { return row += kStep; });
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");
    const bool w = threadIdx.x >= 128;
    dq_consume<D, T>(w ? dohi : qhi, w ? dolo : qlo, w ? delta : lse, dq,
                     sh);
  }
}

// ----------------------------------------------------------- (a) prepare

// Scratch layout (float32, rows of D): q scale hi, lo and dO hi, lo
// (bh sqp rows each), K hi, lo and V hi, lo (bhkv skp rows each), then
// delta and lse (bh sqp each). Row r of head h sits at h sqp + r (h skp +
// r); rows past Sq (Sk) are zeros.
struct Scratch {
  float *qhi, *qlo, *dohi, *dolo, *khi, *klo, *vhi, *vlo, *delta, *lse;
  __host__ __device__ Scratch(float* w, int64_t qrows, int64_t krows,
                              int d) {
    qhi = w;
    qlo = qhi + qrows * d;
    dohi = qlo + qrows * d;
    dolo = dohi + qrows * d;
    khi = dolo + qrows * d;
    klo = khi + krows * d;
    vhi = klo + krows * d;
    vlo = vhi + krows * d;
    delta = vlo + krows * d;
    lse = delta + qrows;
  }
};

__device__ __forceinline__ void split(float x, float* hi, float* lo) {
  const float h = to_tf32(x);
  *hi = h;
  *lo = to_tf32(x - h);
}

// One warp a padded scratch row: the q side's bh sqp rows, then the k
// side's bhkv skp rows; lane l holds columns l + 32 i.
template <int D, typename T>
__global__ void __launch_bounds__(256)
    flash_bwd_prepare(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ o,
                      const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      float* __restrict__ work, int bh, int bhkv, Shape sh) {
  const int64_t qrows = (int64_t)bh * sh.sqp, krows = (int64_t)bhkv * sh.skp;
  const Scratch s(work, qrows, krows, D);
  const int64_t row = (int64_t)blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row < qrows) {
    const int64_t h = row / sh.sqp;
    const int r = (int)(row % sh.sqp);
    const bool valid = r < sh.sq;
    const int64_t src = (h * sh.sq + r) * D, dst = row * D;
    float part = 0.0f;
#pragma unroll
    for (int i = 0; i < D / 32; ++i) {
      const int c = lane + 32 * i;
      const float x = valid ? to_float(q[src + c]) * sh.scale : 0.0f;
      const float y = valid ? to_float(dout[src + c]) : 0.0f;
      const float z = valid ? to_float(o[src + c]) : 0.0f;
      split(x, s.qhi + dst + c, s.qlo + dst + c);
      split(y, s.dohi + dst + c, s.dolo + dst + c);
      part = fmaf(y, z, part);
    }
#pragma unroll
    for (int off = 16; off; off >>= 1)
      part += __shfl_xor_sync(0xffffffffu, part, off);
    if (lane == 0) {
      s.delta[row] = part;
      s.lse[row] = valid ? lse[h * sh.sq + r] : 0.0f;
    }
  } else if (row < qrows + krows) {
    const int64_t kr = row - qrows, h = kr / sh.skp;
    const int r = (int)(kr % sh.skp);
    const bool valid = r < sh.sk;
    const int64_t src = (h * sh.sk + r) * D, dst = kr * D;
#pragma unroll
    for (int i = 0; i < D / 32; ++i) {
      const int c = lane + 32 * i;
      split(valid ? to_float(k[src + c]) : 0.0f, s.khi + dst + c,
            s.klo + dst + c);
      split(valid ? to_float(v[src + c]) : 0.0f, s.vhi + dst + c,
            s.vlo + dst + c);
    }
  }
}

// ------------------------------------------------------------------ host

// A head's scratch rows, padded to whole resident tiles (which load their
// 64 rows without bounds) and so to whole 32-row steps.
int padded(int n) { return (n + kRes - 1) / kRes * kRes; }

template <int D, typename T>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, void* dq, void* dk, void* dv,
           float* work, int bh, int kv_group, int sq, int sk, int causal,
           int window, float scale, int skip, cudaStream_t stream) {
  using L = Layout<D>;
  const int bhkv = bh / kv_group;
  const Shape sh{sq,      sk,     padded(sq), padded(sk), kv_group,
                 causal, window, skip,       scale};
  const int64_t qrows = (int64_t)bh * sh.sqp, krows = (int64_t)bhkv * sh.skp;
  const Scratch s(work, qrows, krows, D);
  const T *qt = static_cast<const T*>(q), *kt = static_cast<const T*>(k),
          *vt = static_cast<const T*>(v), *ot = static_cast<const T*>(o),
          *dot = static_cast<const T*>(dout);
  flash_bwd_prepare<D, T><<<(unsigned)((qrows + krows + 7) / 8), 256, 0,
                            stream>>>(qt, kt, vt, ot, dot, lse, work, bh,
                                      bhkv, sh);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return kMapError + (int)CUDA_ERROR_NOT_FOUND;
  CUtensorMap qm[4], km[4];
  float* qs[4] = {s.qhi, s.qlo, s.dohi, s.dolo};
  float* ks[4] = {s.khi, s.klo, s.vhi, s.vlo};
  int r = 0;
  for (int i = 0; i < 4 && !r; ++i)
    r = tensor_map(encode, &qm[i], qs[i], D, qrows, kStep);
  for (int i = 0; i < 4 && !r; ++i)
    r = tensor_map(encode, &km[i], ks[i], D, krows, kStep);
  if (r) return kMapError + r;

  auto* dkdv = flash_bwd_dkdv<D, T>;
  auto* dqk = flash_bwd_dq<D, T>;
  err = cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             L::kBytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        dqk, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (err != cudaSuccess) return (int)err;
  dkdv<<<bhkv * ((sk + kRes - 1) / kRes), kThreads, L::kBytes, stream>>>(
      qm[0], qm[1], qm[2], qm[3], s.khi, s.klo, s.vhi, s.vlo, s.lse, s.delta,
      static_cast<T*>(dk), static_cast<T*>(dv), sh);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dqk<<<bh * ((sq + kRes - 1) / kRes), kThreads, L::kBytes, stream>>>(
      km[0], km[1], km[2], km[3], s.qhi, s.qlo, s.dohi, s.dolo, s.lse,
      s.delta, static_cast<T*>(dq), sh);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, const void* o,
             const void* dout, const float* lse, void* dq, void* dk,
             void* dv, float* work, int bh, int kv_group, int sq, int sk,
             int d, int causal, int window, float scale, int skip,
             cudaStream_t stream) {
  switch (d) {
    case 32:
      return launch<32, T>(q, k, v, o, dout, lse, dq, dk, dv, work, bh,
                           kv_group, sq, sk, causal, window, scale, skip,
                           stream);
    case 64:
      return launch<64, T>(q, k, v, o, dout, lse, dq, dk, dv, work, bh,
                           kv_group, sq, sk, causal, window, scale, skip,
                           stream);
    case 128:
      return launch<128, T>(q, k, v, o, dout, lse, dq, dk, dv, work, bh,
                            kv_group, sq, sk, causal, window, scale, skip,
                            stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q, o, dout, dq (bh, sq, d) and k, v, dk, dv (bh / kv_group, sk, d):
// contiguous, 16-byte aligned, all float32 (bf16 = 0) or all bfloat16
// (bf16 = 1) on the device; lse (bh, sq) float32, the forward's (K5 with
// an lse array); work: float32 scratch of 4 bh sqp d + 4 (bh / kv_group)
// skp d + 2 bh sqp, sqp and skp being sq and sk rounded up to 64; d in {32,
// 64, 128}; window <= 0 for none; skip = 1 skips the steps whose pairs are
// all masked (kernels/flash_attention.py checks shapes, types and shared
// memory, and refuses shapes with a row that sees no key). Launches the
// three kernels on ``stream`` and returns cudaGetLastError() (or the
// error of raising a shared memory limit, or 10000 + the CUresult of a
// tensor map the driver refused).
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, const void* lse,
                                   void* dq, void* dk, void* dv, void* work,
                                   int bh, int kv_group, int sq, int sk,
                                   int d, int bf16, int causal, int window,
                                   float scale, int skip, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* w = static_cast<float*>(work);
  return bf16 ? launch_d<__nv_bfloat16>(q, k, v, o, dout, l, dq, dk, dv, w,
                                        bh, kv_group, sq, sk, d, causal,
                                        window, scale, skip, s)
              : launch_d<float>(q, k, v, o, dout, l, dq, dk, dv, w, bh,
                                kv_group, sq, sk, d, causal, window, scale,
                                skip, s);
}
