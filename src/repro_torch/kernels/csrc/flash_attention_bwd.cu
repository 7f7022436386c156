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
// Three device kernels, launched in order on one stream (with probs_bf16
// (c) before (b), below):
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
//
// The two modes of attention_modes.cuh (the reference's kv_valid masks and
// attn_probs_bf16), each taking the gradient that jax.vjp takes of the
// reference's function. (b) and (c) are built per mode (template M: none,
// kv_valid, probs_bf16 with kv_valid read at run time), so that a call
// without a mode runs the unmasked kernels' code (a build that tested the
// modes at run time ran those calls 2-6% slower on the H100).
//
// kv_valid: a dead key is masked as a causally masked one (in (b) the
// block's resident keys' bits are read once, in (c) each step's 32 keys
// are one packed word); a row with no live key has lse = +inf from the
// forward, so P = 0 on it here, and dead_rows sums the dO of such rows a
// KV head, which (b) adds, times 1 / Sk, to dv at every key. The skip also
// leaves out what the mask makes dead: a (b) block none of whose 64 keys
// is live runs no step (dk = 0, dv dead_rows' term alone), else its query
// stream runs from its first live key (causal) to its last live key's
// window; (c) cuts its keys to the batch row's first and last live key
// (kv_bounds, a pass after the packing), so a block whose rows all come
// before the first (causal) or whose batch row has none runs no step (dq
// = 0), and its producer and both consumers leave out a step whose packed
// word is 0 (each reads the word). Those steps have P = 0 and dS = 0, so
// leaving them out keeps the bits (above); holes inside the range run.
//
// probs_bf16: the prepare pass splits V as bf16(v) and 0, so dP = dO
// bf16(v)^T, rounded to bfloat16 on the CUDA cores (the cast of p
// transposes to a cast of its cotangent); dS = P (bf16(dP) - delta) from
// the float32 P; (b) stores P_hi = bf16(P) and P_lo = tf32(P - P_hi),
// warpgroup 1 reads P_hi + P_lo for dS and dV^T += dO^T bf16(P) reads
// P_hi alone; dv is rounded to bfloat16 once summed (the cast of v
// transposes to a cast of dv). delta is the reference's sum_j P_j
// bf16(dP_j), which rowsum(dO o) is not once P and dP are rounded. With
// dS' = P bf16(dP), dQ = scale (dS K) = scale (dS' K - delta (P K)), and
// (c) sees every key of its rows: so (c) runs first, warpgroup 1 sums A =
// dS' K and delta, warpgroup 0 B = P K on the P tile it writes, and (c)
// writes dq = scale (A - delta B) and delta, which (b) then reads.
//
// Zero lo parts: a product of a lo part that is exactly zero adds exact
// zeros, so the mode builds drop it (Zeros) and do not stream that tile:
// V's with probs_bf16 (dP = dO_lo V_hi + dO_hi V_hi in (b) and (c)) and
// bf16(P)'s in dV; K's, V's and dO's with bfloat16 inputs. At D = 128 in
// float32 a probs_bf16 step runs 10 TF32 products in (b) (not 12) and 11
// in (c) (S, dP, dS' K, P K); with bfloat16 inputs 7 in each.
//
// Registers at D = 128, where the mode builds went past their 240 (each
// step found by ptxas's spill report): where V's lo is zero, (b)'s
// warpgroup 1 keeps V_hi in shared memory in V_lo's place and reads it by
// wgmma from there (kHiSmem), and each warpgroup of (b) loops over its own
// code; with probs_bf16, (b)'s warpgroup 0 issues its next S after its dV
// product rather than behind it, and (c)'s warpgroup 1 loads its
// gradient's A fragments lo, then hi (grads_lean) and sums delta in the
// stats area, not in registers.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "attention_modes.cuh"
#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kRes = 64;    // resident rows of a block: keys (b), rows (c)
constexpr int kStep = 32;   // streamed rows a step: query rows (b), keys (c)
constexpr int kConsumers = 256;  // warpgroups 0 and 1
constexpr int kThreads = kConsumers + 128;  // and the producer warpgroup
constexpr int kAtom = 128;  // bytes in a swizzled row (32 floats)
constexpr int kExBytes = kRes * kStep * 4;  // an exchange tile's hi or lo

// Builds of (b) and (c) (template M): without the modes, with kv_valid
// alone, and with probs_bf16 (kv_valid then read at run time).
constexpr int kKvBuild = 1, kPbBuild = 2;
// A product's operands whose lo part is exactly zero (bit set): its
// products on that lo part are dropped. A: the first operand (the
// resident rows of a score product, the streamed tile of a gradient), B:
// the second. kHiSmem (a score product whose resident lo is zero): the
// resident hi lives in shared memory in the lo tile's place, read by
// wgmma from there, so it holds no fragment registers.
constexpr int kNoALo = 1, kNoBLo = 2, kHiSmem = 4;

// Which lo parts are zero in build M with inputs of type T: V's with
// probs_bf16 (split as bf16(v) and 0), and K's, V's and dO's with
// bfloat16 inputs (they widen exactly); the build without the modes runs
// every product. Per product of a step, as the header lists them, and
// the producer's lo tiles left unloaded (bit 0 X0's, bit 1 X1's).
template <typename T, int M>
struct Zeros {
  static constexpr bool kBf = M != 0 && std::is_same<T, __nv_bfloat16>::value;
  static constexpr bool kK = kBf, kDo = kBf, kV = kBf || M == kPbBuild;
  static constexpr bool kPb = M == kPbBuild;
  // (b): S^T = K Q^T; dV^T += dO^T bf16(P) (P's lo with probs_bf16);
  // dP^T = V dO^T (V_hi in shared memory where V's lo is zero); dK^T +=
  // (q scale)^T dS
  static constexpr int kS0b = kK ? kNoALo : 0;
  static constexpr int kDv = (kDo ? kNoALo : 0) | (kPb ? kNoBLo : 0);
  static constexpr int kS1b = (kV ? kNoALo | kHiSmem : 0) | (kDo ? kNoBLo : 0);
  static constexpr int kDk = 0;
  static constexpr int kSkipB = kDo ? 2 : 0;
  // (c): S = (q scale) K^T; dP = dO V^T; dQ^T += K^T dS^T (and with
  // probs_bf16 K^T P^T)
  static constexpr int kS0c = kK ? kNoBLo : 0;
  static constexpr int kS1c = (kDo ? kNoALo : 0) | (kV ? kNoBLo : 0);
  static constexpr int kDq = kK ? kNoALo : 0;
  static constexpr int kSkipC = (kK ? 1 : 0) | (kV ? 2 : 0);
};

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
  // modes (attention_modes.cuh): the packed kv_valid words (null without
  // a mask; nw a batch row, row-block bh reading row bh / hq), each batch
  // row's first and last live key (kv_bounds), the dead rows' dO sums,
  // and the flags
  const uint32_t* bits;
  const int* bounds;
  const float* dead;
  int nw, hq, flags;
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
// With HiSmem (the lo part zero) the hi part goes to shared memory in the
// lo tile's place, and rh is left alone.
template <int D, bool HiSmem = false>
__device__ __forceinline__ void load_resident(uint32_t* rh, uint32_t lo,
                                              const float* __restrict__ hi_src,
                                              const float* __restrict__ lo_src,
                                              int64_t r0, int wt, int lr,
                                              int t) {
  const float* h = hi_src + r0 * D;
  if constexpr (!HiSmem) {
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        rh[4 * kk + r] = __float_as_uint(
            h[(lr + 8 * (r % 2)) * D + 8 * kk + t + 4 * (r / 2)]);
  }
  const float* l = (HiSmem ? hi_src : lo_src) + r0 * D;
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
// kk); R 64 rows, X a 32-row streamed tile; Z drops the products of a
// zero R_lo (kNoALo) or X_lo (kNoBLo).
template <int D, int Z, int KK>
__device__ __forceinline__ void scores_from(float* sc, const uint32_t* rh,
                                            uint64_t rlo, uint64_t xhi,
                                            uint64_t xlo) {
  if constexpr (KK < D / 8) {
    if constexpr (!(Z & kNoALo))
      WgmmaSS<32, k_step(KK, kRes), k_step(KK, kStep)>::run(sc, rlo, xhi);
    scores_from<D, Z, KK + 1>(sc, rh, rlo, xhi, xlo);
  } else if constexpr (KK < 2 * (D / 8)) {
    constexpr int kk = KK - D / 8;
    if constexpr (Z & kHiSmem) {
      if constexpr (!(Z & kNoBLo))
        WgmmaSS<32, k_step(kk, kRes), k_step(kk, kStep)>::run(sc, rlo, xlo);
    } else if constexpr (!(Z & kNoBLo)) {
      wgmma_rs32<k_step(kk, kStep)>(sc, rh + 4 * kk, xlo);
    }
    scores_from<D, Z, KK + 1>(sc, rh, rlo, xhi, xlo);
  } else if constexpr (KK < 3 * (D / 8)) {
    constexpr int kk = KK - 2 * (D / 8);
    if constexpr (Z & kHiSmem)
      WgmmaSS<32, k_step(kk, kRes), k_step(kk, kStep)>::run(sc, rlo, xhi);
    else
      wgmma_rs32<k_step(kk, kStep)>(sc, rh + 4 * kk, xhi);
    scores_from<D, Z, KK + 1>(sc, rh, rlo, xhi, xlo);
  }
}

// T (64 x 32: sc[4 j + 2 i + e] is resident row lr + 8 i, streamed row 8 j
// + 2 t + e) of the resident rows (rh, lo tile at rlo) against the
// streamed tile at x (its lo at x + kTileBytes), issued and committed as
// one group.
template <int D, int Z = 0>
__device__ __forceinline__ void issue_scores(float* sc, const uint32_t* rh,
                                             uint32_t rlo, uint32_t x) {
  rlo = opaque(rlo);
  x = opaque(x);
#pragma unroll
  for (int i = 0; i < 16; ++i) sc[i] = 0.0f;
  fence_regs<16>(sc);
  wgmma_fence();
  scores_from<D, Z, 0>(sc, rh, sw128_desc(rlo), sw128_desc(x),
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
// kExBytes), in the layout wgmma reads as a K-major operand; with pb the
// hi part is bf16(x) (and lo tf32(x - hi)).
__device__ __forceinline__ void store_tile(const float* sc, uint32_t p,
                                           int lr, int t, int pb = 0) {
  const ExBase ex(p, lr, t);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const uint32_t at = ex(i, j, e);
        const float x = sc[4 * j + 2 * i + e];
        const float h = pb ? modes::bf16_round(x) : to_tf32(x);
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
// al[4 kk + r] (al only with Lo); columns past D (D = 32) are zeros. With
// lr = 16 w + g,
// column 64 c + m is in atom 2 c + w / 2, 16-byte chunk 4 (w % 2) + g / 4 +
// 2 (r % 2), float g % 4, and the row's swizzle XORs the chunk with 2 t +
// r / 2: a per-thread base, a constant and one XOR; and the 32 lanes of a
// load hit 32 banks.
template <int D, bool Lo = true>
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
        if constexpr (Lo) l = ld_shared(at + Layout<D>::kTileBytes);
      }
      ah[4 * kk + r] = h;
      if constexpr (Lo) al[4 * kk + r] = l;
    }
}

// The k steps J.. of a gradient chunk: A_lo B_hi, A_hi B_lo, A_hi B_hi (B
// the exchange tile: its 32 columns are one atom, k step kk 32 bytes = 2
// descriptor units into it), up to JEnd; Z drops those of a zero A_lo or
// B_lo.
template <int Z, int J, int JEnd = 12>
__device__ __forceinline__ void grad_from(float* tmp, const uint32_t* ah,
                                          const uint32_t* al, uint64_t bh,
                                          uint64_t bl) {
  if constexpr (J < JEnd) {
    constexpr int kk = J % 4;
    if constexpr (!((J < 4 && (Z & kNoALo)) ||
                    (J >= 4 && J < 8 && (Z & kNoBLo))))
      wgmma_rs64<2 * kk>(tmp, (J < 4 ? al : ah) + 4 * kk,
                         J >= 4 && J < 8 ? bl : bh);
    grad_from<Z, J + 1, JEnd>(tmp, ah, al, bh, bl);
  }
}

// One gradient chunk into a fresh sum tmp: 12 products (fewer with Z),
// A_lo B_hi, A_hi B_lo, A_hi B_hi over the 4 k steps, B the exchange tile
// at b; issued and committed as one group.
template <int Z>
__device__ __forceinline__ void issue_grad(float* tmp, const uint32_t* ah,
                                           const uint32_t* al, uint32_t b) {
#pragma unroll
  for (int i = 0; i < 32; ++i) tmp[i] = 0.0f;
  fence_regs<32>(tmp);
  wgmma_fence();
  b = opaque(b);
  grad_from<Z, 0>(tmp, ah, al, sw128_desc(b), sw128_desc(b + kExBytes));
  wgmma_commit();
}

// The same chunk with the A fragments in one array f, in two groups: A_lo
// B_hi (A_lo loaded into f), waited for, then A_hi B_lo and A_hi B_hi
// (A_hi loaded into f); the same products in the same order as
// issue_grad, so the same bits, with half the fragment registers.
template <int D, int Z>
__device__ __forceinline__ void issue_grad_lean(float* tmp, uint32_t* f,
                                                uint32_t x, int c, uint32_t b,
                                                int lr, int t) {
  uint32_t unused[16];
#pragma unroll
  for (int i = 0; i < 32; ++i) tmp[i] = 0.0f;
  b = opaque(b);
  if constexpr (!(Z & kNoALo)) {
    load_frags<D, false>(f, unused, x + Layout<D>::kTileBytes, c, lr, t);
    fence_regs<32>(tmp);
    wgmma_fence();
    grad_from<Z, 0, 4>(tmp, f, f, sw128_desc(b), sw128_desc(b));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<16>(f);
  }
  load_frags<D, false>(f, unused, x, c, lr, t);
  fence_regs<32>(tmp);
  wgmma_fence();
  grad_from<Z, 4>(tmp, f, f, sw128_desc(b), sw128_desc(b + kExBytes));
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
// products asynchronous). Z drops the gradient's products on zero lo
// parts, ZS the next T's.
template <int D, bool More, int Z = 0, int ZS = 0>
__device__ __forceinline__ void grads(float* acc, uint32_t x, uint32_t b,
                                      int lr, int t, float* sc = nullptr,
                                      const uint32_t* rh = nullptr,
                                      uint32_t rlo = 0, uint32_t nx = 0,
                                      uint32_t nfull = 0, int nparity = 0) {
  constexpr bool kALo = !(Z & kNoALo);
  uint32_t ah[16], al[16];
  float tmp[32];
  load_frags<D, kALo>(ah, al, x, 0, lr, t);
  issue_grad<Z>(tmp, ah, al, b);
  if constexpr (More) {
    mbar_wait(nfull, nparity);
    issue_scores<D, ZS>(sc, rh, rlo, nx);
    wgmma_wait<1>();
  } else {
    wgmma_wait<0>();
  }
  fence_regs<32>(tmp);
  fence_regs<16>(ah);
  if constexpr (kALo) fence_regs<16>(al);
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] += tmp[i];
  if constexpr (D > 64) {
    load_frags<D, kALo>(ah, al, x, 1, lr, t);
    issue_grad<Z>(tmp, ah, al, b);
    wgmma_wait<0>();
    fence_regs<32>(tmp);
    fence_regs<16>(ah);
    if constexpr (kALo) fence_regs<16>(al);
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[32 + i] += tmp[i];
  } else if constexpr (More) {
    wgmma_wait<0>();
  }
  if constexpr (More) fence_regs<16>(sc);
}

// grads with each chunk by issue_grad_lean: 16 fragment registers, not
// 32 (for a warpgroup at the edge of its 240); with More the next T
// behind the first chunk, as grads.
template <int D, bool More, int Z, int ZS = 0>
__device__ __forceinline__ void grads_lean(float* acc, uint32_t x,
                                           uint32_t b, int lr, int t,
                                           float* sc = nullptr,
                                           const uint32_t* rh = nullptr,
                                           uint32_t rlo = 0, uint32_t nx = 0,
                                           uint32_t nfull = 0,
                                           int nparity = 0) {
  uint32_t f[16];
  float tmp[32];
#pragma unroll
  for (int c = 0; c < (D + 63) / 64; ++c) {
    issue_grad_lean<D, Z>(tmp, f, x, c, b, lr, t);
    if (More && c == 0) {
      mbar_wait(nfull, nparity);
      issue_scores<D, ZS>(sc, rh, rlo, nx);
      wgmma_wait<1>();
    } else {
      wgmma_wait<0>();
    }
    fence_regs<32>(tmp);
    fence_regs<16>(f);
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[32 * c + i] += tmp[i];
  }
  if constexpr (More && D <= 64) wgmma_wait<0>();
  if constexpr (More) fence_regs<16>(sc);
}

// acc (as in grads) times ``mul`` into out (n_max rows of D): row n0 +
// 8 j + 2 t + e, column 64 c + lr + 8 i; plus add[column] where add is
// given, rounded to bfloat16 with rnd.
template <int D, typename T>
__device__ __forceinline__ void store_out(const float* acc, T* out, int n0,
                                          int n_max, float mul, int lr,
                                          int t, const float* add = nullptr,
                                          int rnd = 0) {
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
          if (n < n_max) {
            float x = mul * acc[32 * c + 4 * j + 2 * i + e];
            if (add != nullptr) x += add[col];
            store1(out + (int64_t)n * D + col,
                   rnd ? modes::bf16_round(x) : x);
          }
        }
    }
}

// A warpgroup's index, given at run time or as a constant.
__device__ __forceinline__ int wg_index(int w) { return w; }
template <int W>
__device__ __forceinline__ constexpr int wg_index(
    std::integral_constant<int, W>) {
  return W;
}

// -------------------------------------------------------------------- work

// (b): KV head kvh, keys k0 .. k0 + 63, query tiles [t0, t1) of 32 rows
// (every tile some row of which sees a key of the block; all with !skip).
// With kv_valid (M) the block's live keys stand for its keys: none, and
// the block runs no step; else the rows from its first live key (causal)
// to its last live key's window.
struct KvWork {
  int kvh, k0, t0, t1;
};

template <int M>
__device__ __forceinline__ KvWork kv_work(const Shape& s) {
  const int nkt = (s.sk + kRes - 1) / kRes;
  KvWork w;
  w.kvh = blockIdx.x / nkt;
  w.k0 = (blockIdx.x % nkt) * kRes;
  int lo = 0, hi = s.sq;
  if (s.skip) {
    int first = w.k0, last = min(w.k0 + kRes, s.sk) - 1;
    if constexpr (M != 0) {
      if (s.bits != nullptr) {
        const int wd = w.k0 / modes::kWordKeys;
        const uint32_t* row =
            s.bits + (int64_t)(w.kvh * s.kv_group / s.hq) * s.nw + wd;
        const uint64_t live =
            row[0] | (wd + 1 < s.nw ? (uint64_t)row[1] << 32 : 0ull);
        if (live == 0ull) {
          w.t0 = w.t1 = 0;
          return w;
        }
        first = w.k0 + __ffsll((long long)live) - 1;
        last = w.k0 + 63 - __clzll((long long)live);
      }
    }
    if (s.causal) lo = first;
    if (s.window > 0) hi = min(hi, last + s.window);
  }
  w.t0 = lo / kStep;
  w.t1 = hi > lo ? (hi + kStep - 1) / kStep : w.t0;
  return w;
}

// (c): head bh (KV head kvh), rows q0 .. q0 + 63, key tiles [t0, t1) of
// 32 keys, n of them run; blocks KV head by KV head, the longest causal
// rows first. With kv_valid (M) the keys are also cut to the batch row's
// [first, last] live keys (kv_bounds; none live, or rows all before the
// first under causal, and the block runs no step), and the tiles whose
// packed word is 0 are not run (n counts the others, 32 words a round by
// a ballot: every lane of the calling warp calls q_work).
struct QWork {
  int bh, kvh, q0, t0, t1, n;
};

// With kv_valid and the skip, head bh's packed words, whose zero words
// (key tiles with no live key) (c) does not run; else null.
__device__ __forceinline__ const uint32_t* skip_words(const Shape& s,
                                                      int bh) {
  return s.skip && s.bits != nullptr ? s.bits + (int64_t)(bh / s.hq) * s.nw
                                     : nullptr;
}

// The first key tile at or after t, before t1, that (c) runs.
__device__ __forceinline__ int next_tile(const uint32_t* words, int t,
                                         int t1) {
  if (words != nullptr)
    while (t < t1 && words[t] == 0u) ++t;
  return t;
}

template <int M>
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
    if constexpr (M != 0) {
      if (s.bits != nullptr) {
        const int b = w.bh / s.hq;
        lo = max(lo, s.bounds[2 * b]);
        hi = min(hi, s.bounds[2 * b + 1] + 1);
      }
    }
  }
  w.t0 = lo / kStep;
  w.t1 = hi > lo ? (hi + kStep - 1) / kStep : w.t0;
  w.n = w.t1 - w.t0;
  if constexpr (M != 0) {
    const uint32_t* words = skip_words(s, w.bh);
    if (words != nullptr) {
      const int lane = threadIdx.x % 32;
      w.n = 0;
      for (int t = w.t0; t < w.t1; t += 32)
        w.n += __popc(__ballot_sync(
            0xffffffffu, t + lane < w.t1 && words[t + lane] != 0u));
    }
  }
  return w;
}

// The producer (one thread): each step's X0 hi, X0 lo, X1 hi, X1 lo boxes
// (32 rows x 32 floats, one per column atom) at scratch row next_row(),
// called once a step in order; with stats (b), those rows' lse and delta
// (the scratch's rows, so the same index) beside them. Skip leaves out
// the lo boxes that are zeros (bit 0 X0's, bit 1 X1's): no product reads
// them.
template <int D, int Skip = 0, typename NextRow>
__device__ __forceinline__ void produce(const CUtensorMap* x0h,
                                        const CUtensorMap* x0l,
                                        const CUtensorMap* x1h,
                                        const CUtensorMap* x1l, int n_steps,
                                        NextRow next_row,
                                        const float* lse = nullptr,
                                        const float* delta = nullptr) {
  using L = Layout<D>;
  constexpr int kS = L::kStages;
  constexpr int kBytes = L::kStageBytes - ((Skip & 1) + (Skip >> 1)) *
                                              L::kTileBytes;
  const uint32_t base = smem_base();
  for (int n = 0; n < n_steps; ++n) {
    const int s = n % kS;
    const uint32_t full = base + L::kBar + 16 * s;
    if (n >= kS) mbar_wait(full + 8, ((n / kS) - 1) & 1);
    mbar_expect_tx(full, kBytes + (lse ? L::kStatBytes : 0));
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
      if constexpr (!(Skip & 1))
        tma_load(at + L::kTileBytes, x0l, full, 32 * a, row);
      tma_load(at + 2 * L::kTileBytes, x1h, full, 32 * a, row);
      if constexpr (!(Skip & 2))
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
template <int D, typename T, int M>
__device__ __forceinline__ void dkdv_consume(
    const float* __restrict__ res_hi, const float* __restrict__ res_lo,
    T* __restrict__ out, const Shape& sh) {
  using L = Layout<D>;
  using Z = Zeros<T, M>;
  const KvWork wk = kv_work<M>(sh);
  const int g = sh.kv_group, n_steps = (wk.t1 - wk.t0) * g;
  const int w = threadIdx.x / 128, wt = threadIdx.x % 128;
  const int t = wt % 4, lr = 16 * (wt / 32) + (wt % 32) / 4;
  const uint32_t base = smem_base(), rlo = base + w * L::kResBytes;
  const uint32_t p = base + L::kP, ds = base + L::kDs;
  constexpr int pb = Z::kPb;
  // the warpgroups' products differ only where a lo part is zero
  constexpr bool kOneSite = Z::kS0b == Z::kS1b && Z::kDv == Z::kDk;
  // bit i: resident key k0 + lr + 8 i is live in kv_valid (the group's
  // heads are all of one batch element)
  uint32_t kvok = 3u;
  if (M && sh.bits != nullptr) {
    const uint32_t* row = sh.bits + (int64_t)(wk.kvh * g / sh.hq) * sh.nw;
    kvok = 0u;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int key = wk.k0 + lr + 8 * i;
      if (key < sh.sk && ((row[key / 32] >> (key % 32)) & 1u))
        kvok |= 1u << i;
    }
  }
  uint32_t rh[D / 2];
  const int64_t r0 = (int64_t)wk.kvh * sh.skp + wk.k0;
  if (Z::kS1b & kHiSmem && w == 1)  // V_hi in V_lo's (zero) place
    load_resident<D, true>(rh, rlo, res_hi, res_lo, r0, wt, lr, t);
  else
    load_resident<D>(rh, rlo, res_hi, res_lo, r0, wt, lr, t);
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
    if (kOneSite || w == 0)
      issue_scores<D, Z::kS0b>(sc, rh, rlo, stage(0) + mine);
    else
      issue_scores<D, Z::kS1b>(sc, rh, rlo, stage(0) + mine);
    wgmma_wait<0>();
    fence_regs<16>(sc);
  }
  // this step's gradient with product drops ZG, and the next T's, ZS;
  // with probs_bf16 at D = 128 warpgroup 0's next T follows its gradient
  // (behind it, it spills)
  auto run_grads = [&](int n, uint32_t x, uint32_t b, auto more, auto zg,
                       auto zs) {
    constexpr int ZG = decltype(zg)::value, ZS = decltype(zs)::value;
    constexpr bool kMore = decltype(more)::value;
    if constexpr (pb && D > 64 && ZG == Z::kDv) {
      grads<D, false, ZG>(acc, x, b, lr, t);
      if constexpr (kMore) {
        mbar_wait(full(n + 1), parity(n + 1));
        issue_scores<D, ZS>(sc, rh, rlo, stage(n + 1) + mine);
        wgmma_wait<0>();
        fence_regs<16>(sc);
      }
    } else if constexpr (kMore)
      grads<D, true, ZG, ZS>(acc, x, b, lr, t, sc, rh, rlo,
                             stage(n + 1) + mine, full(n + 1),
                             parity(n + 1));
    else
      grads<D, false, ZG>(acc, x, b, lr, t);
  };
  using S0 = std::integral_constant<int, Z::kS0b>;
  using S1 = std::integral_constant<int, Z::kS1b>;
  using G0 = std::integral_constant<int, Z::kDv>;
  using G1 = std::integral_constant<int, Z::kDk>;
  // wg: this warpgroup, w at run time where both take the same products,
  // else a constant, each warpgroup looping over its own code (one loop
  // over both their codes spills at D = 128)
  auto step = [&](int n, auto more, auto wg) {
    constexpr bool kMore = decltype(more)::value;
    const int q0 = (wk.t1 - 1 - n / g) * kStep;
    const uint32_t st = stage(n);
    uint32_t x, b;
    if (wg_index(wg) == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& v = sc[4 * j + 2 * i + e];
            v = live(q0 + 8 * j + 2 * t + e, wk.k0 + lr + 8 * i, sh) &&
                        ((kvok >> i) & 1u)
                    ? fast_exp(v - stat(n, j, e))
                    : 0.0f;
          }
      if (n > 0) bar_sync(4, kConsumers);  // warpgroup 1 has read P
      store_tile(sc, p, lr, t, pb);
      smem_ready(0);
      bar_arrive(3, kConsumers);
      x = st + 2 * L::kTileBytes;  // dV^T += dO^T P (P_hi alone with pb)
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
            const float dp = pb ? modes::bf16_round(sc[v]) : sc[v];
            sc[v] = pv[v] * (dp - stat(n, j, e));
          }
      store_tile(sc, ds, lr, t);
      smem_ready(1);
      x = st;  // dK^T += (q scale)^T dS
      b = ds;
    }
    if (kOneSite || wg_index(wg) == 0)
      run_grads(n, x, b, more, G0{}, S0{});
    else
      run_grads(n, x, b, more, G1{}, S1{});
    mbar_arrive(full(n) + 8);
  };
  auto loop = [&](auto wg) {
    for (int n = 0; n + 1 < n_steps; ++n) step(n, std::true_type{}, wg);
    if (n_steps > 0) step(n_steps - 1, std::false_type{}, wg);
  };
  if constexpr (kOneSite)
    loop(w);
  else if (w == 0)
    loop(std::integral_constant<int, 0>{});
  else
    loop(std::integral_constant<int, 1>{});
  // dv (warpgroup 0): plus the dead rows' term at every key, rounded to
  // bfloat16 with pb
  store_out<D, T>(acc, out + (int64_t)wk.kvh * sh.sk * D, wk.k0, sh.sk, 1.0f,
                  lr, t,
                  M && w == 0 && sh.dead != nullptr
                      ? sh.dead + (int64_t)wk.kvh * D
                      : nullptr,
                  w == 0 ? pb : 0);
}

template <int D, typename T, int M>
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
      const KvWork wk = kv_work<M>(sh);
      const int g = sh.kv_group;
      const int head_rows = sh.sqp, row0 = wk.kvh * g * head_rows;
      int gi = 0, q0 = (wk.t1 - 1) * kStep;
      produce<D, Zeros<T, M>::kSkipB>(
                 &tm_qhi, &tm_qlo, &tm_dohi, &tm_dolo, (wk.t1 - wk.t0) * g,
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
    dkdv_consume<D, T, M>(w ? vhi : khi, w ? vlo : klo, w ? dk : dv, sh);
  }
}

// ------------------------------------------------------------------ (c) dQ

// Warpgroup w of (c): resident q scale (w = 0, with lse) or dO (w = 1,
// with delta, writing dq); see the header for a step. At D <= 64
// warpgroup 1 issues each step's dP behind the previous step's gradient
// (grads); at D = 128 it has no registers for that.
//
// With probs_bf16 (M = kPbBuild) (c) runs first and no delta is read:
// warpgroup 1 takes dS' = P bf16(dP) in place of dS, sums A^T += K^T
// dS'^T and each row's delta = sum_j P_j bf16(dP_j), and warpgroup 0
// sums B^T += K^T P^T on the P tile it wrote (a gradient product as
// warpgroup 1's, its next S issued behind it); at the end B crosses to
// warpgroup 1 through the idle stages (named barriers 5 and 6), which
// writes dq = scale (A - delta B) and delta to the scratch for (b).
template <int D, typename T, int M>
__device__ __forceinline__ void dq_consume(const float* __restrict__ res_hi,
                                           const float* __restrict__ res_lo,
                                           const float* stats,
                                           T* __restrict__ dq,
                                           float* delta_out,
                                           const Shape& sh) {
  using L = Layout<D>;
  using Z = Zeros<T, M>;
  constexpr bool kPb = Z::kPb;
  const QWork wk = q_work<M>(sh);
  const int n_steps = wk.n;
  const int w = threadIdx.x / 128, wt = threadIdx.x % 128;
  const int t = wt % 4, lr = 16 * (wt / 32) + (wt % 32) / 4;
  const uint32_t base = smem_base(), rlo = base + w * L::kResBytes;
  const uint32_t p = base + L::kP, ds = base + L::kDs;
  uint32_t rh[D / 2];
  load_resident<D>(rh, rlo, res_hi, res_lo,
                   (int64_t)wk.bh * sh.sqp + wk.q0, wt, lr, t);
  smem_ready(w);
  // lse (w = 0) or delta (w = 1, but for probs_bf16, which makes it) of
  // this thread's rows q0 + lr + 8 i
  float stat[2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
    stat[i] = kPb && w == 1
                  ? 0.0f
                  : stats[(int64_t)wk.bh * sh.sqp + wk.q0 + lr + 8 * i];
  auto stage = [&](int n) {
    return base + L::kStage0 + (n % L::kStages) * L::kStageBytes;
  };
  auto full = [&](int n) { return base + L::kBar + 16 * (n % L::kStages); };
  auto parity = [&](int n) { return (n / L::kStages) & 1; };
  float sc[16];
  float acc[32 * ((D + 63) / 64)];
  // where B (warpgroup 0) crosses to warpgroup 1: acc[i] of thread wt at
  // float i 128 + wt of the stages
  auto cross = [&](int i) { return base + L::kStage0 + 4 * (i * 128 + wt); };

  constexpr bool kPipe = D <= 64;
  if (w == 0) {
    // step n's key tile (M: the zero words' tiles left out) and its 32
    // keys' packed kv_valid word. In the kv_valid build prefetch() loads
    // the word after the current tile before a wait on the tensor cores
    // (no load moves past that wait, and the wait hides its latency) and
    // advance(n) takes it (in the probs_bf16 build, whose registers are
    // spent, advance reads it), reading further only past a word of 0 (a
    // skipped tile)
    int tile = wk.t0 - 1;
    uint32_t word = ~0u, ahead = ~0u;
    auto word_at = [&](int k) {
      return sh.bits[(int64_t)(wk.bh / sh.hq) * sh.nw + k];
    };
    auto prefetch = [&]() {
      if (M == kKvBuild && sh.bits && tile + 1 < wk.t1)
        ahead = word_at(tile + 1);
    };
    auto advance = [&](int n) {
      if constexpr (M == kKvBuild) {
        tile += 1;
        word = ahead;
        if (sh.skip && word == 0u) {
          tile = next_tile(skip_words(sh, wk.bh), tile + 1, wk.t1);
          word = word_at(tile);
        }
        return;
      }
      tile = M ? next_tile(skip_words(sh, wk.bh), tile + 1, wk.t1)
               : wk.t0 + n;
      if (M && sh.bits) word = word_at(tile);
    };
    // P = exp(S - lse) of the step's keys (sc), 0 on the masked ones
    auto probs = [&]() {
      const int k0 = tile * kStep;
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = sc[4 * j + 2 * i + e];
            x = live(wk.q0 + lr + 8 * i, k0 + 8 * j + 2 * t + e, sh) &&
                        ((word >> (8 * j + 2 * t + e)) & 1u)
                    ? fast_exp(x - stat[i])
                    : 0.0f;
          }
    };
    if constexpr (!kPb) {
      prefetch();
      for (int n = 0; n < n_steps; ++n) {
        advance(n);
        mbar_wait(full(n), parity(n));
        issue_scores<D, Z::kS0c>(sc, rh, rlo, stage(n));  // S, the K tile
        prefetch();
        wgmma_wait<0>();
        fence_regs<16>(sc);
        mbar_arrive(full(n) + 8);  // done with the stage
        probs();
        if (n > 0) bar_sync(4, kConsumers);  // warpgroup 1 has read P
        store_tile(sc, p, lr, t);
        bar_arrive(3, kConsumers);
      }
      return;
    } else {
#pragma unroll
      for (int i = 0; i < 32 * ((D + 63) / 64); ++i) acc[i] = 0.0f;
      auto issue_s = [&](int n) {  // S against the K tile
        mbar_wait(full(n), parity(n));
        issue_scores<D, Z::kS0c>(sc, rh, rlo, stage(n));
        wgmma_wait<0>();
        fence_regs<16>(sc);
      };
      prefetch();
      if (n_steps > 0) {
        advance(0);
        prefetch();  // behind the waits of issue_s
        issue_s(0);
      }
      auto step = [&](int n, auto more) {
        constexpr bool kMore = decltype(more)::value;
        probs();
        if constexpr (kMore) {
          advance(n + 1);
          prefetch();  // behind the waits of the gradient
        }
        if (n > 0) bar_sync(4, kConsumers);  // warpgroup 1 has read P
        store_tile(sc, p, lr, t);
        smem_ready(0);
        bar_arrive(3, kConsumers);
        // B^T += K^T P^T (at D <= 64 the next S behind it)
        if constexpr (kMore && kPipe)
          grads<D, true, Z::kDq, Z::kS0c>(acc, stage(n), p, lr, t, sc, rh,
                                          rlo, stage(n + 1), full(n + 1),
                                          parity(n + 1));
        else
          grads<D, false, Z::kDq>(acc, stage(n), p, lr, t);
        mbar_arrive(full(n) + 8);
        if constexpr (kMore && !kPipe) issue_s(n + 1);
      };
      for (int n = 0; n + 1 < n_steps; ++n) step(n, std::true_type{});
      if (n_steps > 0) step(n_steps - 1, std::false_type{});
      bar_sync(5, kConsumers);  // warpgroup 1 is done with the stages
#pragma unroll
      for (int i = 0; i < 32 * ((D + 63) / 64); ++i)
        st_shared(cross(i), acc[i]);
      bar_arrive(6, kConsumers);
      return;
    }
  }

  const uint32_t v_tile = 2 * L::kTileBytes;
  auto issue_dp = [&](int n) {  // dP against the V tile
    mbar_wait(full(n), parity(n));
    issue_scores<D, Z::kS1c>(sc, rh, rlo, stage(n) + v_tile);
    wgmma_wait<0>();
    fence_regs<16>(sc);
  };
#pragma unroll
  for (int i = 0; i < 32 * ((D + 63) / 64); ++i) acc[i] = 0.0f;
  // probs_bf16: delta of rows q0 + r in the (in (c) idle) stats area,
  // each step's part of it summed by the row's 4 threads (a quad) and
  // added by the first (so no register holds it across the loop)
  const uint32_t rows = base + L::kStats;
  if constexpr (kPb) {
    if (t == 0)
#pragma unroll
      for (int i = 0; i < 2; ++i) st_shared(rows + 4 * (lr + 8 * i), 0.0f);
  }
  if (n_steps > 0) issue_dp(0);
  auto step = [&](int n, auto more) {
    constexpr bool kMore = decltype(more)::value;
    float pv[16];
    bar_sync(3, kConsumers);
    load_tile(pv, p, lr, t);
    if (kMore) bar_arrive(4, kConsumers);
    float part[2] = {0.0f, 0.0f};
#pragma unroll
    for (int v = 0; v < 16; ++v) {
      if constexpr (kPb) {
        sc[v] = pv[v] * modes::bf16_round(sc[v]);
        part[(v / 2) % 2] += sc[v];
      } else {
        sc[v] = pv[v] * (sc[v] - stat[(v / 2) % 2]);
      }
    }
    if constexpr (kPb) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        part[i] += __shfl_xor_sync(0xffffffffu, part[i], 1);
        part[i] += __shfl_xor_sync(0xffffffffu, part[i], 2);
        const uint32_t at = rows + 4 * (lr + 8 * i);
        if (t == 0) st_shared(at, ld_sharedf(at) + part[i]);
      }
    }
    store_tile(sc, ds, lr, t);
    smem_ready(1);
    // dQ^T += K^T dS^T (probs_bf16 at D = 128: lean, for the registers
    // its delta and epilogue take)
    if constexpr (kMore && kPipe)
      grads<D, true, Z::kDq, Z::kS1c>(acc, stage(n), ds, lr, t, sc, rh, rlo,
                                      stage(n + 1) + v_tile, full(n + 1),
                                      parity(n + 1));
    else if constexpr (kPb && !kPipe)
      grads_lean<D, false, Z::kDq>(acc, stage(n), ds, lr, t);
    else
      grads<D, false, Z::kDq>(acc, stage(n), ds, lr, t);
    mbar_arrive(full(n) + 8);
    if constexpr (kMore && !kPipe) issue_dp(n + 1);
  };
  for (int n = 0; n + 1 < n_steps; ++n) step(n, std::true_type{});
  if (n_steps > 0) step(n_steps - 1, std::false_type{});
  if constexpr (kPb) {
    bar_arrive(5, kConsumers);  // done with the stages
    // delta to the scratch for (b)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = wk.q0 + lr + 8 * i;
      if (t == 0 && row < sh.sq)
        delta_out[(int64_t)wk.bh * sh.sqp + row] =
            ld_sharedf(rows + 4 * (lr + 8 * i));
    }
    bar_sync(2, 128);         // every row's delta is in place
    bar_sync(6, kConsumers);  // and warpgroup 0's B
    // acc is A (column 8 j + 2 t + e the row): A - delta B
#pragma unroll
    for (int c = 0; c < (D + 63) / 64; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int v = 32 * c + 4 * j + 2 * i + e;
            acc[v] = acc[v] - ld_sharedf(rows + 4 * (8 * j + 2 * t + e)) *
                                  ld_sharedf(cross(v));
          }
  }
  store_out<D, T>(acc, dq + (int64_t)wk.bh * sh.sq * D, wk.q0, sh.sq,
                  sh.scale, lr, t);
}

template <int D, typename T, int M>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq(const __grid_constant__ CUtensorMap tm_khi,
                 const __grid_constant__ CUtensorMap tm_klo,
                 const __grid_constant__ CUtensorMap tm_vhi,
                 const __grid_constant__ CUtensorMap tm_vlo,
                 const float* __restrict__ qhi, const float* __restrict__ qlo,
                 const float* __restrict__ dohi,
                 const float* __restrict__ dolo,
                 const float* __restrict__ lse, float* delta,
                 T* __restrict__ dq, Shape sh) {
  init_barriers<D>();
  if (threadIdx.x >= kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    // with the modes the producer's warp counts the tiles (q_work)
    if (threadIdx.x == kConsumers ||
        (M != 0 && threadIdx.x < kConsumers + 32)) {
      const QWork wk = q_work<M>(sh);
      if constexpr (M == 0) {
        int row = wk.kvh * sh.skp + wk.t0 * kStep - kStep;
        produce<D>(&tm_khi, &tm_klo, &tm_vhi, &tm_vlo, wk.t1 - wk.t0,
                   [&]() { return row += kStep; });
      } else if (threadIdx.x == kConsumers) {
        const uint32_t* skips = skip_words(sh, wk.bh);
        const int row0 = wk.kvh * sh.skp;
        int tile = wk.t0 - 1;
        produce<D, Zeros<T, M>::kSkipC>(
            &tm_khi, &tm_klo, &tm_vhi, &tm_vlo, wk.n, [&]() {
              tile = next_tile(skips, tile + 1, wk.t1);
              return row0 + tile * kStep;
            });
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");
    const bool w = threadIdx.x >= 128;
    dq_consume<D, T, M>(w ? dohi : qhi, w ? dolo : qlo, w ? delta : lse, dq,
                        delta, sh);
  }
}

// ----------------------------------------------------------- (a) prepare

// Scratch layout (float32, rows of D): q scale hi, lo and dO hi, lo
// (bh sqp rows each), K hi, lo and V hi, lo (bhkv skp rows each), then
// delta and lse (bh sqp each). Row r of head h sits at h sqp + r (h skp +
// r); rows past Sq (Sk) are zeros.
struct Scratch {
  float *qhi, *qlo, *dohi, *dolo, *khi, *klo, *vhi, *vlo, *delta, *lse;
  // with kv_valid: dead_rows's sums (bhkv D), the packed mask words (and
  // after them each batch row's first and last live key, launch's bounds)
  float* dead;
  uint32_t* bits;
  __host__ __device__ Scratch(float* w, int64_t qrows, int64_t krows,
                              int64_t bhkv, int d) {
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
    dead = lse + qrows;
    bits = reinterpret_cast<uint32_t*>(dead + bhkv * d);
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
  const Scratch s(work, qrows, krows, bhkv, D);
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
    const int pb = sh.flags & modes::kProbsBf16;
#pragma unroll
    for (int i = 0; i < D / 32; ++i) {
      const int c = lane + 32 * i;
      split(valid ? to_float(k[src + c]) : 0.0f, s.khi + dst + c,
            s.klo + dst + c);
      const float x = valid ? to_float(v[src + c]) : 0.0f;
      if (pb) {  // V as bf16(v) and 0
        s.vhi[dst + c] = modes::bf16_round(x);
        s.vlo[dst + c] = 0.0f;
      } else {
        split(x, s.vhi + dst + c, s.vlo + dst + c);
      }
    }
  }
}

// Block (32 columns, KV head), kv_valid only: the sum of dO over the rows
// of the head's kv_group query heads with lse = +inf (no live key), times
// the weight 1 / Sk such a row puts on every key: what those rows add to
// dv at each key. A fixed order: thread (c, y) sums rows y, y + 32, ...
// (32 warps a block, so that many rows' lse loads are in flight), then
// the 32 partial sums in turn.
template <typename T>
__global__ void __launch_bounds__(1024)
    flash_bwd_dead_rows(const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        float* __restrict__ dead, int g, int sq, int sk,
                        int D, int pb) {
  __shared__ float part[32][33];
  const int h = blockIdx.y, x = threadIdx.x % 32, y = threadIdx.x / 32;
  const int c = blockIdx.x * 32 + x;
  const int64_t r0 = (int64_t)h * g * sq, n = (int64_t)g * sq;
  float sum = 0.0f;
  for (int64_t r = y; r < n; r += 32)
    if (isinf(lse[r0 + r])) sum += to_float(dout[(r0 + r) * D + c]);
  part[y][x] = sum;
  __syncthreads();
  if (y == 0) {
    float total = 0.0f;
    for (int i = 0; i < 32; ++i) total += part[i][x];
    dead[(int64_t)h * D + c] = total * modes::dead_weight(sk, pb);
  }
}

// ------------------------------------------------------------------ host

// A head's scratch rows, padded to whole resident tiles (which load their
// 64 rows without bounds) and so to whole 32-row steps.
int padded(int n) { return (n + kRes - 1) / kRes * kRes; }

// The passes of a call, as ``only`` names them (kernels/flash_attention.py
// BWD_PASSES): the mask's packing and bounds, dead_rows, prepare, (b), (c).
enum Pass { kMaskPass, kDeadPass, kPreparePass, kDkdvPass, kDqPass };

template <int D, typename T, int M>
int launch_main(const CUtensorMap* qm, const CUtensorMap* km,
                const Scratch& s, void* dq, void* dk, void* dv, int bh,
                int bhkv, const Shape& sh, int only, cudaStream_t stream) {
  using L = Layout<D>;
  auto* dkdv = flash_bwd_dkdv<D, T, M>;
  auto* dqk = flash_bwd_dq<D, T, M>;
  cudaError_t err = cudaFuncSetAttribute(
      dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        dqk, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (err != cudaSuccess) return (int)err;
  auto run_dkdv = [&]() {
    if (only < 0 || only == kDkdvPass)
      dkdv<<<bhkv * ((sh.sk + kRes - 1) / kRes), kThreads, L::kBytes,
             stream>>>(qm[0], qm[1], qm[2], qm[3], s.khi, s.klo, s.vhi,
                       s.vlo, s.lse, s.delta, static_cast<T*>(dk),
                       static_cast<T*>(dv), sh);
    return cudaGetLastError();
  };
  auto run_dq = [&]() {
    if (only < 0 || only == kDqPass)
      dqk<<<bh * ((sh.sq + kRes - 1) / kRes), kThreads, L::kBytes,
            stream>>>(km[0], km[1], km[2], km[3], s.qhi, s.qlo, s.dohi,
                      s.dolo, s.lse, s.delta, static_cast<T*>(dq), sh);
    return cudaGetLastError();
  };
  // with probs_bf16, (c) makes the delta (b) reads
  if (M == kPbBuild) {
    err = run_dq();
    return (int)(err != cudaSuccess ? err : run_dkdv());
  }
  err = run_dkdv();
  return (int)(err != cudaSuccess ? err : run_dq());
}

template <int D, typename T>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, void* dq, void* dk, void* dv,
           float* work, const uint8_t* kv, int bh, int kv_group, int sq,
           int sk, int hq, int causal, int window, float scale, int skip,
           int mds, int only, cudaStream_t stream) {
  const int bhkv = bh / kv_group;
  const int64_t qrows = (int64_t)bh * padded(sq),
                krows = (int64_t)bhkv * padded(sk);
  const Scratch s(work, qrows, krows, bhkv, D);
  const int pb = (mds & modes::kProbsBf16) ? 1 : 0;
  // each batch row's first and last live key, after the packed words
  int* bounds = reinterpret_cast<int*>(
      s.bits + (int64_t)(bh / hq) * modes::mask_words(sk));
  const Shape sh{sq,
                 sk,
                 padded(sq),
                 padded(sk),
                 kv_group,
                 causal,
                 window,
                 skip,
                 scale,
                 kv ? s.bits : nullptr,
                 kv ? bounds : nullptr,
                 kv ? s.dead : nullptr,
                 modes::mask_words(sk),
                 hq,
                 pb ? modes::kProbsBf16 : 0};
  const T *qt = static_cast<const T*>(q), *kt = static_cast<const T*>(k),
          *vt = static_cast<const T*>(v), *ot = static_cast<const T*>(o),
          *dot = static_cast<const T*>(dout);
  cudaError_t err;
  if (kv != nullptr) {
    err = only < 0 || only == kMaskPass
              ? modes::launch_pack(kv, s.bits, bh / hq, sk, stream, bounds)
              : cudaSuccess;
    if (err != cudaSuccess) return (int)err;
    if (only < 0 || only == kDeadPass)
      flash_bwd_dead_rows<T><<<dim3(D / 32, bhkv), 1024, 0, stream>>>(
          dot, lse, s.dead, kv_group, sq, sk, D, pb);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (only < 0 || only == kPreparePass)
    flash_bwd_prepare<D, T><<<(unsigned)((qrows + krows + 7) / 8), 256, 0,
                              stream>>>(qt, kt, vt, ot, dot, lse, work, bh,
                                        bhkv, sh);
  err = cudaGetLastError();
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
  if (pb)
    return launch_main<D, T, kPbBuild>(qm, km, s, dq, dk, dv, bh, bhkv, sh,
                                       only, stream);
  if (kv != nullptr)
    return launch_main<D, T, kKvBuild>(qm, km, s, dq, dk, dv, bh, bhkv, sh,
                                       only, stream);
  return launch_main<D, T, 0>(qm, km, s, dq, dk, dv, bh, bhkv, sh, only,
                              stream);
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, const void* o,
             const void* dout, const float* lse, void* dq, void* dk,
             void* dv, float* work, const uint8_t* kv, int bh, int kv_group,
             int sq, int sk, int d, int hq, int causal, int window,
             float scale, int skip, int mds, int only, cudaStream_t stream) {
  switch (d) {
    case 32:
      return launch<32, T>(q, k, v, o, dout, lse, dq, dk, dv, work, kv, bh,
                           kv_group, sq, sk, hq, causal, window, scale, skip,
                           mds, only, stream);
    case 64:
      return launch<64, T>(q, k, v, o, dout, lse, dq, dk, dv, work, kv, bh,
                           kv_group, sq, sk, hq, causal, window, scale, skip,
                           mds, only, stream);
    case 128:
      return launch<128, T>(q, k, v, o, dout, lse, dq, dk, dv, work, kv, bh,
                            kv_group, sq, sk, hq, causal, window, scale,
                            skip, mds, only, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q, o, dout, dq (bh, sq, d) and k, v, dk, dv (bh / kv_group, sk, d):
// contiguous, 16-byte aligned, all float32 (bf16 = 0) or all bfloat16
// (bf16 = 1) on the device; lse (bh, sq) float32, the forward's (K5 with
// an lse array); work: float32 scratch of 4 bh sqp d + 4 (bh / kv_group)
// skp d + 2 bh sqp, sqp and skp being sq and sk rounded up to 64, and
// with kv_valid (bh / kv_group) d + (bh / hq) (ceil(sk / 32) + 2) more;
// kv_valid: null, or (bh / hq, sk) uint8 live keys, row-block bh reading
// row bh / hq; modes: 0 or kProbsBf16 (attention_modes.cuh); d in {32,
// 64, 128}; window <= 0 for none; skip = 1 skips the steps whose pairs
// are all masked (kernels/flash_attention.py checks shapes, types and
// shared memory, and refuses shapes with a row that sees no key for want
// of a window); only: -1 for the call, or one Pass alone on the scratch a
// call left (for timing). Launches the mask's packing and bounds and
// dead_rows (with kv_valid), the prepare pass, (b) and (c) (with
// probs_bf16 (c) first) on ``stream`` and returns cudaGetLastError() (or
// the error of raising a shared memory limit, or 10000 + the CUresult of
// a tensor map the driver refused).
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, const void* lse,
                                   void* dq, void* dk, void* dv, void* work,
                                   const void* kv_valid, int bh,
                                   int kv_group, int sq, int sk, int d,
                                   int bf16, int hq, int causal, int window,
                                   float scale, int skip, int mds, int only,
                                   void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* w = static_cast<float*>(work);
  const uint8_t* kv = static_cast<const uint8_t*>(kv_valid);
  return bf16 ? launch_d<__nv_bfloat16>(q, k, v, o, dout, l, dq, dk, dv, w,
                                        kv, bh, kv_group, sq, sk, d, hq,
                                        causal, window, scale, skip, mds,
                                        only, s)
              : launch_d<float>(q, k, v, o, dout, l, dq, dk, dv, w, kv, bh,
                                kv_group, sq, sk, d, hq, causal, window,
                                scale, skip, mds, only, s);
}
