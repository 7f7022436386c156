// Flash attention (online softmax) over flattened (BH, S, D) tensors on
// Hopper's tensor cores: o = softmax(mask(q k^T scale)) v per (batch,
// head), causal masking, a one-sided sliding window (k > q - window) and
// the key count Sk as the bound, query and key positions both counted from
// 0. Query row-block bh reads KV head bh / kv_group (GQA's shared KV head,
// in the grouping of ``repeat_interleave``); kv_group = 1 is the TPU
// kernel's contract.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention_bhsd, body _attn_kernel). That kernel runs a (BH, q
// blocks, k blocks) grid whose k axis is sequential on the TPU's one core,
// carrying the online-softmax statistics m, l and the (128, D) sum in VMEM
// scratch, and pads Sq and Sk to blocks of 128 (padded keys masked by
// kv_len). Here one block owns 128 query rows of one head and loops over
// the 32-key tiles itself (blocks run in no order, so nothing can carry
// between them); m, l and the sum stay in registers across the loop. Per
// tile, in the TPU kernel's order: s = (q scale) k^T; masked scores set to
// -1e30, never -inf; m' = max(m, rowmax s); alpha = exp(m - m');
// p = exp(s - m'); l = alpha l + rowsum p; acc = acc alpha + p v; at the
// end o = acc / max(l, 1e-30), in q's type, and, when the caller passes
// an lse array (kernels/flash_attention.py::FlashAttention does, for the
// backward kernel csrc/flash_attention_bwd.cu), each row's m + log(l),
// written after the loop (o's bits do not depend on it). Keys past Sk get
// p = 0 and leave m, l and acc as they were. exp is 2^(x log2 e) on the
// special-function unit (ex2.approx, ~2 ulp): expf's longer sequence sat
// on the critical path of the softmax.
//
// -1e30 and the fully masked tile: a row whose first tile holds only
// masked keys (a window row) gets p = exp(0) = 1 there, junk that the
// first tile with a live key wipes out exactly (alpha = exp(-1e30 - m) is
// 0). With -inf that row would become NaN. For the same reason, skipping
// the tiles that lie wholly above the causal diagonal or wholly before the
// window of every row of the block gives the same bits as running them
// (p = 0 and alpha = 1 there for every row that has seen a live key, and
// a product with an all-zero P adds exact zeros); the ``skip`` argument
// turns it off so a test can show that. A row with no live key at all
// (only when Sq >= Sk + window) would depend on the skip; the wrapper
// refuses such shapes.
//
// Float32 accuracy on TF32 tensor cores (3xTF32). A TF32 product keeps 10
// mantissa bits, about 1e-3 at yi-6b's shape, against the 2e-5 the port
// holds. So each operand x is split into hi = tf32(x) and lo = tf32(x -
// hi) (x - hi is exact in float32), and each product is hi.hi + hi.lo +
// lo.hi in float32 accumulators (lo.lo, ~2^-22 relative, is dropped):
// float32's accuracy at three TF32 products per float32 one. bfloat16
// inputs widen exactly into hi (lo = 0); q scale and P are float32 and
// have a lo part either way. One kernel body serves both types; the zero
// products of bfloat16's lo parts are run, not skipped.
//
// Bound on the card: at yi-6b's prefill shape (BH, S, D) = (128, 2048,
// 128), causal, q k^T and p v over the live half are 2 S (S + 1) D
// operations per bh, 137.5 GFLOP; three TF32 products each at 495 TFLOP/s
// (dense TF32 peak) is 0.833 ms. The softmax's 0.87 GFLOP at 67 TFLOP/s
// is 0.013 ms; q, o and the 16 unexpanded KV heads are 302 MB, 0.090 ms at
// 3.35 TB/s. So it is bound by tensor-core operations. The design:
//
// 1. The prepare pass (flash_attention_prepare_kv), once per call over the
//    unexpanded heads: K -> K_hi, K_lo (BHkv, Skp, D) and V -> V^T_hi,
//    V^T_lo (BHkv, D, Skp), float32, Skp = Sk rounded up to the 32-key
//    tile, keys past Sk written as zeros (so no tile crosses a head and
//    TMA needs no bounds). wgmma takes TF32 operands K-major only (no
//    transpose flag for .tf32), and V is the B operand of P.V with the key
//    dimension as K, hence V^T. Cost at the main shape: 33.5 MB read, 67 MB
//    written (about 0.03 ms at the HBM rate); the wrapper allocates the
//    scratch.
// 2. The main kernel: one block of 384 threads per (head bh, 128 query
//    rows), blocks ordered KV head by KV head (its K/V tiles stay in L2
//    while its kv_group query heads read them) and, within one, the
//    longest causal rows first. Warpgroups 0 and 1 are consumers, 64 rows
//    each, at 240 registers a thread; warpgroup 2 is the producer, down to
//    24 (setmaxnreg): one of its threads keeps the K/V tiles in flight
//    with TMA (2-D tensor maps, 128-byte swizzle, one box per 32-float
//    column atom of K, one per tile of V^T) into a ring of shared-memory
//    stages (2 at D = 128, 4 below). A stage's K half and V half each
//    complete on a "full" mbarrier by the bytes they expect and are
//    released on an "empty" one by the 256 consumer threads, K one tile
//    ahead of V, since a tile's K is done long before its V.
// 3. A consumer warpgroup scales its Q rows and splits them: Q_hi into
//    TF32 A fragments in registers, Q_lo into shared memory in the 128-byte
//    swizzled layout wgmma reads. Per key tile: S = Q_lo K_hi^T (A and B
//    from shared memory) + Q_hi K_lo^T + Q_hi K_hi^T (A from registers),
//    wgmma m64n32k8, 3 D / 8 instructions; the online softmax in float32
//    on the CUDA cores, on the accumulator fragments (a row's 4 threads
//    reduce by quad shuffles), O rescaled by alpha in registers; P split
//    into hi and lo and stored to shared memory (64 x 32 each, swizzled);
//    P_lo V_hi + P_hi V_lo + P_hi V_hi with wgmma m64nDk8 (A = P and B =
//    V^T from shared memory, 12 instructions) into a fresh accumulator,
//    added to O on the CUDA cores (see issue_pv: the tensor cores truncate
//    as they add, and O held on them across all tiles was off by up to
//    8e-6). Small terms go first, as CUTLASS orders 3xTF32. Tile it's P.V
//    and tile it + 1's scores are issued back to back, so the tensor cores
//    run the scores while the CUDA cores add P.V to O, and two warpgroups
//    per SM hide each other's softmax. Descriptor offsets are immediates
//    added inside each wgmma's asm, so the compiler holds one descriptor
//    per operand: with Q_hi (64), O (64), the fresh sum (64) and S (16)
//    live, the consumers sit at ~237 of their 240 registers, no spills.
// Shared memory at D = 128: Q_lo for 128 rows 64 KB, P hi + lo 32 KB, two
// 32-key stages of K hi + lo and V^T hi + lo at 64 KB each: 224 KB, one
// block per SM. Not yet: a persistent grid, TMA multicast of K/V across a
// cluster, and a native bfloat16 path.
//
// The two modes of attention_modes.cuh (the reference's kv_valid masks and
// attn_probs_bf16). kv_valid: the producer copies each K tile's packed
// mask word and its key tile beside it into its stage, and the softmax
// masks a dead key as a causally masked one. The blocks skip what the mask
// leaves dead, as the backward does: a block's keys are cut to its batch
// row's first and last live key (kv_bounds, read from the packed words),
// and the producer and both consumer warpgroups leave out, in the same
// order, the tiles whose word is 0 (see Work: the bits stay those of
// running them). A block left no tile (a batch row with no live key, or
// rows that all come before its first live key) loads nothing and waits on
// no barrier. A row that ends with m = -1e30 (no live key anywhere) is
// written kv_mean's mean of v over all Sk keys, with lse = +inf.
// probs_bf16 rounds where the reference rounds, the normalised softmax:
// an lse pass over the block's tiles runs the online max and sum alone,
// giving each row's lse; the second pass (pb_step) makes p = exp(s -
// lse), already normalised, into bf16(p) in registers, as the A operand
// of a bfloat16 wgmma (the scores' accumulator layout is that operand's,
// so P never goes through shared memory), times V^T = bf16(v) (the
// prepare pass's, in bfloat16, 64-byte rows): each product of two
// bfloat16 values is exact, summed in float32 into O on the tensor cores
// (no fresh sum a tile: see issue_pv_bf16), with no rescaling and no
// division at the end. The lse pass holds no O, so it keeps two score
// tiles in flight (lse_step: tile i + 1's scores run while tile i's exps
// do), takes Q_lo from registers as well as Q_hi (see scores_from), and
// its K tiles fill the
// stages' K halves and their idle V halves in turn (LseSlot: 4 tiles in
// flight at D = 128); its last step issues the second pass's first
// scores.
// The main kernel is built three times (template M): without the modes
// (the unmasked kernel's code, no word read: the kv_valid build runs an
// all-live mask a few percent slower than it on the H100), with kv_valid
// alone, and with probs_bf16 (kv_valid's words read there too, all ones
// without a mask).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "attention_modes.cuh"
#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kBq = 64;           // query rows per consumer warpgroup
constexpr int kGroups = 2;        // consumer warpgroups per block
constexpr int kBlockRows = kGroups * kBq;
constexpr int kBk = 32;           // keys per stage: one 128-byte row of V^T
constexpr int kConsumers = 128 * kGroups;
// and a producer warpgroup: setmaxnreg moves registers between whole
// warpgroups, and the producer's give the consumers their 240
constexpr int kThreads = kConsumers + 128;
constexpr int kAtom = 128;        // bytes in a swizzled row (32 floats)
constexpr float kNegInf = -1e30f;
// the main kernel's builds (template M): no mode, kv_valid alone,
// probs_bf16 (with or without kv_valid)
constexpr int kModeNone = 0, kModeMask = 1, kModePb = 2;

// Dynamic shared memory of one block, from a 1024-byte aligned base (the
// 128-byte swizzle repeats every 8 rows of 128 bytes): each consumer
// warpgroup's Q_lo as D / 32 column atoms of (64 rows x 128 B) (Q_hi lives
// in its registers); each one's P_hi, P_lo as (64 rows x 128 B); the
// stages, each K_hi, K_lo as D / 32 atoms of (32 rows x 128 B) and V^T_hi,
// V^T_lo as (D rows x 128 B); then the mbarriers, per stage a full and an
// empty one for its K half and for its V half, then per stage a full and
// an empty one for its V half holding a K tile (probs_bf16's lse pass).
template <int D>
struct Layout {
  static constexpr int kStages = D == 128 ? 2 : 4;
  static constexpr int kQBytes = kBq * D * 4;
  static constexpr int kKBytes = kBk * D * 4;
  static constexpr int kVBytes = D * kBk * 4;
  static constexpr int kStageBytes = 2 * kKBytes + 2 * kVBytes;
  static constexpr int kPBytes = kBq * kBk * 4;
  static constexpr int kP0 = kGroups * kQBytes;
  static constexpr int kStage0 = kP0 + kGroups * 2 * kPBytes;
  static constexpr int kBar = kStage0 + kStages * kStageBytes;
  static constexpr int kBarStride = 4 * 8;
  static constexpr int kVkBar = kBar + kStages * kBarStride;
  // with the modes, per stage the (packed kv_valid word, key tile) of the
  // K tile in its K half, then of the one in its V half (the lse pass);
  // then the block's plan (first tile, end tile, tiles run)
  static constexpr int kSlot = kVkBar + kStages * 2 * 8;
  static constexpr int kPlan = kSlot + 2 * 8 * kStages;
  static constexpr int kBytes = kPlan + 16 + 1024;  // + align
};

// ------------------------------------------------------------ loads, stores
// (the PTX helpers are in hopper.cuh)

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Four consecutive input elements as floats (bfloat16 widens exactly: its
// bits are the float's high half).
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}

// Two consecutive outputs, rounded to nearest even in bfloat16.
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// ---------------------------------------------------------- prepare pass

// Block (key tile, KV head): K's 32 rows split into K_hi, K_lo rows; V's
// tile through shared memory into V^T_hi, V^T_lo columns (with pb,
// probs_bf16, V^T_hi = bf16(v) alone, stored as bfloat16 at the start of
// V^T_hi's scratch). Keys at or past Sk are zeros.
template <typename T>
__global__ void __launch_bounds__(256)
    flash_attention_prepare_kv(const T* __restrict__ k,
                               const T* __restrict__ v,
                               float* __restrict__ khi,
                               float* __restrict__ klo,
                               float* __restrict__ vthi,
                               float* __restrict__ vtlo, int Sk, int Skp,
                               int D, int pb) {
  __shared__ float vs[kBk][128 + 1];
  const int h = blockIdx.y, k0 = blockIdx.x * kBk;
  for (int e = threadIdx.x; e < kBk * D; e += blockDim.x) {
    const int r = e / D, c = e % D, key = k0 + r;
    float kx = 0.0f, vx = 0.0f;
    if (key < Sk) {
      const int64_t g = ((int64_t)h * Sk + key) * D + c;
      kx = to_float(k[g]);
      vx = to_float(v[g]);
    }
    const float hi = to_tf32(kx);
    const int64_t w = ((int64_t)h * Skp + key) * D + c;
    khi[w] = hi;
    klo[w] = to_tf32(kx - hi);
    vs[r][c] = vx;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < kBk * D; e += blockDim.x) {
    const int c = e / kBk, j = e % kBk;
    const float x = vs[j][c];
    const int64_t w = ((int64_t)h * D + c) * Skp + k0 + j;
    if (pb) {
      reinterpret_cast<__nv_bfloat16*>(vthi)[w] = __float2bfloat16_rn(x);
    } else {
      const float hi = to_tf32(x);
      vthi[w] = hi;
      vtlo[w] = to_tf32(x - hi);
    }
  }
}

// Block (32 columns, KV head), kv_valid only: the output of a row with no
// live key, the mean of v over all Sk keys (each v rounded to bfloat16
// with pb, the weight 1 / Sk rounded as P is), in a fixed order: thread
// (c, y) sums keys y, y + 8, ..., then the 8 partial sums in turn.
template <typename T>
__global__ void __launch_bounds__(256)
    flash_attention_kv_mean(const T* __restrict__ v,
                            float* __restrict__ vmean, int Sk, int D,
                            int pb) {
  __shared__ float part[8][33];
  const int h = blockIdx.y, x = threadIdx.x % 32, y = threadIdx.x / 32;
  const int c = blockIdx.x * 32 + x;
  float sum = 0.0f;
  for (int j = y; j < Sk; j += 8) {
    const float e = to_float(v[((int64_t)h * Sk + j) * D + c]);
    sum += pb ? modes::bf16_round(e) : e;
  }
  part[y][x] = sum;
  __syncthreads();
  if (y == 0) {
    float total = 0.0f;
    for (int i = 0; i < 8; ++i) total += part[i][x];
    vmean[(int64_t)h * D + c] = total * modes::dead_weight(Sk, pb);
  }
}

// ------------------------------------------------------------ main kernel

// A block's work: head bh (KV head kvh), query rows q0 .. q0 + 127, key
// tiles kt_begin .. kt_end - 1 (the tiles some row of the block sees; both
// warpgroups run them all, and a tile that none of a warpgroup's rows sees
// leaves its bits alone), n_tiles of them run. Blocks go KV head by KV
// head (its K/V tiles stay in L2 while its kv_group query heads read
// them), query tiles longest first within one. With kv_valid (M, and
// ``bounds``, each batch row's first and last live key) the keys are also
// cut to the batch row's live span: a batch row with no live key, or rows
// that all come before its first live key under causal masking, leave the
// block no tile (n_tiles 0); and the tiles whose packed word is 0 are not
// run (live_tiles counts the others, next_tile walks them). The
// producer's first warp plans that before the roles split, into shared
// memory (Layout::kPlan), where the consumers' and the producer's
// registers are not yet scarce. Every tile
// left out adds exact zeros to the rows that have seen a live key (p =
// exp(-1e30 - m) = 0, alpha = 1) and junk to the others that the first
// live tile wipes out exactly (alpha = exp(-1e30 - m) = 0), or that
// kv_mean overwrites (a row with no live key): so the skips keep the bits,
// and skip = 0 (the wrapper's skip_tiles=False) shows it.
struct Work {
  int bh, kvh, q0, kt_begin, kt_end, n_tiles;
};

template <int M>
__device__ __forceinline__ Work block_work(int Sq, int Sk, int kv_group,
                                           int causal, int window, int skip,
                                           const int* bounds, int hq) {
  Work wk;
  const int nqt = (Sq + kBlockRows - 1) / kBlockRows;
  wk.kvh = blockIdx.x / (nqt * kv_group);
  const int rem = blockIdx.x % (nqt * kv_group);
  wk.bh = wk.kvh * kv_group + rem % kv_group;
  wk.q0 = (nqt - 1 - rem / kv_group) * kBlockRows;
  int lo = 0, hi = Sk;  // the keys to run
  if (skip) {
    if (causal) hi = min(hi, min(wk.q0 + kBlockRows, Sq));
    if (window > 0) lo = max(lo, wk.q0 - window + 1);
    if constexpr (M != kModeNone) {
      if (bounds != nullptr) {
        const int b = wk.bh / hq;
        lo = max(lo, bounds[2 * b]);
        hi = min(hi, bounds[2 * b + 1] + 1);
      }
    }
  }
  wk.kt_begin = lo / kBk;
  wk.kt_end = hi > lo ? (hi + kBk - 1) / kBk : wk.kt_begin;
  wk.n_tiles = wk.kt_end - wk.kt_begin;
  return wk;
}

// The tiles of [t0, t1) whose packed word is not 0, counted by every lane
// of the calling warp (32 words a round by a ballot).
__device__ __forceinline__ int live_tiles(const uint32_t* words, int t0,
                                          int t1) {
  const int lane = threadIdx.x % 32;
  int n = 0;
  for (int t = t0; t < t1; t += 32)
    n += __popc(__ballot_sync(0xffffffffu,
                              t + lane < t1 && words[t + lane] != 0u));
  return n;
}

// The first tile at or after t, before t1, that the block runs: with
// ``words`` (kv_valid and the skip) the next whose packed word is not 0.
__device__ __forceinline__ int next_tile(const uint32_t* words, int t,
                                         int t1) {
  if (words != nullptr)
    while (t < t1 && words[t] == 0u) ++t;
  return t;
}

// The stages' shared-memory addresses and barriers. K loads and V loads
// count on in their own sequences; probs_bf16's lse pass loads its K tiles
// into the K halves and the V halves in turn (LseSlot).
template <int D>
struct Stages {
  using L = Layout<D>;
  uint32_t base, bars;
  __device__ uint32_t k(int it) const {
    return base + L::kStage0 + (it % L::kStages) * L::kStageBytes;
  }
  __device__ uint32_t v(int it) const { return k(it) + 2 * L::kKBytes; }
  __device__ uint32_t k_full(int it) const {
    return bars + L::kBarStride * (it % L::kStages);
  }
  __device__ uint32_t k_empty(int it) const { return k_full(it) + 8; }
  __device__ uint32_t v_full(int it) const { return k_full(it) + 16; }
  __device__ uint32_t v_empty(int it) const { return k_full(it) + 24; }
  __device__ int parity(int it) const { return (it / L::kStages) & 1; }
  // K load it's (word, key tile)
  __device__ uint32_t slot(int it) const {
    return base + L::kSlot + 8 * (it % L::kStages);
  }
};

// Where probs_bf16's lse pass finds its tile i: tiles go to the K halves
// of stages 0 .. S - 1, then to their V halves (idle until the second
// pass), and round again, so 2 S K tiles are in flight (4 at D = 128). A
// K half's use is K load (i / 2S) S + i % 2S of the K sequence, which the
// second pass's K loads continue (``k_loads``); a V half has barriers of
// its own for it (Layout::kVkBar).
template <int D>
struct LseSlot {
  using L = Layout<D>;
  static constexpr int kS = L::kStages;
  uint32_t tile, full, slot;
  int parity;
  __device__ LseSlot(uint32_t base, uint32_t bars, int i) {
    const int u = i % (2 * kS), s = u % kS;
    const bool vh = u >= kS;
    tile = base + L::kStage0 + s * L::kStageBytes + (vh ? 2 * L::kKBytes : 0);
    full = vh ? base + L::kVkBar + 16 * s : bars + L::kBarStride * s;
    slot = base + L::kSlot + 8 * s + (vh ? 8 * kS : 0);
    parity = (i / (2 * kS)) & 1;
  }
  __device__ uint32_t empty() const { return full + 8; }
  // the K halves' loads among the pass's first n tiles
  __device__ static int k_loads(int n) {
    return n / (2 * kS) * kS + min(n % (2 * kS), kS);
  }
};

__device__ __forceinline__ uint32_t ld_shared_u32(uint32_t addr) {
  uint32_t x;
  asm volatile("ld.shared.u32 %0, [%1];" : "=r"(x) : "r"(addr) : "memory");
  return x;
}
__device__ __forceinline__ void st_shared_u32(uint32_t addr, uint32_t x) {
  asm volatile("st.shared.u32 [%0], %1;" ::"r"(addr), "r"(x) : "memory");
}
__device__ __forceinline__ void st_shared_v2(uint32_t addr, uint32_t a,
                                             uint32_t b) {
  asm volatile("st.shared.v2.u32 [%0], {%1, %2};" ::"r"(addr), "r"(a),
               "r"(b)
               : "memory");
}
__device__ __forceinline__ uint2 ld_shared_v2(uint32_t addr) {
  uint2 x;
  asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];"
               : "=r"(x.x), "=r"(x.y)
               : "r"(addr)
               : "memory");
  return x;
}

// The k steps of Q_lo that probs_bf16's lse pass takes from registers:
// all of them (the other passes take Q_lo from shared memory).
template <int D>
constexpr int kLseQlSteps = D / 8;

// What a consumer thread needs for the mask: its first row (the second is
// row0 + 8), its key pair t, and the call's bounds.
struct Tile {
  int r0, row0, t, Sk, causal, window;  // r0: the warpgroup's first row
};

// A value the compiler must recompute where it is used, so that it holds
// no loop-invariant descriptor in a register across the loop (the
// consumers run at the edge of their 240 registers).
__device__ __forceinline__ uint32_t opaque(uint32_t x) {
  asm volatile("mov.b32 %0, %0;" : "+r"(x));
  return x;
}

// Byte offset, in 16-byte descriptor units, of k step kk (8 floats =
// 32 bytes) in a K-major operand of ``rows`` rows stored as 32-float column
// atoms of (rows x 128 B).
__host__ __device__ constexpr int k_step(int kk, int rows) {
  return ((kk / 4) * rows * kAtom + (kk % 4) * 32) / 16;
}

// The k steps KK.. of S = Q_lo K_hi^T (both from shared memory) + Q_hi
// K_lo^T + Q_hi K_hi^T (Q_hi as TF32 A fragments in registers, qh[4 kk ..]
// for k step kk). With R > 0, Q_lo's first R k steps come from registers
// too (ql, laid out as qh): the same products in the same order, so that
// those read only K from shared memory (an SS product of N = 32 reads
// more bytes a step than shared memory gives the tensor cores).
// probs_bf16's lse pass, which holds no O, has room for all of them
// (kLseQlSteps).
template <int D, int R, int KK>
__device__ __forceinline__ void scores_from(float* sc, const uint32_t* qh,
                                            const uint32_t* ql, uint64_t qlo,
                                            uint64_t khi, uint64_t klo) {
  if constexpr (KK < R) {
    wgmma_rs32<k_step(KK, kBk)>(sc, ql + 4 * KK, khi);
    scores_from<D, R, KK + 1>(sc, qh, ql, qlo, khi, klo);
  } else if constexpr (KK < D / 8) {
    WgmmaSS<32, k_step(KK, kBq), k_step(KK, kBk)>::run(sc, qlo, khi);
    scores_from<D, R, KK + 1>(sc, qh, ql, qlo, khi, klo);
  } else if constexpr (KK < 2 * (D / 8)) {
    constexpr int kk = KK - D / 8;
    wgmma_rs32<k_step(kk, kBk)>(sc, qh + 4 * kk, klo);
    scores_from<D, R, KK + 1>(sc, qh, ql, qlo, khi, klo);
  } else if constexpr (KK < 3 * (D / 8)) {
    constexpr int kk = KK - 2 * (D / 8);
    wgmma_rs32<k_step(kk, kBk)>(sc, qh + 4 * kk, khi);
    scores_from<D, R, KK + 1>(sc, qh, ql, qlo, khi, klo);
  }
}

// S into sc (zeroed here), committed as one group; small terms first, as
// CUTLASS orders 3xTF32.
template <int D, int R = 0>
__device__ __forceinline__ void issue_scores(float* sc, const uint32_t* qh,
                                             uint32_t qlo, uint32_t k,
                                             const uint32_t* ql = nullptr) {
  qlo = opaque(qlo);
  k = opaque(k);
#pragma unroll
  for (int i = 0; i < 16; ++i) sc[i] = 0.0f;
  fence_regs<16>(sc);
  wgmma_fence();
  scores_from<D, R, 0>(sc, qh, ql, sw128_desc(qlo), sw128_desc(k),
                       sw128_desc(k + Layout<D>::kKBytes));
  wgmma_commit();
}

// The k steps J.. of P.V: P_lo V_hi (J < 4), P_hi V_lo, P_hi V_hi (J >= 8)
// (the 32 keys are one atom: k step j is 32 bytes, 2 descriptor units,
// into it).
template <int D, int J>
__device__ __forceinline__ void pv_from(float* tmp, uint64_t ph,
                                        uint64_t pl, uint64_t vh,
                                        uint64_t vl) {
  if constexpr (J < 12) {
    constexpr int j = 2 * (J % 4);
    WgmmaSS<D, j, j>::run(tmp, J < 4 ? pl : ph, J >= 4 && J < 8 ? vl : vh);
    pv_from<D, J + 1>(tmp, ph, pl, vh, vl);
  }
}

// One tile's P.V in a fresh accumulator: tmp = P_lo V_hi + P_hi V_lo +
// P_hi V_hi (P from shared memory at p, P_lo at p + kPBytes; B = V^T);
// committed as one group. The tensor cores add with truncation, so a sum
// held on them across every tile would lose up to an ulp of O per product
// step (768 steps a row at S = 2048: errors up to 8e-6); a fresh sum per
// tile, added to O on the CUDA cores, keeps that to the 12 steps of one
// tile.
template <int D>
__device__ __forceinline__ void issue_pv(float* tmp, uint32_t p,
                                         uint32_t v) {
  p = opaque(p);
  v = opaque(v);
  const uint32_t plo = p + Layout<D>::kPBytes;
  const uint32_t vlo = v + Layout<D>::kVBytes;
#pragma unroll
  for (int i = 0; i < D / 2; ++i) tmp[i] = 0.0f;
  fence_regs<D / 2>(tmp);
  wgmma_fence();
  pv_from<D, 0>(tmp, sw128_desc(p), sw128_desc(plo), sw128_desc(v),
                sw128_desc(vlo));
  wgmma_commit();
}

// probs_bf16's P.V added to O on the tensor cores: P as bfloat16 A
// fragments in registers (pa, from pack_p), V^T_hi = bf16(v) as bfloat16
// (D rows x 32 keys, 64-byte rows) in shared memory at v; two bfloat16
// products of 16 keys, each exact (bfloat16 values), summed in float32
// into acc. Committed as one group. O held on the tensor cores across
// the tiles loses up to an ulp a step (issue_pv), ~1e-6 over a 2,048-key
// row: far inside the mode's own rounding of p and v (2^-9 of each), and
// it leaves no fresh sum to hold in registers.
template <int D>
__device__ __forceinline__ void issue_pv_bf16(float* acc, const uint32_t* pa,
                                              uint32_t v) {
  const uint64_t vd = sw64_desc(opaque(v));
  fence_regs<D / 2>(acc);
  wgmma_fence();
  WgmmaRsBf16<D, 0>::run(acc, pa, vd);
  WgmmaRsBf16<D, 2>::run(acc, pa + 4, vd);  // keys 16.., 32 bytes in
  wgmma_commit();
}

// exp(x) as 2^(x log2(e)) on the special-function unit: ~2 ulp, against
// ~1 ulp for expf at several times the instructions on the critical path.
// exp(-1e30 ...) is still exactly 0 and exp(0) exactly 1.
__device__ __forceinline__ float fast_exp(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}

// The online softmax of one tile of scores at keys key0.., in place in sc
// (sc[4 j + 2 i + e] is row row0 + 8 i, key key0 + 8 j + 2 t + e; a row's
// 4 threads are one quad): masked scores (and keys whose bit in the tile's
// kv_valid word is clear) to -1e30, m and l updated, O (acc[4 c + 2 i +
// e], row row0 + 8 i) rescaled by alpha (unless !Rescale: probs_bf16's
// first pass, which keeps no O), sc left holding p.
template <int D, bool M, bool Rescale = true>
__device__ __forceinline__ void softmax_step(float* sc, float* m, float* l,
                                             float* acc, int key0,
                                             uint32_t word, const Tile& tl) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qpos = tl.row0 + 8 * i;
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kpos = key0 + 8 * j + 2 * tl.t + e;
        bool live = kpos < tl.Sk && (!tl.causal || kpos <= qpos) &&
                    (tl.window <= 0 || kpos > qpos - tl.window);
        if constexpr (M)
          live = live && ((word >> (8 * j + 2 * tl.t + e)) & 1u);
        float& x = sc[4 * j + 2 * i + e];
        if (!live) x = kNegInf;
        mx = fmaxf(mx, x);
      }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[i], mx);
    const float alpha = fast_exp(m[i] - m_new);
    float sum = 0.0f;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = sc[4 * j + 2 * i + e];
        x = key0 + 8 * j + 2 * tl.t + e < tl.Sk ? fast_exp(x - m_new) : 0.0f;
        sum += x;
      }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    l[i] = alpha * l[i] + sum;
    m[i] = m_new;
    if constexpr (Rescale) {
#pragma unroll
      for (int c = 0; c < D / 8; ++c) {
        acc[4 * c + 2 * i] *= alpha;
        acc[4 * c + 2 * i + 1] *= alpha;
      }
    }
  }
}

// probs_bf16's second pass over one tile of scores, in place in sc (laid
// out as in softmax_step): p = exp(s - lse) on the live keys, the
// normalised softmax the reference rounds, and 0 on the others.
__device__ __forceinline__ void probs_step(float* sc, const float* lse,
                                           int key0, uint32_t word,
                                           const Tile& tl) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qpos = tl.row0 + 8 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kpos = key0 + 8 * j + 2 * tl.t + e;
        const bool live =
            kpos < tl.Sk && (!tl.causal || kpos <= qpos) &&
            (tl.window <= 0 || kpos > qpos - tl.window) &&
            ((word >> (8 * j + 2 * tl.t + e)) & 1u);
        float& x = sc[4 * j + 2 * i + e];
        x = live ? fast_exp(x - lse[i]) : 0.0f;
      }
  }
}

__device__ __forceinline__ void st_shared2(uint32_t addr, float a, float b) {
  asm volatile("st.shared.v2.f32 [%0], {%1, %2};" ::"r"(addr), "f"(a),
               "f"(b)
               : "memory");
}

// P (in sc) split into hi and lo and stored for wgmma: (64 rows x 32
// keys) in one 128-byte swizzled atom each (row r's 16-byte chunk c at
// c ^ (r % 8)); this thread's rows are lr and lr + 8 of the warpgroup's 64,
// keys 8 j + 2 t and + 1 side by side. The caller fences and syncs the
// warpgroup before the product reads them.
__device__ __forceinline__ void store_p(const float* sc, uint32_t p, int lr,
                                        int t) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = lr + 8 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float x0 = sc[4 * j + 2 * i], x1 = sc[4 * j + 2 * i + 1];
      const float h0 = to_tf32(x0), h1 = to_tf32(x1);
      const int off = r * kAtom + (((2 * j + t / 2) ^ (r % 8)) << 4) +
                      8 * (t % 2);
      st_shared2(p + off, h0, h1);
      st_shared2(p + kBq * kBk * 4 + off, to_tf32(x0 - h0),
                 to_tf32(x1 - h1));
    }
  }
}

// Make this warpgroup's shared-memory stores visible to wgmma (the async
// proxy), once all 4 warps made them (named barrier 1 + w over its 128
// threads).
__device__ __forceinline__ void smem_ready(int w) {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("bar.sync %0, 128;" ::"r"(1 + w) : "memory");
}

// Tile it, whose P is in shared memory (O already rescaled for it), with
// nothing in flight on entry or exit: issue tile it's P.V into a fresh
// sum and (Next) tile it + 1's scores behind it; once P.V is done, release
// tile it's V half and add the sum to O; once the scores are done,
// read tile it + 1's kv_valid word and key tile (with kv_valid: the tile
// skip leaves gaps) and release its K half (which frees its slot too), run
// its softmax, rescale O by its alpha and store its P. While one
// warpgroup runs its softmax, the other's products keep the tensor cores
// busy. Next is a template argument, so every wait is static and ptxas
// keeps the products asynchronous. Tile it's K half is K load it, its V
// half V load it. (probs_bf16's second pass is pb_step.)
template <int D, bool Next, int M>
__device__ __forceinline__ void tile_step(int it, int kt_begin,
                                          const Stages<D>& st,
                                          const uint32_t* qh, uint32_t qlo,
                                          uint32_t p, int w, const Tile& tl,
                                          float* acc, float* m, float* l) {
  float tmp[D / 2], sc[16];
  const int kn = it + 1;  // tile it + 1's K load
  mbar_wait(st.v_full(it), st.parity(it));
  issue_pv<D>(tmp, p, st.v(it));
  if (Next) {
    mbar_wait(st.k_full(kn), st.parity(kn));
    issue_scores<D>(sc, qh, qlo, st.k(kn));
    wgmma_wait<1>();
  } else {
    wgmma_wait<0>();
  }
  fence_regs<D / 2>(tmp);
  mbar_arrive(st.v_empty(it));
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] += tmp[i];
  if (Next) {
    wgmma_wait<0>();
    fence_regs<16>(sc);
    uint32_t word = ~0u;
    int key0 = (kt_begin + it + 1) * kBk;
    if constexpr (M != kModeNone) {
      const uint2 ws = ld_shared_v2(st.slot(kn));
      word = ws.x;
      key0 = ws.y * kBk;
    }
    mbar_arrive(st.k_empty(kn));
    softmax_step<D, M != kModeNone>(sc, m, l, acc, key0, word, tl);
    store_p(sc, p, tl.row0 - tl.r0, tl.t);
    smem_ready(w);
  }
}

// probs_bf16's P of one tile (in sc, laid out as softmax_step's) as the A
// fragments of issue_pv_bf16: the score accumulator's layout is the
// bfloat16 A operand's, so register i holds bf16(sc[2 i]), bf16(sc[2 i +
// 1]) (k step i / 4: keys 16 (i / 4) + 2 t, + 1 and + 8, rows row0 and
// row0 + 8), rounded to nearest even as the reference rounds p.
__device__ __forceinline__ void pack_p(const float* sc, uint32_t* pa) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(sc[2 * i], sc[2 * i + 1]);
    pa[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
}

// probs_bf16's second pass, tile it (K load ko + it, V load it), its P in
// registers (pa), with nothing in flight on entry or exit: issue tile
// it's P.V into O (issue_pv_bf16; no rescaling: lse is fixed) and (Next)
// tile it + 1's scores behind it; once P.V is done, release tile it's V
// half; once the scores are done, release tile it + 1's K half and make
// its normalised p into pa. P never goes through shared memory, so no
// warpgroup barrier either.
template <int D, bool Next>
__device__ __forceinline__ void pb_step(int it, int ko, const Stages<D>& st,
                                        const uint32_t* qh, uint32_t qlo,
                                        const Tile& tl, float* acc,
                                        const float* lse, uint32_t* pa) {
  float sc[16];
  const int kn = it + 1 + ko;  // tile it + 1's K load
  mbar_wait(st.v_full(it), st.parity(it));
  issue_pv_bf16<D>(acc, pa, st.v(it));
  if (Next) {
    mbar_wait(st.k_full(kn), st.parity(kn));
    issue_scores<D>(sc, qh, qlo, st.k(kn));
    wgmma_wait<1>();
  } else {
    wgmma_wait<0>();
  }
  fence_regs<D / 2>(acc);
  fence_regs<8>(pa);
  mbar_arrive(st.v_empty(it));
  if (Next) {
    wgmma_wait<0>();
    fence_regs<16>(sc);
    const uint2 ws = ld_shared_v2(st.slot(kn));
    mbar_arrive(st.k_empty(kn));
    probs_step(sc, lse, ws.y * kBk, ws.x, tl);
    pack_p(sc, pa);
  }
}

// probs_bf16's lse pass, tile i (LseSlot i), its scores in flight in cur:
// issue the next scores into nxt behind them (the pass's tile i + 1, or
// with Last the second pass's first tile, K load ko), wait for cur, read
// its word and key tile and release its slot, and run the online max and
// sum on it (no O to rescale). Two score tiles in flight: the tensor
// cores run tile i + 1's while the CUDA cores run tile i's exps. Q_lo's
// first kLseQlSteps k steps from registers.
template <int D, bool Last>
__device__ __forceinline__ void lse_step(int i, int ko, const Stages<D>& st,
                                         const uint32_t* ql,
                                         const uint32_t* qh, uint32_t qlo,
                                         const Tile& tl, float* cur,
                                         float* nxt, float* m, float* l) {
  if constexpr (Last) {
    mbar_wait(st.k_full(ko), st.parity(ko));
    issue_scores<D, kLseQlSteps<D>>(nxt, qh, qlo, st.k(ko), ql);
  } else {
    const LseSlot<D> ns(st.base, st.bars, i + 1);
    mbar_wait(ns.full, ns.parity);
    issue_scores<D, kLseQlSteps<D>>(nxt, qh, qlo, ns.tile, ql);
  }
  wgmma_wait<1>();
  fence_regs<16>(cur);
  const LseSlot<D> cs(st.base, st.bars, i);
  const uint2 ws = ld_shared_v2(cs.slot);
  mbar_arrive(cs.empty());
  softmax_step<D, true, false>(cur, m, l, nullptr, ws.y * kBk, ws.x, tl);
}

// The producer (one thread): every box, K one tile ahead of V (K_0, K_1,
// V_0, K_2, V_1, ...), since a tile's K half is free once its scores are
// done and its V half only after P.V; with each K half, with the modes,
// the tile's packed kv_valid word from ``words`` (the block's batch row of
// them, null without a mask: all ones) and its key tile, stored before
// the arrive that releases them. With kv_valid and the skip (``skip``
// given) the tiles whose word is 0 are left out, as the consumers leave
// them out. With probs_bf16 every tile's K half goes first, alone, for the
// lse pass (LseSlot: into the K halves and the idle V halves in turn),
// and a V half is V^T_hi alone; a stage's first V load of the second pass
// waits for the release of the K tile its V half held last.
template <int D, int M>
__device__ __forceinline__ void produce(const CUtensorMap* tm_khi,
                                        const CUtensorMap* tm_klo,
                                        const CUtensorMap* tm_vthi,
                                        const CUtensorMap* tm_vtlo,
                                        const Work& wk, int Skp,
                                        const uint32_t* words,
                                        const uint32_t* skip) {
  using L = Layout<D>;
  constexpr int kS = L::kStages;
  constexpr bool kPb = M == kModePb;
  const uint32_t base = smem_base(), bars = base + L::kBar;
  // the n-th load of a K tile into a K half (vh = 0) or, in the lse pass,
  // a V half (vh = 1): tile kt
  auto load_k = [&](int n, int kt, int vh) {
    const int s = n % kS;
    const uint32_t full = vh ? base + L::kVkBar + 16 * s
                             : bars + L::kBarStride * s;
    if (n >= kS) mbar_wait(full + 8, ((n / kS) - 1) & 1);
    if constexpr (M != kModeNone)
      st_shared_v2(base + L::kSlot + 8 * s + 8 * kS * vh,
                   words ? words[kt] : ~0u, kt);
    mbar_expect_tx(full, 2 * L::kKBytes);
    const int row = wk.kvh * Skp + kt * kBk;
    const uint32_t st = base + L::kStage0 + s * L::kStageBytes +
                        2 * L::kKBytes * vh;
#pragma unroll
    for (int a = 0; a < D / 32; ++a) {
      tma_load(st + a * kBk * kAtom, tm_khi, full, 32 * a, row);
      tma_load(st + L::kKBytes + a * kBk * kAtom, tm_klo, full, 32 * a,
               row);
    }
  };
  int nk = 0, nv = 0;  // K tiles loaded into K halves, into V halves
  if constexpr (kPb) {
    for (int kt = next_tile(skip, wk.kt_begin, wk.kt_end); kt < wk.kt_end;
         kt = next_tile(skip, kt + 1, wk.kt_end)) {
      if ((nk + nv) % (2 * kS) < kS)
        load_k(nk++, kt, 0);
      else
        load_k(nv++, kt, 1);
    }
  }
  int kt = next_tile(skip, wk.kt_begin, wk.kt_end), vt = kt;
  for (int it = -1; vt < wk.kt_end; ++it) {  // K of tile it + 1, V of it
    if (kt < wk.kt_end) {
      load_k(nk++, kt, 0);
      kt = next_tile(skip, kt + 1, wk.kt_end);
    }
    if (it >= 0) {
      const int s = it % kS;
      const uint32_t full = bars + L::kBarStride * s + 16;
      if (it >= kS) {
        mbar_wait(full + 8, ((it / kS) - 1) & 1);
      } else if (kPb) {
        // the lse pass's loads into this V half
        const int uses = (nv + kS - 1 - s) / kS;
        if (uses > 0)
          mbar_wait(base + L::kVkBar + 16 * s + 8, (uses - 1) & 1);
      }
      mbar_expect_tx(full, kPb ? D * kBk * 2 : 2 * L::kVBytes);
      const uint32_t st =
          base + L::kStage0 + s * L::kStageBytes + 2 * L::kKBytes;
      tma_load(st, tm_vthi, full, vt * kBk, wk.kvh * D);
      if constexpr (!kPb)
        tma_load(st + L::kVBytes, tm_vtlo, full, vt * kBk, wk.kvh * D);
      vt = next_tile(skip, vt + 1, wk.kt_end);
    }
  }
}

// A consumer warpgroup: rows q0 + 64 w .. of head bh.
template <int D, typename T, int M>
__device__ __forceinline__ void consume(const T* __restrict__ q,
                                        T* __restrict__ o,
                                        float* __restrict__ lse,
                                        const float* __restrict__ vmean,
                                        int Sq, int Sk, int kv_group,
                                        int causal, int window, float scale,
                                        int skip) {
  using L = Layout<D>;
  const Work wk =
      block_work<M>(Sq, Sk, kv_group, causal, window, skip, nullptr, 0);
  const int bh = wk.bh, q0 = wk.q0, kt_begin = wk.kt_begin;
  const uint32_t base = smem_base(), bars = base + L::kBar;
  const int n_tiles = M != kModeNone ? (int)ld_shared_u32(base + L::kPlan + 8)
                                     : wk.n_tiles;
  constexpr bool kPb = M == kModePb;
  // Q scaled and split: Q_lo into shared memory in the swizzled layout
  // (16-byte chunk c of row r at chunk c ^ (r % 8), as TMA's SWIZZLE_128B
  // puts it), Q_hi straight into this thread's A fragments (with
  // probs_bf16 Q_lo too, for the lse pass). A block left no tile (kv_valid)
  // loads no Q.
  const int tid = threadIdx.x, w = tid / 128, wt = tid % 128;
  const int lane = tid % 32, g = lane / 4, t = lane % 4;
  const int r0 = q0 + kBq * w;
  const int64_t qoff = ((int64_t)bh * Sq + r0) * D;
  const uint32_t qlo = base + w * L::kQBytes;
  const Tile tile{r0, r0 + 16 * (wt / 32) + g, t, Sk, causal, window};
  uint32_t qh[D / 2];  // k step kk: (row0, 8 kk + t), (row0 + 8, ..), + 4
  uint32_t ql[kPb && kLseQlSteps<D> ? 4 * kLseQlSteps<D> : 1];
  if (M == kModeNone || n_tiles > 0) {
    for (int e = wt; e < kBq * D / 4; e += 128) {
      const int r = e / (D / 4), c4 = e % (D / 4);
      float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (r0 + r < Sq) {
        x = load4(q + qoff + (int64_t)r * D + 4 * c4);
        x.x *= scale;
        x.y *= scale;
        x.z *= scale;
        x.w *= scale;
      }
      const float4 lo = make_float4(
          to_tf32(x.x - to_tf32(x.x)), to_tf32(x.y - to_tf32(x.y)),
          to_tf32(x.z - to_tf32(x.z)), to_tf32(x.w - to_tf32(x.w)));
      const int off = (c4 / 8) * kBq * kAtom + r * kAtom +
                      (((c4 % 8) ^ (r % 8)) << 4);
      asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};" ::"r"(
                       qlo + off),
                   "f"(lo.x), "f"(lo.y), "f"(lo.z), "f"(lo.w)
                   : "memory");
    }
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = tile.row0 + 8 * (r % 2);
        const float x =
            row < Sq ? to_float(q[((int64_t)bh * Sq + row) * D + 8 * kk + t +
                                  4 * (r / 2)]) * scale
                     : 0.0f;
        qh[4 * kk + r] = __float_as_uint(to_tf32(x));
        if constexpr (kPb)
          if (kk < kLseQlSteps<D>)
            ql[4 * kk + r] = __float_as_uint(to_tf32(x - to_tf32(x)));
      }
    smem_ready(w);
  }

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
  const Stages<D> st{base, bars};
  const uint32_t p = base + L::kP0 + w * 2 * L::kPBytes;
  // O, zeroed where the tiles begin (a block left no tile reads none of
  // it: every row of it is written from kv_mean)
  float acc[D / 2];
  if constexpr (kPb) {
    // the lse pass: each row's max and sum over all its tiles, two score
    // tiles in flight, so that the second pass (K loads ko ..) normalises
    // p before rounding it; its last step issues the second pass's first
    // scores into the array it has just read
    const int ko = LseSlot<D>::k_loads(n_tiles);
    float s0[16], s1[16], row_lse[2];
    uint32_t pa[8];  // a tile's P, bfloat16 pairs
    // the second pass's first tile, its scores in sc
    auto first = [&](float* sc) {
#pragma unroll
      for (int r = 0; r < 2; ++r) row_lse[r] = m[r] + logf(l[r]);
#pragma unroll
      for (int r = 0; r < D / 2; ++r) acc[r] = 0.0f;
      wgmma_wait<0>();
      fence_regs<16>(sc);
      const uint2 ws = ld_shared_v2(st.slot(ko));
      mbar_arrive(st.k_empty(ko));
      probs_step(sc, row_lse, ws.y * kBk, ws.x, tile);
      pack_p(sc, pa);
    };
    if (n_tiles > 0) {
      {
        const LseSlot<D> tile0(base, bars, 0);
        mbar_wait(tile0.full, tile0.parity);
        issue_scores<D, kLseQlSteps<D>>(s0, qh, qlo, tile0.tile, ql);
      }
      int i = 0;
      for (; i + 2 < n_tiles; i += 2) {
        lse_step<D, false>(i, ko, st, ql, qh, qlo, tile, s0, s1, m, l);
        lse_step<D, false>(i + 1, ko, st, ql, qh, qlo, tile, s1, s0, m, l);
      }
      if (i + 2 == n_tiles) {
        lse_step<D, false>(i, ko, st, ql, qh, qlo, tile, s0, s1, m, l);
        lse_step<D, true>(i + 1, ko, st, ql, qh, qlo, tile, s1, s0, m, l);
        first(s0);
      } else {
        lse_step<D, true>(i, ko, st, ql, qh, qlo, tile, s0, s1, m, l);
        first(s1);
      }
      for (int it = 0; it + 1 < n_tiles; ++it)
        pb_step<D, true>(it, ko, st, qh, qlo, tile, acc, row_lse, pa);
      pb_step<D, false>(n_tiles - 1, ko, st, qh, qlo, tile, acc, row_lse,
                        pa);
    }
  } else if (M == kModeNone || n_tiles > 0) {
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
    {
      float sc[16];
      mbar_wait(st.k_full(0), st.parity(0));
      issue_scores<D>(sc, qh, qlo, st.k(0));
      wgmma_wait<0>();
      fence_regs<16>(sc);
      uint32_t word = ~0u;
      int key0 = kt_begin * kBk;
      if constexpr (M != kModeNone) {
        const uint2 ws = ld_shared_v2(st.slot(0));
        word = ws.x;
        key0 = ws.y * kBk;
      }
      mbar_arrive(st.k_empty(0));
      softmax_step<D, M != kModeNone>(sc, m, l, acc, key0, word, tile);
      store_p(sc, p, tile.row0 - r0, t);
      smem_ready(w);
    }
    for (int it = 0; it + 1 < n_tiles; ++it)
      tile_step<D, true, M>(it, kt_begin, st, qh, qlo, p, w, tile, acc, m,
                            l);
    tile_step<D, false, M>(n_tiles - 1, kt_begin, st, qh, qlo, p, w, tile,
                           acc, m, l);
  }

  // acc[4 c + 2 i + e] is row row0 + 8 i, column 8 c + 2 t + e (with
  // probs_bf16 already normalised); lse (when asked for) is the row's m +
  // log(l), for the backward kernel. With kv_valid (vmean given) a row
  // whose m is still -1e30 saw no live key: it gets the mean of v over all
  // keys and lse = +inf.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = tile.row0 + 8 * i;
    if (r < Sq) {
      const bool dead = M != kModeNone && vmean != nullptr &&
                        m[i] == kNegInf;
      if (lse != nullptr && t == 0)
        lse[(int64_t)bh * Sq + r] =
            dead ? __int_as_float(0x7f800000) : m[i] + logf(l[i]);
      const float den = kPb ? 1.0f : fmaxf(l[i], 1e-30f);
      T* out = o + ((int64_t)bh * Sq + r) * D + 2 * t;
      if (dead) {
        const float* mean = vmean + (int64_t)(bh / kv_group) * D + 2 * t;
#pragma unroll
        for (int c = 0; c < D / 8; ++c)
          store2(out + 8 * c, mean[8 * c], mean[8 * c + 1]);
      } else {
#pragma unroll
        for (int c = 0; c < D / 8; ++c)
          store2(out + 8 * c, acc[4 * c + 2 * i] / den,
                 acc[4 * c + 2 * i + 1] / den);
      }
    }
  }
}

template <int D, typename T, int M>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attention_kernel(const __grid_constant__ CUtensorMap tm_khi,
                           const __grid_constant__ CUtensorMap tm_klo,
                           const __grid_constant__ CUtensorMap tm_vthi,
                           const __grid_constant__ CUtensorMap tm_vtlo,
                           const T* __restrict__ q, T* __restrict__ o,
                           float* __restrict__ lse,
                           const uint32_t* __restrict__ bits,
                           const int* __restrict__ bounds,
                           const float* __restrict__ vmean, int Sq, int Sk,
                           int Skp, int kv_group, int hq, int causal,
                           int window, float scale, int skip) {
  using L = Layout<D>;
  constexpr int kS = L::kStages;
  if (threadIdx.x == 0) {
    const uint32_t bars = smem_base() + L::kBar;
    // full (one arrive + the bytes) and empty (the consumers) pairs
    for (int b = 0; b < 3 * kS; ++b) {
      mbar_init(bars + 16 * b, 1);
      mbar_init(bars + 16 * b + 8, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if constexpr (M != kModeNone) {
    // the block's plan (Work), by the producer's first warp
    if (threadIdx.x / 32 == kConsumers / 32) {
      const Work wk = block_work<M>(Sq, Sk, kv_group, causal, window, skip,
                                    bounds, hq);
      int n = wk.n_tiles;
      if (skip && bits != nullptr)
        n = live_tiles(bits + (int64_t)(wk.bh / hq) * modes::mask_words(Sk),
                       wk.kt_begin, wk.kt_end);
      if (threadIdx.x == kConsumers) {
        st_shared_v2(smem_base() + L::kPlan, wk.kt_begin, wk.kt_end);
        st_shared_u32(smem_base() + L::kPlan + 8, n);
      }
    }
  }
  __syncthreads();

  // Each role computes what it needs after setmaxnreg: values carried
  // across it cost the consumers registers.
  if (threadIdx.x >= kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    if (threadIdx.x == kConsumers) {
      Work wk =
          block_work<M>(Sq, Sk, kv_group, causal, window, skip, nullptr, 0);
      if constexpr (M != kModeNone) {
        wk.kt_begin = (int)ld_shared_u32(smem_base() + L::kPlan);
        wk.kt_end = (int)ld_shared_u32(smem_base() + L::kPlan + 4);
      }
      const uint32_t* words =
          M != kModeNone && bits != nullptr
              ? bits + (int64_t)(wk.bh / hq) * modes::mask_words(Sk)
              : nullptr;
      produce<D, M>(&tm_khi, &tm_klo, &tm_vthi, &tm_vtlo, wk, Skp, words,
                    skip ? words : nullptr);
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");
    consume<D, T, M>(q, o, lse, vmean, Sq, Sk, kv_group, causal, window,
                     scale, skip);
  }
}

// ------------------------------------------------------------------ host

// The scratch after the split K and V: with kv_valid, kv_mean's (BHkv, D)
// float32 means, then the (B, ceil(Sk / 32)) packed mask words, then each
// batch row's first and last live key (2 ints, kv_bounds).
template <int D, typename T>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           float* work, const uint8_t* kv, int bh, int kv_group, int sq,
           int sk, int hq, int causal, int window, float scale, int skip,
           int mds, cudaStream_t stream) {
  const int bhkv = bh / kv_group;
  const int skp = (sk + kBk - 1) / kBk * kBk;
  const int64_t part = (int64_t)bhkv * skp * D;
  float *khi = work, *klo = work + part, *vthi = work + 2 * part,
        *vtlo = work + 3 * part;
  const int pb = (mds & modes::kProbsBf16) ? 1 : 0;
  float* vmean = nullptr;
  uint32_t* bits = nullptr;
  int* bounds = nullptr;
  cudaError_t err;
  if (kv != nullptr) {
    vmean = work + 4 * part;
    bits = reinterpret_cast<uint32_t*>(vmean + (int64_t)bhkv * D);
    bounds = reinterpret_cast<int*>(bits + (int64_t)(bh / hq) *
                                               modes::mask_words(sk));
    err = modes::launch_pack(kv, bits, bh / hq, sk, stream, bounds);
    if (err != cudaSuccess) return (int)err;
    flash_attention_kv_mean<T><<<dim3(D / 32, bhkv), 256, 0, stream>>>(
        static_cast<const T*>(v), vmean, sk, D, pb);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  flash_attention_prepare_kv<T><<<dim3(skp / kBk, bhkv), 256, 0, stream>>>(
      static_cast<const T*>(k), static_cast<const T*>(v), khi, klo, vthi,
      vtlo, sk, skp, D, pb);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return kMapError + (int)CUDA_ERROR_NOT_FOUND;
  CUtensorMap maps[4];
  const uint64_t rows = (uint64_t)bhkv * skp, vrows = (uint64_t)bhkv * D;
  int r = tensor_map(encode, &maps[0], khi, D, rows, kBk);
  if (!r) r = tensor_map(encode, &maps[1], klo, D, rows, kBk);
  if (!r)
    r = pb ? tensor_map_bf16(encode, &maps[2], vthi, skp, vrows, D)
           : tensor_map(encode, &maps[2], vthi, skp, vrows, D);
  if (!r) r = tensor_map(encode, &maps[3], vtlo, skp, vrows, D);
  if (r) return kMapError + r;

  auto* kernel = pb ? flash_attention_kernel<D, T, kModePb>
                 : kv != nullptr ? flash_attention_kernel<D, T, kModeMask>
                                 : flash_attention_kernel<D, T, kModeNone>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Layout<D>::kBytes);
  if (err != cudaSuccess) return (int)err;
  const int grid = bh * ((sq + kBlockRows - 1) / kBlockRows);
  kernel<<<grid, kThreads, Layout<D>::kBytes, stream>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<const T*>(q),
      static_cast<T*>(o), lse, bits, bounds, vmean, sq, sk, skp, kv_group, hq,
      causal, window, scale, skip);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* o,
             float* lse, float* work, const uint8_t* kv, int bh,
             int kv_group, int sq, int sk, int d, int hq, int causal,
             int window, float scale, int skip, int mds,
             cudaStream_t stream) {
  switch (d) {
    case 32:
      return launch<32, T>(q, k, v, o, lse, work, kv, bh, kv_group, sq, sk,
                           hq, causal, window, scale, skip, mds, stream);
    case 64:
      return launch<64, T>(q, k, v, o, lse, work, kv, bh, kv_group, sq, sk,
                           hq, causal, window, scale, skip, mds, stream);
    case 128:
      return launch<128, T>(q, k, v, o, lse, work, kv, bh, kv_group, sq, sk,
                            hq, causal, window, scale, skip, mds, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q (bh, sq, d), k / v (bh / kv_group, sk, d), o (bh, sq, d): contiguous,
// 16-byte aligned, all float32 (bf16 = 0) or all bfloat16 (bf16 = 1) on
// the device; lse: null, or (bh, sq) float32 for each row's log-sum-exp
// (the backward's statistics; o is the same either way); work: 4 (bh /
// kv_group) ceil(sk / 32) 32 d float32 scratch, and with kv_valid (bh /
// kv_group) d + (bh / hq) (ceil(sk / 32) + 2) more; kv_valid: null, or
// (bh / hq, sk) uint8 live keys, row-block bh reading row bh / hq; modes:
// 0 or kProbsBf16 (attention_modes.cuh); d in {32, 64, 128}; bh divisible
// by kv_group and hq; window <= 0 for none; skip = 1 skips the tiles no
// row of a query tile can see, and with kv_valid those with no live key
// (kernels/flash_attention.py checks shapes, types and shared memory
// before the launch, and refuses shapes with a row that sees no key for
// want of a window). Launches the mask's packing and bounds and kv_mean
// (with kv_valid), the prepare pass and the kernel on ``stream``
// and returns cudaGetLastError() (or the error of raising the shared
// memory limit, or 10000 + the CUresult of a tensor map the driver
// refused).
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, void* lse,
                                   void* work, const void* kv_valid, int bh,
                                   int kv_group, int sq, int sk, int d,
                                   int bf16, int hq, int causal, int window,
                                   float scale, int skip, int mds,
                                   void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float *w = static_cast<float*>(work), *l = static_cast<float*>(lse);
  const uint8_t* kv = static_cast<const uint8_t*>(kv_valid);
  return bf16 ? launch_d<__nv_bfloat16>(q, k, v, o, l, w, kv, bh, kv_group,
                                        sq, sk, d, hq, causal, window, scale,
                                        skip, mds, s)
              : launch_d<float>(q, k, v, o, l, w, kv, bh, kv_group, sq, sk,
                                d, hq, causal, window, scale, skip, mds, s);
}
