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
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

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

// Dynamic shared memory of one block, from a 1024-byte aligned base (the
// 128-byte swizzle repeats every 8 rows of 128 bytes): each consumer
// warpgroup's Q_lo as D / 32 column atoms of (64 rows x 128 B) (Q_hi lives
// in its registers); each one's P_hi, P_lo as (64 rows x 128 B); the
// stages, each K_hi, K_lo as D / 32 atoms of (32 rows x 128 B) and V^T_hi,
// V^T_lo as (D rows x 128 B); then the mbarriers, per stage a full and an
// empty one for its K half and for its V half.
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
  static constexpr int kBytes = kBar + 4 * kStages * 8 + 1024;  // + align
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
// tile through shared memory into V^T_hi, V^T_lo columns. Keys at or past
// Sk are zeros.
template <typename T>
__global__ void __launch_bounds__(256)
    flash_attention_prepare_kv(const T* __restrict__ k,
                               const T* __restrict__ v,
                               float* __restrict__ khi,
                               float* __restrict__ klo,
                               float* __restrict__ vthi,
                               float* __restrict__ vtlo, int Sk, int Skp,
                               int D) {
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
    const float hi = to_tf32(x);
    const int64_t w = ((int64_t)h * D + c) * Skp + k0 + j;
    vthi[w] = hi;
    vtlo[w] = to_tf32(x - hi);
  }
}

// ------------------------------------------------------------ main kernel

// A block's work: head bh (KV head kvh), query rows q0 .. q0 + 127, key
// tiles kt_begin .. kt_begin + n_tiles - 1 (the tiles some row of the
// block sees; both warpgroups run them all, and a tile that none of a
// warpgroup's rows sees leaves its bits alone). Blocks go KV head by KV
// head (its K/V tiles stay in L2 while its kv_group query heads read
// them), query tiles longest first within one.
struct Work {
  int bh, kvh, q0, kt_begin, n_tiles;
};

__device__ __forceinline__ Work block_work(int Sq, int Sk, int kv_group,
                                           int causal, int window,
                                           int skip) {
  Work wk;
  const int nqt = (Sq + kBlockRows - 1) / kBlockRows;
  wk.kvh = blockIdx.x / (nqt * kv_group);
  const int rem = blockIdx.x % (nqt * kv_group);
  wk.bh = wk.kvh * kv_group + rem % kv_group;
  wk.q0 = (nqt - 1 - rem / kv_group) * kBlockRows;
  const int nk = (Sk + kBk - 1) / kBk;
  int kt_begin = 0, kt_end = nk;
  if (skip) {
    const int q_last = min(wk.q0 + kBlockRows, Sq) - 1;
    if (causal) kt_end = min(nk, q_last / kBk + 1);
    if (window > 0) kt_begin = max(0, wk.q0 - window + 1) / kBk;
  }
  wk.kt_begin = kt_begin;
  wk.n_tiles = kt_end - kt_begin;
  return wk;
}

// The stages' shared-memory addresses and barriers.
template <int D>
struct Stages {
  using L = Layout<D>;
  uint32_t base, bars;
  __device__ uint32_t k(int it) const {
    return base + L::kStage0 + (it % L::kStages) * L::kStageBytes;
  }
  __device__ uint32_t v(int it) const { return k(it) + 2 * L::kKBytes; }
  __device__ uint32_t k_full(int it) const {
    return bars + 32 * (it % L::kStages);
  }
  __device__ uint32_t k_empty(int it) const { return k_full(it) + 8; }
  __device__ uint32_t v_full(int it) const { return k_full(it) + 16; }
  __device__ uint32_t v_empty(int it) const { return k_full(it) + 24; }
  __device__ int parity(int it) const { return (it / L::kStages) & 1; }
};

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
// for k step kk).
template <int D, int KK>
__device__ __forceinline__ void scores_from(float* sc, const uint32_t* qh,
                                            uint64_t qlo, uint64_t khi,
                                            uint64_t klo) {
  if constexpr (KK < D / 8) {
    WgmmaSS<32, k_step(KK, kBq), k_step(KK, kBk)>::run(sc, qlo, khi);
    scores_from<D, KK + 1>(sc, qh, qlo, khi, klo);
  } else if constexpr (KK < 2 * (D / 8)) {
    constexpr int kk = KK - D / 8;
    wgmma_rs32<k_step(kk, kBk)>(sc, qh + 4 * kk, klo);
    scores_from<D, KK + 1>(sc, qh, qlo, khi, klo);
  } else if constexpr (KK < 3 * (D / 8)) {
    constexpr int kk = KK - 2 * (D / 8);
    wgmma_rs32<k_step(kk, kBk)>(sc, qh + 4 * kk, khi);
    scores_from<D, KK + 1>(sc, qh, qlo, khi, klo);
  }
}

// S into sc (zeroed here), committed as one group; small terms first, as
// CUTLASS orders 3xTF32.
template <int D>
__device__ __forceinline__ void issue_scores(float* sc, const uint32_t* qh,
                                             uint32_t qlo, uint32_t k) {
  qlo = opaque(qlo);
  k = opaque(k);
#pragma unroll
  for (int i = 0; i < 16; ++i) sc[i] = 0.0f;
  fence_regs<16>(sc);
  wgmma_fence();
  scores_from<D, 0>(sc, qh, sw128_desc(qlo), sw128_desc(k),
                    sw128_desc(k + Layout<D>::kKBytes));
  wgmma_commit();
}

// The k steps J.. of P.V: P_lo V_hi, P_hi V_lo, P_hi V_hi (the 32 keys are
// one atom: k step j is 32 bytes, 2 descriptor units, into it).
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
// P_hi V_hi (P from shared memory at p, P_lo at p + kPBytes; B = V^T),
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
// 4 threads are one quad): masked scores to -1e30, m and l updated, O
// (acc[4 c + 2 i + e], row row0 + 8 i) rescaled by alpha, sc left holding
// p.
template <int D>
__device__ __forceinline__ void softmax_step(float* sc, float* m, float* l,
                                             float* acc, int key0,
                                             const Tile& tl) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qpos = tl.row0 + 8 * i;
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kpos = key0 + 8 * j + 2 * tl.t + e;
        const bool live = kpos < tl.Sk && (!tl.causal || kpos <= qpos) &&
                          (tl.window <= 0 || kpos > qpos - tl.window);
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
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      acc[4 * c + 2 * i] *= alpha;
      acc[4 * c + 2 * i + 1] *= alpha;
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
// release tile it + 1's K half, run its softmax, rescale O by its alpha
// and store its P. While one warpgroup runs its softmax, the other's
// products keep the tensor cores busy. Next is a template argument, so
// every wait is static and ptxas keeps the products asynchronous.
template <int D, bool Next>
__device__ __forceinline__ void tile_step(int it, int kt_begin,
                                          const Stages<D>& st,
                                          const uint32_t* qh, uint32_t qlo,
                                          uint32_t p, int w, const Tile& tl,
                                          float* acc, float* m, float* l) {
  float tmp[D / 2], sc[16];
  mbar_wait(st.v_full(it), st.parity(it));
  issue_pv<D>(tmp, p, st.v(it));
  if (Next) {
    mbar_wait(st.k_full(it + 1), st.parity(it + 1));
    issue_scores<D>(sc, qh, qlo, st.k(it + 1));
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
    mbar_arrive(st.k_empty(it + 1));
    softmax_step<D>(sc, m, l, acc, (kt_begin + it + 1) * kBk, tl);
    store_p(sc, p, tl.row0 - tl.r0, tl.t);
    smem_ready(w);
  }
}

// The producer (one thread): every box, K one tile ahead of V (K_0, K_1,
// V_0, K_2, V_1, ...), since a tile's K half is free once its scores are
// done and its V half only after P.V.
template <int D>
__device__ __forceinline__ void produce(const CUtensorMap* tm_khi,
                                        const CUtensorMap* tm_klo,
                                        const CUtensorMap* tm_vthi,
                                        const CUtensorMap* tm_vtlo,
                                        const Work& wk, int Skp) {
  using L = Layout<D>;
  constexpr int kS = L::kStages;
  const uint32_t base = smem_base(), bars = base + L::kBar;
  for (int it = -1; it < wk.n_tiles; ++it) {
    const int kt = it + 1;  // the K half to load, then V of tile it
    if (kt < wk.n_tiles) {
      const int s = kt % kS;
      const uint32_t full = bars + 8 * (4 * s);
      if (kt >= kS) mbar_wait(full + 8, ((kt / kS) - 1) & 1);
      mbar_expect_tx(full, 2 * L::kKBytes);
      const int row = wk.kvh * Skp + (wk.kt_begin + kt) * kBk;
      const uint32_t st = base + L::kStage0 + s * L::kStageBytes;
#pragma unroll
      for (int a = 0; a < D / 32; ++a) {
        tma_load(st + a * kBk * kAtom, tm_khi, full, 32 * a, row);
        tma_load(st + L::kKBytes + a * kBk * kAtom, tm_klo, full, 32 * a,
                 row);
      }
    }
    if (it >= 0) {
      const int s = it % kS;
      const uint32_t full = bars + 8 * (4 * s + 2);
      if (it >= kS) mbar_wait(full + 8, ((it / kS) - 1) & 1);
      mbar_expect_tx(full, 2 * L::kVBytes);
      const int key0 = (wk.kt_begin + it) * kBk;
      const uint32_t st =
          base + L::kStage0 + s * L::kStageBytes + 2 * L::kKBytes;
      tma_load(st, tm_vthi, full, key0, wk.kvh * D);
      tma_load(st + L::kVBytes, tm_vtlo, full, key0, wk.kvh * D);
    }
  }
}

// A consumer warpgroup: rows q0 + 64 w .. of head bh.
template <int D, typename T>
__device__ __forceinline__ void consume(const T* __restrict__ q,
                                        T* __restrict__ o,
                                        float* __restrict__ lse, int Sq,
                                        int Sk, int kv_group, int causal,
                                        int window, float scale, int skip) {
  using L = Layout<D>;
  const Work wk = block_work(Sq, Sk, kv_group, causal, window, skip);
  const int bh = wk.bh, q0 = wk.q0, kt_begin = wk.kt_begin,
            n_tiles = wk.n_tiles;
  const uint32_t base = smem_base(), bars = base + L::kBar;
  // Q scaled and split: Q_lo into shared memory in the swizzled layout
  // (16-byte chunk c of row r at chunk c ^ (r % 8), as TMA's SWIZZLE_128B
  // puts it), Q_hi straight into this thread's A fragments.
  const int tid = threadIdx.x, w = tid / 128, wt = tid % 128;
  const int lane = tid % 32, g = lane / 4, t = lane % 4;
  const int r0 = q0 + kBq * w;
  const int64_t qoff = ((int64_t)bh * Sq + r0) * D;
  const uint32_t qlo = base + w * L::kQBytes;
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
  const Tile tile{r0, r0 + 16 * (wt / 32) + g, t, Sk, causal, window};
  uint32_t qh[D / 2];  // k step kk: (row0, 8 kk + t), (row0 + 8, ..), + 4
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
    }
  smem_ready(w);

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
  const Stages<D> st{base, bars};
  const uint32_t p = base + L::kP0 + w * 2 * L::kPBytes;

  {
    float sc[16];
    mbar_wait(st.k_full(0), 0);
    issue_scores<D>(sc, qh, qlo, st.k(0));
    wgmma_wait<0>();
    fence_regs<16>(sc);
    mbar_arrive(st.k_empty(0));
    softmax_step<D>(sc, m, l, acc, kt_begin * kBk, tile);
    store_p(sc, p, tile.row0 - r0, t);
    smem_ready(w);
  }
  for (int it = 0; it + 1 < n_tiles; ++it)
    tile_step<D, true>(it, kt_begin, st, qh, qlo, p, w, tile, acc, m, l);
  tile_step<D, false>(n_tiles - 1, kt_begin, st, qh, qlo, p, w, tile, acc, m,
                      l);

  // acc[4 c + 2 i + e] is row row0 + 8 i, column 8 c + 2 t + e; lse
  // (when asked for) is the row's m + log(l), for the backward kernel
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = tile.row0 + 8 * i;
    if (r < Sq) {
      if (lse != nullptr && t == 0)
        lse[(int64_t)bh * Sq + r] = m[i] + logf(l[i]);
      const float den = fmaxf(l[i], 1e-30f);
      T* out = o + ((int64_t)bh * Sq + r) * D + 2 * t;
#pragma unroll
      for (int c = 0; c < D / 8; ++c)
        store2(out + 8 * c, acc[4 * c + 2 * i] / den,
               acc[4 * c + 2 * i + 1] / den);
    }
  }
}

template <int D, typename T>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attention_kernel(const __grid_constant__ CUtensorMap tm_khi,
                           const __grid_constant__ CUtensorMap tm_klo,
                           const __grid_constant__ CUtensorMap tm_vthi,
                           const __grid_constant__ CUtensorMap tm_vtlo,
                           const T* __restrict__ q, T* __restrict__ o,
                           float* __restrict__ lse, int Sq, int Sk, int Skp,
                           int kv_group, int causal, int window, float scale,
                           int skip) {
  using L = Layout<D>;
  constexpr int kS = L::kStages;
  if (threadIdx.x == 0) {
    const uint32_t bars = smem_base() + L::kBar;
    for (int s = 0; s < kS; ++s) {
      mbar_init(bars + 8 * (4 * s), 1);
      mbar_init(bars + 8 * (4 * s + 1), kConsumers);
      mbar_init(bars + 8 * (4 * s + 2), 1);
      mbar_init(bars + 8 * (4 * s + 3), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // Each role computes what it needs after setmaxnreg: values carried
  // across it cost the consumers registers.
  if (threadIdx.x >= kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    if (threadIdx.x == kConsumers)
      produce<D>(&tm_khi, &tm_klo, &tm_vthi, &tm_vtlo,
                 block_work(Sq, Sk, kv_group, causal, window, skip), Skp);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");
    consume<D, T>(q, o, lse, Sq, Sk, kv_group, causal, window, scale,
                  skip);
  }
}

// ------------------------------------------------------------------ host

template <int D, typename T>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           float* work, int bh, int kv_group, int sq, int sk, int causal,
           int window, float scale, int skip, cudaStream_t stream) {
  const int bhkv = bh / kv_group;
  const int skp = (sk + kBk - 1) / kBk * kBk;
  const int64_t part = (int64_t)bhkv * skp * D;
  float *khi = work, *klo = work + part, *vthi = work + 2 * part,
        *vtlo = work + 3 * part;
  flash_attention_prepare_kv<T><<<dim3(skp / kBk, bhkv), 256, 0, stream>>>(
      static_cast<const T*>(k), static_cast<const T*>(v), khi, klo, vthi,
      vtlo, sk, skp, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return kMapError + (int)CUDA_ERROR_NOT_FOUND;
  CUtensorMap maps[4];
  const uint64_t rows = (uint64_t)bhkv * skp, vrows = (uint64_t)bhkv * D;
  int r = tensor_map(encode, &maps[0], khi, D, rows, kBk);
  if (!r) r = tensor_map(encode, &maps[1], klo, D, rows, kBk);
  if (!r) r = tensor_map(encode, &maps[2], vthi, skp, vrows, D);
  if (!r) r = tensor_map(encode, &maps[3], vtlo, skp, vrows, D);
  if (r) return kMapError + r;

  auto* kernel = flash_attention_kernel<D, T>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Layout<D>::kBytes);
  if (err != cudaSuccess) return (int)err;
  const int grid = bh * ((sq + kBlockRows - 1) / kBlockRows);
  kernel<<<grid, kThreads, Layout<D>::kBytes, stream>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<const T*>(q),
      static_cast<T*>(o), lse, sq, sk, skp, kv_group, causal, window, scale,
      skip);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* o,
             float* lse, float* work, int bh, int kv_group, int sq, int sk,
             int d, int causal, int window, float scale, int skip,
             cudaStream_t stream) {
  switch (d) {
    case 32:
      return launch<32, T>(q, k, v, o, lse, work, bh, kv_group, sq, sk,
                           causal, window, scale, skip, stream);
    case 64:
      return launch<64, T>(q, k, v, o, lse, work, bh, kv_group, sq, sk,
                           causal, window, scale, skip, stream);
    case 128:
      return launch<128, T>(q, k, v, o, lse, work, bh, kv_group, sq, sk,
                            causal, window, scale, skip, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q (bh, sq, d), k / v (bh / kv_group, sk, d), o (bh, sq, d): contiguous,
// 16-byte aligned, all float32 (bf16 = 0) or all bfloat16 (bf16 = 1) on
// the device; lse: null, or (bh, sq) float32 for each row's log-sum-exp
// (the backward's statistics; o is the same either way); work: 4 (bh /
// kv_group) ceil(sk / 32) 32 d float32 scratch;
// d in {32, 64, 128}; bh divisible by kv_group; ceil(sq / 64) <= 65535;
// window <= 0 for none; skip = 1 skips the tiles no row of a query tile
// can see (kernels/flash_attention.py checks shapes, types and shared
// memory before the launch, and refuses shapes with a row that sees no
// key). Launches the prepare pass and the kernel on ``stream`` and returns
// cudaGetLastError() (or the error of raising the shared memory limit, or
// 10000 + the CUresult of a tensor map the driver refused).
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, void* lse,
                                   void* work, int bh, int kv_group, int sq,
                                   int sk, int d, int bf16, int causal,
                                   int window, float scale, int skip,
                                   void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float *w = static_cast<float*>(work), *l = static_cast<float*>(lse);
  return bf16 ? launch_d<__nv_bfloat16>(q, k, v, o, l, w, bh, kv_group, sq,
                                        sk, d, causal, window, scale, skip, s)
              : launch_d<float>(q, k, v, o, l, w, bh, kv_group, sq, sk, d,
                                causal, window, scale, skip, s);
}
