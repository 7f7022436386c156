// The backward of flash attention (csrc/flash_attention.cu) over flattened
// (BH, S, D) tensors: given q, k, v, the forward's output o and its
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
// FlashAttention).
//
// The standard recomputation: with P = exp(s - lse) on the live (q, k)
// pairs and 0 elsewhere,
//
//     dV = P^T dO,  dP = dO V^T,  dS = P (dP - delta),
//     dQ = scale (dS K),  dK = dS^T (q scale),
//
// delta = rowsum(dO o). Three kernels, launched in order on one stream:
//
// (a) flash_bwd_stats, per (bh, 64-row query tile): each row's lse over
//     the visible key tiles (online max and sum, masked scores -1e30 as in
//     the forward, so a wholly masked tile leaves m and l as they were or
//     is wiped out exactly by the first live one) and delta;
// (b) flash_bwd_dkdv, per (KV head, 64-key tile): dK and dV in registers,
//     looping over the group's g query heads and, for each, the query
//     tiles that can see the key tile;
// (c) flash_bwd_dq, per (bh, query tile): dQ in registers over the visible
//     key tiles.
//
// Every sum has one owner and a fixed order: no atomics, so the result is
// the same from run to run. The tile skip (``skip``) only leaves out tiles
// whose pairs are all masked; such a tile has P = 0 and dS = 0, adds exact
// zeros, and leaves lse's m and l unchanged, so skipping or running them
// gives the same bits. The scores s come from one routine with one order
// of products (dot_tile) in all three kernels, so (b) and (c) see the same
// P that (a) normalised.
//
// Bound on the card: at yi-6b's shape (BH, S, D) = (128, 2048, 128),
// causal, the five products over the live half are 5 x 2 D per pair,
// 343.8 GFLOP; as three TF32 products each at 495 TFLOP/s that is 2.08 ms
// (operations, not the 604 MB of q, k, v, o, dO and the gradients). This
// first kernel runs float32 FMAs from shared-memory tiles on the CUDA
// cores (67 TFLOP/s, 5.1 ms for those five products alone) and recomputes
// q k^T in all three kernels and dO V^T in two: eight products where the
// bound counts five. Each thread owns a 4 x 4 block of a 64 x 64 tile of
// scores (rows ty + 16 i, columns tx + 16 j), read as float4 along D from
// rows padded by 4 floats (conflict-free), and a 4 x D/16 block of its
// gradient rows. wgmma (3xTF32, as the forward) and TMA are the lever for
// a later PR.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;            // query rows or keys of a tile
constexpr int kThreads = 256;        // 16 x 16: thread (ty, tx)
constexpr int kPad = 4;              // floats of padding per tile row
constexpr int kLdT = kTile + kPad;   // row stride of a 64 x 64 P / dS tile
constexpr float kNeg = -1e30f;       // the forward's masked score

template <int D>
struct Ld {
  static constexpr int kRow = D + kPad;   // row stride of a 64 x D tile
  static constexpr int kFloats = kTile * kRow;
};

template <int D>
constexpr int stats_bytes() { return 2 * Ld<D>::kFloats * 4; }
template <int D>
constexpr int dkdv_bytes() {
  return (4 * Ld<D>::kFloats + 2 * kTile * kLdT + 2 * kTile) * 4;
}
template <int D>
constexpr int dq_bytes() { return (4 * Ld<D>::kFloats + kTile * kLdT) * 4; }

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ float load1(const float* p) { return *p; }
__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Rows r0 .. r0 + 63 of a (n, D) matrix into a padded float32 tile, each
// value times ``mul`` (1 is exact); rows past n are zeros.
template <int D, typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int r0,
                                          int n, float mul) {
  constexpr int kVec = D / 4;
  for (int i = threadIdx.x; i < kTile * kVec; i += kThreads) {
    const int r = i / kVec, c = (i % kVec) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < n) x = load4(src + (int64_t)(r0 + r) * D + c);
    *reinterpret_cast<float4*>(dst + r * Ld<D>::kRow + c) =
        make_float4(x.x * mul, x.y * mul, x.z * mul, x.w * mul);
  }
}

// s[i][j] = sum over d, in order, of a[ty + 16 i][d] b[tx + 16 j][d]:
// a and b are padded 64 x D tiles.
template <int D>
__device__ __forceinline__ void dot_tile(float (&s)[4][4], const float* a,
                                         const float* b, int ty, int tx) {
  constexpr int kRow = Ld<D>::kRow;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      av[i] = *reinterpret_cast<const float4*>(a + (ty + 16 * i) * kRow + d);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      bv[j] = *reinterpret_cast<const float4*>(b + (tx + 16 * j) * kRow + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x = s[i][j];
        x = fmaf(av[i].x, bv[j].x, x);
        x = fmaf(av[i].y, bv[j].y, x);
        x = fmaf(av[i].z, bv[j].z, x);
        x = fmaf(av[i].w, bv[j].w, x);
        s[i][j] = x;
      }
  }
}

// acc[i][c] += sum over j < 64, in order, of a[ty + 16 i][j] b[j][tx + 16
// c]: a a 64 x 64 tile of row stride kLdT, b a padded 64 x D tile.
template <int D>
__device__ __forceinline__ void acc_tile(float (&acc)[4][D / 16],
                                         const float* a, const float* b,
                                         int ty, int tx) {
  constexpr int kRow = Ld<D>::kRow, kNc = D / 16;
#pragma unroll 2
  for (int j = 0; j < kTile; j += 4) {
    float av[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 x =
          *reinterpret_cast<const float4*>(a + (ty + 16 * i) * kLdT + j);
      av[i][0] = x.x; av[i][1] = x.y; av[i][2] = x.z; av[i][3] = x.w;
    }
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int c = 0; c < kNc; ++c) {
        const float bv = b[(j + jj) * kRow + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(av[i][jj], bv, acc[i][c]);
      }
  }
}

__device__ __forceinline__ float max16(float x) {
#pragma unroll
  for (int o = 8; o; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float sum16(float x) {
#pragma unroll
  for (int o = 8; o; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// The forward's mask for query row ``row`` and key ``col``.
__device__ __forceinline__ bool visible(int row, int col, int sk, int causal,
                                        int window) {
  return col < sk && (!causal || col <= row) &&
         (window <= 0 || col > row - window);
}

// The key tiles [*t0, *t1) the query tile at q0 can see (all with !skip).
__device__ __forceinline__ void key_tiles(int q0, int sq, int sk, int causal,
                                          int window, int skip, int* t0,
                                          int* t1) {
  int lo = 0, hi = sk;
  if (skip) {
    const int last = min(q0 + kTile, sq) - 1;
    if (causal) hi = min(hi, last + 1);
    if (window > 0) lo = max(lo, q0 - window + 1);
  }
  *t0 = lo / kTile;
  *t1 = hi > lo ? (hi + kTile - 1) / kTile : *t0;
}

// The query tiles [*t0, *t1) that can see the key tile at k0.
__device__ __forceinline__ void query_tiles(int k0, int sq, int sk,
                                            int causal, int window, int skip,
                                            int* t0, int* t1) {
  int lo = 0, hi = sq;
  if (skip) {
    const int last = min(k0 + kTile, sk) - 1;
    if (causal) lo = max(lo, k0);
    if (window > 0) hi = min(hi, last + window);
  }
  *t0 = lo / kTile;
  *t1 = hi > lo ? (hi + kTile - 1) / kTile : *t0;
}

// (a) lse and delta of the 64 query rows of one (bh, query tile).
template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_stats(const T* q, const T* k, const T* o, const T* dout,
                    float* lse, float* delta, int kv_group, int sq, int sk,
                    int causal, int window, float scale, int skip) {
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* ks = qs + Ld<D>::kFloats;
  const int tiles = (sq + kTile - 1) / kTile;
  const int head = blockIdx.x / tiles, q0 = (blockIdx.x % tiles) * kTile;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int64_t qoff = (int64_t)head * sq * D;
  const T* kh = k + (int64_t)(head / kv_group) * sk * D;
  load_tile<D>(qs, q + qoff, q0, sq, scale);

  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
    // delta: this thread's columns tx + 16 c, then the 16 lanes of the row
    const int row = q0 + ty + 16 * i;
    float part = 0.f;
    if (row < sq) {
      const int64_t at = qoff + (int64_t)row * D + tx;
#pragma unroll
      for (int c = 0; c < D / 16; ++c)
        part = fmaf(load1(dout + at + 16 * c), load1(o + at + 16 * c), part);
    }
    part = sum16(part);
    if (tx == 0 && row < sq) delta[(int64_t)head * sq + row] = part;
  }

  int t0, t1;
  key_tiles(q0, sq, sk, causal, window, skip, &t0, &t1);
  for (int t = t0; t < t1; ++t) {
    __syncthreads();
    load_tile<D>(ks, kh, t * kTile, sk, 1.f);
    __syncthreads();
    float s[4][4];
    dot_tile<D>(s, qs, ks, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (!visible(row, t * kTile + tx + 16 * j, sk, causal, window))
          s[i][j] = kNeg;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], max16(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) sum += expf(s[i][j] - m_new);
      l[i] = l[i] * expf(m[i] - m_new) + sum16(sum);
      m[i] = m_new;
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (tx == 0 && row < sq) lse[(int64_t)head * sq + row] = m[i] + logf(l[i]);
  }
}

// P and dS of one (query tile, key tile) pair: rows q0 + ty + 16 i, keys
// k0 + tx + 16 j; ``s`` and ``dp`` in, P and dS out in their place.
__device__ __forceinline__ void probs(float (&s)[4][4], float (&dp)[4][4],
                                      const float* lse_rows,
                                      const float* delta_rows, int q0, int k0,
                                      int sq, int sk, int causal, int window,
                                      int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool live = row < sq && visible(row, k0 + tx + 16 * j, sk, causal,
                                            window);
      const float p = live ? expf(s[i][j] - lse_rows[i]) : 0.f;
      s[i][j] = p;
      dp[i][j] = p * (dp[i][j] - delta_rows[i]);
    }
  }
}

// (b) dK and dV of one (KV head, key tile).
template <int D, typename T>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkdv(const T* q, const T* k, const T* v, const T* dout,
                   const float* lse, const float* delta, T* dk, T* dv,
                   int kv_group, int sq, int sk, int causal, int window,
                   float scale, int skip) {
  constexpr int kNc = D / 16;
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);
  float* vs = ks + Ld<D>::kFloats;
  float* qs = vs + Ld<D>::kFloats;
  float* dos = qs + Ld<D>::kFloats;
  float* pt = dos + Ld<D>::kFloats;     // P^T: [key][query row]
  float* dst = pt + kTile * kLdT;       // dS^T
  float* lse_s = dst + kTile * kLdT;
  float* delta_s = lse_s + kTile;
  const int tiles = (sk + kTile - 1) / kTile;
  const int kvh = blockIdx.x / tiles, k0 = (blockIdx.x % tiles) * kTile;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int64_t kvoff = (int64_t)kvh * sk * D;
  load_tile<D>(ks, k + kvoff, k0, sk, 1.f);
  load_tile<D>(vs, v + kvoff, k0, sk, 1.f);

  float acc_dk[4][kNc], acc_dv[4][kNc];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kNc; ++c) acc_dk[i][c] = acc_dv[i][c] = 0.f;

  int t0, t1;
  query_tiles(k0, sq, sk, causal, window, skip, &t0, &t1);
  for (int g = 0; g < kv_group; ++g) {
    const int head = kvh * kv_group + g;
    const int64_t qoff = (int64_t)head * sq * D;
    for (int t = t0; t < t1; ++t) {
      const int q0 = t * kTile;
      __syncthreads();
      load_tile<D>(qs, q + qoff, q0, sq, scale);
      load_tile<D>(dos, dout + qoff, q0, sq, 1.f);
      if (threadIdx.x < kTile) {
        const int row = q0 + threadIdx.x;
        const int64_t at = (int64_t)head * sq + row;
        lse_s[threadIdx.x] = row < sq ? lse[at] : 0.f;
        delta_s[threadIdx.x] = row < sq ? delta[at] : 0.f;
      }
      __syncthreads();
      float s[4][4], dp[4][4], lr[4], dr[4];
      dot_tile<D>(s, qs, ks, ty, tx);
      dot_tile<D>(dp, dos, vs, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        lr[i] = lse_s[ty + 16 * i];
        dr[i] = delta_s[ty + 16 * i];
      }
      probs(s, dp, lr, dr, q0, k0, sq, sk, causal, window, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          pt[(tx + 16 * j) * kLdT + ty + 16 * i] = s[i][j];
          dst[(tx + 16 * j) * kLdT + ty + 16 * i] = dp[i][j];
        }
      __syncthreads();
      // rows of acc_* are keys k0 + ty + 16 i, columns d = tx + 16 c
      acc_tile<D>(acc_dv, pt, dos, ty, tx);
      acc_tile<D>(acc_dk, dst, qs, ty, tx);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key >= sk) continue;
    const int64_t at = kvoff + (int64_t)key * D + tx;
#pragma unroll
    for (int c = 0; c < kNc; ++c) {
      store1(dk + at + 16 * c, acc_dk[i][c]);
      store1(dv + at + 16 * c, acc_dv[i][c]);
    }
  }
}

// (c) dQ of one (bh, query tile).
template <int D, typename T>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq(const T* q, const T* k, const T* v, const T* dout,
                 const float* lse, const float* delta, T* dq, int kv_group,
                 int sq, int sk, int causal, int window, float scale,
                 int skip) {
  constexpr int kNc = D / 16;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* dos = qs + Ld<D>::kFloats;
  float* ks = dos + Ld<D>::kFloats;
  float* vs = ks + Ld<D>::kFloats;
  float* dss = vs + Ld<D>::kFloats;     // dS: [query row][key]
  const int tiles = (sq + kTile - 1) / kTile;
  const int head = blockIdx.x / tiles, q0 = (blockIdx.x % tiles) * kTile;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int64_t qoff = (int64_t)head * sq * D;
  const int64_t kvoff = (int64_t)(head / kv_group) * sk * D;
  load_tile<D>(qs, q + qoff, q0, sq, scale);
  load_tile<D>(dos, dout + qoff, q0, sq, 1.f);
  float lr[4], dr[4], acc[4][kNc];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    lr[i] = row < sq ? lse[(int64_t)head * sq + row] : 0.f;
    dr[i] = row < sq ? delta[(int64_t)head * sq + row] : 0.f;
#pragma unroll
    for (int c = 0; c < kNc; ++c) acc[i][c] = 0.f;
  }

  int t0, t1;
  key_tiles(q0, sq, sk, causal, window, skip, &t0, &t1);
  for (int t = t0; t < t1; ++t) {
    const int k0 = t * kTile;
    __syncthreads();
    load_tile<D>(ks, k + kvoff, k0, sk, 1.f);
    load_tile<D>(vs, v + kvoff, k0, sk, 1.f);
    __syncthreads();
    float s[4][4], dp[4][4];
    dot_tile<D>(s, qs, ks, ty, tx);
    dot_tile<D>(dp, dos, vs, ty, tx);
    probs(s, dp, lr, dr, q0, k0, sq, sk, causal, window, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        dss[(ty + 16 * i) * kLdT + tx + 16 * j] = dp[i][j];
    __syncthreads();
    acc_tile<D>(acc, dss, ks, ty, tx);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= sq) continue;
    const int64_t at = qoff + (int64_t)row * D + tx;
#pragma unroll
    for (int c = 0; c < kNc; ++c) store1(dq + at + 16 * c, scale * acc[i][c]);
  }
}

template <int D, typename T>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, void* dq, void* dk, void* dv, float* lse,
           float* delta, int bh, int kv_group, int sq, int sk, int causal,
           int window, float scale, int skip, cudaStream_t stream) {
  const T *qt = static_cast<const T*>(q), *kt = static_cast<const T*>(k),
          *vt = static_cast<const T*>(v), *ot = static_cast<const T*>(o),
          *dot = static_cast<const T*>(dout);
  const int q_blocks = bh * ((sq + kTile - 1) / kTile);
  const int kv_blocks = bh / kv_group * ((sk + kTile - 1) / kTile);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_stats<D, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      stats_bytes<D>());
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_bwd_dkdv<D, T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               dkdv_bytes<D>());
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_bwd_dq<D, T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               dq_bytes<D>());
  if (err != cudaSuccess) return (int)err;
  flash_bwd_stats<D, T><<<q_blocks, kThreads, stats_bytes<D>(), stream>>>(
      qt, kt, ot, dot, lse, delta, kv_group, sq, sk, causal, window, scale,
      skip);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dkdv<D, T><<<kv_blocks, kThreads, dkdv_bytes<D>(), stream>>>(
      qt, kt, vt, dot, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      kv_group, sq, sk, causal, window, scale, skip);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dq<D, T><<<q_blocks, kThreads, dq_bytes<D>(), stream>>>(
      qt, kt, vt, dot, lse, delta, static_cast<T*>(dq), kv_group, sq, sk,
      causal, window, scale, skip);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, const void* o,
             const void* dout, void* dq, void* dk, void* dv, float* lse,
             float* delta, int bh, int kv_group, int sq, int sk, int d,
             int causal, int window, float scale, int skip,
             cudaStream_t stream) {
  switch (d) {
    case 32:
      return launch<32, T>(q, k, v, o, dout, dq, dk, dv, lse, delta, bh,
                           kv_group, sq, sk, causal, window, scale, skip,
                           stream);
    case 64:
      return launch<64, T>(q, k, v, o, dout, dq, dk, dv, lse, delta, bh,
                           kv_group, sq, sk, causal, window, scale, skip,
                           stream);
    case 128:
      return launch<128, T>(q, k, v, o, dout, dq, dk, dv, lse, delta, bh,
                            kv_group, sq, sk, causal, window, scale, skip,
                            stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q, o, dout, dq (bh, sq, d) and k, v, dk, dv (bh / kv_group, sk, d):
// contiguous, 16-byte aligned, all float32 (bf16 = 0) or all bfloat16
// (bf16 = 1) on the device; lse and delta: bh sq float32 scratch; d in {32,
// 64, 128}; window <= 0 for none; skip = 1 skips the tiles whose pairs are
// all masked (kernels/flash_attention.py checks shapes and types, and
// refuses shapes with a row that sees no key). Launches the three kernels
// on ``stream`` and returns cudaGetLastError() (or the error of raising a
// shared memory limit).
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, void* dq, void* dk,
                                   void* dv, void* lse, void* delta, int bh,
                                   int kv_group, int sq, int sk, int d,
                                   int bf16, int causal, int window,
                                   float scale, int skip, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float *l = static_cast<float*>(lse), *dl = static_cast<float*>(delta);
  return bf16 ? launch_d<__nv_bfloat16>(q, k, v, o, dout, dq, dk, dv, l, dl,
                                        bh, kv_group, sq, sk, d, causal,
                                        window, scale, skip, s)
              : launch_d<float>(q, k, v, o, dout, dq, dk, dv, l, dl, bh,
                                kv_group, sq, sk, d, causal, window, scale,
                                skip, s);
}
