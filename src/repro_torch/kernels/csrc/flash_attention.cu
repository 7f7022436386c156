// Flash attention (online softmax) over flattened (BH, S, D) tensors:
// o = softmax(mask(q k^T scale)) v per (batch, head), causal masking, a
// one-sided sliding window (k > q - window) and the key count Sk as the
// bound, query and key positions both counted from 0.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention_bhsd, body _attn_kernel). That kernel runs a (BH, q
// blocks, k blocks) grid whose k axis is sequential on the TPU's one core,
// carrying the online-softmax statistics m, l and the (128, D) sum in VMEM
// scratch, and pads Sq and Sk to blocks of 128 (padded keys masked by
// kv_len). Here one block owns one (bh, 64-row query tile) and loops over
// the 64-key tiles itself (blocks run in no order, so nothing can carry
// between them); m, l and the sum stay in registers across the loop, and
// the ragged edges are bounds-checked instead of padded. Per tile, in the
// TPU kernel's order: s = (q scale) k^T; masked scores set to -1e30, never
// -inf; m' = max(m, rowmax s); alpha = exp(m - m'); p = exp(s - m');
// l = alpha l + rowsum p; acc = acc alpha + p v; at the end
// o = acc / max(l, 1e-30), in q's type. Keys past Sk get p = 0 and leave
// m, l and acc as they were.
//
// -1e30 and the fully masked tile: a row whose first tile holds only
// masked keys (a window row) gets p = exp(0) = 1 there, junk that the
// first tile with a live key wipes out exactly (alpha = exp(-1e30 - m) is
// 0). With -inf that row would become NaN. For the same reason, skipping
// the tiles that lie wholly above the causal diagonal or wholly before the
// window of every row of the query tile gives the same bits as running
// them (p = 0 and alpha = 1 there for every row that has seen a live key);
// the ``skip`` argument turns it off so a test can show that. A row with no
// live key at all (only when Sq >= Sk + window) would depend on the skip;
// the wrapper refuses such shapes.
//
// Bound on the card: at yi-6b's prefill shape (BH, S, D) = (128, 2048,
// 128), causal, q k^T and p v over the live half are 2 S (S + 1) D
// float32 operations per bh, 137 GFLOP: 2.05 ms at 67 TFLOP/s; q, k, v
// and o are 134 MB each, 0.16 ms at 3.35 TB/s. So it is bound by
// operations. This design runs every product in full float32 on the CUDA
// cores (no TF32, no tensor cores), so it agrees with the plain version to
// float32's tolerance. What it does about the bound:
// - the causal and window tile skip halves the work at the causal shape;
// - the query tile, one K and one V tile stay in shared memory (97 KB at
//   D = 128, so two blocks share an SM), and P^T overwrites the K tile
//   once the scores are in registers;
// - each product is an outer-product loop in registers: a thread owns 4
//   rows (4 ty .. 4 ty + 3) and 4 key columns (tx + 16 j) of the scores,
//   then the same 4 rows and D / 16 output columns, so per step a float4
//   of each of 4 q rows and 4 k rows feeds 64 fused multiply-adds, and a
//   float4 of P^T with D / 32 float2 of V feeds D / 4. K rows are padded
//   to D + 4 floats and P^T to 68, so the float4 reads of a quarter-warp
//   hit distinct banks;
// - the row max and sum reduce over the 16 threads of a row by warp
//   shuffles, so the softmax needs no shared memory;
// - the query tiles run longest first (causal rows near the end have the
//   most tiles);
// - the products accumulate with explicit fused multiply-adds (fmaf), one
//   rounding per product; the build's -fmad=false keeps every other
//   multiply and add separately rounded, as the plain version computes.
// The tensor cores (wgmma), TMA loads overlapped with the products, and
// reading GQA's shared KV heads without the expanded copy are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBq = 64;        // query rows per block
constexpr int kBk = 64;        // keys per tile
constexpr int kThreads = 256;  // 16 x 16: ty = tid / 16 rows, tx = tid % 16
constexpr int kLdp = kBk + 4;  // row of the transposed P tile
constexpr float kNegInf = -1e30f;

// Dynamic shared memory, in floats: the scaled query tile (kBq, D), the K
// tile (kBk, D + 4) or P^T (kBk, kLdp) over it, the V tile (kBk, D).
__host__ __device__ constexpr int kp_floats(int d) {
  return kBk * (d + 4) > kBk * kLdp ? kBk * (d + 4) : kBk * kLdp;
}
__host__ __device__ constexpr int smem_floats(int d) {
  return kBq * d + kp_floats(d) + kBk * d;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void st4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}

// Four consecutive input elements as floats (bfloat16 widens exactly: its
// bits are the float's high half).
__device__ __forceinline__ float4 load4(const float* p) { return ld4(p); }
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

template <int D, typename T>
__global__ void __launch_bounds__(kThreads, 2)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ o,
                           int Sq, int Sk, int causal, int window,
                           float scale, int skip) {
  constexpr int kLdk = D + 4;
  constexpr int kCols = D / 16;  // output columns per thread
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // (kBq, D), times scale
  float* ks = qs + kBq * D;                     // (kBk, D + 4), then P^T
  float* vs = ks + kp_floats(D);                // (kBk, D)
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBq;  // longest rows first
  const int64_t qoff = (int64_t)blockIdx.y * Sq * D;
  const int64_t koff = (int64_t)blockIdx.y * Sk * D;

  for (int e = tid; e < kBq * D / 4; e += kThreads) {
    const int r = e / (D / 4), c = 4 * (e % (D / 4));
    float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (q0 + r < Sq) {
      x = load4(q + qoff + (int64_t)(q0 + r) * D + c);
      x.x *= scale;
      x.y *= scale;
      x.z *= scale;
      x.w *= scale;
    }
    st4(&qs[r * D + c], x);
  }

  const int nk = (Sk + kBk - 1) / kBk;
  int kt_begin = 0, kt_end = nk;
  if (skip) {
    const int q_last = min(q0 + kBq, Sq) - 1;
    if (causal) kt_end = min(nk, q_last / kBk + 1);
    if (window > 0) kt_begin = max(0, q0 - window + 1) / kBk;
  }

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.0f;
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kBk;
    for (int e = tid; e < kBk * D / 4; e += kThreads) {
      const int r = e / (D / 4), c = 4 * (e % (D / 4));
      float4 kx = make_float4(0.0f, 0.0f, 0.0f, 0.0f), vx = kx;
      if (k0 + r < Sk) {
        const int64_t g = koff + (int64_t)(k0 + r) * D + c;
        kx = load4(k + g);
        vx = load4(v + g);
      }
      st4(&ks[r * kLdk + c], kx);
      st4(&vs[r * D + c], vx);
    }
    __syncthreads();

    // s[i][j] = q[4 ty + i] . k[tx + 16 j]
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = ld4(&qs[(4 * ty + i) * D + d]);
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ld4(&ks[(tx + 16 * j) * kLdk + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }

    // online softmax per row; the 16 threads of a row are lanes tx of one
    // half-warp, so shuffles over xor 8, 4, 2, 1 reduce a row
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + 4 * ty + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        const bool live = kpos < Sk && (!causal || kpos <= qpos) &&
                          (window <= 0 || kpos > qpos - window);
        if (!live) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off /= 2)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = k0 + tx + 16 * j < Sk ? expf(s[i][j] - m_new) : 0.0f;
        sum += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off /= 2)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = alpha * l[i] + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();  // every thread is done reading the K tile

    float* pt = ks;  // P^T (kBk, kLdp): a float4 holds rows 4 ty .. 4 ty + 3
#pragma unroll
    for (int j = 0; j < 4; ++j)
      st4(&pt[(tx + 16 * j) * kLdp + 4 * ty],
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]));
    __syncthreads();

    // acc[i][2 g + e] += p[4 ty + i][c] v[c][32 g + 2 tx + e]
#pragma unroll 4
    for (int c = 0; c < kBk; ++c) {
      const float4 p4 = ld4(&pt[c * kLdp + 4 * ty]);
      const float pr[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
      for (int g = 0; g < D / 32; ++g) {
        const float2 v2 =
            *reinterpret_cast<const float2*>(&vs[c * D + 32 * g + 2 * tx]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][2 * g] = fmaf(pr[i], v2.x, acc[i][2 * g]);
          acc[i][2 * g + 1] = fmaf(pr[i], v2.y, acc[i][2 * g + 1]);
        }
      }
    }
    __syncthreads();  // before the next tile overwrites P^T and V
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + 4 * ty + i;
    if (r < Sq) {
      const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int g = 0; g < D / 32; ++g)
        store2(o + qoff + (int64_t)r * D + 32 * g + 2 * tx,
               acc[i][2 * g] / den, acc[i][2 * g + 1] / den);
    }
  }
}

template <int D, typename T>
int launch(const void* q, const void* k, const void* v, void* o, int bh,
           int sq, int sk, int causal, int window, float scale, int skip,
           cudaStream_t stream) {
  const int bytes = smem_floats(D) * (int)sizeof(float);
  auto* kernel = flash_attention_kernel<D, T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((sq + kBq - 1) / kBq, bh);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), sq, sk, causal, window,
      scale, skip);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* o, int bh,
             int sq, int sk, int d, int causal, int window, float scale,
             int skip, cudaStream_t stream) {
  switch (d) {
    case 32:
      return launch<32, T>(q, k, v, o, bh, sq, sk, causal, window, scale,
                           skip, stream);
    case 64:
      return launch<64, T>(q, k, v, o, bh, sq, sk, causal, window, scale,
                           skip, stream);
    case 128:
      return launch<128, T>(q, k, v, o, bh, sq, sk, causal, window, scale,
                            skip, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q (bh, sq, d), k / v (bh, sk, d), o (bh, sq, d): contiguous, 16-byte
// aligned, all float32 (bf16 = 0) or all bfloat16 (bf16 = 1) on the device;
// d in {32, 64, 128}; bh <= 65535; window <= 0 for none; skip = 1 skips
// the tiles no row of a query tile can see (kernels/flash_attention.py
// checks shapes, types and shared memory before the launch, and refuses
// shapes with a row that sees no key). Launches on ``stream`` and returns
// cudaGetLastError() (or the error of raising the shared memory limit).
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, int bh, int sq,
                                   int sk, int d, int bf16, int causal,
                                   int window, float scale, int skip,
                                   void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_d<__nv_bfloat16>(q, k, v, o, bh, sq, sk, d, causal,
                                        window, scale, skip, s)
              : launch_d<float>(q, k, v, o, bh, sq, sk, d, causal, window,
                                scale, skip, s);
}
