// The two optional modes of K5 and its backward (flash_attention.cu,
// flash_attention_bwd.cu), as the reference's _grouped_attention takes
// them (src/repro/models/attention.py):
//
// kv_valid: a (B, Sk) uint8 mask of live keys, row-block bh reading batch
//   bh / hq (hq query heads a batch element). The kernels read it packed,
//   32 keys a word (pack_kv_bits), a key that is dead scoring -1e30 like a
//   causally masked one. A row left with no live key at all gets every
//   score -1e30 in the reference, so softmax puts 1 / Sk on each of the Sk
//   keys, causally masked ones included: the forward writes that row the
//   mean of v over all Sk keys (kv_mean) and lse = +inf, and the backward,
//   where exp(s - lse) is then 0 on the whole row, adds the row's do / Sk
//   to dv at every key (dead_rows) and nothing else, as jax.vjp gives.
//   Both kernels also read each batch row's first and last live key
//   (kv_bounds, from the packed words), so that their blocks skip the
//   rows and keys that the mask leaves dead, not only those the band does:
//   the forward's blocks run only the key tiles of that span whose packed
//   word is not 0, and a block with none (a batch row with no live key,
//   or rows all before its first live key) writes its rows from kv_mean
//   at once; the backward's skip its dead rows, keys and words alike.
// probs_bf16 (attn_probs_bf16): the normalised probabilities P and V
//   rounded to bfloat16, their product summed in float32. The forward's
//   P.V is a bfloat16 wgmma with P in registers; the backward keeps its
//   TF32 path with the rounded value as the hi part (a bfloat16 value is
//   exact in TF32) and drops every product of a zero lo part (V's,
//   bf16(P)'s in dV, and K's and dO's where the inputs are bfloat16).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace modes {

constexpr int kKvValid = 1;    // flag bits of the C entries' ``modes``
constexpr int kProbsBf16 = 2;
constexpr int kWordKeys = 32;  // keys a packed mask word

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// The weight 1 / Sk a row with no live key puts on each key, rounded as
// P is in the mode.
__device__ __forceinline__ float dead_weight(int sk, int probs_bf16) {
  const float w = 1.0f / (float)sk;
  return probs_bf16 ? bf16_round(w) : w;
}

__host__ __device__ inline int mask_words(int sk) { return (sk + kWordKeys - 1) / kWordKeys; }

// Block (word group, batch): bits[b nw + w] has bit j set for key 32 w + j
// of batch b live (keys past Sk dead). One warp a word.
__global__ void __launch_bounds__(256)
    pack_kv_bits(const uint8_t* __restrict__ kv, uint32_t* __restrict__ bits,
                 int sk, int nw) {
  const int b = blockIdx.y, w = blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (w >= nw) return;  // the whole warp
  const int key = kWordKeys * w + lane;
  const bool on = key < sk && kv[(int64_t)b * sk + key] != 0;
  const uint32_t word = __ballot_sync(0xffffffffu, on);
  if (lane == 0) bits[(int64_t)b * nw + w] = word;
}

// Block b: bounds[2 b] and bounds[2 b + 1], the first and the last live
// key of batch b in the packed words (Sk and -1 where none is live); each
// thread's words, then the warps', then the block's, no atomics.
__global__ void __launch_bounds__(256)
    kv_bounds(const uint32_t* __restrict__ bits, int* __restrict__ bounds,
              int sk, int nw) {
  __shared__ int part[2][8];
  const int b = blockIdx.x, lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  int first = sk, last = -1;
  for (int w = threadIdx.x; w < nw; w += 256) {
    const uint32_t word = bits[(int64_t)b * nw + w];
    if (word != 0u) {
      first = min(first, kWordKeys * w + __ffs(word) - 1);
      last = max(last, kWordKeys * w + 31 - __clz(word));
    }
  }
  for (int off = 16; off; off >>= 1) {
    first = min(first, __shfl_xor_sync(0xffffffffu, first, off));
    last = max(last, __shfl_xor_sync(0xffffffffu, last, off));
  }
  if (lane == 0) {
    part[0][warp] = first;
    part[1][warp] = last;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int i = 1; i < 8; ++i) {
      first = min(first, part[0][i]);
      last = max(last, part[1][i]);
    }
    bounds[2 * b] = first;
    bounds[2 * b + 1] = last;
  }
}

// The packing, and with ``bounds`` kv_bounds after it.
inline cudaError_t launch_pack(const uint8_t* kv, uint32_t* bits, int batch,
                               int sk, cudaStream_t stream,
                               int* bounds = nullptr) {
  const int nw = mask_words(sk);
  pack_kv_bits<<<dim3((nw + 7) / 8, batch), 256, 0, stream>>>(kv, bits, sk,
                                                             nw);
  if (bounds != nullptr)
    kv_bounds<<<batch, 256, 0, stream>>>(bits, bounds, sk, nw);
  return cudaGetLastError();
}

}  // namespace modes
