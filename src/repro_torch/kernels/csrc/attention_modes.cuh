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
// probs_bf16 (attn_probs_bf16): the normalised probabilities P and V
//   rounded to bfloat16, their product summed in float32. A bfloat16 value
//   is exact in TF32, so the kernels keep their TF32 wgmma path with the
//   rounded value as the hi part: the forward's P.V is the one product
//   P_hi V_hi; the backward keeps its three-product shape with zero lo
//   parts, whose products add exact zeros.
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

inline cudaError_t launch_pack(const uint8_t* kv, uint32_t* bits, int batch,
                               int sk, cudaStream_t stream) {
  const int nw = mask_words(sk);
  pack_kv_bits<<<dim3((nw + 7) / 8, batch), 256, 0, stream>>>(kv, bits, sk,
                                                             nw);
  return cudaGetLastError();
}

}  // namespace modes
