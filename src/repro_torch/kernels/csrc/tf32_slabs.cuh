// 3xTF32 wgmma over K slabs of 32 for blocks of two warpgroups (256
// threads; both take the A tile's 64 rows, each half of the B tile's
// rows): a slab's operands split into TF32 hi and lo as they are stored,
// in 128-byte swizzled rows of 32 K values, and the 12 products of a slab
// into a fresh float32 sum added on the CUDA cores; with the cp.async and
// shared-memory loads that stage the raw rows. Shared by K4
// (ssd_scan.cu) and its backward (ssd_scan_bwd.cu).
#pragma once

#include <cstdint>

#include "hopper.cuh"

namespace hopper {

constexpr int kRows = 64;      // rows of an A tile (wgmma's M)
constexpr int kSlab = 32;      // K per slab: one 128-byte swizzled row
constexpr int kATile = kRows * 128;

// Bytes of one operand buffer: a slab's A hi, A lo (64 rows) and B hi,
// B lo (nb rows), each row 128 bytes, from a 1024-byte aligned base.
__host__ __device__ constexpr int buf_bytes(int nb) {
  return 2 * kATile + 2 * nb * 128;
}

// Four K values of row r (slab columns 4 c4 .. 4 c4 + 3) into the hi tile
// at ``tile`` and the lo tile at tile + lo_off, swizzled as wgmma reads a
// K-major operand with the 128-byte swizzle.
__device__ __forceinline__ void put4(uint32_t tile, int lo_off, int r, int c4,
                                     float4 v) {
  const uint32_t off = tile + r * 128 + ((c4 ^ (r & 7)) << 4);
  const float4 hi =
      make_float4(to_tf32(v.x), to_tf32(v.y), to_tf32(v.z), to_tf32(v.w));
  asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};" ::"r"(off),
               "f"(hi.x), "f"(hi.y), "f"(hi.z), "f"(hi.w)
               : "memory");
  asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};" ::"r"(off + lo_off),
               "f"(to_tf32(v.x - hi.x)), "f"(to_tf32(v.y - hi.y)),
               "f"(to_tf32(v.z - hi.z)), "f"(to_tf32(v.w - hi.w))
               : "memory");
}

// The 12 products of one slab: lo.hi, hi.lo, hi.hi over its 4 k8 steps
// (32 bytes, 2 descriptor units, each).
template <int NB, int J>
__device__ __forceinline__ void slab_from(float* d, uint64_t ah, uint64_t al,
                                          uint64_t bh, uint64_t bl) {
  if constexpr (J < 12) {
    constexpr int k = 2 * (J % 4);
    WgmmaSS<NB, k, k>::run(d, J < 4 ? al : ah, J >= 4 && J < 8 ? bl : bh);
    slab_from<NB, J + 1>(d, ah, al, bh, bl);
  }
}

// One K slab: D (64 x NB / 2) += A (64 x 32) B_w (NB / 2 x 32)^T in
// 3xTF32, from the buffer at ``buf``, committed as one group; B_w is
// warpgroup w's half of the B tile's rows (a multiple of 8 rows, so it
// starts on the swizzle's 1024-byte period).
template <int NB>
__device__ __forceinline__ void issue_slab(float* d, uint32_t buf) {
  const uint32_t b = buf + 2 * kATile + (threadIdx.x / 128) * (NB / 2) * 128;
  wgmma_fence();
  slab_from<NB / 2, 0>(d, sw128_desc(buf), sw128_desc(buf + kATile),
                       sw128_desc(b), sw128_desc(b + NB * 128));
  wgmma_commit();
}

template <int N>
__device__ __forceinline__ void zero(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = 0.0f;
  fence_regs<N>(d);
}

// Once the last slab's products are done, in every warp: their fresh sum
// added to ``total`` on the CUDA cores, and the buffer free.
template <int NB>
__device__ __forceinline__ void absorb(float* total, float* fresh) {
  wgmma_wait<0>();
  fence_regs<NB / 4>(fresh);
#pragma unroll
  for (int i = 0; i < NB / 4; ++i) total[i] += fresh[i];
}

// After a slab's stores: visible to wgmma (the async proxy), in every
// warp; the previous slab's products, if ``pending``, awaited and added to
// ``total`` (they ran while this slab loaded and stored); this slab's
// products issued into ``fresh``, zeroed here.
template <int NB>
__device__ __forceinline__ void run_slab(float* fresh, float* total,
                                         bool pending, uint32_t buf) {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();
  if (pending) absorb<NB>(total, fresh);
  zero<NB / 4>(fresh);
  issue_slab<NB>(fresh, buf);
}

// A thread's accumulator of a 64 x NB product, NB / 4 floats:
// d[4 j + 2 i + e] is row 16 (warp % 4) + g + 8 i, column (NB / 2) w +
// 8 j + 2 t + e (warpgroup w, g = lane / 4, t = lane % 4).
struct Frag {
  int r0, c0;  // row of i = 0; column of j = 0, e = 0
  __device__ explicit Frag(int nb) {
    const int lane = threadIdx.x % 32;
    r0 = 16 * (threadIdx.x / 32 % 4) + lane / 4;
    c0 = (threadIdx.x / 128) * (nb / 2) + 2 * (lane % 4);
  }
};

// cp.async of 16 or 4 bytes (a byte count under the size zero-fills);
// loads from shared memory by address.
__device__ __forceinline__ void cp16(uint32_t dst, const float* src,
                                     int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp4(uint32_t dst, const float* src,
                                    int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ float4 lds4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}
__device__ __forceinline__ float lds(uint32_t addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];" : "=f"(v) : "r"(addr) : "memory");
  return v;
}

}  // namespace hopper
