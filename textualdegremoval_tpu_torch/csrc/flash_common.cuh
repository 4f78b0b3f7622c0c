// Helpers shared by the flash self-attention kernels (flash_attn.cu
// forward, flash_attn_bwd.cu backward): the CTA shape, bf16 fragment
// packing for mma.sync, and the staging of 64 rows of one head into
// shared memory.  Everything lives in an anonymous namespace: each .cu
// includes its own copy.
#pragma once

#include "tblock_common.cuh"

namespace {

constexpr int kFaThreads = 128;  // 4 warps
constexpr int kFaRows = 64;      // query rows per CTA, 16 per warp
constexpr int kFaKeys = 64;      // keys per staged tile
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// 16 bytes moved as one (a 128-bit load or store on the card)
struct alignas(16) Vec16 {
  uint32_t w[4];
};

__device__ __forceinline__ uint32_t bits16(__nv_bfloat16 v) {
  return *reinterpret_cast<const unsigned short*>(&v);
}

// two bf16 at unrelated addresses as one mma fragment word (lo in bits 0-15)
__device__ __forceinline__ uint32_t pack_pair(const __nv_bfloat16* lo,
                                              const __nv_bfloat16* hi) {
  return bits16(*lo) | (bits16(*hi) << 16);
}

// two f32 rounded to bf16 as one mma fragment word
__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  return bits16(__float2bfloat16(lo)) | (bits16(__float2bfloat16(hi)) << 16);
}

// Stage rows [row0, row0 + 64) of one head (D wide) into dst[64][ldd],
// rows at or past N as zeros.  16-byte loads from global memory; the
// stores are 16-byte too when ldd keeps rows 16-byte aligned (kVecStore).
template <typename T, int D, bool kVecStore>
__device__ void stage_rows(T* dst, int ldd, const T* src, long long sn,
                           int row0, int N) {
  constexpr int kPer = 16 / sizeof(T);
  constexpr int kVecs = D / kPer;
  for (int idx = threadIdx.x; idx < kFaRows * kVecs; idx += kFaThreads) {
    const int r = idx / kVecs, c = (idx % kVecs) * kPer;
    Vec16 val = {{0u, 0u, 0u, 0u}};
    if (row0 + r < N)
      val = *reinterpret_cast<const Vec16*>(src + (row0 + r) * sn + c);
    if constexpr (kVecStore) {
      *reinterpret_cast<Vec16*>(dst + (size_t)r * ldd + c) = val;
    } else {
      const T* e = reinterpret_cast<const T*>(&val);
#pragma unroll
      for (int i = 0; i < kPer; ++i) dst[(size_t)r * ldd + c + i] = e[i];
    }
  }
}

}  // namespace
