// The 16-byte-run stores of the bf16 kernels' epilogues (bwd_gemm.cu,
// probe_qkv_tma.cu): a wgmma accumulator holds, per lane and 8-column
// group j, two adjacent columns of two rows; a quad's 4 lanes trade their
// rounded words so that each lane holds 8 consecutive columns of a row and
// stores them as one 16-byte word.
//
// Everything lives in an anonymous namespace: each .cu includes its own
// copy.
#pragma once

#include <string.h>

#include "tblock_common.cuh"

namespace {

// two f32 rounded to bf16 as one word (lo in bits 0-15)
__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  const __nv_bfloat16 a = from_f<__nv_bfloat16>(lo);
  const __nv_bfloat16 b = from_f<__nv_bfloat16>(hi);
  return (uint32_t)*reinterpret_cast<const unsigned short*>(&a) |
         ((uint32_t)*reinterpret_cast<const unsigned short*>(&b) << 16);
}

// 16 bytes of an output row, loaded and stored as one word
struct alignas(16) Run16 {
  uint32_t w[4];
};

__device__ __forceinline__ float f32_of(uint32_t bits) {
  float v;
  memcpy(&v, &bits, 4);
  return v;
}
__device__ __forceinline__ uint32_t bits_of(float v) {
  uint32_t bits;
  memcpy(&bits, &v, 4);
  return bits;
}
// value e of a run of 8 bf16 as f32 (a bf16 is the upper half of its f32)
__device__ __forceinline__ float bf16_at(const Run16& q, int e) {
  return f32_of(e & 1 ? q.w[e / 2] & 0xffff0000u : q.w[e / 2] << 16);
}

// A quad's 4 lanes trade words: wv[t] is this lane's word of j = 4 j4 + t,
// tw[s] comes back as lane s's word of j = 4 j4 + tig, so that each lane
// holds 8 consecutive columns of a row
__device__ __forceinline__ void quad_transpose(const uint32_t (&wv)[4],
                                               uint32_t (&tw)[4], int tig) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int s = tig ^ k;
    const uint32_t got = __shfl_xor_sync(
        0xffffffffu, s == 0 ? wv[0] : s == 1 ? wv[1] : s == 2 ? wv[2] : wv[3],
        k);
    if (s == 0) tw[0] = got;
    else if (s == 1) tw[1] = got;
    else if (s == 2) tw[2] = got;
    else tw[3] = got;
  }
}

}  // namespace
