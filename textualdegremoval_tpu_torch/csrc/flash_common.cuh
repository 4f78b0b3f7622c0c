// Helpers shared by the flash self-attention kernels (flash_attn.cu
// forward, flash_attn_bwd.cu backward): the float32 kernels' CTA shape and
// their staging of 64 rows of one head into shared memory; for the bf16
// kernels the mbarriers of their TMA ring, exp2 and the rounding of f32
// pairs to the bf16 A registers of a product.  Everything lives in an
// anonymous namespace: each .cu includes its own copy.
#pragma once

#include "hopper.cuh"
#include "tblock_common.cuh"

namespace {

constexpr int kFaThreads = 128;  // 4 warps (float32 kernels)
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

// two f32 rounded to bf16 as one fragment word (lo in bits 0-15), one
// cvt on the card
__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
#ifdef TBLOCK_HOST_BUILD
  return bits16(__float2bfloat16(lo)) | (bits16(__float2bfloat16(hi)) << 16);
#else
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
#endif
}

// 2^x on the special-function unit, subnormal results flushed to zero
// (ex2.approx.ftz; exp2f adds a range fix-up around the same instruction):
// the bf16 kernels' probabilities, whose subnormal tail rounds away in
// bf16 anyway
__device__ __forceinline__ float fast_exp2(float x) {
#ifdef TBLOCK_HOST_BUILD
  return exp2f(x);
#else
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
#endif
}

// The mbarriers of a bf16 kernel's CTA (two consumer warpgroups, one
// producer warp), at `bars` in shared memory: full[S] (`full_count`
// arrivals and the stage's bytes), empty[S] (the 8 consumer warps) and res
// (the tiles loaded once); initialised by thread 0 before a __syncthreads.
template <int S>
struct Ring {
  uint64_t *full, *empty, *res;
  __device__ Ring(unsigned char* bars, int full_count)
      : full(reinterpret_cast<uint64_t*>(bars)), empty(full + S),
        res(empty + S) {
    if (threadIdx.x == 0) {
      for (int s = 0; s < S; ++s) {
        mbar_init(full + s, full_count);
        mbar_init(empty + s, 8);
      }
      mbar_init(res, 1);
      mbar_init_fence();
    }
    __syncthreads();
  }
};

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
