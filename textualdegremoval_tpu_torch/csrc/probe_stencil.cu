// Probe of the depthwise 3x3 stencil for Hopper (sm_90a): the row-tile
// stencil (t + 2, W, ch) -> (t, W, ch) iterated in the kernel, in the
// variants of the TPU probe.
//
// Replaces the TPU probe kernel of tools/bench_stencil.py: `make_kernel`
// (:50), called at :109.  The function is the TPU kernel's: `iters` times,
// out = the stencil of hid (taps (9, ch), zero outside the row ends), then
// hid = concat(hid[:2], out) (its feedback, :96-98); the result is
// hid[2:].  Variants (`main`'s four, :143):
//
//   concat        f32 sums of shifted neighbours read from shared memory,
//                 the whole-block kernel's own `stencil3x3`;
//   bf16acc       bf16 taps and a bf16 accumulator, packed two pixels to a
//                 32-bit word: each tap a rounded product and a rounded
//                 sum (mul.rn.bf16x2, add.rn.bf16x2), where the TPU body
//                 rounds;
//   mulonly       concat without the x-shifts (a wrong result: the FMAs
//                 alone, with one read per row);
//   mulonly_bf16  bf16acc without the x-shifts.
//
// Every variant takes a bf16 slab, as the TPU tool gives it; taps are f32
// in device memory.
//
// Depthwise work is independent per channel, so one CTA takes one channel
// and keeps its (t + 2) x W slab resident in shared memory for all
// iterations, twice: one slab is read while the next is written, with one
// barrier between iterations.  A slab row holds two zero columns, the W
// pixels and zero columns to its end, so that every shifted read finds
// the stencil's zero padding in place.  Rows 0 and 1 never change.
//
// What bounds it on the card: operations, on the CUDA cores (9 FMAs a
// pixel on 2 values read once; there is no product for the tensor cores).
// Against that: concat reads 9 values from shared memory per FMA row of
// 9, and a warp's shared-memory load issues at a quarter of its FMA rate;
// the bf16 variants read a word per two pixels and build the shifted
// pairs with two byte permutes per row; one CTA per channel fills 128 of
// the 132 SMs at ch = 128.  Those costs are what the probe measures.

#include "tblock_common.cuh"

#include <string.h>

namespace {

enum { kConcat = 0, kBf16Acc = 1, kMulonly = 2, kMulonlyBf16 = 3 };

// Elements of one slab row: two zero columns, the W pixels (W rounded up to
// even), two zero columns.  Even, so that a row starts on a 32-bit word.
__host__ __device__ inline int slab_ld(int W) { return round_up(W, 2) + 4; }

__host__ __device__ inline size_t stencil_smem_bytes(int t, int W) {
  return (size_t)2 * (t + 2) * slab_ld(W) * sizeof(__nv_bfloat16);
}

// Two bf16 in a 32-bit word, each half rounded once (round to nearest
// even); the host build of the tests supplies its own.
__device__ __forceinline__ uint32_t bf16x2_mul(uint32_t a, uint32_t b) {
#ifdef TBLOCK_HOST_BUILD
  return host_bf16x2_mul(a, b);
#else
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
#endif
}

__device__ __forceinline__ uint32_t bf16x2_add(uint32_t a, uint32_t b) {
#ifdef TBLOCK_HOST_BUILD
  return host_bf16x2_add(a, b);
#else
  uint32_t d;
  asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
#endif
}

// One iteration with f32 sums, one output pixel per thread step: concat
// reads the 3 x 3 window of shifted neighbours (`stencil3x3`), mulonly the
// unshifted pixel of each of the three rows, with every tap of the row.
template <int kV>
__device__ void step_f32(const __nv_bfloat16* src, __nv_bfloat16* dst, int t,
                         int W, int ld, const float (&tf)[9]) {
  for (int y = 0; y < t; ++y)
    for (int x = threadIdx.x; x < W; x += blockDim.x) {
      float a;
      if constexpr (kV == kConcat) {
        a = stencil3x3(src + 1, ld, 1, y, x, tf, 1, false);
      } else {
        a = 0.f;
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          const float v = to_f(src[(y + dy) * ld + x + 2]);
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) a += v * tf[dy * 3 + dx];
        }
      }
      dst[(y + 2) * ld + x + 2] = from_f<__nv_bfloat16>(a);
    }
}

// One iteration in packed bf16, one pair of output pixels (x = 2k, 2k + 1,
// slab columns 2k + 2, 2k + 3, word k + 1) per thread step.  Words k,
// k + 1, k + 2 of a row hold columns 2k ... 2k + 5; the left neighbours
// are columns (2k + 1, 2k + 2), the right ones (2k + 3, 2k + 4).
template <int kV>
__device__ void step_bf16(const uint32_t* src, uint32_t* dst, int t, int W,
                          int lw, const uint32_t (&t2)[9]) {
  const int pairs = (W + 1) / 2;
  for (int y = 0; y < t; ++y)
    for (int k = threadIdx.x; k < pairs; k += blockDim.x) {
      uint32_t acc = 0;  // (+0, +0)
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        const uint32_t* r = src + (y + dy) * lw + k;
        const uint32_t mid = r[1];
        uint32_t op[3] = {mid, mid, mid};
        if constexpr (kV == kBf16Acc) {
          op[0] = (r[0] >> 16) | (mid << 16);
          op[2] = (mid >> 16) | (r[2] << 16);
        }
#pragma unroll
        for (int dx = 0; dx < 3; ++dx)
          acc = bf16x2_add(acc, bf16x2_mul(op[dx], t2[dy * 3 + dx]));
      }
      // an odd W's last pair: its second pixel is the row's zero column
      if (2 * k + 1 >= W) acc &= 0xffffu;
      dst[(y + 2) * lw + k + 1] = acc;
    }
}

template <int kV>
__global__ void __launch_bounds__(kThreads) stencil_kernel(
    const __nv_bfloat16* __restrict__ x, const float* __restrict__ taps,
    __nv_bfloat16* __restrict__ out, int t, int W, int ch, int iters) {
  using T = __nv_bfloat16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int c = blockIdx.x, rows = t + 2, ld = slab_ld(W);
  T* slab[2] = {reinterpret_cast<T*>(smem_raw),
                reinterpret_cast<T*>(smem_raw) + (size_t)rows * ld};

  // both slabs: channel c of x between the zero columns
  for (int idx = threadIdx.x; idx < rows * ld; idx += blockDim.x) {
    const int r = idx / ld, xc = idx % ld - 2;
    T v = from_f<T>(0.f);
    if (xc >= 0 && xc < W) v = x[((size_t)r * W + xc) * ch + c];
    slab[0][idx] = v;
    slab[1][idx] = v;
  }
  float tf[9];
  uint32_t t2[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    tf[k] = taps[(size_t)k * ch + c];
    const __nv_bfloat16 h = from_f<__nv_bfloat16>(tf[k]);
    uint16_t bits;
    memcpy(&bits, &h, 2);
    t2[k] = bits | ((uint32_t)bits << 16);
  }
  __syncthreads();

  int cur = 0;
  for (int it = 0; it < iters; ++it) {
    if constexpr (kV == kConcat || kV == kMulonly)
      step_f32<kV>(slab[cur], slab[cur ^ 1], t, W, ld, tf);
    else
      step_bf16<kV>(reinterpret_cast<const uint32_t*>(slab[cur]),
                    reinterpret_cast<uint32_t*>(slab[cur ^ 1]), t, W, ld / 2,
                    t2);
    __syncthreads();
    cur ^= 1;
  }

  for (int idx = threadIdx.x; idx < t * W; idx += blockDim.x) {
    const int y = idx / W, xc = idx % W;
    out[((size_t)y * W + xc) * ch + c] = slab[cur][(y + 2) * ld + xc + 2];
  }
}

template <int kV>
int launch_stencil(const void* x, const void* taps, void* out, int t, int W,
                   int ch, int iters, cudaStream_t stream) {
  const size_t smem = stencil_smem_bytes(t, W);
  cudaError_t err = cudaFuncSetAttribute(
      stencil_kernel<kV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  stencil_kernel<kV><<<ch, kThreads, smem, stream>>>(
      (const __nv_bfloat16*)x, (const float*)taps, (__nv_bfloat16*)out, t, W,
      ch, iters);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x: (t + 2, W, ch), out: (t, W, ch), both bf16 (is_bf16 must be 1: the
// kernel takes no other slab); taps: (9, ch) f32 in (dy, dx) order;
// variant 0 concat, 1 bf16acc, 2 mulonly, 3 mulonly_bf16.  Returns a
// cudaError_t.
int probe_stencil(const void* x, const void* taps, void* out, int t, int W,
                  int ch, int variant, int is_bf16, int iters,
                  void* stream) {
  if (t <= 0 || W <= 0 || ch <= 0 || iters < 0 || variant < 0 ||
      variant > 3 || !is_bf16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (variant) {
    case kConcat:
      return launch_stencil<kConcat>(x, taps, out, t, W, ch, iters, s);
    case kBf16Acc:
      return launch_stencil<kBf16Acc>(x, taps, out, t, W, ch, iters, s);
    case kMulonly:
      return launch_stencil<kMulonly>(x, taps, out, t, W, ch, iters, s);
    default:
      return launch_stencil<kMulonlyBf16>(x, taps, out, t, W, ch, iters, s);
  }
}

}  // extern "C"
