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
//   concat        f32 sums of the shifted neighbours' products, in (dy, dx)
//                 order, rounded to bf16 once per step;
//   bf16acc       bf16 taps and a bf16 accumulator, packed two pixels to a
//                 32-bit word: each tap a rounded product and a rounded
//                 sum (mul.rn.bf16x2, add.rn.bf16x2), where the TPU body
//                 rounds;
//   mulonly       concat without the x-shifts (a wrong result: the FMAs
//                 alone);
//   mulonly_bf16  bf16acc without the x-shifts.
//
// Every variant takes a bf16 slab, as the TPU tool gives it; taps are f32
// in device memory.
//
// What bounds it on the card: operations, on the CUDA cores (9 FMAs a
// pixel of the f32 variants, 9 packed products and sums a pair of the bf16
// ones; there is no product for the tensor cores, and the slab is read and
// written once per launch).  The design keeps the issue slots for those:
// * depthwise work is independent per channel, so one CTA takes one
//   channel for all iterations;
// * each thread holds 4 consecutive pixels (the f32 variants: f32 values
//   of the bf16 slab) or one pair (the bf16 variants: a packed word) of
//   every one of the t + 2 rows in registers for the whole launch, so a
//   step reads no memory; rows 0 and 1 never change;
// * a step computes the new rows by blocks of 8 from the last one down,
//   each in place: row y + 2 takes old rows y .. y + 2, and no lower row
//   reads it; a block's 32 (f32) or 8 (bf16) sums are in flight together,
//   their (dy, dx) order kept;
// * the x-neighbours inside a thread's pixels are its own registers; the
//   one beyond each end comes from the next lane by a warp shuffle (2 a
//   row, against 36 FMAs at 4 pixels), and only the pixels at a warp's
//   ends pass through shared memory, one barrier a step (double-buffered,
//   so a step needs no second one); the unshifted variants need neither;
// * pixels past W are held at zero, so the shuffles and the edge slots
//   bring the stencil's zero padding (the slots beyond the first and last
//   warp hold zeros);
// * the bf16 shifted variant keeps, beside each row's pairs, its pairs
//   shifted by one pixel, built once a step with a shift and an or per
//   word, so that each packed product reads whole words.
// At t = 8, W = 512, ch = 128: 128 CTAs, one an SM, of 4 warps (f32) or
// 8 (bf16).  Rows past the slab (t < kMaxT) are computed and never read.
//
// Limits: t <= 16 (rows in registers: kMaxT of 8 or 16) and W up to 2048
// pixels at t <= 8, 1024 above (`probe_stencil_max_width`).

#include "tblock_common.cuh"

#include <string.h>

namespace {

enum { kConcat = 0, kBf16Acc = 1, kMulonly = 2, kMulonlyBf16 = 3 };

// consecutive pixels of a row per thread: 4 in the f32 variants, one pair
// (2) in the bf16 ones, where twice the warps hide the packed ops' latency
constexpr int kCols = 4;
constexpr int kPairs = 1;
constexpr int kBlk = 8;   // new rows whose sums are in flight together
constexpr unsigned kFull = 0xffffffffu;

// the CTA's threads at most for a kernel holding kMaxT + 2 rows of `cols`
// pixels a thread (registers): W up to 2048 at kMaxT = 8, 1024 at 16
__host__ __device__ constexpr int max_threads(int max_t, int cols) {
  return (max_t <= 8 ? 2048 : 1024) / cols;
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

// lo and hi rounded to bf16 (round to nearest even), as f32: one packed
// conversion and two bit operations on the card
__device__ __forceinline__ void round_pair(float& lo, float& hi) {
#ifdef TBLOCK_HOST_BUILD
  lo = to_f(from_f<__nv_bfloat16>(lo));
  hi = to_f(from_f<__nv_bfloat16>(hi));
#else
  uint32_t d;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(d) : "f"(hi), "f"(lo));
  lo = __uint_as_float(d << 16);
  hi = __uint_as_float(d & 0xffff0000u);
#endif
}

// lane src's 32 bits of v (a plain shfl.sync.idx)
__device__ __forceinline__ uint32_t lane_word(uint32_t v, int src) {
  return (uint32_t)__shfl_sync(kFull, (int)v, src);
}

__device__ __forceinline__ float lane_value(float v, int src) {
  uint32_t u;
  memcpy(&u, &v, 4);
  u = lane_word(u, src);
  memcpy(&v, &u, 4);
  return v;
}

__device__ __forceinline__ uint32_t bf16_bits(__nv_bfloat16 h) {
  uint16_t b;
  memcpy(&b, &h, 2);
  return b;
}

__device__ __forceinline__ __nv_bfloat16 bits_bf16(uint32_t b) {
  const uint16_t s = (uint16_t)b;
  __nv_bfloat16 h;
  memcpy(&h, &s, 2);
  return h;
}

// f32 variants: v[r][j] is pixel x0 + j of row r as f32 (a bf16 value).
template <int kV, int kMaxT>
__global__ void __launch_bounds__(max_threads(kMaxT, kCols))
    stencil_f32_kernel(
    const __nv_bfloat16* __restrict__ x, const float* __restrict__ taps,
    __nv_bfloat16* __restrict__ out, int t, int W, int ch, int iters) {
  constexpr int R = kMaxT + 2;
  constexpr bool kShift = kV == kConcat;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int c = blockIdx.x, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5, x0 = threadIdx.x * kCols;
  const bool ragged = x0 + kCols > W;  // holds pixels past W

  float v[R][kCols];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      v[r][j] = r < t + 2 && x0 + j < W
                    ? to_f(x[((size_t)r * W + x0 + j) * ch + c])
                    : 0.f;
  float tf[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) tf[k] = taps[(size_t)k * ch + c];

  // edge[buf][slot][side][row]: slot w + 1 holds warp w's first (side 0)
  // and last (side 1) pixel of each row; slots 0 and nw + 1 stay zero
  float* edge = reinterpret_cast<float*>(smem_raw);
  const int per_buf = (nw + 2) * 2 * R;
  if constexpr (kShift) {
    for (int i = threadIdx.x; i < 2 * per_buf; i += blockDim.x) edge[i] = 0.f;
    __syncthreads();
  }
  float lft[R], rgt[R];  // pixels x0 - 1 and x0 + kCols of each row

  for (int it = 0; it < iters; ++it) {
    if constexpr (kShift) {
      // the neighbours of the rows that changed (all of them at first)
      const int r_lo = it == 0 ? 0 : 2;
      float* eb = edge + (it & 1) * per_buf;
      if (lane == 0 || lane == 31) {
        float* slot = eb + ((warp + 1) * 2 + (lane == 31)) * R;
#pragma unroll
        for (int r = 0; r < R; ++r)
          if (r >= r_lo) slot[r] = lane == 0 ? v[r][0] : v[r][kCols - 1];
      }
      __syncthreads();
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r < r_lo) continue;
        float l = lane_value(v[r][kCols - 1], (lane + 31) & 31);
        float rr = lane_value(v[r][0], (lane + 1) & 31);
        if (lane == 0) l = eb[(warp * 2 + 1) * R + r];
        if (lane == 31) rr = eb[((warp + 2) * 2) * R + r];
        lft[r] = l;
        rgt[r] = rr;
      }
    }
    // new rows by blocks of kBlk from the last down, each block's sums
    // all in flight (32 independent chains) before it is written in place
#pragma unroll
    for (int y0 = kMaxT - kBlk; y0 >= 0; y0 -= kBlk) {
      float a[kBlk][kCols];
#pragma unroll
      for (int y = 0; y < kBlk; ++y)
#pragma unroll
        for (int j = 0; j < kCols; ++j) a[y][j] = 0.f;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int y = 0; y < kBlk; ++y) {
          const int r = y0 + y + dy;
#pragma unroll
          for (int j = 0; j < kCols; ++j) {
            if constexpr (kShift) {
              a[y][j] += (j == 0 ? lft[r] : v[r][j - 1]) * tf[dy * 3];
              a[y][j] += v[r][j] * tf[dy * 3 + 1];
              a[y][j] += (j == kCols - 1 ? rgt[r] : v[r][j + 1]) *
                         tf[dy * 3 + 2];
            } else {
#pragma unroll
              for (int dx = 0; dx < 3; ++dx)
                a[y][j] += v[r][j] * tf[dy * 3 + dx];
            }
          }
        }
#pragma unroll
      for (int y = 0; y < kBlk; ++y) {
#pragma unroll
        for (int j = 0; j < kCols; j += 2) round_pair(a[y][j], a[y][j + 1]);
#pragma unroll
        for (int j = 0; j < kCols; ++j) v[y0 + y + 2][j] = a[y][j];
      }
      if (ragged) {
#pragma unroll
        for (int y = 0; y < kBlk; ++y)
#pragma unroll
          for (int j = 0; j < kCols; ++j)
            if (x0 + j >= W) v[y0 + y + 2][j] = 0.f;
      }
    }
  }

#pragma unroll
  for (int r = 2; r < R; ++r)
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      if (r < t + 2 && x0 + j < W)
        out[((size_t)(r - 2) * W + x0 + j) * ch + c] =
            from_f<__nv_bfloat16>(v[r][j]);
}

// bf16 variants: e[r][p] holds pixels x0 + 2p (low half) and x0 + 2p + 1
// (high half) of row r; bf16acc also o[r][p], pixels x0 + 2p - 1 and
// x0 + 2p, the pairs shifted left by one.
template <int kV, int kMaxT>
__global__ void __launch_bounds__(max_threads(kMaxT, 2 * kPairs))
    stencil_bf16_kernel(
    const __nv_bfloat16* __restrict__ x, const float* __restrict__ taps,
    __nv_bfloat16* __restrict__ out, int t, int W, int ch, int iters) {
  constexpr int R = kMaxT + 2;
  constexpr bool kShift = kV == kBf16Acc;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int c = blockIdx.x, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5, x0 = threadIdx.x * 2 * kPairs;
  const bool ragged = x0 + 2 * kPairs > W;
  // the halves of pixels at or past W
  uint32_t keep[kPairs];
#pragma unroll
  for (int p = 0; p < kPairs; ++p)
    keep[p] = (x0 + 2 * p < W ? 0xffffu : 0u) |
              (x0 + 2 * p + 1 < W ? 0xffff0000u : 0u);

  uint32_t e[R][kPairs];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int p = 0; p < kPairs; ++p) {
      uint32_t w = 0;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int xc = x0 + 2 * p + h;
        if (r < t + 2 && xc < W)
          w |= bf16_bits(x[((size_t)r * W + xc) * ch + c]) << (16 * h);
      }
      e[r][p] = w;
    }
  uint32_t t2[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    const uint32_t b =
        bf16_bits(from_f<__nv_bfloat16>(taps[(size_t)k * ch + c]));
    t2[k] = b | (b << 16);
  }

  uint32_t* edge = reinterpret_cast<uint32_t*>(smem_raw);
  const int per_buf = (nw + 2) * 2 * R;
  if constexpr (kShift) {
    for (int i = threadIdx.x; i < 2 * per_buf; i += blockDim.x) edge[i] = 0u;
    __syncthreads();
  }
  uint32_t o[R][kPairs + 1];

  for (int it = 0; it < iters; ++it) {
    if constexpr (kShift) {
      const int r_lo = it == 0 ? 0 : 2;
      uint32_t* eb = edge + (it & 1) * per_buf;
      if (lane == 0 || lane == 31) {
        uint32_t* slot = eb + ((warp + 1) * 2 + (lane == 31)) * R;
#pragma unroll
        for (int r = 0; r < R; ++r)
          if (r >= r_lo) slot[r] = lane == 0 ? e[r][0] : e[r][kPairs - 1];
      }
      __syncthreads();
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r < r_lo) continue;
        uint32_t lw = lane_word(e[r][kPairs - 1], (lane + 31) & 31);
        uint32_t rw = lane_word(e[r][0], (lane + 1) & 31);
        if (lane == 0) lw = eb[(warp * 2 + 1) * R + r];
        if (lane == 31) rw = eb[((warp + 2) * 2) * R + r];
        o[r][0] = (lw >> 16) | (e[r][0] << 16);
#pragma unroll
        for (int p = 1; p < kPairs; ++p)
          o[r][p] = (e[r][p - 1] >> 16) | (e[r][p] << 16);
        o[r][kPairs] = (e[r][kPairs - 1] >> 16) | (rw << 16);
      }
    }
#pragma unroll
    for (int y0 = kMaxT - kBlk; y0 >= 0; y0 -= kBlk) {
      uint32_t acc[kBlk][kPairs];
#pragma unroll
      for (int y = 0; y < kBlk; ++y)
#pragma unroll
        for (int p = 0; p < kPairs; ++p) acc[y][p] = 0;  // (+0, +0)
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int y = 0; y < kBlk; ++y) {
          const int r = y0 + y + dy;
#pragma unroll
          for (int p = 0; p < kPairs; ++p) {
            const uint32_t op[3] = {kShift ? o[r][p] : e[r][p], e[r][p],
                                    kShift ? o[r][p + 1] : e[r][p]};
#pragma unroll
            for (int dx = 0; dx < 3; ++dx)
              acc[y][p] = bf16x2_add(acc[y][p],
                                     bf16x2_mul(op[dx], t2[dy * 3 + dx]));
          }
        }
#pragma unroll
      for (int y = 0; y < kBlk; ++y)
#pragma unroll
        for (int p = 0; p < kPairs; ++p)
          e[y0 + y + 2][p] = ragged ? acc[y][p] & keep[p] : acc[y][p];
    }
  }

#pragma unroll
  for (int r = 2; r < R; ++r)
#pragma unroll
    for (int p = 0; p < kPairs; ++p)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int xc = x0 + 2 * p + h;
        if (r < t + 2 && xc < W)
          out[((size_t)(r - 2) * W + xc) * ch + c] =
              bits_bf16(e[r][p] >> (16 * h));
      }
}

// rows held in registers for a slab of t output rows (0: too many)
int max_rows(int t) { return t <= 8 ? 8 : t <= 16 ? 16 : 0; }

template <int kV, int kMaxT>
int launch_stencil(const void* x, const void* taps, void* out, int t, int W,
                   int ch, int iters, cudaStream_t stream) {
  constexpr int cols = kV == kConcat || kV == kMulonly ? kCols : 2 * kPairs;
  const int threads = round_up((W + cols - 1) / cols, 32);
  const size_t smem = (size_t)2 * (threads / 32 + 2) * 2 * (kMaxT + 2) * 4;
  const auto* xb = (const __nv_bfloat16*)x;
  const auto* tp = (const float*)taps;
  auto* ob = (__nv_bfloat16*)out;
  if constexpr (kV == kConcat || kV == kMulonly)
    stencil_f32_kernel<kV, kMaxT><<<ch, threads, smem, stream>>>(
        xb, tp, ob, t, W, ch, iters);
  else
    stencil_bf16_kernel<kV, kMaxT><<<ch, threads, smem, stream>>>(
        xb, tp, ob, t, W, ch, iters);
  return (int)cudaGetLastError();
}

template <int kMaxT>
int launch_variant(int variant, const void* x, const void* taps, void* out,
                   int t, int W, int ch, int iters, cudaStream_t s) {
  switch (variant) {
    case kConcat:
      return launch_stencil<kConcat, kMaxT>(x, taps, out, t, W, ch, iters, s);
    case kBf16Acc:
      return launch_stencil<kBf16Acc, kMaxT>(x, taps, out, t, W, ch, iters,
                                             s);
    case kMulonly:
      return launch_stencil<kMulonly, kMaxT>(x, taps, out, t, W, ch, iters,
                                             s);
    default:
      return launch_stencil<kMulonlyBf16, kMaxT>(x, taps, out, t, W, ch,
                                                 iters, s);
  }
}

}  // namespace

extern "C" {

// The widest row the kernel takes for t output rows (0: t too large).
int probe_stencil_max_width(int t) {
  const int rows = t > 0 ? max_rows(t) : 0;
  return rows ? kCols * max_threads(rows, kCols) : 0;
}

// x: (t + 2, W, ch), out: (t, W, ch), both bf16 (is_bf16 must be 1: the
// kernel takes no other slab); taps: (9, ch) f32 in (dy, dx) order;
// variant 0 concat, 1 bf16acc, 2 mulonly, 3 mulonly_bf16; t and W within
// `probe_stencil_max_width`.  Returns a cudaError_t.
int probe_stencil(const void* x, const void* taps, void* out, int t, int W,
                  int ch, int variant, int is_bf16, int iters,
                  void* stream) {
  if (t <= 0 || W <= 0 || ch <= 0 || iters < 0 || variant < 0 ||
      variant > 3 || !is_bf16 || W > probe_stencil_max_width(t))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (max_rows(t) == 8)
    return launch_variant<8>(variant, x, taps, out, t, W, ch, iters, s);
  return launch_variant<16>(variant, x, taps, out, t, W, ch, iters, s);
}

}  // extern "C"
