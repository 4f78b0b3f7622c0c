// Helpers shared by the TransformerBlock kernels (tblock.cu forward,
// tblock_chain.cu cross-block chain, tblock_bwd.cu GDFN-half backward,
// tblock_attn_bwd.cu attention-half backward, wgrad.cu weight-gradient
// products), the module-path kernels (gdfn.cu, mdta.cu) and the NAFBlock
// kernel (nafblock.cu): rounding to the model dtype,
// the per-pixel LayerNorm rows, the masked 3x3 depthwise stencil, and the
// block-level products on the tensor cores (bf16, mma.sync m16n8k16) or in
// f32 FMA loops.
//
// Everything lives in an anonymous namespace: each .cu includes its own
// copy.  The host build of the sources used by the tests
// (tests/cuda_host_shim.h) defines TBLOCK_HOST_BUILD and supplies the CUDA
// subset these helpers use.
#pragma once

#ifndef TBLOCK_HOST_BUILD
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#endif

#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVC = 32;             // v output-channel chunk (pass B)
constexpr int kHC = 32;             // GDFN hidden chunk; hpad % kHC == 0
constexpr int kRP = 4;              // pixel rows per thread, FMA products
constexpr int kRowPad = 16;         // smem GEMM operands hold rows to x16
constexpr int kMaxCph = 192;        // channels per head, forward kernels
constexpr int kMaxCphBwd = 96;      // channels per head, f32 attention bwd
constexpr int kAccPad = 4;          // f32 accumulator row padding
// Restormer's LayerNorm epsilon, the default of the helpers below;
// nafblock.cu passes NAFNet's 1e-6 to them, and bwd_stencil.cu's
// bwd_ln_rows takes its epsilon from the caller
constexpr float kEps = 1e-5f;

__host__ __device__ inline int round_up(int a, int m) {
  return (a + m - 1) / m * m;
}

// Leading dimension of a [rows][n] bf16/f32 GEMM operand in shared memory:
// 8 elements of padding put the 8 rows of an mma fragment load in
// different banks.
__host__ __device__ inline int smem_ld(int n) { return round_up(n, 8) + 8; }

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float v) {
  return __float2bfloat16(v);
}
// value rounded to T and widened back to f32
template <typename T> __device__ __forceinline__ float rnd(float v) {
  return to_f(from_f<T>(v));
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float gelu_erf(float v) {
  return v * 0.5f * (1.0f + erff(v * 0.70710678118654752f));
}

// d gelu_erf / dv = Phi(v) + v * phi(v)
__device__ __forceinline__ float gelu_erf_grad(float v) {
  return 0.5f * (1.0f + erff(v * 0.70710678118654752f)) +
         v * 0.3989422804014327f * expf(-0.5f * v * v);
}

// two adjacent bf16 as one 32-bit word (the address is 4-byte aligned)
__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// d += a . b on the tensor cores: one m16n8k16 bf16 product, f32 sums.
// Fragments as in the PTX ISA (mma.m16n8k16, .bf16).  The host build of
// these sources used by the tests supplies its own warp-level product.
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          const uint32_t (&b)[2]) {
#ifdef TBLOCK_HOST_BUILD
  host_mma_16816(d, a, b);
#else
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
#endif
}

// One-pass LayerNorm moments of one C-wide pixel by one warp (ops/norm.py:
// var = E[x^2] - E[x]^2 clamped at 0).  Every lane gets mu and
// 1 / sqrt(var + eps).
template <typename T>
__device__ void ln_moments(const T* src, int C, int lane, float& mu,
                           float& inv) {
  float s = 0.f, s2 = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float v = to_f(src[c]);
    s += v;
    s2 += v * v;
  }
  s = warp_sum(s);
  s2 = warp_sum(s2);
  mu = s / C;
  const float var = fmaxf(s2 / C - mu * mu, 0.f);
  inv = 1.f / sqrtf(var + kEps);
}

// LayerNorm of one C-wide pixel by one warp, result rounded to T.
template <typename T>
__device__ void ln_pixel(const T* src, T* dst, int C, const float* w,
                         const float* b, bool bias_free, int lane,
                         float eps = kEps) {
  float s = 0.f, s2 = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float v = to_f(src[c]);
    s += v;
    s2 += v * v;
  }
  s = warp_sum(s);
  s2 = warp_sum(s2);
  const float mu = s / C;
  const float var = fmaxf(s2 / C - mu * mu, 0.f);
  const float den = sqrtf(var + eps);
  for (int c = lane; c < C; c += 32) {
    const float v = to_f(src[c]);
    dst[c] = from_f<T>(bias_free ? v / den * w[c]
                                 : (v - mu) / den * w[c] + b[c]);
  }
}

// LN of the rh x rw pixels whose top-left is image pixel (gy0, gx0); pixels
// outside the image are written as zeros.  dst is [rh*rw][ldd].
template <typename T>
__device__ void ln_region(const T* xb, int H, int W, int C, int gy0, int gx0,
                          int rh, int rw, const float* w, const float* b,
                          bool bias_free, T* dst, int ldd, float eps = kEps) {
  const int lane = threadIdx.x & 31;
  for (int p = threadIdx.x >> 5; p < rh * rw; p += blockDim.x >> 5) {
    const int gy = gy0 + p / rw, gx = gx0 + p % rw;
    T* d = dst + (size_t)p * ldd;
    if (gy < 0 || gy >= H || gx < 0 || gx >= W) {
      for (int c = lane; c < C; c += 32) d[c] = from_f<T>(0.f);
    } else {
      ln_pixel(xb + ((size_t)gy * W + gx) * C, d, C, w, b, bias_free, lane,
               eps);
    }
  }
}

// Copy the rh x rw pixels whose top-left is image pixel (gy0, gx0) of a
// (H, W, C) image into dst [rh*rw][ldd]; pixels outside the image are
// zeros (a gradient at a pixel that does not exist).
template <typename T>
__device__ void load_region(const T* src, int H, int W, int C, int gy0,
                            int gx0, int rh, int rw, T* dst, int ldd) {
  for (int idx = threadIdx.x; idx < rh * rw * C; idx += blockDim.x) {
    const int p = idx / C, c = idx % C;
    const int gy = gy0 + p / rw, gx = gx0 + p % rw;
    const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
    dst[(size_t)p * ldd + c] =
        in ? src[((size_t)gy * W + gx) * C + c] : from_f<T>(0.f);
  }
}

// The 3x3 depthwise stencil at one output: the window's top-left is element
// (y, x) of a region `sw` pixels wide, whose pixel p keeps this channel at
// src[p * lds]; tap (dy, dx) is taps[(dy * 3 + dx) * tap_ld].  flip
// applies the transposed stencil (tap (2 - dy, 2 - dx) at window (dy, dx)),
// the backward of the forward stencil.  Sums in f32, taps in (dy, dx)
// order.  Values outside the image must be zeros in src: that is the
// stencil's zero padding.
template <typename T>
__device__ __forceinline__ float stencil3x3(const T* src, int sw, int lds,
                                            int y, int x, const float* taps,
                                            int tap_ld, bool flip) {
  float a = 0.f;
  for (int dy = 0; dy < 3; ++dy)
    for (int dx = 0; dx < 3; ++dx) {
      const int tap = flip ? (2 - dy) * 3 + (2 - dx) : dy * 3 + dx;
      a += to_f(src[((size_t)(y + dy) * sw + x + dx) * lds]) *
           taps[(size_t)tap * tap_ld];
    }
  return a;
}

// The right operand of a product: element (k, n) at p[k * sk + n * sn].
template <typename T>
struct MatB {
  const T* p;
  int sk, sn;
};

// Rows [n0, ...) of outputs and [k0, ...) of inputs of a weight matrix with
// n_total outputs and k_total inputs.  bf16 weights are n-major (each
// output's inputs contiguous, as the tensor-core fragments read them); f32
// weights are k-major (threads on adjacent outputs read adjacent words).
template <typename T>
__device__ MatB<T> weights(const T* w, int n_total, int k_total, int n0,
                           int k0) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    return {w + (size_t)n0 * k_total + k0, 1, k_total};
  else
    return {w + (size_t)k0 * n_total + n0, n_total, 1};
}

// The tensor-core part of `gemm`.  A warp item is a (16 MB) x 8 output
// tile: each B fragment, read from global memory, feeds MB products, so a
// CTA reads the weights through L2 once per 16 MB pixel rows, not per 16.
template <int MB, typename T, typename Store>
__device__ void mma_gemm(const T* A, int lda, int P, int K, MatB<T> B, int N,
                         Store store) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tig = lane & 3;
  const int mt = (P + 16 * MB - 1) / (16 * MB), nt = (N + 7) / 8;
  for (int tile = threadIdx.x >> 5; tile < mt * nt; tile += kWarps) {
    const int m0 = (tile / nt) * 16 * MB, n0 = (tile % nt) * 8;
    // columns past N read the last real column; their sums are dropped
    const int n = n0 + g < N ? n0 + g : N - 1;
    const T* b0 = B.p + (size_t)n * B.sn + tig * 2;
    const T* a0 = A + (size_t)(m0 + g) * lda + tig * 2;
    float d[MB][4];
#pragma unroll
    for (int i = 0; i < MB; ++i) d[i][0] = d[i][1] = d[i][2] = d[i][3] = 0.f;
    for (int k0 = 0; k0 < K; k0 += 16) {
      const uint32_t b[2] = {ld_pair(b0 + k0), ld_pair(b0 + k0 + 8)};
#pragma unroll
      for (int i = 0; i < MB; ++i) {
        if (m0 + 16 * i >= P) break;  // warp-uniform: rows past P unread
        const T* ai = a0 + (size_t)16 * i * lda;
        const uint32_t a[4] = {ld_pair(ai + k0), ld_pair(ai + 8 * lda + k0),
                               ld_pair(ai + k0 + 8),
                               ld_pair(ai + 8 * lda + k0 + 8)};
        mma_16816(d[i], a, b);
      }
    }
    const int c = n0 + tig * 2;
#pragma unroll
    for (int i = 0; i < MB; ++i) {
      const int r = m0 + 16 * i + g;
      if (r < P && c < N) store(r, c, d[i][0]);
      if (r < P && c + 1 < N) store(r, c + 1, d[i][1]);
      if (r + 8 < P && c < N) store(r + 8, c, d[i][2]);
      if (r + 8 < P && c + 1 < N) store(r + 8, c + 1, d[i][3]);
    }
  }
}

// store(p, n, sum_k A[p*lda + k] * B(k, n)) for p < P, n < N, with f32 sums.
// A lives in shared memory with round_up(P, kRowPad) readable rows; results
// of the padding rows are dropped.  Each (p, n) is owned by exactly one
// thread in a call.
//
// bf16 with K % 16 == 0 and B n-major runs on the tensor cores
// (`mma_gemm`): each warp takes (16 MB) x 8 output tiles and issues MB
// mma.m16n8k16 per 16 of K.  Otherwise each thread holds kRP rows of one
// output column in f32 FMA loops.
template <typename T, typename Store>
__device__ void gemm(const T* A, int lda, int P, int K, MatB<T> B, int N,
                     Store store) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (K % 16 == 0 && B.sk == 1) {
      // the tallest warp tile that still gives every warp an item
      const int mt = (P + 15) / 16, nt = (N + 7) / 8;
      if ((mt + 3) / 4 * nt >= kWarps)
        mma_gemm<4>(A, lda, P, K, B, N, store);
      else if ((mt + 1) / 2 * nt >= kWarps)
        mma_gemm<2>(A, lda, P, K, B, N, store);
      else
        mma_gemm<1>(A, lda, P, K, B, N, store);
      return;
    }
  }
  const int groups = (P + kRP - 1) / kRP;
  for (int idx = threadIdx.x; idx < groups * N; idx += blockDim.x) {
    const int n = idx % N, p0 = (idx / N) * kRP;
    float acc[kRP];
#pragma unroll
    for (int r = 0; r < kRP; ++r) acc[r] = 0.f;
    const T* a = A + (size_t)p0 * lda;
    const T* bcol = B.p + (size_t)n * B.sn;
    for (int k = 0; k < K; ++k) {
      const float wv = to_f(bcol[(size_t)k * B.sk]);
#pragma unroll
      for (int r = 0; r < kRP; ++r) acc[r] += to_f(a[r * lda + k]) * wv;
    }
#pragma unroll
    for (int r = 0; r < kRP; ++r)
      if (p0 + r < P) store(p0 + r, n, acc[r]);
  }
}

// LayerNorm backward of one body pixel by one warp (JAX `_ln_bwd_rows`):
// dz is the f32 gradient of the LN output, x the LN input.  Returns nothing;
// writes dst[c] = base[c] + dx[c] rounded to T.  WithBias:
// dx = (dz w - mean(dz w) - zhat mean(dz w zhat)) inv; BiasFree (zhat =
// x inv, the variance still mean-centred):
// dx = (dz w - mean(dz w zhat) (zhat - mu inv)) inv.
template <typename T>
__device__ void ln_bwd_pixel(const T* x, const float* dz, const float* w,
                             float mu, float inv, bool bias_free,
                             const T* base, T* dst, int C, int lane) {
  float m1 = 0.f, m2 = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float xv = to_f(x[c]);
    const float zh = bias_free ? xv * inv : (xv - mu) * inv;
    const float dzh = dz[c] * w[c];
    m1 += dzh;
    m2 += dzh * zh;
  }
  m1 = warp_sum(m1) / C;
  m2 = warp_sum(m2) / C;
  for (int c = lane; c < C; c += 32) {
    const float xv = to_f(x[c]);
    const float zh = bias_free ? xv * inv : (xv - mu) * inv;
    const float dzh = dz[c] * w[c];
    const float dx = bias_free ? (dzh - m2 * (zh - mu * inv)) * inv
                               : (dzh - m1 - zh * m2) * inv;
    dst[c] = from_f<T>(to_f(base[c]) + dx);
  }
}

// Per-CTA partial of the LN parameter gradients over the tile's body
// pixels: dlnw[c] += sum_p dz[p][c] zhat[p][c], dlnb[c] += sum_p dz[p][c],
// one thread per channel, pixels in a fixed order (repeatable sums).
// mu[p], inv[p] are the body pixels' LN moments; in_img(p) says whether
// pixel p of the tile lies in the image.
template <typename T, typename InImg>
__device__ void ln_param_grads(const T* xb, int W, int C, int oy, int ox,
                               int th, int tw, const float* dz, int ldz,
                               const float* mu, const float* inv,
                               bool bias_free, float* dlnw, float* dlnb,
                               InImg in_img) {
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float sw = 0.f, sb = 0.f;
    for (int p = 0; p < th * tw; ++p) {
      if (!in_img(p)) continue;
      const int gy = oy + p / tw, gx = ox + p % tw;
      const float xv = to_f(xb[((size_t)gy * W + gx) * C + c]);
      const float zh = bias_free ? xv * inv[p] : (xv - mu[p]) * inv[p];
      const float d = dz[(size_t)p * ldz + c];
      sw += d * zh;
      sb += d;
    }
    dlnw[c] += sw;
    dlnb[c] += sb;
  }
}

}  // namespace
