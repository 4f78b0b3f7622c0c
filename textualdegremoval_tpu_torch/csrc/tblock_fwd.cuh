// The bodies of the TransformerBlock forward, shared by the per-block
// kernel pair (tblock.cu) and the cross-block chain kernel
// (tblock_chain.cu): the shared-memory sizes, the per-head statistics of
// one tile (pass A's work), the GDFN on one region (also the whole of the
// standalone GDFN kernel, gdfn.cu) and the whole block applied to one
// region (pass B's work).  What each computes, and its rounding points, is
// described at the top of tblock.cu.
#pragma once

#include "tblock_common.cuh"

namespace {

// Dynamic shared memory of pass A for a th x tw tile: the head's f32 gram,
// LN1 of the tile plus a 1-pixel halo, one third's 1x1 output there, and q
// and k of the tile, transposed.
__host__ __device__ inline size_t stats_smem_bytes(int C, int cph, int th,
                                                   int tw, int eb) {
  const int p1 = (th + 2) * (tw + 2), tp = th * tw;
  return (size_t)4 * cph * cph +
         (size_t)eb * ((size_t)round_up(p1, kRowPad) * smem_ld(C) +
                       (size_t)round_up(p1 * cph, 8) +
                       2 * (size_t)round_up(cph, kRowPad) *
                           smem_ld(round_up(tp, 16)));
}

// Dynamic shared memory of `apply_region` for a th x tw output region.
__host__ __device__ inline size_t apply_smem_bytes(int C, int th, int tw,
                                                   int eb) {
  const int p2 = (th + 4) * (tw + 4), p1 = (th + 2) * (tw + 2), tp = th * tw;
  const int chunk = p2 * kVC > 2 * p1 * kHC ? p2 * kVC : 2 * p1 * kHC;
  return (size_t)4 * tp * (C + kAccPad) +
         (size_t)eb * ((size_t)round_up(p2, kRowPad) * smem_ld(C) +
                       (size_t)round_up(p1, kRowPad) * smem_ld(C) + chunk +
                       (size_t)round_up(tp, kRowPad) * smem_ld(kHC));
}

// The layout of `apply_smem_bytes` for a th x tw output region.
template <typename T>
struct ApplySmem {
  float* acc;  // [tp][C + kAccPad] f32: the GDFN output
  T* bufA;     // [p2 rows][ldc]: LN1 y, then o, then z = LN2(x1)
  T* bufB;     // [p1 rows][ldc]: v, then x1
  T* chunk;    // v's 1x1 output chunk, or the two GDFN hidden chunks
  T* gate;     // [tp rows][smem_ld(kHC)]
  __device__ ApplySmem(unsigned char* raw, int C, int th, int tw) {
    const int p2 = (th + 4) * (tw + 4), p1 = (th + 2) * (tw + 2);
    const int tp = th * tw, ldc = smem_ld(C);
    acc = reinterpret_cast<float*>(raw);
    bufA = reinterpret_cast<T*>(acc + (size_t)tp * (C + kAccPad));
    bufB = bufA + (size_t)round_up(p2, kRowPad) * ldc;
    chunk = bufB + (size_t)round_up(p1, kRowPad) * ldc;
    gate = chunk + (p2 * kVC > 2 * p1 * kHC ? p2 * kVC : 2 * p1 * kHC);
  }
};

// Pass A's work on one th x tw tile at image pixel (oy, ox), for head hd:
// ys holds LN1 of the tile plus a 1-pixel halo ((th + 2) x (tw + 2)
// pixels, zeros outside the image, leading dimension ldc).  Computes the
// head's q and k 1x1 outputs there (zeroed outside the image: the
// reference zero-pads the qkv tensor), the 3x3 depthwise conv on the
// tile, and adds the head's cph x cph gram to gacc ([c][d], f32).
// add_ssq(j, i, s) receives the tile's square sum s of channel i of
// [q | k] (i < 2 cph), from the thread that owns i; j counts the thread's
// channels (i = threadIdx.x + j blockDim.x), so each channel is summed by
// the same thread in every call.  lin ([p1][cph]), qT and kT ([cph
// rows][ldp], channel-major so that the gram is a product with K =
// pixels; the pixel columns [tp, round_up(tp, 16)) must hold zeros) are
// scratch.  Only pixels of image rows [lo, hi) count toward the gram and
// the square sums (the whole image at lo = 0, hi = H; a row-sharded slab
// passes its own rows, leaving its halo out).  Ends with a barrier.
template <typename T, typename AddSsq>
__device__ void stats_head_tile(const T* ys, int ldc, int oy, int ox, int th,
                                int tw, int H, int W, int C, int cph, int hd,
                                int lo, int hi, const T* wq, const T* wk,
                                const float* dwqk, T* lin, T* qT, T* kT,
                                int ldp, float* gacc, AddSsq add_ssq) {
  const int hw = tw + 2, p1 = (th + 2) * hw, tp = th * tw;
  for (int which = 0; which < 2; ++which) {
    gemm(ys, ldc, p1, C, weights(which == 0 ? wq : wk, C, C, hd * cph, 0),
         cph, [&](int p, int n, float acc) {
           const int gy = oy - 1 + p / hw, gx = ox - 1 + p % hw;
           const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
           lin[p * cph + n] = from_f<T>(in ? acc : 0.f);
         });
    __syncthreads();
    T* dst = which == 0 ? qT : kT;
    const float* taps = dwqk + (size_t)which * 9 * C + hd * cph;
    for (int idx = threadIdx.x; idx < tp * cph; idx += blockDim.x) {
      const int p = idx / cph, n = idx % cph;
      const int py = p / tw, px = p % tw;
      const float acc =
          stencil3x3(lin + n, hw, cph, py, px, taps + n, C, false);
      // pixels of the tile outside the image or the row window add
      // nothing to the sums
      const bool in = oy + py >= lo && oy + py < hi && ox + px < W;
      dst[n * ldp + p] = from_f<T>(in ? acc : 0.f);
    }
    __syncthreads();
  }
  gemm(qT, ldp, cph, round_up(tp, 16), MatB<T>{kT, 1, ldp}, cph,
       [&](int c, int d, float v) { gacc[c * cph + d] += v; });
  for (int i = threadIdx.x, j = 0; i < 2 * cph; i += blockDim.x, ++j) {
    const T* src = (i < cph ? qT : kT) + (i % cph) * ldp;
    float s = 0.f;
    for (int p = 0; p < tp; ++p) {
      const float v = to_f(src[p]);
      s += v * v;
    }
    add_ssq(j, i, s);
  }
  __syncthreads();
}

// The GDFN on the th x tw region whose top-left is image pixel (oy, ox):
// z holds its input on the region plus a 1-pixel halo ((th + 2) x (tw + 2)
// pixels, leading dimension ldz, round_up(p1, kRowPad) readable rows).  In
// kHC-wide hidden chunks (w1 rows [2 c0, 2 c0 + kHC) make the chunk's h1,
// the next kHC rows its h2): the 1x1 to both halves, rounded to T and
// zeroed outside the image (the reference zero-pads the hidden tensor),
// the 3x3 depthwise stencil in f32, gate = gelu_erf(d1) * d2 rounded to T,
// and the 1x1 back, added in f32 to acc[p * lda_acc + n] for region pixel
// p and channel n (the caller zeroes acc).  chunk (2 p1 kHC) and gate
// ([round_up(tp, kRowPad) rows][smem_ld(kHC)]) are scratch.  w1: (2 hpad,
// C), dwg: (18, hpad) f32, w2: (C, hpad) in the `weights` layout.  Ends
// with a barrier.
template <typename T>
__device__ void gdfn_region(const T* z, int ldz, int oy, int ox, int th,
                            int tw, int H, int W, int C, int hpad,
                            const T* w1, const float* dwg, const T* w2,
                            T* chunk, T* gate, float* acc, int lda_acc) {
  const int w1w = tw + 2, p1 = (th + 2) * w1w, tp = th * tw;
  const int ldg = smem_ld(kHC);
  T* h1 = chunk;
  T* h2 = chunk + (size_t)p1 * kHC;
  for (int c0 = 0; c0 < hpad; c0 += kHC) {
    auto masked = [&](int q, float a) {
      const int gy = oy - 1 + q / w1w, gx = ox - 1 + q % w1w;
      return from_f<T>(gy >= 0 && gy < H && gx >= 0 && gx < W ? a : 0.f);
    };
    gemm(z, ldz, p1, C, weights(w1, 2 * hpad, C, 2 * c0, 0), 2 * kHC,
         [&](int q, int n, float a) {
           (n < kHC ? h1 : h2)[q * kHC + n % kHC] = masked(q, a);
         });
    __syncthreads();
    for (int idx = threadIdx.x; idx < tp * kHC; idx += blockDim.x) {
      const int p = idx / kHC, j = idx % kHC;
      const int py = p / tw, px = p % tw;
      const float d1 = stencil3x3(h1 + j, w1w, kHC, py, px, dwg + c0 + j,
                                  hpad, false);
      const float d2 = stencil3x3(h2 + j, w1w, kHC, py, px,
                                  dwg + 9 * hpad + c0 + j, hpad, false);
      gate[p * ldg + j] = from_f<T>(gelu_erf(d1) * d2);
    }
    __syncthreads();
    gemm(gate, ldg, tp, kHC, weights(w2, C, hpad, 0, c0), C,
         [&](int p, int n, float a) { acc[p * lda_acc + n] += a; });
    __syncthreads();
  }
}

// Pass B's work: the whole block applied on the th x tw output region
// whose top-left is image pixel (oy, ox) (it may start outside the
// image).  Reads x on the region plus a 2-pixel halo; every intermediate
// stays in the shared memory laid out by ApplySmem.  For every pixel p of
// the region that lies in the image and every channel n, calls
// emit(p, gy, gx, n, x1, out) with x1 = x + proj(attention) and the
// block's output, both rounded to T; x1 is read from s.bufB and s.bufA is
// free by then (emit may write it).  attn: this image's (heads, cph, cph)
// softmaxed attention, [c][d] per head.  Ends without a barrier.
template <typename T, typename Emit>
__device__ void apply_region(
    const T* xb, int H, int W, int C, int heads, int hpad, bool bf, int oy,
    int ox, int th, int tw, const float* ln1w, const float* ln1b,
    const T* wv, const float* dwv, const T* ab, const T* wproj,
    const float* ln2w, const float* ln2b, const T* w1, const float* dwg,
    const T* w2, const ApplySmem<T>& s, Emit emit) {
  const int cph = C / heads;
  const int w2w = tw + 4, p2 = (th + 4) * w2w;  // 2-pixel halo region
  const int w1w = tw + 2, p1 = (th + 2) * w1w;  // 1-pixel halo region
  const int tp = th * tw;
  const int ldc = smem_ld(C), lda_acc = C + kAccPad;
  float* acc = s.acc;
  T* bufA = s.bufA;
  T* bufB = s.bufB;
  T* chunk = s.chunk;
  T* gate = s.gate;

  auto in_image = [&](int gy, int gx) {
    return gy >= 0 && gy < H && gx >= 0 && gx < W;
  };

  // 1. LN1 on the 2-pixel-halo region
  ln_region(xb, H, W, C, oy - 2, ox - 2, th + 4, w2w, ln1w, ln1b, bf, bufA,
            ldc);
  __syncthreads();

  // 2. v = dw3x3(mask(y . Wv)) on the 1-pixel-halo region, kVC channels at
  //    a time
  for (int n0 = 0; n0 < C; n0 += kVC) {
    const int nc = C - n0 < kVC ? C - n0 : kVC;
    gemm(bufA, ldc, p2, C, weights(wv, C, C, n0, 0), nc,
         [&](int p, int n, float a) {
           const bool in = in_image(oy - 2 + p / w2w, ox - 2 + p % w2w);
           chunk[p * kVC + n] = from_f<T>(in ? a : 0.f);
         });
    __syncthreads();
    for (int idx = threadIdx.x; idx < p1 * nc; idx += blockDim.x) {
      const int q = idx / nc, n = idx % nc;
      const int qy = q / w1w, qx = q % w1w;
      const float a = stencil3x3(chunk + n, w2w, kVC, qy, qx, dwv + n0 + n, C,
                                 false);
      bufB[(size_t)q * ldc + n0 + n] = from_f<T>(a);
    }
    __syncthreads();
  }

  // 3. o = v . A_head^T per head (the block-diagonal attention); attn[h] is
  //    [c][d], the n-major weight layout of this product
  for (int hd = 0; hd < heads; ++hd)
    gemm(bufB + hd * cph, ldc, p1, cph,
         MatB<T>{ab + (size_t)hd * cph * cph, 1, cph}, cph,
         [&](int q, int n, float a) {
           bufA[(size_t)q * ldc + hd * cph + n] = from_f<T>(a);
         });
  __syncthreads();

  // 4. x1 = x + proj(o) on the 1-pixel-halo region (0 outside the image)
  gemm(bufA, ldc, p1, C, weights(wproj, C, C, 0, 0), C,
       [&](int q, int n, float a) {
    const int gy = oy - 1 + q / w1w, gx = ox - 1 + q % w1w;
    float v = 0.f;
    if (in_image(gy, gx))
      v = to_f(xb[((size_t)gy * W + gx) * C + n]) + rnd<T>(a);
    bufB[(size_t)q * ldc + n] = from_f<T>(v);
  });
  __syncthreads();

  // 5. z = LN2(x1); zero the f32 accumulator of the GDFN output
  {
    const int lane = threadIdx.x & 31;
    for (int q = threadIdx.x >> 5; q < p1; q += blockDim.x >> 5)
      ln_pixel(bufB + (size_t)q * ldc, bufA + (size_t)q * ldc, C, ln2w, ln2b,
               bf, lane);
    for (int i = threadIdx.x; i < tp * lda_acc; i += blockDim.x) acc[i] = 0.f;
  }
  __syncthreads();

  // 6. the GDFN of z, accumulated into acc
  gdfn_region(bufA, ldc, oy, ox, th, tw, H, W, C, hpad, w1, dwg, w2, chunk,
              gate, acc, lda_acc);

  // 7. out = x1 + acc on the region
  for (int idx = threadIdx.x; idx < tp * C; idx += blockDim.x) {
    const int p = idx / C, n = idx % C;
    const int py = p / tw, px = p % tw;
    const int gy = oy + py, gx = ox + px;
    if (in_image(gy, gx)) {
      const T x1 = bufB[((size_t)(py + 1) * w1w + px + 1) * ldc + n];
      emit(p, gy, gx, n, x1,
           from_f<T>(to_f(x1) + rnd<T>(acc[p * lda_acc + n])));
    }
  }
}

}  // namespace
