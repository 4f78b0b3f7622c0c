// Backward of the attention half of the Restormer TransformerBlock for
// Hopper (sm_90a):
//
//   x1 = x + proj(o),  o = v . A^T per head,  A = softmax(tau qn k^T kn)
//   (q, k, v) = dw3x3(mask(LN1(x) . Wqkv))
//
// Replaces the two TPU kernels of
// textualdegremoval_tpu/ops/pallas/tblock_attn_bwd.py (wrapper
// `attn_half_bwd`): pass 1 `_make_attn_bwd_stats_kernel` and pass 2
// `_make_attn_bwd_apply_kernel`.  The glue between them (`_attn_bwd_glue`:
// softmax, temperature and L2-norm backward on the per-head cph x cph
// statistics) is plain torch in the wrapper, ops/pallas/tblock_attn_bwd.py,
// as it was plain XLA.
//
// Both passes here are float32 only, the parity path; bf16 runs the passes
// laid out at the top of bwd_stencil.cu.  Neither holds the whole C on a
// halo beyond pass 1's LN1 rows, so both take any cph up to kMaxCph (192,
// PromptIR's noise blocks have 176) at C up to 704 on a 4 x 4 tile.
//
// Pass 1 (attn_bwd_stats_kernel): one CTA per output tile.  LN1 of x on
// the tile plus a 1-pixel halo (y, zero outside the image); for each third
// of q | k | v, kVC channels at a time, lin = y . W on the halo (zero
// outside the image) and its dwconv on the tile; then o = v . A^T per head
// and do = dx1 . Wproj^T (dx1 loaded into y's rows, which are no longer
// read).  Each is rounded to the model dtype as on the TPU.  It writes y,
// lin, q | k | v, o and do of the tile's pixels to scratch: pass 2 reads
// them on its halo instead of recomputing them there.  The per-head
// dA = do^T v and dWproj = o^T dx1 are sums over every pixel; wgrad.cu
// reduces them.
//
// Pass 2 (attn_bwd_apply_kernel): one CTA per (tile split, image) walks a
// fixed, strided list of tiles.  For each tile and head, one cph-wide
// operand at a time on the 1-pixel halo (zero outside the image), read
// from pass 1's scratch:
//   dq = k . M^T + q Dq and dk = q . M + k Dk (M, Dq, Dk from the glue);
//   dv = do . A;
// each third's gradient dth (f32, zero outside the image) gives the tap
// gradients against that third's lin on the 1-pixel halo, dlin = the
// flipped stencil of dth rounded to the model dtype
// (tblock_attn_bwd.py:240-256), and dy += dlin . W^T in f32.  Last, the
// LN1 backward writes dx = dx1 + LN1-bwd(dy).  Its shared memory is the
// tile's dy (tile x C, f32) and four head-wide buffers, so it grows with C
// only on the tile's own pixels.
//
// The reductions over pixels: the 27 x C tap gradients and the LN1
// parameter gradients are per-CTA partials summed by the wrapper in a
// fixed order; dWqkv = y^T dlin goes through scratch (y from pass 1, dlin
// of the body pixels) and wgrad.cu.  No float atomics anywhere: the result
// is bitwise repeatable.
//
// What bounds it on the card: the 1x1 products of pass 1 over the 1-pixel
// halo (the whole of y . Wqkv, 2.25 times the tile's own at 4 x 4), K = cph
// products for the attention terms, and the stencils on the CUDA cores; the
// scratch traffic (y, lin, q | k | v, do: 8 C values per pixel written and
// read again) is small beside those FMA loops.

#include "tblock_common.cuh"

namespace {

size_t attn_stats_smem_bytes(int C, int th, int tw, int eb) {
  const int p1 = (th + 2) * (tw + 2), tp = th * tw;
  return (size_t)eb * ((size_t)round_up(p1, kRowPad) * smem_ld(C) +
                       (size_t)p1 * kVC +
                       (size_t)round_up(tp, kRowPad) * smem_ld(C));
}

size_t attn_apply_smem_bytes(int C, int cph, int th, int tw, int eb) {
  const int p1 = (th + 2) * (tw + 2), tp = th * tw;
  const int ldh = smem_ld(cph);
  return (size_t)4 * ((size_t)tp * (C + kAccPad) + (size_t)p1 * cph + 2 * tp +
                      2 * C) +
         (size_t)eb * ((size_t)p1 * cph +
                       (size_t)round_up(p1, kRowPad) * ldh +
                       (size_t)round_up(tp, kRowPad) * ldh);
}

// ---------------------------------------------------------------------------
// Pass 1: y, lin, q | k | v, o and do of the tile, to scratch
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads) attn_bwd_stats_kernel(
    const T* __restrict__ x, const T* __restrict__ dx1,
    const float* __restrict__ ln1w, const float* __restrict__ ln1b,
    const T* __restrict__ wq, const T* __restrict__ wk,
    const T* __restrict__ wv, const float* __restrict__ dwall,
    const T* __restrict__ attn, const T* __restrict__ wprojt,
    T* __restrict__ ys, T* __restrict__ lins, T* __restrict__ qkv,
    T* __restrict__ os, T* __restrict__ dos, int H, int W, int C, int heads,
    int bias_free, int th, int tw) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int cph = C / heads;
  const int b = blockIdx.z, oy = blockIdx.y * th, ox = blockIdx.x * tw;
  const int w1w = tw + 2, p1 = (th + 2) * w1w, tp = th * tw;
  const int ldc = smem_ld(C);

  T* yb = reinterpret_cast<T*>(smem_raw);              // [p1 rows][ldc]
  T* lin = yb + (size_t)round_up(p1, kRowPad) * ldc;   // [p1][kVC]
  T* vb = lin + (size_t)p1 * kVC;                      // [tp rows][ldc]
  T* gb = yb;  // dx1 of the tile, [tp rows][ldc], once y is spent

  const size_t img = (size_t)b * H * W * C;
  auto in_image = [&](int gy, int gx) {
    return gy >= 0 && gy < H && gx >= 0 && gx < W;
  };
  auto body_in = [&](int p) { return in_image(oy + p / tw, ox + p % tw); };
  auto pix = [&](int p) {
    return ((size_t)b * H + oy + p / tw) * W + ox + p % tw;
  };
  // pixel p of the tile in the halo's frame
  auto halo = [&](int p) { return (p / tw + 1) * w1w + p % tw + 1; };

  ln_region(x + img, H, W, C, oy - 1, ox - 1, th + 2, w1w, ln1w, ln1b,
            bias_free != 0, yb, ldc);
  __syncthreads();
  // y of the body pixels feeds dWqkv = y^T dlin (wgrad.cu)
  for (int idx = threadIdx.x; idx < tp * C; idx += blockDim.x) {
    const int p = idx / C, c = idx % C;
    if (body_in(p)) ys[pix(p) * C + c] = yb[(size_t)halo(p) * ldc + c];
  }

  // each third: lin = mask(y . W) on the halo, its dwconv on the tile,
  // kVC channels at a time
  const T* w3[3] = {wq, wk, wv};
  for (int which = 0; which < 3; ++which) {
    for (int n0 = 0; n0 < C; n0 += kVC) {
      const int nc = C - n0 < kVC ? C - n0 : kVC;
      gemm(yb, ldc, p1, C, weights(w3[which], C, C, n0, 0), nc,
           [&](int q, int n, float a) {
             const bool in = in_image(oy - 1 + q / w1w, ox - 1 + q % w1w);
             lin[q * kVC + n] = from_f<T>(in ? a : 0.f);
           });
      __syncthreads();
      const size_t col = (size_t)which * C + n0;
      for (int idx = threadIdx.x; idx < tp * nc; idx += blockDim.x) {
        const int p = idx / nc, n = idx % nc;
        const T v = from_f<T>(
            stencil3x3(lin + n, w1w, kVC, p / tw, p % tw,
                       dwall + (size_t)which * 9 * C + n0 + n, C, false));
        if (which == 2) vb[(size_t)p * ldc + n0 + n] = v;
        if (body_in(p)) {
          lins[pix(p) * 3 * C + col + n] = lin[halo(p) * kVC + n];
          qkv[pix(p) * 3 * C + col + n] = v;
        }
      }
      __syncthreads();
    }
  }

  // o = v . A_head^T per head; do = dx1 . Wproj^T
  const T* ab = attn + (size_t)b * heads * cph * cph;
  for (int hd = 0; hd < heads; ++hd)
    gemm(vb + hd * cph, ldc, tp, cph,
         MatB<T>{ab + (size_t)hd * cph * cph, 1, cph}, cph,
         [&](int p, int n, float a) {
           if (body_in(p)) os[pix(p) * C + hd * cph + n] = from_f<T>(a);
         });
  load_region(dx1 + img, H, W, C, oy, ox, th, tw, gb, ldc);
  __syncthreads();
  gemm(gb, ldc, tp, C, weights(wprojt, C, C, 0, 0), C,
       [&](int p, int n, float a) {
         if (body_in(p)) dos[pix(p) * C + n] = from_f<T>(a);
       });
}

// ---------------------------------------------------------------------------
// Pass 2: dx and dlin to scratch, tap and LN1 partials
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads) attn_bwd_apply_kernel(
    const T* __restrict__ x, const T* __restrict__ dx1,
    const float* __restrict__ ln1w, const T* __restrict__ qkv,
    const T* __restrict__ lins, const T* __restrict__ dos,
    const T* __restrict__ wqt, const T* __restrict__ wkt,
    const T* __restrict__ wvt, const float* __restrict__ dwall,
    const T* __restrict__ m, const T* __restrict__ mt,
    const T* __restrict__ at, const float* __restrict__ dqd,
    const float* __restrict__ dkd, T* __restrict__ dx,
    T* __restrict__ dlins, float* __restrict__ dtap_part,
    float* __restrict__ dln_part, int H, int W, int C, int heads,
    int bias_free, int th, int tw) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int cph = C / heads;
  const int split = blockIdx.x, nsplit = gridDim.x, b = blockIdx.y;
  const int w1w = tw + 2, p1 = (th + 2) * w1w;
  const int tp = th * tw;
  const int ldh = smem_ld(cph), lda_acc = C + kAccPad;
  const int ntx = (W + tw - 1) / tw, ntiles = ((H + th - 1) / th) * ntx;
  const bool bf = bias_free != 0;
  const int lane = threadIdx.x & 31;

  float* dy = reinterpret_cast<float*>(smem_raw);  // [tp][lda_acc]
  float* dth = dy + (size_t)tp * lda_acc;          // [p1][cph]
  float* mu = dth + (size_t)p1 * cph;              // [tp]
  float* inv = mu + tp;                            // [tp]
  float* dlnw = inv + tp;                          // [C]
  float* dlnb = dlnw + C;                          // [C]
  T* la = reinterpret_cast<T*>(dlnb + C);          // [p1][cph]
  T* ab = la + (size_t)p1 * cph;                   // [p1 rows][ldh]
  T* dl = ab + (size_t)round_up(p1, kRowPad) * ldh;  // [tp rows][ldh]

  // this CTA's slab of the tap-gradient partials: rows 0-8 q, 9-17 k,
  // 18-26 v
  float* dtap = dtap_part + ((size_t)b * nsplit + split) * 27 * C;
  for (int i = threadIdx.x; i < 27 * C; i += blockDim.x) dtap[i] = 0.f;
  for (int c = threadIdx.x; c < C; c += blockDim.x) dlnw[c] = dlnb[c] = 0.f;

  const size_t img = (size_t)b * H * W * C;
  const T* xb = x + img;
  const size_t bh = (size_t)b * heads;
  for (int t = split; t < ntiles; t += nsplit) {
    const int oy = (t / ntx) * th, ox = (t % ntx) * tw;
    auto in_image = [&](int gy, int gx) {
      return gy >= 0 && gy < H && gx >= 0 && gx < W;
    };
    auto in_p1 = [&](int q) {
      return in_image(oy - 1 + q / w1w, ox - 1 + q % w1w);
    };
    auto body_in = [&](int p) { return in_image(oy + p / tw, ox + p % tw); };
    auto pix = [&](int p) {
      return ((size_t)b * H + oy + p / tw) * W + ox + p % tw;
    };
    // halo pixel q's row of a (B H W, ld) scratch (q in the image)
    auto row1 = [&](int q) {
      return ((size_t)b * H + oy - 1 + q / w1w) * W + ox - 1 + q % w1w;
    };
    // columns [col, col + cph) of a (B H W, ld) scratch on the 1-pixel
    // halo into dst [p1][ldd], zeros outside the image
    auto load_halo = [&](const T* src, int ld, int col, T* dst, int ldd) {
      for (int idx = threadIdx.x; idx < p1 * cph; idx += blockDim.x) {
        const int q = idx / cph, n = idx % cph;
        dst[(size_t)q * ldd + n] =
            in_p1(q) ? src[row1(q) * ld + col + n] : from_f<T>(0.f);
      }
    };

    // the body pixels' LN1 moments; zero the dy accumulator
    for (int p = threadIdx.x >> 5; p < tp; p += kWarps) {
      float mv = 0.f, iv = 0.f;
      if (body_in(p))
        ln_moments(xb + ((size_t)(oy + p / tw) * W + ox + p % tw) * C, C,
                   lane, mv, iv);
      if (lane == 0) {
        mu[p] = mv;
        inv[p] = iv;
      }
    }
    for (int i = threadIdx.x; i < tp * lda_acc; i += blockDim.x) dy[i] = 0.f;

    // one third's backward from its gradient dth (f32, zero outside the
    // image, on the 1-pixel halo): tap gradients against the third's 1x1
    // output lin (1-pixel halo), dlin on the body rounded to T (scratch and
    // smem), dy += dlin . W^T
    auto third = [&](int which, const T* wt, int hd) {
      load_halo(lins, 3 * C, which * C + hd * cph, la, cph);
      __syncthreads();
      const float* taps = dwall + (size_t)which * 9 * C + hd * cph;
      for (int idx = threadIdx.x; idx < 9 * cph; idx += blockDim.x) {
        const int tap = idx / cph, n = idx % cph;
        const int ty = tap / 3, tx = tap % 3;
        float s = 0.f;
        for (int p = 0; p < tp; ++p) {
          const int py = p / tw, px = p % tw;
          s += to_f(la[((size_t)(py + ty) * w1w + px + tx) * cph + n]) *
               dth[((py + 1) * w1w + px + 1) * cph + n];
        }
        dtap[(size_t)(which * 9 + tap) * C + hd * cph + n] += s;
      }
      for (int idx = threadIdx.x; idx < tp * cph; idx += blockDim.x) {
        const int p = idx / cph, n = idx % cph;
        const int py = p / tw, px = p % tw;
        float a = 0.f;
        for (int ty = 0; ty < 3; ++ty)
          for (int tx = 0; tx < 3; ++tx)
            a += rnd<T>(dth[((py + 2 - ty) * w1w + px + 2 - tx) * cph + n]) *
                 taps[(size_t)(ty * 3 + tx) * C + n];
        const T v = from_f<T>(a);
        dl[(size_t)p * ldh + n] = v;
        if (body_in(p))
          dlins[pix(p) * 3 * C + (size_t)which * C + hd * cph + n] = v;
      }
      __syncthreads();
      gemm(dl, ldh, tp, cph, weights(wt, C, C, 0, hd * cph), C,
           [&](int p, int n, float a) { dy[p * lda_acc + n] += a; });
      __syncthreads();
    };

    for (int hd = 0; hd < heads; ++hd) {
      const size_t mo = (bh + hd) * cph * cph;
      const int cq = hd * cph, ck = C + hd * cph;  // q and k columns
      // dq = k . M^T + q Dq
      load_halo(qkv, 3 * C, ck, ab, ldh);
      __syncthreads();
      gemm(ab, ldh, p1, cph, MatB<T>{m + mo, 1, cph}, cph,
           [&](int q, int n, float a) {
             dth[q * cph + n] =
                 in_p1(q) ? a + to_f(qkv[row1(q) * 3 * C + cq + n]) *
                                    dqd[(size_t)b * C + cq + n]
                          : 0.f;
           });
      __syncthreads();
      third(0, wqt, hd);

      // dk = q . M + k Dk
      load_halo(qkv, 3 * C, cq, ab, ldh);
      __syncthreads();
      gemm(ab, ldh, p1, cph, MatB<T>{mt + mo, 1, cph}, cph,
           [&](int q, int n, float a) {
             dth[q * cph + n] =
                 in_p1(q) ? a + to_f(qkv[row1(q) * 3 * C + ck + n]) *
                                    dkd[(size_t)b * C + cq + n]
                          : 0.f;
           });
      __syncthreads();
      third(1, wkt, hd);

      // dv = do . A
      load_halo(dos, C, cq, ab, ldh);
      __syncthreads();
      gemm(ab, ldh, p1, cph, MatB<T>{at + mo, 1, cph}, cph,
           [&](int q, int n, float a) {
             dth[q * cph + n] = in_p1(q) ? a : 0.f;
           });
      __syncthreads();
      third(2, wvt, hd);
    }

    // LN1 parameter gradients (per-CTA partials) and dx = dx1 + LN1-bwd
    ln_param_grads(xb, W, C, oy, ox, th, tw, dy, lda_acc, mu, inv, bf, dlnw,
                   dlnb, body_in);
    for (int p = threadIdx.x >> 5; p < tp; p += kWarps) {
      if (!body_in(p)) continue;
      const size_t o = pix(p) * C;
      ln_bwd_pixel(x + o, dy + (size_t)p * lda_acc, ln1w, mu[p], inv[p], bf,
                   dx1 + o, dx + o, C, lane);
    }
    __syncthreads();
  }
  float* dlp = dln_part + ((size_t)b * nsplit + split) * 2 * C;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    dlp[c] = dlnw[c];
    dlp[C + c] = dlnb[c];
  }
}

template <typename T>
int launch_attn_stats(const void* x, const void* dx1, const void* ln1w,
                      const void* ln1b, const void* wq, const void* wk,
                      const void* wv, const void* dwall, const void* attn,
                      const void* wprojt, void* ys, void* lins, void* qkv,
                      void* os, void* dos, int B, int H, int W, int C,
                      int heads, int bias_free, int th, int tw,
                      cudaStream_t stream) {
  const size_t smem = attn_stats_smem_bytes(C, th, tw, sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(
      attn_bwd_stats_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W + tw - 1) / tw, (H + th - 1) / th, B);
  attn_bwd_stats_kernel<T><<<grid, kThreads, smem, stream>>>(
      (const T*)x, (const T*)dx1, (const float*)ln1w, (const float*)ln1b,
      (const T*)wq, (const T*)wk, (const T*)wv, (const float*)dwall,
      (const T*)attn, (const T*)wprojt, (T*)ys, (T*)lins, (T*)qkv, (T*)os,
      (T*)dos, H, W, C, heads, bias_free, th, tw);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_attn_apply(const void* x, const void* dx1, const void* ln1w,
                      const void* qkv, const void* lins, const void* dos,
                      const void* wqt, const void* wkt, const void* wvt,
                      const void* dwall, const void* m, const void* mt,
                      const void* at, const void* dqd, const void* dkd,
                      void* dx, void* dlins, void* dtap_part, void* dln_part,
                      int B, int H, int W, int C, int heads, int bias_free,
                      int th, int tw, int nsplit, cudaStream_t stream) {
  const size_t smem = attn_apply_smem_bytes(C, C / heads, th, tw, sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(
      attn_bwd_apply_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  attn_bwd_apply_kernel<T><<<dim3(nsplit, B), kThreads, smem, stream>>>(
      (const T*)x, (const T*)dx1, (const float*)ln1w, (const T*)qkv,
      (const T*)lins, (const T*)dos, (const T*)wqt, (const T*)wkt,
      (const T*)wvt, (const float*)dwall, (const T*)m, (const T*)mt,
      (const T*)at, (const float*)dqd, (const float*)dkd, (T*)dx, (T*)dlins,
      (float*)dtap_part, (float*)dln_part, H, W, C, heads, bias_free, th, tw);
  return (int)cudaGetLastError();
}

bool attn_shape_ok(int C, int heads, int th, int tw) {
  return heads > 0 && C % heads == 0 && C / heads <= kMaxCph && th > 0 &&
         tw > 0;
}

}  // namespace

extern "C" {

// Channels per head that the attention-half backward takes.
int tblock_attn_bwd_max_cph() { return kMaxCph; }

// Dynamic shared memory of pass 1 (pass == 0) or pass 2 (pass == 1).
long long tblock_attn_bwd_smem_bytes(int pass, int C, int heads, int th,
                                     int tw, int elem_bytes) {
  if (pass == 0) return (long long)attn_stats_smem_bytes(C, th, tw,
                                                         elem_bytes);
  return (long long)attn_apply_smem_bytes(C, C / heads, th, tw, elem_bytes);
}

// Pass 1, float32 (bf16 runs the passes laid out at the top of
// bwd_stencil.cu).  Weight matrices as in tblock.cu's f32 (inputs,
// outputs).  x, dx1: (B, H, W, C); wq, wk, wv: the forward's thirds;
// dwall: (27, C) f32 taps, q rows 0-8, k 9-17, v 18-26; attn: (B, heads,
// cph, cph) A, [c][d]; wprojt: the product dx1 -> do (proj transposed).
// Outputs ys, os, dos: (B H W, C) y, o, do; lins, qkv: (B H W, 3 C) lin
// and q | k | v.  Returns a cudaError_t.
int tblock_attn_bwd_stats(const void* x, const void* dx1, const void* ln1w,
                          const void* ln1b, const void* wq, const void* wk,
                          const void* wv, const void* dwall,
                          const void* attn, const void* wprojt, void* ys,
                          void* lins, void* qkv, void* os, void* dos, int B,
                          int H, int W, int C, int heads, int bias_free,
                          int th, int tw, void* stream) {
  if (!attn_shape_ok(C, heads, th, tw)) return (int)cudaErrorInvalidValue;
  return launch_attn_stats<float>(x, dx1, ln1w, ln1b, wq, wk, wv, dwall,
                                  attn, wprojt, ys, lins, qkv, os, dos, B, H,
                                  W, C, heads, bias_free, th, tw,
                                  (cudaStream_t)stream);
}

// Pass 2, float32, on pass 1's qkv, lins and dos.
// wqt, wkt, wvt: the thirds' transposes (the products dlin -> dy); dwall
// as pass 1's; m, mt, at: (B, heads, cph, cph) in x's dtype, M, M^T and
// A^T of the glue; dqd, dkd: (B, C) f32.  Outputs: dx (B, H, W, C); dlins
// (B H W, 3 C) for wgrad; dtap_part (B nsplit, 27, C) and dln_part
// (B nsplit, 2, C) f32 per-CTA partials.  Returns a cudaError_t.
int tblock_attn_bwd_apply(const void* x, const void* dx1, const void* ln1w,
                          const void* qkv, const void* lins, const void* dos,
                          const void* wqt, const void* wkt, const void* wvt,
                          const void* dwall, const void* m, const void* mt,
                          const void* at, const void* dqd, const void* dkd,
                          void* dx, void* dlins, void* dtap_part,
                          void* dln_part, int B, int H, int W, int C,
                          int heads, int bias_free, int th, int tw,
                          int nsplit, void* stream) {
  if (!attn_shape_ok(C, heads, th, tw) || nsplit <= 0)
    return (int)cudaErrorInvalidValue;
  return launch_attn_apply<float>(
      x, dx1, ln1w, qkv, lins, dos, wqt, wkt, wvt, dwall, m, mt, at, dqd, dkd,
      dx, dlins, dtap_part, dln_part, B, H, W, C, heads, bias_free, th, tw,
      nsplit, (cudaStream_t)stream);
}

}  // extern "C"
