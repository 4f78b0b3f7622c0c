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
// Pass 1 (attn_bwd_stats_kernel), float32 only (the parity path; bf16
// runs the passes laid out at the top of bwd_stencil.cu, which recompute
// nothing on a halo and take any cph): one CTA per output tile.  It recomputes
// LN1 and the v third on the tile plus a 1-pixel halo (zero outside the
// image), v on the tile, o = v . A^T and do = dx1 . Wproj^T, each rounded
// to the model dtype as on the TPU, and writes v, o and do of the tile to
// scratch.  The per-head dA = do^T v and dWproj = o^T dx1 are sums over
// every pixel; wgrad.cu reduces them.
//
// Pass 2 (attn_bwd_apply_kernel), float32 only (the parity path; bf16 runs
// the passes of bwd_stencil.cu and bwd_gemm.cu on pass 1's do): one CTA per
// (tile split, image) walks a fixed, strided list of tiles.  For each
// tile: LN1 of x on a 2-pixel halo, dx1 on a 1-pixel halo (zero outside
// the image), then per head:
//   q, k from their 1x1 (rounded, zero outside the image) and dwconv;
//   dq = k . M^T + q Dq and dk = q . M + k Dk (M, Dq, Dk from the glue);
//   dv = do . A with do = dx1 . Wproj^T on the halo;
// each third's gradient (f32, zero outside the image) gives the tap
// gradients against its 1x1 output, dlin = the flipped stencil of it
// rounded to the model dtype (tblock_attn_bwd.py:240-256), and
// dy += dlin . W^T in f32.  Last, the LN1 backward writes dx = dx1 +
// LN1-bwd(dy).  Working per head bounds the shared memory: the head is
// the unit of the channel attention, and cph <= 96 (kMaxCphBwd), which
// Restormer's widths keep (PromptIR's cph 176 trains in bf16 only).
//
// The reductions over pixels: the 27 x C tap gradients and the LN1
// parameter gradients are per-CTA partials summed by the wrapper in a
// fixed order; dWqkv = y^T dlin goes through scratch (y and dlin of the
// body pixels) and wgrad.cu.  No float atomics anywhere: the result is
// bitwise repeatable.
//
// What bounds it on the card: the 1x1 products over the 2-pixel halo (the
// q and k thirds of every head read all of y), K = cph products for the
// attention terms, and the stencils on the CUDA cores; the scratch traffic
// of y and dlin (4 C values per pixel) is small beside the GDFN half's.
// The products run on FMA loops.

#include "tblock_common.cuh"

namespace {

size_t attn_stats_smem_bytes(int C, int th, int tw, int eb) {
  const int p1 = (th + 2) * (tw + 2), tp = th * tw;
  return (size_t)eb * ((size_t)round_up(p1, kRowPad) * smem_ld(C) +
                       (size_t)p1 * kVC +
                       2 * (size_t)round_up(tp, kRowPad) * smem_ld(C));
}

size_t attn_apply_smem_bytes(int C, int cph, int th, int tw, int eb) {
  const int p2 = (th + 4) * (tw + 4), p1 = (th + 2) * (tw + 2), tp = th * tw;
  const int ldh = smem_ld(cph);
  return (size_t)4 * ((size_t)tp * (C + kAccPad) + (size_t)p1 * cph + 2 * tp +
                      2 * C) +
         (size_t)eb * ((size_t)round_up(p2, kRowPad) * smem_ld(C) +
                       (size_t)round_up(p1, kRowPad) * smem_ld(C) +
                       2 * (size_t)p2 * cph +
                       3 * (size_t)round_up(p1, kRowPad) * ldh +
                       (size_t)round_up(tp, kRowPad) * ldh);
}

// ---------------------------------------------------------------------------
// Pass 1: v, o and do of the tile, to scratch
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads) attn_bwd_stats_kernel(
    const T* __restrict__ x, const T* __restrict__ dx1,
    const float* __restrict__ ln1w, const float* __restrict__ ln1b,
    const T* __restrict__ wv, const float* __restrict__ dwv,
    const T* __restrict__ attn, const T* __restrict__ wprojt,
    T* __restrict__ vs, T* __restrict__ os, T* __restrict__ dos, int H,
    int W, int C, int heads, int bias_free, int th, int tw) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int cph = C / heads;
  const int b = blockIdx.z, oy = blockIdx.y * th, ox = blockIdx.x * tw;
  const int w1w = tw + 2, p1 = (th + 2) * w1w, tp = th * tw;
  const int ldc = smem_ld(C);

  T* ys = reinterpret_cast<T*>(smem_raw);              // [p1 rows][ldc]
  T* lin = ys + (size_t)round_up(p1, kRowPad) * ldc;   // [p1][kVC]
  T* vb = lin + (size_t)p1 * kVC;                      // [tp rows][ldc]
  T* gb = vb + (size_t)round_up(tp, kRowPad) * ldc;    // [tp rows][ldc]

  const size_t img = (size_t)b * H * W * C;
  auto in_image = [&](int gy, int gx) {
    return gy >= 0 && gy < H && gx >= 0 && gx < W;
  };
  auto body_in = [&](int p) { return in_image(oy + p / tw, ox + p % tw); };
  auto pix = [&](int p) {
    return ((size_t)b * H + oy + p / tw) * W + ox + p % tw;
  };

  ln_region(x + img, H, W, C, oy - 1, ox - 1, th + 2, w1w, ln1w, ln1b,
            bias_free != 0, ys, ldc);
  load_region(dx1 + img, H, W, C, oy, ox, th, tw, gb, ldc);
  __syncthreads();

  // v = dw3x3(mask(y . Wv)) on the tile, kVC channels at a time
  for (int n0 = 0; n0 < C; n0 += kVC) {
    const int nc = C - n0 < kVC ? C - n0 : kVC;
    gemm(ys, ldc, p1, C, weights(wv, C, C, n0, 0), nc,
         [&](int q, int n, float a) {
           const bool in = in_image(oy - 1 + q / w1w, ox - 1 + q % w1w);
           lin[q * kVC + n] = from_f<T>(in ? a : 0.f);
         });
    __syncthreads();
    for (int idx = threadIdx.x; idx < tp * nc; idx += blockDim.x) {
      const int p = idx / nc, n = idx % nc;
      const T v = from_f<T>(stencil3x3(lin + n, w1w, kVC, p / tw, p % tw,
                                       dwv + n0 + n, C, false));
      vb[(size_t)p * ldc + n0 + n] = v;
      if (body_in(p)) vs[pix(p) * C + n0 + n] = v;
    }
    __syncthreads();
  }

  // o = v . A_head^T per head; do = dx1 . Wproj^T
  const T* ab = attn + (size_t)b * heads * cph * cph;
  for (int hd = 0; hd < heads; ++hd)
    gemm(vb + hd * cph, ldc, tp, cph,
         MatB<T>{ab + (size_t)hd * cph * cph, 1, cph}, cph,
         [&](int p, int n, float a) {
           if (body_in(p)) os[pix(p) * C + hd * cph + n] = from_f<T>(a);
         });
  gemm(gb, ldc, tp, C, weights(wprojt, C, C, 0, 0), C,
       [&](int p, int n, float a) {
         if (body_in(p)) dos[pix(p) * C + n] = from_f<T>(a);
       });
}

// ---------------------------------------------------------------------------
// Pass 2: dx, y and dlin to scratch, tap and LN1 partials
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads) attn_bwd_apply_kernel(
    const T* __restrict__ x, const T* __restrict__ dx1,
    const float* __restrict__ ln1w, const float* __restrict__ ln1b,
    const T* __restrict__ wq, const T* __restrict__ wk,
    const T* __restrict__ wv, const T* __restrict__ wqt,
    const T* __restrict__ wkt, const T* __restrict__ wvt,
    const float* __restrict__ dwall, const T* __restrict__ wprojt,
    const T* __restrict__ m, const T* __restrict__ mt,
    const T* __restrict__ at, const float* __restrict__ dqd,
    const float* __restrict__ dkd, T* __restrict__ dx, T* __restrict__ ys,
    T* __restrict__ dlins, float* __restrict__ dtap_part,
    float* __restrict__ dln_part, int H, int W, int C, int heads,
    int bias_free, int th, int tw) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int cph = C / heads;
  const int split = blockIdx.x, nsplit = gridDim.x, b = blockIdx.y;
  const int w2w = tw + 4, p2 = (th + 4) * w2w;
  const int w1w = tw + 2, p1 = (th + 2) * w1w;
  const int tp = th * tw;
  const int ldc = smem_ld(C), ldh = smem_ld(cph), lda_acc = C + kAccPad;
  const int ntx = (W + tw - 1) / tw, ntiles = ((H + th - 1) / th) * ntx;
  const bool bf = bias_free != 0;
  const int lane = threadIdx.x & 31;

  float* dy = reinterpret_cast<float*>(smem_raw);  // [tp][lda_acc]
  float* dth = dy + (size_t)tp * lda_acc;          // [p1][cph]
  float* mu = dth + (size_t)p1 * cph;              // [tp]
  float* inv = mu + tp;                            // [tp]
  float* dlnw = inv + tp;                          // [C]
  float* dlnb = dlnw + C;                          // [C]
  T* yb = reinterpret_cast<T*>(dlnb + C);          // [p2 rows][ldc]
  T* gb = yb + (size_t)round_up(p2, kRowPad) * ldc;     // [p1 rows][ldc]
  T* la = gb + (size_t)round_up(p1, kRowPad) * ldc;     // [p2][cph]
  T* lb = la + (size_t)p2 * cph;                        // [p2][cph]
  T* qa = lb + (size_t)p2 * cph;                        // [p1 rows][ldh]
  T* ka = qa + (size_t)round_up(p1, kRowPad) * ldh;     // [p1 rows][ldh]
  T* db = ka + (size_t)round_up(p1, kRowPad) * ldh;     // [p1 rows][ldh]
  T* dl = db + (size_t)round_up(p1, kRowPad) * ldh;     // [tp rows][ldh]

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
    auto in_p2 = [&](int q) {
      return in_image(oy - 2 + q / w2w, ox - 2 + q % w2w);
    };
    auto in_p1 = [&](int q) {
      return in_image(oy - 1 + q / w1w, ox - 1 + q % w1w);
    };
    auto body_in = [&](int p) { return in_image(oy + p / tw, ox + p % tw); };
    auto pix = [&](int p) {
      return ((size_t)b * H + oy + p / tw) * W + ox + p % tw;
    };

    // y = LN1(x) on the 2-pixel halo, dx1 on the 1-pixel halo, the body
    // pixels' LN1 moments; zero the dy accumulator
    ln_region(xb, H, W, C, oy - 2, ox - 2, th + 4, w2w, ln1w, ln1b, bf, yb,
              ldc);
    load_region(dx1 + img, H, W, C, oy - 1, ox - 1, th + 2, w1w, gb, ldc);
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
    __syncthreads();
    // y of the body pixels feeds dWqkv = y^T dlin (wgrad.cu)
    for (int idx = threadIdx.x; idx < tp * C; idx += blockDim.x) {
      const int p = idx / C, c = idx % C;
      if (body_in(p))
        ys[pix(p) * C + c] =
            yb[((size_t)(p / tw + 2) * w2w + p % tw + 2) * ldc + c];
    }

    // one third's backward from its gradient dth (f32, zero outside the
    // image, on the 1-pixel halo): tap gradients against the third's 1x1
    // output lin (2-pixel halo), dlin on the body rounded to T (scratch and
    // smem), dy += dlin . W^T
    auto third = [&](const T* lin, int which, const T* wt, int hd) {
      const float* taps = dwall + (size_t)which * 9 * C + hd * cph;
      for (int idx = threadIdx.x; idx < 9 * cph; idx += blockDim.x) {
        const int tap = idx / cph, n = idx % cph;
        const int ty = tap / 3, tx = tap % 3;
        float s = 0.f;
        for (int p = 0; p < tp; ++p) {
          const int py = p / tw, px = p % tw;
          s += to_f(lin[((size_t)(py + 1 + ty) * w2w + px + 1 + tx) * cph + n]) *
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
      // q and k of the head: 1x1 on the 2-pixel halo (zero outside the
      // image), dwconv on the 1-pixel halo
      gemm(yb, ldc, p2, C, weights(wq, C, C, hd * cph, 0), cph,
           [&](int q, int n, float a) {
             la[q * cph + n] = from_f<T>(in_p2(q) ? a : 0.f);
           });
      gemm(yb, ldc, p2, C, weights(wk, C, C, hd * cph, 0), cph,
           [&](int q, int n, float a) {
             lb[q * cph + n] = from_f<T>(in_p2(q) ? a : 0.f);
           });
      __syncthreads();
      for (int idx = threadIdx.x; idx < p1 * cph; idx += blockDim.x) {
        const int q = idx / cph, n = idx % cph;
        const int qy = q / w1w, qx = q % w1w;
        qa[(size_t)q * ldh + n] = from_f<T>(stencil3x3(
            la + n, w2w, cph, qy, qx, dwall + hd * cph + n, C, false));
        ka[(size_t)q * ldh + n] = from_f<T>(stencil3x3(
            lb + n, w2w, cph, qy, qx, dwall + (size_t)9 * C + hd * cph + n,
            C, false));
      }
      __syncthreads();

      // dq = k . M^T + q Dq
      gemm(ka, ldh, p1, cph, MatB<T>{m + mo, 1, cph}, cph,
           [&](int q, int n, float a) {
             const float qv = to_f(qa[(size_t)q * ldh + n]);
             dth[q * cph + n] =
                 in_p1(q) ? a + qv * dqd[(size_t)b * C + hd * cph + n] : 0.f;
           });
      __syncthreads();
      third(la, 0, wqt, hd);

      // dk = q . M + k Dk
      gemm(qa, ldh, p1, cph, MatB<T>{mt + mo, 1, cph}, cph,
           [&](int q, int n, float a) {
             const float kv = to_f(ka[(size_t)q * ldh + n]);
             dth[q * cph + n] =
                 in_p1(q) ? a + kv * dkd[(size_t)b * C + hd * cph + n] : 0.f;
           });
      __syncthreads();
      third(lb, 1, wkt, hd);

      // v third: its 1x1 output for the tap gradients; do = dx1 . Wproj^T
      // on the 1-pixel halo, then dv = do . A
      gemm(yb, ldc, p2, C, weights(wv, C, C, hd * cph, 0), cph,
           [&](int q, int n, float a) {
             la[q * cph + n] = from_f<T>(in_p2(q) ? a : 0.f);
           });
      gemm(gb, ldc, p1, C, weights(wprojt, C, C, hd * cph, 0), cph,
           [&](int q, int n, float a) {
             db[(size_t)q * ldh + n] = from_f<T>(a);
           });
      __syncthreads();
      gemm(db, ldh, p1, cph, MatB<T>{at + mo, 1, cph}, cph,
           [&](int q, int n, float a) {
             dth[q * cph + n] = in_p1(q) ? a : 0.f;
           });
      __syncthreads();
      third(la, 2, wvt, hd);
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
                      const void* ln1b, const void* wv, const void* dwv,
                      const void* attn, const void* wprojt, void* vs,
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
      (const T*)wv, (const float*)dwv, (const T*)attn, (const T*)wprojt,
      (T*)vs, (T*)os, (T*)dos, H, W, C, heads, bias_free, th, tw);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_attn_apply(const void* x, const void* dx1, const void* ln1w,
                      const void* ln1b, const void* wq, const void* wk,
                      const void* wv, const void* wqt, const void* wkt,
                      const void* wvt, const void* dwall, const void* wprojt,
                      const void* m, const void* mt, const void* at,
                      const void* dqd, const void* dkd, void* dx, void* ys,
                      void* dlins, void* dtap_part, void* dln_part, int B,
                      int H, int W, int C, int heads, int bias_free, int th,
                      int tw, int nsplit, cudaStream_t stream) {
  const size_t smem = attn_apply_smem_bytes(C, C / heads, th, tw, sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(
      attn_bwd_apply_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  attn_bwd_apply_kernel<T><<<dim3(nsplit, B), kThreads, smem, stream>>>(
      (const T*)x, (const T*)dx1, (const float*)ln1w, (const float*)ln1b,
      (const T*)wq, (const T*)wk, (const T*)wv, (const T*)wqt, (const T*)wkt,
      (const T*)wvt, (const float*)dwall, (const T*)wprojt, (const T*)m,
      (const T*)mt, (const T*)at, (const float*)dqd, (const float*)dkd,
      (T*)dx, (T*)ys, (T*)dlins, (float*)dtap_part, (float*)dln_part, H, W,
      C, heads, bias_free, th, tw);
  return (int)cudaGetLastError();
}

bool attn_shape_ok(int C, int heads, int th, int tw) {
  return heads > 0 && C % heads == 0 && C / heads <= kMaxCphBwd && th > 0 &&
         tw > 0;
}

}  // namespace

extern "C" {

// Channels per head that the attention-half backward takes.
int tblock_attn_bwd_max_cph() { return kMaxCphBwd; }

// Dynamic shared memory of pass 1 (pass == 0) or pass 2 (pass == 1).
long long tblock_attn_bwd_smem_bytes(int pass, int C, int heads, int th,
                                     int tw, int elem_bytes) {
  if (pass == 0) return (long long)attn_stats_smem_bytes(C, th, tw,
                                                         elem_bytes);
  return (long long)attn_apply_smem_bytes(C, C / heads, th, tw, elem_bytes);
}

// Pass 1, float32 (bf16 runs the passes laid out at the top of
// bwd_stencil.cu).  Weight matrices as in tblock.cu's f32 (inputs,
// outputs).  x, dx1: (B, H, W, C); wv: the v third's 1x1; dwv: (9, C) f32;
// attn: (B, heads, cph, cph) A, [c][d]; wprojt: the product dx1 -> do
// (proj transposed).  Outputs vs, os, dos: (B H W, C) v, o, do.  Returns a
// cudaError_t.
int tblock_attn_bwd_stats(const void* x, const void* dx1, const void* ln1w,
                          const void* ln1b, const void* wv, const void* dwv,
                          const void* attn, const void* wprojt, void* vs,
                          void* os, void* dos, int B, int H, int W, int C,
                          int heads, int bias_free, int th, int tw,
                          void* stream) {
  if (!attn_shape_ok(C, heads, th, tw)) return (int)cudaErrorInvalidValue;
  return launch_attn_stats<float>(x, dx1, ln1w, ln1b, wv, dwv, attn, wprojt,
                                  vs, os, dos, B, H, W, C, heads, bias_free,
                                  th, tw, (cudaStream_t)stream);
}

// Pass 2, float32.
// wq, wk, wv: the forward's thirds; wqt, wkt, wvt: their transposes (the
// products dlin -> dy); dwall: (27, C) f32 taps, q rows 0-8, k 9-17, v
// 18-26; m, mt, at: (B, heads, cph, cph) in x's dtype, M, M^T and A^T of
// the glue; dqd, dkd: (B, C) f32.  Outputs: dx (B, H, W, C); ys (B H W, C)
// and dlins (B H W, 3 C) for wgrad; dtap_part (B nsplit, 27, C) and
// dln_part (B nsplit, 2, C) f32 per-CTA partials.  Returns a cudaError_t.
int tblock_attn_bwd_apply(const void* x, const void* dx1, const void* ln1w,
                          const void* ln1b, const void* wq, const void* wk,
                          const void* wv, const void* wqt, const void* wkt,
                          const void* wvt, const void* dwall,
                          const void* wprojt, const void* m, const void* mt,
                          const void* at, const void* dqd, const void* dkd,
                          void* dx, void* ys, void* dlins, void* dtap_part,
                          void* dln_part, int B, int H, int W, int C,
                          int heads, int bias_free, int th, int tw,
                          int nsplit, void* stream) {
  if (!attn_shape_ok(C, heads, th, tw) || nsplit <= 0)
    return (int)cudaErrorInvalidValue;
  return launch_attn_apply<float>(
      x, dx1, ln1w, ln1b, wq, wk, wv, wqt, wkt, wvt, dwall, wprojt, m, mt, at,
      dqd, dkd, dx, ys, dlins, dtap_part, dln_part, B, H, W, C, heads,
      bias_free, th, tw, nsplit, (cudaStream_t)stream);
}

}  // extern "C"
