// Whole Restormer TransformerBlock forward for Hopper (sm_90a).
//
//   out = x1 + GDFN(LN2(x1)),  x1 = x + proj(MDTA(dw3x3(LN1(x) . Wqkv)))
//
// Replaces the TPU kernels of textualdegremoval_tpu/ops/pallas/tblock.py:
// pass A `_make_stats_kernel` and pass B `_make_apply_kernel`.  The glue
// between them (`_attn_matrix`: norms, temperature, f32 softmax, O(C*cph))
// stays plain torch in the wrapper, ops/pallas/tblock.py.
//
// Pass A (tblock_stats_kernel): one CTA per (tile split, head, image).  A CTA
// walks a fixed, strided list of spatial tiles.  For each tile it computes
// LN1 on the tile plus a 1-pixel halo, the q and k columns of its head's
// 1x1, zeroes the post-1x1 values outside the image on all four sides (the
// reference zero-pads the qkv tensor, not x), applies the 3x3 depthwise
// conv, and accumulates the head's cph x cph gram and the per-channel q/k
// square sums in f32.  Only the per-head diagonal blocks of the gram are
// computed.  Each CTA writes its own partial sums; the wrapper adds the
// partials over the split axis with torch.sum.  No float atomics: the result
// is bitwise repeatable run to run.
//
// Pass B (tblock_apply_kernel): one CTA per output tile.  It recomputes LN1
// and the v third on the tile plus a 2-pixel halo, masks values outside the
// image, applies the dwconv to get v on the tile plus a 1-pixel ring, then
// o = v . A_head^T per head, project_out and the first residual (x1), LN2,
// the GDFN in 32-wide hidden chunks (1x1 to both halves, zero outside the
// image, 3x3 depthwise, gelu_erf(h1) * h2, 1x1 back accumulated in f32),
// and the second residual.  Only the C-wide output is written to memory,
// and x1 as well when the training step's backward asks for it (JAX
// `want_x1`).  Helpers shared with the backward kernels are in
// tblock_common.cuh.
//
// Rounding points mirror the JAX kernel: the 1x1 outputs are cast to the
// input dtype before the dwconv; the qkv dwconv sums in f32 and is cast; o
// and proj are in the input dtype; the GDFN gate is computed in f32 and cast
// before the W2 product; the output is x1 + acc cast to the input dtype.
//
// What bounds it on the card: at C = 48/96 the products have K = C, too
// short to amortise loads, and the depthwise stencils are pure load/FMA
// work; neither is bound by arithmetic.  A pass-B tile is small (4 x 8
// pixels: its intermediates for the 2-pixel halo must fit in shared
// memory), so every CTA reads all of the block's weights (184 KB at
// C = 96) for 32 output pixels: the weight reads through L2, the shared-
// memory bank conflicts and the halo recompute bound it.  Timing each stage
// by leaving it out put pass B's four products (GDFN in and out, v, proj)
// at most of its time.  What the design does:
// * every intermediate (LN output, v, o, x1, hidden chunks) stays in shared
//   memory, none crosses device memory; tiles cut H and W (a whole
//   TPU-style row does not fit in 227 KB) and mask all four image edges;
// * in bf16 every product with K % 16 == 0 (all of them at the model's
//   widths: the 1x1s, o = v A^T, the gram with K = pixels) runs as warp-
//   level mma.sync m16n8k16 with f32 sums, A fragments from padded shared
//   memory, B fragments from (outputs, inputs) weights in global memory;
//   each warp reuses a B fragment for up to four 16-row pixel tiles, which
//   cuts the weight reads through L2 by as much;
// * both GDFN halves come out of one product (w1's rows interleaved per
//   hidden chunk), and the f32 GDFN accumulator's rows are padded against
//   bank conflicts;
// * pass B is held to 64 registers so that four CTAs fit on an SM at
//   C <= 96, where occupancy hides the load latency.
// float32, and bf16 at other widths, use f32 FMA loops.  The stencils and
// LayerNorms stay on the CUDA cores.  Tiles are picked by the wrapper from
// an order measured on the card.  wgmma, TMA and weights staged in shared
// memory are left for later work.

#include "tblock_common.cuh"

namespace {

size_t stats_smem_bytes(int C, int cph, int th, int tw, int eb) {
  const int p1 = (th + 2) * (tw + 2), tp = th * tw;
  return (size_t)4 * cph * cph +
         (size_t)eb * ((size_t)round_up(p1, kRowPad) * smem_ld(C) +
                       (size_t)round_up(p1 * cph, 8) +
                       2 * (size_t)round_up(cph, kRowPad) *
                           smem_ld(round_up(tp, 16)));
}

size_t apply_smem_bytes(int C, int th, int tw, int eb) {
  const int p2 = (th + 4) * (tw + 4), p1 = (th + 2) * (tw + 2), tp = th * tw;
  const int chunk = p2 * kVC > 2 * p1 * kHC ? p2 * kVC : 2 * p1 * kHC;
  return (size_t)4 * tp * (C + kAccPad) +
         (size_t)eb * ((size_t)round_up(p2, kRowPad) * smem_ld(C) +
                       (size_t)round_up(p1, kRowPad) * smem_ld(C) + chunk +
                       (size_t)round_up(tp, kRowPad) * smem_ld(kHC));
}

// ---------------------------------------------------------------------------
// Pass A: per-head gram and q/k square sums, per-CTA partials
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads) tblock_stats_kernel(
    const T* __restrict__ x, const float* __restrict__ lnw,
    const float* __restrict__ lnb, const T* __restrict__ wq,
    const T* __restrict__ wk, const float* __restrict__ dwqk,
    float* __restrict__ gram_part, float* __restrict__ qs_part,
    float* __restrict__ ks_part, int H, int W, int C, int heads,
    int bias_free, int th, int tw) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int cph = C / heads;
  const int split = blockIdx.x, nsplit = gridDim.x;
  const int hd = blockIdx.y, b = blockIdx.z;
  const int hw = tw + 2, p1 = (th + 2) * hw, tp = th * tw;
  const int tp16 = round_up(tp, 16);
  const int ldc = smem_ld(C), ldp = smem_ld(tp16);
  const int ntx = (W + tw - 1) / tw;
  const int ntiles = ((H + th - 1) / th) * ntx;

  float* gacc = reinterpret_cast<float*>(smem_raw);      // [cph][cph] f32
  T* ys = reinterpret_cast<T*>(gacc + cph * cph);        // [p1 rows][ldc]
  T* lin = ys + (size_t)round_up(p1, kRowPad) * ldc;     // [p1][cph]
  T* qT = lin + round_up(p1 * cph, 8);                   // [cph rows][ldp]
  T* kT = qT + (size_t)round_up(cph, kRowPad) * ldp;     // [cph rows][ldp]

  // q and k are kept transposed (channel-major) so that the gram is a
  // product with K = pixels; the pixel columns [tp, tp16) stay zero
  for (int i = threadIdx.x; i < cph * cph; i += blockDim.x) gacc[i] = 0.f;
  for (int i = threadIdx.x; i < cph * (tp16 - tp); i += blockDim.x) {
    const int c = i / (tp16 - tp), p = tp + i % (tp16 - tp);
    qT[c * ldp + p] = from_f<T>(0.f);
    kT[c * ldp + p] = from_f<T>(0.f);
  }
  float ssq = 0.f;  // threads [0, cph): q channels; [cph, 2 cph): k channels

  const T* xb = x + (size_t)b * H * W * C;
  for (int t = split; t < ntiles; t += nsplit) {
    const int oy = (t / ntx) * th, ox = (t % ntx) * tw;
    ln_region(xb, H, W, C, oy - 1, ox - 1, th + 2, hw, lnw, lnb,
              bias_free != 0, ys, ldc);
    __syncthreads();
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
        // pixels of the tile outside the image add nothing to the sums
        const bool in = oy + py < H && ox + px < W;
        dst[n * ldp + p] = from_f<T>(in ? acc : 0.f);
      }
      __syncthreads();
    }
    gemm(qT, ldp, cph, tp16, MatB<T>{kT, 1, ldp}, cph,
         [&](int c, int d, float v) { gacc[c * cph + d] += v; });
    if ((int)threadIdx.x < 2 * cph) {
      const int c = threadIdx.x % cph;
      const T* src = ((int)threadIdx.x < cph ? qT : kT) + c * ldp;
      float s = 0.f;
      for (int p = 0; p < tp; ++p) {
        const float v = to_f(src[p]);
        s += v * v;
      }
      ssq += s;
    }
    __syncthreads();
  }

  const size_t slot = (size_t)b * nsplit + split;
  float* gp = gram_part + (slot * heads + hd) * cph * cph;
  for (int i = threadIdx.x; i < cph * cph; i += blockDim.x) gp[i] = gacc[i];
  if ((int)threadIdx.x < cph)
    qs_part[slot * C + hd * cph + threadIdx.x] = ssq;
  else if ((int)threadIdx.x < 2 * cph)
    ks_part[slot * C + hd * cph + threadIdx.x - cph] = ssq;
}

// ---------------------------------------------------------------------------
// Pass B: apply attention, project, residual, LN2, GDFN, residual
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads, 4) tblock_apply_kernel(
    const T* __restrict__ x, const float* __restrict__ ln1w,
    const float* __restrict__ ln1b, const T* __restrict__ wv,
    const float* __restrict__ dwv, const T* __restrict__ attn,
    const T* __restrict__ wproj, const float* __restrict__ ln2w,
    const float* __restrict__ ln2b, const T* __restrict__ w1,
    const float* __restrict__ dwg, const T* __restrict__ w2,
    T* __restrict__ out, T* __restrict__ x1out, int H, int W, int C,
    int heads, int hpad, int bias_free, int th, int tw) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int cph = C / heads;
  const int b = blockIdx.z, oy = blockIdx.y * th, ox = blockIdx.x * tw;
  const int w2w = tw + 4, p2 = (th + 4) * w2w;  // 2-pixel halo region
  const int w1w = tw + 2, p1 = (th + 2) * w1w;  // 1-pixel halo region
  const int tp = th * tw;
  const int ldc = smem_ld(C), ldg = smem_ld(kHC);
  const bool bf = bias_free != 0;

  const int lda_acc = C + kAccPad;
  float* acc = reinterpret_cast<float*>(smem_raw);  // [tp][lda_acc] f32
  T* bufA = reinterpret_cast<T*>(acc + (size_t)tp * lda_acc);  // y, o, z
  T* bufB = bufA + (size_t)round_up(p2, kRowPad) * ldc;   // v, then x1
  T* chunk = bufB + (size_t)round_up(p1, kRowPad) * ldc;  // v_lin / h1,h2
  const int chunk_elems = p2 * kVC > 2 * p1 * kHC ? p2 * kVC : 2 * p1 * kHC;
  T* gate = chunk + chunk_elems;                  // [tp rows][ldg]

  const T* xb = x + (size_t)b * H * W * C;
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
  const T* ab = attn + (size_t)b * heads * cph * cph;
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

  // 6. GDFN in kHC-wide hidden chunks; w1 rows [2 c0, 2 c0 + kHC) make the
  //    chunk's h1, the next kHC rows its h2
  T* h1 = chunk;
  T* h2 = chunk + (size_t)p1 * kHC;
  for (int c0 = 0; c0 < hpad; c0 += kHC) {
    auto masked = [&](int q, float a) {
      return from_f<T>(in_image(oy - 1 + q / w1w, ox - 1 + q % w1w) ? a
                                                                    : 0.f);
    };
    gemm(bufA, ldc, p1, C, weights(w1, 2 * hpad, C, 2 * c0, 0), 2 * kHC,
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

  // 7. out = x1 + acc on the tile; x1 itself too when asked for (the
  //    attention-residual boundary that the backward starts from)
  for (int idx = threadIdx.x; idx < tp * C; idx += blockDim.x) {
    const int p = idx / C, n = idx % C;
    const int py = p / tw, px = p % tw;
    const int gy = oy + py, gx = ox + px;
    if (gy < H && gx < W) {
      const T x1 = bufB[((size_t)(py + 1) * w1w + px + 1) * ldc + n];
      const size_t o = (((size_t)b * H + gy) * W + gx) * C + n;
      out[o] = from_f<T>(to_f(x1) + rnd<T>(acc[p * lda_acc + n]));
      if (x1out != nullptr) x1out[o] = x1;
    }
  }
}

template <typename T>
int launch_stats(const void* x, const void* lnw, const void* lnb,
                 const void* wq, const void* wk, const void* dwqk,
                 void* gram_part, void* qs_part, void* ks_part, int B, int H,
                 int W, int C, int heads, int bias_free, int th, int tw,
                 int nsplit, cudaStream_t stream) {
  const size_t smem = stats_smem_bytes(C, C / heads, th, tw, sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(
      tblock_stats_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  tblock_stats_kernel<T><<<dim3(nsplit, heads, B), kThreads, smem, stream>>>(
      (const T*)x, (const float*)lnw, (const float*)lnb, (const T*)wq,
      (const T*)wk, (const float*)dwqk, (float*)gram_part, (float*)qs_part,
      (float*)ks_part, H, W, C, heads, bias_free, th, tw);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_apply(const void* x, const void* ln1w, const void* ln1b,
                 const void* wv, const void* dwv, const void* attn,
                 const void* wproj, const void* ln2w, const void* ln2b,
                 const void* w1, const void* dwg, const void* w2, void* out,
                 void* x1out, int B, int H, int W, int C, int heads,
                 int hpad, int bias_free, int th, int tw,
                 cudaStream_t stream) {
  const size_t smem = apply_smem_bytes(C, th, tw, sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(
      tblock_apply_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W + tw - 1) / tw, (H + th - 1) / th, B);
  tblock_apply_kernel<T><<<grid, kThreads, smem, stream>>>(
      (const T*)x, (const float*)ln1w, (const float*)ln1b, (const T*)wv,
      (const float*)dwv, (const T*)attn, (const T*)wproj, (const float*)ln2w,
      (const float*)ln2b, (const T*)w1, (const float*)dwg, (const T*)w2,
      (T*)out, (T*)x1out, H, W, C, heads, hpad, bias_free, th, tw);
  return (int)cudaGetLastError();
}

bool shape_ok(int C, int heads, int th, int tw) {
  return heads > 0 && C % heads == 0 && C / heads <= kMaxCph && th > 0 &&
         tw > 0;
}

}  // namespace

extern "C" {

// Dynamic shared memory of pass A (pass == 0) or pass B (pass == 1) for a
// th x tw tile; the wrapper picks tiles with it.
long long tblock_smem_bytes(int pass, int C, int heads, int th, int tw,
                            int elem_bytes) {
  if (pass == 0) return (long long)stats_smem_bytes(C, C / heads, th, tw,
                                                    elem_bytes);
  return (long long)apply_smem_bytes(C, th, tw, elem_bytes);
}

int tblock_hidden_chunk() { return kHC; }

int tblock_max_cph() { return kMaxCph; }

const char* tblock_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Weight matrices are (outputs, inputs) for bf16 and (inputs, outputs) for
// float32 (see `weights`); the shapes below are the bf16 ones.
//
// x: (B, H, W, C); wq, wk: (C, C); dwqk: (18, C) f32, q taps in rows 0-8,
// k taps in rows 9-17; gram_part: (B, nsplit, heads, cph, cph)
// f32; qs_part, ks_part: (B, nsplit, C) f32.  Returns a cudaError_t.
int tblock_stats(const void* x, const void* lnw, const void* lnb,
                 const void* wq, const void* wk, const void* dwqk,
                 void* gram_part, void* qs_part, void* ks_part, int B, int H,
                 int W, int C, int heads, int is_bf16, int bias_free, int th,
                 int tw, int nsplit, void* stream) {
  if (!shape_ok(C, heads, th, tw) || nsplit <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return launch_stats<__nv_bfloat16>(x, lnw, lnb, wq, wk, dwqk, gram_part,
                                       qs_part, ks_part, B, H, W, C, heads,
                                       bias_free, th, tw, nsplit, s);
  return launch_stats<float>(x, lnw, lnb, wq, wk, dwqk, gram_part, qs_part,
                             ks_part, B, H, W, C, heads, bias_free, th, tw,
                             nsplit, s);
}

// attn: (B, heads, cph, cph) in x's dtype, [c][d] per head; wv, wproj:
// (C, C); dwv: (9, C) f32; w1: (2 hpad, C), per hidden chunk of kHC its h1
// rows, then its h2 rows; dwg: (18, hpad) f32; w2: (C, hpad); x1out: null,
// or (B, H, W, C) to receive x1 = x + proj(attention).  Returns a
// cudaError_t.
int tblock_apply(const void* x, const void* ln1w, const void* ln1b,
                 const void* wv, const void* dwv, const void* attn,
                 const void* wproj, const void* ln2w, const void* ln2b,
                 const void* w1, const void* dwg, const void* w2, void* out,
                 void* x1out, int B, int H, int W, int C, int heads, int hpad,
                 int is_bf16, int bias_free, int th, int tw, void* stream) {
  if (!shape_ok(C, heads, th, tw) || hpad <= 0 || hpad % kHC)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return launch_apply<__nv_bfloat16>(x, ln1w, ln1b, wv, dwv, attn, wproj,
                                       ln2w, ln2b, w1, dwg, w2, out, x1out,
                                       B, H, W, C, heads, hpad, bias_free,
                                       th, tw, s);
  return launch_apply<float>(x, ln1w, ln1b, wv, dwv, attn, wproj, ln2w, ln2b,
                             w1, dwg, w2, out, x1out, B, H, W, C, heads, hpad,
                             bias_free, th, tw, s);
}

}  // extern "C"
