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
// is bitwise repeatable run to run.  Only pixels of a window of rows
// [row_lo, row_hi) count (`tblock_stats_rows`; `tblock_stats` takes every
// row): a slab of an image split by rows over ranks runs the block on its
// rows and a halo of its neighbours', and its statistics, summed over the
// ranks, take its own rows only.
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
// tblock_common.cuh; the bodies of both passes, which the cross-block chain
// kernel (tblock_chain.cu) runs too, are in tblock_fwd.cuh.
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
// LayerNorms stay on the CUDA cores.
//
// Widths: any C with at most kMaxCph = 192 channels per head.  Restormer's
// blocks have 48 or 96; PromptIR's three noise blocks have C = 704 / 320 /
// 160 at 4 heads, 176 / 80 / 40 channels per head (its --tiny_debug
// config 192).  Pass A keeps the head's cph x cph gram in f32 shared
// memory (124 KB at cph 176), so at C = 704 only a 4 x 4 tile fits in
// bf16 and a 2 x 2 in f32, one CTA per SM; pass B's shared memory does not
// depend on cph and takes 4 x 4 (bf16) and 2 x 2 (f32) at C = 704.  At cph
// 40 the one product with K = cph (o = v A^T) runs the FMA loops in bf16
// too; the 1x1s (K = C), the gram (K = tile pixels padded to 16) and the
// GDFN's second product (K = 32) stay on mma.sync.  No register or stack
// array is sized by cph: each thread keeps at most two of the 2 cph q/k
// square sums.  Tiles are picked by the wrapper from
// an order measured on the card.  wgmma, TMA and weights staged in shared
// memory are left for later work.

#include "tblock_fwd.cuh"

namespace {

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
    int bias_free, int th, int tw, int row_lo, int row_hi) {
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

  // the pixel columns [tp, tp16) of qT and kT stay zero
  for (int i = threadIdx.x; i < cph * cph; i += blockDim.x) gacc[i] = 0.f;
  for (int i = threadIdx.x; i < cph * (tp16 - tp); i += blockDim.x) {
    const int c = i / (tp16 - tp), p = tp + i % (tp16 - tp);
    qT[c * ldp + p] = from_f<T>(0.f);
    kT[c * ldp + p] = from_f<T>(0.f);
  }
  // the square sums of this thread's channels i = threadIdx.x (+ blockDim.x)
  // of [q | k]: 2 cph <= 2 kThreads
  static_assert(kMaxCph <= kThreads, "two square sums per thread");
  float ssq0 = 0.f, ssq1 = 0.f;

  const T* xb = x + (size_t)b * H * W * C;
  for (int t = split; t < ntiles; t += nsplit) {
    const int oy = (t / ntx) * th, ox = (t % ntx) * tw;
    ln_region(xb, H, W, C, oy - 1, ox - 1, th + 2, hw, lnw, lnb,
              bias_free != 0, ys, ldc);
    __syncthreads();
    stats_head_tile(ys, ldc, oy, ox, th, tw, H, W, C, cph, hd, row_lo, row_hi,
                    wq, wk, dwqk, lin, qT, kT, ldp, gacc,
                    [&](int j, int, float v) {
                      if (j == 0) ssq0 += v; else ssq1 += v;
                    });
  }

  const size_t slot = (size_t)b * nsplit + split;
  float* gp = gram_part + (slot * heads + hd) * cph * cph;
  for (int i = threadIdx.x; i < cph * cph; i += blockDim.x) gp[i] = gacc[i];
  for (int i = threadIdx.x, j = 0; i < 2 * cph; i += blockDim.x, ++j)
    (i < cph ? qs_part : ks_part)[slot * C + hd * cph + i % cph] =
        j == 0 ? ssq0 : ssq1;
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
  const ApplySmem<T> s(smem_raw, C, th, tw);
  // out = x1 + GDFN on the tile; x1 itself too when asked for (the
  // attention-residual boundary that the backward starts from)
  apply_region(x + (size_t)b * H * W * C, H, W, C, heads, hpad,
               bias_free != 0, oy, ox, th, tw, ln1w, ln1b, wv, dwv,
               attn + (size_t)b * heads * cph * cph, wproj, ln2w, ln2b, w1,
               dwg, w2, s, [&](int, int gy, int gx, int n, T x1, T v) {
                 const size_t o = (((size_t)b * H + gy) * W + gx) * C + n;
                 out[o] = v;
                 if (x1out != nullptr) x1out[o] = x1;
               });
}

template <typename T>
int launch_stats(const void* x, const void* lnw, const void* lnb,
                 const void* wq, const void* wk, const void* dwqk,
                 void* gram_part, void* qs_part, void* ks_part, int B, int H,
                 int W, int C, int heads, int bias_free, int th, int tw,
                 int nsplit, int row_lo, int row_hi, cudaStream_t stream) {
  const size_t smem = stats_smem_bytes(C, C / heads, th, tw, sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(
      tblock_stats_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  tblock_stats_kernel<T><<<dim3(nsplit, heads, B), kThreads, smem, stream>>>(
      (const T*)x, (const float*)lnw, (const float*)lnb, (const T*)wq,
      (const T*)wk, (const float*)dwqk, (float*)gram_part, (float*)qs_part,
      (float*)ks_part, H, W, C, heads, bias_free, th, tw, row_lo, row_hi);
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
// f32; qs_part, ks_part: (B, nsplit, C) f32, over the pixels of image rows
// [row_lo, row_hi) (0 <= row_lo <= row_hi <= H; a row-sharded slab's own
// rows, without its halo).  Returns a cudaError_t.
int tblock_stats_rows(const void* x, const void* lnw, const void* lnb,
                      const void* wq, const void* wk, const void* dwqk,
                      void* gram_part, void* qs_part, void* ks_part, int B,
                      int H, int W, int C, int heads, int is_bf16,
                      int bias_free, int th, int tw, int nsplit, int row_lo,
                      int row_hi, void* stream) {
  if (!shape_ok(C, heads, th, tw) || nsplit <= 0 || row_lo < 0 ||
      row_hi < row_lo || row_hi > H)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return launch_stats<__nv_bfloat16>(x, lnw, lnb, wq, wk, dwqk, gram_part,
                                       qs_part, ks_part, B, H, W, C, heads,
                                       bias_free, th, tw, nsplit, row_lo,
                                       row_hi, s);
  return launch_stats<float>(x, lnw, lnb, wq, wk, dwqk, gram_part, qs_part,
                             ks_part, B, H, W, C, heads, bias_free, th, tw,
                             nsplit, row_lo, row_hi, s);
}

// tblock_stats_rows over every row of x.
int tblock_stats(const void* x, const void* lnw, const void* lnb,
                 const void* wq, const void* wk, const void* dwqk,
                 void* gram_part, void* qs_part, void* ks_part, int B, int H,
                 int W, int C, int heads, int is_bf16, int bias_free, int th,
                 int tw, int nsplit, void* stream) {
  return tblock_stats_rows(x, lnw, lnb, wq, wk, dwqk, gram_part, qs_part,
                           ks_part, B, H, W, C, heads, is_bf16, bias_free, th,
                           tw, nsplit, 0, H, stream);
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
