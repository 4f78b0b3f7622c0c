// Whole NAFBlock forward for Hopper (sm_90a).
//
//   y1  = x + conv3(SimpleGate(dw3x3(conv1(LN1(x)))) * s) * beta
//   out = y1 + conv5(SimpleGate(conv4(LN2(y1)))) * gamma
//   s   = mean over the image of the gate, through the SCA 1x1 (glue)
//
// Replaces the TPU kernels of textualdegremoval_tpu/ops/pallas/nafblock.py
// `_nafblock_impl`: pass A `_make_sum_kernel` and pass B
// `_make_apply_kernel`.  The glue between them (the SCA scale s = mean @ W
// + b, O(C^2) per image) stays plain torch in the wrapper,
// ops/pallas/nafblock.py.
//
// The gate channel j needs only channel j of each half of conv1, so both
// passes build the gate kGC channels at a time: one product makes the
// chunk's two conv1 halves (w1's outputs are interleaved per chunk), the
// 3x3 depthwise stencil and the product of the halves follow in shared
// memory.
//
// Pass A (nafblock_sum_kernel): one CTA per (tile split, image).  A CTA
// walks a fixed, strided list of spatial tiles; for each it computes LN1 on
// the tile plus a 1-pixel halo, and per gate chunk conv1, zeroes its output
// (bias included) outside the image on all four sides (the reference zero-
// pads the dwconv's input), the dwconv plus its bias, the gate, and adds the
// gate's pixel sum over the tile to a per-channel f32 sum.  Each CTA writes
// its own partial sums; the wrapper adds them over the split axis with
// torch.sum in a fixed order.  No float atomics: a repeated call is bitwise
// equal.  Only pixels of a window of rows [row_lo, row_hi) count
// (`nafblock_sum_rows`; `nafblock_sum` takes every row): a slab of an image
// split by rows over ranks runs the block on its rows and a 1-row halo of
// its neighbours', and its sums, added over the ranks, take its own rows
// only.
//
// Pass B (nafblock_apply_kernel): one CTA per output tile.  It recomputes
// the gate chunk by chunk as pass A does, scales it by s and accumulates
// conv3 over the chunks in f32; then y1 = x + (conv3 + b3) * beta, LN2, and
// per chunk the two halves of conv4, their product, and conv5 accumulated
// in f32; then out = y1 + (conv5 + b5) * gamma.  Only the output is written
// to memory.
//
// Rounding points mirror the JAX kernel: every product sums in f32 and is
// cast to the compute dtype before its bias is added in that dtype; the
// dwconv sums in f32 with f32 taps and adds its bias before one cast; the
// gate, the SCA product and the residuals are in the compute dtype; the
// LayerNorms are f32 with eps 1e-6.  The biases, beta and gamma arrive as
// f32 arrays holding compute-dtype values.
//
// What bounds it on the card: products, 12 C^2 operations per pixel (conv1
// 4, conv3 2, conv4 4, conv5 2), far above the bytes it must move at every
// width of the model (C = 64..2048).  A tile holds LN1 of its pixels and
// their 1-pixel halo at full width in shared memory, so tiles shrink as C
// grows (4 x 8 pixels up to C = 512 in bf16, 2 x 2 at C = 2048), and each
// CTA reads all of the block's weights (6 C^2 values) through L2 for its
// few pixels; conv1 is also recomputed on the halo, by both passes.  What
// the design does: no intermediate crosses device memory (the 2C-wide
// tensors of the op chain cross it ~10 times); in bf16 every product with
// K % 16 == 0 runs on mma.sync m16n8k16 with f32 sums (tblock_common.cuh
// `gemm`), each B fragment feeding up to four 16-pixel row tiles.  float32,
// and bf16 at other widths, use f32 FMA loops.  wgmma, TMA and weights
// staged in shared memory are left for later work.

#include "tblock_common.cuh"

namespace {

constexpr int kGC = 32;           // gate-channel chunk; cpad % kGC == 0
constexpr float kNafEps = 1e-6f;  // LayerNorm2d

__host__ __device__ inline size_t align16(size_t n) {
  return (n + 15) / 16 * 16;
}

// Dynamic shared memory of pass A for a th x tw tile: the per-channel sums,
// LN1 on the haloed tile, the chunk's conv1 halves, the gate chunk.
size_t sum_smem_bytes(int C, int cpad, int th, int tw, int eb) {
  const int p1 = (th + 2) * (tw + 2), tp = th * tw;
  return align16((size_t)4 * cpad) +
         align16((size_t)eb * round_up(p1, kRowPad) * smem_ld(C)) +
         align16((size_t)eb * p1 * 2 * kGC) +
         (size_t)eb * round_up(tp, kRowPad) * smem_ld(kGC);
}

// Pass B: the f32 accumulator of conv3 then conv5, LN1 on the haloed tile
// (later LN2 on the tile), y1, the chunk's conv1/conv4 halves, the gate.
size_t apply_smem_bytes(int C, int th, int tw, int eb) {
  const int p1 = (th + 2) * (tw + 2), tp = th * tw;
  return align16((size_t)4 * tp * (C + kAccPad)) +
         align16((size_t)eb * round_up(p1, kRowPad) * smem_ld(C)) +
         align16((size_t)eb * tp * smem_ld(C)) +
         align16((size_t)eb * p1 * 2 * kGC) +
         (size_t)eb * round_up(tp, kRowPad) * smem_ld(kGC);
}

// hab[p][n] for the P pixels of the region whose top-left is image pixel
// (gy0, gx0), rw wide: n < kGC the first half of conv1 at gate channel
// j0 + n, n >= kGC the second half at j0 + n - kGC; conv1 output plus bias,
// zero outside the image.  w1 is (2 cpad, C) with the chunk's two halves in
// rows [2 j0, 2 j0 + 2 kGC); b1 is (2, cpad).
template <typename T>
__device__ void conv1_chunk(const T* ys, int ldc, int P, int C, const T* w1,
                            const float* b1, int cpad, int j0, int gy0,
                            int gx0, int rw, int H, int W, T* hab) {
  gemm(ys, ldc, P, C, weights(w1, 2 * cpad, C, 2 * j0, 0), 2 * kGC,
       [&](int p, int n, float a) {
         const int gy = gy0 + p / rw, gx = gx0 + p % rw;
         const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
         const float bias = b1[(n / kGC) * cpad + j0 + n % kGC];
         hab[p * 2 * kGC + n] = from_f<T>(in ? rnd<T>(a) + bias : 0.f);
       });
}

// The gate at gate channel j0 + j of the body pixel (py, px): both halves'
// 3x3 stencils over hab (rw pixels wide, the window's top-left at (py, px)),
// each plus its dwconv bias and cast, then their product, cast.  taps is
// (18, cpad) f32, the first half's taps in rows 0-8; dwb is (2, cpad).
template <typename T>
__device__ __forceinline__ float gate_at(const T* hab, int rw, int py, int px,
                                         int j, int j0, const float* taps,
                                         const float* dwb, int cpad) {
  const float da = stencil3x3(hab + j, rw, 2 * kGC, py, px, taps + j0 + j,
                              cpad, false);
  const float db = stencil3x3(hab + kGC + j, rw, 2 * kGC, py, px,
                              taps + 9 * (size_t)cpad + j0 + j, cpad, false);
  return rnd<T>(rnd<T>(da + dwb[j0 + j]) * rnd<T>(db + dwb[cpad + j0 + j]));
}

// ---------------------------------------------------------------------------
// Pass A: per-image, per-channel pixel sums of the gate, per-CTA partials
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads) nafblock_sum_kernel(
    const T* __restrict__ x, const float* __restrict__ lnw,
    const float* __restrict__ lnb, const T* __restrict__ w1,
    const float* __restrict__ b1, const float* __restrict__ taps,
    const float* __restrict__ dwb, float* __restrict__ sum_part, int H, int W,
    int C, int cpad, int th, int tw, int row_lo, int row_hi) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int split = blockIdx.x, nsplit = gridDim.x, b = blockIdx.y;
  const int rw = tw + 2, p1 = (th + 2) * rw, tp = th * tw;
  const int ldc = smem_ld(C), ldg = smem_ld(kGC);
  const int ntx = (W + tw - 1) / tw;
  const int ntiles = ((H + th - 1) / th) * ntx;

  unsigned char* at = smem_raw;
  float* csum = reinterpret_cast<float*>(at);  // [cpad] f32
  at += align16((size_t)4 * cpad);
  T* ys = reinterpret_cast<T*>(at);  // [p1 rows][ldc]
  at += align16(sizeof(T) * (size_t)round_up(p1, kRowPad) * ldc);
  T* hab = reinterpret_cast<T*>(at);  // [p1][2 kGC]
  at += align16(sizeof(T) * (size_t)p1 * 2 * kGC);
  T* gbuf = reinterpret_cast<T*>(at);  // [tp rows][ldg]

  for (int i = threadIdx.x; i < cpad; i += blockDim.x) csum[i] = 0.f;
  const T* xb = x + (size_t)b * H * W * C;
  for (int t = split; t < ntiles; t += nsplit) {
    const int oy = (t / ntx) * th, ox = (t % ntx) * tw;
    ln_region(xb, H, W, C, oy - 1, ox - 1, th + 2, rw, lnw, lnb, false, ys,
              ldc, kNafEps);
    __syncthreads();
    for (int j0 = 0; j0 < cpad; j0 += kGC) {
      conv1_chunk(ys, ldc, p1, C, w1, b1, cpad, j0, oy - 1, ox - 1, rw, H, W,
                  hab);
      __syncthreads();
      for (int idx = threadIdx.x; idx < tp * kGC; idx += blockDim.x) {
        const int p = idx / kGC, j = idx % kGC;
        const int py = p / tw, px = p % tw;
        // pixels of the tile outside the image or the row window add
        // nothing to the sums
        const bool in = oy + py >= row_lo && oy + py < row_hi && ox + px < W;
        gbuf[p * ldg + j] = from_f<T>(
            in ? gate_at<T>(hab, rw, py, px, j, j0, taps, dwb, cpad) : 0.f);
      }
      __syncthreads();
      // one thread per channel, pixels in a fixed order: repeatable sums
      if ((int)threadIdx.x < kGC) {
        float s = 0.f;
        for (int p = 0; p < tp; ++p) s += to_f(gbuf[p * ldg + threadIdx.x]);
        csum[j0 + threadIdx.x] += s;
      }
    }
    __syncthreads();
  }

  float* dst = sum_part + ((size_t)b * nsplit + split) * cpad;
  for (int i = threadIdx.x; i < cpad; i += blockDim.x) dst[i] = csum[i];
}

// ---------------------------------------------------------------------------
// Pass B: gate * s, conv3, beta residual, LN2, pointwise FFN, gamma residual
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads) nafblock_apply_kernel(
    const T* __restrict__ x, const float* __restrict__ ln1w,
    const float* __restrict__ ln1b, const T* __restrict__ w1,
    const float* __restrict__ b1, const float* __restrict__ taps,
    const float* __restrict__ dwb, const T* __restrict__ s,
    const T* __restrict__ w3, const float* __restrict__ ln2w,
    const float* __restrict__ ln2b, const T* __restrict__ w4,
    const float* __restrict__ b4, const T* __restrict__ w5,
    const float* __restrict__ bg, T* __restrict__ out, int H, int W, int C,
    int cpad, int th, int tw) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int b = blockIdx.z, oy = blockIdx.y * th, ox = blockIdx.x * tw;
  const int rw = tw + 2, p1 = (th + 2) * rw, tp = th * tw;
  const int ldc = smem_ld(C), ldg = smem_ld(kGC), lda = C + kAccPad;

  unsigned char* at = smem_raw;
  float* acc = reinterpret_cast<float*>(at);  // [tp][lda] f32
  at += align16((size_t)4 * tp * lda);
  T* ys = reinterpret_cast<T*>(at);  // [p1 rows][ldc]: LN1, then LN2
  at += align16(sizeof(T) * (size_t)round_up(p1, kRowPad) * ldc);
  T* y1s = reinterpret_cast<T*>(at);  // [tp][ldc]
  at += align16(sizeof(T) * (size_t)tp * ldc);
  T* hab = reinterpret_cast<T*>(at);  // [p1][2 kGC]
  at += align16(sizeof(T) * (size_t)p1 * 2 * kGC);
  T* gbuf = reinterpret_cast<T*>(at);  // [tp rows][ldg]

  const T* xb = x + (size_t)b * H * W * C;
  const T* sb = s + (size_t)b * C;
  auto in_image = [&](int p) { return oy + p / tw < H && ox + p % tw < W; };

  // 1. LN1 on the haloed tile; zero the accumulator
  ln_region(xb, H, W, C, oy - 1, ox - 1, th + 2, rw, ln1w, ln1b, false, ys,
            ldc, kNafEps);
  for (int i = threadIdx.x; i < tp * lda; i += blockDim.x) acc[i] = 0.f;
  __syncthreads();

  // 2. per gate chunk: the gate times s, then conv3 accumulated in f32
  for (int j0 = 0; j0 < cpad; j0 += kGC) {
    conv1_chunk(ys, ldc, p1, C, w1, b1, cpad, j0, oy - 1, ox - 1, rw, H, W,
                hab);
    __syncthreads();
    for (int idx = threadIdx.x; idx < tp * kGC; idx += blockDim.x) {
      const int p = idx / kGC, j = idx % kGC;
      const float sv = j0 + j < C ? to_f(sb[j0 + j]) : 0.f;
      gbuf[p * ldg + j] = from_f<T>(
          gate_at<T>(hab, rw, p / tw, p % tw, j, j0, taps, dwb, cpad) * sv);
    }
    __syncthreads();
    gemm(gbuf, ldg, tp, kGC, weights(w3, C, cpad, 0, j0), C,
         [&](int p, int n, float a) { acc[p * lda + n] += a; });
    __syncthreads();
  }

  // 3. y1 = x + (conv3 + b3) * beta on the tile (0 outside the image);
  //    bg rows: 0 = b3, 1 = beta, 2 = b5, 3 = gamma
  for (int idx = threadIdx.x; idx < tp * C; idx += blockDim.x) {
    const int p = idx / C, n = idx % C;
    float v = 0.f;
    if (in_image(p)) {
      const float o = rnd<T>(rnd<T>(acc[p * lda + n]) + bg[n]);
      const size_t xo = ((size_t)(oy + p / tw) * W + ox + p % tw) * C + n;
      v = to_f(xb[xo]) + rnd<T>(o * bg[C + n]);
    }
    y1s[(size_t)p * ldc + n] = from_f<T>(v);
    acc[p * lda + n] = 0.f;
  }
  __syncthreads();

  // 4. z = LN2(y1) into the first tp rows of ys
  {
    const int lane = threadIdx.x & 31;
    for (int p = threadIdx.x >> 5; p < tp; p += blockDim.x >> 5)
      ln_pixel(y1s + (size_t)p * ldc, ys + (size_t)p * ldc, C, ln2w, ln2b,
               false, lane, kNafEps);
  }
  __syncthreads();

  // 5. per gate chunk: both halves of conv4 plus bias, their product, then
  //    conv5 accumulated in f32
  for (int j0 = 0; j0 < cpad; j0 += kGC) {
    gemm(ys, ldc, tp, C, weights(w4, 2 * cpad, C, 2 * j0, 0), 2 * kGC,
         [&](int p, int n, float a) {
           hab[p * 2 * kGC + n] =
               from_f<T>(rnd<T>(a) + b4[(n / kGC) * cpad + j0 + n % kGC]);
         });
    __syncthreads();
    for (int idx = threadIdx.x; idx < tp * kGC; idx += blockDim.x) {
      const int p = idx / kGC, j = idx % kGC;
      gbuf[p * ldg + j] = from_f<T>(to_f(hab[p * 2 * kGC + j]) *
                                    to_f(hab[p * 2 * kGC + kGC + j]));
    }
    __syncthreads();
    gemm(gbuf, ldg, tp, kGC, weights(w5, C, cpad, 0, j0), C,
         [&](int p, int n, float a) { acc[p * lda + n] += a; });
    __syncthreads();
  }

  // 6. out = y1 + (conv5 + b5) * gamma on the tile's pixels in the image
  for (int idx = threadIdx.x; idx < tp * C; idx += blockDim.x) {
    const int p = idx / C, n = idx % C;
    if (!in_image(p)) continue;
    const float o2 = rnd<T>(rnd<T>(acc[p * lda + n]) + bg[2 * C + n]);
    const size_t oo =
        (((size_t)b * H + oy + p / tw) * W + ox + p % tw) * C + n;
    out[oo] = from_f<T>(to_f(y1s[(size_t)p * ldc + n]) +
                        rnd<T>(o2 * bg[3 * C + n]));
  }
}

template <typename T>
int launch_sum(const void* x, const void* lnw, const void* lnb,
               const void* w1, const void* b1, const void* taps,
               const void* dwb, void* sum_part, int B, int H, int W, int C,
               int cpad, int th, int tw, int nsplit, int row_lo, int row_hi,
               cudaStream_t stream) {
  const size_t smem = sum_smem_bytes(C, cpad, th, tw, sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(
      nafblock_sum_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  nafblock_sum_kernel<T><<<dim3(nsplit, B), kThreads, smem, stream>>>(
      (const T*)x, (const float*)lnw, (const float*)lnb, (const T*)w1,
      (const float*)b1, (const float*)taps, (const float*)dwb,
      (float*)sum_part, H, W, C, cpad, th, tw, row_lo, row_hi);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_apply(const void* x, const void* ln1w, const void* ln1b,
                 const void* w1, const void* b1, const void* taps,
                 const void* dwb, const void* s, const void* w3,
                 const void* ln2w, const void* ln2b, const void* w4,
                 const void* b4, const void* w5, const void* bg, void* out,
                 int B, int H, int W, int C, int cpad, int th, int tw,
                 cudaStream_t stream) {
  const size_t smem = apply_smem_bytes(C, th, tw, sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(
      nafblock_apply_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W + tw - 1) / tw, (H + th - 1) / th, B);
  nafblock_apply_kernel<T><<<grid, kThreads, smem, stream>>>(
      (const T*)x, (const float*)ln1w, (const float*)ln1b, (const T*)w1,
      (const float*)b1, (const float*)taps, (const float*)dwb, (const T*)s,
      (const T*)w3, (const float*)ln2w, (const float*)ln2b, (const T*)w4,
      (const float*)b4, (const T*)w5, (const float*)bg, (T*)out, H, W, C,
      cpad, th, tw);
  return (int)cudaGetLastError();
}

template <typename K>
cudaError_t occupancy(K kernel, size_t smem, int* n) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(n, kernel, kThreads,
                                                       smem);
}

bool shape_ok(int B, int H, int W, int C, int cpad, int th, int tw) {
  return B > 0 && H > 0 && W > 0 && C > 0 && cpad >= C && cpad % kGC == 0 &&
         th > 0 && tw > 0;
}

}  // namespace

extern "C" {

// Dynamic shared memory of pass A (pass == 0) or pass B (pass == 1) for a
// th x tw tile; the wrapper picks tiles with it.
long long nafblock_smem_bytes(int pass, int C, int th, int tw,
                              int elem_bytes) {
  const int cpad = round_up(C, kGC);
  if (pass == 0)
    return (long long)sum_smem_bytes(C, cpad, th, tw, elem_bytes);
  return (long long)apply_smem_bytes(C, th, tw, elem_bytes);
}

int nafblock_gate_chunk() { return kGC; }

// CTAs of pass A (pass == 0) or pass B (pass == 1) that one SM holds at
// once for a th x tw tile (registers and shared memory), or -1 on error.
int nafblock_ctas_per_sm(int pass, int C, int th, int tw, int is_bf16) {
  const int eb = is_bf16 ? 2 : 4;
  const size_t smem = pass == 0
                          ? sum_smem_bytes(C, round_up(C, kGC), th, tw, eb)
                          : apply_smem_bytes(C, th, tw, eb);
  int n = -1;
  cudaError_t err;
  if (is_bf16 && pass == 0) {
    err = occupancy(nafblock_sum_kernel<__nv_bfloat16>, smem, &n);
  } else if (is_bf16) {
    err = occupancy(nafblock_apply_kernel<__nv_bfloat16>, smem, &n);
  } else if (pass == 0) {
    err = occupancy(nafblock_sum_kernel<float>, smem, &n);
  } else {
    err = occupancy(nafblock_apply_kernel<float>, smem, &n);
  }
  return err == cudaSuccess ? n : -1;
}

// Weight matrices are (outputs, inputs) for bf16 and (inputs, outputs) for
// float32 (see `weights`); the shapes below are the bf16 ones.  cpad is C
// rounded up to the gate chunk; weights, taps and biases are zero past C.
//
// x: (B, H, W, C); lnw, lnb: (C,) f32; w1: (2 cpad, C), per gate chunk of
// kGC its first-half rows, then its second-half rows; b1, dwb: (2, cpad)
// f32; taps: (18, cpad) f32, the first half's taps in rows 0-8; sum_part:
// (B, nsplit, cpad) f32, the gate's sums over the pixels of image rows
// [row_lo, row_hi) (0 <= row_lo <= row_hi <= H; a row-sharded slab's own
// rows, without its halo).  Returns a cudaError_t.
int nafblock_sum_rows(const void* x, const void* lnw, const void* lnb,
                      const void* w1, const void* b1, const void* taps,
                      const void* dwb, void* sum_part, int B, int H, int W,
                      int C, int cpad, int is_bf16, int th, int tw,
                      int nsplit, int row_lo, int row_hi, void* stream) {
  if (!shape_ok(B, H, W, C, cpad, th, tw) || nsplit <= 0 || row_lo < 0 ||
      row_hi < row_lo || row_hi > H)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16)
    return launch_sum<__nv_bfloat16>(x, lnw, lnb, w1, b1, taps, dwb,
                                     sum_part, B, H, W, C, cpad, th, tw,
                                     nsplit, row_lo, row_hi, st);
  return launch_sum<float>(x, lnw, lnb, w1, b1, taps, dwb, sum_part, B, H, W,
                           C, cpad, th, tw, nsplit, row_lo, row_hi, st);
}

// nafblock_sum_rows over every row of x.
int nafblock_sum(const void* x, const void* lnw, const void* lnb,
                 const void* w1, const void* b1, const void* taps,
                 const void* dwb, void* sum_part, int B, int H, int W, int C,
                 int cpad, int is_bf16, int th, int tw, int nsplit,
                 void* stream) {
  return nafblock_sum_rows(x, lnw, lnb, w1, b1, taps, dwb, sum_part, B, H, W,
                           C, cpad, is_bf16, th, tw, nsplit, 0, H, stream);
}

// s: (B, C) in x's dtype, the SCA scale; w3, w5: (C, cpad); w4 and b4 as w1
// and b1; bg: (4, C) f32, rows b3, beta, b5, gamma; out: (B, H, W, C).
// Returns a cudaError_t.
int nafblock_apply(const void* x, const void* ln1w, const void* ln1b,
                   const void* w1, const void* b1, const void* taps,
                   const void* dwb, const void* s, const void* w3,
                   const void* ln2w, const void* ln2b, const void* w4,
                   const void* b4, const void* w5, const void* bg, void* out,
                   int B, int H, int W, int C, int cpad, int is_bf16, int th,
                   int tw, void* stream) {
  if (!shape_ok(B, H, W, C, cpad, th, tw)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16)
    return launch_apply<__nv_bfloat16>(x, ln1w, ln1b, w1, b1, taps, dwb, s,
                                       w3, ln2w, ln2b, w4, b4, w5, bg, out, B,
                                       H, W, C, cpad, th, tw, st);
  return launch_apply<float>(x, ln1w, ln1b, w1, b1, taps, dwb, s, w3, ln2w,
                             ln2b, w4, b4, w5, bg, out, B, H, W, C, cpad, th,
                             tw, st);
}

}  // extern "C"
