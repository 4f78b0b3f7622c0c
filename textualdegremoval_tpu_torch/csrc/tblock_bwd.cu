// Backward of the GDFN half of the Restormer TransformerBlock for Hopper
// (sm_90a), in float32 (the parity path; bf16 runs the passes of
// bwd_stencil.cu and bwd_gemm.cu):
//
//   out = x1 + W2(gelu(d1) * d2),  (d1, d2) = dw3x3(mask(LN2(x1) . W1))
//
// Replaces the TPU kernel `_make_gdfn_bwd_kernel` of
// textualdegremoval_tpu/ops/pallas/tblock_bwd.py (wrapper `gdfn_half_bwd`).
// Given x1 and dout = dL/dout it computes dx1 and every parameter gradient
// of the half (dW1, the 18 x hpad dwconv taps, dW2, dLN2 weight and bias),
// with the hidden tensors (5.32 C wide) and their gradients kept in shared
// memory, as on the TPU:
//
//   dgate = dout . W2^T;  dd1 = dgate d2 gelu'(d1);  dd2 = dgate gelu(d1)
//   dhid = dw3x3^T(dd) (flipped taps);  dtap_j = sum_p shift_j(hid) dd
//   dz = dhid . W1^T;  dx1 = dout + LN2-backward(dz)
//
// One CTA per (tile split, image) walks a fixed, strided list of th x tw
// tiles (tiles cut H and W, all four image edges masked).  For each tile:
// LN2 of x1 on a 2-pixel halo, dout on a 1-pixel halo (zero outside the
// image: gradients at pixels that do not exist), then per 32-wide hidden
// chunk: hid = z . W1 (both halves in one product, rounded to the model
// dtype, zero outside the image), d1/d2 on the 1-pixel halo, dgate there,
// dd (f32, zero outside the image), the tap gradients, dhid on the tile
// from dd rounded to the model dtype, and dz += dhid . W1^T in f32.  Last,
// the LN2 backward per pixel writes dx1.
//
// Rounding points are those of the TPU kernel: hid is cast to the model
// dtype after its product (tblock_bwd.py:148), dd before the flipped
// stencil (:185-186), the gate and dhid before their weight products; the
// tap gradients take dd in f32 (:197-212).
//
// The reductions over pixels: the tap gradients and the LN2 parameter
// gradients are per-CTA partials (a CTA owns its slab of the partial
// buffers and adds into it in tile order; the wrapper sums the slabs with
// torch.sum), so the result is bitwise repeatable.  dW1 = z^T dhid and
// dW2 = gate^T dout are too wide for a partial per CTA (C x 2 hpad f32 is
// 12.6 MB at C = 768), so this kernel writes z, gate and dhid of the body
// pixels to scratch and wgrad.cu reduces them over pixels.
//
// What bounds it on the card: like the forward's pass B, the products have
// K = C or 64 and the stencils are load/FMA work on the CUDA cores; the
// scratch writes of gate and dhid (3 hpad values per pixel) are the bulk
// of its memory traffic.  The products run on FMA loops
// (tblock_common.cuh `gemm`).

#include "tblock_common.cuh"

namespace {

size_t gdfn_bwd_smem_bytes(int C, int th, int tw, int eb) {
  const int p2 = (th + 4) * (tw + 4), p1 = (th + 2) * (tw + 2), tp = th * tw;
  return (size_t)4 * ((size_t)tp * (C + kAccPad) + (size_t)p1 * 3 * kHC +
                      2 * tp + 2 * C) +
         (size_t)eb * ((size_t)round_up(p2, kRowPad) * smem_ld(C) +
                       (size_t)round_up(p1, kRowPad) * smem_ld(C) +
                       (size_t)p2 * 2 * kHC +
                       (size_t)round_up(tp, kRowPad) * smem_ld(2 * kHC));
}

template <typename T>
__global__ void __launch_bounds__(kThreads) gdfn_bwd_kernel(
    const T* __restrict__ x1, const T* __restrict__ dout,
    const float* __restrict__ ln2w, const float* __restrict__ ln2b,
    const T* __restrict__ w1, const T* __restrict__ w1t,
    const float* __restrict__ dwg, const T* __restrict__ w2t,
    T* __restrict__ dx1, T* __restrict__ zs, T* __restrict__ gates,
    T* __restrict__ dhids, float* __restrict__ dtap_part,
    float* __restrict__ dln_part, int H, int W, int C, int hpad,
    int bias_free, int th, int tw) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int split = blockIdx.x, nsplit = gridDim.x, b = blockIdx.y;
  const int w2w = tw + 4, p2 = (th + 4) * w2w;  // 2-pixel halo region
  const int w1w = tw + 2, p1 = (th + 2) * w1w;  // 1-pixel halo region
  const int tp = th * tw;
  const int ldc = smem_ld(C), ldh = smem_ld(2 * kHC), lda_acc = C + kAccPad;
  const int ntx = (W + tw - 1) / tw, ntiles = ((H + th - 1) / th) * ntx;
  const bool bf = bias_free != 0;
  const int lane = threadIdx.x & 31;

  float* dz = reinterpret_cast<float*>(smem_raw);  // [tp][lda_acc]
  float* dgate = dz + (size_t)tp * lda_acc;        // [p1][kHC]
  float* dd = dgate + (size_t)p1 * kHC;            // [p1][2 kHC]: dd1 | dd2
  float* mu = dd + (size_t)p1 * 2 * kHC;           // [tp]
  float* inv = mu + tp;                            // [tp]
  float* dlnw = inv + tp;                          // [C]
  float* dlnb = dlnw + C;                          // [C]
  T* zb = reinterpret_cast<T*>(dlnb + C);          // [p2 rows][ldc]
  T* gb = zb + (size_t)round_up(p2, kRowPad) * ldc;  // [p1 rows][ldc]
  T* hid = gb + (size_t)round_up(p1, kRowPad) * ldc;  // [p2][2 kHC]
  T* dh = hid + (size_t)p2 * 2 * kHC;              // [tp rows][ldh]

  // this CTA's slab of the tap-gradient partials: rows 0-8 the taps of the
  // first hidden half, 9-17 of the second
  float* dtap = dtap_part + ((size_t)b * nsplit + split) * 18 * hpad;
  for (int i = threadIdx.x; i < 18 * hpad; i += blockDim.x) dtap[i] = 0.f;
  for (int c = threadIdx.x; c < C; c += blockDim.x) dlnw[c] = dlnb[c] = 0.f;

  const size_t img = (size_t)b * H * W * C;
  const T* xb = x1 + img;
  const T* gsrc = dout + img;
  for (int t = split; t < ntiles; t += nsplit) {
    const int oy = (t / ntx) * th, ox = (t % ntx) * tw;
    auto in_image = [&](int gy, int gx) {
      return gy >= 0 && gy < H && gx >= 0 && gx < W;
    };
    auto body_in = [&](int p) { return in_image(oy + p / tw, ox + p % tw); };
    // global pixel index of body pixel p (valid when body_in(p))
    auto pix = [&](int p) {
      return ((size_t)b * H + oy + p / tw) * W + ox + p % tw;
    };

    // 1. z = LN2(x1) on the 2-pixel halo, dout on the 1-pixel halo, the
    //    body pixels' LN2 moments; zero the dz accumulator
    ln_region(xb, H, W, C, oy - 2, ox - 2, th + 4, w2w, ln2w, ln2b, bf, zb,
              ldc);
    load_region(gsrc, H, W, C, oy - 1, ox - 1, th + 2, w1w, gb, ldc);
    for (int p = threadIdx.x >> 5; p < tp; p += kWarps) {
      float m = 0.f, iv = 0.f;
      if (body_in(p))
        ln_moments(xb + ((size_t)(oy + p / tw) * W + ox + p % tw) * C, C,
                   lane, m, iv);
      if (lane == 0) {
        mu[p] = m;
        inv[p] = iv;
      }
    }
    for (int i = threadIdx.x; i < tp * lda_acc; i += blockDim.x) dz[i] = 0.f;
    __syncthreads();
    // z of the body pixels feeds dW1 = z^T dhid (wgrad.cu)
    for (int idx = threadIdx.x; idx < tp * C; idx += blockDim.x) {
      const int p = idx / C, c = idx % C;
      if (body_in(p))
        zs[pix(p) * C + c] =
            zb[((size_t)(p / tw + 2) * w2w + p % tw + 2) * ldc + c];
    }

    for (int c0 = 0; c0 < hpad; c0 += kHC) {
      // a. hid = mask(z . W1) for the chunk's h1 and h2 columns on the
      //    2-pixel halo; w1 rows [2 c0, 2 c0 + kHC) are h1, the next kHC h2
      gemm(zb, ldc, p2, C, weights(w1, 2 * hpad, C, 2 * c0, 0), 2 * kHC,
           [&](int q, int n, float a) {
             const bool in = in_image(oy - 2 + q / w2w, ox - 2 + q % w2w);
             hid[(size_t)q * 2 * kHC + n] = from_f<T>(in ? a : 0.f);
           });
      // b. dgate = dout . W2[chunk]^T on the 1-pixel halo (f32)
      gemm(gb, ldc, p1, C, weights(w2t, hpad, C, c0, 0), kHC,
           [&](int q, int n, float a) { dgate[q * kHC + n] = a; });
      __syncthreads();

      // c. d1, d2 on the 1-pixel halo; dd (zero outside the image); the
      //    gate of the body pixels feeds dW2 = gate^T dout (wgrad.cu)
      for (int idx = threadIdx.x; idx < p1 * kHC; idx += blockDim.x) {
        const int q = idx / kHC, j = idx % kHC;
        const int qy = q / w1w, qx = q % w1w;
        const float d1 = stencil3x3(hid + j, w2w, 2 * kHC, qy, qx,
                                    dwg + c0 + j, hpad, false);
        const float d2 = stencil3x3(hid + kHC + j, w2w, 2 * kHC, qy, qx,
                                    dwg + 9 * hpad + c0 + j, hpad, false);
        const bool in = in_image(oy - 1 + qy, ox - 1 + qx);
        const float g = dgate[q * kHC + j], ga = gelu_erf(d1);
        dd[q * 2 * kHC + j] = in ? g * d2 * gelu_erf_grad(d1) : 0.f;
        dd[q * 2 * kHC + kHC + j] = in ? g * ga : 0.f;
        if (in && qy >= 1 && qy <= th && qx >= 1 && qx <= tw)
          gates[(((size_t)b * H + oy - 1 + qy) * W + ox - 1 + qx) * hpad +
                c0 + j] = from_f<T>(ga * d2);
      }
      __syncthreads();

      // d. tap gradients of the chunk over the body pixels:
      //    dtap[half * 9 + tap][c0 + j] += sum_p hid[p + tap] dd[p]
      for (int idx = threadIdx.x; idx < 18 * kHC; idx += blockDim.x) {
        const int row = idx / kHC, j = idx % kHC;
        const int half = row / 9, dy = (row % 9) / 3, dx = row % 3;
        const int n = half * kHC + j;
        float s = 0.f;
        for (int p = 0; p < tp; ++p) {
          const int py = p / tw, px = p % tw;
          s += to_f(hid[((size_t)(py + 1 + dy) * w2w + px + 1 + dx) * 2 * kHC +
                        n]) *
               dd[((py + 1) * w1w + px + 1) * 2 * kHC + n];
        }
        dtap[(size_t)row * hpad + c0 + j] += s;
      }
      // e. dhid on the body = flipped stencil of dd rounded to T
      for (int idx = threadIdx.x; idx < tp * 2 * kHC; idx += blockDim.x) {
        const int p = idx / (2 * kHC), n = idx % (2 * kHC);
        const int half = n / kHC, j = n % kHC;
        const int py = p / tw, px = p % tw;
        float a = 0.f;
        for (int dy = 0; dy < 3; ++dy)
          for (int dx = 0; dx < 3; ++dx)
            a += rnd<T>(dd[((py + 2 - dy) * w1w + px + 2 - dx) * 2 * kHC + n]) *
                 dwg[(size_t)(half * 9 + dy * 3 + dx) * hpad + c0 + j];
        const T v = from_f<T>(a);
        dh[(size_t)p * ldh + n] = v;
        if (body_in(p)) dhids[pix(p) * 2 * hpad + half * hpad + c0 + j] = v;
      }
      __syncthreads();

      // f. dz += dhid . W1^T over the chunk's 2 kHC hidden columns
      gemm(dh, ldh, tp, 2 * kHC, weights(w1t, C, 2 * hpad, 0, 2 * c0), C,
           [&](int p, int n, float a) { dz[p * lda_acc + n] += a; });
      __syncthreads();
    }

    // LN2 parameter gradients (per-CTA partials) and dx1 = dout + LN2-bwd
    ln_param_grads(xb, W, C, oy, ox, th, tw, dz, lda_acc, mu, inv, bf, dlnw,
                   dlnb, body_in);
    for (int p = threadIdx.x >> 5; p < tp; p += kWarps) {
      if (!body_in(p)) continue;
      const size_t o = pix(p) * C;
      ln_bwd_pixel(x1 + o, dz + (size_t)p * lda_acc, ln2w, mu[p], inv[p], bf,
                   dout + o, dx1 + o, C, lane);
    }
    __syncthreads();
  }
  float* dl = dln_part + ((size_t)b * nsplit + split) * 2 * C;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    dl[c] = dlnw[c];
    dl[C + c] = dlnb[c];
  }
}

template <typename T>
int launch_gdfn_bwd(const void* x1, const void* dout, const void* ln2w,
                    const void* ln2b, const void* w1, const void* w1t,
                    const void* dwg, const void* w2t, void* dx1, void* zs,
                    void* gates, void* dhids, void* dtap_part, void* dln_part,
                    int B, int H, int W, int C, int hpad, int bias_free,
                    int th, int tw, int nsplit, cudaStream_t stream) {
  const size_t smem = gdfn_bwd_smem_bytes(C, th, tw, sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(
      gdfn_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  gdfn_bwd_kernel<T><<<dim3(nsplit, B), kThreads, smem, stream>>>(
      (const T*)x1, (const T*)dout, (const float*)ln2w, (const float*)ln2b,
      (const T*)w1, (const T*)w1t, (const float*)dwg, (const T*)w2t,
      (T*)dx1, (T*)zs, (T*)gates, (T*)dhids, (float*)dtap_part,
      (float*)dln_part, H, W, C, hpad, bias_free, th, tw);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

long long tblock_gdfn_bwd_smem_bytes(int C, int th, int tw, int elem_bytes) {
  return (long long)gdfn_bwd_smem_bytes(C, th, tw, elem_bytes);
}

// float32; weight matrices (inputs, outputs) as in tblock.cu.  x1, dout,
// dx1: (B, H, W, C); w1: the forward's (C, 2 hpad) interleaved per hidden
// chunk; w1t: its transpose (2 hpad, C) in the same order; dwg: (18, hpad);
// w2t: (C, hpad), the product dout -> dgate.  Outputs: dx1; zs (B H W,
// C), gates (B H W, hpad), dhids (B H W, 2 hpad: first half, then second)
// for wgrad; dtap_part (B nsplit, 18, hpad) and dln_part (B nsplit, 2, C)
// per-CTA partials.
// Returns a cudaError_t.
int tblock_gdfn_bwd(const void* x1, const void* dout, const void* ln2w,
                    const void* ln2b, const void* w1, const void* w1t,
                    const void* dwg, const void* w2t, void* dx1, void* zs,
                    void* gates, void* dhids, void* dtap_part, void* dln_part,
                    int B, int H, int W, int C, int hpad, int bias_free,
                    int th, int tw, int nsplit, void* stream) {
  if (C <= 0 || hpad <= 0 || hpad % kHC || th <= 0 || tw <= 0 || nsplit <= 0)
    return (int)cudaErrorInvalidValue;
  return launch_gdfn_bwd<float>(x1, dout, ln2w, ln2b, w1, w1t, dwg, w2t, dx1,
                                zs, gates, dhids, dtap_part, dln_part, B, H,
                                W, C, hpad, bias_free, th, tw, nsplit,
                                (cudaStream_t)stream);
}

}  // extern "C"
