// The CUDA-core passes of the Restormer TransformerBlock backward in bf16
// for Hopper (sm_90a): the LayerNorms per pixel, and the depthwise
// stencils on halo tiles that TMA loads.
//
// Together with the products of bwd_gemm.cu and wgrad.cu they replace the
// bf16 paths of the TPU kernels `_make_gdfn_bwd_kernel`
// (textualdegremoval_tpu/ops/pallas/tblock_bwd.py, wrapper
// `gdfn_half_bwd`), `_make_attn_bwd_stats_kernel` and
// `_make_attn_bwd_apply_kernel` (ops/pallas/tblock_attn_bwd.py,
// `attn_half_bwd`'s passes 1 and 2):
//
//   GDFN half (x1, dout -> dx1):
//     bwd_ln_rows       z = LN2(x1) (bf16) and each pixel's moments
//     [bwd_gemm]        hid = z . W1 (bf16), dgate = dout . W2^T (f32)
//     bwd_gdfn_stencil  d1, d2 = dw3x3(hid) on the tile's 1-pixel halo,
//                       dd1 = dgate d2 gelu'(d1), dd2 = dgate gelu(d1)
//                       (f32, shared memory only), the gate gelu(d1) d2
//                       and dhid = dw3x3^T(dd) of the body (bf16), the tap
//                       gradients sum_p shift_t(hid) dd
//     [bwd_dgrad]       dz = dhid . W1^T (f32)
//     bwd_ln_rows_bwd   dx1 = dout + LN2-bwd(dz), the LN2 partials
//   attention half, pass 1 (x, dx1 -> what pass 2 and the weight
//   gradients read; ops/pallas/tblock_attn_bwd.py `_attn_pass1_bf16`):
//     bwd_ln_rows       y = LN1(x) (bf16) and each pixel's moments
//     [bwd_gemm]        lin = y . Wqkv (bf16)
//     [fwd_qkv_stencil] q | k | v = dw3x3(lin) (bf16; fwd_stencil.cu, its
//                       square sums off)
//     [attn_heads_o]    o = v . A_h^T per (image, head) (bf16)
//     [bwd_gemm]        do = dx1 . Wproj^T (bf16)
//     [tblock_wgrad]    dA = do_h^T v_h per (image, head), dWproj = o^T dx1
//   attention half, pass 2 (pass 1's y, lin, q | k | v and do -> dx):
//     [bwd_head_products]  dth: the three thirds' attention terms (f32)
//     bwd_dlin_stencil  dlin = dw3x3^T(dth) (bf16), the tap gradients
//                       sum_p shift_t(lin) dth
//     [bwd_dgrad]       dy = dlin . Wqkv^T (f32)
//     bwd_ln_rows_bwd   dx = dx1 + LN1-bwd(dy), the LN1 partials
//
// The rounding points are the TPU kernels': hid, lin, q, k, v, o, do, the
// gate, dhid and dlin in bf16; dd and dth in f32 for the tap gradients,
// rounded to bf16 only as the flipped stencil's input (tblock_bwd.py:
// 185-212, tblock_attn_bwd.py:112-160 and 240-256); every sum in f32.
//
// What bounds them: the stencils are CUDA-core work (per body pixel and
// hidden channel 2 x 9 forward taps, gelu and its derivative, 18 tap
// products, 18 flipped taps) and the bytes of the operands they stream
// (hid and dgate: 6 hpad bytes a pixel at 1.4-1.9 times the body on the
// halo).  The design keeps them off the tensor cores' path: a halo tile of
// each operand arrives as one TMA box of the (C, W, H, B) view (64 bf16 or
// 32 f32 channels, no swizzle) into one of two stages, the next item's box
// in flight while the current one is computed; pixels outside the image
// arrive as zeros, which is the stencils' zero padding and the masking of
// gradients at pixels that do not exist (the block's 1x1 convs have no
// bias, so z = 0 gives hid = 0 and dout = 0 gives dgate = dd = 0).  Tiles
// are 8 x 16 pixels, the 1-pixel halo 10 x 18.  One CTA per (tile split,
// image) walks a fixed, strided list of (tile, column box) items; the tap
// gradients are per-CTA partials (a CTA owns its slab and adds into it in
// item order), summed by the wrapper in a fixed order: no atomics, a
// repeated call is bitwise equal.

#include "halo_tiles.cuh"

namespace {

constexpr int kRowThreads = 256;

// ---------------------------------------------------------------------------
// LayerNorm rows
// ---------------------------------------------------------------------------

// 8 bf16 channels, loaded and stored as one 16-byte word
struct alignas(16) Bf16x8 {
  uint32_t w[4];
};

// channel e of a word as f32 (a bf16 value is the upper half of its f32)
__device__ __forceinline__ float word_at(const Bf16x8& q, int e) {
  const uint32_t bits = e & 1 ? q.w[e / 2] & 0xffff0000u : q.w[e / 2] << 16;
  float v;
  memcpy(&v, &bits, 4);
  return v;
}

// y = LN(x) of every pixel (ops/norm.py: var = E[x^2] - E[x]^2 clamped at
// 0; eps 1e-5 for Restormer's LayerNorms, 1e-6 for NAFNet's LayerNorm2d),
// rounded to bf16, with the pixel's mu and 1 / sqrt(var + eps) for the
// backward.  A pixel is a group of G lanes (the power of two at or above
// C / 8, at most 32), each reading 8 channels at a time as one 16-byte
// word, so that a warp takes 32 / G pixels and a row of 48-192 channels
// keeps its lanes busy; the group's sums meet through shuffles.  C % 8 == 0
// and the rows 16-byte aligned.
__global__ void __launch_bounds__(kRowThreads) ln_rows_fwd_kernel(
    const __nv_bfloat16* __restrict__ x, const float* __restrict__ w,
    const float* __restrict__ b, int bias_free, float eps,
    __nv_bfloat16* __restrict__ y, float* __restrict__ mu,
    float* __restrict__ inv, int npix, int C, int G) {
  const int lane = threadIdx.x & 31, gl = lane & (G - 1);
  const int p = (blockIdx.x * (kRowThreads / 32) + (threadIdx.x >> 5)) *
                    (32 / G) + lane / G;
  const bool valid = p < npix;
  const int words = C / 8;
  const Bf16x8* src =
      reinterpret_cast<const Bf16x8*>(x + (size_t)(valid ? p : 0) * C);
  float s = 0.f, s2 = 0.f;
  for (int i = gl; valid && i < words; i += G) {
    const Bf16x8 q = src[i];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float v = word_at(q, e);
      s += v;
      s2 += v * v;
    }
  }
  for (int off = G / 2; off > 0; off >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, off);
    s2 += __shfl_xor_sync(0xffffffffu, s2, off);
  }
  if (!valid) return;
  const float m = s / C;
  const float den = sqrtf(fmaxf(s2 / C - m * m, 0.f) + eps);
  Bf16x8* dst = reinterpret_cast<Bf16x8*>(y + (size_t)p * C);
  for (int i = gl; i < words; i += G) {
    const Bf16x8 q = src[i];
    float o[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int c = 8 * i + e;
      const float v = word_at(q, e);
      o[e] = bias_free ? v / den * w[c] : (v - m) / den * w[c] + b[c];
    }
    Bf16x8 out;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const __nv_bfloat16 lo = from_f<__nv_bfloat16>(o[2 * e]);
      const __nv_bfloat16 hi = from_f<__nv_bfloat16>(o[2 * e + 1]);
      out.w[e] = (uint32_t)*reinterpret_cast<const unsigned short*>(&lo) |
                 ((uint32_t)*reinterpret_cast<const unsigned short*>(&hi)
                  << 16);
    }
    dst[i] = out;
  }
  if (gl == 0) {
    mu[p] = m;
    inv[p] = 1.f / den;
  }
}

// dst = base + LN-backward(dz) of every pixel by one warp each (JAX
// `_ln_bwd_rows`), and this CTA's partial of the LN parameter gradients
// over its pixels [p0, p0 + per_cta): part[cta][0][c] = sum dz zhat,
// part[cta][1][c] = sum dz.  Each warp adds its pixels' terms, in order,
// into its own rows of shared memory (red: [warps][2][C] f32); the warps'
// rows are then added in warp order.
__global__ void __launch_bounds__(kRowThreads) ln_rows_bwd_kernel(
    const __nv_bfloat16* __restrict__ x, const float* __restrict__ dz,
    const float* __restrict__ w, const float* __restrict__ mu,
    const float* __restrict__ inv, int bias_free,
    const __nv_bfloat16* __restrict__ base, __nv_bfloat16* __restrict__ dst,
    float* __restrict__ part, int npix, int C, int per_cta) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kRowWarps = kRowThreads / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int p0 = blockIdx.x * per_cta;
  const int p1 = p0 + per_cta < npix ? p0 + per_cta : npix;
  const bool bf = bias_free != 0;
  float* red = reinterpret_cast<float*>(smem_raw);
  float* rw = red + (size_t)warp * 2 * C;
  for (int c = lane; c < 2 * C; c += 32) rw[c] = 0.f;
  for (int p = p0 + warp; p < p1; p += kRowWarps) {
    const size_t o = (size_t)p * C;
    const float m = mu[p], iv = inv[p];
    // ln_bwd_pixel of tblock_common.cuh, with the parameter terms added
    float m1 = 0.f, m2 = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float xv = to_f(x[o + c]);
      const float zh = bf ? xv * iv : (xv - m) * iv;
      const float dzh = dz[o + c] * w[c];
      m1 += dzh;
      m2 += dzh * zh;
    }
    m1 = warp_sum(m1) / C;
    m2 = warp_sum(m2) / C;
    for (int c = lane; c < C; c += 32) {
      const float xv = to_f(x[o + c]);
      const float zh = bf ? xv * iv : (xv - m) * iv;
      const float d = dz[o + c], dzh = d * w[c];
      const float dx = bf ? (dzh - m2 * (zh - m * iv)) * iv
                          : (dzh - m1 - zh * m2) * iv;
      dst[o + c] = from_f<__nv_bfloat16>(to_f(base[o + c]) + dx);
      rw[c] += d * zh;
      rw[C + c] += d;
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < 2 * C; c += kRowThreads) {
    float sum = 0.f;
    for (int k = 0; k < kRowWarps; ++k) sum += red[(size_t)k * 2 * C + c];
    part[(size_t)blockIdx.x * 2 * C + c] = sum;
  }
}

// ---------------------------------------------------------------------------
// Stencils on halo tiles
// ---------------------------------------------------------------------------

// --- GDFN half: hid and dgate -> gates, dhid, tap partials -----------------

constexpr int kGdfnThreads = 512;

struct GdfnSmem {
  static constexpr int kHid = kP2 * 2 * kHC * 2;       // [kP2][64] bf16
  static constexpr int kStage = kHid + round1k(kP1 * kHC * 4);  // + dgate
  static constexpr int kDd = 2 * kStage;               // [kP1][64] f32
  static constexpr int kRed = kDd + kP1 * 2 * kHC * 4;  // [9][kTH][64] f32
  static constexpr int kBars = kRed + 9 * kTH * 2 * kHC * 4;
  static constexpr int kBytes = kBars + 16 + 1024;
};

// item = (tile, hidden chunk c0 of kHC): the chunk's 64 hid columns (h1
// then h2, w1's interleaved order) on the 2-pixel halo, its kHC dgate
// columns on the 1-pixel halo
__global__ void __launch_bounds__(kGdfnThreads, 1) gdfn_stencil_kernel(
    const __grid_constant__ CUtensorMap thid,
    const __grid_constant__ CUtensorMap tdg, const float* __restrict__ dwg,
    __nv_bfloat16* __restrict__ gates, __nv_bfloat16* __restrict__ dhids,
    float* __restrict__ dtap_part, int H, int W, int hpad) {
  using L = GdfnSmem;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base = align1k(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + L::kBars);
  init_stage_bars(full);
  const int b = blockIdx.y;
  const Items items(H, W, hpad / kHC, blockIdx.x, gridDim.x);
  float* dd = reinterpret_cast<float*>(base + L::kDd);
  float* red = reinterpret_cast<float*>(base + L::kRed);
  // this CTA's slab of the tap partials: rows 0-8 h1's taps, 9-17 h2's
  float* dtap = dtap_part + ((size_t)b * gridDim.x + blockIdx.x) * 18 * hpad;
  for (int i = threadIdx.x; i < 18 * hpad; i += kGdfnThreads) dtap[i] = 0.f;
  auto pix = [&](int gy, int gx) { return ((size_t)b * H + gy) * W + gx; };

  item_loop(
      full, items.n,
      [&](int i, int s) {
        int oy, ox, c0;
        items.at(i, oy, ox, c0);
        unsigned char* st = base + s * L::kStage;
        mbar_arrive_expect_tx(full + s, kP2 * 2 * kHC * 2 + kP1 * kHC * 4);
        tma_load(st, &thid, full + s, 2 * kHC * c0, ox - 2, oy - 2, b);
        tma_load(st + L::kHid, &tdg, full + s, kHC * c0, ox - 1, oy - 1, b);
      },
      [&](int i, int s) {
        int oy, ox, c0;
        items.at(i, oy, ox, c0);
        c0 *= kHC;
        const __nv_bfloat16* hid =
            reinterpret_cast<const __nv_bfloat16*>(base + s * L::kStage);
        const float* dg =
            reinterpret_cast<const float*>(base + s * L::kStage + L::kHid);

        // 1. d1, d2 and dd on the 1-pixel halo; the gate of the body
        //    pixels feeds dW2 = gate^T dout (wgrad.cu).  A task is one
        //    channel j on a third of a halo row, walked left to right with
        //    the 3 x 3 windows of h1 and h2 in registers.
        //    A thread keeps its channel (kGdfnThreads % kHC == 0).
        static_assert(kGdfnThreads % kHC == 0, "one channel per thread");
        {
          const int j = threadIdx.x % kHC;
          float t1[9], t2[9];
          load_taps(t1, dwg, hpad, 0, c0 + j, true);
          load_taps(t2, dwg, hpad, 9, c0 + j, true);
          for (int task = threadIdx.x; task < 3 * kH1 * kHC;
               task += kGdfnThreads) {
            const int qy = (task / kHC) % kH1;
            const int x0 = (task / (kHC * kH1)) * (kW1 / 3);
            float w1[3][3], w2[3][3];
            auto at = [&](int r, int x, int half) {
              return to_f(hid[((qy + r) * kW2 + x) * 64 + half * kHC + j]);
            };
#pragma unroll
            for (int r = 0; r < 3; ++r)
#pragma unroll
              for (int c = 1; c < 3; ++c) {
                w1[r][c] = at(r, x0 + c - 1, 0);
                w2[r][c] = at(r, x0 + c - 1, 1);
              }
            for (int qx = x0; qx < x0 + kW1 / 3; ++qx) {
              float d1 = 0.f, d2 = 0.f;
#pragma unroll
              for (int r = 0; r < 3; ++r) {
                w1[r][0] = w1[r][1], w1[r][1] = w1[r][2];
                w2[r][0] = w2[r][1], w2[r][1] = w2[r][2];
                w1[r][2] = at(r, qx + 2, 0);
                w2[r][2] = at(r, qx + 2, 1);
#pragma unroll
                for (int c = 0; c < 3; ++c) {
                  d1 += w1[r][c] * t1[r * 3 + c];
                  d2 += w2[r][c] * t2[r * 3 + c];
                }
              }
              // gelu_erf and gelu_erf_grad of tblock_common.cuh, one erf
              const int q = qy * kW1 + qx;
              const float e = erff(d1 * 0.70710678118654752f);
              const float g = dg[q * kHC + j], ga = d1 * 0.5f * (1.0f + e);
              dd[q * 64 + j] =
                  g * d2 *
                  (0.5f * (1.0f + e) +
                   d1 * 0.3989422804014327f * expf(-0.5f * d1 * d1));
              dd[q * 64 + kHC + j] = g * ga;
              const int gy = oy - 1 + qy, gx = ox - 1 + qx;
              if (qy >= 1 && qy <= kTH && qx >= 1 && qx <= kTW && gy < H &&
                  gx < W)
                gates[pix(gy, gx) * hpad + c0 + j] =
                    from_f<__nv_bfloat16>(ga * d2);
            }
          }
        }
        __syncthreads();

        // 2. per column n of the chunk (h1, then h2) and body row py: the
        //    row's share of the tap gradients, and dhid = the flipped
        //    stencil of dd rounded to bf16, walked left to right with the
        //    3 x 3 windows of hid (2-pixel halo rows py + 1 ..) and of
        //    rounded dd (1-pixel halo rows py ..) in registers
        {
          const int n = threadIdx.x & 63, py = threadIdx.x >> 6;
          float tp[9], sum[9], hw[3][3], dw[3][3];
          load_taps(tp, dwg, hpad, (n / kHC) * 9, c0 + n % kHC, true);
          auto hid_at = [&](int r, int x) {
            return to_f(hid[((py + 1 + r) * kW2 + x) * 64 + n]);
          };
          auto dd_at = [&](int r, int x) {
            return dd[((py + r) * kW1 + x) * 64 + n];
          };
#pragma unroll
          for (int t = 0; t < 9; ++t) sum[t] = 0.f;
#pragma unroll
          for (int r = 0; r < 3; ++r)
#pragma unroll
            for (int c = 1; c < 3; ++c) {
              hw[r][c] = hid_at(r, c);
              dw[r][c] = rnd<__nv_bfloat16>(dd_at(r, c - 1));
            }
          const int gy = oy + py;
          for (int px = 0; px < kTW; ++px) {
            const float xv = dd_at(1, px + 1);
            float a = 0.f;
#pragma unroll
            for (int r = 0; r < 3; ++r) {
              hw[r][0] = hw[r][1], hw[r][1] = hw[r][2];
              dw[r][0] = dw[r][1], dw[r][1] = dw[r][2];
              hw[r][2] = hid_at(r, px + 3);
              dw[r][2] = rnd<__nv_bfloat16>(dd_at(r, px + 2));
            }
#pragma unroll
            for (int dy = 0; dy < 3; ++dy)
#pragma unroll
              for (int dx = 0; dx < 3; ++dx) {
                sum[dy * 3 + dx] += hw[dy][dx] * xv;
                a += dw[2 - dy][2 - dx] * tp[dy * 3 + dx];
              }
            if (gy < H && ox + px < W)
              dhids[pix(gy, ox + px) * 2 * hpad + 2 * c0 + n] =
                  from_f<__nv_bfloat16>(a);
          }
#pragma unroll
          for (int t = 0; t < 9; ++t) red[(t * kTH + py) * 64 + n] = sum[t];
        }
        __syncthreads();

        // 3. the chunk's tap partials, the body rows added in order
        for (int idx = threadIdx.x; idx < 18 * kHC; idx += kGdfnThreads) {
          const int row = idx / kHC, j = idx % kHC;
          const int n = (row / 9) * kHC + j, t = row % 9;
          float sum = 0.f;
          for (int py = 0; py < kTH; ++py) sum += red[(t * kTH + py) * 64 + n];
          dtap[(size_t)row * hpad + c0 + j] += sum;
        }
      });
}

// --- attention half: dth, lin -> dlin, tap partials ------------------------

constexpr int kDlinThreads = 256;

struct DlinSmem {
  static constexpr int kDth = round1k(kP1 * 32 * 4);    // [kP1][32] f32
  static constexpr int kStage = kDth + round1k(kP1 * 32 * 2);  // + lin bf16
  static constexpr int kRed = 2 * kStage;               // [9][kTH][32] f32
  static constexpr int kBars = kRed + 9 * kTH * 32 * 4;
  static constexpr int kBytes = kBars + 16 + 1024;
};

// item = (tile, 32 of the 3 C columns): dth and lin on the 1-pixel halo
__global__ void __launch_bounds__(kDlinThreads) dlin_stencil_kernel(
    const __grid_constant__ CUtensorMap tdth,
    const __grid_constant__ CUtensorMap tlin, const float* __restrict__ dwall,
    __nv_bfloat16* __restrict__ dlins, float* __restrict__ dtap_part, int H,
    int W, int C) {
  using L = DlinSmem;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base = align1k(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + L::kBars);
  init_stage_bars(full);
  const int b = blockIdx.y;
  const Items items(H, W, (3 * C + 31) / 32, blockIdx.x, gridDim.x);
  float* red = reinterpret_cast<float*>(base + L::kRed);
  // this CTA's slab of the tap partials: rows 0-8 q, 9-17 k, 18-26 v
  float* dtap = dtap_part + ((size_t)b * gridDim.x + blockIdx.x) * 27 * C;
  for (int i = threadIdx.x; i < 27 * C; i += kDlinThreads) dtap[i] = 0.f;

  item_loop(
      full, items.n,
      [&](int i, int s) {
        int oy, ox, box;
        items.at(i, oy, ox, box);
        unsigned char* st = base + s * L::kStage;
        mbar_arrive_expect_tx(full + s, kP1 * 32 * 4 + kP1 * 32 * 2);
        tma_load(st, &tdth, full + s, 32 * box, ox - 1, oy - 1, b);
        tma_load(st + L::kDth, &tlin, full + s, 32 * box, ox - 1, oy - 1, b);
      },
      [&](int i, int s) {
        int oy, ox, box;
        items.at(i, oy, ox, box);
        const float* dth = reinterpret_cast<const float*>(base + s * L::kStage);
        const __nv_bfloat16* lin = reinterpret_cast<const __nv_bfloat16*>(
            base + s * L::kStage + L::kDth);
        // per column j of the box and body row py, left to right with the
        // 3 x 3 windows of lin and of rounded dth (1-pixel halo rows py ..)
        // in registers: the row's share of the tap gradients, and dlin
        {
          const int j = threadIdx.x & 31, py = threadIdx.x >> 5;
          const int col = 32 * box + j;
          const bool valid = col < 3 * C;
          float tp[9], sum[9], lw[3][3], dw[3][3];
          load_taps(tp, dwall, C, (col / C) * 9, col % C, valid);
          auto lin_at = [&](int r, int x) {
            return to_f(lin[((py + r) * kW1 + x) * 32 + j]);
          };
          auto dth_at = [&](int r, int x) {
            return dth[((py + r) * kW1 + x) * 32 + j];
          };
#pragma unroll
          for (int t = 0; t < 9; ++t) sum[t] = 0.f;
#pragma unroll
          for (int r = 0; r < 3; ++r)
#pragma unroll
            for (int c = 1; c < 3; ++c) {
              lw[r][c] = lin_at(r, c - 1);
              dw[r][c] = rnd<__nv_bfloat16>(dth_at(r, c - 1));
            }
          const int gy = oy + py;
          for (int px = 0; px < kTW; ++px) {
            const float xv = dth_at(1, px + 1);
            float a = 0.f;
#pragma unroll
            for (int r = 0; r < 3; ++r) {
              lw[r][0] = lw[r][1], lw[r][1] = lw[r][2];
              dw[r][0] = dw[r][1], dw[r][1] = dw[r][2];
              lw[r][2] = lin_at(r, px + 2);
              dw[r][2] = rnd<__nv_bfloat16>(dth_at(r, px + 2));
            }
#pragma unroll
            for (int dy = 0; dy < 3; ++dy)
#pragma unroll
              for (int dx = 0; dx < 3; ++dx) {
                sum[dy * 3 + dx] += lw[dy][dx] * xv;
                a += dw[2 - dy][2 - dx] * tp[dy * 3 + dx];
              }
            if (valid && gy < H && ox + px < W)
              dlins[(((size_t)b * H + gy) * W + ox + px) * 3 * C + col] =
                  from_f<__nv_bfloat16>(a);
          }
#pragma unroll
          for (int t = 0; t < 9; ++t) red[(t * kTH + py) * 32 + j] = sum[t];
        }
        __syncthreads();
        // the box's tap partials, the body rows added in order
        for (int idx = threadIdx.x; idx < 9 * 32; idx += kDlinThreads) {
          const int t = idx / 32, j = idx % 32, col = 32 * box + j;
          if (col >= 3 * C) continue;
          float sum = 0.f;
          for (int py = 0; py < kTH; ++py) sum += red[(t * kTH + py) * 32 + j];
          dtap[(size_t)((col / C) * 9 + t) * C + col % C] += sum;
        }
      });
}

}  // namespace

extern "C" {

// The stencil kernels' tile: rows (dim 0) or columns (dim 1).
int bwd_stencil_tile(int dim) { return dim == 0 ? kTH : kTW; }

// y (npix, C) bf16 = LN(x) with epsilon eps, mu and inv (npix) f32;
// C % 8 == 0, x and y 16-byte aligned.  Returns a cudaError_t.
int bwd_ln_rows(const void* x, const float* w, const float* b, int bias_free,
                float eps, void* y, float* mu, float* inv, int npix, int C,
                void* stream) {
  if (npix <= 0 || C <= 0 || C % 8 || (uintptr_t)x % 16 || (uintptr_t)y % 16)
    return (int)cudaErrorInvalidValue;
  int G = 1;
  while (G < 32 && G < C / 8) G *= 2;
  const int per = kRowThreads / 32 * (32 / G);  // pixels a CTA
  ln_rows_fwd_kernel<<<(npix + per - 1) / per, kRowThreads, 0,
                       (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, w, b, bias_free, eps, (__nv_bfloat16*)y, mu,
      inv, npix, C, G);
  return (int)cudaGetLastError();
}

// dst = base + LN-backward(dz) (npix, C) bf16, and part (nct, 2, C) f32:
// the LN parameter partials of nct CTAs over consecutive pixel ranges.
// Returns a cudaError_t.
int bwd_ln_rows_bwd(const void* x, const float* dz, const float* w,
                    const float* mu, const float* inv, int bias_free,
                    const void* base, void* dst, float* part, int npix, int C,
                    int nct, void* stream) {
  if (npix <= 0 || C <= 0 || nct <= 0) return (int)cudaErrorInvalidValue;
  const int smem = kRowThreads / 32 * 2 * C * 4;
  int err;
  if (smem > 48 * 1024 && (err = prepare(ln_rows_bwd_kernel, smem)))
    return err;
  ln_rows_bwd_kernel<<<nct, kRowThreads, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, dz, w, mu, inv, bias_free,
      (const __nv_bfloat16*)base, (__nv_bfloat16*)dst, part, npix, C,
      (npix + nct - 1) / nct);
  return (int)cudaGetLastError();
}

// hids (B H W, 2 hpad) bf16, w1's interleaved chunk order; dgates (B H W,
// hpad) f32; dwg (18, hpad) f32 taps.  Outputs: gates (B H W, hpad), dhids
// (B H W, 2 hpad, interleaved as hids) bf16; dtap_part (B nsplit, 18, hpad)
// f32.  Returns a cudaError_t.
int bwd_gdfn_stencil(const void* hids, const float* dgates, const float* dwg,
                     void* gates, void* dhids, float* dtap_part, int B, int H,
                     int W, int hpad, int nsplit, void* stream) {
  if (bad_grid(B, H, W, nsplit) || hpad <= 0 || hpad % kHC)
    return (int)cudaErrorInvalidValue;
  CUtensorMap th, tg;
  int err;
  if ((err = view_map(&th, nhwc_view(hids, B, H, W, 2 * hpad, 2 * kHC, kW2,
                                     kH2), false, false)) ||
      (err = view_map(&tg, nhwc_view(dgates, B, H, W, hpad, kHC, kW1, kH1),
                      true, false)))
    return err;
  static const int attr = prepare(gdfn_stencil_kernel, GdfnSmem::kBytes);
  if (attr != 0) return attr;
  gdfn_stencil_kernel<<<dim3(nsplit, B), kGdfnThreads, GdfnSmem::kBytes,
                        (cudaStream_t)stream>>>(
      th, tg, dwg, (__nv_bfloat16*)gates, (__nv_bfloat16*)dhids, dtap_part, H,
      W, hpad);
  return (int)cudaGetLastError();
}

// dth (B H W, 3 C) f32, the thirds' gradients; lins (B H W, 3 C) bf16, the
// q | k | v 1x1 outputs; dwall (27, C) f32.
// Outputs: dlins (B H W, 3 C) bf16; dtap_part (B nsplit, 27, C) f32.
// Returns a cudaError_t.
int bwd_dlin_stencil(const float* dth, const void* lins, const float* dwall,
                     void* dlins, float* dtap_part, int B, int H, int W,
                     int C, int nsplit, void* stream) {
  if (bad_grid(B, H, W, nsplit) || C <= 0) return (int)cudaErrorInvalidValue;
  CUtensorMap td, tl;
  int err;
  if ((err = view_map(&td, nhwc_view(dth, B, H, W, 3 * C, 32, kW1, kH1),
                      true, false)) ||
      (err = view_map(&tl, nhwc_view(lins, B, H, W, 3 * C, 32, kW1, kH1),
                      false, false)))
    return err;
  static const int attr = prepare(dlin_stencil_kernel, DlinSmem::kBytes);
  if (attr != 0) return attr;
  dlin_stencil_kernel<<<dim3(nsplit, B), kDlinThreads, DlinSmem::kBytes,
                        (cudaStream_t)stream>>>(
      td, tl, dwall, (__nv_bfloat16*)dlins, dtap_part, H, W, C);
  return (int)cudaGetLastError();
}

}  // extern "C"
