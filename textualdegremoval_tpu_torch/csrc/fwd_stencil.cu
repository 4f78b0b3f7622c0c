// The depthwise passes of the Restormer TransformerBlock forward in bf16
// for Hopper (sm_90a): the q | k | v stencil with the square sums of q and
// k, and the GDFN gate stencil, both on halo tiles that TMA loads; and the
// glue between the statistics and the attention.
//
// With the products of bwd_gemm.cu, the LayerNorm rows of bwd_stencil.cu
// and the gram of wgrad.cu they replace the bf16 path of the TPU kernels
// `_make_stats_kernel` (textualdegremoval_tpu/ops/pallas/tblock.py:170,
// called at :627) and `_make_apply_kernel` (:220, called at :652), both
// run by `_tblock_impl` (:557) with the glue `_attn_matrix` (:538)
// between them.  The block, x -> out (ops/pallas/tblock.py
// `tblock_pipeline`):
//
//   [bwd_ln_rows]        y = LN1(x) (bf16)
//   [bwd_gemm]           lin = y . Wqkv (bf16), 3 C wide
//   fwd_qkv_stencil      q | k | v = dw3x3(lin) (bf16), and per CTA the
//                        square sums of the rounded q and k (f32), over a
//                        window of rows where a row-sharded slab asks
//                        (`fwd_qkv_stencil_rows`: its own rows, not its
//                        halo; the gram then reads the view of those rows)
//   [tblock_wgrad]       gram = q_h^T k_h per (image, head), partials (f32)
//   (torch)              the partials of the gram and the square sums
//                        summed in a fixed order
//   fwd_attn_glue        A = softmax(temperature q.k / |q| |k|) per head
//                        (bf16), `_attn_matrix`
//   [fwd_attn_out]       o = v . A_h^T per (image, head) (bf16), then
//                        x1 = x + rnd(o . Wproj) (bf16)
//   [bwd_ln_rows]        z = LN2(x1) (bf16)
//   [bwd_gemm]           hid = z . W1 (bf16), W1's interleaved chunk order
//   fwd_gate_stencil     gate = gelu(dw3x3(h1)) dw3x3(h2) (bf16)
//   [fwd_gemm_residual]  out = x1 + rnd(gate . W2) (bf16)
//
// The cross-block chain (`chain_pipeline`, the TPU kernel
// `_make_apply_stats_kernel`, tblock.py:314) runs this sequence block after
// block, and at each boundary but the last [fwd_gemm_residual_ln]: out as
// above and the next block's y = LN1(out) from the same registers, in
// place of that block's [bwd_ln_rows].  The standalone GDFN (ops/pallas/
// gdfn.py `gdfn_pipeline`, the TPU kernel of ops/pallas/gdfn.py) is
// [bwd_gemm] hid = x . W1, fwd_gate_stencil and [bwd_gemm] out = gate . W2.
//
// The rounding points are the TPU kernel's (tblock.py:185-205, :242-307):
// the 1x1 outputs lin and hid before their stencils, q, k and v after the
// f32 stencil, o, proj before the residual, the gate after its f32
// product, the GDFN output before the residual; the square sums and the
// gram take the rounded q and k; every sum is in f32.
//
// What bounds them on the card: the bytes of the operands they stream
// (lin: 6 C bytes a pixel read and 6 C written; hid: 4 hpad read, 2 hpad
// written), read from device memory once and from L2 again on the halo
// (1.41 times the body at a 1-pixel halo of an 8 x 16 tile), and the
// CUDA-core instructions of the stencils (9 taps a value; the gate's erf).
// The design: a tile's halo arrives as one TMA box of the (C, W, H, B)
// view (64 bf16 channels, no swizzle; tma_maps.cuh, halo_tiles.cuh) into
// one of two stages, the next item's box in flight; pixels outside the
// image arrive as zeros, which is the TPU kernel's zero padding of the 1x1
// outputs (the block's 1x1 convs have no bias).  Each thread walks one
// body row of one channel left to right with the 3 x 3 window in
// registers.  The square sums are per-CTA partials (a CTA owns its slab
// and adds into it in item order), summed by the wrapper in a fixed order:
// no atomics, a repeated call is bitwise equal.  The glue is one small
// kernel where torch took ten launches a block: on the 512 px forward the
// host's launches, not the card, set the pace on a busy host.

#include "halo_tiles.cuh"

namespace {

// --- lin -> q | k | v, square sums of q and k -----------------------------

constexpr int kQkvThreads = 256;

struct QkvSmem {
  static constexpr int kStage = round1k(kP1 * 64 * 2);  // [kP1][64] bf16
  static constexpr int kRed = 2 * kStage;               // [4][64] f32
  static constexpr int kBars = kRed + kQkvThreads * 4;
  static constexpr int kBytes = kBars + 16 + 1024;
};

// item = (tile, 64 of the 3 C columns of lin) on the 1-pixel halo
__global__ void __launch_bounds__(kQkvThreads) qkv_stencil_kernel(
    const __grid_constant__ CUtensorMap tlin, const float* __restrict__ dwall,
    __nv_bfloat16* __restrict__ qkv, float* __restrict__ ssq_part, int H,
    int W, int C, int row_lo, int row_hi) {
  using L = QkvSmem;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base = align1k(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + L::kBars);
  init_stage_bars(full);
  const int b = blockIdx.y;
  const Items items(H, W, (3 * C + 63) / 64, blockIdx.x, gridDim.x);
  float* red = reinterpret_cast<float*>(base + L::kRed);
  // this CTA's slab of the square-sum partials: q's C channels, then k's
  // (none where ssq_part is null: the backward's pass 1)
  float* ssq = ssq_part == nullptr
                   ? nullptr
                   : ssq_part + ((size_t)b * gridDim.x + blockIdx.x) * 2 * C;
  for (int i = threadIdx.x; ssq != nullptr && i < 2 * C; i += kQkvThreads)
    ssq[i] = 0.f;

  item_loop(
      full, items.n,
      [&](int i, int s) {
        int oy, ox, box;
        items.at(i, oy, ox, box);
        mbar_arrive_expect_tx(full + s, kP1 * 64 * 2);
        tma_load(base + s * L::kStage, &tlin, full + s, 64 * box, ox - 1,
                 oy - 1, b);
      },
      [&](int i, int s) {
        int oy, ox, box;
        items.at(i, oy, ox, box);
        const __nv_bfloat16* lin =
            reinterpret_cast<const __nv_bfloat16*>(base + s * L::kStage);
        const int n = threadIdx.x & 63, col = 64 * box + n;
        const bool valid = col < 3 * C;
        float tp[9], w[3][3], sq = 0.f;
        load_taps(tp, dwall, C, (col / C) * 9, col % C, valid);
        // body rows of column n left to right, the 3 x 3 window in
        // registers; the rounded values' squares summed in row order
        for (int py = threadIdx.x >> 6; py < kTH; py += kQkvThreads / 64) {
          auto at = [&](int r, int x) {
            return to_f(lin[((py + r) * kW1 + x) * 64 + n]);
          };
#pragma unroll
          for (int r = 0; r < 3; ++r)
#pragma unroll
            for (int c = 1; c < 3; ++c) w[r][c] = at(r, c - 1);
          const int gy = oy + py;
          for (int px = 0; px < kTW; ++px) {
            float a = 0.f;
#pragma unroll
            for (int r = 0; r < 3; ++r) {
              w[r][0] = w[r][1], w[r][1] = w[r][2];
              w[r][2] = at(r, px + 2);
#pragma unroll
              for (int c = 0; c < 3; ++c) a += w[r][c] * tp[r * 3 + c];
            }
            if (valid && gy < H && ox + px < W) {
              const float v = rnd<__nv_bfloat16>(a);
              qkv[(((size_t)b * H + gy) * W + ox + px) * 3 * C + col] =
                  from_f<__nv_bfloat16>(v);
              // only the window's rows count toward the square sums
              if (gy >= row_lo && gy < row_hi) sq += v * v;
            }
          }
        }
        // the item's square sums of the q and k columns, the four row
        // groups added in order
        if (ssq == nullptr) return;
        red[threadIdx.x] = sq;
        __syncthreads();
        if (threadIdx.x < 64 && col < 2 * C)
          ssq[col] += ((red[n] + red[64 + n]) + red[128 + n]) + red[192 + n];
      });
}

// --- hid -> gate ------------------------------------------------------------

constexpr int kGateThreads = kHC * kTH;  // a thread per channel and body row

struct GateSmem {
  static constexpr int kStage = round1k(kP1 * 2 * kHC * 2);  // [kP1][64] bf16
  static constexpr int kBars = 2 * kStage;
  static constexpr int kBytes = kBars + 16 + 1024;
};

// item = (tile, hidden chunk c0 of kHC): the chunk's 64 hid columns (h1
// then h2, W1's interleaved order) on the 1-pixel halo
__global__ void __launch_bounds__(kGateThreads) gate_stencil_kernel(
    const __grid_constant__ CUtensorMap thid, const float* __restrict__ dwg,
    __nv_bfloat16* __restrict__ gates, int H, int W, int hpad) {
  using L = GateSmem;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base = align1k(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + L::kBars);
  init_stage_bars(full);
  const int b = blockIdx.y;
  const Items items(H, W, hpad / kHC, blockIdx.x, gridDim.x);

  item_loop(
      full, items.n,
      [&](int i, int s) {
        int oy, ox, c0;
        items.at(i, oy, ox, c0);
        mbar_arrive_expect_tx(full + s, kP1 * 2 * kHC * 2);
        tma_load(base + s * L::kStage, &thid, full + s, 2 * kHC * c0, ox - 1,
                 oy - 1, b);
      },
      [&](int i, int s) {
        int oy, ox, c0;
        items.at(i, oy, ox, c0);
        c0 *= kHC;
        const __nv_bfloat16* hid =
            reinterpret_cast<const __nv_bfloat16*>(base + s * L::kStage);
        // channel j of the chunk on body row py, left to right with the
        // 3 x 3 windows of h1 and h2 in registers
        const int j = threadIdx.x % kHC, py = threadIdx.x / kHC;
        float t1[9], t2[9], w1[3][3], w2[3][3];
        load_taps(t1, dwg, hpad, 0, c0 + j, true);
        load_taps(t2, dwg, hpad, 9, c0 + j, true);
        auto at = [&](int r, int x, int half) {
          return to_f(hid[((py + r) * kW1 + x) * 2 * kHC + half * kHC + j]);
        };
#pragma unroll
        for (int r = 0; r < 3; ++r)
#pragma unroll
          for (int c = 1; c < 3; ++c) {
            w1[r][c] = at(r, c - 1, 0);
            w2[r][c] = at(r, c - 1, 1);
          }
        const int gy = oy + py;
        __nv_bfloat16* row =
            gates + (((size_t)b * H + gy) * W + ox) * hpad + c0 + j;
        for (int px = 0; px < kTW; ++px) {
          float d1 = 0.f, d2 = 0.f;
#pragma unroll
          for (int r = 0; r < 3; ++r) {
            w1[r][0] = w1[r][1], w1[r][1] = w1[r][2];
            w2[r][0] = w2[r][1], w2[r][1] = w2[r][2];
            w1[r][2] = at(r, px + 2, 0);
            w2[r][2] = at(r, px + 2, 1);
#pragma unroll
            for (int c = 0; c < 3; ++c) {
              d1 += w1[r][c] * t1[r * 3 + c];
              d2 += w2[r][c] * t2[r * 3 + c];
            }
          }
          if (gy < H && ox + px < W)
            row[(size_t)px * hpad] = from_f<__nv_bfloat16>(gelu_erf(d1) * d2);
        }
      });
}

// --- the glue: statistics -> attention -------------------------------------

constexpr int kGlueThreads = 256;

// per (head, image): A = softmax over rows of temperature * gram *
// qn kn^T with qn = 1 / sqrt(max(qssq, 1e-24)) (`_attn_matrix` of
// ops/pallas/tblock.py) in f32, a warp per row, rounded to bf16; and the
// square sums split into q's and k's for the backward
__global__ void __launch_bounds__(kGlueThreads) attn_glue_kernel(
    const float* __restrict__ gram, const float* __restrict__ ssq,
    const float* __restrict__ temperature, float* __restrict__ qssq,
    float* __restrict__ kssq, __nv_bfloat16* __restrict__ attn, int C,
    int heads) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* norms = reinterpret_cast<float*>(smem_raw);  // [2 cph]: qn, kn
  const int h = blockIdx.x, b = blockIdx.y, cph = C / heads;
  for (int i = threadIdx.x; i < 2 * cph; i += kGlueThreads) {
    const int k = i >= cph, ch = h * cph + i - k * cph;
    const float s = ssq[(size_t)b * 2 * C + k * C + ch];
    (k ? kssq : qssq)[(size_t)b * C + ch] = s;
    norms[i] = 1.f / sqrtf(fmaxf(s, 1e-24f));
  }
  __syncthreads();
  const float t = temperature[h];
  const size_t hb = (size_t)b * heads + h, sq = (size_t)cph * cph;
  const int lane = threadIdx.x & 31;
  for (int i = threadIdx.x >> 5; i < cph; i += kGlueThreads / 32) {
    float z[kMaxCph / 32], mx = -INFINITY;
#pragma unroll
    for (int e = 0; e < kMaxCph / 32; ++e) {
      const int j = lane + 32 * e;
      z[e] = 0.f;
      if (j >= cph) continue;
      z[e] = gram[hb * sq + (size_t)i * cph + j] * (norms[i] * norms[cph + j]) *
             t;
      mx = fmaxf(mx, z[e]);
    }
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float sum = 0.f;
#pragma unroll
    for (int e = 0; e < kMaxCph / 32; ++e) {
      if (lane + 32 * e >= cph) continue;
      z[e] = expf(z[e] - mx);
      sum += z[e];
    }
    sum = warp_sum(sum);
#pragma unroll
    for (int e = 0; e < kMaxCph / 32; ++e) {
      const int j = lane + 32 * e;
      if (j < cph)
        attn[(hb * cph + i) * cph + j] = from_f<__nv_bfloat16>(z[e] / sum);
    }
  }
}

}  // namespace

extern "C" {

// lins (B H W, 3 C) bf16, the q | k | v 1x1 outputs; dwall (27, C) f32
// taps.  Outputs: qkv (B H W, 3 C) bf16 after the stencils; ssq_part
// (B nsplit, 2 C) f32, each CTA's square sums of q's and k's rounded
// values over its pixels of image rows [row_lo, row_hi) (0 <= row_lo <=
// row_hi <= H; a row-sharded slab's own rows, without its halo), or null
// for none (the backward's pass 1).  Returns a cudaError_t.
int fwd_qkv_stencil_rows(const void* lins, const float* dwall, void* qkv,
                         float* ssq_part, int B, int H, int W, int C,
                         int nsplit, int row_lo, int row_hi, void* stream) {
  if (bad_grid(B, H, W, nsplit) || C <= 0 || row_lo < 0 ||
      row_hi < row_lo || row_hi > H)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tl;
  int err;
  if ((err = view_map(&tl, nhwc_view(lins, B, H, W, 3 * C, 64, kW1, kH1),
                      false, false)))
    return err;
  static const int attr = prepare(qkv_stencil_kernel, QkvSmem::kBytes);
  if (attr != 0) return attr;
  qkv_stencil_kernel<<<dim3(nsplit, B), kQkvThreads, QkvSmem::kBytes,
                       (cudaStream_t)stream>>>(tl, dwall, (__nv_bfloat16*)qkv,
                                               ssq_part, H, W, C, row_lo,
                                               row_hi);
  return (int)cudaGetLastError();
}

// fwd_qkv_stencil_rows with the square sums over every row.
int fwd_qkv_stencil(const void* lins, const float* dwall, void* qkv,
                    float* ssq_part, int B, int H, int W, int C, int nsplit,
                    void* stream) {
  return fwd_qkv_stencil_rows(lins, dwall, qkv, ssq_part, B, H, W, C, nsplit,
                              0, H, stream);
}

// hids (B H W, 2 hpad) bf16 in W1's interleaved chunk order; dwg (18,
// hpad) f32 taps, h1's in rows 0-8.  Output gates (B H W, hpad) bf16.
// Returns a cudaError_t.
int fwd_gate_stencil(const void* hids, const float* dwg, void* gates, int B,
                     int H, int W, int hpad, int nsplit, void* stream) {
  if (bad_grid(B, H, W, nsplit) || hpad <= 0 || hpad % kHC)
    return (int)cudaErrorInvalidValue;
  CUtensorMap th;
  int err;
  if ((err = view_map(&th, nhwc_view(hids, B, H, W, 2 * hpad, 2 * kHC, kW1,
                                     kH1), false, false)))
    return err;
  static const int attr = prepare(gate_stencil_kernel, GateSmem::kBytes);
  if (attr != 0) return attr;
  gate_stencil_kernel<<<dim3(nsplit, B), kGateThreads, GateSmem::kBytes,
                        (cudaStream_t)stream>>>(th, dwg, (__nv_bfloat16*)gates,
                                                H, W, hpad);
  return (int)cudaGetLastError();
}

// gram (B, heads, cph, cph) f32; ssq (B, 2 C) f32, q's square sums then
// k's; temperature (heads) f32.  Outputs: qssq and kssq (B, C) f32; attn
// (B, heads, cph, cph) bf16.  cph <= kMaxCph.  Returns a cudaError_t.
int fwd_attn_glue(const float* gram, const float* ssq,
                  const float* temperature, float* qssq, float* kssq,
                  void* attn, int B, int C, int heads, void* stream) {
  if (B <= 0 || B > 65535 || heads <= 0 || C % heads || C / heads > kMaxCph)
    return (int)cudaErrorInvalidValue;
  attn_glue_kernel<<<dim3(heads, B), kGlueThreads, 2 * C / heads * 4,
                     (cudaStream_t)stream>>>(gram, ssq, temperature, qssq,
                                             kssq, (__nv_bfloat16*)attn, C,
                                             heads);
  return (int)cudaGetLastError();
}

}  // extern "C"
