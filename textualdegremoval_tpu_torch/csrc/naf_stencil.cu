// The depthwise passes and the SCA glue of the NAFBlock forward in bf16 for
// Hopper (sm_90a): the gate stencil on halo tiles that TMA loads, in two
// modes (the per-CTA sums of the gate over the image, then the gate scaled
// by the SCA), and the glue between them.
//
// With the products of bwd_gemm.cu (its NAFBlock epilogues) and the
// LayerNorm rows of bwd_stencil.cu they replace the bf16 path of the TPU
// kernels `_make_sum_kernel` (textualdegremoval_tpu/ops/pallas/nafblock.py
// :156, called at :303) and `_make_apply_kernel` (:180, called at :321),
// both run by `_nafblock_impl` (:246) with the SCA glue (:315-319) between
// them.  The block, x -> out (ops/pallas/nafblock.py `naf_pipeline`):
//
//   [bwd_ln_rows, eps 1e-6]  y = LN1(x) (bf16)
//   [naf_gemm_bias]          h = rnd(rnd(y . W1) + b1) (bf16), 2 cpad wide
//                            in W1's 32-channel chunks (a chunk's first
//                            half, then its second)
//   naf_gate_stencil, SUM    per CTA the sums of the gate g over its image
//                            pixels (f32), over a window of rows where a
//                            row-sharded slab asks (`naf_gate_stencil_rows`:
//                            its own rows, not its 1-row halo); g is not
//                            written
//   (torch, sharded only)    the partials summed, then summed over the
//                            ranks; the glue takes them as one partial
//   naf_sca_glue             s = rnd(rnd(rnd(sum / HW) . Wsca) + bsca) per
//                            (image, channel), the partials summed in a
//                            fixed order; HW the whole image's pixels
//   naf_gate_stencil, APPLY  gs = rnd(g s[image]) (bf16), cpad wide
//   [naf_gemm_bias]          y1 = rnd(x + rnd(rnd(rnd(gs . W3) + b3) beta))
//   [bwd_ln_rows, eps 1e-6]  z = LN2(y1) (bf16)
//   [naf_gemm_gate]          g2 = rnd(h_a h_b), h_* = rnd(rnd(z . W4_*) +
//                            b4_*) (bf16), cpad wide
//   [naf_gemm_bias]          out = rnd(y1 + rnd(rnd(rnd(g2 . W5) + b5)
//                            gamma))
//
// with g = rnd(d_a d_b), d_* = rnd(dw3x3_f32(h_*) + dwb_*).  The rounding
// points are the TPU kernel's (nafblock.py:114-218): every product sums in
// f32 and is rounded before its bias is added in bf16; the depthwise conv
// sums in f32 with f32 taps and adds its bias before one rounding; the
// gate, the SCA product and the residuals are bf16; the LayerNorms f32
// with eps 1e-6; the SCA sums take the rounded gate of image pixels only.
//
// What bounds them on the card: the bytes of h that the two stencil
// passes stream (4 cpad bytes a pixel each, and the halo again from L2:
// 1.41 times the body at a 1-pixel halo of an 8 x 16 tile), gs written
// once, and the stencil's CUDA-core instructions (18 taps a gate value).
// The gate is recomputed by APPLY instead of being written by SUM and
// read back: either way h is read twice and gs written once.  The design:
// a tile's halo arrives as one TMA box of the (C, W, H, B) view of h (64
// channels: 32 of each half, thanks to W1's chunks; tma_maps.cuh,
// halo_tiles.cuh) into one of two stages, the next tile's box in flight;
// pixels outside the image arrive as zeros, which is the reference's zero
// padding of conv1's output, bias included (h is stored with its bias).
// A CTA keeps one 32-channel chunk and walks a strided list of tiles; each
// thread walks one body row of one channel left to right with both 3 x 3
// windows in registers.  SUM: each thread adds its rounded gate values of
// image pixels in order; at the end the CTA adds its eight row groups in
// order and writes its chunk of the partials.  The glue sums the partials
// in a fixed order: no atomics, a repeated call is bitwise equal.

#include "halo_tiles.cuh"

namespace {

// --- h -> the gate's sums (SUM) or the scaled gate (APPLY) ----------------

constexpr int kNafThreads = kHC * kTH;  // a thread per channel and body row

struct NafSmem {
  static constexpr int kStage = round1k(kP1 * 2 * kHC * 2);  // [kP1][64] bf16
  static constexpr int kRed = 2 * kStage;                     // [kTH][kHC] f32
  static constexpr int kBars = kRed + kNafThreads * 4;
  static constexpr int kBytes = kBars + 16 + 1024;
};

// CTA (split, chunk) of image blockIdx.y, blockIdx.x = chunk nsplit +
// split: gate channels [32 chunk, 32 chunk + 32), the tiles split, split +
// nsplit, ...  SUM (kApply 0) writes sum_part[image][split][channel], the
// sums over image rows [row_lo, row_hi); APPLY writes gs = rnd(g
// s[image][channel]) on every row.
template <int kApply>
__global__ void __launch_bounds__(kNafThreads) naf_gate_kernel(
    const __grid_constant__ CUtensorMap th, const float* __restrict__ taps,
    const float* __restrict__ dwb, const float* __restrict__ s,
    __nv_bfloat16* __restrict__ gs, float* __restrict__ sum_part, int H,
    int W, int cpad, int nsplit, int row_lo, int row_hi) {
  using L = NafSmem;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base = align1k(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + L::kBars);
  init_stage_bars(full);
  const int b = blockIdx.y, split = blockIdx.x % nsplit;
  const int c0 = blockIdx.x / nsplit * kHC;
  const Items items(H, W, 1, split, nsplit);
  // channel j of the chunk on body row py
  const int j = threadIdx.x % kHC, py = threadIdx.x / kHC, ch = c0 + j;
  float ta[9], tb[9];
  load_taps(ta, taps, cpad, 0, ch, true);
  load_taps(tb, taps, cpad, 9, ch, true);
  const float ba = dwb[ch], bb = dwb[cpad + ch];
  const float sv = kApply ? s[(size_t)b * cpad + ch] : 0.f;
  float sum = 0.f;

  item_loop(
      full, items.n,
      [&](int i, int st) {
        int oy, ox, box;
        items.at(i, oy, ox, box);
        mbar_arrive_expect_tx(full + st, kP1 * 2 * kHC * 2);
        tma_load(base + st * L::kStage, &th, full + st, 2 * c0, ox - 1,
                 oy - 1, b);
      },
      [&](int i, int st) {
        int oy, ox, box;
        items.at(i, oy, ox, box);
        const __nv_bfloat16* h =
            reinterpret_cast<const __nv_bfloat16*>(base + st * L::kStage);
        float wa[3][3], wb[3][3];
        auto at = [&](int r, int x, int half) {
          return to_f(h[((py + r) * kW1 + x) * 2 * kHC + half * kHC + j]);
        };
#pragma unroll
        for (int r = 0; r < 3; ++r)
#pragma unroll
          for (int c = 1; c < 3; ++c) {
            wa[r][c] = at(r, c - 1, 0);
            wb[r][c] = at(r, c - 1, 1);
          }
        const int gy = oy + py;
        __nv_bfloat16* row =
            kApply ? gs + (((size_t)b * H + gy) * W + ox) * cpad + ch
                   : nullptr;
        for (int px = 0; px < kTW; ++px) {
          float da = 0.f, db = 0.f;
#pragma unroll
          for (int r = 0; r < 3; ++r) {
            wa[r][0] = wa[r][1], wa[r][1] = wa[r][2];
            wb[r][0] = wb[r][1], wb[r][1] = wb[r][2];
            wa[r][2] = at(r, px + 2, 0);
            wb[r][2] = at(r, px + 2, 1);
#pragma unroll
            for (int c = 0; c < 3; ++c) {
              da += wa[r][c] * ta[r * 3 + c];
              db += wb[r][c] * tb[r * 3 + c];
            }
          }
          // body pixels past H or W (a ragged tile's) are not the image's;
          // only the window's rows count toward the sums
          const bool in = gy < H && ox + px < W;
          const bool counted = gy >= row_lo && gy < row_hi;
          const float g = rnd<__nv_bfloat16>(rnd<__nv_bfloat16>(da + ba) *
                                             rnd<__nv_bfloat16>(db + bb));
          if (kApply) {
            if (in) row[(size_t)px * cpad] = from_f<__nv_bfloat16>(g * sv);
          } else if (in && counted) {
            sum += g;
          }
        }
      });
  if (kApply) return;
  // the chunk's sums, the eight row groups added in order
  float* red = reinterpret_cast<float*>(base + L::kRed);
  red[threadIdx.x] = sum;
  __syncthreads();
  if (threadIdx.x < kHC) {
    float t = 0.f;
    for (int r = 0; r < kTH; ++r) t += red[r * kHC + j];
    sum_part[((size_t)b * nsplit + split) * cpad + ch] = t;
  }
}

// --- the SCA glue: partial sums -> s ---------------------------------------

constexpr int kGlueThreads = 256;
constexpr int kGlueCols = 32;  // output channels a CTA
constexpr int kGlueKGroups = kGlueThreads / (kGlueCols / 8);

// 4 f32 or 8 bf16 loaded as one 16-byte word
struct alignas(16) Quad {
  float v[4];
};
struct alignas(16) Word8 {
  uint32_t w[4];
};

// per (32 output channels, image).  First pooled = rnd(sum of the image's
// nsplit partials / HW) of every channel: a thread per 4 channels (16-byte
// loads), the partials split into row groups where there are fewer than
// 256 such quads, each thread adding its rows in order and the row groups
// added in order.  Then s = rnd(rnd(pooled . Wsca) + bsca) of its
// channels: a thread per 8 of them (16-byte loads of a Wsca row) and one
// of 64 groups over K, the groups added in order; s is 0 for the padded
// channels [C, cpad).
__global__ void __launch_bounds__(kGlueThreads) naf_sca_kernel(
    const float* __restrict__ sum_part, const __nv_bfloat16* __restrict__ wsca,
    const __nv_bfloat16* __restrict__ bsca, float* __restrict__ s, int nsplit,
    int HW, int C, int cpad) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* pooled = reinterpret_cast<float*>(smem_raw);  // [cpad]
  float* red = pooled + cpad;                          // [kGlueThreads][8]
  const int b = blockIdx.y, nq = cpad / 4;
  const int nqt = nq < kGlueThreads ? nq : kGlueThreads;
  const int rg = kGlueThreads / nqt, r = threadIdx.x / nqt;
  const Quad* part =
      reinterpret_cast<const Quad*>(sum_part + (size_t)b * nsplit * cpad);
  for (int q0 = 0; q0 < nq; q0 += nqt) {
    const int q = q0 + threadIdx.x % nqt;
    Quad t = {{0.f, 0.f, 0.f, 0.f}};
    if (r < rg && q < nq) {
#pragma unroll 8
      for (int k = r; k < nsplit; k += rg) {
        const Quad v = part[(size_t)k * nq + q];
#pragma unroll
        for (int e = 0; e < 4; ++e) t.v[e] += v.v[e];
      }
    }
    reinterpret_cast<Quad*>(red)[threadIdx.x] = t;
    __syncthreads();
    if (r == 0 && q < nq) {
      for (int g = 1; g < rg; ++g) {
        const Quad v =
            reinterpret_cast<const Quad*>(red)[g * nqt + threadIdx.x];
#pragma unroll
        for (int e = 0; e < 4; ++e) t.v[e] += v.v[e];
      }
#pragma unroll
      for (int e = 0; e < 4; ++e)
        pooled[4 * q + e] = rnd<__nv_bfloat16>(t.v[e] / (float)HW);
    }
    __syncthreads();
  }
  // columns n0 .. n0 + 7 of this thread, rows kg, kg + 64, ...
  const int kg = threadIdx.x / (kGlueCols / 8);
  const int n0 = blockIdx.x * kGlueCols + 8 * (threadIdx.x % (kGlueCols / 8));
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (n0 < C) {
#pragma unroll 4
    for (int k = kg; k < C; k += kGlueKGroups) {
      const Word8 w =
          *reinterpret_cast<const Word8*>(wsca + (size_t)k * C + n0);
      const float pk = pooled[k];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        // a bf16 is the upper half of its f32
        uint32_t bits = e & 1 ? w.w[e / 2] & 0xffff0000u : w.w[e / 2] << 16;
        float wf;
        memcpy(&wf, &bits, 4);
        acc[e] += pk * wf;
      }
    }
  }
#pragma unroll
  for (int e = 0; e < 8; ++e) red[e * kGlueThreads + threadIdx.x] = acc[e];
  __syncthreads();
  if (threadIdx.x < kGlueCols) {
    const int n = blockIdx.x * kGlueCols + threadIdx.x;
    const int lane = threadIdx.x / 8, e = threadIdx.x % 8;
    float t = 0.f;
    for (int g = 0; g < kGlueKGroups; ++g)
      t += red[e * kGlueThreads + g * (kGlueCols / 8) + lane];
    if (n < cpad)
      s[(size_t)b * cpad + n] =
          n < C ? rnd<__nv_bfloat16>(rnd<__nv_bfloat16>(t) + to_f(bsca[n]))
                : 0.f;
  }
}

}  // namespace

extern "C" {

// The gate stencil's chunk width (channels of each half per box).
int naf_gate_chunk() { return kHC; }

// hids (B H W, 2 cpad) bf16, conv1's output with its bias in W1's
// interleaved 32-channel chunks; taps (18, cpad) f32, the first half's in
// rows 0-8; dwb (2, cpad) f32.  apply 0 (SUM): sum_part (B, nsplit, cpad)
// f32, each CTA's sums of the rounded gate over its image pixels of rows
// [row_lo, row_hi) (0 <= row_lo <= row_hi <= H; a row-sharded slab's own
// rows, without its halo).  apply 1 (APPLY): s (B, cpad) f32, the SCA
// scale; gs (B H W, cpad) bf16 = rnd(g s), every row.  A CTA per (split,
// chunk, image): nsplit splits of the image's 8 x 16 tiles.  Returns a
// cudaError_t.
int naf_gate_stencil_rows(const void* hids, const float* taps,
                          const float* dwb, const float* s, void* gs,
                          float* sum_part, int B, int H, int W, int cpad,
                          int nsplit, int apply, int row_lo, int row_hi,
                          void* stream) {
  if (bad_grid(B, H, W, nsplit) || cpad <= 0 || cpad % kHC ||
      (apply ? !s || !gs : !sum_part) || row_lo < 0 || row_hi < row_lo ||
      row_hi > H)
    return (int)cudaErrorInvalidValue;
  CUtensorMap th;
  int err;
  if ((err = view_map(&th, nhwc_view(hids, B, H, W, 2 * cpad, 2 * kHC, kW1,
                                     kH1), false, false)))
    return err;
  const dim3 grid(nsplit * (cpad / kHC), B);
  cudaStream_t st = (cudaStream_t)stream;
  if (apply) {
    static const int attr = prepare(naf_gate_kernel<1>, NafSmem::kBytes);
    if (attr != 0) return attr;
    naf_gate_kernel<1><<<grid, kNafThreads, NafSmem::kBytes, st>>>(
        th, taps, dwb, s, (__nv_bfloat16*)gs, nullptr, H, W, cpad, nsplit,
        row_lo, row_hi);
  } else {
    static const int attr = prepare(naf_gate_kernel<0>, NafSmem::kBytes);
    if (attr != 0) return attr;
    naf_gate_kernel<0><<<grid, kNafThreads, NafSmem::kBytes, st>>>(
        th, taps, dwb, nullptr, nullptr, sum_part, H, W, cpad, nsplit,
        row_lo, row_hi);
  }
  return (int)cudaGetLastError();
}

// naf_gate_stencil_rows with the sums over every row.
int naf_gate_stencil(const void* hids, const float* taps, const float* dwb,
                     const float* s, void* gs, float* sum_part, int B, int H,
                     int W, int cpad, int nsplit, int apply, void* stream) {
  return naf_gate_stencil_rows(hids, taps, dwb, s, gs, sum_part, B, H, W,
                               cpad, nsplit, apply, 0, H, stream);
}

// sum_part (B, nsplit, cpad) f32 from the SUM pass (a row-sharded slab
// passes its partials summed, then summed over the ranks, as nsplit 1);
// HW the pixels the mean divides by (the whole image's); wsca (C, C) bf16
// (the SCA 1x1, inputs by outputs); bsca (C) bf16.  Output s (B, cpad) f32
// holding bf16 values, 0 past C.  Returns a cudaError_t.
int naf_sca_glue(const float* sum_part, const void* wsca, const void* bsca,
                 float* s, int B, int HW, int C, int cpad, int nsplit,
                 void* stream) {
  const int smem = (cpad + 8 * kGlueThreads) * 4;  // pooled, the sums
  if (B <= 0 || B > 65535 || HW <= 0 || C <= 0 || C % 8 || cpad < C ||
      cpad % 4 || nsplit <= 0 || smem > 48 * 1024 || (uintptr_t)wsca % 16 ||
      (uintptr_t)sum_part % 16)
    return (int)cudaErrorInvalidValue;
  naf_sca_kernel<<<dim3((cpad + kGlueCols - 1) / kGlueCols, B), kGlueThreads,
                   smem, (cudaStream_t)stream>>>(
      sum_part, (const __nv_bfloat16*)wsca, (const __nv_bfloat16*)bsca, s,
      nsplit, HW, C, cpad);
  return (int)cudaGetLastError();
}

}  // extern "C"
