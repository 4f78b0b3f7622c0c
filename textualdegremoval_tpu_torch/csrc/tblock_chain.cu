// Cross-block chain of Restormer TransformerBlocks for Hopper (sm_90a):
// block i applied and block i+1's attention statistics taken in one kernel.
//
// It serves float32 (the parity path) and the bf16 widths the pipeline's
// TMA rows cannot take (C or C / heads not a multiple of 8).  bf16 chains
// at the other widths run `chain_pipeline` (ops/pallas/tblock.py): the
// block pipeline's kernels with bwd_gemm.cu's chain epilogue
// (`fwd_gemm_residual_ln`) at each block boundary.
//
// Replaces the TPU kernel `_make_apply_stats_kernel` of
// textualdegremoval_tpu/ops/pallas/tblock.py (called by
// `_tblock_chain_impl` / `tblock_chain_fused`).  A chain of n blocks runs
// as pass A of block 0 (tblock.cu), this kernel n - 1 times, and pass B of
// the last block (tblock.cu); the glue `_attn_matrix` between launches
// stays plain torch in the wrapper, ops/pallas/tblock.py.  So each
// intermediate activation is written once and read once, by the kernel of
// the next block, where the per-block kernels read it twice (pass A, then
// pass B).
//
// The TPU kernel walks row tiles in order and keeps the previous tile's
// last output row in a 1-row stash as the statistics' top halo.  CTAs of
// a CUDA grid run in no order, so here every tile recomputes its output on
// a 1-pixel ring as well (the block applied on (th + 2) x (tw + 2) pixels,
// from x on a 3-pixel halo, where pass B reads a 2-pixel one): the tile's
// statistics need block i+1's input, i.e. block i's output, on that ring.
// No CTA depends on another, so the result cannot depend on the order in
// which the card runs them; the cost is the ring's recompute, (th + 2)
// (tw + 2) / (th tw) times pass B's work, which the wrapper weighs when it
// picks the tile.
//
// One CTA per (split, image) walks a fixed, strided list of tiles (a
// persistent CTA): for each tile it applies block i on the ring region
// (`apply_region`, tblock_fwd.cuh: pass B's body), writes the tile's body
// to `out`, takes LN1 of block i+1 over the region from shared memory
// (zeros outside the image), and for every head adds the tile's per-head
// gram and q/k square sums to the CTA's own accumulators (pass A's body,
// `stats_head_tile`: q/k 1x1, zeroed outside the image on all four edges,
// 3x3 depthwise on the tile).  Only the per-head diagonal blocks of the
// gram are formed.  Each CTA writes one partial (heads x cph x cph gram,
// q and k square sums); the wrapper adds them over the split axis in a
// fixed order.  No float atomics: the result is bitwise repeatable.  With
// as many CTAs as fit on the card at once, the partials are a few MB at
// most (C cph + 2 C floats each), where one per tile would outweigh the
// activation read that the chain saves.
//
// The gram accumulators of all heads (C cph f32: 9 KB at C = 48, 72 KB at
// C = 384 with 8 heads) stay in shared memory where they fit beside the
// tile's working set; otherwise (`gram_in_smem` 0: f32 at C = 384) they
// live in the CTA's own partial slot in device memory (L2-resident), read
// and written once per tile by the thread that owns each element.
//
// What bounds it on the card: the same products and stencils as pass B
// plus those of pass A, on a region larger than the tile by the ring, so
// like tblock.cu it is bound by operand traffic through L2 and shared
// memory, not by the tensor cores.  Rounding points are those of
// tblock.cu: block i's output is bitwise what tblock_apply_kernel writes
// for the same attention matrix.  bf16 products with K % 16 == 0 run on
// mma.sync, f32 ones on FMA loops.

#include "tblock_fwd.cuh"

namespace {

size_t chain_smem_bytes(int C, int cph, int th, int tw, int eb,
                        bool gram_in_smem) {
  const int ldp = smem_ld(round_up(th * tw, 16));
  return apply_smem_bytes(C, th + 2, tw + 2, eb) +
         (size_t)4 * round_up(2 * C, 4) +
         (size_t)eb * 2 * round_up(cph, kRowPad) * ldp +
         (gram_in_smem ? (size_t)4 * C * cph : 0);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) tblock_chain_kernel(
    const T* __restrict__ x, const float* __restrict__ ln1w,
    const float* __restrict__ ln1b, const T* __restrict__ wv,
    const float* __restrict__ dwv, const T* __restrict__ attn,
    const T* __restrict__ wproj, const float* __restrict__ ln2w,
    const float* __restrict__ ln2b, const T* __restrict__ w1,
    const float* __restrict__ dwg, const T* __restrict__ w2,
    const float* __restrict__ n1w, const float* __restrict__ n1b,
    const T* __restrict__ wq, const T* __restrict__ wk,
    const float* __restrict__ dwqk, T* __restrict__ out,
    float* __restrict__ gram_part, float* __restrict__ qs_part,
    float* __restrict__ ks_part, int H, int W, int C, int heads, int hpad,
    int bias_free, int th, int tw, int gram_in_smem) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int cph = C / heads;
  const int split = blockIdx.x, nsplit = gridDim.x, b = blockIdx.y;
  const int ntx = (W + tw - 1) / tw;
  const int ntiles = ((H + th - 1) / th) * ntx;
  const int ew = tw + 2, op = (th + 2) * ew;  // the output region
  const int tp = th * tw, tp16 = round_up(tp, 16);
  const int ldc = smem_ld(C), ldp = smem_ld(tp16);
  const bool bf = bias_free != 0;

  const ApplySmem<T> s(smem_raw, C, th + 2, tw + 2);
  float* ss = reinterpret_cast<float*>(
      smem_raw + apply_smem_bytes(C, th + 2, tw + 2, sizeof(T)));  // [2][C]
  T* qT = reinterpret_cast<T*>(ss + round_up(2 * C, 4));  // [cph rows][ldp]
  T* kT = qT + (size_t)round_up(cph, kRowPad) * ldp;      // [cph rows][ldp]
  // the CTA's gram accumulators, [head][c][d]: shared memory, or its own
  // partial slot
  const size_t slot = (size_t)b * nsplit + split;
  float* gslot = gram_part + slot * heads * cph * cph;
  float* gacc = gram_in_smem
                    ? reinterpret_cast<float*>(
                          kT + (size_t)round_up(cph, kRowPad) * ldp)
                    : gslot;
  // LN1 of block i+1 over the region (ys) and one third's 1x1 output there
  // (lin) reuse pass B's buffers once block i's output is made
  T* ys = s.bufB;
  T* lin = reinterpret_cast<T*>(s.acc);

  for (int i = threadIdx.x; i < C * cph; i += blockDim.x) gacc[i] = 0.f;
  for (int i = threadIdx.x; i < 2 * C; i += blockDim.x) ss[i] = 0.f;
  // the pixel columns [tp, tp16) of qT and kT stay zero
  for (int i = threadIdx.x; i < cph * (tp16 - tp); i += blockDim.x) {
    const int c = i / (tp16 - tp), p = tp + i % (tp16 - tp);
    qT[c * ldp + p] = from_f<T>(0.f);
    kT[c * ldp + p] = from_f<T>(0.f);
  }
  __syncthreads();

  const T* xb = x + (size_t)b * H * W * C;
  const T* ab = attn + (size_t)b * heads * cph * cph;
  for (int t = split; t < ntiles; t += nsplit) {
    const int oy = (t / ntx) * th, ox = (t % ntx) * tw;
    // block i on the tile plus a 1-pixel ring: the body to `out`, the whole
    // region to s.bufA
    apply_region(xb, H, W, C, heads, hpad, bf, oy - 1, ox - 1, th + 2, ew,
                 ln1w, ln1b, wv, dwv, ab, wproj, ln2w, ln2b, w1, dwg, w2, s,
                 [&](int p, int gy, int gx, int n, T, T v) {
                   if (gy >= oy && gy < oy + th && gx >= ox && gx < ox + tw)
                     out[(((size_t)b * H + gy) * W + gx) * C + n] = v;
                   s.bufA[(size_t)p * ldc + n] = v;
                 });
    __syncthreads();
    // LN1 of block i+1 over the region, zeros outside the image
    {
      const int lane = threadIdx.x & 31;
      for (int q = threadIdx.x >> 5; q < op; q += blockDim.x >> 5) {
        const int gy = oy - 1 + q / ew, gx = ox - 1 + q % ew;
        T* d = ys + (size_t)q * ldc;
        if (gy < 0 || gy >= H || gx < 0 || gx >= W) {
          for (int c = lane; c < C; c += 32) d[c] = from_f<T>(0.f);
        } else {
          ln_pixel(s.bufA + (size_t)q * ldc, d, C, n1w, n1b, bf, lane);
        }
      }
    }
    __syncthreads();
    for (int hd = 0; hd < heads; ++hd)
      stats_head_tile(ys, ldc, oy, ox, th, tw, H, W, C, cph, hd, wq, wk, dwqk,
                      lin, qT, kT, ldp, gacc + (size_t)hd * cph * cph,
                      [&](int, int i, float v) {
                        ss[(i < cph ? 0 : C) + hd * cph + i % cph] += v;
                      });
  }

  if (gram_in_smem)
    for (int i = threadIdx.x; i < C * cph; i += blockDim.x) gslot[i] = gacc[i];
  for (int i = threadIdx.x; i < C; i += blockDim.x) {
    qs_part[slot * C + i] = ss[i];
    ks_part[slot * C + i] = ss[C + i];
  }
}

template <typename K>
cudaError_t set_smem(K kernel, size_t smem) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T>
int launch_chain(const void* const* p, int B, int H, int W, int C, int heads,
                 int hpad, int bias_free, int th, int tw, int nsplit,
                 int gram_in_smem, cudaStream_t stream) {
  const size_t smem = chain_smem_bytes(C, C / heads, th, tw, sizeof(T),
                                       gram_in_smem != 0);
  cudaError_t err = set_smem(tblock_chain_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  tblock_chain_kernel<T><<<dim3(nsplit, B), kThreads, smem, stream>>>(
      (const T*)p[0], (const float*)p[1], (const float*)p[2],
      (const T*)p[3], (const float*)p[4], (const T*)p[5], (const T*)p[6],
      (const float*)p[7], (const float*)p[8], (const T*)p[9],
      (const float*)p[10], (const T*)p[11], (const float*)p[12],
      (const float*)p[13], (const T*)p[14], (const T*)p[15],
      (const float*)p[16], (T*)p[17], (float*)p[18], (float*)p[19],
      (float*)p[20], H, W, C, heads, hpad, bias_free, th, tw, gram_in_smem);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory of the chain kernel for a th x tw tile, with the
// gram accumulators in shared memory (gram_in_smem 1) or in device memory.
long long tblock_chain_smem_bytes(int C, int heads, int th, int tw,
                                  int elem_bytes, int gram_in_smem) {
  return (long long)chain_smem_bytes(C, C / heads, th, tw, elem_bytes,
                                     gram_in_smem != 0);
}

// CTAs of the chain kernel that fit on one SM at once, or -1 on error.
int tblock_chain_ctas_per_sm(int C, int heads, int th, int tw, int is_bf16,
                             int gram_in_smem) {
  const size_t smem = chain_smem_bytes(C, C / heads, th, tw,
                                       is_bf16 ? 2 : 4, gram_in_smem != 0);
  int n = -1;
  cudaError_t err;
  if (is_bf16) {
    err = set_smem(tblock_chain_kernel<__nv_bfloat16>, smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, tblock_chain_kernel<__nv_bfloat16>, kThreads, smem);
  } else {
    err = set_smem(tblock_chain_kernel<float>, smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, tblock_chain_kernel<float>, kThreads, smem);
  }
  return err == cudaSuccess ? n : -1;
}

// Block i applied to x and block i+1's statistics over its output.
// Block i's weights as tblock_apply takes them (ln1w ... w2, attn: (B,
// heads, cph, cph) in x's dtype, [c][d] per head); block i+1's as
// tblock_stats takes them (n1w, n1b, wq, wk, dwqk).  out: (B, H, W, C);
// gram_part: (B, nsplit, heads, cph, cph) f32; qs_part, ks_part: (B,
// nsplit, C) f32.  Returns a cudaError_t.
int tblock_chain(const void* x, const void* ln1w, const void* ln1b,
                 const void* wv, const void* dwv, const void* attn,
                 const void* wproj, const void* ln2w, const void* ln2b,
                 const void* w1, const void* dwg, const void* w2,
                 const void* n1w, const void* n1b, const void* wq,
                 const void* wk, const void* dwqk, void* out, void* gram_part,
                 void* qs_part, void* ks_part, int B, int H, int W, int C,
                 int heads, int hpad, int is_bf16, int bias_free, int th,
                 int tw, int nsplit, int gram_in_smem, void* stream) {
  if (heads <= 0 || C % heads || C / heads > kMaxCph || th <= 0 || tw <= 0 ||
      nsplit <= 0 || hpad <= 0 || hpad % kHC)
    return (int)cudaErrorInvalidValue;
  const void* const p[21] = {x,   ln1w, ln1b, wv,  dwv, attn,     wproj,
                             ln2w, ln2b, w1,  dwg, w2,  n1w,      n1b,
                             wq,  wk,   dwqk, out, gram_part, qs_part,
                             ks_part};
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return launch_chain<__nv_bfloat16>(p, B, H, W, C, heads, hpad, bias_free,
                                       th, tw, nsplit, gram_in_smem, s);
  return launch_chain<float>(p, B, H, W, C, heads, hpad, bias_free, th, tw,
                             nsplit, gram_in_smem, s);
}

}  // extern "C"
