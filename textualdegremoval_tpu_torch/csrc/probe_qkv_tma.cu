// The qkv probe's two forms in bf16 for Hopper (sm_90a) on TMA and wgmma:
// y = dw3x3(x . W), one 1x1 product and one 3x3 depthwise stencil with
// zero padding.  The bf16 route of ops/probes.py (C and co multiples of
// 8); float32 and other widths keep probe_qkv_form.cu.
//
// Replaces, in bf16, the TPU probe kernels of tools/bench_qkv_form.py:
// `_run_pallas` (:109) running `_kernel_current` (:51) or
// `_kernel_composed` (:70).  Their rounding points are kept:
//
//   current:  lin = rnd(x . W) (f32 sums over K = C), zero outside the
//             image; y = rnd(the 9-tap f32 sum of lin and the f32 taps).
//   composed: y = rnd(X9 . W9), one f32 sum over K = 9C, X9 the nine
//             shifted copies of x (zero outside the image) and
//             W9[(tap, ci), co] = W[ci, co] dw[tap, co] in bf16.
//
// What bounds them on the card: the function's bytes (x read and y
// written once: C + co values a pixel against 2 C co + 18 co operations,
// below the card's 295 operations a byte at every tool case), and for
// composed at 96 -> 256 its own tensor-core work (2 9C co a pixel, 0.117
// ms against the bytes' 0.055).  What each form adds to that is its
// question: composed rereads x nine times (one shifted window per tap)
// and W9 once per 128-pixel tile, from L2; current recomputes the product
// on the tile's 1-pixel ring (1.41x at 8 x 16) and reads lin nine times
// from shared memory on the CUDA cores.
//
// composed (`qkv_composed_tma_kernel`): an implicit GEMM.  A CTA's item is
// an 8 x 16 tile of one image (M = 128, 64 rows per consumer warpgroup)
// and a BN-wide block of the co columns (BN 64-256, one wgmma width).  K
// runs over (tap, 64-channel box): for each, the producer warp TMA-loads
// the x window shifted by (dy - 1, dx - 1), one box of the (C, W, H, B)
// view with the 128-byte swizzle, whose zeros outside the image are the
// zero padding and whose channels past C are zeros too (K padded to 64 a
// box).  The matching W9 slice is the B operand, K-major, a box of the
// (C, 9, co) view of W9 (co, 9C): in the same stage of a 4-stage ring
// (full / empty mbarriers, bwd_gemm.cu's skeleton), or, where all
// of W9 fits beside the ring (C <= 64, co <= 128), loaded once and kept.
// CTAs are persistent and walk a strided item list, so the next item's
// boxes load under this item's products and epilogue.  The epilogue
// rounds to bf16 and stores 16-byte runs (runs16.cuh).
//
// current (`qkv_current_tma_kernel`): one kernel, the product, then the
// stencil, lin kept on chip.  A CTA owns one 64-column slice of W (kept
// in shared memory) and one image, and walks a strided list of 8 x 16
// tiles (halo_tiles.cuh's `Items`); C <= 256.  A tile's 10 x 18 halo of x
// arrives by TMA, one box per 64 channels (128-byte swizzle, zeros
// outside the image, so lin is zero there: the 1x1 has no bias), in one
// of 3 stages (2 above C = 128), loaded that many tiles ahead.  wgmma
// forms lin on the 180 halo pixels padded to M = 192 (three m64 products,
// two on the first warpgroup), K = C, N = 64.  lin is rounded to bf16
// into the stage it was computed from (rows of 128 bytes, 16-byte chunk c
// of row q at chunk c ^ (q % 8), so that the accumulators' writes and the
// stencil's 16-byte reads are free of bank conflicts); then the next
// tile's products are issued, and run on the tensor cores while this
// tile's stencil runs on the CUDA cores: each thread sums 8 channels of 4
// output pixels over the 9 taps in f32, a halo row at a time (its 3 taps
// in registers, each of its 6 lin runs converted once: all 9 taps at once
// spill to local memory, which misses L1), and stores each pixel's 8
// channels as one 16-byte run.

#include "halo_tiles.cuh"
#include "runs16.cuh"

namespace {

constexpr int kATile = kTH * kTW * 128;  // 128 pixels x 64 bf16 channels

// --- composed ---------------------------------------------------------------

constexpr int kCmpThreads = 288;  // two consumer warpgroups, a producer warp
constexpr int kCmpStages = 4;
constexpr int kMaxSmem = 232448;  // a block's dynamic shared memory

// Shared memory from the 1024-aligned base: the ring's stages (an x window
// and, unless W9 is resident, its W9 slice), then W9 where resident (9
// nkb slices of BN x 64), then the mbarriers; plus the alignment slack.
struct CmpSmem {
  int stage, w9, bars, bytes;
  __host__ __device__ CmpSmem(int bn, bool resident, int nkb)
      : stage(kATile + (resident ? 0 : bn * 128)),
        w9(kCmpStages * stage),
        bars(w9 + (resident ? 9 * nkb * bn * 128 : 0)),
        bytes(bars + (2 * kCmpStages + 1) * 8 + 1024) {}
};

template <int BN, bool kResident>
__global__ void __launch_bounds__(kCmpThreads,
                                  BN > 128 ? 1 : 2) qkv_composed_tma_kernel(
    const __grid_constant__ CUtensorMap tx,
    const __grid_constant__ CUtensorMap tw9, __nv_bfloat16* __restrict__ out,
    int B, int H, int W, int C, int co) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base = align1k(smem_raw);
  const int nkb = (C + 63) / 64, nsteps = 9 * nkb;
  const CmpSmem L(BN, kResident, nkb);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + L.bars);
  uint64_t* empty = full + kCmpStages;
  uint64_t* wbar = empty + kCmpStages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kCmpStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 8);
    }
    mbar_init(wbar, 1);
    mbar_init_fence();
  }
  __syncthreads();
  const int ntx = (W + kTW - 1) / kTW, nty = (H + kTH - 1) / kTH;
  const int nnb = (co + BN - 1) / BN, nitems = B * nty * ntx * nnb;
  // item = ((b, tile row, tile column), column block), the block fastest
  auto item_at = [&](int item, int& b, int& oy, int& ox, int& nb) {
    nb = item % nnb;
    int t = item / nnb;
    ox = (t % ntx) * kTW;
    t /= ntx;
    oy = (t % nty) * kTH;
    b = t / nty;
  };
  const int wg = warpgroup_index(), lane = threadIdx.x & 31;

  if (wg == 2) {  // the producer warp: its first lane loads
    if (lane != 0) return;
    if (kResident) {  // W9 whole (nnb is 1): slice (tap, kb) at (tap nkb + kb)
      mbar_arrive_expect_tx(wbar, 9 * nkb * BN * 128);
      for (int step = 0; step < nsteps; ++step)
        tma_load(base + L.w9 + step * BN * 128, &tw9, wbar,
                 64 * (step % nkb), step / nkb, 0, 0);
    }
    int it = 0;
    for (int item = blockIdx.x; item < nitems; item += gridDim.x) {
      int b, oy, ox, nb;
      item_at(item, b, oy, ox, nb);
      for (int step = 0; step < nsteps; ++step, ++it) {
        const int s = it % kCmpStages, tap = step / nkb, kb = step % nkb;
        mbar_wait(empty + s, ((it / kCmpStages) & 1) ^ 1);
        unsigned char* st = base + s * L.stage;
        mbar_arrive_expect_tx(full + s, L.stage);
        tma_load(st, &tx, full + s, 64 * kb, ox + tap % 3 - 1,
                 oy + tap / 3 - 1, b);
        if (!kResident)
          tma_load(st + kATile, &tw9, full + s, 64 * kb, tap, nb * BN, 0);
      }
    }
    return;
  }

  const int warp = (threadIdx.x >> 5) & 3, gq = lane >> 2, tig = lane & 3;
  if (kResident) mbar_wait(wbar, 0);
  float acc[BN / 2];
  int it = 0;
  for (int item = blockIdx.x; item < nitems; item += gridDim.x) {
    int b, oy, ox, nb;
    item_at(item, b, oy, ox, nb);
    for (int step = 0; step < nsteps; ++step, ++it) {
      const int s = it % kCmpStages;
      mbar_wait(full + s, (it / kCmpStages) & 1);
      // this warpgroup's 64 pixel rows of the window; the slice's BN rows
      const uint32_t at = smem_addr(base + s * L.stage) + wg * 64 * 128;
      const uint32_t bt =
          smem_addr(base + (kResident ? L.w9 + step * BN * 128
                                      : s * L.stage + kATile));
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < 4; ++kc)
        wgmma_ss<BN, 0>(acc, desc_sw128(at + kc * 32, 16, 1024),
                        desc_sw128(bt + kc * 32, 16, 1024),
                        step > 0 || kc > 0);  // the first ignores acc
      wgmma_commit();
      wgmma_wait();
      fence_regs(acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + s);  // this warp read the stage
    }
    // entry 4 j + 2 h + c: pixel row r = 64 wg + 16 warp + gq + 8 h of the
    // tile, column 8 j + 2 tig + c of the block; each lane stores 16-byte
    // runs after the quad's trade (every lane takes part in the shuffles)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wg * 64 + warp * 16 + gq + 8 * h;
      const int gy = oy + r / kTW, gx = ox + r % kTW;
      const bool in = gy < H && gx < W;
      __nv_bfloat16* row =
          out + (((size_t)b * H + (in ? gy : 0)) * W + (in ? gx : 0)) * co;
#pragma unroll
      for (int j4 = 0; j4 < BN / 32; ++j4) {
        uint32_t wv[4], tw[4];
#pragma unroll
        for (int t = 0; t < 4; ++t)
          wv[t] = bf16_pair(acc[4 * (4 * j4 + t) + 2 * h],
                            acc[4 * (4 * j4 + t) + 2 * h + 1]);
        quad_transpose(wv, tw, tig);
        const int n = nb * BN + 8 * (4 * j4 + tig);
        if (in && n < co)
          *reinterpret_cast<Run16*>(row + n) = Run16{{tw[0], tw[1], tw[2],
                                                      tw[3]}};
      }
    }
  }
}

// the column block of composed: one wgmma width at or above co, at most 256
int composed_bn(int co) {
  return co <= 64 ? 64 : co <= 128 ? 128 : co <= 192 ? 192 : 256;
}
// W9 kept in shared memory: the whole of it beside the ring
bool composed_resident(int C, int co) {
  return (C + 63) / 64 == 1 && co <= 128;
}

// --- current ----------------------------------------------------------------

constexpr int kCurThreads = 256;  // two warpgroups: products, then stencil
constexpr int kHaloBox = 192 * 128;  // a 64-channel box of the 180-pixel
                                     // halo, padded to 3 x m64 rows
constexpr int kCurMaxBoxes = 4;      // C <= 256

// Shared memory from the 1024-aligned base: the stages (an item's nkb halo
// boxes each; 3 where they fit, else 2), W's slice (nkb boxes of 64 x 64),
// the mbarriers; plus the alignment slack.
struct CurSmem {
  int stage, nst, w, bars, bytes;
  __host__ __device__ explicit CurSmem(int nkb)
      : stage(nkb * kHaloBox),
        nst(3 * stage + nkb * 64 * 128 + 4 * 8 + 1024 <= kMaxSmem ? 3 : 2),
        w(nst * stage), bars(w + nkb * 64 * 128), bytes(bars + 4 * 8 + 1024) {}
};

// lin's 16-byte chunk c (channels 8 c .. 8 c + 7) of halo pixel q
__device__ __forceinline__ int lin_chunk(int q, int c) {
  return q * 128 + ((c ^ (q & 7)) << 4);
}

// Orders the calling thread's writes to shared memory before later TMA
// writes to the same bytes (lin's stage is loaded again).
__device__ __forceinline__ void fence_proxy_async() {
#ifndef TBLOCK_HOST_BUILD
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
#endif
}

// 4 f32 taps, loaded as one 16-byte word
struct alignas(16) Taps4 {
  float v[4];
};

// Grid (nsplit, co / 64 slices, B).  Tile i's halo boxes arrive in stage
// i % nst, loaded nst tiles ahead.  Per tile: wait for its products, round
// lin into the stage over its x, issue the next tile's products (they run
// on the tensor cores while this tile's stencil runs on the CUDA cores),
// the stencil, then the stage is loaded again.
__global__ void __launch_bounds__(kCurThreads, 1) qkv_current_tma_kernel(
    const __grid_constant__ CUtensorMap tx,
    const __grid_constant__ CUtensorMap tw, const float* __restrict__ dw,
    __nv_bfloat16* __restrict__ out, int H, int W, int C, int co) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base = align1k(smem_raw);
  const int nkb = (C + 63) / 64;
  const CurSmem L(nkb);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + L.bars);
  uint64_t* wbar = full + 3;
  if (threadIdx.x == 0) {
    for (int s = 0; s < 4; ++s) mbar_init(full + s, 1);
    mbar_init_fence();
  }
  __syncthreads();
  const int b = blockIdx.z, slice = blockIdx.y;
  const Items items(H, W, 1, blockIdx.x, gridDim.x);
  auto load = [&](int i) {
    int oy, ox, box;
    items.at(i, oy, ox, box);
    const int s = i % L.nst;
    mbar_arrive_expect_tx(full + s, nkb * kP1 * 128);
    for (int kb = 0; kb < nkb; ++kb)
      tma_load(base + s * L.stage + kb * kHaloBox, &tx, full + s, 64 * kb,
               ox - 1, oy - 1, b);
  };
  if (threadIdx.x == 0) {
    mbar_arrive_expect_tx(wbar, nkb * 64 * 128);
    for (int kb = 0; kb < nkb; ++kb)
      tma_load(base + L.w + kb * 64 * 128, &tw, wbar, 64 * kb, 64 * slice, 0,
               0);
    for (int i = 0; i < L.nst && i < items.n; ++i) load(i);
  }
  __syncwarp();
  const int wg = warpgroup_index(), lane = threadIdx.x & 31;
  const int warp = (threadIdx.x >> 5) & 3, gq = lane >> 2, tig = lane & 3;
  // warpgroup 0 takes m-tiles 0 and 2 of the halo's rows, warpgroup 1
  // m-tile 1
  const int nmt = wg == 0 ? 2 : 1;
  float acc[2][32];
  // issue tile i's products (asynchronous) into acc
  auto product = [&](int i) {
    const int s = i % L.nst;
    mbar_wait(full + s, (i / L.nst) & 1);
    wgmma_fence();  // the first product of each m-tile ignores acc
    for (int kb = 0; kb < nkb; ++kb) {
      const uint32_t at = smem_addr(base + s * L.stage + kb * kHaloBox);
      const uint32_t bt = smem_addr(base + L.w + kb * 64 * 128);
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        if (m >= nmt) break;
#pragma unroll
        for (int kc = 0; kc < 4; ++kc)
          wgmma_ss<64, 0>(acc[m],
                          desc_sw128(at + (wg + 2 * m) * 64 * 128 + kc * 32,
                                     16, 1024),
                          desc_sw128(bt + kc * 32, 16, 1024),
                          kb > 0 || kc > 0);
      }
    }
    wgmma_commit();
  };
  mbar_wait(wbar, 0);
  if (items.n > 0) product(0);
  for (int i = 0; i < items.n; ++i) {
    unsigned char* st = base + (i % L.nst) * L.stage;
    wgmma_wait();
    fence_regs(acc[0]);
    fence_regs(acc[1]);
    __syncthreads();  // both warpgroups' products read the stage's x
    // lin rounded to bf16 into the stage, rows past the halo dropped
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      if (m >= nmt) break;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int q = (wg + 2 * m) * 64 + warp * 16 + gq + 8 * h;
        if (q >= kP1) continue;
#pragma unroll
        for (int jn = 0; jn < 8; ++jn)
          *reinterpret_cast<uint32_t*>(st + lin_chunk(q, jn) + tig * 4) =
              bf16_pair(acc[m][4 * jn + 2 * h], acc[m][4 * jn + 2 * h + 1]);
      }
    }
    __syncthreads();
    if (i + 1 < items.n) product(i + 1);
    // the stencil: channels 8 c8 .. + 7 of the slice at body row py,
    // pixels 4 seg .. + 3, each an f32 sum over the taps in (dy, dx)
    // order; per halo row its 3 taps of those channels, and its 6 lin runs
    // one at a time, each converted once for the (pixel, tap) pairs it
    // meets
    int oy, ox, box;
    items.at(i, oy, ox, box);
    const int c8 = threadIdx.x & 7, seg = (threadIdx.x >> 3) & 3;
    const int py = threadIdx.x >> 5, col = 64 * slice + 8 * c8;
    const bool valid = col < co;
    float a[4][8];
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int e = 0; e < 8; ++e) a[k][e] = 0.f;
#pragma unroll 1
    for (int r = 0; r < 3; ++r) {
      float tp[3][8];
#pragma unroll
      for (int c = 0; c < 3; ++c)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const Taps4 q4 =
              valid ? *reinterpret_cast<const Taps4*>(
                          dw + (size_t)(3 * r + c) * co + col + 4 * half)
                    : Taps4{};
#pragma unroll
          for (int e = 0; e < 4; ++e) tp[c][4 * half + e] = q4.v[e];
        }
#pragma unroll
      for (int x = 0; x < 6; ++x) {
        const Run16 v = *reinterpret_cast<const Run16*>(
            st + lin_chunk((py + r) * kW1 + 4 * seg + x, c8));
        float f[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) f[e] = bf16_at(v, e);
        // pixel k meets this run at tap c = x - k, in c's order
#pragma unroll
        for (int c = 2; c >= 0; --c) {
          const int k = x - c;
          if (k < 0 || k > 3) continue;
#pragma unroll
          for (int e = 0; e < 8; ++e) a[k][e] += f[e] * tp[c][e];
        }
      }
    }
    const int gy = oy + py;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (valid && gy < H && ox + 4 * seg + k < W)
        *reinterpret_cast<Run16*>(
            out + (((size_t)b * H + gy) * W + ox + 4 * seg + k) * co + col) =
            Run16{{bf16_pair(a[k][0], a[k][1]), bf16_pair(a[k][2], a[k][3]),
                   bf16_pair(a[k][4], a[k][5]),
                   bf16_pair(a[k][6], a[k][7])}};
    fence_proxy_async();
    __syncthreads();  // the stage is free: load the tile nst on
    if (threadIdx.x == 0 && i + L.nst < items.n) load(i + L.nst);
    __syncwarp();
  }
}

// CTAs of `kernel` that fit an SM at `smem` bytes (0 where none does)
template <typename K>
int occupancy(K kernel, int threads, int smem) {
  int n = 0;
  if (prepare(kernel, smem) != 0 ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads,
                                                    smem) != cudaSuccess)
    return 0;
  return n;
}

// the composed kernel's instantiation for C, co: f(Cfg<BN, kResident>{})
template <int BN, bool kResident>
struct Cfg {
  static constexpr int bn = BN;
  static constexpr bool resident = kResident;
};
template <typename F>
int with_composed(int C, int co, F f) {
  const int bn = composed_bn(co);
  if (composed_resident(C, co))
    return bn == 64 ? f(Cfg<64, true>{}) : f(Cfg<128, true>{});
  return bn == 64    ? f(Cfg<64, false>{})
         : bn == 128 ? f(Cfg<128, false>{})
         : bn == 192 ? f(Cfg<192, false>{})
                     : f(Cfg<256, false>{});
}

int composed_smem(int C, int co) {
  return CmpSmem(composed_bn(co), composed_resident(C, co), (C + 63) / 64)
      .bytes;
}

bool bad_qkv(int B, int H, int W, int C, int co, int n) {
  return B <= 0 || H <= 0 || W <= 0 || C <= 0 || co <= 0 || n <= 0 ||
         C % 8 || co % 8 || B > 65535;
}

}  // namespace

extern "C" {

// CTAs of form 0 (current) or 1 (composed) that fit an SM at these widths
// (0 where none does); the wrapper sizes the grid with it.
int probe_qkv_tma_ctas_per_sm(int form, int C, int co) {
  if (form == 0)
    return occupancy(qkv_current_tma_kernel, kCurThreads,
                     CurSmem((C + 63) / 64).bytes);
  return with_composed(C, co, [&](auto cfg) {
    using K = decltype(cfg);
    return occupancy(qkv_composed_tma_kernel<K::bn, K::resident>,
                     kCmpThreads, composed_smem(C, co));
  });
}

// x: (B, H, W, C) bf16; w: (co, C) bf16 (the `kernel_matrix` layout); dw:
// (9, co) f32, taps in (dy, dx) order; out: (B, H, W, co) bf16; all
// contiguous, C and co multiples of 8, C <= 256.  nsplit CTAs per
// (64-column slice, image).  Returns a cudaError_t.
int probe_qkv_tma_current(const void* x, const void* w, const float* dw,
                          void* out, int B, int H, int W, int C, int co,
                          int nsplit, void* stream) {
  if (bad_qkv(B, H, W, C, co, nsplit) || C > 64 * kCurMaxBoxes ||
      (co + 63) / 64 > 65535)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tx, tw;
  int err;
  if ((err = view_map(&tx, nhwc_view(x, B, H, W, C, 64, kW1, kH1), false,
                      true)) ||
      (err = view_map(&tw, View4{w, {C, co, 1, 1}, {C, (long long)C * co,
                                                    (long long)C * co},
                                 {64, 64, 1, 1}},
                      false, true)))
    return err;
  const int smem = CurSmem((C + 63) / 64).bytes;
  if ((err = prepare(qkv_current_tma_kernel, smem))) return err;
  qkv_current_tma_kernel<<<dim3(nsplit, (co + 63) / 64, B), kCurThreads,
                           smem, (cudaStream_t)stream>>>(
      tx, tw, dw, (__nv_bfloat16*)out, H, W, C, co);
  return (int)cudaGetLastError();
}

// x: (B, H, W, C) bf16; w9: (co, 9C) bf16, columns (tap, ci) in (dy, dx,
// ci) order (`kernel_matrix` of `compose_w9`); out: (B, H, W, co) bf16;
// all contiguous, C and co multiples of 8.  nctas persistent CTAs (at
// most one per item).  Returns a cudaError_t.
int probe_qkv_tma_composed(const void* x, const void* w9, void* out, int B,
                           int H, int W, int C, int co, int nctas,
                           void* stream) {
  if (bad_qkv(B, H, W, C, co, nctas)) return (int)cudaErrorInvalidValue;
  const long long items = (long long)B * ((H + kTH - 1) / kTH) *
                          ((W + kTW - 1) / kTW) *
                          ((co + composed_bn(co) - 1) / composed_bn(co));
  if (items > 0x7fffffff) return (int)cudaErrorInvalidValue;
  nctas = nctas < items ? nctas : (int)items;
  CUtensorMap tx, tw9;
  int err;
  if ((err = view_map(&tx, nhwc_view(x, B, H, W, C, 64, kTW, kTH), false,
                      true)) ||
      (err = view_map(&tw9, View4{w9, {C, 9, co, 1}, {C, 9LL * C,
                                                      9LL * C * co},
                                  {64, 1, composed_bn(co), 1}},
                      false, true)))
    return err;
  const int smem = composed_smem(C, co);
  return with_composed(C, co, [&](auto cfg) {
    using K = decltype(cfg);
    int rc = prepare(qkv_composed_tma_kernel<K::bn, K::resident>, smem);
    if (rc != 0) return rc;
    qkv_composed_tma_kernel<K::bn, K::resident><<<nctas, kCmpThreads, smem,
                                                  (cudaStream_t)stream>>>(
        tx, tw9, (__nv_bfloat16*)out, B, H, W, C, co);
    return (int)cudaGetLastError();
  });
}

}  // extern "C"
