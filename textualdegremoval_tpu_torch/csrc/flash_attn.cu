// Non-causal multi-head self-attention forward for Hopper (sm_90a):
//
//   o = softmax(q k^T * scale) v      per (batch, head), scale = D^-0.5
//
// Replaces the stock Pallas TPU flash-attention kernel that
// textualdegremoval_tpu/ops/flash_attn.py `self_attention` reaches (via
// jax.experimental.pallas.ops.tpu.flash_attention, 512-wide blocks).  That
// kernel was not written by the package; this one is a port of what it
// computes, not of its blocks.  In pipeline A it runs every SD UNet
// self-attention at the 64 x 64 latent of a 512 px image: (2, 4096, 5, 64)
// under classifier-free guidance, five launches per UNet forward.
//
// What bounds it on the card: operations.  4 B H N^2 D = 42.9 GFLOP per
// launch at (2, 4096, 5, 64), 0.043 ms at the 989 TFLOP/s bf16 peak; its
// bytes (q, k, v, o: 21 MB) take 6.3 us at 3.35 TB/s.  The plain version
// moves the (B, H, N, N) f32 logits through device memory several times
// (671 MB each way at that shape); this kernel keeps them on chip.  Only
// wgmma reaches the tensor cores' full rate on Hopper, and it needs its
// operands in shared memory in time: so the loads overlap the products.
//
// Design (bf16, flash_bf16_kernel): one CTA per (128-row query tile, head,
// batch) of two consumer warpgroups (64 query rows each) and one producer
// warp, 288 threads, one CTA per SM.  The producer's first lane loads the
// q tile once by TMA, then keeps K and V tiles of 128 keys in flight by TMA
// in a ring of 3 stages (D = 64; 2 at D = 128): each stage has a "full"
// mbarrier that expects the tile's bytes and an "empty" one that the 8
// consumer warps release after their products have read it.  Tiles land
// 128-byte swizzled (hopper.cuh), rows of 64 dims; a D = 128 row is two
// such boxes.  Per key tile each consumer warpgroup runs S = q K^T as
// wgmma m64n128k16 with both operands in shared memory (K's rows are
// D-contiguous: K-major for B), then the online softmax in f32 registers
// (the row max through the quad of lanes that share a row, exp2 of the
// logits scaled and shifted by the max in one FMA, the accumulator
// rescaled by exp2(m_old - m_new)), then O += P V as wgmma with P in
// registers (the S accumulator rounded to bf16 is the A layout as it
// stands) and V read MN-major from its tile (the transpose bit), one
// division by the row sum at the end.  The two warpgroups take turns at
// S (named barriers): one's softmax, on the special-function and FMA
// units, runs while the other's product holds the tensor cores.  Keys
// past N arrive as zeros and are set to -inf before the max; query rows
// past N are computed and not written.  Registers: 64 S + 32 (D = 64) or
// 64 O accumulators a thread, within the 168 that ptxas gives each of
// the 288 threads (D = 128 is at the cap, and ptxas serialises its
// products).  At (2, 4096, 5, 64): 320 CTAs on 132 SMs, 2.42 waves.
// float32
// (flash_f32_kernel) keeps 64-row tiles and the online softmax in FMA
// loops: two threads per query row, P through shared memory.  No atomics:
// a repeated call is bitwise equal.
//
// q, k and v are read in place from the (B, N, H*D) projection layout:
// element (b, n, h, d) of each is at b*sb + n*sn + h*sh + d, with strides
// given per tensor (bf16: through one tensor map each, encoded per call).
// o is written contiguous (B, N, H, D).  Where the caller asks for it
// (training), each row's log-sum-exp is written too, in natural-log units
// (m + log2 l, times ln 2): the backward of flash_attn_bwd.cu recomputes
// P = exp(S - lse) from it.
//
// Later work, not here: overlapping one tile's softmax with the next
// tile's products inside a warpgroup (more registers: a producer
// warpgroup with setmaxnreg), a persistent tile scheduler against the
// last wave's idle SMs, o stored through shared memory by TMA.

#include "flash_common.cuh"

#ifndef TBLOCK_HOST_BUILD
#include <math.h>
#endif

namespace {

// ---------------------------------------------------------------------------
// bf16: TMA ring, wgmma products
// ---------------------------------------------------------------------------

constexpr int kFwdRows = 128;    // query rows per CTA, 64 per warpgroup
constexpr int kFwdKeys = 128;    // keys per ring stage
constexpr int kFwdThreads = 288;  // two consumer warpgroups, a producer warp

// shared memory of flash_bf16_kernel, bytes from its 1024-aligned base:
// q (D / 64 boxes of 128 x 64), then per stage a K and a V tile, then the
// mbarriers; plus the slack that aligns the base
template <int D>
struct FwdSmem {
  static constexpr int kStages = D == 64 ? 3 : 2;
  static constexpr int kTile = kFwdKeys * D * 2;  // one K or V tile
  static constexpr int kKv = kFwdRows * D * 2;    // stage s at kKv + 2 s kTile
  static constexpr int kBars = kKv + kStages * 2 * kTile;
  static constexpr int kBytes = kBars + (2 * kStages + 1) * 8 + 1024;
};

template <int D>
__global__ void __launch_bounds__(kFwdThreads, 1) flash_bf16_kernel(
    const __grid_constant__ CUtensorMap tq,
    const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
    float* __restrict__ lse, int N, int H, float scale_log2) {
  using L = FwdSmem<D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base = smem_raw + (1024 - smem_addr(smem_raw) % 1024) % 1024;
  const Ring<L::kStages> ring(base + L::kBars, 1);
  uint64_t *full = ring.full, *empty = ring.empty, *qbar = ring.res;

  const int b = blockIdx.z, h = blockIdx.y, row0 = blockIdx.x * kFwdRows;
  const int n_tiles = (N + kFwdKeys - 1) / kFwdKeys;

  const int wg = warpgroup_index();
  if (wg == 2) {  // the producer warp: its first lane loads
    if (threadIdx.x == 256) {
      mbar_arrive_expect_tx(qbar, kFwdRows * D * 2);
      for (int x = 0; x < D / 64; ++x)
        tma_load(base + x * kFwdRows * 128, &tq, qbar, 64 * x, row0, h, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % L::kStages;
        mbar_wait(empty + s, ((it / L::kStages) & 1) ^ 1);
        unsigned char* kt = base + L::kKv + s * 2 * L::kTile;
        mbar_arrive_expect_tx(full + s, 2 * L::kTile);
        for (int x = 0; x < D / 64; ++x) {
          tma_load(kt + x * kFwdKeys * 128, &tk, full + s, 64 * x,
                   it * kFwdKeys, h, b);
          tma_load(kt + L::kTile + x * kFwdKeys * 128, &tv, full + s, 64 * x,
                   it * kFwdKeys, h, b);
        }
      }
    }
    return;
  }

  const int warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31, g = lane >> 2, tig = lane & 3;
  // this warpgroup's 64 q rows in each box
  const uint32_t qa = smem_addr(base) + wg * 64 * 128;

  // this thread's parts of rows g (index 0) and g + 8 (index 1) of its
  // warp's 16; accumulator entry 4 j + i is column 8 j + 2 tig + (i & 1)
  // of row g + 8 (i >> 1)
  float m0 = -INFINITY, m1 = -INFINITY;  // running max of q.k (unscaled)
  float l0 = 0.f, l1 = 0.f;              // running sums, this thread's keys
  float acc[D / 2];
#pragma unroll
  for (int j = 0; j < D / 2; ++j) acc[j] = 0.f;

  // The two warpgroups take turns at S = q K^T (named barriers 1 and 2,
  // "your turn"): one's softmax runs while the other's product does.
  if (wg == 1) named_arrive(1, 256);
  mbar_wait(qbar, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % L::kStages, kv0 = it * kFwdKeys;
    mbar_wait(full + s, (it / L::kStages) & 1);
    const uint32_t ka = smem_addr(base + L::kKv + s * 2 * L::kTile);
    const uint32_t va = ka + L::kTile;

    // S = q K^T over the tile's 128 keys, 16 dims per product
    float sc[kFwdKeys / 2];
    named_sync(1 + wg, 256);
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      const uint32_t off = (kc / 4) * 128 * 128 + (kc % 4) * 32;
      wgmma_ss<kFwdKeys, 0>(sc, desc_sw128(qa + off, 16, 1024),
                            desc_sw128(ka + off, 16, 1024), kc > 0);
    }
    wgmma_commit();
    wgmma_wait();
    fence_regs(sc);
    if (wg == 0 || it + 1 < n_tiles) named_arrive(2 - wg, 256);

    // mask the keys past N (the last tile), row max over the tile
    if (kv0 + kFwdKeys > N) {
#pragma unroll
      for (int j = 0; j < kFwdKeys / 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (kv0 + j * 8 + tig * 2 + (i & 1) >= N) sc[4 * j + i] = -INFINITY;
    }
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < kFwdKeys / 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    // key kv0 < N is in every tile, so the new max is finite; the scale
    // goes into one FMA with the max: 2^(s sl2 - m sl2)
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float al0 = fast_exp2((m0 - mn0) * scale_log2);
    const float al1 = fast_exp2((m1 - mn1) * scale_log2);
    m0 = mn0;
    m1 = mn1;
    const float ms0 = mn0 * scale_log2, ms1 = mn1 * scale_log2;

    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int j = 0; j < kFwdKeys / 8; ++j) {
      sc[4 * j] = fast_exp2(fmaf(sc[4 * j], scale_log2, -ms0));
      sc[4 * j + 1] = fast_exp2(fmaf(sc[4 * j + 1], scale_log2, -ms0));
      sc[4 * j + 2] = fast_exp2(fmaf(sc[4 * j + 2], scale_log2, -ms1));
      sc[4 * j + 3] = fast_exp2(fmaf(sc[4 * j + 3], scale_log2, -ms1));
      rs0 += sc[4 * j] + sc[4 * j + 1];
      rs1 += sc[4 * j + 2] + sc[4 * j + 3];
    }
    l0 = l0 * al0 + rs0;
    l1 = l1 * al1 + rs1;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      acc[4 * j] *= al0; acc[4 * j + 1] *= al0;
      acc[4 * j + 2] *= al1; acc[4 * j + 3] *= al1;
    }

    // O += P V: P's A registers for keys [16 kc, 16 kc + 16) are S's
    // entries of columns 2 kc and 2 kc + 1 rounded to bf16; V MN-major, 16
    // key rows (2048 bytes) per product, its D = 128 boxes one tile apart
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < kFwdKeys / 16; ++kc) {
      const uint32_t pa[4] = {pack_f32(sc[8 * kc], sc[8 * kc + 1]),
                              pack_f32(sc[8 * kc + 2], sc[8 * kc + 3]),
                              pack_f32(sc[8 * kc + 4], sc[8 * kc + 5]),
                              pack_f32(sc[8 * kc + 6], sc[8 * kc + 7])};
      wgmma_rs<D, 1>(acc, pa, desc_sw128(va + kc * 2048, kFwdKeys * 128, 1024),
                     1);
    }
    wgmma_commit();
    wgmma_wait();
    fence_regs(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + s);  // this warp read K and V
  }

  // the row sums over the quad, one division, rows past N not written
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  const int r0 = row0 + wg * 64 + warp * 16 + g, r1 = r0 + 8;
  if (lse != nullptr && tig == 0) {  // natural-log units, as exp() reads it
    float* lb = lse + ((long long)b * H + h) * N;
    if (r0 < N) lb[r0] = (m0 * scale_log2 + log2f(l0)) * kLn2;
    if (r1 < N) lb[r1] = (m1 * scale_log2 + log2f(l1)) * kLn2;
  }
  const long long o_sn = (long long)H * D;
  __nv_bfloat16* ob = o + ((long long)b * N * H + h) * D + tig * 2;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    if (r0 < N)
      *reinterpret_cast<uint32_t*>(ob + r0 * o_sn + j * 8) =
          pack_f32(acc[4 * j] * inv0, acc[4 * j + 1] * inv0);
    if (r1 < N)
      *reinterpret_cast<uint32_t*>(ob + r1 * o_sn + j * 8) =
          pack_f32(acc[4 * j + 2] * inv1, acc[4 * j + 3] * inv1);
  }
}


// ---------------------------------------------------------------------------
// float32: FMA loops, two threads per query row
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kFaThreads) flash_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ o,
    float* __restrict__ lse, int N, int H,
    long long q_sb, long long q_sn, long long q_sh, long long k_sb,
    long long k_sn, long long k_sh, long long v_sb, long long v_sn,
    long long v_sh, float scale_log2) {
  // q and k rows padded by one word: the 16 rows a warp reads at one
  // column, and the two keys its halves read, fall in different banks
  constexpr int LDQ = D + 1, LDV = D, LDP = kFaKeys + 1;
  constexpr int kHalf = kFaKeys / 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);
  float* ks = qs + kFaRows * LDQ;
  float* vs = ks + kFaKeys * LDQ;
  float* ps = vs + kFaKeys * LDV;

  const int b = blockIdx.z, h = blockIdx.y, row0 = blockIdx.x * kFaRows;
  // thread (r, half): keys 2 jj + half of each tile, dims 2 dd + half
  const int r = threadIdx.x >> 1, half = threadIdx.x & 1;
  const float* kb = k + b * k_sb + h * k_sh;
  const float* vb = v + b * v_sb + h * v_sh;

  stage_rows<float, D, false>(qs, LDQ, q + b * q_sb + h * q_sh, q_sn, row0, N);

  float m = -INFINITY, l = 0.f;
  float acc[D / 2];
#pragma unroll
  for (int dd = 0; dd < D / 2; ++dd) acc[dd] = 0.f;

  for (int kv0 = 0; kv0 < N; kv0 += kFaKeys) {
    __syncthreads();
    stage_rows<float, D, false>(ks, LDQ, kb, k_sn, kv0, N);
    stage_rows<float, D, true>(vs, LDV, vb, v_sn, kv0, N);
    __syncthreads();

    float s[kHalf];
#pragma unroll
    for (int jj = 0; jj < kHalf; ++jj) s[jj] = 0.f;
    const float* qr = qs + (size_t)r * LDQ;
    for (int d = 0; d < D; ++d) {
      const float qv = qr[d];
#pragma unroll
      for (int jj = 0; jj < kHalf; ++jj)
        s[jj] += qv * ks[(size_t)(2 * jj + half) * LDQ + d];
    }
    float mx = -INFINITY;
#pragma unroll
    for (int jj = 0; jj < kHalf; ++jj) {
      s[jj] = kv0 + 2 * jj + half < N ? s[jj] * scale_log2 : -INFINITY;
      mx = fmaxf(mx, s[jj]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float mn = fmaxf(m, mx);
    const float al = exp2f(m - mn);
    m = mn;
    float rs = 0.f;
#pragma unroll
    for (int jj = 0; jj < kHalf; ++jj) {
      const float p = exp2f(s[jj] - mn);
      rs += p;
      ps[(size_t)r * LDP + 2 * jj + half] = p;
    }
    l = l * al + rs;
#pragma unroll
    for (int dd = 0; dd < D / 2; ++dd) acc[dd] *= al;
    __syncthreads();  // the row's other half of P is written

    const float* pr = ps + (size_t)r * LDP;
    for (int j = 0; j < kFaKeys; ++j) {
      const float p = pr[j];
      const float* vr = vs + (size_t)j * LDV + half;
#pragma unroll
      for (int dd = 0; dd < D / 2; ++dd) acc[dd] += p * vr[2 * dd];
    }
  }

  l += __shfl_xor_sync(0xffffffffu, l, 1);
  const float inv = 1.f / l;
  if (lse != nullptr && half == 0 && row0 + r < N)
    lse[((long long)b * H + h) * N + row0 + r] = (m + log2f(l)) * kLn2;
  if (row0 + r < N) {
    float* orow = o + (((long long)b * N + row0 + r) * H + h) * D + half;
#pragma unroll
    for (int dd = 0; dd < D / 2; ++dd) orow[2 * dd] = acc[dd] * inv;
  }
}

size_t f32_smem_bytes(int D) {
  return ((size_t)(kFaRows + kFaKeys) * (D + 1) + (size_t)kFaKeys * D +
          (size_t)kFaRows * (kFaKeys + 1)) * sizeof(float);
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* o,
                float* lse, int B, int N, int H, const long long* st,
                float scale, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  int err;
  if ((err = bnhd_map(&tq, q, B, N, H, D, st[0], st[1], st[2], kFwdRows)) ||
      (err = bnhd_map(&tk, k, B, N, H, D, st[3], st[4], st[5], kFwdKeys)) ||
      (err = bnhd_map(&tv, v, B, N, H, D, st[6], st[7], st[8], kFwdKeys)))
    return err;
  static const int attr = (int)cudaFuncSetAttribute(
      flash_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      FwdSmem<D>::kBytes);
  if (attr != 0) return attr;
  const dim3 grid((N + kFwdRows - 1) / kFwdRows, H, B);
  flash_bf16_kernel<D><<<grid, kFwdThreads, FwdSmem<D>::kBytes, stream>>>(
      tq, tk, tv, (__nv_bfloat16*)o, lse, N, H, scale * kLog2e);
  return (int)cudaGetLastError();
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o,
               float* lse, int B, int N, int H, const long long* st,
               float scale, cudaStream_t stream) {
  const size_t smem = f32_smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      flash_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + kFaRows - 1) / kFaRows, H, B);
  flash_f32_kernel<D><<<grid, kFaThreads, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, lse, N,
      H, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      scale * kLog2e);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* flash_attn_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// q, k, v: (B, N, H, D) of one dtype (bf16 when is_bf16, else f32), element
// (b, n, h, d) of q at q + b*q_sb + n*q_sn + h*q_sh + d (strides in
// elements, each a multiple of 16 bytes, as the base pointers are); o:
// contiguous (B, N, H, D); lse: null, or a contiguous f32 (B, H, N) that
// gets each row's log-sum-exp of q k^T * scale (natural log), for the
// backward.  D is 64 or 128.  Returns a cudaError_t.
int flash_attn_fwd(const void* q, const void* k, const void* v, void* o,
                   float* lse, int B, int N, int H, int D, long long q_sb, long long q_sn,
                   long long q_sh, long long k_sb, long long k_sn,
                   long long k_sh, long long v_sb, long long v_sn,
                   long long v_sh, float scale, int is_bf16, void* stream) {
  if (B <= 0 || N <= 0 || H <= 0 || B > 65535 || H > 65535 ||
      (D != 64 && D != 128))
    return (int)cudaErrorInvalidValue;
  const long long st[9] = {q_sb, q_sn, q_sh, k_sb, k_sn, k_sh,
                           v_sb, v_sn, v_sh};
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return D == 64 ? launch_bf16<64>(q, k, v, o, lse, B, N, H, st, scale, s)
                   : launch_bf16<128>(q, k, v, o, lse, B, N, H, st, scale, s);
  return D == 64 ? launch_f32<64>(q, k, v, o, lse, B, N, H, st, scale, s)
                 : launch_f32<128>(q, k, v, o, lse, B, N, H, st, scale, s);
}

}  // extern "C"
