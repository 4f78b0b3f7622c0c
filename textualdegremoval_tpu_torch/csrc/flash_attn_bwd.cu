// Non-causal multi-head self-attention backward for Hopper (sm_90a):
//
//   P  = exp(S - lse),  S = q k^T * scale       (recomputed, never stored)
//   dv = P^T do
//   dP = do v^T,  dS = P o (dP - di),  di = rowsum(o o do)
//   dk = dS^T q * scale,   dq = dS k * scale
//
// per (batch, head), scale = D^-0.5; lse is the forward's row log-sum-exp
// (flash_attn.cu) and di is formed by the caller in f32 from the forward's
// own output o.
//
// Replaces the backward of the stock Pallas TPU flash-attention kernel that
// textualdegremoval_tpu/ops/flash_attn.py `self_attention` reaches: its
// custom VJP `_flash_attention_bwd` computes di in plain jnp, then runs
// `_flash_attention_bwd_dkv` (one kernel per K/V block, walking the q
// blocks) and `_flash_attention_bwd_dq` (one per q block, walking the K/V
// blocks).  The two kernels here keep that split, so no output is summed
// across CTAs and no atomics are needed: a repeated call is bitwise equal.
// In pipeline A's training they run at every SD UNet self-attention of the
// 64 x 64 latent that the loss reaches: (4, 4096, 5, 64) at batch 4.
//
// What bounds it on the card: operations.  Five products of 2 B H N^2 D
// each (S, dP, dV, dK in the dkv kernel; S and dP again and dQ in the dq
// kernel: seven as run, five as counted) = 214.7 GFLOP at (4, 4096, 5, 64),
// 0.217 ms at the 989 TFLOP/s bf16 peak; its bytes (q, k, v, o, do in; dq,
// dk, dv out: 84 MB) take 25 us at 3.35 TB/s.  Only wgmma reaches the
// tensor cores' full rate on Hopper, fed from shared memory: so the walked
// operand streams in by TMA while the products run.
//
// Design (bf16): CTAs of two consumer warpgroups and one producer warp
// (288 threads, one CTA per SM).  The CTA's 128 resident rows (keys for
// dkv, queries for dq; 64 per warpgroup) arrive once by TMA; the producer
// keeps the walked operand in flight by TMA in a ring of 3 stages, each
// with a "full" mbarrier (the tile's bytes) and an "empty" one that the 8
// consumer warps release.  Tiles land 128-byte swizzled (hopper.cuh), rows
// of 64 dims; a D = 128 row is two such boxes.  Every product is a wgmma
// with f32 sums: the two over D with both operands in shared memory
// (K-major), the two over the walked rows with A from registers (the f32
// accumulator of the first products rounded to bf16: P^T and dS^T never
// leave registers) and B read MN-major from the walked tile (the
// transpose bit).  P is formed in f32 and rounded to bf16 only as a
// product operand (as the plain version rounds the normalised
// probabilities before P v).  The two warpgroups take turns at the two
// products over D (named barriers), so that one's elementwise work runs
// while the other's products hold the tensor cores.
// * flash_bwd_dkv_bf16: one CTA per (128-key tile, head, batch), K and V
//   resident.  The ring walks q and do in tiles of 64 queries (32 at
//   D = 128), with each tile's lse (log2 units) and di, which the producer
//   warp's lanes write beside it.  Per tile: S^T = K q^T and dP^T = V do^T,
//   P^T and dS^T elementwise, dV += P^T do and dK += dS^T q.  Registers:
//   dV and dK take D/2 + D/2 a thread, S^T and dP^T 32 + 32 (D = 64) or
//   16 + 16 (D = 128, hence its shorter tile), against the 168 that ptxas
//   gives each of the 288 threads: D = 128 still spills 128 bytes and its
//   products are serialised.
// * flash_bwd_dq_bf16: one CTA per (128-query tile, head, batch), q and do
//   resident, each row's lse and di in registers.  The ring walks K and V
//   in tiles of 64 keys.  Per tile: S and dP, then dQ += dS K.
// At (4, 4096, 5, 64): 640 CTAs of each kernel on 132 SMs, 4.85 waves.
// Queries past N get lse = +inf (P = 0) and zero do, keys past N arrive as
// zeros and get P = 0 in the dq kernel; rows past N are not written.
// float32 keeps the 64-row CTAs of 4 warps in FMA loops: two threads per
// row, P and dS through shared memory.
//
// q, k, v and do are read in place with per-tensor strides, element
// (b, n, h, d) at b*sb + n*sn + h*sh + d (bf16: through one tensor map
// each, encoded per call); lse and di are contiguous f32 (B, H, N); dq, dk
// and dv are written contiguous (B, N, H, D).
//
// Later work, not here: one kernel that writes dq through a reduction
// instead of recomputing S and dP (atomics, or f32 partials), overlapping
// the elementwise work with the next tile's products inside a warpgroup,
// a producer warpgroup with setmaxnreg for D = 128's registers.

#include "flash_common.cuh"

#ifndef TBLOCK_HOST_BUILD
#include <math.h>
#endif

namespace {

// Stage entries [row0, row0 + 64) of one (batch, head) row vector, times
// mul; entries at or past N as `fill`.
__device__ void stage_vec(float* dst, const float* src, int row0, int N,
                          float mul, float fill) {
  for (int i = threadIdx.x; i < kFaRows; i += kFaThreads)
    dst[i] = row0 + i < N ? src[row0 + i] * mul : fill;
}

// ---------------------------------------------------------------------------
// bf16: TMA ring, wgmma products
// ---------------------------------------------------------------------------

constexpr int kBwdRows = 128;     // resident rows per CTA, 64 per warpgroup
constexpr int kBwdThreads = 288;  // two consumer warpgroups, a producer warp
constexpr int kBwdStages = 3;

// shared memory, bytes from the 1024-aligned base: the two resident tiles
// (D / 64 boxes of 128 x 64 each), the ring (per stage two walked tiles of
// kWalk x D), the dkv kernel's lse and di per stage, the mbarriers; plus
// the slack that aligns the base
template <int D, bool kDkv>
struct BwdSmem {
  static constexpr int kWalk = kDkv && D == 128 ? 32 : 64;
  static constexpr int kRes = kBwdRows * D * 2;  // one resident tile
  static constexpr int kTile = kWalk * D * 2;    // one walked tile
  static constexpr int kRing = 2 * kRes;         // stage s at kRing + 2 s kTile
  static constexpr int kVec = kRing + kBwdStages * 2 * kTile;
  static constexpr int kBars = kVec + (kDkv ? kBwdStages * 2 * kWalk * 4 : 0);
  static constexpr int kBytes = kBars + (2 * kBwdStages + 1) * 8 + 1024;
};

// P's (or dS's) A registers for rows [16 kc, 16 kc + 16) of a product over
// them: the f32 accumulator's columns 2 kc and 2 kc + 1 rounded to bf16
template <int R>
__device__ __forceinline__ void frag_acc(uint32_t (&f)[4],
                                         const float (&s)[R], int kc) {
  f[0] = pack_f32(s[8 * kc], s[8 * kc + 1]);
  f[1] = pack_f32(s[8 * kc + 2], s[8 * kc + 3]);
  f[2] = pack_f32(s[8 * kc + 4], s[8 * kc + 5]);
  f[3] = pack_f32(s[8 * kc + 6], s[8 * kc + 7]);
}

// Write rows r0 and r0 + 8 (those < N) of a warpgroup accumulator (D
// columns), times mul, as bf16 into a contiguous (B, N, H, D) tensor;
// `base` points at (b, 0, h, tig * 2).
template <int D>
__device__ void store_rows(__nv_bfloat16* base, const float (&acc)[D / 2],
                           int r0, int N, int H, float mul) {
  const long long sn = (long long)H * D;
  const int r1 = r0 + 8;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    if (r0 < N)
      *reinterpret_cast<uint32_t*>(base + r0 * sn + j * 8) =
          pack_f32(acc[4 * j] * mul, acc[4 * j + 1] * mul);
    if (r1 < N)
      *reinterpret_cast<uint32_t*>(base + r1 * sn + j * 8) =
          pack_f32(acc[4 * j + 2] * mul, acc[4 * j + 3] * mul);
  }
}

// The producer's first lane: the two resident tiles (rows row0..+127 of
// maps a and b) into base, completing on ring.res.
template <int D>
__device__ void load_resident(unsigned char* base, const CUtensorMap* a,
                              const CUtensorMap* b, uint64_t* bar, int row0,
                              int h, int bi) {
  mbar_arrive_expect_tx(bar, 2 * kBwdRows * D * 2);
  for (int x = 0; x < D / 64; ++x) {
    tma_load(base + x * kBwdRows * 128, a, bar, 64 * x, row0, h, bi);
    tma_load(base + kBwdRows * D * 2 + x * kBwdRows * 128, b, bar, 64 * x,
             row0, h, bi);
  }
}

// One ring stage: walked rows row0.. of maps a and b into dst (two tiles
// of W x D), completing on `full` after expecting their bytes.
template <int D, int W>
__device__ void load_walked(unsigned char* dst, const CUtensorMap* a,
                            const CUtensorMap* b, uint64_t* full, int row0,
                            int h, int bi) {
  mbar_arrive_expect_tx(full, 2 * W * D * 2);
  for (int x = 0; x < D / 64; ++x) {
    tma_load(dst + x * W * 128, a, full, 64 * x, row0, h, bi);
    tma_load(dst + W * D * 2 + x * W * 128, b, full, 64 * x, row0, h, bi);
  }
}

template <int D>
__global__ void __launch_bounds__(kBwdThreads, 1) flash_bwd_dkv_bf16(
    const __grid_constant__ CUtensorMap tq,
    const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv,
    const __grid_constant__ CUtensorMap tdo, const float* __restrict__ lse,
    const float* __restrict__ di, __nv_bfloat16* __restrict__ dk,
    __nv_bfloat16* __restrict__ dv, int N, int H, float scale) {
  using L = BwdSmem<D, true>;
  constexpr int W = L::kWalk;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base = smem_raw + (1024 - smem_addr(smem_raw) % 1024) % 1024;
  const Ring<kBwdStages> ring(base + L::kBars, 32);  // the producer's lanes
  const int b = blockIdx.z, h = blockIdx.y, key0 = blockIdx.x * kBwdRows;
  const int n_tiles = (N + W - 1) / W;
  const int lane = threadIdx.x & 31;

  const int wg = warpgroup_index();
  if (wg == 2) {  // the producer warp
    const long long bh = ((long long)b * H + h) * N;
    if (lane == 0) load_resident<D>(base, &tk, &tv, ring.res, key0, h, b);
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % kBwdStages, q0 = it * W;
      mbar_wait(ring.empty + s, ((it / kBwdStages) & 1) ^ 1);
      // the tile's lse in log2 units (+inf past N: P = 0) and di
      float* vec = reinterpret_cast<float*>(base + L::kVec) + s * 2 * W;
      for (int i = lane; i < W; i += 32) {
        const bool in = q0 + i < N;
        vec[i] = in ? lse[bh + q0 + i] * kLog2e : INFINITY;
        vec[W + i] = in ? di[bh + q0 + i] : 0.f;
      }
      if (lane == 0)
        load_walked<D, W>(base + L::kRing + s * 2 * L::kTile, &tq, &tdo,
                          ring.full + s, q0, h, b);
      else
        mbar_arrive(ring.full + s);
    }
    return;
  }

  const int warp = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, tig = lane & 3;
  const float sl2 = scale * kLog2e;
  // this warpgroup's 64 keys of the resident K and V
  const uint32_t ka = smem_addr(base) + wg * 64 * 128;
  const uint32_t va = ka + L::kRes;

  float dka[D / 2], dva[D / 2];
#pragma unroll
  for (int j = 0; j < D / 2; ++j) dka[j] = dva[j] = 0.f;

  // The two warpgroups take turns at the first two products (named
  // barriers 1 and 2): one's elementwise work runs while the other's
  // products do.
  if (wg == 1) named_arrive(1, 256);
  mbar_wait(ring.res, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % kBwdStages;
    mbar_wait(ring.full + s, (it / kBwdStages) & 1);
    const uint32_t qt = smem_addr(base + L::kRing + s * 2 * L::kTile);
    const uint32_t dt = qt + L::kTile;
    const float* ls = reinterpret_cast<const float*>(base + L::kVec) + s * 2 * W;
    const float* ds = ls + W;

    // S^T = K q^T and dP^T = V do^T over the tile's W queries: entry
    // 4 j + i is key row g + 8 (i >> 1) of the warp's 16, query
    // 8 j + 2 tig + (i & 1)
    float st[W / 2], dpt[W / 2];
    named_sync(1 + wg, 256);
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      const uint32_t ra = (kc / 4) * kBwdRows * 128 + (kc % 4) * 32;
      const uint32_t wa = (kc / 4) * W * 128 + (kc % 4) * 32;
      wgmma_ss<W, 0>(st, desc_sw128(ka + ra, 16, 1024),
                     desc_sw128(qt + wa, 16, 1024), kc > 0);
      wgmma_ss<W, 0>(dpt, desc_sw128(va + ra, 16, 1024),
                     desc_sw128(dt + wa, 16, 1024), kc > 0);
    }
    wgmma_commit();
    wgmma_wait();
    fence_regs(st);
    fence_regs(dpt);
    if (wg == 0 || it + 1 < n_tiles) named_arrive(2 - wg, 256);

    // P^T = exp(S^T - lse), dS^T = P^T (dP^T - di), both in f32
#pragma unroll
    for (int j = 0; j < W / 8; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int qi = 8 * j + 2 * tig + c;
        const float lq = ls[qi], dl = ds[qi];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int e = 4 * j + 2 * r + c;
          const float p = fast_exp2(st[e] * sl2 - lq);
          st[e] = p;
          dpt[e] = p * (dpt[e] - dl);
        }
      }

    // dV += P^T do and dK += dS^T q over the tile's queries: B MN-major,
    // 16 query rows (2048 bytes) per product, D = 128 boxes a tile apart
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < W / 16; ++kc) {
      uint32_t pa[4], sa[4];
      frag_acc(pa, st, kc);
      frag_acc(sa, dpt, kc);
      wgmma_rs<D, 1>(dva, pa, desc_sw128(dt + kc * 2048, W * 128, 1024), 1);
      wgmma_rs<D, 1>(dka, sa, desc_sw128(qt + kc * 2048, W * 128, 1024), 1);
    }
    wgmma_commit();
    wgmma_wait();
    fence_regs(dva);
    fence_regs(dka);
    __syncwarp();
    if (lane == 0) mbar_arrive(ring.empty + s);  // this warp read the stage
  }

  const int r0 = key0 + wg * 64 + warp * 16 + g;
  const long long off = ((long long)b * N * H + h) * D + tig * 2;
  store_rows<D>(dk + off, dka, r0, N, H, scale);
  store_rows<D>(dv + off, dva, r0, N, H, 1.f);
}

template <int D>
__global__ void __launch_bounds__(kBwdThreads, 1) flash_bwd_dq_bf16(
    const __grid_constant__ CUtensorMap tq,
    const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv,
    const __grid_constant__ CUtensorMap tdo, const float* __restrict__ lse,
    const float* __restrict__ di, __nv_bfloat16* __restrict__ dq, int N,
    int H, float scale) {
  using L = BwdSmem<D, false>;
  constexpr int W = L::kWalk;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base = smem_raw + (1024 - smem_addr(smem_raw) % 1024) % 1024;
  const Ring<kBwdStages> ring(base + L::kBars, 1);
  const int b = blockIdx.z, h = blockIdx.y, row0 = blockIdx.x * kBwdRows;
  const int n_tiles = (N + W - 1) / W;
  const int lane = threadIdx.x & 31;

  const int wg = warpgroup_index();
  if (wg == 2) {  // the producer warp: its first lane loads
    if (lane == 0) {
      load_resident<D>(base, &tq, &tdo, ring.res, row0, h, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kBwdStages;
        mbar_wait(ring.empty + s, ((it / kBwdStages) & 1) ^ 1);
        load_walked<D, W>(base + L::kRing + s * 2 * L::kTile, &tk, &tv,
                          ring.full + s, it * W, h, b);
      }
    }
    return;
  }

  const int warp = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, tig = lane & 3;
  const float sl2 = scale * kLog2e;
  // this warpgroup's 64 rows of the resident q and do
  const uint32_t qa = smem_addr(base) + wg * 64 * 128;
  const uint32_t da = qa + L::kRes;
  // lse (log2 units) and di of this thread's rows g and g + 8
  const int r0 = row0 + wg * 64 + warp * 16 + g, r1 = r0 + 8;
  const long long bh = ((long long)b * H + h) * N;
  const float l0 = r0 < N ? lse[bh + r0] * kLog2e : INFINITY;
  const float l1 = r1 < N ? lse[bh + r1] * kLog2e : INFINITY;
  const float d0 = r0 < N ? di[bh + r0] : 0.f;
  const float d1 = r1 < N ? di[bh + r1] : 0.f;

  float dqa[D / 2];
#pragma unroll
  for (int j = 0; j < D / 2; ++j) dqa[j] = 0.f;

  // the two warpgroups take turns at S and dP, as in the dkv kernel
  if (wg == 1) named_arrive(1, 256);
  mbar_wait(ring.res, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % kBwdStages, kv0 = it * W;
    mbar_wait(ring.full + s, (it / kBwdStages) & 1);
    const uint32_t kt = smem_addr(base + L::kRing + s * 2 * L::kTile);
    const uint32_t vt = kt + L::kTile;

    // S = q K^T and dP = do V^T over the tile's W keys: entry 4 j + i is
    // row g + 8 (i >> 1), key kv0 + 8 j + 2 tig + (i & 1)
    float sc[W / 2], dp[W / 2];
    named_sync(1 + wg, 256);
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      const uint32_t ra = (kc / 4) * kBwdRows * 128 + (kc % 4) * 32;
      const uint32_t wa = (kc / 4) * W * 128 + (kc % 4) * 32;
      wgmma_ss<W, 0>(sc, desc_sw128(qa + ra, 16, 1024),
                     desc_sw128(kt + wa, 16, 1024), kc > 0);
      wgmma_ss<W, 0>(dp, desc_sw128(da + ra, 16, 1024),
                     desc_sw128(vt + wa, 16, 1024), kc > 0);
    }
    wgmma_commit();
    wgmma_wait();
    fence_regs(sc);
    fence_regs(dp);
    if (wg == 0 || it + 1 < n_tiles) named_arrive(2 - wg, 256);

    // dS = P (dP - di) into sc; keys past N have P = 0
#pragma unroll
    for (int j = 0; j < W / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = kv0 + 8 * j + 2 * tig + (i & 1);
        const int e = 4 * j + i;
        const float p =
            key < N ? fast_exp2(sc[e] * sl2 - (i < 2 ? l0 : l1)) : 0.f;
        sc[e] = p * (dp[e] - (i < 2 ? d0 : d1));
      }

    // dQ += dS K over the tile's keys: K MN-major, 16 key rows per product
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < W / 16; ++kc) {
      uint32_t sa[4];
      frag_acc(sa, sc, kc);
      wgmma_rs<D, 1>(dqa, sa, desc_sw128(kt + kc * 2048, W * 128, 1024), 1);
    }
    wgmma_commit();
    wgmma_wait();
    fence_regs(dqa);
    __syncwarp();
    if (lane == 0) mbar_arrive(ring.empty + s);  // this warp read the stage
  }

  store_rows<D>(dq + ((long long)b * N * H + h) * D + tig * 2, dqa, r0, N, H,
                scale);
}

// ---------------------------------------------------------------------------
// float32: FMA loops, two threads per row
// ---------------------------------------------------------------------------

// thread (r, half) of a CTA: row r of the CTA's tile; of the walked tile,
// rows 2 jj + half for the products over D and columns 2 dd + half of the
// accumulators.  Operands padded by one word (LDQ): the 16 rows a warp
// reads at one column fall in different banks.

template <int D>
__global__ void __launch_bounds__(kFaThreads) flash_bwd_dkv_f32(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ di,
    float* __restrict__ dk, float* __restrict__ dv, int N, int H,
    long long q_sb, long long q_sn, long long q_sh, long long k_sb,
    long long k_sn, long long k_sh, long long v_sb, long long v_sn,
    long long v_sh, long long do_sb, long long do_sn, long long do_sh,
    float scale) {
  constexpr int LDQ = D + 1, LDP = kFaRows + 1, kHalf = kFaRows / 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ks = reinterpret_cast<float*>(smem_raw);
  float* vs = ks + kFaKeys * LDQ;
  float* qs = vs + kFaKeys * LDQ;
  float* dos = qs + kFaRows * LDQ;
  float* ps = dos + kFaRows * LDQ;
  float* dss = ps + kFaKeys * LDP;
  float* lses = dss + kFaKeys * LDP;
  float* dis = lses + kFaRows;

  const int b = blockIdx.z, h = blockIdx.y, key0 = blockIdx.x * kFaKeys;
  const int r = threadIdx.x >> 1, half = threadIdx.x & 1;
  const float sl2 = scale * kLog2e;
  const float* qb = q + b * q_sb + h * q_sh;
  const float* dob = dout + b * do_sb + h * do_sh;
  const float* lb = lse + ((long long)b * H + h) * N;
  const float* db = di + ((long long)b * H + h) * N;

  stage_rows<float, D, false>(ks, LDQ, k + b * k_sb + h * k_sh, k_sn, key0,
                              N);
  stage_rows<float, D, false>(vs, LDQ, v + b * v_sb + h * v_sh, v_sn, key0,
                              N);

  float dka[D / 2], dva[D / 2];
#pragma unroll
  for (int dd = 0; dd < D / 2; ++dd) dka[dd] = dva[dd] = 0.f;

  for (int q0 = 0; q0 < N; q0 += kFaRows) {
    __syncthreads();
    stage_rows<float, D, false>(qs, LDQ, qb, q_sn, q0, N);
    stage_rows<float, D, false>(dos, LDQ, dob, do_sn, q0, N);
    stage_vec(lses, lb, q0, N, kLog2e, INFINITY);
    stage_vec(dis, db, q0, N, 1.f, 0.f);
    __syncthreads();

    const float* kr = ks + (size_t)r * LDQ;
    const float* vr = vs + (size_t)r * LDQ;
    float s[kHalf];
#pragma unroll
    for (int jj = 0; jj < kHalf; ++jj) s[jj] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float kv = kr[d];
#pragma unroll
      for (int jj = 0; jj < kHalf; ++jj)
        s[jj] += kv * qs[(size_t)(2 * jj + half) * LDQ + d];
    }
#pragma unroll
    for (int jj = 0; jj < kHalf; ++jj) {
      const int j = 2 * jj + half;
      s[jj] = exp2f(s[jj] * sl2 - lses[j]);
      ps[(size_t)r * LDP + j] = s[jj];
    }
    float dp[kHalf];
#pragma unroll
    for (int jj = 0; jj < kHalf; ++jj) dp[jj] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float vv = vr[d];
#pragma unroll
      for (int jj = 0; jj < kHalf; ++jj)
        dp[jj] += vv * dos[(size_t)(2 * jj + half) * LDQ + d];
    }
#pragma unroll
    for (int jj = 0; jj < kHalf; ++jj) {
      const int j = 2 * jj + half;
      dss[(size_t)r * LDP + j] = s[jj] * (dp[jj] - dis[j]);
    }
    __syncthreads();  // the row's other half of P and dS is written

    const float* pr = ps + (size_t)r * LDP;
    const float* sr = dss + (size_t)r * LDP;
    for (int j = 0; j < kFaRows; ++j) {
      const float p = pr[j], ds = sr[j];
      const float* dor = dos + (size_t)j * LDQ + half;
      const float* qr = qs + (size_t)j * LDQ + half;
#pragma unroll
      for (int dd = 0; dd < D / 2; ++dd) {
        dva[dd] += p * dor[2 * dd];
        dka[dd] += ds * qr[2 * dd];
      }
    }
  }

  if (key0 + r < N) {
    const long long off = (((long long)b * N + key0 + r) * H + h) * D + half;
#pragma unroll
    for (int dd = 0; dd < D / 2; ++dd) {
      dk[off + 2 * dd] = dka[dd] * scale;
      dv[off + 2 * dd] = dva[dd];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kFaThreads) flash_bwd_dq_f32(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ di,
    float* __restrict__ dq, int N, int H, long long q_sb, long long q_sn,
    long long q_sh, long long k_sb, long long k_sn, long long k_sh,
    long long v_sb, long long v_sn, long long v_sh, long long do_sb,
    long long do_sn, long long do_sh, float scale) {
  constexpr int LDQ = D + 1, LDP = kFaKeys + 1, kHalf = kFaKeys / 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);
  float* dos = qs + kFaRows * LDQ;
  float* ks = dos + kFaRows * LDQ;
  float* vs = ks + kFaKeys * LDQ;
  float* dss = vs + kFaKeys * LDQ;

  const int b = blockIdx.z, h = blockIdx.y, row0 = blockIdx.x * kFaRows;
  const int r = threadIdx.x >> 1, half = threadIdx.x & 1;
  const float sl2 = scale * kLog2e;
  const float* kb = k + b * k_sb + h * k_sh;
  const float* vb = v + b * v_sb + h * v_sh;

  stage_rows<float, D, false>(qs, LDQ, q + b * q_sb + h * q_sh, q_sn, row0,
                              N);
  stage_rows<float, D, false>(dos, LDQ, dout + b * do_sb + h * do_sh, do_sn,
                              row0, N);
  const long long bh = ((long long)b * H + h) * N;
  const bool live = row0 + r < N;
  const float lr = live ? lse[bh + row0 + r] * kLog2e : INFINITY;
  const float dr = live ? di[bh + row0 + r] : 0.f;

  float dqa[D / 2];
#pragma unroll
  for (int dd = 0; dd < D / 2; ++dd) dqa[dd] = 0.f;

  for (int kv0 = 0; kv0 < N; kv0 += kFaKeys) {
    __syncthreads();
    stage_rows<float, D, false>(ks, LDQ, kb, k_sn, kv0, N);
    stage_rows<float, D, false>(vs, LDQ, vb, v_sn, kv0, N);
    __syncthreads();

    const float* qr = qs + (size_t)r * LDQ;
    const float* dor = dos + (size_t)r * LDQ;
    float s[kHalf];
#pragma unroll
    for (int jj = 0; jj < kHalf; ++jj) s[jj] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float qv = qr[d];
#pragma unroll
      for (int jj = 0; jj < kHalf; ++jj)
        s[jj] += qv * ks[(size_t)(2 * jj + half) * LDQ + d];
    }
#pragma unroll
    for (int jj = 0; jj < kHalf; ++jj)
      s[jj] = kv0 + 2 * jj + half < N ? exp2f(s[jj] * sl2 - lr) : 0.f;
    float dp[kHalf];
#pragma unroll
    for (int jj = 0; jj < kHalf; ++jj) dp[jj] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float dov = dor[d];
#pragma unroll
      for (int jj = 0; jj < kHalf; ++jj)
        dp[jj] += dov * vs[(size_t)(2 * jj + half) * LDQ + d];
    }
#pragma unroll
    for (int jj = 0; jj < kHalf; ++jj)
      dss[(size_t)r * LDP + 2 * jj + half] = s[jj] * (dp[jj] - dr);
    __syncthreads();  // the row's other half of dS is written

    const float* sr = dss + (size_t)r * LDP;
    for (int j = 0; j < kFaKeys; ++j) {
      const float ds = sr[j];
      const float* kc = ks + (size_t)j * LDQ + half;
#pragma unroll
      for (int dd = 0; dd < D / 2; ++dd) dqa[dd] += ds * kc[2 * dd];
    }
  }

  if (live) {
    float* out = dq + (((long long)b * N + row0 + r) * H + h) * D + half;
#pragma unroll
    for (int dd = 0; dd < D / 2; ++dd) out[2 * dd] = dqa[dd] * scale;
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

size_t f32_smem_bytes(int D, bool dkv) {
  return ((size_t)4 * kFaRows * (D + 1) +
          (size_t)(dkv ? 2 : 1) * kFaRows * (kFaRows + 1) +
          (dkv ? 2 * kFaRows : 0)) * sizeof(float);
}

struct Strides {
  long long v[12];  // q, k, v, do: (sb, sn, sh) each
};

// the tensor maps of q, k, v and do, with boxes of `rows_qdo` rows for q
// and do and `rows_kv` for k and v
template <int D>
int bf16_maps(CUtensorMap (&m)[4], const void* q, const void* k,
              const void* v, const void* dout, int B, int N, int H,
              const Strides& st, int rows_qdo, int rows_kv) {
  const long long* s = st.v;
  int err;
  if ((err = bnhd_map(&m[0], q, B, N, H, D, s[0], s[1], s[2], rows_qdo)) ||
      (err = bnhd_map(&m[1], k, B, N, H, D, s[3], s[4], s[5], rows_kv)) ||
      (err = bnhd_map(&m[2], v, B, N, H, D, s[6], s[7], s[8], rows_kv)) ||
      (err = bnhd_map(&m[3], dout, B, N, H, D, s[9], s[10], s[11],
                      rows_qdo)))
    return err;
  return 0;
}

template <typename K>
int prepare(K kernel, size_t smem) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* di, void* dk, void* dv, int B,
               int N, int H, const Strides& st, float scale, int is_bf16,
               cudaStream_t stream) {
  const long long* s = st.v;
  int err;
  if (is_bf16) {
    using L = BwdSmem<D, true>;
    CUtensorMap m[4];
    if ((err = bf16_maps<D>(m, q, k, v, dout, B, N, H, st, L::kWalk,
                            kBwdRows)))
      return err;
    static const int attr = prepare(flash_bwd_dkv_bf16<D>, L::kBytes);
    if (attr != 0) return attr;
    const dim3 grid((N + kBwdRows - 1) / kBwdRows, H, B);
    flash_bwd_dkv_bf16<D><<<grid, kBwdThreads, L::kBytes, stream>>>(
        m[0], m[1], m[2], m[3], lse, di, (__nv_bfloat16*)dk,
        (__nv_bfloat16*)dv, N, H, scale);
  } else {
    const size_t smem = f32_smem_bytes(D, true);
    if ((err = prepare(flash_bwd_dkv_f32<D>, smem)) != 0) return err;
    const dim3 grid((N + kFaKeys - 1) / kFaKeys, H, B);
    flash_bwd_dkv_f32<D><<<grid, kFaThreads, smem, stream>>>(
        (const float*)q, (const float*)k, (const float*)v,
        (const float*)dout, lse, di, (float*)dk, (float*)dv, N, H, s[0],
        s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8], s[9], s[10], s[11],
        scale);
  }
  return (int)cudaGetLastError();
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* di, void* dq, int B, int N,
              int H, const Strides& st, float scale, int is_bf16,
              cudaStream_t stream) {
  const long long* s = st.v;
  int err;
  if (is_bf16) {
    using L = BwdSmem<D, false>;
    CUtensorMap m[4];
    if ((err = bf16_maps<D>(m, q, k, v, dout, B, N, H, st, kBwdRows,
                            L::kWalk)))
      return err;
    static const int attr = prepare(flash_bwd_dq_bf16<D>, L::kBytes);
    if (attr != 0) return attr;
    const dim3 grid((N + kBwdRows - 1) / kBwdRows, H, B);
    flash_bwd_dq_bf16<D><<<grid, kBwdThreads, L::kBytes, stream>>>(
        m[0], m[1], m[2], m[3], lse, di, (__nv_bfloat16*)dq, N, H, scale);
  } else {
    const size_t smem = f32_smem_bytes(D, false);
    if ((err = prepare(flash_bwd_dq_f32<D>, smem)) != 0) return err;
    const dim3 grid((N + kFaRows - 1) / kFaRows, H, B);
    flash_bwd_dq_f32<D><<<grid, kFaThreads, smem, stream>>>(
        (const float*)q, (const float*)k, (const float*)v,
        (const float*)dout, lse, di, (float*)dq, N, H, s[0], s[1], s[2],
        s[3], s[4], s[5], s[6], s[7], s[8], s[9], s[10], s[11], scale);
  }
  return (int)cudaGetLastError();
}

bool bad_shape(int B, int N, int H) {
  return B <= 0 || N <= 0 || H <= 0 || B > 65535 || H > 65535;
}

}  // namespace

extern "C" {

// q, k, v, do: (B, N, H, D) of one dtype (bf16 when is_bf16, else f32),
// element (b, n, h, d) of q at q + b*q_sb + n*q_sn + h*q_sh + d (strides in
// elements, each a multiple of 16 bytes, as the base pointers are); lse
// (the forward's, natural log) and di = rowsum(o * do): contiguous f32
// (B, H, N); dk, dv (flash_attn_bwd_dkv) and dq (flash_attn_bwd_dq):
// contiguous (B, N, H, D).  D is 64 or 128.  Each returns a cudaError_t.
int flash_attn_bwd_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse, const float* di,
                       void* dk, void* dv, int B, int N, int H, int D,
                       long long q_sb, long long q_sn, long long q_sh,
                       long long k_sb, long long k_sn, long long k_sh,
                       long long v_sb, long long v_sn, long long v_sh,
                       long long do_sb, long long do_sn, long long do_sh,
                       float scale, int is_bf16, void* stream) {
  if (bad_shape(B, N, H)) return (int)cudaErrorInvalidValue;
  const Strides st = {{q_sb, q_sn, q_sh, k_sb, k_sn, k_sh, v_sb, v_sn, v_sh,
                       do_sb, do_sn, do_sh}};
  cudaStream_t s = (cudaStream_t)stream;
  if (D == 64)
    return launch_dkv<64>(q, k, v, dout, lse, di, dk, dv, B, N, H, st, scale,
                          is_bf16, s);
  if (D == 128)
    return launch_dkv<128>(q, k, v, dout, lse, di, dk, dv, B, N, H, st,
                           scale, is_bf16, s);
  return (int)cudaErrorInvalidValue;
}

int flash_attn_bwd_dq(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* di,
                      void* dq, int B, int N, int H, int D, long long q_sb,
                      long long q_sn, long long q_sh, long long k_sb,
                      long long k_sn, long long k_sh, long long v_sb,
                      long long v_sn, long long v_sh, long long do_sb,
                      long long do_sn, long long do_sh, float scale,
                      int is_bf16, void* stream) {
  if (bad_shape(B, N, H)) return (int)cudaErrorInvalidValue;
  const Strides st = {{q_sb, q_sn, q_sh, k_sb, k_sn, k_sh, v_sb, v_sn, v_sh,
                       do_sb, do_sn, do_sh}};
  cudaStream_t s = (cudaStream_t)stream;
  if (D == 64)
    return launch_dq<64>(q, k, v, dout, lse, di, dq, B, N, H, st, scale,
                         is_bf16, s);
  if (D == 128)
    return launch_dq<128>(q, k, v, dout, lse, di, dq, B, N, H, st, scale,
                          is_bf16, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
