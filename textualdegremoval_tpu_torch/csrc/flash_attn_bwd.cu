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
// dk, dv out: 84 MB) take 25 us at 3.35 TB/s.
//
// Design (bf16): CTAs of 4 warps; each warp owns 16 rows of the CTA's
// 64-row tile, the other operand is walked in staged tiles of 64 rows.
// Every product runs on mma.sync.m16n8k16 (bf16 in, f32 sums), and the f32
// accumulator of two n-tiles of one product is the A fragment of the next,
// so P and dS never leave registers.  P is formed in f32 and rounded to
// bf16 only as a product operand (as the plain version rounds the
// normalised probabilities before P v).
// * flash_bwd_dkv_bf16: one CTA per (64-key tile, head, batch), K and V
//   staged once.  Per query tile: S^T = K q^T and dP^T = V do^T, P^T and
//   dS^T elementwise, dV += P^T do and dK += dS^T q.
// * flash_bwd_dq_bf16: one CTA per (64-query tile, head, batch), q and do
//   staged once, each row's lse and di in registers.  Per key tile: S and
//   dP, then dQ += dS K.
// At D = 128 the warp's two 16 x D f32 accumulators take 128 registers, so
// the query (key) tile is taken in two halves of 32: the S and dP
// accumulators of one half take 32 registers, not 64.  The A fragments of
// the staged operand are read from shared memory at each use.
// Queries past N get lse = +inf (P = 0) and zero do, keys past N P = 0;
// rows past N are not written.  float32 keeps the same CTAs in FMA loops:
// two threads per row, P and dS through shared memory.
//
// q, k, v and do are read in place with per-tensor strides, element
// (b, n, h, d) at b*sb + n*sn + h*sh + d; lse and di are contiguous f32
// (B, H, N); dq, dk and dv are written contiguous (B, N, H, D).
//
// Later work, not here: wgmma, TMA loads, a pipelined ring, one kernel that
// writes dq through a reduction instead of recomputing S and dP.

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

// the A fragment (16 rows of one warp, 16 columns from kc * 16) of a
// row-major bf16 tile; `a` points at row g, column tig * 2 of the warp's rows
__device__ __forceinline__ void frag_a(uint32_t (&f)[4],
                                       const __nv_bfloat16* a, int ld,
                                       int kc) {
  f[0] = ld_pair(a + kc * 16);
  f[1] = ld_pair(a + 8 * ld + kc * 16);
  f[2] = ld_pair(a + kc * 16 + 8);
  f[3] = ld_pair(a + 8 * ld + kc * 16 + 8);
}

// the A fragment for keys (or queries) [16 kc, 16 kc + 16) of a product
// over them, from the f32 accumulators of n-tiles 2 kc and 2 kc + 1
template <int NT>
__device__ __forceinline__ void frag_acc(uint32_t (&f)[4],
                                         const float (&s)[NT][4], int kc) {
  f[0] = pack_f32(s[2 * kc][0], s[2 * kc][1]);
  f[1] = pack_f32(s[2 * kc][2], s[2 * kc][3]);
  f[2] = pack_f32(s[2 * kc + 1][0], s[2 * kc + 1][1]);
  f[3] = pack_f32(s[2 * kc + 1][2], s[2 * kc + 1][3]);
}

// acc[j] += a . B for the D/8 n-tiles of a row-major [16][D] bf16 operand
// B (rows = the product's K dimension); `b` points at row tig * 2,
// column g
template <int D>
__device__ __forceinline__ void mma_rows(float (&acc)[D / 8][4],
                                         const uint32_t (&a)[4],
                                         const __nv_bfloat16* b, int ld) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const __nv_bfloat16* c = b + j * 8;
    const uint32_t bf[2] = {pack_pair(c, c + ld),
                            pack_pair(c + 8 * ld, c + 9 * ld)};
    mma_16816(acc[j], a, bf);
  }
}

// Write rows r0 and r0 + 8 (those < N) of a warp's [16][D] f32
// accumulator, times mul, as bf16 into a contiguous (B, N, H, D) tensor;
// `base` points at (b, 0, h, tig * 2).
template <int D>
__device__ void store_rows(__nv_bfloat16* base, const float (&acc)[D / 8][4],
                           int r0, int N, int H, float mul) {
  const long long sn = (long long)H * D;
  const int r1 = r0 + 8;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    if (r0 < N)
      *reinterpret_cast<uint32_t*>(base + r0 * sn + j * 8) =
          pack_f32(acc[j][0] * mul, acc[j][1] * mul);
    if (r1 < N)
      *reinterpret_cast<uint32_t*>(base + r1 * sn + j * 8) =
          pack_f32(acc[j][2] * mul, acc[j][3] * mul);
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor-core products
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kFaThreads) flash_bwd_dkv_bf16(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v,
    const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ di, __nv_bfloat16* __restrict__ dk,
    __nv_bfloat16* __restrict__ dv, int N, int H, long long q_sb,
    long long q_sn, long long q_sh, long long k_sb, long long k_sn,
    long long k_sh, long long v_sb, long long v_sn, long long v_sh,
    long long do_sb, long long do_sn, long long do_sh, float scale) {
  constexpr int LD = D + 8;
  constexpr int kSub = D == 64 ? 64 : 32;  // walked rows per product
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* vs = ks + kFaKeys * LD;
  __nv_bfloat16* qs = vs + kFaKeys * LD;
  __nv_bfloat16* dos = qs + kFaRows * LD;
  float* lses = reinterpret_cast<float*>(dos + kFaRows * LD);
  float* dis = lses + kFaRows;

  const int b = blockIdx.z, h = blockIdx.y, key0 = blockIdx.x * kFaKeys;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const float sl2 = scale * kLog2e;
  const __nv_bfloat16* qb = q + b * q_sb + h * q_sh;
  const __nv_bfloat16* dob = dout + b * do_sb + h * do_sh;
  const float* lb = lse + ((long long)b * H + h) * N;
  const float* db = di + ((long long)b * H + h) * N;

  stage_rows<__nv_bfloat16, D, true>(ks, LD, k + b * k_sb + h * k_sh, k_sn,
                                     key0, N);
  stage_rows<__nv_bfloat16, D, true>(vs, LD, v + b * v_sb + h * v_sh, v_sn,
                                     key0, N);
  // this warp's 16 keys as the A operand of S^T and dP^T
  const __nv_bfloat16* kw = ks + (size_t)(warp * 16 + g) * LD + tig * 2;
  const __nv_bfloat16* vw = vs + (size_t)(warp * 16 + g) * LD + tig * 2;

  float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) dka[j][i] = dva[j][i] = 0.f;

  for (int q0 = 0; q0 < N; q0 += kFaRows) {
    __syncthreads();  // the previous query tile is no longer read
    stage_rows<__nv_bfloat16, D, true>(qs, LD, qb, q_sn, q0, N);
    stage_rows<__nv_bfloat16, D, true>(dos, LD, dob, do_sn, q0, N);
    stage_vec(lses, lb, q0, N, kLog2e, INFINITY);
    stage_vec(dis, db, q0, N, 1.f, 0.f);
    __syncthreads();

    for (int c0 = 0; c0 < kFaRows; c0 += kSub) {
      // S^T = K q^T and dP^T = V do^T over queries [c0, c0 + kSub): element
      // i of n-tile nt is key row g (i < 2) or g + 8, query
      // c0 + nt * 8 + tig * 2 + (i & 1)
      float st[kSub / 8][4], dpt[kSub / 8][4];
#pragma unroll
      for (int nt = 0; nt < kSub / 8; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) st[nt][i] = dpt[nt][i] = 0.f;
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc) {
        uint32_t ka[4], va[4];
        frag_a(ka, kw, LD, kc);
        frag_a(va, vw, LD, kc);
#pragma unroll
        for (int nt = 0; nt < kSub / 8; ++nt) {
          const size_t row =
              (size_t)(c0 + nt * 8 + g) * LD + kc * 16 + tig * 2;
          const uint32_t qf[2] = {ld_pair(qs + row), ld_pair(qs + row + 8)};
          const uint32_t df[2] = {ld_pair(dos + row), ld_pair(dos + row + 8)};
          mma_16816(st[nt], ka, qf);
          mma_16816(dpt[nt], va, df);
        }
      }
      // P^T = exp(S^T - lse), dS^T = P^T (dP^T - di), both in f32
#pragma unroll
      for (int nt = 0; nt < kSub / 8; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int qi = c0 + nt * 8 + tig * 2 + (i & 1);
          const float p = exp2f(st[nt][i] * sl2 - lses[qi]);
          st[nt][i] = p;
          dpt[nt][i] = p * (dpt[nt][i] - dis[qi]);
        }
      // dV += P^T do and dK += dS^T q over these queries
#pragma unroll
      for (int kc = 0; kc < kSub / 16; ++kc) {
        uint32_t pa[4], sa[4];
        frag_acc(pa, st, kc);
        frag_acc(sa, dpt, kc);
        const size_t row = (size_t)(c0 + kc * 16 + tig * 2) * LD + g;
        mma_rows<D>(dva, pa, dos + row, LD);
        mma_rows<D>(dka, sa, qs + row, LD);
      }
    }
  }

  const int r0 = key0 + warp * 16 + g;
  const long long off = ((long long)b * N * H + h) * D + tig * 2;
  store_rows<D>(dk + off, dka, r0, N, H, scale);
  store_rows<D>(dv + off, dva, r0, N, H, 1.f);
}

template <int D>
__global__ void __launch_bounds__(kFaThreads) flash_bwd_dq_bf16(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v,
    const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ di, __nv_bfloat16* __restrict__ dq, int N,
    int H, long long q_sb, long long q_sn, long long q_sh, long long k_sb,
    long long k_sn, long long k_sh, long long v_sb, long long v_sn,
    long long v_sh, long long do_sb, long long do_sn, long long do_sh,
    float scale) {
  constexpr int LD = D + 8;
  constexpr int kSub = D == 64 ? 64 : 32;  // walked rows per product
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* dos = qs + kFaRows * LD;
  __nv_bfloat16* ks = dos + kFaRows * LD;
  __nv_bfloat16* vs = ks + kFaKeys * LD;

  const int b = blockIdx.z, h = blockIdx.y, row0 = blockIdx.x * kFaRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const float sl2 = scale * kLog2e;
  const __nv_bfloat16* kb = k + b * k_sb + h * k_sh;
  const __nv_bfloat16* vb = v + b * v_sb + h * v_sh;

  stage_rows<__nv_bfloat16, D, true>(qs, LD, q + b * q_sb + h * q_sh, q_sn,
                                     row0, N);
  stage_rows<__nv_bfloat16, D, true>(dos, LD, dout + b * do_sb + h * do_sh,
                                     do_sn, row0, N);
  const __nv_bfloat16* qw = qs + (size_t)(warp * 16 + g) * LD + tig * 2;
  const __nv_bfloat16* dw = dos + (size_t)(warp * 16 + g) * LD + tig * 2;
  // lse (log2 units) and di of this thread's rows g and g + 8
  const int r0 = row0 + warp * 16 + g, r1 = r0 + 8;
  const long long bh = ((long long)b * H + h) * N;
  const float l0 = r0 < N ? lse[bh + r0] * kLog2e : INFINITY;
  const float l1 = r1 < N ? lse[bh + r1] * kLog2e : INFINITY;
  const float d0 = r0 < N ? di[bh + r0] : 0.f;
  const float d1 = r1 < N ? di[bh + r1] : 0.f;

  float dqa[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) dqa[j][i] = 0.f;

  for (int kv0 = 0; kv0 < N; kv0 += kFaKeys) {
    __syncthreads();  // the previous key tile (or q, do) is read
    stage_rows<__nv_bfloat16, D, true>(ks, LD, kb, k_sn, kv0, N);
    stage_rows<__nv_bfloat16, D, true>(vs, LD, vb, v_sn, kv0, N);
    __syncthreads();

    for (int c0 = 0; c0 < kFaKeys; c0 += kSub) {
      // S = q K^T and dP = do V^T over keys [c0, c0 + kSub): element i of
      // n-tile nt is row g (i < 2) or g + 8, key
      // kv0 + c0 + nt * 8 + tig * 2 + (i & 1)
      float s[kSub / 8][4], dp[kSub / 8][4];
#pragma unroll
      for (int nt = 0; nt < kSub / 8; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[nt][i] = dp[nt][i] = 0.f;
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc) {
        uint32_t qa[4], da[4];
        frag_a(qa, qw, LD, kc);
        frag_a(da, dw, LD, kc);
#pragma unroll
        for (int nt = 0; nt < kSub / 8; ++nt) {
          const size_t row =
              (size_t)(c0 + nt * 8 + g) * LD + kc * 16 + tig * 2;
          const uint32_t kf[2] = {ld_pair(ks + row), ld_pair(ks + row + 8)};
          const uint32_t vf[2] = {ld_pair(vs + row), ld_pair(vs + row + 8)};
          mma_16816(s[nt], qa, kf);
          mma_16816(dp[nt], da, vf);
        }
      }
      // dS = P (dP - di) into s; keys past N have P = 0
#pragma unroll
      for (int nt = 0; nt < kSub / 8; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int key = kv0 + c0 + nt * 8 + tig * 2 + (i & 1);
          const float p =
              key < N ? exp2f(s[nt][i] * sl2 - (i < 2 ? l0 : l1)) : 0.f;
          s[nt][i] = p * (dp[nt][i] - (i < 2 ? d0 : d1));
        }
      // dQ += dS K over these keys
#pragma unroll
      for (int kc = 0; kc < kSub / 16; ++kc) {
        uint32_t sa[4];
        frag_acc(sa, s, kc);
        mma_rows<D>(dqa, sa, ks + (size_t)(c0 + kc * 16 + tig * 2) * LD + g,
                    LD);
      }
    }
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

size_t smem_bytes(int D, bool bf16, bool dkv) {
  if (bf16)
    return (size_t)4 * kFaRows * (D + 8) * sizeof(__nv_bfloat16) +
           (dkv ? 2 * kFaRows * sizeof(float) : 0);
  return ((size_t)4 * kFaRows * (D + 1) +
          (size_t)(dkv ? 2 : 1) * kFaRows * (kFaRows + 1) +
          (dkv ? 2 * kFaRows : 0)) * sizeof(float);
}

struct Strides {
  long long v[12];  // q, k, v, do: (sb, sn, sh) each
};

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
  const size_t smem = smem_bytes(D, is_bf16 != 0, true);
  const dim3 grid((N + kFaKeys - 1) / kFaKeys, H, B);
  const long long* s = st.v;
  int err;
  if (is_bf16) {
    if ((err = prepare(flash_bwd_dkv_bf16<D>, smem)) != 0) return err;
    flash_bwd_dkv_bf16<D><<<grid, kFaThreads, smem, stream>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
        (const __nv_bfloat16*)v, (const __nv_bfloat16*)dout, lse, di,
        (__nv_bfloat16*)dk, (__nv_bfloat16*)dv, N, H, s[0], s[1], s[2], s[3],
        s[4], s[5], s[6], s[7], s[8], s[9], s[10], s[11], scale);
  } else {
    if ((err = prepare(flash_bwd_dkv_f32<D>, smem)) != 0) return err;
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
  const size_t smem = smem_bytes(D, is_bf16 != 0, false);
  const dim3 grid((N + kFaRows - 1) / kFaRows, H, B);
  const long long* s = st.v;
  int err;
  if (is_bf16) {
    if ((err = prepare(flash_bwd_dq_bf16<D>, smem)) != 0) return err;
    flash_bwd_dq_bf16<D><<<grid, kFaThreads, smem, stream>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
        (const __nv_bfloat16*)v, (const __nv_bfloat16*)dout, lse, di,
        (__nv_bfloat16*)dq, N, H, s[0], s[1], s[2], s[3], s[4], s[5], s[6],
        s[7], s[8], s[9], s[10], s[11], scale);
  } else {
    if ((err = prepare(flash_bwd_dq_f32<D>, smem)) != 0) return err;
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
