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
// (671 MB each way at that shape); this kernel keeps them on chip.
//
// Design (bf16, flash_bf16_kernel): one CTA of 4 warps per (64-row query
// tile, head, batch); each warp owns 16 query rows, whose q fragments stay
// in registers.  The CTA walks the keys in tiles of 64, staging K and V in
// shared memory; S = q k^T and O += P V run on mma.sync.m16n8k16 (bf16 in,
// f32 sums).  Each row keeps an online softmax in f32: the running max and
// sum (max through the quad of lanes that share the row), the accumulator
// rescaled by exp(m_old - m_new) whenever the max grows, P rounded to bf16
// for the PV product, one division by the row sum at the end.  The S
// accumulator of two n-tiles is exactly the A fragment of the next product,
// so P never leaves registers.  Keys past N are set to -inf before the max
// and their V rows are zero; query rows past N are computed and not
// written.  float32 (flash_f32_kernel) keeps the same tiles and online
// softmax in FMA loops: two threads per query row, P through shared memory.
// No atomics: a repeated call is bitwise equal.
//
// q, k and v are read in place from the (B, N, H*D) projection layout:
// element (b, n, h, d) of each is at b*sb + n*sn + h*sh + d, with strides
// given per tensor.  o is written contiguous (B, N, H, D).
//
// Later work, not here: wgmma, TMA loads, warp specialisation, a pipelined
// K/V ring, a backward kernel.

#include "tblock_common.cuh"

#ifndef TBLOCK_HOST_BUILD
#include <math.h>
#endif

namespace {

constexpr int kFaThreads = 128;  // 4 warps
constexpr int kFaRows = 64;      // query rows per CTA, 16 per warp
constexpr int kFaKeys = 64;      // keys per staged tile
constexpr float kLog2e = 1.4426950408889634f;

// 16 bytes moved as one (a 128-bit load or store on the card)
struct alignas(16) Vec16 {
  uint32_t w[4];
};

__device__ __forceinline__ uint32_t bits16(__nv_bfloat16 v) {
  return *reinterpret_cast<const unsigned short*>(&v);
}

// two bf16 at unrelated addresses as one mma fragment word (lo in bits 0-15)
__device__ __forceinline__ uint32_t pack_pair(const __nv_bfloat16* lo,
                                              const __nv_bfloat16* hi) {
  return bits16(*lo) | (bits16(*hi) << 16);
}

// two f32 rounded to bf16 as one mma fragment word
__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  return bits16(__float2bfloat16(lo)) | (bits16(__float2bfloat16(hi)) << 16);
}

// Stage rows [row0, row0 + 64) of one head (D wide) into dst[64][ldd],
// rows at or past N as zeros.  16-byte loads from global memory; the
// stores are 16-byte too when ldd keeps rows 16-byte aligned (kVecStore).
template <typename T, int D, bool kVecStore>
__device__ void stage_rows(T* dst, int ldd, const T* src, long long sn,
                           int row0, int N) {
  constexpr int kPer = 16 / sizeof(T);
  constexpr int kVecs = D / kPer;
  for (int idx = threadIdx.x; idx < kFaRows * kVecs; idx += kFaThreads) {
    const int r = idx / kVecs, c = (idx % kVecs) * kPer;
    Vec16 val = {{0u, 0u, 0u, 0u}};
    if (row0 + r < N)
      val = *reinterpret_cast<const Vec16*>(src + (row0 + r) * sn + c);
    if constexpr (kVecStore) {
      *reinterpret_cast<Vec16*>(dst + (size_t)r * ldd + c) = val;
    } else {
      const T* e = reinterpret_cast<const T*>(&val);
#pragma unroll
      for (int i = 0; i < kPer; ++i) dst[(size_t)r * ldd + c + i] = e[i];
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor-core products
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kFaThreads) flash_bf16_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
    int N, int H, long long q_sb, long long q_sn, long long q_sh,
    long long k_sb, long long k_sn, long long k_sh, long long v_sb,
    long long v_sn, long long v_sh, float scale_log2) {
  constexpr int LD = D + 8;  // rows of an mma fragment load in other banks
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* vs = ks + kFaKeys * LD;

  const int b = blockIdx.z, h = blockIdx.y, row0 = blockIdx.x * kFaRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const __nv_bfloat16* qb = q + b * q_sb + h * q_sh;
  const __nv_bfloat16* kb = k + b * k_sb + h * k_sh;
  const __nv_bfloat16* vb = v + b * v_sb + h * v_sh;

  // q fragments of this warp's 16 rows, staged through the K buffer
  stage_rows<__nv_bfloat16, D, true>(ks, LD, qb, q_sn, row0, N);
  __syncthreads();
  uint32_t qf[D / 16][4];
  {
    const __nv_bfloat16* a0 = ks + (size_t)(warp * 16 + g) * LD + tig * 2;
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      qf[kc][0] = ld_pair(a0 + kc * 16);
      qf[kc][1] = ld_pair(a0 + 8 * LD + kc * 16);
      qf[kc][2] = ld_pair(a0 + kc * 16 + 8);
      qf[kc][3] = ld_pair(a0 + 8 * LD + kc * 16 + 8);
    }
  }

  // this thread's parts of rows g (index 0) and g + 8 (index 1)
  float m0 = -INFINITY, m1 = -INFINITY;  // running max, log2 units
  float l0 = 0.f, l1 = 0.f;              // running sums, this thread's keys
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] =
      acc[j][3] = 0.f;

  for (int kv0 = 0; kv0 < N; kv0 += kFaKeys) {
    __syncthreads();  // the previous tile (or q) is no longer read
    stage_rows<__nv_bfloat16, D, true>(ks, LD, kb, k_sn, kv0, N);
    stage_rows<__nv_bfloat16, D, true>(vs, LD, vb, v_sn, kv0, N);
    __syncthreads();

    // S = q k^T: 8 n-tiles of 8 keys; S(row, key) of n-tile nt sits at
    // s[nt][0..1] (row g, keys tig*2, +1) and s[nt][2..3] (row g + 8)
    float s[kFaKeys / 8][4];
#pragma unroll
    for (int nt = 0; nt < kFaKeys / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const __nv_bfloat16* kr = ks + (size_t)(nt * 8 + g) * LD + tig * 2;
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc) {
        const uint32_t bf[2] = {ld_pair(kr + kc * 16),
                                ld_pair(kr + kc * 16 + 8)};
        mma_16816(s[nt], qf[kc], bf);
      }
    }

    // scale, mask the keys past N, row max over the tile
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < kFaKeys / 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = kv0 + nt * 8 + tig * 2 + (i & 1);
        s[nt][i] = key < N ? s[nt][i] * scale_log2 : -INFINITY;
        if (i < 2) mx0 = fmaxf(mx0, s[nt][i]);
        else mx1 = fmaxf(mx1, s[nt][i]);
      }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    // key kv0 < N is in every tile, so the new max is finite
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float al0 = exp2f(m0 - mn0), al1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;

    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < kFaKeys / 8; ++nt) {
      s[nt][0] = exp2f(s[nt][0] - mn0);
      s[nt][1] = exp2f(s[nt][1] - mn0);
      s[nt][2] = exp2f(s[nt][2] - mn1);
      s[nt][3] = exp2f(s[nt][3] - mn1);
      rs0 += s[nt][0] + s[nt][1];
      rs1 += s[nt][2] + s[nt][3];
    }
    l0 = l0 * al0 + rs0;
    l1 = l1 * al1 + rs1;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      acc[j][0] *= al0; acc[j][1] *= al0; acc[j][2] *= al1; acc[j][3] *= al1;
    }

    // O += P V: P's A fragment for keys [16 kc, 16 kc + 16) is the S
    // accumulator of n-tiles 2 kc and 2 kc + 1, rounded to bf16; V's B
    // fragment (key rows tig*2, +1, +8, +9 of dim column g) is packed from
    // the row-major tile
#pragma unroll
    for (int kc = 0; kc < kFaKeys / 16; ++kc) {
      const uint32_t pa[4] = {
          pack_f32(s[2 * kc][0], s[2 * kc][1]),
          pack_f32(s[2 * kc][2], s[2 * kc][3]),
          pack_f32(s[2 * kc + 1][0], s[2 * kc + 1][1]),
          pack_f32(s[2 * kc + 1][2], s[2 * kc + 1][3])};
      const __nv_bfloat16* vr = vs + (size_t)(kc * 16 + tig * 2) * LD + g;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const __nv_bfloat16* vc = vr + j * 8;
        const uint32_t bf[2] = {pack_pair(vc, vc + LD),
                                pack_pair(vc + 8 * LD, vc + 9 * LD)};
        mma_16816(acc[j], pa, bf);
      }
    }
  }

  // the row sums over the quad, one division, rows past N not written
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  const int r0 = row0 + warp * 16 + g, r1 = r0 + 8;
  const long long o_sn = (long long)H * D;
  __nv_bfloat16* ob = o + ((long long)b * N * H + h) * D + tig * 2;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    if (r0 < N)
      *reinterpret_cast<uint32_t*>(ob + r0 * o_sn + j * 8) =
          pack_f32(acc[j][0] * inv0, acc[j][1] * inv0);
    if (r1 < N)
      *reinterpret_cast<uint32_t*>(ob + r1 * o_sn + j * 8) =
          pack_f32(acc[j][2] * inv1, acc[j][3] * inv1);
  }
}

// ---------------------------------------------------------------------------
// float32: FMA loops, two threads per query row
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kFaThreads) flash_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ o, int N, int H,
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
  if (row0 + r < N) {
    float* orow = o + (((long long)b * N + row0 + r) * H + h) * D + half;
#pragma unroll
    for (int dd = 0; dd < D / 2; ++dd) orow[2 * dd] = acc[dd] * inv;
  }
}

size_t smem_bytes(int D, bool bf16) {
  if (bf16) return (size_t)2 * kFaKeys * (D + 8) * sizeof(__nv_bfloat16);
  return ((size_t)(kFaRows + kFaKeys) * (D + 1) + (size_t)kFaKeys * D +
          (size_t)kFaRows * (kFaKeys + 1)) * sizeof(float);
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int N, int H, const long long* st, float scale, int is_bf16,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(D, is_bf16 != 0);
  const dim3 grid((N + kFaRows - 1) / kFaRows, H, B);
  const float sl2 = scale * kLog2e;
  if (is_bf16) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    flash_bf16_kernel<D><<<grid, kFaThreads, smem, stream>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
        (const __nv_bfloat16*)v, (__nv_bfloat16*)o, N, H, st[0], st[1], st[2],
        st[3], st[4], st[5], st[6], st[7], st[8], sl2);
  } else {
    cudaError_t err = cudaFuncSetAttribute(
        flash_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    flash_f32_kernel<D><<<grid, kFaThreads, smem, stream>>>(
        (const float*)q, (const float*)k, (const float*)v, (float*)o, N, H,
        st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], sl2);
  }
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
// contiguous (B, N, H, D).  D is 64 or 128.  Returns a cudaError_t.
int flash_attn_fwd(const void* q, const void* k, const void* v, void* o,
                   int B, int N, int H, int D, long long q_sb, long long q_sn,
                   long long q_sh, long long k_sb, long long k_sn,
                   long long k_sh, long long v_sb, long long v_sn,
                   long long v_sh, float scale, int is_bf16, void* stream) {
  if (B <= 0 || N <= 0 || H <= 0 || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  const long long st[9] = {q_sb, q_sn, q_sh, k_sb, k_sn, k_sh,
                           v_sb, v_sn, v_sh};
  cudaStream_t s = (cudaStream_t)stream;
  if (D == 64) return launch<64>(q, k, v, o, B, N, H, st, scale, is_bf16, s);
  if (D == 128)
    return launch<128>(q, k, v, o, B, N, H, st, scale, is_bf16, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
