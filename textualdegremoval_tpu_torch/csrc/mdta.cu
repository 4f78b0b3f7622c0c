// MDTA attention statistics for Hopper (sm_90a): the per-head softmaxed
// channel attention of q and k,
//
//   attn[b, h] = softmax_rows(temperature[h] * (q_h^T k_h) / (|q_c| |k_d|))
//
// with the norms taken over all L pixels, rsqrt(max(sum of squares,
// 1e-24)) as in the reference.  Replaces the TPU kernel of
// textualdegremoval_tpu/ops/pallas/mdta.py: `mdta_stats_pallas`
// (`_make_stats_kernel`), used by `mdta_attention_pallas`, the MDTA core of
// TransformerBlock's module path (`MDTAAttention(use_pallas=True)`).  The
// product attn . v stays outside, a plain batched product, as there.
//
// Two kernels, as the TPU kernel's sequential grid becomes parallel CTAs:
// * mdta_stats_kernel, one CTA per (split, head, image): the CTA walks a
//   fixed, strided list of tl-pixel chunks of L.  For each chunk it loads
//   the head's q and k channels transposed (channel-major, zero past L)
//   into shared memory, adds the cph x cph gram q^T k (one product with
//   K = pixels; mma.sync in bf16) to an f32 accumulator in shared memory,
//   and each channel's square sum to a register of the thread that owns
//   the channel in every chunk.  This is the gram / square-sum part of the
//   whole-block kernel's pass A (`stats_head_tile`, csrc/tblock_fwd.cuh)
//   without LN1 and the qkv conv.  Each CTA writes its own partial sums;
//   no float atomics.
// * mdta_finish_kernel, one warp per attention row: the partials summed
//   over the splits in a fixed order (so two calls are bitwise equal), the
//   norms clamped at 1e-24, rsqrt, the temperature, and the row softmax,
//   written in f32.  This step lives in the TPU kernel's body (its last
//   grid step), so it is CUDA here too.
//
// q and k are read where they lie: strided views (the chunks of one qkv
// tensor have a pixel stride of 3C), pixel l of image b at
// b sb + (l / W) sh + (l % W) sw, channels contiguous.  Any L works; the
// tail chunk is masked.
//
// What bounds it on the card: bytes.  Each q and k element is read once
// (2 L C elements per image) for 2 L C cph + 4 L C operations, far below
// the tensor cores' ratio; the partials (nsplit cph^2 f32 per head and
// image) are small beside q and k at the model's sizes.  What the design
// does: enough CTAs per head to keep every SM loading, loads of adjacent
// channels by adjacent threads, and nothing of the size of q or k
// written back.
//
// Widths: cph up to kMaxCph = 192 channels per head (Restormer's 48 and
// 96, PromptIR's noise blocks 176 / 80 / 40); the f32 gram of the head
// lives in shared memory (147 KB at 192), and the wrapper picks the chunk
// length tl by shared memory.

#include "tblock_common.cuh"

namespace {

// Dynamic shared memory of the statistics kernel: the head's f32 gram and
// q and k of one chunk, transposed.
__host__ __device__ inline size_t stats_smem(int cph, int tl, int eb) {
  return (size_t)4 * cph * cph +
         (size_t)eb * 2 * round_up(cph, kRowPad) * smem_ld(tl);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) mdta_stats_kernel(
    const T* __restrict__ q, const T* __restrict__ k, long long sb,
    long long sh, long long sw, int L, int W, int C, int heads, int tl,
    float* __restrict__ gram_part, float* __restrict__ qs_part,
    float* __restrict__ ks_part) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int cph = C / heads;
  const int split = blockIdx.x, nsplit = gridDim.x;
  const int hd = blockIdx.y, b = blockIdx.z;
  const int ldp = smem_ld(tl);
  float* gacc = reinterpret_cast<float*>(smem_raw);   // [cph][cph] f32
  T* qT = reinterpret_cast<T*>(gacc + cph * cph);     // [cph rows][ldp]
  T* kT = qT + (size_t)round_up(cph, kRowPad) * ldp;  // [cph rows][ldp]

  for (int i = threadIdx.x; i < cph * cph; i += blockDim.x) gacc[i] = 0.f;
  // the square sums of this thread's channels i = threadIdx.x (+ blockDim.x)
  // of [q | k]: 2 cph <= 2 kThreads
  static_assert(kMaxCph <= kThreads, "two square sums per thread");
  float ssq0 = 0.f, ssq1 = 0.f;

  const size_t base = (size_t)b * sb + (size_t)hd * cph;
  const int nchunks = (L + tl - 1) / tl;
  for (int t = split; t < nchunks; t += nsplit) {
    const int l0 = t * tl;
    for (int idx = threadIdx.x; idx < tl * cph; idx += blockDim.x) {
      const int p = idx / cph, n = idx % cph, l = l0 + p;
      T qv = from_f<T>(0.f), kv = from_f<T>(0.f);
      if (l < L) {
        const size_t off =
            base + (size_t)(l / W) * sh + (size_t)(l % W) * sw + n;
        qv = q[off];
        kv = k[off];
      }
      qT[n * ldp + p] = qv;
      kT[n * ldp + p] = kv;
    }
    __syncthreads();
    gemm(qT, ldp, cph, tl, MatB<T>{kT, 1, ldp}, cph,
         [&](int c, int d, float v) { gacc[c * cph + d] += v; });
    for (int i = threadIdx.x, j = 0; i < 2 * cph; i += blockDim.x, ++j) {
      const T* src = (i < cph ? qT : kT) + (i % cph) * ldp;
      float s = 0.f;
      for (int p = 0; p < tl; ++p) {
        const float v = to_f(src[p]);
        s += v * v;
      }
      if (j == 0) ssq0 += s; else ssq1 += s;
    }
    __syncthreads();
  }

  const size_t slot = (size_t)b * nsplit + split;
  float* gp = gram_part + (slot * heads + hd) * cph * cph;
  for (int i = threadIdx.x; i < cph * cph; i += blockDim.x) gp[i] = gacc[i];
  for (int i = threadIdx.x, j = 0; i < 2 * cph; i += blockDim.x, ++j)
    (i < cph ? qs_part : ks_part)[slot * C + hd * cph + i % cph] =
        j == 0 ? ssq0 : ssq1;
}

// One CTA per kRows rows of one (head, image), one warp per row c: the
// partials summed over the splits in order, then attn[b, hd, c, :] =
// softmax(gram[c, :] * (rq[c] rk[:]) * temperature[hd]).
template <int kRows>
__global__ void __launch_bounds__(kRows * 32) mdta_finish_kernel(
    const float* __restrict__ gram_part, const float* __restrict__ qs_part,
    const float* __restrict__ ks_part, const float* __restrict__ temperature,
    float* __restrict__ attn, int C, int heads, int nsplit) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int cph = C / heads, hd = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* rk = reinterpret_cast<float*>(smem_raw);  // [cph]
  float* row = rk + kMaxCph + warp * kMaxCph;      // this warp's [cph]
  static_assert(kRows * 32 <= kThreads, "one warp per row");
  const size_t img = (size_t)b * nsplit;

  for (int d = threadIdx.x; d < cph; d += blockDim.x) {
    float s = 0.f;
    for (int sp = 0; sp < nsplit; ++sp)
      s += ks_part[(img + sp) * C + hd * cph + d];
    rk[d] = 1.f / sqrtf(fmaxf(s, 1e-24f));
  }
  __syncthreads();
  const int c = blockIdx.x * kRows + warp;
  if (c >= cph) return;
  float sq = 0.f;
  for (int sp = 0; sp < nsplit; ++sp)
    sq += qs_part[(img + sp) * C + hd * cph + c];
  const float rq = 1.f / sqrtf(fmaxf(sq, 1e-24f));
  const float temp = temperature[hd];
  float mx = -3.0e38f;
  for (int d = lane; d < cph; d += 32) {
    float g = 0.f;
    for (int sp = 0; sp < nsplit; ++sp)
      g += gram_part[(((img + sp) * heads + hd) * cph + c) * cph + d];
    const float a = g * (rq * rk[d]) * temp;
    row[d] = a;
    mx = fmaxf(mx, a);
  }
  mx = warp_max(mx);
  float sum = 0.f;
  for (int d = lane; d < cph; d += 32) {
    const float e = expf(row[d] - mx);
    row[d] = e;
    sum += e;
  }
  sum = warp_sum(sum);
  float* dst = attn + (((size_t)b * heads + hd) * cph + c) * cph;
  for (int d = lane; d < cph; d += 32) dst[d] = row[d] / sum;
}

template <typename T>
int launch_stats(const void* q, const void* k, void* gram_part,
                 void* qs_part, void* ks_part, int B, int L, int W, int C,
                 int heads, long long sb, long long sh, long long sw, int tl,
                 int nsplit, cudaStream_t stream) {
  const size_t smem = stats_smem(C / heads, tl, sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(
      mdta_stats_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  mdta_stats_kernel<T><<<dim3(nsplit, heads, B), kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, sb, sh, sw, L, W, C, heads, tl,
      (float*)gram_part, (float*)qs_part, (float*)ks_part);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int mdta_max_cph() { return kMaxCph; }

// Dynamic shared memory of the statistics kernel at chunk length tl; the
// wrapper picks tl with it.
long long mdta_stats_smem(int cph, int tl, int elem_bytes) {
  return (long long)stats_smem(cph, tl, elem_bytes);
}

// q, k: (B, L) pixels of C channels, pixel l of image b at element
// b sb + (l / W) sh + (l % W) sw, channels contiguous (the same strides
// for both); gram_part: (B, nsplit, heads, cph, cph) f32; qs_part,
// ks_part: (B, nsplit, C) f32; tl % 16 == 0.  Returns a cudaError_t.
int mdta_stats(const void* q, const void* k, void* gram_part, void* qs_part,
               void* ks_part, int B, int L, int W, int C, int heads,
               long long sb, long long sh, long long sw, int is_bf16, int tl,
               int nsplit, void* stream) {
  if (B <= 0 || L <= 0 || W <= 0 || heads <= 0 || C % heads ||
      C / heads > kMaxCph || tl <= 0 || tl % 16 || nsplit <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return launch_stats<__nv_bfloat16>(q, k, gram_part, qs_part, ks_part, B,
                                       L, W, C, heads, sb, sh, sw, tl,
                                       nsplit, s);
  return launch_stats<float>(q, k, gram_part, qs_part, ks_part, B, L, W, C,
                             heads, sb, sh, sw, tl, nsplit, s);
}

// The partials of `mdta_stats` into attn: (B, heads, cph, cph) f32;
// temperature: (heads,) f32.  Returns a cudaError_t.
int mdta_finish(const void* gram_part, const void* qs_part,
                const void* ks_part, const void* temperature, void* attn,
                int B, int C, int heads, int nsplit, void* stream) {
  if (B <= 0 || heads <= 0 || C % heads || C / heads > kMaxCph ||
      nsplit <= 0)
    return (int)cudaErrorInvalidValue;
  const int cph = C / heads;
  const size_t smem = (size_t)4 * kMaxCph * (kWarps + 1);
  const dim3 grid((cph + kWarps - 1) / kWarps, heads, B);
  cudaStream_t s = (cudaStream_t)stream;
  mdta_finish_kernel<kWarps><<<grid, kThreads, smem, s>>>(
      (const float*)gram_part, (const float*)qs_part, (const float*)ks_part,
      (const float*)temperature, (float*)attn, C, heads, nsplit);
  return (int)cudaGetLastError();
}

}  // extern "C"
