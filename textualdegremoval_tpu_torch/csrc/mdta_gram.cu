// MDTA attention statistics for Hopper (sm_90a) in bf16, on the gram of
// csrc/wgrad.cu: the per-head softmaxed channel attention of q and k,
//
//   attn[b, h] = softmax_rows(temperature[h] * (q_h^T k_h) / (|q_c| |k_d|))
//
// with the norms taken over all L pixels, rsqrt(max(sum of squares,
// 1e-24)) as in the reference.  Replaces, for bf16 q and k whose widths
// and strides TMA takes (ops/pallas/mdta.py `_takes_gram`), the TPU kernel
// of textualdegremoval_tpu/ops/pallas/mdta.py: `mdta_stats_pallas`
// (`_make_stats_kernel`); every other call runs csrc/mdta.cu.
//
// Two launches, as the TPU kernel's sequential grid becomes parallel CTAs:
// * the gram and the square sums: wgrad.cu's TMA ring into wgmma with its
//   square-sum word (`tblock_wgrad_ssq`), batched over (image, head), both
//   operands MN-major where they lie (q and k are strided chunks of one
//   qkv tensor, pixel stride 3C), split over the pixel axis into one wave
//   of CTAs; each split writes f32 partials of the gram and of q's and k's
//   square sums, taken from the stages the products read, so q and k come
//   from device memory once, as the TPU kernel reads each tile once;
// * mdta_gram_finish_kernel, one CTA per attention row: the partials summed
//   over the splits in a fixed order (groups of consecutive splits, then
//   the groups in order: two calls are bitwise equal), the norms clamped
//   at 1e-24, rsqrt, the temperature and the row softmax, written in f32.
//   The partials are summed here, in no torch launch.
//
// What bounds it on the card: bytes.  q and k (2 L C bf16 per image) read
// once for 2 L C cph + 4 L C operations, far below the tensor cores'
// ratio; the partials (nsplit (cph^2 + 2 cph) f32 per head and image) are a
// few percent of q and k at the model's sizes.  What the design does:
// wgrad.cu keeps four 64-pixel stages in flight per CTA and one wave of
// CTAs on the card, and the square sums ride on the stages the products
// read; the finish reads every partial once per row of its head with the
// splits spread over the CTA's threads.
//
// Widths: cph a multiple of 8 up to 192 (Restormer's 48 and 96, PromptIR's
// 176 / 80 / 40); C a multiple of 8; q and k 16-byte aligned with one
// pixel stride (a multiple of 8 elements) and one image stride.

#include "tblock_common.cuh"

extern "C" int tblock_wgrad_ssq(const void* A, int lda, long long sa1,
                                long long sa2, const void* B, int ldb,
                                long long sb1, long long sb2, void* out,
                                void* ssq_a, void* ssq_b, int P, int M, int N,
                                int nb1, int nb2, int nsplit, void* stream);

namespace {

constexpr int kFinThreads = 512;

// One CTA per row c of one (head, image).  Thread t sums column d = t % lc
// (d < cph: the gram's entry and k's square sum of column d; d == cph: q's
// square sum of row c) over the g = t / lc-th of G groups of consecutive
// splits; the groups' sums are then added in order, and warp 0 takes the
// softmax of the row.
__global__ void __launch_bounds__(kFinThreads) mdta_gram_finish_kernel(
    const float* __restrict__ gram_part, const float* __restrict__ qs_part,
    const float* __restrict__ ks_part, const float* __restrict__ temperature,
    float* __restrict__ attn, int B, int C, int heads, int nsplit) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int cph = C / heads, c = blockIdx.x, hd = blockIdx.y, b = blockIdx.z;
  const int lc = round_up(cph + 1, 32), groups = kFinThreads / lc;
  float* pg = reinterpret_cast<float*>(smem_raw);  // [groups][lc]
  float* pk = pg + groups * lc;                    // [groups][lc]
  const int t = threadIdx.x, d = t % lc, g = t / lc;
  if (g < groups && d <= cph) {
    const int s0 = (int)((long long)nsplit * g / groups);
    const int s1 = (int)((long long)nsplit * (g + 1) / groups);
    // split s's gram entry (c, d), q's square sum of c (d == cph) and k's
    // of d
    const size_t gs = (size_t)B * heads * cph * cph, ss = (size_t)B * C;
    const float* gp = d < cph
        ? gram_part + (((size_t)b * heads + hd) * cph + c) * cph + d
        : qs_part + (size_t)b * C + hd * cph + c;
    const size_t gstride = d < cph ? gs : ss;
    const float* kp = ks_part + (size_t)b * C + hd * cph + (d < cph ? d : 0);
    float sg = 0.f, sk = 0.f;
#pragma unroll 4
    for (int s = s0; s < s1; ++s) {
      sg += gp[s * gstride];
      sk += kp[s * ss];
    }
    pg[g * lc + d] = sg;
    pk[g * lc + d] = sk;
  }
  __syncthreads();
  if (t <= cph) {
    float sg = 0.f, sk = 0.f;
    for (int i = 0; i < groups; ++i) {
      sg += pg[i * lc + t];
      sk += pk[i * lc + t];
    }
    pg[t] = sg;
    pk[t] = 1.f / sqrtf(fmaxf(sk, 1e-24f));  // rk of column t
  }
  __syncthreads();
  if (t >= 32) return;
  const float rq = 1.f / sqrtf(fmaxf(pg[cph], 1e-24f));
  const float temp = temperature[hd];
  float mx = -3.0e38f;
  for (int j = t; j < cph; j += 32) {
    const float a = pg[j] * (rq * pk[j]) * temp;
    pg[j] = a;
    mx = fmaxf(mx, a);
  }
  mx = warp_max(mx);
  float sum = 0.f;
  for (int j = t; j < cph; j += 32) {
    const float e = expf(pg[j] - mx);
    pg[j] = e;
    sum += e;
  }
  sum = warp_sum(sum);
  float* dst = attn + (((size_t)b * heads + hd) * cph + c) * cph;
  for (int j = t; j < cph; j += 32) dst[j] = pg[j] / sum;
}

}  // namespace

extern "C" {

// Floats of the workspace `mdta_stats_gram` takes: the gram's partials
// (nsplit, B, heads, cph, cph), then q's and k's square sums (nsplit, B, C)
// each.
long long mdta_gram_work(int B, int C, int heads, int nsplit) {
  const long long cph = heads > 0 ? C / heads : 0;
  return (long long)nsplit * B * (heads * cph * cph + 2LL * C);
}

// q, k: bf16, pixel l of image b at element b sb + l ld, head h's channels
// at + h cph, contiguous (the same strides for both); temperature: (heads,)
// f32; work: `mdta_gram_work` floats; attn: (B, heads, cph, cph) f32.
// nsplit splits of the pixel axis.  Two launches.  Returns a cudaError_t.
int mdta_stats_gram(const void* q, const void* k, const void* temperature,
                    void* work, void* attn, int B, int L, int C, int heads,
                    long long ld, long long sb, int nsplit, void* stream) {
  if (B <= 0 || L <= 0 || heads <= 0 || C % heads || C % 8 ||
      (C / heads) % 8 || C / heads > kMaxCph || nsplit <= 0)
    return (int)cudaErrorInvalidValue;
  const int cph = C / heads;
  float* gram = (float*)work;
  float* qs = gram + (size_t)nsplit * B * heads * cph * cph;
  float* ks = qs + (size_t)nsplit * B * C;
  int err = tblock_wgrad_ssq(q, (int)ld, sb, cph, k, (int)ld, sb, cph, gram,
                             qs, ks, L, cph, cph, B, heads, nsplit, stream);
  if (err) return err;
  const int lc = round_up(cph + 1, 32);
  const size_t smem = (size_t)2 * 4 * (kFinThreads / lc) * lc;
  mdta_gram_finish_kernel<<<dim3(cph, heads, B), kFinThreads, smem,
                            (cudaStream_t)stream>>>(
      gram, qs, ks, (const float*)temperature, (float*)attn, B, C, heads,
      nsplit);
  return (int)cudaGetLastError();
}

}  // extern "C"
