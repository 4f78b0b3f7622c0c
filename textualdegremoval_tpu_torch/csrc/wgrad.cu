// Weight-gradient products of the TransformerBlock backward for Hopper
// (sm_90a): out = A^T B summed over pixels, split over the pixel axis.
//
// The TPU backward kernels (textualdegremoval_tpu/ops/pallas/tblock_bwd.py
// `_make_gdfn_bwd_kernel`, tblock_attn_bwd.py `_make_attn_bwd_stats_kernel`
// and `_make_attn_bwd_apply_kernel`) keep dW_in, dW_out, dWqkv, dWproj and
// dA as accumulators in VMEM for the whole sequential grid.  On the card the
// CTAs run in parallel and one such accumulator is up to 768 x 4096 f32
// (12.6 MB) wide, so a partial per CTA does not fit.  Instead the streaming
// kernels (tblock_bwd.cu, tblock_attn_bwd.cu) write the recomputed operands
// of these products (z, gate and dhid; y, dlin, v, o and do) to scratch,
// and this kernel reduces them: a split-K product whose K is the pixel
// axis.
//
//   out[s][z][m][n] = sum_{p in split s} A_z[p][m] * B_z[p][n]
//
// z runs over (z1, z2) batches with element offsets z1 * sa1 + z2 * sa2
// (images, and heads for the per-head dA).  Each split writes its own
// partial; the wrapper adds the partials in a fixed order with torch.sum,
// so the result is bitwise repeatable (no float atomics).
//
// What bounds it: at the model's widths M, N >= 48 and K = pixels in the
// millions, so it is a large product, bound by arithmetic.  The design is
// a plain tiled one: a 64 x 64 output tile per CTA, 32 pixels of A and B
// staged transposed in shared memory per step, bf16 on mma.sync m16n8k16
// with f32 sums (8 warps, each 16 x 32 outputs), f32 on FMA (each thread
// 4 x 4 outputs).  Two shared-memory stages: each thread loads the next
// step's elements into registers before the current step's products and
// stores them to the other stage after, so the global loads' latency
// overlaps the products (one barrier per step).  wgmma, TMA, ldmatrix and
// deeper pipelines are left for later work.

#include "tblock_common.cuh"

namespace {

constexpr int kBM = 64, kBN = 64, kBK = 32, kLK = kBK + 8;
constexpr int kPer = kBK * kBM / kThreads;  // staged elements per thread
static_assert(kBM == kBN && kPer * kThreads == kBK * kBM, "tile shape");

size_t wgrad_smem_bytes(int eb) {
  return (size_t)eb * 2 * (kBM + kBN) * kLK;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) wgrad_kernel(
    const T* __restrict__ A, int lda, long long sa1, long long sa2,
    const T* __restrict__ B, int ldb, long long sb1, long long sb2,
    float* __restrict__ out, int P, int M, int N, int nb1, int nb2,
    int chunk) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // two stages of [kBM][kLK] A^T (m rows) and [kBN][kLK] B^T (n rows)
  T* As = reinterpret_cast<T*>(smem_raw);
  T* Bs = As + 2 * kBM * kLK;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;
  const int nbatch = nb1 * nb2;
  const int z = blockIdx.z % nbatch, s = blockIdx.z / nbatch;
  const T* a = A + (z / nb2) * sa1 + (z % nb2) * sa2;
  const T* bm = B + (z / nb2) * sb1 + (z % nb2) * sb2;
  const int p_beg = s * chunk;
  const int p_end = p_beg + chunk < P ? p_beg + chunk : P;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  constexpr bool kMma = std::is_same<T, __nv_bfloat16>::value;
  // bf16: warp (wm, wn) owns rows [16 wm, +16) and columns [32 wn, +32) as
  // four m16n8 tiles; f32: thread (ty, tx) owns rows 4 ty.. and columns
  // 4 tx..
  const int wm = warp % 4, wn = warp / 4;
  const int ty = tid / 16, tx = tid % 16;
  float acc[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = 0.f;

  // element i of this thread's share of a step: pixel k0 + kk, column mm
  // (threads on adjacent columns: coalesced reads)
  T ra[kPer], rb[kPer];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int idx = tid + i * kThreads, kk = idx / kBM, mm = idx % kBM;
      const int p = k0 + kk;
      ra[i] = p < p_end && m0 + mm < M ? a[(size_t)p * lda + m0 + mm]
                                       : from_f<T>(0.f);
      rb[i] = p < p_end && n0 + mm < N ? bm[(size_t)p * ldb + n0 + mm]
                                       : from_f<T>(0.f);
    }
  };
  auto stash = [&](int stage) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int idx = tid + i * kThreads, kk = idx / kBM, mm = idx % kBM;
      As[stage * kBM * kLK + mm * kLK + kk] = ra[i];
      Bs[stage * kBN * kLK + mm * kLK + kk] = rb[i];
    }
  };

  if (p_beg < p_end) {
    fetch(p_beg);
    stash(0);
  }
  __syncthreads();
  int stage = 0;
  for (int k0 = p_beg; k0 < p_end; k0 += kBK) {
    const bool more = k0 + kBK < p_end;
    if (more) fetch(k0 + kBK);  // in flight during this step's products
    const T* as = As + stage * kBM * kLK;
    const T* bs = Bs + stage * kBN * kLK;
    if constexpr (kMma) {
#pragma unroll
      for (int kk = 0; kk < kBK; kk += 16) {
        const T* ar = as + (16 * wm + g) * kLK + kk + tig * 2;
        const uint32_t af[4] = {ld_pair(ar), ld_pair(ar + 8 * kLK),
                                ld_pair(ar + 8), ld_pair(ar + 8 * kLK + 8)};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const T* br = bs + (32 * wn + 8 * j + g) * kLK + kk + tig * 2;
          const uint32_t bf[2] = {ld_pair(br), ld_pair(br + 8)};
          float(&d)[4] = *reinterpret_cast<float(*)[4]>(acc + 4 * j);
          mma_16816(d, af, bf);
        }
      }
    } else {
      for (int kk = 0; kk < kBK; ++kk) {
        float av[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          av[i] = to_f(as[(4 * ty + i) * kLK + kk]);
          bv[i] = to_f(bs[(4 * tx + i) * kLK + kk]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[4 * i + j] += av[i] * bv[j];
      }
    }
    // the other stage was last read before the previous barrier
    if (more) stash(stage ^ 1);
    __syncthreads();
    stage ^= 1;
  }

  float* o = out + ((size_t)s * nbatch + z) * M * N;
  auto put = [&](int m, int n, float v) {
    if (m < M && n < N) o[(size_t)m * N + n] = v;
  };
  if constexpr (kMma) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = m0 + 16 * wm + g, c = n0 + 32 * wn + 8 * j + tig * 2;
      put(r, c, acc[4 * j]);
      put(r, c + 1, acc[4 * j + 1]);
      put(r + 8, c, acc[4 * j + 2]);
      put(r + 8, c + 1, acc[4 * j + 3]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        put(m0 + 4 * ty + i, n0 + 4 * tx + j, acc[4 * i + j]);
  }
}

template <typename T>
int launch_wgrad(const void* A, int lda, long long sa1, long long sa2,
                 const void* B, int ldb, long long sb1, long long sb2,
                 void* out, int P, int M, int N, int nb1, int nb2, int nsplit,
                 cudaStream_t stream) {
  const int chunk = round_up((P + nsplit - 1) / nsplit, kBK);
  const size_t smem = wgrad_smem_bytes(sizeof(T));
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM,
                  nb1 * nb2 * nsplit);
  wgrad_kernel<T><<<grid, kThreads, smem, stream>>>(
      (const T*)A, lda, sa1, sa2, (const T*)B, ldb, sb1, sb2, (float*)out, P,
      M, N, nb1, nb2, chunk);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// out: (nsplit, nb1, nb2, M, N) f32 partials of sum_p A[p][m] B[p][n] over
// P pixels, A[p][m] at A + z1 sa1 + z2 sa2 + p lda + m (elements), B
// likewise.  A and B in the same dtype (bf16 when is_bf16, else f32).
// Returns a cudaError_t.
int tblock_wgrad(const void* A, int lda, long long sa1, long long sa2,
                 const void* B, int ldb, long long sb1, long long sb2,
                 void* out, int P, int M, int N, int nb1, int nb2, int nsplit,
                 int is_bf16, void* stream) {
  if (P <= 0 || M <= 0 || N <= 0 || nb1 <= 0 || nb2 <= 0 || nsplit <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return launch_wgrad<__nv_bfloat16>(A, lda, sa1, sa2, B, ldb, sb1, sb2,
                                       out, P, M, N, nb1, nb2, nsplit, s);
  return launch_wgrad<float>(A, lda, sa1, sa2, B, ldb, sb1, sb2, out, P, M, N,
                             nb1, nb2, nsplit, s);
}

}  // extern "C"
