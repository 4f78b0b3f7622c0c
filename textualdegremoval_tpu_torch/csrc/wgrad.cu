// Weight-gradient products of the TransformerBlock backward, and the
// forward's per-head gram, for Hopper (sm_90a): out = A^T B summed over
// pixels, split over the pixel axis.
//
// The TPU backward kernels (textualdegremoval_tpu/ops/pallas/tblock_bwd.py
// `_make_gdfn_bwd_kernel`, tblock_attn_bwd.py `_make_attn_bwd_stats_kernel`
// and `_make_attn_bwd_apply_kernel`) keep dW_in, dW_out, dWqkv, dWproj and
// dA as accumulators in VMEM for the whole sequential grid, and the
// forward's `_make_stats_kernel` (tblock.py:170) its gram.  On the card the
// CTAs run in parallel and one such accumulator is up to 768 x 4096 f32
// (12.6 MB) wide, so a partial per CTA does not fit.  Instead the passes
// before write the operands of these products (z, gate and dhid; y, dlin,
// v, o and do; q and k) to device memory, and this kernel reduces them: a
// split-K product whose K is the pixel axis.
//
//   out[s][z][m][n] = sum_{p in split s} A_z[p][m] * B_z[p][n]
//
// z runs over (z1, z2) batches with element offsets z1 * sa1 + z2 * sa2
// (images, and heads for the per-head dA and gram).  Each split writes its
// own partial; the wrapper adds the partials in a fixed order with
// torch.sum, so the result is bitwise repeatable (no float atomics).
//
// What bounds it: bytes.  K = pixels is in the millions and M, N are
// 48-4096, so each operand read once is the whole cost: at the block's
// widths the products do 0.7 C operations a byte of operand, 34-270 at
// C = 48-384, below the card's 295 (only the widest dW1, C = 768, reaches
// it).  The bf16 design therefore reads each operand about once at full
// bandwidth, and keeps the tensor cores fed only as far as that needs:
//   - both operands are MN-major (K, the pixel axis, is the row axis of
//     both): TMA loads boxes of 64 channels (128 bytes, the 128-byte
//     swizzle) x 64 pixels, and wgmma reads A and B with their transpose
//     bits set (hopper.cuh);
//   - a CTA owns an output tile of 64 or 128 rows (one consumer warpgroup
//     per 64) by 64-256 columns, so that dW1 at C = 96 (96 x 512) reads z
//     twice and dhid once; the per-head dA and gram (cph = 48-176) take a
//     tile of cph rounded up, batched over (image, head); boxes that lie
//     wholly past M or N are not loaded, and the rows and columns past
//     them are computed on whatever the stage holds and not stored;
//   - one producer warp keeps a ring of 4 stages in flight with full and
//     empty mbarriers (bwd_gemm.cu's skeleton); each CTA walks a
//     contiguous range of 64-pixel steps of its (tile, batch), the ragged
//     end of the pixel axis arriving as TMA zeros; the wrapper picks the
//     number of splits so that the grid fills the card in one wave;
//   - each CTA writes its f32 partial once, as 16-byte runs per lane (lane
//     pairs trade values, as bwd_gemm.cu's epilogue does).
// float32 (the parity path) keeps the plain tiled kernel: a 64 x 64 output
// tile per CTA, 32 pixels of A and B staged transposed in shared memory per
// step over two stages, FMA sums (each thread 4 x 4 outputs).

#include "tma_maps.cuh"
#include "tblock_common.cuh"

namespace {

// ---------------------------------------------------------------------------
// float32: the plain tiled kernel
// ---------------------------------------------------------------------------

constexpr int kBM = 64, kBN = 64, kBK = 32, kLK = kBK + 8;
constexpr int kPer = kBK * kBM / kThreads;  // staged elements per thread
static_assert(kBM == kBN && kPer * kThreads == kBK * kBM, "tile shape");

constexpr size_t kWgradSmemBytes = (size_t)4 * 2 * (kBM + kBN) * kLK;

__global__ void __launch_bounds__(kThreads) wgrad_kernel(
    const float* __restrict__ A, int lda, long long sa1, long long sa2,
    const float* __restrict__ B, int ldb, long long sb1, long long sb2,
    float* __restrict__ out, int P, int M, int N, int nb1, int nb2,
    int chunk) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // two stages of [kBM][kLK] A^T (m rows) and [kBN][kLK] B^T (n rows)
  float* As = reinterpret_cast<float*>(smem_raw);
  float* Bs = As + 2 * kBM * kLK;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;
  const int nbatch = nb1 * nb2;
  const int z = blockIdx.z % nbatch, s = blockIdx.z / nbatch;
  const float* a = A + (z / nb2) * sa1 + (z % nb2) * sa2;
  const float* bm = B + (z / nb2) * sb1 + (z % nb2) * sb2;
  const int p_beg = s * chunk;
  const int p_end = p_beg + chunk < P ? p_beg + chunk : P;

  const int tid = threadIdx.x;
  // thread (ty, tx) owns rows 4 ty.. and columns 4 tx..
  const int ty = tid / 16, tx = tid % 16;
  float acc[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = 0.f;

  // element i of this thread's share of a step: pixel k0 + kk, column mm
  // (threads on adjacent columns: coalesced reads)
  float ra[kPer], rb[kPer];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int idx = tid + i * kThreads, kk = idx / kBM, mm = idx % kBM;
      const int p = k0 + kk;
      ra[i] = p < p_end && m0 + mm < M ? a[(size_t)p * lda + m0 + mm] : 0.f;
      rb[i] = p < p_end && n0 + mm < N ? bm[(size_t)p * ldb + n0 + mm] : 0.f;
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
    const float* as = As + stage * kBM * kLK;
    const float* bs = Bs + stage * kBN * kLK;
    for (int kk = 0; kk < kBK; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        av[i] = as[(4 * ty + i) * kLK + kk];
        bv[i] = bs[(4 * tx + i) * kLK + kk];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[4 * i + j] += av[i] * bv[j];
    }
    // the other stage was last read before the previous barrier
    if (more) stash(stage ^ 1);
    __syncthreads();
    stage ^= 1;
  }

  float* o = out + ((size_t)s * nbatch + z) * M * N;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = m0 + 4 * ty + i, n = n0 + 4 * tx + j;
      if (m < M && n < N) o[(size_t)m * N + n] = acc[4 * i + j];
    }
}

int launch_wgrad_f32(const void* A, int lda, long long sa1, long long sa2,
                     const void* B, int ldb, long long sb1, long long sb2,
                     void* out, int P, int M, int N, int nb1, int nb2,
                     int nsplit, cudaStream_t stream) {
  const int chunk = round_up((P + nsplit - 1) / nsplit, kBK);
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM,
                  nb1 * nb2 * nsplit);
  wgrad_kernel<<<grid, kThreads, kWgradSmemBytes, stream>>>(
      (const float*)A, lda, sa1, sa2, (const float*)B, ldb, sb1, sb2,
      (float*)out, P, M, N, nb1, nb2, chunk);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: TMA ring and wgmma, both operands MN-major
// ---------------------------------------------------------------------------

constexpr int kTcStages = 4;
constexpr int kBox = 64 * 128;  // one box: 64 pixels x 64 bf16 channels

// shared memory, bytes from the 1024-aligned base: per stage kWG boxes of
// A (64 rows of the output each) and BN / 64 boxes of B, then the
// mbarriers; plus the slack that aligns the base.  kPerSm: CTAs an SM
// holds (228 KB of shared memory, 1 KB of it reserved per CTA).
template <int kWG, int BN>
struct TcSmem {
  static constexpr int kA = kWG * kBox;
  static constexpr int kStage = kA + BN / 64 * kBox;
  static constexpr int kBars = kTcStages * kStage;
  static constexpr int kBytes = kBars + 2 * kTcStages * 8 + 1024;
  static constexpr int kThreadsCta = 128 * kWG + 32;
  static constexpr int kPerSm = 233472 / (kBytes + 1024);
};

// the tile of an M x N product: 64 output rows per consumer warpgroup, BN
// columns
int tc_wg(int M) { return M <= 64 ? 1 : 2; }
int tc_bn(int N) {
  return N <= 64 ? 64 : N <= 128 ? 128 : N <= 192 ? 192 : 256;
}

// four f32 of an output row, stored as one 16-byte word
struct alignas(16) F32x4 {
  float v[4];
};

template <int kWG, int BN>
__global__ void __launch_bounds__(TcSmem<kWG, BN>::kThreadsCta,
                                  TcSmem<kWG, BN>::kPerSm)
    wgrad_tc_kernel(const __grid_constant__ CUtensorMap ta,
                    const __grid_constant__ CUtensorMap tb,
                    float* __restrict__ out, int M, int N, int nb2,
                    int nbatch, int steps, int per_split) {
  using L = TcSmem<kWG, BN>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base = smem_raw + (1024 - smem_addr(smem_raw) % 1024) % 1024;
  uint64_t* full = reinterpret_cast<uint64_t*>(base + L::kBars);
  uint64_t* empty = full + kTcStages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kTcStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 4 * kWG);
    }
    mbar_init_fence();
  }
  __syncthreads();
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * 64 * kWG;
  const int z = blockIdx.z % nbatch, split = blockIdx.z / nbatch;
  const int z1 = z / nb2, z2 = z % nb2;
  // this split's 64-pixel steps
  const int k0 = split * per_split;
  const int k1 = k0 + per_split < steps ? k0 + per_split : steps;
  const int nk = k1 > k0 ? k1 - k0 : 0;
  const int lane = threadIdx.x & 31;

  const int wg = warpgroup_index();
  if (wg == kWG) {  // the producer warp: its first lane loads
    if (lane == 0) {
      // the boxes that hold rows of A and columns of B
      const int na = (M - m0 + 63) / 64 < kWG ? (M - m0 + 63) / 64 : kWG;
      const int nb = (N - n0 + 63) / 64 < BN / 64 ? (N - n0 + 63) / 64
                                                  : BN / 64;
      for (int it = 0; it < nk; ++it) {
        const int s = it % kTcStages;
        mbar_wait(empty + s, ((it / kTcStages) & 1) ^ 1);
        unsigned char* st = base + s * L::kStage;
        mbar_arrive_expect_tx(full + s, (na + nb) * kBox);
        const int p = 64 * (k0 + it);
        for (int x = 0; x < na; ++x)
          tma_load(st + x * kBox, &ta, full + s, m0 + 64 * x, z2, p, z1);
        for (int x = 0; x < nb; ++x)
          tma_load(st + L::kA + x * kBox, &tb, full + s, n0 + 64 * x, z2, p,
                   z1);
      }
    }
    return;
  }

  const int warp = (threadIdx.x >> 5) & 3;
  const int gq = lane >> 2, tig = lane & 3;
  float acc[BN / 2];
#pragma unroll
  for (int j = 0; j < BN / 2; ++j) acc[j] = 0.f;
  for (int it = 0; it < nk; ++it) {
    const int s = it % kTcStages;
    mbar_wait(full + s, (it / kTcStages) & 1);
    // this warpgroup's box of A, then B's boxes: rows of 64 channels, one
    // row per pixel; 16 pixels (2048 bytes) a wgmma, B's boxes kBox apart
    const uint32_t at = smem_addr(base + s * L::kStage) + wg * kBox;
    const uint32_t bt = smem_addr(base + s * L::kStage + L::kA);
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < 4; ++kc)
      wgmma_ss<BN, 1, 1>(acc, desc_sw128(at + kc * 2048, kBox, 1024),
                         desc_sw128(bt + kc * 2048, kBox, 1024), 1);
    wgmma_commit();
    wgmma_wait();
    fence_regs(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + s);  // this warp read the stage
  }

  // entry 4 j + 2 h + c: row 16 warp + gq + 8 h, column 8 j + 2 tig + c.
  // Lane pairs trade pairs of 2 j so that each lane stores 4 consecutive
  // columns of a row as one 16-byte run (N % 4 == 0): even lanes keep
  // j = 2 j2 and take their partner's pair of it, odd lanes keep
  // j = 2 j2 + 1.  Rows past M and columns past N are not stored (every
  // lane takes part in the shuffles).
  float* o = out + ((size_t)split * nbatch + z) * M * N;
  const bool odd = tig & 1;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = m0 + wg * 64 + warp * 16 + gq + 8 * h;
#pragma unroll
    for (int j2 = 0; j2 < BN / 16; ++j2) {
      const float a0 = acc[8 * j2 + 2 * h], a1 = acc[8 * j2 + 2 * h + 1];
      const float b0 = acc[8 * j2 + 4 + 2 * h];
      const float b1 = acc[8 * j2 + 4 + 2 * h + 1];
      const float g0 = __shfl_xor_sync(0xffffffffu, odd ? a0 : b0, 1);
      const float g1 = __shfl_xor_sync(0xffffffffu, odd ? a1 : b1, 1);
      const int n = n0 + 8 * (2 * j2 + (odd ? 1 : 0)) + 2 * (tig & 2);
      if (r >= M || n >= N) continue;
      const F32x4 v = {{odd ? g0 : a0, odd ? g1 : a1, odd ? b0 : g0,
                        odd ? b1 : g1}};
      *reinterpret_cast<F32x4*>(o + (size_t)r * N + n) = v;
    }
  }
}

template <int kWG, int BN>
int launch_tc(const CUtensorMap& ta, const CUtensorMap& tb, float* out, int M,
              int N, int nb2, int nbatch, int nsplit, int steps,
              cudaStream_t stream) {
  using L = TcSmem<kWG, BN>;
  static const int attr = (int)cudaFuncSetAttribute(
      wgrad_tc_kernel<kWG, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::kBytes);
  if (attr != 0) return attr;
  const dim3 grid((N + BN - 1) / BN, (M + 64 * kWG - 1) / (64 * kWG),
                  nbatch * nsplit);
  wgrad_tc_kernel<kWG, BN><<<grid, L::kThreadsCta, L::kBytes, stream>>>(
      ta, tb, out, M, N, nb2, nbatch, steps, (steps + nsplit - 1) / nsplit);
  return (int)cudaGetLastError();
}

template <int kWG>
int launch_tc_bn(const CUtensorMap& ta, const CUtensorMap& tb, float* out,
                 int M, int N, int nb2, int nbatch, int nsplit, int steps,
                 cudaStream_t stream) {
  switch (tc_bn(N)) {
    case 64:
      return launch_tc<kWG, 64>(ta, tb, out, M, N, nb2, nbatch, nsplit, steps,
                                stream);
    case 128:
      return launch_tc<kWG, 128>(ta, tb, out, M, N, nb2, nbatch, nsplit,
                                 steps, stream);
    case 192:
      return launch_tc<kWG, 192>(ta, tb, out, M, N, nb2, nbatch, nsplit,
                                 steps, stream);
    default:
      return launch_tc<kWG, 256>(ta, tb, out, M, N, nb2, nbatch, nsplit,
                                 steps, stream);
  }
}

template <int kWG>
int per_sm(int N) {
  switch (tc_bn(N)) {
    case 64: return TcSmem<kWG, 64>::kPerSm;
    case 128: return TcSmem<kWG, 128>::kPerSm;
    case 192: return TcSmem<kWG, 192>::kPerSm;
    default: return TcSmem<kWG, 256>::kPerSm;
  }
}

// The (M, nb2, P, nb1) view of an operand whose element (z1, z2, p, m) is
// at base + z1 s1 + z2 s2 + p ld + m, boxes of 64 channels x 64 pixels; a
// batch dimension of one takes a stride the CUDA driver accepts.
View4 pixel_view(const void* base, int ld, long long s1, long long s2, int P,
                 int M, int nb1, int nb2) {
  return View4{base,
               {M, nb2, P, nb1},
               {nb2 > 1 ? s2 : ld, ld, nb1 > 1 ? s1 : (long long)ld * P},
               {64, 1, 64, 1}};
}

int launch_wgrad_bf16(const void* A, int lda, long long sa1, long long sa2,
                      const void* B, int ldb, long long sb1, long long sb2,
                      void* out, int P, int M, int N, int nb1, int nb2,
                      int nsplit, cudaStream_t stream) {
  if (N % 4 || (long long)nb1 * nb2 * nsplit > 65535 ||
      (M + 127) / 128 > 65535)
    return (int)cudaErrorInvalidValue;
  CUtensorMap ta, tb;
  int err;
  if ((err = view_map(&ta, pixel_view(A, lda, sa1, sa2, P, M, nb1, nb2),
                      false, true)) ||
      (err = view_map(&tb, pixel_view(B, ldb, sb1, sb2, P, N, nb1, nb2),
                      false, true)))
    return err;
  const int steps = (P + 63) / 64;
  return tc_wg(M) == 1
             ? launch_tc_bn<1>(ta, tb, (float*)out, M, N, nb2, nb1 * nb2,
                               nsplit, steps, stream)
             : launch_tc_bn<2>(ta, tb, (float*)out, M, N, nb2, nb1 * nb2,
                               nsplit, steps, stream);
}

}  // namespace

extern "C" {

// out: (nsplit, nb1, nb2, M, N) f32 partials of sum_p A[p][m] B[p][n] over
// P pixels, A[p][m] at A + z1 sa1 + z2 sa2 + p lda + m (elements), B
// likewise.  A and B in the same dtype: bf16 (is_bf16; the TMA + wgmma
// kernel, which needs 16-byte aligned bases and strides, i.e. lda, ldb,
// sa*, sb* multiples of 8, and N % 4 == 0) or f32.  Returns a cudaError_t.
int tblock_wgrad(const void* A, int lda, long long sa1, long long sa2,
                 const void* B, int ldb, long long sb1, long long sb2,
                 void* out, int P, int M, int N, int nb1, int nb2, int nsplit,
                 int is_bf16, void* stream) {
  if (P <= 0 || M <= 0 || N <= 0 || nb1 <= 0 || nb2 <= 0 || nsplit <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return launch_wgrad_bf16(A, lda, sa1, sa2, B, ldb, sb1, sb2, out, P, M, N,
                             nb1, nb2, nsplit, s);
  return launch_wgrad_f32(A, lda, sa1, sa2, B, ldb, sb1, sb2, out, P, M, N,
                          nb1, nb2, nsplit, s);
}

// The bf16 kernel's output tiles of one batch of an M x N product, and
// its CTAs an SM: the wrapper sizes the split over pixels from them.
int tblock_wgrad_tiles(int M, int N) {
  const int bm = 64 * tc_wg(M), bn = tc_bn(N);
  return ((M + bm - 1) / bm) * ((N + bn - 1) / bn);
}

int tblock_wgrad_ctas_per_sm(int M, int N) {
  return tc_wg(M) == 1 ? per_sm<1>(N) : per_sm<2>(N);
}

}  // extern "C"
