// Host checks of the Hopper primitives of csrc/hopper.cuh as
// tests/cuda_host_shim.h runs them (tests/test_torch_hopper_shim.py): one
// warpgroup product fed by TMA tile loads, and one raw TMA box.  Compiled
// with g++ against the shim; each entry returns a cudaError_t.
#include "cuda_host_shim.h"
#include "hopper.cuh"

namespace {

// C (64 x N, f32, row-major) = A (64 x K) . B, summed over K in steps of
// 16.  A is a bf16 (64, K) row-major matrix read K-major (kTransA 0:
// loaded by TMA as K / 64 boxes of 64 x 64), or a (K, 64) one read
// MN-major (kTransA 1: one box of K rows of 64 M values).  B is (N, K)
// read K-major (kTransB 0: K / 64 boxes of N x 64) or (K, N) read MN-major
// (kTransB 1: N / 64 boxes of K x 64).  A comes from shared memory (rs 0)
// or from registers (rs 1, K-major A only), packed from global memory in
// the m16n8k16 A layout.
template <int N, int kTransB, int kTransA>
__global__ void product(const __grid_constant__ CUtensorMap ta,
                        const __grid_constant__ CUtensorMap tb,
                        const uint16_t* a, int K, int rs, float* c) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sa = smem_raw;              // up to 32 KB
  unsigned char* sb = smem_raw + 32768;      // up to 64 KB
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem_raw + 131072);
  const int rows_b = kTransB ? K : N;
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_arrive_expect_tx(bar, (64 * K + N * K) * 2);
    if (kTransA)
      tma_load(sa, &ta, bar, 0, 0, 0, 0);
    else
      for (int x = 0; x < K / 64; ++x)
        tma_load(sa + x * 64 * 128, &ta, bar, 64 * x, 0, 0, 0);
    for (int x = 0; x < (kTransB ? N : K) / 64; ++x)
      tma_load(sb + x * rows_b * 128, &tb, bar, 64 * x, 0, 0, 0);
  }
  mbar_wait(bar, 0);

  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tig = lane % 4;
  float d[N / 2];
  wgmma_fence();
  for (int kc = 0; kc < K / 16; ++kc) {
    const uint64_t db =
        kTransB ? desc_sw128(smem_addr(sb) + kc * 2048, K * 128, 1024)
                : desc_sw128(smem_addr(sb) + (kc / 4) * N * 128 +
                                 (kc % 4) * 32,
                             16, 1024);
    if (rs) {
      uint32_t f[4];
      for (int i = 0; i < 4; ++i) {
        const int row = 16 * w + g + 8 * (i & 1);
        const int col = 16 * kc + 8 * (i >> 1) + 2 * tig;
        f[i] = (uint32_t)a[row * K + col] |
               ((uint32_t)a[row * K + col + 1] << 16);
      }
      if constexpr (N <= 128) wgmma_rs<N, kTransB>(d, f, db, kc > 0);
    } else {
      // MN-major A: 16 K rows (2048 bytes) a step, one 64-wide M box
      const uint64_t da =
          kTransA ? desc_sw128(smem_addr(sa) + kc * 2048, K * 128, 1024)
                  : desc_sw128(smem_addr(sa) + (kc / 4) * 64 * 128 +
                                   (kc % 4) * 32,
                               16, 1024);
      wgmma_ss<N, kTransB, kTransA>(d, da, db, kc > 0);
    }
  }
  wgmma_commit();
  wgmma_wait();
  for (int j = 0; j < N / 8; ++j)
    for (int i = 0; i < 4; ++i)
      c[(16 * w + g + 8 * (i >> 1)) * N + 8 * j + 2 * tig + (i & 1)] =
          d[4 * j + i];
}

template <int N, int kTransB, int kTransA>
void run_product(const CUtensorMap& ta, const CUtensorMap& tb,
                 const uint16_t* a, int K, int rs, float* c) {
  shim_launch(dim3(1), 128, 0, nullptr, product<N, kTransB, kTransA>, ta, tb,
              a, K, rs, c);
}

template <int N>
int run_width(const CUtensorMap& ta, const CUtensorMap& tb,
              const uint16_t* a, int K, int rs, float* c, int mn_major,
              int a_mn_major) {
  if (a_mn_major)
    mn_major ? run_product<N, 1, 1>(ta, tb, a, K, rs, c)
             : run_product<N, 0, 1>(ta, tb, a, K, rs, c);
  else
    mn_major ? run_product<N, 1, 0>(ta, tb, a, K, rs, c)
             : run_product<N, 0, 0>(ta, tb, a, K, rs, c);
  return 0;
}

// One TMA box of `rows` x D (D / 64 loads of rows x 64) of a bf16 (n, D)
// row-major matrix from row row0, its shared-memory bytes copied to out.
__global__ void box(const __grid_constant__ CUtensorMap t, int D, int row0,
                    int rows, unsigned char* out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem_raw + 65536);
  mbar_init(bar, 1);
  mbar_arrive_expect_tx(bar, rows * D * 2);
  for (int x = 0; x < D / 64; ++x)
    tma_load(smem_raw + x * rows * 128, &t, bar, 64 * x, row0, 0, 0);
  mbar_wait(bar, 0);
  memcpy(out, smem_raw, (size_t)rows * D * 2);
}

}  // namespace

extern "C" {

// a: (64, K) row-major, or (K, 64) when a_mn_major; b: (N, K), or (K, N)
// when mn_major.  N in 64, 128, 256 (256 from shared memory only).
int hopper_product(const uint16_t* a, const uint16_t* b, float* c, int N,
                   int K, int mn_major, int rs, int a_mn_major) {
  if ((a_mn_major && (rs || K > 256)) || (N == 256 && rs))
    return (int)cudaErrorInvalidValue;
  CUtensorMap ta, tb;
  int err = a_mn_major ? bnhd_map(&ta, a, 1, K, 1, 64, 64LL * K, 64, 64, K)
                       : bnhd_map(&ta, a, 1, 64, 1, K, 64LL * K, K, K, 64);
  if (err == 0)
    err = mn_major ? bnhd_map(&tb, b, 1, K, 1, N, (long long)K * N, N, N, K)
                   : bnhd_map(&tb, b, 1, N, 1, K, (long long)N * K, K, K, N);
  if (err != 0) return err;
  if (N == 64) return run_width<64>(ta, tb, a, K, rs, c, mn_major, a_mn_major);
  if (N == 128)
    return run_width<128>(ta, tb, a, K, rs, c, mn_major, a_mn_major);
  if (N == 256)
    return run_width<256>(ta, tb, a, K, rs, c, mn_major, a_mn_major);
  return (int)cudaErrorInvalidValue;
}

int hopper_box(const uint16_t* src, int n, int D, int row0, int rows,
               unsigned char* out) {
  CUtensorMap t;
  const int err = bnhd_map(&t, src, 1, n, 1, D, (long long)n * D, D, D, rows);
  if (err != 0) return err;
  shim_launch(dim3(1), 1, 0, nullptr, box, t, D, row0, rows, out);
  return 0;
}

}  // extern "C"
