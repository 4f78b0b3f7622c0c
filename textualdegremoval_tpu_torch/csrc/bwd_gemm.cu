// The products of the Restormer TransformerBlock backward in bf16 for
// Hopper (sm_90a): one GEMM kernel, TMA-fed and on wgmma, for every
// product of the two halves that the TPU kernels computed in their bodies.
//
// Replaces the in-body products of the TPU kernels `_make_gdfn_bwd_kernel`
// (textualdegremoval_tpu/ops/pallas/tblock_bwd.py) and
// `_make_attn_bwd_apply_kernel` (ops/pallas/tblock_attn_bwd.py):
//   GDFN half:      hid = z . W1, dgate = dout . W2^T, dz = dhid . W1^T;
//   attention half: lin = y . Wqkv, and per (image, head)
//                   dq = k . M^T + q Dq, dk = q . M + k Dk, dv = do . A,
//                   dy = dlin . Wqkv^T.
// Between them run the CUDA-core passes of bwd_stencil.cu (LayerNorms, the
// depthwise stencils, gelu, the tap gradients).  The weight gradients (sums
// over pixels) stay in wgrad.cu.
//
// What bounds them on the card: each is a skinny product, M = every pixel
// of the batch (1.18 M at the 384 px batch-8 step), N and K = C, cph or
// the GDFN hidden (48-4096), so the ones with K or N near C are bound by
// their bytes (the operand read once, the output written once) and the
// widest (K or N = 2 hpad at C = 768) by operations.  Written as whole
// products over pixels, none recomputes anything on a halo (the TPU-shaped
// kernels redid the 1x1s on a 2-pixel halo, 3-6 times the body's work),
// and the f32 input gradient dz / dy is written once instead of being
// read-modified-written in shared memory per hidden chunk or head, which
// is what pinned the old kernels' tiles to 2-32 pixels.
//
// Design: CTAs of two consumer warpgroups (64 output rows each) and one
// producer warp, 288 threads, two CTAs per SM.  The producer keeps A (128
// pixel rows x 64 of K) and B (BN = 64 or 128 columns x 64 of K) in flight
// by TMA through a ring of 3 stages ("full" mbarriers with the stage's
// bytes, "empty" ones that the 8 consumer warps release); tiles land
// 128-byte swizzled (hopper.cuh) and every product is a wgmma with both
// operands in shared memory and f32 sums in registers.  B is read K-major
// (rows of N, a weight in the kernels' (outputs, inputs) layout) or
// MN-major (rows of K: the same weight run the other way, so dz and dy
// read W1 and Wqkv as the forward-direction products do, with no
// transposed copy).  K and N need not be multiples of 64: the boxes past
// them arrive as zeros and the epilogue drops the columns.  The epilogue
// writes f32 (dgate, dz, dy, the attention terms) or rounds to bf16 (hid,
// lin, where the TPU kernel rounds them), and for dq / dk adds the L2
// norm's diagonal term from the stencil's q / k in f32.  No atomics: a
// repeated call is bitwise equal.

#include "tma_maps.cuh"
#include "tblock_common.cuh"

namespace {

constexpr int kGemmThreads = 288;  // two consumer warpgroups, a producer warp
constexpr int kGemmRows = 128;     // output rows per CTA, 64 per warpgroup
constexpr int kGemmStages = 3;

// shared memory, bytes from the 1024-aligned base: per stage an A tile
// (128 rows x 128 bytes) and a B tile (BN x 64 values), then the
// mbarriers; plus the slack that aligns the base
template <int BN>
struct GemmSmem {
  static constexpr int kA = kGemmRows * 128;
  static constexpr int kStage = kA + BN * 128;
  static constexpr int kBars = kGemmStages * kStage;
  static constexpr int kBytes = kBars + 2 * kGemmStages * 8 + 1024;
};

// Where the products go: output row z3 * rows + r, column
// col0 + z2 * N + n (z2, z3: the batch indices, heads and images for the
// per-head products), f32 into out_f or rounded to bf16 into out_h.
// Where aux is set, the f32 value aux[row][aux_col0 + z2 N + n] *
// vec[z3 vec_ld + z2 N + n] is added first.
struct GemmOut {
  int rows, N, nz2, nk;  // nk: steps of 64 along K
  float* out_f;
  __nv_bfloat16* out_h;
  long long ldo;
  int col0;
  const __nv_bfloat16* aux;
  long long ld_aux;
  int aux_col0;
  const float* vec;
  int vec_ld;
};

struct alignas(8) F32Pair {
  float lo, hi;
};

// two f32 rounded to bf16 as one word (lo in bits 0-15)
__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  const __nv_bfloat16 a = from_f<__nv_bfloat16>(lo);
  const __nv_bfloat16 b = from_f<__nv_bfloat16>(hi);
  return (uint32_t)*reinterpret_cast<const unsigned short*>(&a) |
         ((uint32_t)*reinterpret_cast<const unsigned short*>(&b) << 16);
}

template <int BN, int kTransB>
__global__ void __launch_bounds__(kGemmThreads, 2) bwd_gemm_kernel(
    const __grid_constant__ CUtensorMap ta,
    const __grid_constant__ CUtensorMap tb, const GemmOut g) {
  using L = GemmSmem<BN>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base = smem_raw + (1024 - smem_addr(smem_raw) % 1024) % 1024;
  uint64_t* full = reinterpret_cast<uint64_t*>(base + L::kBars);
  uint64_t* empty = full + kGemmStages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kGemmStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 8);
    }
    mbar_init_fence();
  }
  __syncthreads();
  const int n0 = blockIdx.x * BN, row0 = blockIdx.y * kGemmRows;
  const int z2 = blockIdx.z % g.nz2, z3 = blockIdx.z / g.nz2;
  const int lane = threadIdx.x & 31;

  const int wg = warpgroup_index();
  if (wg == 2) {  // the producer warp: its first lane loads
    if (lane == 0) {
      for (int it = 0; it < g.nk; ++it) {
        const int s = it % kGemmStages;
        mbar_wait(empty + s, ((it / kGemmStages) & 1) ^ 1);
        unsigned char* st = base + s * L::kStage;
        mbar_arrive_expect_tx(full + s, L::kStage);
        tma_load(st, &ta, full + s, 64 * it, z2, row0, z3);
        if (kTransB == 0) {
          tma_load(st + L::kA, &tb, full + s, 64 * it, n0, z2, z3);
        } else {
          for (int x = 0; x < BN / 64; ++x)
            tma_load(st + L::kA + x * 8192, &tb, full + s, n0 + 64 * x,
                     64 * it, z2, z3);
        }
      }
    }
    return;
  }

  const int warp = (threadIdx.x >> 5) & 3;
  const int gq = lane >> 2, tig = lane & 3;
  float acc[BN / 2];
#pragma unroll
  for (int j = 0; j < BN / 2; ++j) acc[j] = 0.f;
  for (int it = 0; it < g.nk; ++it) {
    const int s = it % kGemmStages;
    mbar_wait(full + s, (it / kGemmStages) & 1);
    // this warpgroup's 64 rows of the A tile; the B tile
    const uint32_t at = smem_addr(base + s * L::kStage) + wg * 64 * 128;
    const uint32_t bt = smem_addr(base + s * L::kStage + L::kA);
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      // K-major B: rows of N, 16 K values at 32 kc bytes; MN-major: 16 K
      // rows (2048 bytes) per step, 64-wide N boxes 8192 bytes apart
      const uint64_t db = kTransB ? desc_sw128(bt + kc * 2048, 8192, 1024)
                                  : desc_sw128(bt + kc * 32, 16, 1024);
      wgmma_ss<BN, kTransB>(acc, desc_sw128(at + kc * 32, 16, 1024), db, 1);
    }
    wgmma_commit();
    wgmma_wait();
    fence_regs(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + s);  // this warp read the stage
  }

  // entry 4 j + 2 h + c: row 16 warp + gq + 8 h, column 8 j + 2 tig + c;
  // the two columns of a pair are stored as one 8- or 4-byte word
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + wg * 64 + warp * 16 + gq + 8 * h;
    if (r >= g.rows) continue;
    const size_t row = (size_t)z3 * g.rows + r;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int n = n0 + 8 * j + 2 * tig;
      if (n >= g.N) continue;
      const int col = z2 * g.N + n;
      const bool two = n + 1 < g.N;
      float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
      if (g.aux != nullptr) {
        const __nv_bfloat16* ap = g.aux + row * g.ld_aux + g.aux_col0 + col;
        const float* vp = g.vec + (size_t)z3 * g.vec_ld + col;
        v0 += to_f(ap[0]) * vp[0];
        if (two) v1 += to_f(ap[1]) * vp[1];
      }
      const size_t o = row * g.ldo + g.col0 + col;
      if (g.out_h != nullptr) {
        if (two)
          *reinterpret_cast<uint32_t*>(g.out_h + o) = bf16_pair(v0, v1);
        else
          g.out_h[o] = from_f<__nv_bfloat16>(v0);
      } else if (two) {
        *reinterpret_cast<F32Pair*>(g.out_f + o) = F32Pair{v0, v1};
      } else {
        g.out_f[o] = v0;
      }
    }
  }
}

template <int BN, int kTransB>
int launch_gemm(const CUtensorMap& ta, const CUtensorMap& tb,
                const GemmOut& g, int nz3, cudaStream_t stream) {
  using L = GemmSmem<BN>;
  static const int attr = (int)cudaFuncSetAttribute(
      bwd_gemm_kernel<BN, kTransB>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (attr != 0) return attr;
  const dim3 grid((g.N + BN - 1) / BN, (g.rows + kGemmRows - 1) / kGemmRows,
                  g.nz2 * nz3);
  bwd_gemm_kernel<BN, kTransB><<<grid, kGemmThreads, L::kBytes, stream>>>(
      ta, tb, g);
  return (int)cudaGetLastError();
}

// out = A . B over K.  a: the (K, nz2, rows, nz3) view of A; b: the (K, N,
// nz2, nz3) view of B when K-major (trans_b 0), (N, K, nz2, nz3) when
// MN-major (trans_b 1).  Boxes are set here.
int run_gemm(View4 a, View4 b, int K, int trans_b, GemmOut g, int nz3,
             cudaStream_t stream) {
  if (g.rows <= 0 || g.N <= 0 || K <= 0 || g.nz2 <= 0 || nz3 <= 0 ||
      (g.rows + kGemmRows - 1) / kGemmRows > 65535 || g.nz2 * nz3 > 65535)
    return (int)cudaErrorInvalidValue;
  const int bn = g.N <= 64 ? 64 : 128;
  g.nk = (K + 63) / 64;
  a.box[0] = 64, a.box[1] = 1, a.box[2] = kGemmRows, a.box[3] = 1;
  b.box[0] = 64, b.box[1] = trans_b ? 64 : bn, b.box[2] = 1, b.box[3] = 1;
  CUtensorMap ta, tb;
  int err;
  if ((err = view_map(&ta, a, false, true)) ||
      (err = view_map(&tb, b, false, true)))
    return err;
  if (bn == 64)
    return trans_b ? launch_gemm<64, 1>(ta, tb, g, nz3, stream)
                   : launch_gemm<64, 0>(ta, tb, g, nz3, stream);
  return trans_b ? launch_gemm<128, 1>(ta, tb, g, nz3, stream)
                 : launch_gemm<128, 0>(ta, tb, g, nz3, stream);
}

// a contiguous (rows, cols) matrix as run_gemm's A view (rows in dimension
// 2) or B view (rows in dimension 1), one batch each
View4 a_view(const void* p, long long rows, long long cols) {
  return View4{p, {cols, 1, rows, 1}, {rows * cols, cols, rows * cols}, {}};
}
View4 b_view(const void* p, long long rows, long long cols) {
  return View4{p, {cols, rows, 1, 1}, {cols, rows * cols, rows * cols}, {}};
}

GemmOut plain_out(int M, int N, void* out, int out_bf16) {
  GemmOut g = {};
  g.rows = M, g.N = N, g.nz2 = 1, g.ldo = N;
  if (out_bf16)
    g.out_h = (__nv_bfloat16*)out;
  else
    g.out_f = (float*)out;
  return g;
}

// One per-head product of the attention half over the pixels of every
// (image, head): dth[:, col0 + hd cph + n] = A_h . B_h (+ aux_h * vec_h).
// a: the third's (HW B, lda) operand at its head 0; b: (B, heads, cph, cph)
// read K-major (trans_b 0: B(k, n) = b[n][k]) or MN-major (B(k, n) =
// b[k][n]).
int head_product(const void* a, int lda, const void* b, int trans_b,
                 const void* aux, int aux_col0, const float* vec, float* dth,
                 int col0, int B, int HW, int C, int heads,
                 cudaStream_t stream) {
  const int cph = C / heads;
  const long long hw = HW, sq = (long long)cph * cph;
  const View4 av = {a, {cph, heads, HW, B}, {cph, lda, lda * hw}, {}};
  const View4 bv = {b, {cph, cph, heads, B}, {cph, sq, sq * heads}, {}};
  GemmOut g = {};
  g.rows = HW, g.N = cph, g.nz2 = heads;
  g.out_f = dth, g.ldo = 3LL * C, g.col0 = col0;
  g.aux = (const __nv_bfloat16*)aux, g.ld_aux = 2LL * C, g.aux_col0 = aux_col0;
  g.vec = vec, g.vec_ld = C;
  return run_gemm(av, bv, cph, trans_b, g, B, stream);
}

}  // namespace

extern "C" {

// out (M, N) = a (M, K) . b^T with b (N, K): a forward-direction product of
// the backward (hid = z . W1 with b = W1 in the kernels' (outputs, inputs)
// layout, dgate = dout . W2^T with b = W2 transposed, lin = y . Wqkv).
// a, b contiguous bf16; out contiguous, f32 or (out_bf16) bf16.  Rows of a
// and b are 16-byte multiples (K % 8 == 0).  Returns a cudaError_t.
int bwd_gemm(const void* a, const void* b, void* out, int M, int N, int K,
             int out_bf16, void* stream) {
  return run_gemm(a_view(a, M, K), b_view(b, N, K), K, 0,
                  plain_out(M, N, out, out_bf16), 1, (cudaStream_t)stream);
}

// The input gradient: out (M, N) f32 = a (M, K) . w^T with w (K, N) the
// forward's weight in the kernels' (outputs, inputs) layout, read MN-major
// (dz = dhid . W1^T with w = W1 (2 hpad, C); dy = dlin . Wqkv^T with w =
// Wqkv (3 C, C)).  Returns a cudaError_t.
int bwd_dgrad(const void* a, const void* w, float* out, int M, int N, int K,
              void* stream) {
  return run_gemm(a_view(a, M, K), b_view(w, K, N), K, 1,
                  plain_out(M, N, out, 0), 1, (cudaStream_t)stream);
}

// The attention terms of the three thirds, into dth (B HW, 3 C) f32:
//   q third: k . M^T + q Dq;  k third: q . M + k Dk;  v third: do . A
// per (image, head).  qk: (B HW, 2 C) q | k after their stencil (bf16);
// dos: (B HW, C) do from pass 1; m, attn: (B, heads, cph, cph) bf16, M of
// the glue and the softmax output A; dqd, dkd: (B, C) f32.  cph % 8 == 0.
// Returns a cudaError_t.
int bwd_head_products(const void* qk, const void* dos, const void* m,
                      const void* attn, const float* dqd, const float* dkd,
                      float* dth, int B, int HW, int C, int heads,
                      void* stream) {
  if (heads <= 0 || C % heads || (C / heads) % 8)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const __nv_bfloat16* q = (const __nv_bfloat16*)qk;
  const __nv_bfloat16* k = q + C;
  int err;
  if ((err = head_product(k, 2 * C, m, 0, qk, 0, dqd, dth, 0, B, HW, C,
                          heads, s)) ||
      (err = head_product(q, 2 * C, m, 1, qk, C, dkd, dth, C, B, HW, C,
                          heads, s)) ||
      (err = head_product(dos, C, attn, 1, nullptr, 0, nullptr, dth, 2 * C,
                          B, HW, C, heads, s)))
    return err;
  return 0;
}

}  // extern "C"
