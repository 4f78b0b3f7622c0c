// The products of the Restormer TransformerBlock in bf16 for Hopper
// (sm_90a), backward and forward: one GEMM kernel, TMA-fed and on wgmma,
// for every product of the two halves that the TPU kernels computed in
// their bodies.
//
// Replaces the in-body products of the TPU kernels `_make_gdfn_bwd_kernel`
// (textualdegremoval_tpu/ops/pallas/tblock_bwd.py) and
// `_make_attn_bwd_apply_kernel` (ops/pallas/tblock_attn_bwd.py):
//   GDFN half:      hid = z . W1, dgate = dout . W2^T, dz = dhid . W1^T;
//   attention half: lin = y . Wqkv, and per (image, head)
//                   dq = k . M^T + q Dq, dk = q . M + k Dk, dv = do . A,
//                   dy = dlin . Wqkv^T;
// and of `_make_attn_bwd_stats_kernel` (its pass 1): per (image, head)
// o = v . A^T, and do = dx1 . Wproj^T.
// and of the forward kernels `_make_stats_kernel` and `_make_apply_kernel`
// (ops/pallas/tblock.py:170, :220): lin = y . Wqkv, hid = z . W1 (the
// backward's own entries), per (image, head) o = v . A^T, and the two
// products that end in a residual, x1 = x + rnd(o . Wproj) and
// out = x1 + rnd(gate . W2) (the sequence is laid out at the top of
// fwd_stencil.cu).  And the four products of the NAFBlock forward
// (ops/pallas/nafblock.py:131-218, the TPU kernels `_make_sum_kernel` and
// `_make_apply_kernel`; the sequence is laid out at the top of
// naf_stencil.cu): conv1's h = rnd(rnd(y . W1) + b1), the residual
// products y1 = x + rnd(rnd(rnd(gs . W3) + b3) beta) and
// out = y1 + rnd(rnd(rnd(g2 . W5) + b5) gamma), and conv4 with its gate,
// g2 = rnd(h_a h_b) with h_* = rnd(rnd(z . W4_*) + b4_*).
// Between them run the CUDA-core passes of bwd_stencil.cu and
// fwd_stencil.cu (LayerNorms, the depthwise stencils, gelu, the tap
// gradients).  The weight gradients (sums over pixels) and the forward's
// gram stay in wgrad.cu.
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
// lin, o, where the TPU kernel rounds them), for dq / dk adds the L2
// norm's diagonal term from the stencil's q / k in f32, and for the
// forward's residual products rounds the product to bf16, adds the bf16
// residual in f32 and rounds the sum (the TPU kernel's x + rnd(proj)).
// The NAFBlock's epilogues (kEpi 1, 2) add a bias after the product's
// rounding and round again, then scale by beta or gamma and round before
// the residual, or form the gate: with W4's columns in 32-channel chunks
// (a chunk's first half, then its second), the two columns of a gate
// channel lie 32 apart, in the same lane's accumulators (entries of j and
// j + 4), so the product of the halves is formed in registers and only
// the gate, half as wide, is stored.
// Its stores were what bounded the skinny products: each lane now stores
// whole 16-byte runs of a row, the quad's lanes trading values through
// shuffles first.  No atomics: a repeated call is bitwise equal.

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
// vec[z3 vec_ld + z2 N + n] is added first; where res is set, the product
// is rounded to bf16 and res[row][col0 + z2 N + n] added in f32.  epi 1
// and 2 (the NAFBlock's, bf16 out, nz2 = 1): bias[n] added to the rounded
// product and the sum rounded; epi 1 then times scale[n] and rounded
// where scale is set, before res; epi 2 stores the rounded product of
// columns n and n + 32 of each 64-column chunk k (n % 64 < 32) at output
// column 32 k + n % 64, in an output N / 2 wide (naf_word).
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
  const __nv_bfloat16* res;
  long long ld_res;
  int epi;
  const float* bias;
  const float* scale;
};

// two f32 rounded to bf16 as one word (lo in bits 0-15)
__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  const __nv_bfloat16 a = from_f<__nv_bfloat16>(lo);
  const __nv_bfloat16 b = from_f<__nv_bfloat16>(hi);
  return (uint32_t)*reinterpret_cast<const unsigned short*>(&a) |
         ((uint32_t)*reinterpret_cast<const unsigned short*>(&b) << 16);
}

// 16 bytes of an output row, loaded and stored as one word
struct alignas(16) Run16 {
  uint32_t w[4];
};

__device__ __forceinline__ float f32_of(uint32_t bits) {
  float v;
  memcpy(&v, &bits, 4);
  return v;
}
__device__ __forceinline__ uint32_t bits_of(float v) {
  uint32_t bits;
  memcpy(&bits, &v, 4);
  return bits;
}
// value e of a run of 8 bf16 as f32 (a bf16 is the upper half of its f32)
__device__ __forceinline__ float bf16_at(const Run16& q, int e) {
  return f32_of(e & 1 ? q.w[e / 2] & 0xffff0000u : q.w[e / 2] << 16);
}

// A quad's 4 lanes trade words: wv[t] is this lane's word of j = 4 j4 + t,
// tw[s] comes back as lane s's word of j = 4 j4 + tig, so that each lane
// holds 8 consecutive columns of a row
__device__ __forceinline__ void quad_transpose(const uint32_t (&wv)[4],
                                               uint32_t (&tw)[4], int tig) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int s = tig ^ k;
    const uint32_t got = __shfl_xor_sync(
        0xffffffffu, s == 0 ? wv[0] : s == 1 ? wv[1] : s == 2 ? wv[2] : wv[3],
        k);
    if (s == 0) tw[0] = got;
    else if (s == 1) tw[1] = got;
    else if (s == 2) tw[2] = got;
    else tw[3] = got;
  }
}

// rnd(rnd(a) + bias[n]): a product column's value after its bias
__device__ __forceinline__ float biased(float a, const GemmOut& g, int n) {
  return rnd<__nv_bfloat16>(rnd<__nv_bfloat16>(a) +
                            (n < g.N ? g.bias[n] : 0.f));
}

// The NAFBlock epilogues' word of row half h at the columns n, n + 1
// (n = n0 + 8 j + 2 tig): epi 1 the biased values, times scale[n] and
// rounded where scale is set; epi 2 the gate rnd(h_a h_b) of column n of
// a chunk's first half and column n + 32 of its second (j % 8 < 4).
template <int BN, int kEpi>
__device__ __forceinline__ uint32_t naf_word(const float (&acc)[BN / 2],
                                             const GemmOut& g, int j, int h,
                                             int n0, int tig) {
  float v[2];
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int n = n0 + 8 * j + 2 * tig + c;
    float a = biased(acc[4 * j + 2 * h + c], g, n);
    if constexpr (kEpi == 2)
      a = rnd<__nv_bfloat16>(a * biased(acc[4 * (j + 4) + 2 * h + c], g,
                                        n + 32));
    else if (g.scale != nullptr)
      a = rnd<__nv_bfloat16>(a * (n < g.N ? g.scale[n] : 0.f));
    v[c] = a;
  }
  return bf16_pair(v[0], v[1]);
}

template <int BN, int kTransB, int kEpi>
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

  // entry 4 j + 2 h + c: row 16 warp + gq + 8 h, column 8 j + 2 tig + c.
  // A quad's 4 lanes hold 8 columns of a row per j: they trade values so
  // that each lane stores whole 16-byte runs (a run of a row per lane and
  // store, 64 bytes of a row per quad), where a pair per lane and store
  // (16 or 32 bytes of a row per quad) took up to 1.6 times as long.
  // bf16: the lanes transpose their words of 4 j; f32: lane pairs trade
  // pairs of 2 j.  Rows past the tile's last are computed but not stored
  // (every lane takes part in the shuffles).  run_gemm admits N, ldo and
  // col0 multiples of 8 only, aux with f32 out, res with bf16 out.  epi 2
  // makes a run of 8 gate values from 64 product columns (4 j of each
  // half of a chunk), so a tile stores BN / 64 runs a row per lane.
  const int r_of[2] = {row0 + wg * 64 + warp * 16 + gq,
                       row0 + wg * 64 + warp * 16 + gq + 8};
  if (g.out_h != nullptr) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r_of[h];
      const size_t row = (size_t)z3 * g.rows + (r < g.rows ? r : 0);
#pragma unroll
      for (int j4 = 0; j4 < (kEpi == 2 ? BN / 64 : BN / 32); ++j4) {
        // wv[t]: this lane's word of j = 4 j4 + t (epi 2: of the gate of
        // j = 8 j4 + t and j + 4); tw[s]: lane s's word of j = 4 j4 + tig
        uint32_t wv[4], tw[4];
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          if constexpr (kEpi == 0)
            wv[t] = bf16_pair(acc[4 * (4 * j4 + t) + 2 * h],
                              acc[4 * (4 * j4 + t) + 2 * h + 1]);
          else
            wv[t] = naf_word<BN, kEpi>(
                acc, g, kEpi == 2 ? 8 * j4 + t : 4 * j4 + t, h, n0, tig);
        }
        quad_transpose(wv, tw, tig);
        const int n = kEpi == 2 ? n0 / 2 + 32 * j4 + 8 * tig
                                : n0 + 8 * (4 * j4 + tig);
        if (r >= g.rows || n >= (kEpi == 2 ? g.N / 2 : g.N)) continue;
        const size_t col = (size_t)g.col0 + z2 * g.N + n;
        Run16 out = {{tw[0], tw[1], tw[2], tw[3]}};
        if (g.res != nullptr) {
          const Run16 rq =
              *reinterpret_cast<const Run16*>(g.res + row * g.ld_res + col);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            out.w[e] = bf16_pair(bf16_at(rq, 2 * e) + bf16_at(out, 2 * e),
                                 bf16_at(rq, 2 * e + 1) +
                                     bf16_at(out, 2 * e + 1));
        }
        *reinterpret_cast<Run16*>(g.out_h + row * g.ldo + col) = out;
      }
    }
  } else {
    const bool odd = tig & 1;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r_of[h];
      const size_t row = (size_t)z3 * g.rows + (r < g.rows ? r : 0);
#pragma unroll
      for (int j2 = 0; j2 < BN / 16; ++j2) {
        // even lanes keep j = 2 j2 and take their partner's pair of it,
        // odd lanes keep j = 2 j2 + 1
        const float a0 = acc[8 * j2 + 2 * h], a1 = acc[8 * j2 + 2 * h + 1];
        const float b0 = acc[8 * j2 + 4 + 2 * h];
        const float b1 = acc[8 * j2 + 4 + 2 * h + 1];
        const float g0 = __shfl_xor_sync(0xffffffffu, odd ? a0 : b0, 1);
        const float g1 = __shfl_xor_sync(0xffffffffu, odd ? a1 : b1, 1);
        const int n = n0 + 8 * (2 * j2 + (odd ? 1 : 0)) + 2 * (tig & 2);
        if (r >= g.rows || n >= g.N) continue;
        float v[4] = {odd ? g0 : a0, odd ? g1 : a1, odd ? b0 : g0,
                      odd ? b1 : g1};
        const size_t col = (size_t)z2 * g.N + n;
        if (g.aux != nullptr) {
          const __nv_bfloat16* ap = g.aux + row * g.ld_aux + g.aux_col0 + col;
          const float* vp = g.vec + (size_t)z3 * g.vec_ld + col;
#pragma unroll
          for (int e = 0; e < 4; ++e) v[e] += to_f(ap[e]) * vp[e];
        }
        const Run16 out = {{bits_of(v[0]), bits_of(v[1]), bits_of(v[2]),
                            bits_of(v[3])}};
        *reinterpret_cast<Run16*>(g.out_f + row * g.ldo + g.col0 + col) =
            out;
      }
    }
  }
}

template <int BN, int kTransB, int kEpi>
int launch_gemm(const CUtensorMap& ta, const CUtensorMap& tb,
                const GemmOut& g, int nz3, cudaStream_t stream) {
  using L = GemmSmem<BN>;
  static const int attr = (int)cudaFuncSetAttribute(
      bwd_gemm_kernel<BN, kTransB, kEpi>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (attr != 0) return attr;
  const dim3 grid((g.N + BN - 1) / BN, (g.rows + kGemmRows - 1) / kGemmRows,
                  g.nz2 * nz3);
  bwd_gemm_kernel<BN, kTransB, kEpi><<<grid, kGemmThreads, L::kBytes,
                                       stream>>>(ta, tb, g);
  return (int)cudaGetLastError();
}

// out = A . B over K.  a: the (K, nz2, rows, nz3) view of A; b: the (K, N,
// nz2, nz3) view of B when K-major (trans_b 0), (N, K, nz2, nz3) when
// MN-major (trans_b 1).  Boxes are set here.
int run_gemm(View4 a, View4 b, int K, int trans_b, GemmOut g, int nz3,
             cudaStream_t stream) {
  if (g.rows <= 0 || g.N <= 0 || K <= 0 || g.nz2 <= 0 || nz3 <= 0 ||
      (g.rows + kGemmRows - 1) / kGemmRows > 65535 || g.nz2 * nz3 > 65535 ||
      g.N % 8 || g.ldo % 8 || g.col0 % 8 || (g.out_h && g.aux) ||
      (g.out_f && g.res) ||
      (g.epi != 0 && (!g.out_h || !g.bias || g.nz2 != 1 || trans_b ||
                      g.aux)) ||
      (g.epi == 2 && (g.N % 64 || g.res || g.scale)))
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
  if (g.epi != 0) {
    if (bn == 64)
      return g.epi == 1 ? launch_gemm<64, 0, 1>(ta, tb, g, nz3, stream)
                        : launch_gemm<64, 0, 2>(ta, tb, g, nz3, stream);
    return g.epi == 1 ? launch_gemm<128, 0, 1>(ta, tb, g, nz3, stream)
                      : launch_gemm<128, 0, 2>(ta, tb, g, nz3, stream);
  }
  if (bn == 64)
    return trans_b ? launch_gemm<64, 1, 0>(ta, tb, g, nz3, stream)
                   : launch_gemm<64, 0, 0>(ta, tb, g, nz3, stream);
  return trans_b ? launch_gemm<128, 1, 0>(ta, tb, g, nz3, stream)
                 : launch_gemm<128, 0, 0>(ta, tb, g, nz3, stream);
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
// b[k][n]); aux: (HW B, lda) bf16.
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
  g.aux = (const __nv_bfloat16*)aux, g.ld_aux = lda, g.aux_col0 = aux_col0;
  g.vec = vec, g.vec_ld = C;
  return run_gemm(av, bv, cph, trans_b, g, B, stream);
}

// o = v . A_h^T per (image, head), rounded to bf16 (A read K-major:
// B(k, n) = A[n][k]); qkv (B HW, 3 C) bf16 after the stencils, v its last
// third; attn (B, heads, cph, cph) bf16; o (B HW, C) bf16
int heads_o(const void* qkv, const void* attn, void* o, int B, int HW, int C,
            int heads, cudaStream_t stream) {
  if (heads <= 0 || C % heads || (C / heads) % 8)
    return (int)cudaErrorInvalidValue;
  const int cph = C / heads;
  const long long hw = HW, sq = (long long)cph * cph, ld = 3LL * C;
  const View4 vv = {(const __nv_bfloat16*)qkv + 2 * C,
                    {cph, heads, HW, B}, {cph, ld, ld * hw}, {}};
  const View4 av = {attn, {cph, cph, heads, B}, {cph, sq, sq * heads}, {}};
  GemmOut g = {};
  g.rows = HW, g.N = cph, g.nz2 = heads;
  g.out_h = (__nv_bfloat16*)o, g.ldo = C;
  return run_gemm(vv, av, cph, 0, g, B, stream);
}

// out (M, N) bf16 = res + rnd(a (M, K) . b^T) with b (N, K); res (M, N)
// bf16, or no residual where it is null
int residual_gemm(const void* a, const void* b, const void* res, void* out,
                  int M, int N, int K, cudaStream_t stream) {
  GemmOut g = plain_out(M, N, out, 1);
  g.res = (const __nv_bfloat16*)res, g.ld_res = N;
  return run_gemm(a_view(a, M, K), b_view(b, N, K), K, 0, g, 1, stream);
}

// The NAFBlock's products: out = epilogue(a (M, K) . b^T) with b (N, K),
// its epilogue epi 1 (bias, then scale and res where set) or 2 (the gate,
// out (M, N / 2))
int naf_product(const void* a, const void* b, int epi, const float* bias,
                const float* scale, const void* res, void* out, int M, int N,
                int K, cudaStream_t stream) {
  GemmOut g = plain_out(M, N, out, 1);
  g.ldo = epi == 2 ? N / 2 : N;
  g.epi = epi, g.bias = bias, g.scale = scale;
  g.res = (const __nv_bfloat16*)res, g.ld_res = N;
  return run_gemm(a_view(a, M, K), b_view(b, N, K), K, 0, g, 1, stream);
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
// per (image, head).  qkv: (B HW, 3 C) q | k | v after their stencil
// (bf16; pass 1's); dos: (B HW, C) do from pass 1; m, attn: (B, heads,
// cph, cph) bf16, M of the glue and the softmax output A; dqd, dkd: (B, C)
// f32.  cph % 8 == 0.  Returns a cudaError_t.
int bwd_head_products(const void* qkv, const void* dos, const void* m,
                      const void* attn, const float* dqd, const float* dkd,
                      float* dth, int B, int HW, int C, int heads,
                      void* stream) {
  if (heads <= 0 || C % heads || (C / heads) % 8)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const __nv_bfloat16* q = (const __nv_bfloat16*)qkv;
  const __nv_bfloat16* k = q + C;
  int err;
  if ((err = head_product(k, 3 * C, m, 0, qkv, 0, dqd, dth, 0, B, HW, C,
                          heads, s)) ||
      (err = head_product(q, 3 * C, m, 1, qkv, C, dkd, dth, C, B, HW, C,
                          heads, s)) ||
      (err = head_product(dos, C, attn, 1, nullptr, 0, nullptr, dth, 2 * C,
                          B, HW, C, heads, s)))
    return err;
  return 0;
}

// The forward's residual product: out (M, N) bf16 = res + rnd(a . b^T),
// a (M, K), b (N, K) (W2 in the kernels' (outputs, inputs) layout), res
// (M, N), all contiguous bf16: out = x1 + rnd(gate . W2).  Returns a
// cudaError_t.
int fwd_gemm_residual(const void* a, const void* b, const void* res,
                      void* out, int M, int N, int K, void* stream) {
  return residual_gemm(a, b, res, out, M, N, K, (cudaStream_t)stream);
}

// The forward's attention output: per (image, head) o = v . A_h^T rounded
// to bf16 (A read K-major: B(k, n) = A[n][k]), then x1 = x + rnd(o .
// Wproj).  qkv: (B HW, 3 C) bf16 after the stencils, v its last third;
// attn: (B, heads, cph, cph) bf16, the softmax output; wproj (C, C) bf16
// in the (outputs, inputs) layout; x: (B HW, C) bf16.  Outputs: o (scratch)
// and x1, (B HW, C) bf16.  cph % 8 == 0.  Returns a cudaError_t.
int fwd_attn_out(const void* qkv, const void* attn, const void* wproj,
                 const void* x, void* o, void* x1, int B, int HW, int C,
                 int heads, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  int err;
  if ((err = heads_o(qkv, attn, o, B, HW, C, heads, s))) return err;
  return residual_gemm(o, wproj, x, x1, B * HW, C, C, s);
}

// The backward's pass 1 forms o as the forward does: per (image, head)
// o = v . A_h^T rounded to bf16, qkv, attn and o as fwd_attn_out's.
// Returns a cudaError_t.
int attn_heads_o(const void* qkv, const void* attn, void* o, int B, int HW,
                 int C, int heads, void* stream) {
  return heads_o(qkv, attn, o, B, HW, C, heads, (cudaStream_t)stream);
}

// The NAFBlock's biased product: out (M, N) bf16 = rnd(rnd(a . b^T) +
// bias), a (M, K) and b (N, K) contiguous bf16 (b a weight in the kernels'
// (outputs, inputs) layout), bias (N) f32 holding bf16 values; where scale
// (N, f32 holding bf16 values) is set, that value times scale, rounded;
// where res (M, N) bf16 is set, rnd(res + that): conv1's h = rnd(rnd(y .
// W1) + b1) (no scale, no res), y1 = x + rnd(rnd(rnd(gs . W3) + b3) beta)
// and out = y1 + rnd(rnd(rnd(g2 . W5) + b5) gamma).  Returns a cudaError_t.
int naf_gemm_bias(const void* a, const void* b, const float* bias,
                  const float* scale, const void* res, void* out, int M,
                  int N, int K, void* stream) {
  return naf_product(a, b, 1, bias, scale, res, out, M, N, K,
                     (cudaStream_t)stream);
}

// The NAFBlock's gated product: with b (N, K) holding the two halves of
// conv4 in 32-channel chunks (a chunk's first-half outputs, then its
// second-half outputs; N % 64 == 0) and bias (N) in the same order,
// out (M, N / 2) bf16 = rnd(h_a h_b), h_* = rnd(rnd(a . b_*^T) + bias_*):
// g2 of the FFN half.  Returns a cudaError_t.
int naf_gemm_gate(const void* a, const void* b, const float* bias, void* out,
                  int M, int N, int K, void* stream) {
  return naf_product(a, b, 2, bias, nullptr, nullptr, out, M, N, K,
                     (cudaStream_t)stream);
}

}  // extern "C"
