// Standalone GDFN (gated-dconv FFN) forward for Hopper (sm_90a).
//
//   out = (gelu_erf(dw3x3(x . W1)[:h]) * dw3x3(x . W1)[h:]) . W2
//
// It serves float32 (the parity path) and bf16 at C % 8 != 0.  bf16 at
// C % 8 == 0 runs `gdfn_pipeline` (ops/pallas/gdfn.py): bwd_gemm.cu's
// TMA + wgmma products around fwd_stencil.cu's gate stencil, with the
// same rounding points.
//
// Replaces the TPU kernel of textualdegremoval_tpu/ops/pallas/gdfn.py:
// `gdfn_fused` -> `_gdfn_fused_impl` (`_make_kernel`), the GDFN of
// TransformerBlock's module path (`GDFN(fused=True)`).  No residual and no
// LayerNorm: the block adds them around it.  Bias-free only, as there.
//
// One CTA per th x tw output tile.  It reads x on the tile plus a 1-pixel
// halo into shared memory, once: the halo's coordinates are clamped into
// the image (the TPU kernel's clamped halo rows), and the hidden is zeroed
// there after the 1x1, which is the reference's zero padding of the hidden
// tensor.  Then `gdfn_region` (csrc/tblock_fwd.cuh, the GDFN step of the
// whole-block kernel's pass B, shared with it): the hidden in kHC-wide
// chunks, both halves of a chunk from one product, the 3x3 depthwise
// stencil in f32, the gate, and the product back accumulated in an f32
// tile in shared memory.  Only the C-wide output is written; the 2h-wide
// hidden never leaves shared memory.
//
// Rounding points are the TPU kernel's (ops/pallas/gdfn.py:93-134): the
// 1x1 output is rounded to x's dtype, the depthwise sums and the gate are
// f32, the gate is rounded to x's dtype before the W2 product, whose f32
// sum is rounded once at the output.  The plain version
// (ops/pallas/gdfn.py `gdfn_ref`) rounds after every op, as the module
// path does.
//
// What bounds it on the card: the two 1x1 products, 6 C h operations per
// pixel against 36 h for the stencils, so operations, not bytes (C = 96:
// 146 KFLOP per pixel, 4 bytes in and out).  Every CTA reads all of W1 and
// W2 through L2 (C = 96, bf16: 147 KB per tile of 64 pixels), and the
// products run as warp-level mma.sync from shared memory with weight
// fragments from global memory, as in the whole-block kernel.  What the
// design does: the largest tile that fits shared memory (fewer weight
// reads per pixel, a smaller halo share), the f32 accumulator rows padded
// against bank conflicts, every intermediate in shared memory.  wgmma,
// TMA and weights staged in shared memory are left for later work.
//
// Widths: any C and H, W (edge tiles masked); the hidden is zero-padded
// to a multiple of kHC by the wrapper (zero W1 columns and W2 rows).

#include "tblock_fwd.cuh"

namespace {

// Dynamic shared memory of the kernel for a th x tw tile.
__host__ __device__ inline size_t gdfn_smem_bytes(int C, int th, int tw,
                                                  int eb) {
  const int p1 = (th + 2) * (tw + 2), tp = th * tw;
  return (size_t)4 * tp * (C + kAccPad) +
         (size_t)eb * ((size_t)round_up(p1, kRowPad) * smem_ld(C) +
                       (size_t)2 * p1 * kHC +
                       (size_t)round_up(tp, kRowPad) * smem_ld(kHC));
}

// v clamped into [0, n)
__device__ __forceinline__ int clamp_to(int v, int n) {
  return v < 0 ? 0 : (v >= n ? n - 1 : v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2) gdfn_kernel(
    const T* __restrict__ x, const T* __restrict__ w1,
    const float* __restrict__ dwg, const T* __restrict__ w2,
    T* __restrict__ out, int H, int W, int C, int hpad, int th, int tw) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int b = blockIdx.z, oy = blockIdx.y * th, ox = blockIdx.x * tw;
  const int hw = tw + 2, p1 = (th + 2) * hw, tp = th * tw;
  const int ldc = smem_ld(C), lda_acc = C + kAccPad;
  float* acc = reinterpret_cast<float*>(smem_raw);          // [tp][lda_acc]
  T* xs = reinterpret_cast<T*>(acc + (size_t)tp * lda_acc);  // [p1][ldc]
  T* chunk = xs + (size_t)round_up(p1, kRowPad) * ldc;       // 2 p1 kHC
  T* gate = chunk + (size_t)2 * p1 * kHC;                    // [tp][ldg]

  const T* xb = x + (size_t)b * H * W * C;
  for (int idx = threadIdx.x; idx < p1 * C; idx += blockDim.x) {
    const int p = idx / C, c = idx % C;
    const int gy = clamp_to(oy - 1 + p / hw, H);
    const int gx = clamp_to(ox - 1 + p % hw, W);
    xs[(size_t)p * ldc + c] = xb[((size_t)gy * W + gx) * C + c];
  }
  for (int i = threadIdx.x; i < tp * lda_acc; i += blockDim.x) acc[i] = 0.f;
  __syncthreads();

  gdfn_region(xs, ldc, oy, ox, th, tw, H, W, C, hpad, w1, dwg, w2, chunk,
              gate, acc, lda_acc);

  for (int idx = threadIdx.x; idx < tp * C; idx += blockDim.x) {
    const int p = idx / C, n = idx % C;
    const int gy = oy + p / tw, gx = ox + p % tw;
    if (gy < H && gx < W)
      out[(((size_t)b * H + gy) * W + gx) * C + n] =
          from_f<T>(acc[p * lda_acc + n]);
  }
}

template <typename T>
int launch_gdfn(const void* x, const void* w1, const void* dwg,
                const void* w2, void* out, int B, int H, int W, int C,
                int hpad, int th, int tw, cudaStream_t stream) {
  const size_t smem = gdfn_smem_bytes(C, th, tw, sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(
      gdfn_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W + tw - 1) / tw, (H + th - 1) / th, B);
  gdfn_kernel<T><<<grid, kThreads, smem, stream>>>(
      (const T*)x, (const T*)w1, (const float*)dwg, (const T*)w2, (T*)out, H,
      W, C, hpad, th, tw);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory of the kernel for a th x tw tile; the wrapper picks
// the tile with it.
long long gdfn_smem(int C, int th, int tw, int elem_bytes) {
  return (long long)gdfn_smem_bytes(C, th, tw, elem_bytes);
}

// x, out: (B, H, W, C); w1: (2 hpad, C), per hidden chunk of kHC its h1
// rows, then its h2 rows; dwg: (18, hpad) f32, the h1 taps in rows 0-8;
// w2: (C, hpad).  Matrices are (outputs, inputs) for bf16 and (inputs,
// outputs) for float32, as the whole-block kernel takes them.  Returns a
// cudaError_t.
int gdfn_fwd(const void* x, const void* w1, const void* dwg, const void* w2,
             void* out, int B, int H, int W, int C, int hpad, int is_bf16,
             int th, int tw, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || hpad <= 0 || hpad % kHC ||
      th <= 0 || tw <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return launch_gdfn<__nv_bfloat16>(x, w1, dwg, w2, out, B, H, W, C, hpad,
                                      th, tw, s);
  return launch_gdfn<float>(x, w1, dwg, w2, out, B, H, W, C, hpad, th, tw,
                            s);
}

}  // extern "C"
