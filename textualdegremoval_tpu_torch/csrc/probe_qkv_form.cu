// Probe of the whole-block kernel's linear + depthwise stage for Hopper
// (sm_90a): y = dw3x3(x . W), one 1x1 product and one 3x3 depthwise
// stencil, in two forms.
//
// Replaces the TPU probe kernels of tools/bench_qkv_form.py: `_run_pallas`
// (:109) running `_kernel_current` (:51) or `_kernel_composed` (:70).
//
//   current:  lin = x . W (K = C) rounded to x's dtype and zeroed outside
//             the image, then the 9-tap stencil in f32 on the CUDA cores.
//             This is the whole-block kernel's own path (csrc/tblock_fwd.cuh
//             pass A: `gemm` into shared memory, then `stencil3x3`).
//   composed: dw3x3(x . W) == X9 . W9, X9 the nine shifted copies of x side
//             by side (K = 9C, zero outside the image) and
//             W9[(tap, ci), co] = W[ci, co] dw[tap, co]: the whole stage as
//             one product on the tensor cores, no stencil.
//
// One CTA per th x tw output tile; a grid over tiles replaces the TPU's
// grid over row tiles (the function is the same, not the block layout).
// bf16 products run on the tensor cores (mma.m16n8k16 through `gemm`),
// f32 products in `gemm`'s FMA loops; sums are f32 in both.
//
// Rounding points are the TPU kernels' (tools/bench_qkv_form.py:51-92):
// current rounds lin to x's dtype after its f32 product and the stencil's
// f32 sum at the output; composed rounds once, at the output, of one f32
// sum over K = 9C.  W9 comes to it in x's dtype (the tool rounds W9 to
// bf16 where the current form rounds lin).
//
// What bounds it on the card: bytes.  x is read and y written once, C + co
// values a pixel, against 2 C co + 18 co operations (48 -> 48: 2 bytes
// per 57 operations in bf16, below the card's 295).  The forms spend
// differently around that: current recomputes the product on a 1-pixel
// ring (1.27x at 16 x 16) and reads each lin value nine times from shared
// memory on the CUDA cores; composed writes every x value nine times into
// shared memory and does 9x the tensor-core work.  W (or W9) is read by
// every CTA through L2.  Which one costs less is the probe's question.

#include "tblock_common.cuh"

namespace {

constexpr int kNC = 64;  // output channels per lin chunk, current form

enum { kCurrent = 0, kComposed = 1 };

// Dynamic shared memory of a th x tw tile: current keeps x on the tile
// plus its halo and one lin chunk; composed keeps X9 on the tile.
__host__ __device__ inline size_t qkv_smem_bytes(int form, int C, int co,
                                                 int th, int tw, int eb) {
  if (form == kCurrent) {
    const int p1 = (th + 2) * (tw + 2), nc = co < kNC ? co : kNC;
    return (size_t)eb * ((size_t)round_up(p1, kRowPad) * smem_ld(C) +
                         (size_t)p1 * nc);
  }
  return (size_t)eb * round_up(th * tw, kRowPad) * smem_ld(9 * C);
}

// v clamped into [0, n)
__device__ __forceinline__ int clamp_to(int v, int n) {
  return v < 0 ? 0 : (v >= n ? n - 1 : v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) qkv_current_kernel(
    const T* __restrict__ x, const T* __restrict__ w,
    const float* __restrict__ dw, T* __restrict__ out, int H, int W, int C,
    int co, int th, int tw) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int b = blockIdx.z, oy = blockIdx.y * th, ox = blockIdx.x * tw;
  const int hw = tw + 2, p1 = (th + 2) * hw, tp = th * tw;
  const int ldc = smem_ld(C), nc = co < kNC ? co : kNC;
  T* xs = reinterpret_cast<T*>(smem_raw);             // [p1][ldc]
  T* lin = xs + (size_t)round_up(p1, kRowPad) * ldc;  // [p1][nc]

  // x on the tile and its halo, at coordinates clamped into the image (the
  // TPU kernel's clamped halo rows): lin is zeroed there below
  const T* xb = x + (size_t)b * H * W * C;
  for (int idx = threadIdx.x; idx < p1 * C; idx += blockDim.x) {
    const int p = idx / C, c = idx % C;
    const int gy = clamp_to(oy - 1 + p / hw, H);
    const int gx = clamp_to(ox - 1 + p % hw, W);
    xs[(size_t)p * ldc + c] = xb[((size_t)gy * W + gx) * C + c];
  }
  __syncthreads();

  for (int c0 = 0; c0 < co; c0 += nc) {
    const int n = co - c0 < nc ? co - c0 : nc;
    gemm(xs, ldc, p1, C, weights(w, co, C, c0, 0), n,
         [&](int q, int j, float a) {
           const int gy = oy - 1 + q / hw, gx = ox - 1 + q % hw;
           lin[q * nc + j] =
               from_f<T>(gy >= 0 && gy < H && gx >= 0 && gx < W ? a : 0.f);
         });
    __syncthreads();
    for (int idx = threadIdx.x; idx < tp * n; idx += blockDim.x) {
      const int p = idx / n, j = idx % n, py = p / tw, px = p % tw;
      const int gy = oy + py, gx = ox + px;
      if (gy < H && gx < W)
        out[(((size_t)b * H + gy) * W + gx) * co + c0 + j] = from_f<T>(
            stencil3x3(lin + j, hw, nc, py, px, dw + c0 + j, co, false));
    }
    __syncthreads();
  }
}

// A 16-byte piece of a row, for the gather's vector copies.
struct alignas(16) Vec16 {
  uint32_t w[4];
};

// X9 on the tile: row p (tile pixel p), columns [tap C, tap C + C) hold x
// at the pixel shifted by tap (dy, dx) - (1, 1), zero outside the image.
// Moved V at a time (V is T, or Vec16 where rows are 16-byte aligned).
template <typename V, typename T>
__device__ void gather_x9(const T* xb, int H, int W, int C, int oy, int ox,
                          int tw, int tp, T* x9, int ldk) {
  constexpr int per = sizeof(V) / sizeof(T);
  const int cv = C / per, row = 9 * cv;
  for (int idx = threadIdx.x; idx < tp * row; idx += blockDim.x) {
    const int p = idx / row, r = idx % row, tap = r / cv, cw = r % cv;
    const int gy = oy + p / tw + tap / 3 - 1, gx = ox + p % tw + tap % 3 - 1;
    const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
    const V v = *reinterpret_cast<const V*>(
        xb + ((size_t)clamp_to(gy, H) * W + clamp_to(gx, W)) * C + cw * per);
    *reinterpret_cast<V*>(x9 + (size_t)p * ldk + tap * C + cw * per) =
        in ? v : V{};
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) qkv_composed_kernel(
    const T* __restrict__ x, const T* __restrict__ w9, T* __restrict__ out,
    int H, int W, int C, int co, int th, int tw) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int b = blockIdx.z, oy = blockIdx.y * th, ox = blockIdx.x * tw;
  const int tp = th * tw, K = 9 * C, ldk = smem_ld(K);
  T* x9 = reinterpret_cast<T*>(smem_raw);  // [round_up(tp, kRowPad)][ldk]

  const T* xb = x + (size_t)b * H * W * C;
  if ((C * sizeof(T)) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(x) % 16 == 0)
    gather_x9<Vec16>(xb, H, W, C, oy, ox, tw, tp, x9, ldk);
  else
    gather_x9<T>(xb, H, W, C, oy, ox, tw, tp, x9, ldk);
  __syncthreads();

  gemm(x9, ldk, tp, K, weights(w9, co, K, 0, 0), co,
       [&](int p, int n, float a) {
         const int gy = oy + p / tw, gx = ox + p % tw;
         if (gy < H && gx < W)
           out[(((size_t)b * H + gy) * W + gx) * co + n] = from_f<T>(a);
       });
}

template <typename T>
int launch_current(const void* x, const void* w, const void* dw, void* out,
                   int B, int H, int W, int C, int co, int th, int tw,
                   cudaStream_t stream) {
  const size_t smem = qkv_smem_bytes(kCurrent, C, co, th, tw, sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(
      qkv_current_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W + tw - 1) / tw, (H + th - 1) / th, B);
  qkv_current_kernel<T><<<grid, kThreads, smem, stream>>>(
      (const T*)x, (const T*)w, (const float*)dw, (T*)out, H, W, C, co, th,
      tw);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_composed(const void* x, const void* w9, void* out, int B, int H,
                    int W, int C, int co, int th, int tw,
                    cudaStream_t stream) {
  const size_t smem = qkv_smem_bytes(kComposed, C, co, th, tw, sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(
      qkv_composed_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W + tw - 1) / tw, (H + th - 1) / th, B);
  qkv_composed_kernel<T><<<grid, kThreads, smem, stream>>>(
      (const T*)x, (const T*)w9, (T*)out, H, W, C, co, th, tw);
  return (int)cudaGetLastError();
}

bool bad_shape(int B, int H, int W, int C, int co, int th, int tw) {
  return B <= 0 || H <= 0 || W <= 0 || C <= 0 || co <= 0 || th <= 0 ||
         tw <= 0;
}

}  // namespace

extern "C" {

// Dynamic shared memory of a th x tw tile of form 0 (current) or 1
// (composed); the wrapper picks the tile with it.
long long probe_qkv_smem(int form, int C, int co, int th, int tw,
                         int elem_bytes) {
  return (long long)qkv_smem_bytes(form, C, co, th, tw, elem_bytes);
}

// x: (B, H, W, C); out: (B, H, W, co); dw: (9, co) f32, taps in (dy, dx)
// order; w: (co, C) for bf16, (C, co) for float32 (the `weights` layout).
// Returns a cudaError_t.
int probe_qkv_current(const void* x, const void* w, const void* dw,
                      void* out, int B, int H, int W, int C, int co,
                      int is_bf16, int th, int tw, void* stream) {
  if (bad_shape(B, H, W, C, co, th, tw)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return launch_current<__nv_bfloat16>(x, w, dw, out, B, H, W, C, co, th,
                                         tw, s);
  return launch_current<float>(x, w, dw, out, B, H, W, C, co, th, tw, s);
}

// x: (B, H, W, C); out: (B, H, W, co); w9: (co, 9C) for bf16, (9C, co) for
// float32, rows (tap, ci) in (dy, dx, ci) order.  Returns a cudaError_t.
int probe_qkv_composed(const void* x, const void* w9, void* out, int B,
                       int H, int W, int C, int co, int is_bf16, int th,
                       int tw, void* stream) {
  if (bad_shape(B, H, W, C, co, th, tw)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return launch_composed<__nv_bfloat16>(x, w9, out, B, H, W, C, co, th, tw,
                                          s);
  return launch_composed<float>(x, w9, out, B, H, W, C, co, th, tw, s);
}

}  // extern "C"
