// Host side: tensor maps of any 4-D view of a bf16 or f32 tensor, with the
// 128-byte swizzle (operands of wgmma) or without it (tiles that CUDA-core
// code reads by plain indexing), for the TMA loads of hopper.cuh
// (`tma_load`).  The block-backward kernels (bwd_gemm.cu, bwd_stencil.cu)
// describe every operand with one of these: a halo tile of an NHWC image
// is one box of the (C, W, H, B) view, a head's channels of a pixel-major
// matrix one box of the (cph, heads, HW, B) view, and elements outside the
// view arrive as zeros.
//
// Everything lives in an anonymous namespace: each .cu includes its own
// copy.  The host build used by the tests (tests/cuda_host_shim.h) supplies
// cuTensorMapEncodeTiled's host version.
#pragma once

#include "hopper.cuh"

namespace {

// A 4-D view: element (i0, i1, i2, i3) at base + i0 + i1 s1 + i2 s2 + i3 s3
// (strides in elements; i0 contiguous), boxes of box[0] x ... x box[3].
struct View4 {
  const void* base;
  long long dim[4];
  long long stride[3];
  int box[4];
};

// Encodes the map of `v` (bf16 elements unless f32), swizzled or not.
// Returns a cudaError_t: the CUDA driver refuses a base or stride that is
// not a multiple of 16 bytes, a box dimension past 256 and, under the
// swizzle, a box row wider than 128 bytes.  The last 64 maps of the calling
// thread are kept (the caching allocator hands back the same addresses
// call after call, and an encoding costs microseconds of host time).
inline int view_map(CUtensorMap* map, const View4& v, bool f32,
                    bool swizzle) {
  struct Key {
    View4 v;
    int f32, swizzle;
  };
  struct Entry {
    Key key;
    CUtensorMap map;
  };
  constexpr int kKept = 64;
  thread_local Entry kept[kKept];
  thread_local int n_kept = 0, next = 0;
  Key key;
  memset(&key, 0, sizeof(key));
  key.v = v;
  key.f32 = f32;
  key.swizzle = swizzle;
  for (int j = 1; j <= n_kept; ++j) {  // the newest first
    const Entry& e = kept[(next - j + kKept) % kKept];
    if (memcmp(&e.key, &key, sizeof(key)) == 0) {
      *map = e.map;
      return 0;
    }
  }
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const long long eb = f32 ? 4 : 2;
  const cuuint64_t dim[4] = {(cuuint64_t)v.dim[0], (cuuint64_t)v.dim[1],
                             (cuuint64_t)v.dim[2], (cuuint64_t)v.dim[3]};
  const cuuint64_t stride[3] = {(cuuint64_t)(v.stride[0] * eb),
                                (cuuint64_t)(v.stride[1] * eb),
                                (cuuint64_t)(v.stride[2] * eb)};
  const cuuint32_t box[4] = {(cuuint32_t)v.box[0], (cuuint32_t)v.box[1],
                             (cuuint32_t)v.box[2], (cuuint32_t)v.box[3]};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = fn(
      map,
      f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      4, const_cast<void*>(v.base), dim, stride, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE,
      swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return (int)cudaErrorInvalidValue;
  kept[next] = Entry{key, *map};
  next = (next + 1) % kKept;
  if (n_kept < kKept) ++n_kept;
  return 0;
}

// The (C, W, H, B) view of a contiguous NHWC image batch, boxes of `cols`
// channels on a bw x bh window.
inline View4 nhwc_view(const void* base, int B, int H, int W, int C,
                       int cols, int bw, int bh) {
  return View4{base,
               {C, W, H, B},
               {C, (long long)C * W, (long long)C * W * H},
               {cols, bw, bh, 1}};
}

}  // namespace
