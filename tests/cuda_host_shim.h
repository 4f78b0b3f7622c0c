// Host emulation of the CUDA subset that csrc/*.cu use, so that the kernel
// sources themselves can be compiled with g++ and run on the CPU in the
// tests.  Each CUDA block runs as blockDim.x fibers (ucontext) on the
// calling OS thread, which meet at barriers (__syncthreads, per warp for
// shuffles and mma, per warpgroup for wgmma, named barriers) or spin on
// mbarriers: a fiber runs until it reaches a barrier, and a round-robin
// scheduler resumes it once every member has arrived.  One OS
// thread keeps a launch cheap and its result independent of how busy the
// host is.  Blocks run one after the other, so one static buffer serves as
// the block's dynamic shared memory.  The buffer is filled with NaN bit
// patterns before every block, so a kernel that reads shared memory it
// never wrote shows up in the results.
#pragma once
#include <math.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <ucontext.h>

#include <cstddef>
#include <functional>
#include <memory>
#include <unordered_map>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__
#define __align__(x)
#define __grid_constant__

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
// set by the scheduler before it resumes a fiber
inline dim3 threadIdx, blockIdx;
inline dim3 blockDim, gridDim;

struct ShimBarrier {
  int size = 0, arrived = 0;
  unsigned gen = 0;  // completed rounds
  void arrive() {
    if (++arrived == size) {
      arrived = 0;
      ++gen;
    }
  }
  void arrive_and_wait();
};
struct ShimFiber {
  ucontext_t ctx;
  const ShimBarrier* bar = nullptr;  // waited on, until bar->gen != gen
  unsigned gen = 0;
  bool done = false;
};
inline std::vector<ShimFiber> g_fibers;
inline ucontext_t g_scheduler;
inline int g_current = 0;
inline ShimBarrier g_block_barrier;
inline std::vector<ShimBarrier> g_warp_barriers;
inline std::vector<ShimBarrier> g_wg_barriers;  // per warpgroup of 128
inline ShimBarrier g_named_barriers[16];        // bar.sync ids, per block
inline float g_shuffle[1024];

inline void ShimBarrier::arrive_and_wait() {
  ShimFiber& f = g_fibers[g_current];
  f.bar = this;
  f.gen = gen;
  arrive();
  swapcontext(&f.ctx, &g_scheduler);
}

inline void __syncthreads() { g_block_barrier.arrive_and_wait(); }
inline int __shfl_sync(unsigned, int v, int src_lane) {
  const int t = threadIdx.x, w = t / 32;
  memcpy(&g_shuffle[t], &v, 4);
  g_warp_barriers[w].arrive_and_wait();
  int r;
  memcpy(&r, &g_shuffle[w * 32 + src_lane], 4);
  g_warp_barriers[w].arrive_and_wait();
  return r;
}
inline void __syncwarp(unsigned = 0xffffffffu) {
  g_warp_barriers[threadIdx.x / 32].arrive_and_wait();
}

inline float __shfl_xor_sync(unsigned, float v, int lane_mask) {
  const int t = threadIdx.x, w = t / 32;
  g_shuffle[t] = v;
  g_warp_barriers[w].arrive_and_wait();
  const float r = g_shuffle[w * 32 + ((t % 32) ^ lane_mask)];
  g_warp_barriers[w].arrive_and_wait();
  return r;
}
inline unsigned __shfl_xor_sync(unsigned, unsigned v, int lane_mask) {
  const int t = threadIdx.x, w = t / 32;
  memcpy(&g_shuffle[t], &v, 4);
  g_warp_barriers[w].arrive_and_wait();
  unsigned r;
  memcpy(&r, &g_shuffle[w * 32 + ((t % 32) ^ lane_mask)], 4);
  g_warp_barriers[w].arrive_and_wait();
  return r;
}

struct __nv_bfloat16 {
  uint16_t bits;
};
inline float __bfloat162float(__nv_bfloat16 v) {
  const uint32_t u = (uint32_t)v.bits << 16;
  float f;
  memcpy(&f, &u, 4);
  return f;
}
inline __nv_bfloat16 __float2bfloat16(float f) {  // round to nearest even
  uint32_t u;
  memcpy(&u, &f, 4);
  if ((u & 0x7fffffffu) > 0x7f800000u)
    return __nv_bfloat16{(uint16_t)((u >> 16) | 0x40)};
  return __nv_bfloat16{(uint16_t)((u + 0x7fffu + ((u >> 16) & 1u)) >> 16)};
}

// The warp-level tensor-core product mma.sync.m16n8k16 (bf16 in, f32
// sums), with the PTX ISA's fragment layout: each lane deposits its
// fragments, and every lane then computes its four outputs from the whole
// warp's.  The kernel source calls this in place of its inline PTX when
// TBLOCK_HOST_BUILD is defined.
#define TBLOCK_HOST_BUILD 1
inline uint32_t g_mma_a[1024][4];
inline uint32_t g_mma_b[1024][2];

inline float bf16_half(uint32_t word, int high) {
  return __bfloat162float(
      __nv_bfloat16{(uint16_t)(high ? word >> 16 : word & 0xffffu)});
}

inline void host_mma_16816(float (&d)[4], const uint32_t (&a)[4],
                           const uint32_t (&b)[2]) {
  const int t = threadIdx.x, w = t / 32, lane = t % 32, base = w * 32;
  for (int i = 0; i < 4; ++i) g_mma_a[t][i] = a[i];
  for (int i = 0; i < 2; ++i) g_mma_b[t][i] = b[i];
  g_warp_barriers[w].arrive_and_wait();
  // A (16 x 16, row-major): lane g*4 + tig holds rows g and g+8, columns
  // tig*2, tig*2+1 and those + 8; B (16 x 8, column-major): lane g*4 + tig
  // holds column g, rows tig*2, tig*2+1 and those + 8
  auto A = [&](int row, int k) {
    const int src = base + (row % 8) * 4 + (k % 8) / 2;
    return bf16_half(g_mma_a[src][(row >= 8 ? 1 : 0) + (k >= 8 ? 2 : 0)],
                     k & 1);
  };
  auto B = [&](int k, int col) {
    const int src = base + col * 4 + (k % 8) / 2;
    return bf16_half(g_mma_b[src][k >= 8 ? 1 : 0], k & 1);
  };
  const int g = lane >> 2, tig = lane & 3;
  float out[4];
  for (int i = 0; i < 4; ++i) {
    const int row = g + (i >= 2 ? 8 : 0), col = tig * 2 + (i & 1);
    float s = d[i];
    for (int k = 0; k < 16; ++k) s += A(row, k) * B(k, col);
    out[i] = s;
  }
  g_warp_barriers[w].arrive_and_wait();
  for (int i = 0; i < 4; ++i) d[i] = out[i];
}

// Packed bf16 arithmetic (mul.rn.bf16x2, add.rn.bf16x2): two bf16 in a
// 32-bit word, each half computed in f32 and rounded to bf16 (a product of
// two bf16 is exact in f32).  The kernel source calls these in place of
// its inline PTX when TBLOCK_HOST_BUILD is defined.
template <typename Op>
inline uint32_t host_bf16x2(uint32_t a, uint32_t b, Op op) {
  uint32_t d = 0;
  for (int h = 0; h < 2; ++h) {
    const float r = op(bf16_half(a, h), bf16_half(b, h));
    d |= (uint32_t)__float2bfloat16(r).bits << (16 * h);
  }
  return d;
}
inline uint32_t host_bf16x2_mul(uint32_t a, uint32_t b) {
  return host_bf16x2(a, b, [](float u, float v) { return u * v; });
}
inline uint32_t host_bf16x2_add(uint32_t a, uint32_t b) {
  return host_bf16x2(a, b, [](float u, float v) { return u + v; });
}

typedef void* cudaStream_t;
enum cudaError_t {
  cudaSuccess = 0,
  cudaErrorInvalidValue = 1,
  cudaErrorNotSupported = 801
};
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
constexpr int kShimSharedBytes = 232448;  // H100 per-block maximum

template <typename F>
cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int bytes) {
  return bytes <= kShimSharedBytes ? cudaSuccess : cudaErrorInvalidValue;
}
// one block at a time, as the shim runs them
template <typename F>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, F, int,
                                                          size_t smem) {
  *n = smem <= (size_t)kShimSharedBytes ? 1 : 0;
  return cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline const char* cudaGetErrorString(cudaError_t e) {
  return e == cudaSuccess ? "no error" : "invalid argument";
}

// Found by the kernels' block-scope `extern __shared__ ... smem_raw[]`,
// which the macros above turn into a plain extern declaration in the
// anonymous namespace of the kernel source.
namespace {
alignas(1024) unsigned char smem_raw[kShimSharedBytes];
}

// ---------------------------------------------------------------------------
// Hopper subset (textualdegremoval_tpu_torch/csrc/hopper.cuh): warpgroup
// products, mbarriers, TMA tile loads and tensor maps.  A product runs when
// it is issued (the card runs it asynchronously until the wait); the
// fence, commit and wait are barriers of the warpgroup's 128 threads.  A
// TMA load copies its box at once and completes its bytes on the mbarrier.
// try_wait yields the fiber while the phase is open, so that a spinning
// consumer lets the producer run.  Everything that touches shared memory
// lives in the anonymous namespace, beside this source's own smem_raw.
// ---------------------------------------------------------------------------

namespace {

inline size_t __cvta_generic_to_shared(const void* p) {
  return (size_t)((const unsigned char*)p - smem_raw);
}

inline void host_wg_sync() {
  g_wg_barriers[threadIdx.x / 128].arrive_and_wait();
}

// bar.sync / bar.arrive on named barrier `id` of `count` threads
inline void host_named_barrier(int id, int count, bool wait) {
  ShimBarrier& b = g_named_barriers[id];
  if (b.size == 0) b.size = count;
  if (wait)
    b.arrive_and_wait();
  else
    b.arrive();
}

// the 128-byte swizzle of a shared-memory byte offset: address bits 4-6
// (the 16-byte chunk) XOR bits 7-9 (the row within a group of 8 rows)
inline uint32_t shim_swizzle128(uint32_t byte) {
  return byte ^ (((byte >> 7) & 7u) << 4);
}

struct ShimDesc {
  uint32_t addr, lbo, sbo;
};
inline ShimDesc shim_decode(uint64_t d) {
  if ((d >> 62) != 1) {
    fprintf(stderr, "cuda_host_shim: wgmma descriptor without the 128-byte "
                    "swizzle\n");
    abort();
  }
  return {(uint32_t)(d & 0x3fffu) << 4, (uint32_t)((d >> 16) & 0x3fffu) << 4,
          (uint32_t)((d >> 32) & 0x3fffu) << 4};
}

// element (mn, k) of a wgmma operand (k < 16) read through its descriptor:
// K-major, rows of MN at 128 bytes in groups of 8 at sbo; MN-major, rows
// of K holding 64 MN values, groups of 8 K rows at sbo, 64-wide MN boxes
// at lbo
inline float shim_operand(const ShimDesc& s, int mn, int k, bool mn_major) {
  const uint32_t off =
      mn_major ? (mn % 64) * 2 + (mn / 64) * s.lbo + (k % 8) * 128 +
                     (k / 8) * s.sbo
               : (mn % 8) * 128 + (mn / 8) * s.sbo + k * 2;
  uint16_t bits;
  memcpy(&bits, smem_raw + shim_swizzle128(s.addr + off), 2);
  return __bfloat162float(__nv_bfloat16{bits});
}

// wgmma.mma_async m64nNk16 (bf16 in, f32 sums) for the calling thread's
// accumulator entries; A from the descriptor da (K-major, or MN-major
// where trans_a is set) or, where a is given, from the registers of the
// thread's warp (m16n8k16 A layout).
template <int N>
inline void host_wgmma(float (&d)[N / 2], const uint32_t* a, uint64_t da,
                       uint64_t db, int scale_d, int trans_b,
                       int trans_a = 0) {
  const int t = threadIdx.x, w = (t % 128) / 32, lane = t % 32;
  const int g = lane >> 2, tig = lane & 3;
  float arow[2][16];
  if (a != nullptr) {
    const int wi = t / 32;
    for (int i = 0; i < 4; ++i) g_mma_a[t][i] = a[i];
    g_warp_barriers[wi].arrive_and_wait();
    for (int h = 0; h < 2; ++h)
      for (int k = 0; k < 16; ++k)
        arow[h][k] = bf16_half(
            g_mma_a[wi * 32 + g * 4 + (k % 8) / 2][h + (k >= 8 ? 2 : 0)],
            k & 1);
    g_warp_barriers[wi].arrive_and_wait();
  } else {
    const ShimDesc sa = shim_decode(da);
    for (int h = 0; h < 2; ++h)
      for (int k = 0; k < 16; ++k)
        arow[h][k] = shim_operand(sa, 16 * w + g + 8 * h, k,
                                  trans_a != 0);
  }
  const ShimDesc sb = shim_decode(db);
  for (int j = 0; j < N / 8; ++j)
    for (int c = 0; c < 2; ++c) {
      float bcol[16];
      for (int k = 0; k < 16; ++k)
        bcol[k] = shim_operand(sb, 8 * j + 2 * tig + c, k, trans_b != 0);
      for (int h = 0; h < 2; ++h) {
        float s = scale_d ? d[4 * j + 2 * h + c] : 0.f;
        for (int k = 0; k < 16; ++k) s += arow[h][k] * bcol[k];
        d[4 * j + 2 * h + c] = s;
      }
    }
}

// mbarriers, kept beside shared memory by address (cleared per block)
struct ShimMbar {
  int expected, pending;
  long long tx;
  unsigned phase;
};
inline std::unordered_map<uint32_t, ShimMbar> g_mbars;
inline long long g_fruitless_waits = 0;

inline ShimMbar& shim_mbar(uint32_t addr) {
  auto it = g_mbars.find(addr);
  if (it == g_mbars.end()) {
    fprintf(stderr, "cuda_host_shim: mbarrier used before its init\n");
    abort();
  }
  return it->second;
}
inline void shim_mbar_settle(ShimMbar& m) {
  if (m.pending < 0 || m.tx < 0) {
    fprintf(stderr, "cuda_host_shim: mbarrier over-arrived\n");
    abort();
  }
  if (m.pending == 0 && m.tx == 0) {
    m.phase ^= 1u;
    m.pending = m.expected;
  }
}
inline void host_mbar_init(uint32_t addr, int count) {
  g_mbars[addr] = ShimMbar{count, count, 0, 0};
}
// one arrival, after expecting `tx` more bytes in this phase
inline void host_mbar_arrive(uint32_t addr, uint32_t tx) {
  ShimMbar& m = shim_mbar(addr);
  m.tx += tx;
  --m.pending;
  shim_mbar_settle(m);
}
inline void host_mbar_complete_tx(uint32_t addr, uint32_t bytes) {
  ShimMbar& m = shim_mbar(addr);
  m.tx -= bytes;
  shim_mbar_settle(m);
}
inline bool host_mbar_try_wait(uint32_t addr, uint32_t parity) {
  if (shim_mbar(addr).phase != parity) {
    g_fruitless_waits = 0;
    return true;
  }
  if (++g_fruitless_waits > 10000000) {
    fprintf(stderr, "cuda_host_shim: every thread waits on an mbarrier\n");
    abort();
  }
  ShimFiber& f = g_fibers[g_current];
  f.bar = nullptr;
  swapcontext(&f.ctx, &g_scheduler);
  return false;
}

// tensor maps: the fields the host TMA reads
typedef uint32_t cuuint32_t;
typedef uint64_t cuuint64_t;
enum CUresult { CUDA_SUCCESS = 0, CUDA_ERROR_INVALID_VALUE = 1 };
enum CUtensorMapDataType {
  CU_TENSOR_MAP_DATA_TYPE_FLOAT32 = 7,
  CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 = 9
};
enum CUtensorMapInterleave { CU_TENSOR_MAP_INTERLEAVE_NONE = 0 };
enum CUtensorMapSwizzle {
  CU_TENSOR_MAP_SWIZZLE_NONE = 0,
  CU_TENSOR_MAP_SWIZZLE_128B = 3
};
enum CUtensorMapL2promotion { CU_TENSOR_MAP_L2_PROMOTION_L2_128B = 2 };
enum CUtensorMapFloatOOBfill { CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE = 0 };
struct CUtensorMap {
  const unsigned char* base;
  int rank, swizzle128, elem_bytes;
  uint64_t dim[5], stride[5];  // stride[i]: bytes per step of dim i
  uint32_t box[5];
};

// cuTensorMapEncodeTiled for bf16 and f32, with the CUDA driver's checks on
// what the kernels pass: a 16-byte aligned base, strides multiples of 16
// bytes, boxes of 1-256 whose inner row is a multiple of 16 bytes and, under
// the 128-byte swizzle, at most 128 bytes
inline CUresult shim_encode_tiled(
    CUtensorMap* m, CUtensorMapDataType type, cuuint32_t rank, void* addr,
    const cuuint64_t* dim, const cuuint64_t* strides, const cuuint32_t* box,
    const cuuint32_t* elem_strides, CUtensorMapInterleave,
    CUtensorMapSwizzle swizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill) {
  if (rank < 1 || rank > 5 || (uintptr_t)addr % 16 != 0)
    return CUDA_ERROR_INVALID_VALUE;
  m->base = (const unsigned char*)addr;
  m->rank = (int)rank;
  m->swizzle128 = swizzle == CU_TENSOR_MAP_SWIZZLE_128B;
  m->elem_bytes = type == CU_TENSOR_MAP_DATA_TYPE_FLOAT32 ? 4 : 2;
  for (cuuint32_t i = 0; i < rank; ++i) {
    if (dim[i] < 1 || box[i] < 1 || box[i] > 256 || elem_strides[i] != 1)
      return CUDA_ERROR_INVALID_VALUE;
    m->dim[i] = dim[i];
    m->box[i] = box[i];
    m->stride[i] = i == 0 ? m->elem_bytes : strides[i - 1];
    if (i > 0 && (m->stride[i] % 16 != 0 || m->stride[i] >= (1ull << 40)))
      return CUDA_ERROR_INVALID_VALUE;
  }
  const cuuint32_t row = box[0] * m->elem_bytes;
  if (row % 16 != 0 || (m->swizzle128 && row > 128))
    return CUDA_ERROR_INVALID_VALUE;
  return CUDA_SUCCESS;
}

enum cudaDriverEntryPointQueryResult { cudaDriverEntryPointSuccess = 0 };
constexpr unsigned long long cudaEnableDefault = 0;
inline cudaError_t cudaGetDriverEntryPoint(
    const char* symbol, void** fn, unsigned long long,
    cudaDriverEntryPointQueryResult* status) {
  *fn = strcmp(symbol, "cuTensorMapEncodeTiled") == 0
            ? (void*)&shim_encode_tiled
            : nullptr;
  if (status != nullptr) *status = cudaDriverEntryPointSuccess;
  return *fn != nullptr ? cudaSuccess : cudaErrorInvalidValue;
}

// cp.async.bulk.tensor (tile mode) at coordinates c: the box in row-major
// order (dimension 0 fastest) into shared memory at dst, 128-byte swizzled
// where the map says so, elements outside the tensor as zeros; then the
// box's bytes complete on the mbarrier
inline void host_tma_load(uint32_t dst, const CUtensorMap* m, uint32_t bar,
                          const int* c) {
  uint64_t total = 1;
  for (int i = 0; i < m->rank; ++i) total *= m->box[i];
  for (uint64_t e = 0; e < total; ++e) {
    uint64_t rest = e, off = 0;
    bool inside = true;
    for (int i = 0; i < m->rank; ++i) {
      const long long x = (long long)c[i] + (long long)(rest % m->box[i]);
      rest /= m->box[i];
      inside = inside && x >= 0 && (uint64_t)x < m->dim[i];
      off += (uint64_t)x * m->stride[i];
    }
    const int eb = m->elem_bytes;
    uint32_t byte = dst + (uint32_t)e * eb;
    if (m->swizzle128) byte = shim_swizzle128(byte);
    if (inside)
      memcpy(smem_raw + byte, m->base + off, eb);
    else
      memset(smem_raw + byte, 0, eb);
  }
  host_mbar_complete_tx(bar, (uint32_t)total * m->elem_bytes);
}

}  // namespace

inline std::function<void(int)> g_fiber_body;

inline void shim_fiber_entry() {
  const int t = g_current;
  g_fiber_body(t);
  g_fibers[t].done = true;  // uc_link returns to the scheduler
}

// Stands in for `kernel<<<grid, block, smem, stream>>>(args...)`.
template <typename K, typename... A>
void shim_launch(dim3 grid, int block, size_t, cudaStream_t, K kernel,
                 A... args) {
  // 256 KiB per fiber, far above the kernels' frames; left uninitialised,
  // so the pages a fiber never touches are never committed
  constexpr size_t kStack = 256 << 10;
  static std::unique_ptr<char[]> stacks;
  static int n_stacks = 0;
  if (n_stacks < block) {
    stacks.reset(new char[kStack * block]);
    n_stacks = block;
  }
  blockDim = dim3(block);
  gridDim = grid;
  g_block_barrier = ShimBarrier{block};
  g_warp_barriers.assign((block + 31) / 32, ShimBarrier{32});
  g_wg_barriers.clear();
  for (int w = 0; w < block; w += 128)
    g_wg_barriers.push_back(ShimBarrier{block - w < 128 ? block - w : 128});
  g_fibers.assign(block, ShimFiber{});
  g_fiber_body = [&](int t) {
    for (unsigned z = 0; z < grid.z; ++z)
      for (unsigned y = 0; y < grid.y; ++y)
        for (unsigned x = 0; x < grid.x; ++x) {
          if (t == 0) {
            memset(smem_raw, 0xff, sizeof(smem_raw));
            g_mbars.clear();
            for (ShimBarrier& nb : g_named_barriers) nb = ShimBarrier{};
          }
          g_block_barrier.arrive_and_wait();
          blockIdx = dim3(x, y, z);
          kernel(args...);
          g_block_barrier.arrive_and_wait();
        }
  };
  for (int t = 0; t < block; ++t) {
    ShimFiber& f = g_fibers[t];
    getcontext(&f.ctx);
    f.ctx.uc_stack.ss_sp = stacks.get() + kStack * t;
    f.ctx.uc_stack.ss_size = kStack;
    f.ctx.uc_link = &g_scheduler;
    makecontext(&f.ctx, shim_fiber_entry, 0);
  }
  for (int left = block; left > 0;) {
    bool ran = false;
    for (int t = 0; t < block; ++t) {
      ShimFiber& f = g_fibers[t];
      if (f.done || (f.bar != nullptr && f.bar->gen == f.gen)) continue;
      f.bar = nullptr;
      g_current = t;
      threadIdx = dim3(t);
      swapcontext(&g_scheduler, &f.ctx);
      ran = true;
      left -= f.done;
    }
    if (!ran) {
      fprintf(stderr, "cuda_host_shim: every thread waits at a barrier\n");
      abort();
    }
  }
}
