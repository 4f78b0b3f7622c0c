// Host emulation of the CUDA subset that csrc/*.cu use, so that the kernel
// sources themselves can be compiled with g++ and run on the CPU in the
// tests.  Each CUDA block runs as blockDim.x fibers (ucontext) on the
// calling OS thread, which meet at barriers (__syncthreads, and per warp
// for shuffles and mma): a fiber runs until it reaches a barrier, and a
// round-robin scheduler resumes it once every member has arrived.  One OS
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
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__
#define __align__(x)

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
inline float g_shuffle[1024];

inline void ShimBarrier::arrive_and_wait() {
  ShimFiber& f = g_fibers[g_current];
  f.bar = this;
  f.gen = gen;
  if (++arrived == size) {
    arrived = 0;
    ++gen;
  }
  swapcontext(&f.ctx, &g_scheduler);
}

inline void __syncthreads() { g_block_barrier.arrive_and_wait(); }

inline float __shfl_xor_sync(unsigned, float v, int lane_mask) {
  const int t = threadIdx.x, w = t / 32;
  g_shuffle[t] = v;
  g_warp_barriers[w].arrive_and_wait();
  const float r = g_shuffle[w * 32 + ((t % 32) ^ lane_mask)];
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
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
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
alignas(16) unsigned char smem_raw[kShimSharedBytes];
}

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
  g_fibers.assign(block, ShimFiber{});
  g_fiber_body = [&](int t) {
    for (unsigned z = 0; z < grid.z; ++z)
      for (unsigned y = 0; y < grid.y; ++y)
        for (unsigned x = 0; x < grid.x; ++x) {
          if (t == 0) memset(smem_raw, 0xff, sizeof(smem_raw));
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
