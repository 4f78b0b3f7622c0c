// Hopper (sm_90a) primitives of the bf16 kernels (flash_attn.cu,
// flash_attn_bwd.cu, bwd_gemm.cu, wgrad.cu and the stencils):
// warpgroup products (wgmma, each operand K-major or MN-major) with their
// shared-memory descriptors and fence / commit / wait, named barriers,
// mbarriers, TMA tile loads, and the host-side encoding of a tensor map
// over a BNHD view.
//
// Shared-memory tiles are written by TMA with the 128-byte swizzle and
// read by wgmma through descriptors of the same swizzle: a tile is rows of
// 64 bf16 (128 bytes), stacked in 1024-byte groups of 8 rows, and the
// 16-byte chunk c of row r sits at chunk c ^ (r % 8).  Tiles start at a
// 1024-byte boundary.  A row wider than 64 (D = 128) is two such tiles,
// one after the other ("boxes").
//
// Everything lives in an anonymous namespace: each .cu includes its own
// copy.  The host build used by the tests (tests/cuda_host_shim.h)
// defines TBLOCK_HOST_BUILD and supplies a host version of each
// primitive.
#pragma once

#ifndef TBLOCK_HOST_BUILD
#include <cuda.h>
#include <cuda_runtime.h>
#endif

#include <stdint.h>
#include <string.h>

namespace {

// the calling thread's warpgroup (threadIdx.x / 128), as a value the
// compiler knows to be the same across the warp: a branch on it is not
// divergent, so the warpgroup products after it are not serialised
__device__ __forceinline__ int warpgroup_index() {
  return __shfl_sync(0xffffffffu, (int)threadIdx.x >> 7, 0);
}

// shared-memory address of a generic pointer into shared memory
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// ---------------------------------------------------------------------------
// wgmma: D (64 x N, f32, registers) += A (64 x 16) . B (16 x N), bf16
// ---------------------------------------------------------------------------

// Descriptor of a 128-byte-swizzled operand at shared address `addr`.
// K-major (rows of the operand's M or N dimension, 16 K values at
// addr + 32 k bytes within the row): sbo = 1024, the stride between groups
// of 8 rows; lbo unused.  MN-major (rows of 64 M or N values, one row per
// K index; the transpose bit): sbo = 1024, the stride between groups of 8
// K rows, lbo = the stride between 64-wide boxes along M or N.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3ffffu) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3fffu) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3fffu) << 32) | (1ull << 62);
}

// Before the first wgmma of a product, and after any other instruction
// wrote its accumulator or A registers.
__device__ __forceinline__ void wgmma_fence() {
#ifdef TBLOCK_HOST_BUILD
  host_wg_sync();
#else
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#endif
}

__device__ __forceinline__ void wgmma_commit() {
#ifdef TBLOCK_HOST_BUILD
  host_wg_sync();
#else
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
#endif
}

// every committed product of this warp done (its registers and the shared
// memory it read free)
__device__ __forceinline__ void wgmma_wait() {
#ifdef TBLOCK_HOST_BUILD
  host_wg_sync();
#else
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#endif
}

// Keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous product (after wgmma_wait, before the next use).
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#ifndef TBLOCK_HOST_BUILD
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
#endif
}

// Accumulator layout (as mma.sync m16n8 per n-tile): thread t of the
// warpgroup, warp w = t / 32, g = lane / 4, tig = lane % 4; d[4 j + 2 h + c]
// is row 16 w + g + 8 h, column 8 j + 2 tig + c.  A in registers (RS) has
// the m16n8k16 A layout per warp: a[h + 2 kh] holds row 16 w + g + 8 h,
// columns 8 kh + 2 tig and + 1 (lo, hi).
// scale_d = 0: D = A . B, the accumulator's old value ignored.

// A and B from shared memory; each K-major (kTransA / kTransB 0) or
// MN-major (1: rows of K, the operand's transpose bit set)
template <int N, int kTransB, int kTransA = 0>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int scale_d) {
  static_assert(N == 32 || N == 64 || N == 128 || N == 192 || N == 256,
                "wgmma width");
#ifdef TBLOCK_HOST_BUILD
  host_wgmma<N>(d, nullptr, da, db, scale_d, kTransB, kTransA);
#else
  if constexpr (N == 32) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p, 1, 1, %19, %20;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(da), "l"(db), "r"(scale_d), "n"(kTransA), "n"(kTransB));
  } else if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(scale_d), "n"(kTransA), "n"(kTransB));
  } else if constexpr (N == 128) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(scale_d), "n"(kTransA), "n"(kTransB));
  } else if constexpr (N == 192) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
        "}, %96, %97, p, 1, 1, %99, %100;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
          "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
          "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
          "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
        : "l"(da), "l"(db), "r"(scale_d), "n"(kTransA), "n"(kTransB));
  } else if constexpr (N == 256) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
        "}, %128, %129, p, 1, 1, %131, %132;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
          "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
          "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
          "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
          "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
          "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
          "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
          "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
          "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "l"(da), "l"(db), "r"(scale_d), "n"(kTransA), "n"(kTransB));
  }
#endif
}

// A from registers, B from shared memory
template <int N, int kTransB>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  static_assert(N == 32 || N == 64 || N == 128, "wgmma width");
#ifdef TBLOCK_HOST_BUILD
  host_wgmma<N>(d, a, 0, db, scale_d, kTransB);
#else
  if constexpr (N == 32) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(scale_d), "n"(kTransB));
  } else if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(scale_d), "n"(kTransB));
  } else if constexpr (N == 128) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(scale_d), "n"(kTransB));
  }
#endif
}

// Named barrier `id` (1-15; 0 is __syncthreads) of `count` threads (a
// multiple of 32): named_sync waits until `count` threads have arrived,
// named_arrive counts the calling thread and goes on.
__device__ __forceinline__ void named_sync(int id, int count) {
#ifdef TBLOCK_HOST_BUILD
  host_named_barrier(id, count, true);
#else
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
#endif
}

__device__ __forceinline__ void named_arrive(int id, int count) {
#ifdef TBLOCK_HOST_BUILD
  host_named_barrier(id, count, false);
#else
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
#endif
}

// ---------------------------------------------------------------------------
// mbarriers (64-bit, in shared memory) and TMA
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
#ifdef TBLOCK_HOST_BUILD
  host_mbar_init(smem_addr(bar), count);
#else
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
#endif
}

// makes the initialised barriers visible to the TMA unit (then a
// __syncthreads makes them visible to the other threads)
__device__ __forceinline__ void mbar_init_fence() {
#ifndef TBLOCK_HOST_BUILD
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
#endif
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
#ifdef TBLOCK_HOST_BUILD
  host_mbar_arrive(smem_addr(bar), 0);
#else
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
#endif
}

// arrive, and expect `bytes` more from TMA loads in this phase
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
#ifdef TBLOCK_HOST_BUILD
  host_mbar_arrive(smem_addr(bar), bytes);
#else
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
#endif
}

// Spins until the phase of this parity has completed.  On the card the
// loop runs inside one asm statement, so the compiler sees no divergent
// path around the products that follow; a wait past 4 s (a load that
// never lands, not a slow one: a stage takes microseconds) traps, so that
// a fault ends the launch with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
#ifdef TBLOCK_HOST_BUILD
  while (!host_mbar_try_wait(smem_addr(bar), parity)) {
  }
#else
  asm volatile(
      "{\n.reg .pred p;\n.reg .u64 t0, t;\n"
      "mov.u64 t0, %%globaltimer;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "mov.u64 t, %%globaltimer;\n"
      "sub.u64 t, t, t0;\n"
      "setp.gt.u64 p, t, 4000000000;\n"
      "@p trap;\n"
      "bra WAIT;\n"
      "DONE:\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
#endif
}

// One box of a 4-D tensor map (d, n, h, b) at those coordinates into
// shared memory, completing its bytes on `bar`.  Elements outside the
// tensor arrive as zeros.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int d, int n, int h,
                                         int b) {
#ifdef TBLOCK_HOST_BUILD
  const int c[4] = {d, n, h, b};
  host_tma_load(smem_addr(dst), map, smem_addr(bar), c);
#else
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(
          smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(d),
      "r"(n), "r"(h), "r"(b)
      : "memory");
#endif
}

// ---------------------------------------------------------------------------
// host side: the tensor map of a bf16 (B, N, H, D) view
// ---------------------------------------------------------------------------

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                   cuuint32_t, void*, const cuuint64_t*,
                                   const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave,
                                   CUtensorMapSwizzle, CUtensorMapL2promotion,
                                   CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, a CUDA driver function, taken through the runtime
// (nothing more to link); null where the CUDA driver lacks it
inline EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

// The map of a bf16 view whose element (b, n, h, d) is at
// base + b*sb + n*sn + h*sh + d (strides in elements): dimensions
// (D, N, H, B), boxes of 64 x `rows` x 1 x 1 with the 128-byte swizzle.
// Returns a cudaError_t (the CUDA driver refuses a base or stride that is not a
// multiple of 16 bytes).  The CUDA driver's encoding costs microseconds of host
// time a map, and pipeline A calls with the same views again and again
// (the caching allocator hands back the same addresses), so the last 64
// maps of the calling thread are kept by everything that defines them.
inline int bnhd_map(CUtensorMap* map, const void* base, int B, int N, int H,
                    int D, long long sb, long long sn, long long sh,
                    int rows) {
  struct Key {
    const void* base;
    long long v[8];
  };
  struct Entry {
    Key key;
    CUtensorMap map;
  };
  constexpr int kKept = 64;
  thread_local Entry kept[kKept];
  thread_local int n_kept = 0, next = 0;
  const Key key = {base, {B, N, H, D, sb, sn, sh, rows}};
  for (int j = 1; j <= n_kept; ++j) {  // the newest first
    const Entry& e = kept[(next - j + kKept) % kKept];
    if (e.key.base == base && memcmp(e.key.v, key.v, sizeof(key.v)) == 0) {
      *map = e.map;
      return 0;
    }
  }
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dim[4] = {(cuuint64_t)D, (cuuint64_t)N, (cuuint64_t)H,
                             (cuuint64_t)B};
  const cuuint64_t stride[3] = {(cuuint64_t)sn * 2, (cuuint64_t)sh * 2,
                                (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)rows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(base), dim, stride, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return (int)cudaErrorInvalidValue;
  kept[next] = Entry{key, *map};
  next = (next + 1) % kKept;
  if (n_kept < kKept) ++n_kept;
  return 0;
}

}  // namespace
