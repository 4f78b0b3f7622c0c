// The halo tiles of the bf16 block passes' depthwise stencils
// (bwd_stencil.cu for the backward, fwd_stencil.cu for the forward): an
// 8 x 16 body tile of an NHWC image with its 1- or 2-pixel halo arrives
// as one TMA box of the (C, W, H, B) view (tma_maps.cuh), zeros outside
// the image.  One CTA per (tile split, image) walks a fixed, strided list
// of (tile, column box) items, the next item's boxes in flight in the
// other of two stages while the current one is computed.
//
// Everything lives in an anonymous namespace: each .cu includes its own
// copy.
#pragma once

#include "tma_maps.cuh"
#include "tblock_common.cuh"

namespace {

constexpr int kTH = 8, kTW = 16;                             // body tile
constexpr int kW1 = kTW + 2, kH1 = kTH + 2, kP1 = kW1 * kH1;  // 1-pixel halo
constexpr int kW2 = kTW + 4, kH2 = kTH + 4, kP2 = kW2 * kH2;  // 2-pixel halo

constexpr int round1k(int bytes) { return (bytes + 1023) / 1024 * 1024; }

__device__ __forceinline__ unsigned char* align1k(unsigned char* p) {
  return p + (1024 - smem_addr(p) % 1024) % 1024;
}

// The items of one CTA: of the (tile, column box) pairs of image
// blockIdx.y, box fastest, those at split, split + nsplit, ...
struct Items {
  int ntx, nbox, split, nsplit, n;
  __device__ Items(int H, int W, int nbox_, int split_, int nsplit_)
      : ntx((W + kTW - 1) / kTW), nbox(nbox_), split(split_),
        nsplit(nsplit_) {
    const int total = ((H + kTH - 1) / kTH) * ntx * nbox;
    n = total > split ? (total - split + nsplit - 1) / nsplit : 0;
  }
  // the CTA's item i: its tile's top-left image pixel (oy, ox) and its box
  __device__ void at(int i, int& oy, int& ox, int& box) const {
    const int pair = split + i * nsplit, t = pair / nbox;
    box = pair % nbox;
    oy = (t / ntx) * kTH;
    ox = (t % ntx) * kTW;
  }
};

// Item i's boxes go to stage i % 2 (load(i, stage) by thread 0, which
// arrives on full[stage] expecting their bytes), item i + 1's are in
// flight while body(i, stage) runs; after each body a __syncthreads frees
// the stage and the body's shared buffers.
template <typename Load, typename Body>
__device__ void item_loop(uint64_t* full, int n, Load load, Body body) {
  if (threadIdx.x == 0 && n > 0) load(0, 0);
  for (int i = 0; i < n; ++i) {
    const int s = i & 1;
    if (threadIdx.x == 0 && i + 1 < n) load(i + 1, s ^ 1);
    mbar_wait(full + s, (i >> 1) & 1);
    body(i, s);
    __syncthreads();
  }
}

__device__ void init_stage_bars(uint64_t* full) {
  if (threadIdx.x == 0) {
    mbar_init(full, 1);
    mbar_init(full + 1, 1);
    mbar_init_fence();
  }
  __syncthreads();
}

// The 9 taps of column ch of a third (`third` 0-2 of a (27, C) tap array)
__device__ __forceinline__ void load_taps(float (&t)[9], const float* taps,
                                          int ld, int row0, int ch,
                                          bool valid) {
#pragma unroll
  for (int i = 0; i < 9; ++i)
    t[i] = valid ? taps[(size_t)(row0 + i) * ld + ch] : 0.f;
}

template <typename K>
int prepare(K kernel, int smem) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

bool bad_grid(int B, int H, int W, int nsplit) {
  return B <= 0 || H <= 0 || W <= 0 || nsplit <= 0 || B > 65535;
}

}  // namespace
