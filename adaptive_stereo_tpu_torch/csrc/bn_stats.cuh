// Train-mode BatchNorm statistics across thread blocks, deterministic:
// shared by csrc/aggregation.cu (kernel 2), csrc/coarse_head.cu (kernel 4)
// and csrc/tower.cu (kernel 5).
//
// The statistics of channel c are over every (b, d, h, w) position of a
// (B, D, H, W, C) activation, in f32 semantics with the fast variance:
//
//   mu  = E[y],  var = E[y^2] - E[y]^2        (flax's rule, not unbiased)
//
// Two steps, with no float atomics, so the result does not change from run
// to run:
//   1. for each tile of the volume, the block that computed it writes the
//      tile's per-channel sums of y and y^2 into the tile's own row of a
//      scratch array partials[tile][2][C] that the wrapper allocates;
//   2. bn_finalize: one block of STEREO_BN_TILE threads sums the rows in a
//      fixed order (in double) and writes mu and var.
// Between the two, every row must be written: a launch boundary (kernels 2
// and 5) or a grid-wide barrier (kernel 4).
//
// The tower's tiles are STEREO_BN_TILE consecutive elements, one element
// per thread of a block of STEREO_BN_TILE threads, so thread t holds
// channel t % C (C divides the tile): bn_block_partials. Kernels 2 and 4
// use the row tiles of conv3d.cuh (tile_partials there). Kernels that cut
// the volume into the same tiles get the same rows, and so the same mu and
// var, whatever their grid.
#pragma once

#include "common.cuh"

#define STEREO_BN_TILE 256

// Write this block's per-channel sums (s1 = y, s2 = y^2 of the calling
// thread's element of the tile) to row[0][c] and row[1][c]. blockDim.x must
// be STEREO_BN_TILE; every thread of the block calls it.
__device__ __forceinline__ void bn_block_partials(float s1, float s2, int C, float* row) {
  __shared__ float sh[2][STEREO_BN_TILE];
  const int t = threadIdx.x;
  sh[0][t] = s1;
  sh[1][t] = s2;
  __syncthreads();
  if (t < C) {
    float a = 0.0f, q = 0.0f;
    for (int j = t; j < static_cast<int>(blockDim.x); j += C) {
      a += sh[0][j];
      q += sh[1][j];
    }
    row[t] = a;
    row[C + t] = q;
  }
  __syncthreads();
}

// mu[c] and var[c] for c < C from nparts rows of partials, over count
// elements per channel. Called by every thread of one block of
// STEREO_BN_TILE threads. Thread t sums rows t / C,
// t / C + blockDim.x / C, ... of channel t % C; then thread c < C adds those
// slices in order. The sums are in double, the results rounded to float.
__device__ __forceinline__ void bn_finalize(const float* partials, int nparts, int C,
                                            int count, float* mu, float* var) {
  __shared__ double sh[2][STEREO_BN_TILE];
  const int t = threadIdx.x;
  const int c = t % C;
  const int slices = blockDim.x / C;
  double a = 0.0, q = 0.0;
  for (int p = t / C; p < nparts; p += slices) {
    a += partials[static_cast<int64_t>(p) * 2 * C + c];
    q += partials[static_cast<int64_t>(p) * 2 * C + C + c];
  }
  sh[0][t] = a;
  sh[1][t] = q;
  __syncthreads();
  if (t < C) {
    a = 0.0;
    q = 0.0;
    for (int j = 0; j < slices; ++j) {
      a += sh[0][j * C + t];
      q += sh[1][j * C + t];
    }
    const double m = a / count;
    mu[t] = static_cast<float>(m);
    var[t] = static_cast<float>(q / count - m * m);
  }
  __syncthreads();
}
