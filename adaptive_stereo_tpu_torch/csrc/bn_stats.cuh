// Train-mode BatchNorm statistics across thread blocks, deterministic:
// shared by csrc/aggregation.cu (kernel 2) and csrc/coarse_head.cu (kernel
// 4). The tower (csrc/tower.cu) reduces its per-tile rows by the same rule
// with a wider block (tower_stats_kernel).
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
// Between the two, every row must be written: a launch boundary (kernel 2)
// or a grid-wide barrier (kernel 4). Kernels 2 and 4 use the row tiles of
// conv3d.cuh (tile_partials there), so they get the same rows, and so the
// same mu and var, whatever their grid.
#pragma once

#include "common.cuh"

#define STEREO_BN_TILE 256

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
