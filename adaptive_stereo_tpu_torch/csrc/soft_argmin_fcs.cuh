// The per-pixel body of the soft-argmin + Feature Contrast Score epilogue,
// shared by csrc/disparity.cu (kernel 3) and csrc/coarse_head.cu (kernel 4).
// Over the D pre-softmax costs of one pixel:
//
//   m1   = max_d cost,  i1 = first d with cost == m1
//   m2   = max over d != i1              (a duplicated max is its own runner-up)
//   disp = sum_d d * exp(cost - m1) / sum_d exp(cost - m1)
//   fcs  = m1 - (sum_d cost - m1 - m2) / (D - 2)
//
// in the plain version's order: one pass for the max, its first index and
// the sum, one for the runner-up and the stable softmax expectation. No
// fast-math: expf and the division are the IEEE ones.
//
// Two forms of the same arithmetic in the same order, so they give the
// same bits: soft_argmin_fcs_pixel reads the costs from memory in both
// passes (the second hits L1), for any D; it is kernel 4's epilogue and
// kernel 3's path for a D it has no register form for. soft_argmin_fcs_regs
// takes the costs from registers, loaded once, with D a template parameter
// so that its loops unroll without a bound check (kernel 3 for D = 6, 12
// and 24).
#pragma once

#include "common.cuh"

// src[d * stride] is the cost of disparity d; requires D >= 3.
__device__ __forceinline__ void soft_argmin_fcs_pixel(const float* src, int64_t stride, int D,
                                                      float* disp, float* fcs) {
  float m1 = -INFINITY;
  int i1 = 0;
  float total = 0.0f;
  for (int d = 0; d < D; ++d) {
    const float v = src[d * stride];
    total += v;
    if (v > m1) {  // strict: keeps the first occurrence of the max
      m1 = v;
      i1 = d;
    }
  }
  float m2 = -INFINITY;
  float z = 0.0f;
  float num = 0.0f;
  for (int d = 0; d < D; ++d) {
    const float v = src[d * stride];
    if (d != i1) m2 = fmaxf(m2, v);
    const float e = expf(v - m1);
    z += e;
    num += e * static_cast<float>(d);
  }
  *disp = num / z;
  *fcs = m1 - (total - m1 - m2) / static_cast<float>(D - 2);
}

// The costs v[0..D-1] of one pixel, D a compile-time constant >= 3.
template <int D>
__device__ __forceinline__ void soft_argmin_fcs_regs(const float (&v)[D], float* disp,
                                                     float* fcs) {
  float m1 = -INFINITY;
  int i1 = 0;
  float total = 0.0f;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    total += v[d];
    if (v[d] > m1) {  // strict: keeps the first occurrence of the max
      m1 = v[d];
      i1 = d;
    }
  }
  float m2 = -INFINITY;
  float z = 0.0f;
  float num = 0.0f;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    if (d != i1) m2 = fmaxf(m2, v[d]);
    const float e = expf(v[d] - m1);
    z += e;
    num += e * static_cast<float>(d);
  }
  *disp = num / z;
  *fcs = m1 - (total - m1 - m2) / static_cast<float>(D - 2);
}
