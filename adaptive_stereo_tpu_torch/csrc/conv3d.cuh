// The per-output body of the aggregation stack, shared by csrc/aggregation.cu
// (one layer per launch) and csrc/coarse_head.cu (the whole head in one
// launch), so that both round alike:
//
//   y   = round_T(sum_{taps, ci} x[b, d+kd-1, h+kh-1, w+kw-1, ci] * k[tap, ci, co]
//                 + bias[co])                      (f32 accumulation)
//   out = round_T(leaky_0.2((y - mean[co]) * rsqrt(var[co] + eps) * gamma[co]
//                           + beta[co]))           (BN layers)
//
// Activations are channels-last (B, D, H, W, C); weights are [tap][ci][co]
// with tap = (kd * 3 + kh) * 3 + kw (the DHWIO layout). Taps outside the
// volume are skipped (zero padding 1 in d, h and w).
#pragma once

#include "common.cuh"

// The f32 sum of one conv output (b, d, h, w, co), taps in order and input
// channels in order within a tap. x carries no __restrict__: the fused head
// reads activations that other blocks wrote earlier in the same launch, so
// they must not go through the read-only (non-coherent) cache.
template <typename T>
__device__ __forceinline__ float conv3d_tap_sum(const T* x, const T* __restrict__ k, int b,
                                                int d, int h, int w, int co, int D, int H,
                                                int W, int Cin, int Cout) {
  float acc = 0.0f;
  for (int kd = 0; kd < 3; ++kd) {
    const int dd = d + kd - 1;
    if (dd < 0 || dd >= D) continue;
    for (int kh = 0; kh < 3; ++kh) {
      const int hh = h + kh - 1;
      if (hh < 0 || hh >= H) continue;
      for (int kw = 0; kw < 3; ++kw) {
        const int ww = w + kw - 1;
        if (ww < 0 || ww >= W) continue;
        const T* xp = x + (((static_cast<int64_t>(b) * D + dd) * H + hh) * W + ww) * Cin;
        const T* kp = k + static_cast<int64_t>((kd * 3 + kh) * 3 + kw) * Cin * Cout + co;
        for (int ci = 0; ci < Cin; ++ci) {
          acc = fmaf(to_float(xp[ci]), to_float(kp[static_cast<int64_t>(ci) * Cout]), acc);
        }
      }
    }
  }
  return acc;
}

// The conv output rounded to the compute type: BatchNorm sees what the plain
// stack's conv would have stored.
template <typename T>
__device__ __forceinline__ float conv3d_round(float acc, float bias) {
  return to_float(from_float<T>(acc + bias));
}

// BatchNorm with the given statistics, then LeakyReLU (f32; the caller
// rounds to the compute type).
__device__ __forceinline__ float bn_leaky(float y, float mean, float var, float gamma,
                                          float beta, float eps, float slope) {
  y = (y - mean) * rsqrtf(var + eps) * gamma + beta;
  return y >= 0.0f ? y : slope * y;
}
