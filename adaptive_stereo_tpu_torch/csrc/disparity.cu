// Fused soft-argmin + Feature Contrast Score, forward.
//
// Replaces the TPU kernel adaptive_stereo_tpu/ops/pallas/disparity.py
// (soft_argmin_fcs_pallas -> _forward -> pl.pallas_call of _kernel). Per
// pixel, over the D entries of the pre-softmax cost:
//
//   m1   = max_d cost,  i1 = first d with cost == m1
//   m2   = max over d != i1              (a duplicated max is its own runner-up)
//   disp = sum_d d * exp(cost - m1) / sum_d exp(cost - m1)
//   fcs  = m1 - (sum_d cost - m1 - m2) / (D - 2)
//
// Bound on an H100: bytes. It reads B*D*H*W floats once and writes two
// floats per pixel, with about 5*D operations per pixel (one expf each), far
// below the card's operations-per-byte line. At the serving shape
// (1,12,20,76) that is about 85 KB, so the launch bounds it in practice.
// Design: one thread per pixel; consecutive threads take consecutive
// pixels, so every read of one disparity plane is coalesced. The D values
// are read once into registers (D <= STEREO_MAX_DISP, checked by the
// wrapper) and the max, first index, runner-up, sum and the stable softmax
// expectation are computed from there in the plain version's order. No
// fast-math: expf and the division are the IEEE ones.

#include "common.cuh"

#define STEREO_MAX_DISP 64

__global__ void soft_argmin_fcs_kernel(const float* __restrict__ cost,
                                       float* __restrict__ disp, float* __restrict__ fcs,
                                       int B, int D, int HW) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<int64_t>(B) * HW) return;
  const int64_t b = i / HW;
  const int64_t p = i % HW;
  const float* src = cost + b * D * HW + p;

  float v[STEREO_MAX_DISP];
  float m1 = -INFINITY;
  int i1 = 0;
  float total = 0.0f;
#pragma unroll
  for (int d = 0; d < STEREO_MAX_DISP; ++d) {
    if (d < D) {
      v[d] = src[static_cast<int64_t>(d) * HW];
      total += v[d];
      if (v[d] > m1) {  // strict: keeps the first occurrence of the max
        m1 = v[d];
        i1 = d;
      }
    }
  }
  float m2 = -INFINITY;
  float z = 0.0f;
  float num = 0.0f;
#pragma unroll
  for (int d = 0; d < STEREO_MAX_DISP; ++d) {
    if (d < D) {
      if (d != i1) m2 = fmaxf(m2, v[d]);
      const float e = expf(v[d] - m1);
      z += e;
      num += e * static_cast<float>(d);
    }
  }
  disp[i] = num / z;
  fcs[i] = m1 - (total - m1 - m2) / static_cast<float>(D - 2);
}

extern "C" int stereo_soft_argmin_fcs_forward(const void* cost, void* disp, void* fcs,
                                              int B, int D, int HW, void* stream) {
  if (D < 3 || D > STEREO_MAX_DISP) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t n = static_cast<int64_t>(B) * HW;
  if (n == 0) return 0;
  const int threads = 128;
  soft_argmin_fcs_kernel<<<blocks_for(n, threads), threads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cost), static_cast<float*>(disp), static_cast<float*>(fcs),
      B, D, HW);
  return static_cast<int>(cudaGetLastError());
}
