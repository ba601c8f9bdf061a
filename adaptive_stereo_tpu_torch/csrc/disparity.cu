// Fused soft-argmin + Feature Contrast Score, forward.
//
// Replaces the TPU kernel adaptive_stereo_tpu/ops/pallas/disparity.py
// (soft_argmin_fcs_pallas -> _forward -> pl.pallas_call of _kernel). Per
// pixel, the body of soft_argmin_fcs.cuh over the D entries of the
// pre-softmax cost.
//
// Bound on an H100: bytes. It reads B*D*H*W floats once and writes two
// floats per pixel, with about 5*D operations per pixel (one expf each), far
// below the card's operations-per-byte line. At the serving shape
// (1,12,20,76) that is about 85 KB, so the launch bounds it in practice.
// Design: one thread per pixel; consecutive threads take consecutive
// pixels, so every read of one disparity plane is coalesced.

#include "soft_argmin_fcs.cuh"

__global__ void soft_argmin_fcs_kernel(const float* __restrict__ cost,
                                       float* __restrict__ disp, float* __restrict__ fcs,
                                       int B, int D, int HW) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<int64_t>(B) * HW) return;
  const int64_t b = i / HW;
  const int64_t p = i % HW;
  soft_argmin_fcs_pixel(cost + b * D * HW + p, HW, D, disp + i, fcs + i);
}

extern "C" int stereo_soft_argmin_fcs_forward(const void* cost, void* disp, void* fcs,
                                              int B, int D, int HW, void* stream) {
  if (D < 3) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t n = static_cast<int64_t>(B) * HW;
  if (n == 0) return 0;
  const int threads = 128;
  soft_argmin_fcs_kernel<<<blocks_for(n, threads), threads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cost), static_cast<float*>(disp), static_cast<float*>(fcs),
      B, D, HW);
  return static_cast<int>(cudaGetLastError());
}
