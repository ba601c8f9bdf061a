// Fused soft-argmin + Feature Contrast Score, forward and backward.
//
// Replaces the TPU kernel adaptive_stereo_tpu/ops/pallas/disparity.py
// (soft_argmin_fcs_pallas -> _forward -> pl.pallas_call of _kernel) and its
// custom VJP (_bwd, plain jnp there): per pixel, the body of
// soft_argmin_fcs.cuh over the D entries of the pre-softmax cost; the
// gradient of the expected disparity,
//
//   g_cost[b, j, p] = (g[b, p] * p_j) * (j - disp[b, p]),
//   p_j = exp(cost_j - m) / sum_d exp(cost_d - m),  m = max_d cost_d,
//
// with FCS a stop-gradient.
//
// Bound on an H100: bytes. The forward reads B*D*H*W floats once and writes
// two floats per pixel, with about 5*D operations per pixel (one expf
// each), far below the card's operations-per-byte line; the backward reads
// the cost, disp and g and writes the cost's gradient. At the serving shape
// (1,12,20,76) the forward moves about 85 KB, so the launch bounds it.
// Design: one thread per pixel, consecutive threads on consecutive pixels,
// so every read of one disparity plane is coalesced; blocks of 32 threads,
// so the 1,520 pixels of the serving shape spread over 48 SMs; the grid's
// y is the image, so no index is divided. For the D that the model's
// configurations give, (maxdisp + 1) // 2^(input_scale + k) = 6, 12 or 24
// at maxdisp 192 (12 on the serving and training paths), the kernels are
// instantiated for that exact D: a thread loads its D costs into registers
// at once, one memory round instead of D dependent ones, and the loops
// unroll without a bound check (a loop bound MAXD >= D with a check at
// every step measured slower on an H100 than the loop over memory, PERF.md
// §6). Any other D takes the loop over memory (soft_argmin_fcs_pixel). The
// arithmetic and its order are the same in both forms and in kernel 4's
// epilogue.

#include "soft_argmin_fcs.cuh"

constexpr int kSoftArgminThreads = 32;
constexpr int kMaxGridY = 65535;

// D = 0: the loop over memory, for any nd >= 3; else nd == D.
template <int D>
__global__ void __launch_bounds__(kSoftArgminThreads)
    soft_argmin_fcs_kernel(const float* __restrict__ cost, float* __restrict__ disp,
                           float* __restrict__ fcs, int nd, int HW) {
  const int p = blockIdx.x * kSoftArgminThreads + threadIdx.x;
  if (p >= HW) return;
  const int64_t out = static_cast<int64_t>(blockIdx.y) * HW + p;
  const float* src = cost + static_cast<int64_t>(blockIdx.y) * nd * HW + p;
  if constexpr (D == 0) {
    soft_argmin_fcs_pixel(src, HW, nd, disp + out, fcs + out);
  } else {
    float v[D];
#pragma unroll
    for (int d = 0; d < D; ++d) v[d] = __ldg(src + d * HW);
    soft_argmin_fcs_regs<D>(v, disp + out, fcs + out);
  }
}

template <int D>
__global__ void __launch_bounds__(kSoftArgminThreads)
    soft_argmin_backward_kernel(const float* __restrict__ cost, const float* __restrict__ disp,
                                const float* __restrict__ g, float* __restrict__ g_cost, int nd,
                                int HW) {
  const int p = blockIdx.x * kSoftArgminThreads + threadIdx.x;
  if (p >= HW) return;
  const int64_t out = static_cast<int64_t>(blockIdx.y) * HW + p;
  const int64_t base = static_cast<int64_t>(blockIdx.y) * nd * HW + p;
  const float* src = cost + base;
  float* dst = g_cost + base;
  const float gp = g[out];
  const float dp = disp[out];
  if constexpr (D == 0) {
    float m = -INFINITY;
    for (int d = 0; d < nd; ++d) m = fmaxf(m, src[d * HW]);
    float z = 0.0f;
    for (int d = 0; d < nd; ++d) z += expf(src[d * HW] - m);
    for (int d = 0; d < nd; ++d)
      dst[d * HW] = (gp * (expf(src[d * HW] - m) / z)) * (static_cast<float>(d) - dp);
  } else {
    float v[D];
#pragma unroll
    for (int d = 0; d < D; ++d) v[d] = __ldg(src + d * HW);
    float m = -INFINITY;
#pragma unroll
    for (int d = 0; d < D; ++d) m = fmaxf(m, v[d]);
    float z = 0.0f;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      v[d] = expf(v[d] - m);
      z += v[d];
    }
#pragma unroll
    for (int d = 0; d < D; ++d) dst[d * HW] = (gp * (v[d] / z)) * (static_cast<float>(d) - dp);
  }
}

namespace {

using ForwardFn = void (*)(const float*, float*, float*, int, int);
using BackwardFn = void (*)(const float*, const float*, const float*, float*, int, int);

// The instance for D: the register form for D = 6, 12 or 24, else the loop
// over memory (kernel<0>).
ForwardFn forward_for(int D) {
  switch (D) {
    case 6: return soft_argmin_fcs_kernel<6>;
    case 12: return soft_argmin_fcs_kernel<12>;
    case 24: return soft_argmin_fcs_kernel<24>;
    default: return soft_argmin_fcs_kernel<0>;
  }
}
BackwardFn backward_for(int D) {
  switch (D) {
    case 6: return soft_argmin_backward_kernel<6>;
    case 12: return soft_argmin_backward_kernel<12>;
    case 24: return soft_argmin_backward_kernel<24>;
    default: return soft_argmin_backward_kernel<0>;
  }
}

bool grid_for(int B, int D, int HW, dim3* grid) {
  if (B > kMaxGridY || static_cast<int64_t>(D) * HW > INT32_MAX) return false;
  *grid = dim3(static_cast<unsigned>((HW + kSoftArgminThreads - 1) / kSoftArgminThreads), B);
  return true;
}

}  // namespace

extern "C" int stereo_soft_argmin_fcs_forward(const void* cost, void* disp, void* fcs,
                                              int B, int D, int HW, void* stream) {
  if (D < 3 || B < 0 || HW < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<int64_t>(B) * HW == 0) return 0;
  dim3 grid;
  if (!grid_for(B, D, HW, &grid)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  forward_for(D)<<<grid, kSoftArgminThreads, 0, s>>>(
      static_cast<const float*>(cost), static_cast<float*>(disp), static_cast<float*>(fcs), D,
      HW);
  return static_cast<int>(cudaGetLastError());
}

// cost (B, D, HW), disp and g (B, HW) -> g_cost (B, D, HW), all float32;
// D >= 3, as for the forward.
extern "C" int stereo_soft_argmin_backward(const void* cost, const void* disp, const void* g,
                                           void* g_cost, int B, int D, int HW, void* stream) {
  if (D < 3 || B < 0 || HW < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<int64_t>(B) * HW == 0) return 0;
  dim3 grid;
  if (!grid_for(B, D, HW, &grid)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  backward_for(D)<<<grid, kSoftArgminThreads, 0, s>>>(
      static_cast<const float*>(cost), static_cast<const float*>(disp),
      static_cast<const float*>(g), static_cast<float*>(g_cost), D, HW);
  return static_cast<int>(cudaGetLastError());
}
