// Difference cost-volume build, forward.
//
// Replaces the TPU kernel adaptive_stereo_tpu/ops/pallas/cost_volume.py
// (difference_cost_volume_pallas -> _forward -> pl.pallas_call of _kernel):
//
//   out[b, d, h, x, c] = f_l[b, h, x, c] - f_r[b, h, x - d, c]   (x >= d)
//                        0                                       (x <  d)
//
// Bound on an H100: bytes. It reads 2*B*H*W*C inputs and writes
// B*D*H*W*C outputs and does one subtraction per output, far below the
// card's 295 operations per byte. At the serving shape (1,12,20,76,32) bf16
// that is about 1.27 MB, under a microsecond at 3.35 TB/s, so in practice
// the launch itself bounds it.
// Design: one thread per output element, channel-fastest, so that a warp
// reads 32 consecutive channels of f_l and f_r and writes 32 consecutive
// outputs (coalesced). The difference is taken in float and rounded once
// to the storage type, as torch's bf16 subtraction does, so the kernel is
// bitwise equal to the plain version. The x < d border and every d >= W
// slice are written as exact zeros. The TPU kernel's lane-shift layout is
// not carried over: on the GPU each thread computes its own source index.

#include "common.cuh"

template <typename T>
__global__ void cost_volume_kernel(const T* __restrict__ fl, const T* __restrict__ fr,
                                   T* __restrict__ out, int B, int H, int W, int C,
                                   int D) {
  const int64_t n = static_cast<int64_t>(B) * D * H * W * C;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int c = static_cast<int>(i % C);
  int64_t r = i / C;
  const int x = static_cast<int>(r % W);
  r /= W;
  const int h = static_cast<int>(r % H);
  r /= H;
  const int d = static_cast<int>(r % D);
  const int b = static_cast<int>(r / D);
  float v = 0.0f;
  if (x >= d) {
    const int64_t row = (static_cast<int64_t>(b) * H + h) * W;
    v = to_float(fl[(row + x) * C + c]) - to_float(fr[(row + x - d) * C + c]);
  }
  out[i] = from_float<T>(v);
}

extern "C" int stereo_cost_volume_forward(const void* fl, const void* fr, void* out,
                                          int B, int H, int W, int C, int D, int dtype,
                                          void* stream) {
  const int64_t n = static_cast<int64_t>(B) * D * H * W * C;
  if (n == 0) return 0;
  const int threads = 256;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) {
    cost_volume_kernel<float><<<blocks_for(n, threads), threads, 0, s>>>(
        static_cast<const float*>(fl), static_cast<const float*>(fr),
        static_cast<float*>(out), B, H, W, C, D);
  } else if (dtype == kBFloat16) {
    cost_volume_kernel<__nv_bfloat16><<<blocks_for(n, threads), threads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(fl), static_cast<const __nv_bfloat16*>(fr),
        static_cast<__nv_bfloat16*>(out), B, H, W, C, D);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
