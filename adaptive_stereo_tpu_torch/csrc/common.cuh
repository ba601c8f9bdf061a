// Shared helpers for the port's kernels: element conversions between the
// storage types (float, __nv_bfloat16) and float arithmetic, and the dtype
// codes the Python wrappers pass across the C interface.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Storage-type codes shared with ops/cuda/_build.py (DTYPE_CODES).
enum StereoDType : int { kFloat32 = 0, kBFloat16 = 1 };

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
// Round to nearest even, as torch rounds float -> bfloat16.
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Blocks of 256 threads over n elements.
static inline unsigned int blocks_for(int64_t n, int threads) {
  return static_cast<unsigned int>((n + threads - 1) / threads);
}
