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

// 16-byte accesses: one chunk of the storage type, kChunk<T> elements (4
// float or 8 bfloat16), converted to float on load and rounded to T (to
// nearest even) on store. p must start on a 16-byte boundary.
template <typename T> constexpr int kChunk = 16 / static_cast<int>(sizeof(T));

__device__ __forceinline__ void load_chunk(const float* p, float (&v)[4]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
}
__device__ __forceinline__ void load_chunk(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    v[2 * j] = f.x;
    v[2 * j + 1] = f.y;
  }
}
__device__ __forceinline__ void store_chunk(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store_chunk(__nv_bfloat16* p, const float (&v)[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) h[j] = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}
// The scalar path of the same interface: one element.
template <typename T> __device__ __forceinline__ void load_chunk(const T* p, float (&v)[1]) {
  v[0] = to_float(p[0]);
}
template <typename T> __device__ __forceinline__ void store_chunk(T* p, const float (&v)[1]) {
  p[0] = from_float<T>(v[0]);
}
