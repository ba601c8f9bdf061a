// Cost-volume aggregation stack: one layer per launch, eval and train mode.
//
// Replaces the TPU kernel adaptive_stereo_tpu/ops/pallas/aggregation.py
// (aggregate_cost_volume_pallas -> _forward -> pl.pallas_call of _kernel /
// _stack_body). The stack is
//
//   4 x [Conv3d 32->32 k3 pad 1 + bias, BatchNorm, LeakyReLU 0.2]
//     + Conv3d 32->1 k3 pad 1 + bias
//
// and each output of a layer is the body of conv3d.cuh: the conv output is
// rounded to the compute type before BatchNorm sees it, as in
// aggregate_cost_volume_ref and the TPU kernel.
//
// Eval mode (running statistics): one launch per layer,
// stereo_conv3d_bn_leaky_forward, with BatchNorm + LeakyReLU in the epilogue
// (five launches).
// Train mode (batch statistics, returned as mu/var): three launches per BN
// layer (thirteen in all):
//   stereo_conv3d_stats_forward  the conv output y, rounded, and per-block
//                                sums of y and y^2 (bn_stats.cuh)
//   stereo_bn_stats_finalize     mu, var = E[y], E[y^2] - E[y]^2 in a fixed
//                                order (deterministic, no float atomics)
//   stereo_bn_leaky_apply        BatchNorm with (mu, var) + LeakyReLU, in place
// then the final 32->1 layer as in eval mode.
//
// Bound on an H100: operations. Each 32->32 layer is 2*27*32*32 = 55,296
// operations per output position, about 1.0 GFLOP at the serving shape
// (1,12,20,76), against about 2.3 MB moved (bf16 in and out, plus
// weights). The tensor-core bound of the whole stack is about 4 us.
// Design (simple first): one thread per output element, output channel
// fastest. The 32 threads of a warp share one output position, so every
// read of an input activation is a broadcast and every read of the weights
// (laid out [tap][ci][co]) is coalesced; both stay in L1. This runs on the
// CUDA cores, not the tensor cores; a wgmma implicit-GEMM version is later
// work. Unlike the TPU kernel it has no W % 4 limit and keeps no activation
// resident between layers.

#include "bn_stats.cuh"
#include "conv3d.cuh"

// One tile of partial sums per block in train mode (bn_stats.cuh).
#define STEREO_AGG_THREADS STEREO_BN_TILE

template <typename T>
__global__ void conv3d_bn_leaky_kernel(const T* __restrict__ x, const T* __restrict__ k,
                                       const float* __restrict__ bias,
                                       const float* __restrict__ mean,
                                       const float* __restrict__ var,
                                       const float* __restrict__ gamma,
                                       const float* __restrict__ beta,
                                       T* __restrict__ out, int B, int D, int H, int W,
                                       int Cin, int Cout, int has_bn, float eps,
                                       float slope) {
  const int64_t n = static_cast<int64_t>(B) * D * H * W * Cout;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int co = static_cast<int>(i % Cout);
  int64_t r = i / Cout;
  const int w = static_cast<int>(r % W);
  r /= W;
  const int h = static_cast<int>(r % H);
  r /= H;
  const int d = static_cast<int>(r % D);
  const int b = static_cast<int>(r / D);
  float y = conv3d_round<T>(conv3d_tap_sum<T>(x, k, b, d, h, w, co, D, H, W, Cin, Cout),
                            bias[co]);
  if (has_bn) y = bn_leaky(y, mean[co], var[co], gamma[co], beta[co], eps, slope);
  out[i] = from_float<T>(y);
}

// The conv output (rounded) and this block's per-channel sums of it and its
// square into partials[blockIdx.x]. One element per thread; Cout divides
// the block size, so thread t holds channel t % Cout.
template <typename T>
__global__ void __launch_bounds__(STEREO_AGG_THREADS)
    conv3d_stats_kernel(const T* __restrict__ x, const T* __restrict__ k,
                        const float* __restrict__ bias, T* __restrict__ out,
                        float* __restrict__ partials, int B, int D, int H, int W, int Cin,
                        int Cout) {
  const int64_t n = static_cast<int64_t>(B) * D * H * W * Cout;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  float s1 = 0.0f, s2 = 0.0f;
  if (i < n) {
    const int co = static_cast<int>(i % Cout);
    int64_t r = i / Cout;
    const int w = static_cast<int>(r % W);
    r /= W;
    const int h = static_cast<int>(r % H);
    r /= H;
    const int d = static_cast<int>(r % D);
    const int b = static_cast<int>(r / D);
    const float y = conv3d_round<T>(
        conv3d_tap_sum<T>(x, k, b, d, h, w, co, D, H, W, Cin, Cout), bias[co]);
    out[i] = from_float<T>(y);  // exact: y is already a value of T
    s1 = y;
    s2 = y * y;
  }
  bn_block_partials(s1, s2, Cout, partials + static_cast<int64_t>(blockIdx.x) * 2 * Cout);
}

__global__ void bn_finalize_kernel(const float* __restrict__ partials, int nparts, int C,
                                   int count, float* __restrict__ mu,
                                   float* __restrict__ var) {
  bn_finalize(partials, nparts, C, count, mu, var);
}

template <typename T>
__global__ void bn_leaky_apply_kernel(T* __restrict__ x, const float* __restrict__ mean,
                                      const float* __restrict__ var,
                                      const float* __restrict__ gamma,
                                      const float* __restrict__ beta, int64_t n, int C,
                                      float eps, float slope) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int c = static_cast<int>(i % C);
  x[i] = from_float<T>(
      bn_leaky(to_float(x[i]), mean[c], var[c], gamma[c], beta[c], eps, slope));
}

extern "C" int stereo_conv3d_bn_leaky_forward(const void* x, const void* k, const void* bias,
                                              const void* mean, const void* var,
                                              const void* gamma, const void* beta, void* out,
                                              int B, int D, int H, int W, int Cin, int Cout,
                                              int has_bn, float eps, float slope, int dtype,
                                              void* stream) {
  const int64_t n = static_cast<int64_t>(B) * D * H * W * Cout;
  if (n == 0) return 0;
  const int threads = STEREO_AGG_THREADS;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* bi = static_cast<const float*>(bias);
  const float* mu = static_cast<const float*>(mean);
  const float* va = static_cast<const float*>(var);
  const float* ga = static_cast<const float*>(gamma);
  const float* be = static_cast<const float*>(beta);
  if (dtype == kFloat32) {
    conv3d_bn_leaky_kernel<float><<<blocks_for(n, threads), threads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(k), bi, mu, va, ga, be,
        static_cast<float*>(out), B, D, H, W, Cin, Cout, has_bn, eps, slope);
  } else if (dtype == kBFloat16) {
    conv3d_bn_leaky_kernel<__nv_bfloat16><<<blocks_for(n, threads), threads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(k), bi, mu,
        va, ga, be, static_cast<__nv_bfloat16*>(out), B, D, H, W, Cin, Cout, has_bn, eps,
        slope);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// partials holds nparts rows of 2 * Cout floats; nparts must be the launch's
// block count, ceil(B*D*H*W*Cout / STEREO_BN_TILE).
extern "C" int stereo_conv3d_stats_forward(const void* x, const void* k, const void* bias,
                                           void* out, void* partials, int nparts, int B,
                                           int D, int H, int W, int Cin, int Cout, int dtype,
                                           void* stream) {
  const int64_t n = static_cast<int64_t>(B) * D * H * W * Cout;
  const int threads = STEREO_AGG_THREADS;
  if (n == 0 || threads % Cout != 0 || blocks_for(n, threads) != static_cast<unsigned>(nparts))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* bi = static_cast<const float*>(bias);
  float* pa = static_cast<float*>(partials);
  if (dtype == kFloat32) {
    conv3d_stats_kernel<float><<<nparts, threads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(k), bi,
        static_cast<float*>(out), pa, B, D, H, W, Cin, Cout);
  } else if (dtype == kBFloat16) {
    conv3d_stats_kernel<__nv_bfloat16><<<nparts, threads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(k), bi,
        static_cast<__nv_bfloat16*>(out), pa, B, D, H, W, Cin, Cout);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// mu[c], var[c] (c < C) from nparts rows of partials, over count elements
// per channel. One block.
extern "C" int stereo_bn_stats_finalize(const void* partials, int nparts, int C, int count,
                                        void* mu, void* var, void* stream) {
  const int threads = STEREO_BN_TILE;
  if (nparts < 1 || count < 1 || C < 1 || threads % C != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  bn_finalize_kernel<<<1, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(partials), nparts, C, count, static_cast<float*>(mu),
      static_cast<float*>(var));
  return static_cast<int>(cudaGetLastError());
}

// x (n elements, channels-last with C channels) <- round_T(leaky(bn(x))), in place.
extern "C" int stereo_bn_leaky_apply(void* x, const void* mean, const void* var,
                                     const void* gamma, const void* beta, int n, int C,
                                     float eps, float slope, int dtype, void* stream) {
  if (n == 0) return 0;
  const int threads = STEREO_AGG_THREADS;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* mu = static_cast<const float*>(mean);
  const float* va = static_cast<const float*>(var);
  const float* ga = static_cast<const float*>(gamma);
  const float* be = static_cast<const float*>(beta);
  if (dtype == kFloat32) {
    bn_leaky_apply_kernel<float><<<blocks_for(n, threads), threads, 0, s>>>(
        static_cast<float*>(x), mu, va, ga, be, n, C, eps, slope);
  } else if (dtype == kBFloat16) {
    bn_leaky_apply_kernel<__nv_bfloat16><<<blocks_for(n, threads), threads, 0, s>>>(
        static_cast<__nv_bfloat16*>(x), mu, va, ga, be, n, C, eps, slope);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
