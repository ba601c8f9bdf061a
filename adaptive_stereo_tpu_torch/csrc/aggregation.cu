// Cost-volume aggregation stack: one layer per launch, eval and train mode.
//
// Replaces the TPU kernel adaptive_stereo_tpu/ops/pallas/aggregation.py
// (aggregate_cost_volume_pallas -> _forward -> pl.pallas_call of _kernel /
// _stack_body). The stack is
//
//   4 x [Conv3d 32->32 k3 pad 1 + bias, BatchNorm, LeakyReLU 0.2]
//     + Conv3d 32->1 k3 pad 1 + bias
//
// and each layer is the body of conv3d.cuh: the conv output is rounded to
// the compute type before BatchNorm sees it, as in aggregate_cost_volume_ref
// and the TPU kernel.
//
// Eval mode (running statistics): one launch per layer,
// stereo_conv3d_bn_leaky_forward, with BatchNorm + LeakyReLU in the epilogue
// (five launches).
// Train mode (batch statistics, returned as mu/var): three launches per BN
// layer (thirteen in all):
//   stereo_conv3d_stats_forward  the conv output y, rounded, and per-tile
//                                sums of y and y^2 (conv3d.cuh)
//   stereo_bn_stats_finalize     mu, var = E[y], E[y^2] - E[y]^2 in a fixed
//                                order (deterministic, no float atomics)
//   stereo_bn_leaky_apply        BatchNorm with (mu, var) + LeakyReLU, in place
// then the final 32->1 layer as in eval mode.
//
// Bound on an H100: operations. Each 32->32 layer is 2*27*32*32 = 55,296
// operations per output position, about 1.0 GFLOP at the serving shape
// (1,12,20,76), against about 2.3 MB moved (bf16 in and out, plus
// weights). The tensor-core bound of the whole stack is about 4 us.
// Design: one block per row tile (conv3d.cuh), 240 tiles at the serving
// shape, so that one wave of two 100 KB blocks per SM covers a layer. In
// bf16 a block stages its input halo and the layer's weights in shared
// memory once and runs the 864-deep product on the tensor cores
// (mma.sync); what is left is the staging from L2 and the launch, not the
// product. In f32 (the checking type) each output is a CUDA-core sum. Unlike
// the TPU kernel it has no W % 4 limit and keeps no activation resident
// between layers.

#include "conv3d.cuh"

template <typename T, int COUT>
__global__ void __launch_bounds__(STEREO_CONV_THREADS, 2)
    conv3d_layer_kernel(const T* x, const ConvLayer layer, T* out, float* partials, int D,
                        int H, int W, int wc) {
  const RowTile t = row_tile(blockIdx.x, D, H, W, wc);
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    stage_weights<COUT>(static_cast<const T*>(layer.k), tile_weights(conv_smem(), wc));
  conv3d_row_tile<T, COUT, T>(
      x, layer, t, D, H, W, wc, out,
      partials == nullptr ? nullptr
                          : partials + static_cast<int64_t>(blockIdx.x) * 2 * STEREO_CONV_C);
}

template <typename T, int COUT>
static int launch_layer(const void* x, const ConvLayer& layer, void* out, float* partials,
                        int B, int D, int H, int W, int wc, cudaStream_t s) {
  const int smem = tile_smem(std::is_same<T, float>::value ? kFloat32 : kBFloat16, wc);
  if (smem > 0) {
    const cudaError_t err = cudaFuncSetAttribute(
        conv3d_layer_kernel<T, COUT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  conv3d_layer_kernel<T, COUT>
      <<<static_cast<unsigned>(tile_count(B, D, H, W, wc)), STEREO_CONV_THREADS, smem, s>>>(
          static_cast<const T*>(x), layer, static_cast<T*>(out), partials, D, H, W, wc);
  return static_cast<int>(cudaGetLastError());
}

// wc and smem must be tile_plan's for (B, D, H, W) and the dtype: the
// wrapper sizes everything from them, and a mismatch is refused.
static bool plan_ok(int B, int D, int H, int W, int wc, int smem, int dtype) {
  return B >= 1 && D >= 1 && H >= 1 && W >= 1 && wc >= 1 && wc <= STEREO_TILE_MAX_W &&
         smem == tile_smem(dtype, wc) && tile_count(B, D, H, W, wc) <= 0x7fffffff;
}

template <int COUT>
static int launch_by_dtype(const void* x, const ConvLayer& layer, void* out, float* partials,
                           int B, int D, int H, int W, int wc, int dtype, cudaStream_t s) {
  if (dtype == kFloat32)
    return launch_layer<float, COUT>(x, layer, out, partials, B, D, H, W, wc, s);
  if (dtype == kBFloat16)
    return launch_layer<__nv_bfloat16, COUT>(x, layer, out, partials, B, D, H, W, wc, s);
  return static_cast<int>(cudaErrorInvalidValue);
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

// One layer 32 -> Cout (32 or 1): conv + bias, rounded, then with has_bn
// BatchNorm (mean, var, gamma, beta) + LeakyReLU, rounded. x and out are
// (B, D, H, W, 32) and (B, D, H, W, Cout); x starts on a 16-byte boundary.
extern "C" int stereo_conv3d_bn_leaky_forward(const void* x, const void* k, const void* bias,
                                              const void* mean, const void* var,
                                              const void* gamma, const void* beta, void* out,
                                              int B, int D, int H, int W, int Cout,
                                              int has_bn, int wc, int smem, float eps,
                                              float slope, int dtype, void* stream) {
  if (!plan_ok(B, D, H, W, wc, smem, dtype) || (Cout != STEREO_CONV_C && Cout != 1) ||
      (has_bn && Cout != STEREO_CONV_C))
    return static_cast<int>(cudaErrorInvalidValue);
  const ConvLayer layer{k,
                        static_cast<const float*>(bias),
                        static_cast<const float*>(mean),
                        static_cast<const float*>(var),
                        static_cast<const float*>(gamma),
                        static_cast<const float*>(beta),
                        has_bn ? kConvBnLeaky : kConvOnly,
                        eps,
                        slope};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Cout == STEREO_CONV_C)
    return launch_by_dtype<STEREO_CONV_C>(x, layer, out, nullptr, B, D, H, W, wc, dtype, s);
  return launch_by_dtype<1>(x, layer, out, nullptr, B, D, H, W, wc, dtype, s);
}

// One layer 32 -> 32 in train mode: the conv output y (rounded) into out and
// each row tile's sums of y and y^2 into its row of partials, which holds
// nparts = tile_count(B, D, H, W, wc) rows of 2 * 32 floats.
extern "C" int stereo_conv3d_stats_forward(const void* x, const void* k, const void* bias,
                                           void* out, void* partials, int nparts, int B,
                                           int D, int H, int W, int wc, int smem, int dtype,
                                           void* stream) {
  if (!plan_ok(B, D, H, W, wc, smem, dtype) || tile_count(B, D, H, W, wc) != nparts)
    return static_cast<int>(cudaErrorInvalidValue);
  const ConvLayer layer{k,       static_cast<const float*>(bias), nullptr, nullptr, nullptr,
                        nullptr, kConvStats,                      0.0f,    0.0f};
  return launch_by_dtype<STEREO_CONV_C>(x, layer, out, static_cast<float*>(partials), B, D, H,
                                        W, wc, dtype, static_cast<cudaStream_t>(stream));
}

// mu[c], var[c] (c < C) from nparts rows of partials, over count elements
// per channel. One block of STEREO_BN_TILE threads: the block size of
// csrc/coarse_head.cu, whose block 0 sums the same rows in the same order.
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
  const int threads = 256;
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
