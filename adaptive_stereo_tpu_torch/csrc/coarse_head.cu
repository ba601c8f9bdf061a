// The whole coarse head in one launch: cost-volume build, the 5-layer
// aggregation stack and the soft-argmin + FCS epilogue, eval and train mode.
//
// Replaces the TPU kernel adaptive_stereo_tpu/ops/pallas/coarse_head.py
// (coarse_head_pallas -> _forward -> pl.pallas_call of _kernel). From the two
// coarse feature maps f_l, f_r (B, H, W, C=32) it computes, as
// coarse_head_ref composes them:
//
//   cost[b,d,h,x,c] = round_T(f_l[b,h,x,c] - f_r[b,h,x-d,c])   (0 where x < d)
//   4 x [conv 32->32 + bias, rounded to T; BN; LeakyReLU 0.2; rounded to T]
//   conv 32->1 + bias, rounded to T, then in f32 per pixel:
//   disp = soft-argmin over D, fcs = m1 - (sum - m1 - m2) / (D - 2)
//   mu, var (4, C): the batch statistics in train mode (E[y], E[y^2] -
//   E[y]^2 over B*D*H*W), the running statistics in eval mode.
//
// Bound on an H100 at the serving shape (features (1,20,76,32) bf16, D=12):
// operations. The stack is 3.679 GFLOP (counting only taps inside the zero
// padding) over 989 TFLOP/s of bf16 tensor cores = 3.7 us; the bytes are
// about 0.43 MB (two 97 KB feature maps, 223 KB of weights, 12 KB out), 0.13
// us at 3.35 TB/s. The volume and the five activations never need to reach
// device memory.
//
// Design. A bf16 activation at the serving shape is 1.17 MB, far over one
// block's 227 KB of shared memory, and recomputing halos through five
// 3x3x3 layers would need +-5 in d, h and w. So the kernel is ONE
// cooperative launch (cudaLaunchCooperativeKernel), as many blocks as can
// be resident at once, and a grid-wide barrier (cooperative_groups
// grid.sync) after the cost build and after each layer. The activations
// ping-pong between two scratch buffers that the wrapper allocates; at 1.17
// MB each they stay in the 50 MB L2. Each layer walks the row tiles of
// csrc/aggregation.cu, tile j on block j % gridDim.x, with the same block
// size and the same body (conv3d.cuh: in bf16 the staged implicit GEMM on
// the tensor cores, in f32 the CUDA-core sum); a block stages each layer's
// weights once for all its tiles. The epilogue is the body of
// soft_argmin_fcs.cuh (as csrc/disparity.cu). So this kernel reproduces
// kernels 1-3 composed bit for bit, in eval mode and in train mode, where
// each BN layer adds the tiles' partial sums, a barrier, a fixed-order
// reduction by block 0 (bn_stats.cuh, with kernel 2's block size), a
// barrier, and BatchNorm + LeakyReLU in place. The TPU kernel's 128-lane
// packing, tap matrices and W % 4 limit are TPU matters and are not carried
// over.

#include <cooperative_groups.h>

#include "conv3d.cuh"
#include "soft_argmin_fcs.cuh"

namespace cg = cooperative_groups;

#define STEREO_HEAD_BN_LAYERS 4

// The kernel's arguments; the T-typed arrays (features, conv weights,
// activations) are cast to T inside the kernel.
struct CoarseHeadArgs {
  const void* fl;              // (B, H, W, C) T
  const void* fr;              // (B, H, W, C) T
  const void* kernels;         // (4, 27, C, C) T
  const float* biases;         // (4, C)
  const float* scales;         // (4, C)
  const float* bn_biases;      // (4, C)
  const float* rmean;          // (4, C)
  const float* rvar;           // (4, C)
  const void* final_kernel;    // (27, C) T
  const float* final_bias;     // (1,)
  float* disp;                 // (B, H, W)
  float* fcs;                  // (B, H, W)
  float* mu;                   // (4, C)
  float* var;                  // (4, C)
  void* act0;                  // (B, D, H, W, C) T scratch
  void* act1;                  // (B, D, H, W, C) T scratch
  float* cost;                 // (B, D, H, W) scratch: the final conv output
  float* partials;             // (ntiles, 2, C) scratch
  int64_t ntiles;              // row tiles of the volume (conv3d.cuh)
  int B, H, W, C, D, wc, train;
  float eps, slope;
};

// Two blocks on each SM: the bf16 staging takes about 100 KB of shared
// memory a block, and 128 registers a thread leave room for both.
template <typename T>
__global__ void __launch_bounds__(STEREO_CONV_THREADS, 2)
    coarse_head_kernel(const CoarseHeadArgs a) {
  cg::grid_group grid = cg::this_grid();
  const T* fl = static_cast<const T*>(a.fl);
  const T* fr = static_cast<const T*>(a.fr);
  const int B = a.B, H = a.H, W = a.W, C = a.C, D = a.D;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t nvol = static_cast<int64_t>(B) * D * H * W * C;
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;

  // Cost build into act0, as csrc/cost_volume.cu.
  for (int64_t i = tid; i < nvol; i += stride) {
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
    static_cast<T*>(a.act0)[i] = from_float<T>(v);
  }
  grid.sync();

  const int64_t ntiles = a.ntiles;
  T* src = static_cast<T*>(a.act0);
  T* dst = static_cast<T*>(a.act1);
  for (int layer = 0; layer < STEREO_HEAD_BN_LAYERS; ++layer) {
    const T* k = static_cast<const T*>(a.kernels) + static_cast<int64_t>(layer) * 27 * C * C;
    const float* gamma = a.scales + layer * C;
    const float* beta = a.bn_biases + layer * C;
    float* mu = a.mu + layer * C;
    float* var = a.var + layer * C;
    const ConvLayer conv{k,
                         a.biases + layer * C,
                         a.rmean + layer * C,
                         a.rvar + layer * C,
                         gamma,
                         beta,
                         a.train ? kConvStats : kConvBnLeaky,
                         a.eps,
                         a.slope};
    if constexpr (kBf16)
      if (blockIdx.x < ntiles) stage_weights<STEREO_CONV_C>(k, tile_weights(conv_smem(), a.wc));
    for (int64_t tile = blockIdx.x; tile < ntiles; tile += gridDim.x)
      conv3d_row_tile<T, STEREO_CONV_C, T>(src, conv, row_tile(tile, D, H, W, a.wc), D, H, W,
                                           a.wc, dst, a.partials + tile * 2 * C);
    if (a.train) {
      grid.sync();
      if (blockIdx.x == 0) bn_finalize(a.partials, ntiles, C, B * D * H * W, mu, var);
      grid.sync();
      for (int64_t i = tid; i < nvol; i += stride) {
        const int c = static_cast<int>(i % C);
        dst[i] = from_float<T>(
            bn_leaky(to_float(dst[i]), mu[c], var[c], gamma[c], beta[c], a.eps, a.slope));
      }
    } else if (blockIdx.x == 0 && threadIdx.x < C) {
      mu[threadIdx.x] = a.rmean[layer * C + threadIdx.x];
      var[threadIdx.x] = a.rvar[layer * C + threadIdx.x];
    }
    grid.sync();
    T* t = src;
    src = dst;
    dst = t;
  }

  // Final conv 32->1 into the f32 cost (B, D, H, W), the same row tiles.
  const ConvLayer final_conv{a.final_kernel, a.final_bias, nullptr, nullptr, nullptr, nullptr,
                             kConvOnly,      a.eps,        a.slope};
  if constexpr (kBf16)
    if (blockIdx.x < ntiles)
      stage_weights<1>(static_cast<const T*>(a.final_kernel), tile_weights(conv_smem(), a.wc));
  for (int64_t tile = blockIdx.x; tile < ntiles; tile += gridDim.x)
    conv3d_row_tile<T, 1, float>(src, final_conv, row_tile(tile, D, H, W, a.wc), D, H, W,
                                 a.wc, a.cost, nullptr);
  grid.sync();

  // Soft-argmin + FCS per pixel.
  const int64_t hw = static_cast<int64_t>(H) * W;
  for (int64_t p = tid; p < static_cast<int64_t>(B) * hw; p += stride) {
    const int64_t b = p / hw;
    soft_argmin_fcs_pixel(a.cost + b * D * hw + p % hw, hw, D, a.disp + p, a.fcs + p);
  }
}

// partials holds nparts rows of 2 * C floats, one per row tile of the
// volume: nparts = tile_count(B, D, H, W, wc); wc and smem are
// ops/cuda/aggregation.py:tile_plan's. Returns a CUDA error code (0 on
// success).
extern "C" int stereo_coarse_head_forward(
    const void* fl, const void* fr, const void* kernels, const void* biases,
    const void* scales, const void* bn_biases, const void* rmean, const void* rvar,
    const void* final_kernel, const void* final_bias, void* disp, void* fcs, void* mu,
    void* var, void* act0, void* act1, void* cost, void* partials, int nparts, int B, int H,
    int W, int C, int D, int wc, int smem, int train, float eps, float slope, int dtype,
    void* stream) {
  if (B < 1 || H < 1 || W < 1 || D < 3 || C != STEREO_CONV_C || wc < 1 ||
      wc > STEREO_TILE_MAX_W || smem != tile_smem(dtype, wc) ||
      tile_count(B, D, H, W, wc) != nparts)
    return static_cast<int>(cudaErrorInvalidValue);
  const void* fn;
  if (dtype == kFloat32) {
    fn = reinterpret_cast<const void*>(coarse_head_kernel<float>);
  } else if (dtype == kBFloat16) {
    fn = reinterpret_cast<const void*>(coarse_head_kernel<__nv_bfloat16>);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int device = 0, sms = 0, per_sm = 0;
  // Above 48 KB of dynamic shared memory a launch needs the attribute, and
  // the occupancy (every block resident for the grid barrier) depends on it.
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, STEREO_CONV_THREADS,
                                                        smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // More blocks than tiles would have nothing to do in the layers.
  const int blocks = per_sm * sms < nparts ? per_sm * sms : nparts;
  if (blocks < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  CoarseHeadArgs args{
      fl, fr, kernels, static_cast<const float*>(biases), static_cast<const float*>(scales),
      static_cast<const float*>(bn_biases), static_cast<const float*>(rmean),
      static_cast<const float*>(rvar), final_kernel, static_cast<const float*>(final_bias),
      static_cast<float*>(disp), static_cast<float*>(fcs), static_cast<float*>(mu),
      static_cast<float*>(var), act0, act1, static_cast<float*>(cost),
      static_cast<float*>(partials), nparts, B, H, W, C, D, wc, train, eps, slope};
  void* params[] = {&args};
  err = cudaLaunchCooperativeKernel(fn, dim3(blocks), dim3(STEREO_CONV_THREADS), params, smem,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
