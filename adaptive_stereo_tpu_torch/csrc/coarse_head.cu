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
// Design (simple first). A bf16 activation at the serving shape is 1.17 MB,
// far over one block's 227 KB of shared memory, and recomputing halos
// through five 3x3x3 layers would need +-5 in d, h and w. So the kernel is
// ONE cooperative launch (cudaLaunchCooperativeKernel), as many blocks as
// can be resident at once, grid-stride loops, and a grid-wide barrier
// (cooperative_groups grid.sync) after the cost build and after each layer.
// The activations ping-pong between two scratch buffers that the wrapper
// allocates; at 1.17 MB each they stay in the 50 MB L2. Each output of a
// layer is the body of conv3d.cuh (the same arithmetic, in the same order,
// as csrc/aggregation.cu), and the epilogue is the body of
// soft_argmin_fcs.cuh (as csrc/disparity.cu), so in eval mode this kernel
// reproduces kernels 1-3 composed bit for bit. In train mode each BN layer
// adds partial sums per tile of 256 elements, a barrier, a fixed-order
// reduction by block 0 (bn_stats.cuh), a barrier, and BatchNorm + LeakyReLU
// in place; the tiles are csrc/aggregation.cu's, so train mode too matches
// kernel 2 bit for bit, and does not depend on the grid size. Like
// kernel 2 it runs on the CUDA cores, not the tensor cores, so it is far
// from its bound; what it removes is four launches and the volume's trips
// between kernels. It is slower than kernels 1-3 in turn all the same: the
// whole head in one function takes 128 registers a thread, so an SM holds
// half the warps it holds of kernel 2, and the conv, which waits on L1,
// hides less of that wait (PERF.md). The TPU kernel's 128-lane packing, tap
// matrices and W % 4 limit are TPU matters and are not carried over.

#include <cooperative_groups.h>

#include "bn_stats.cuh"
#include "conv3d.cuh"
#include "soft_argmin_fcs.cuh"

namespace cg = cooperative_groups;

// One tile of partial sums per block and step of the layers (bn_stats.cuh).
#define STEREO_HEAD_THREADS STEREO_BN_TILE
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
  float* partials;             // (ceil(B*D*H*W*C / 256), 2, C) scratch
  int B, H, W, C, D, train;
  float eps, slope;
};

// Two blocks on each SM: up to 128 registers a thread, which the kernel
// uses without spilling. Of the caps that fit one to four blocks on an SM,
// this one ran fastest on the H100; three and four spill.
template <typename T>
__global__ void __launch_bounds__(STEREO_HEAD_THREADS, 2)
    coarse_head_kernel(const CoarseHeadArgs a) {
  cg::grid_group grid = cg::this_grid();
  const T* fl = static_cast<const T*>(a.fl);
  const T* fr = static_cast<const T*>(a.fr);
  const int B = a.B, H = a.H, W = a.W, C = a.C, D = a.D;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t nvol = static_cast<int64_t>(B) * D * H * W * C;

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

  // The layers walk the volume in tiles of STEREO_HEAD_THREADS consecutive
  // elements, tile j on block j % gridDim.x: the tiles, and so the rows of
  // partial sums, are those of csrc/aggregation.cu's train-mode launch (one
  // tile per block there), whatever the grid size.
  const int64_t ntiles = (nvol + blockDim.x - 1) / blockDim.x;
  T* src = static_cast<T*>(a.act0);
  T* dst = static_cast<T*>(a.act1);
  for (int layer = 0; layer < STEREO_HEAD_BN_LAYERS; ++layer) {
    const T* k = static_cast<const T*>(a.kernels) + static_cast<int64_t>(layer) * 27 * C * C;
    const float* bias = a.biases + layer * C;
    const float* gamma = a.scales + layer * C;
    const float* beta = a.bn_biases + layer * C;
    float* mu = a.mu + layer * C;
    float* var = a.var + layer * C;
    for (int64_t tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
      const int64_t i = tile * blockDim.x + threadIdx.x;
      float y = 0.0f;
      if (i < nvol) {
        const int co = static_cast<int>(i % C);
        int64_t r = i / C;
        const int w = static_cast<int>(r % W);
        r /= W;
        const int h = static_cast<int>(r % H);
        r /= H;
        const int d = static_cast<int>(r % D);
        const int b = static_cast<int>(r / D);
        y = conv3d_round<T>(conv3d_tap_sum<T>(src, k, b, d, h, w, co, D, H, W, C, C),
                            bias[co]);
        if (!a.train)
          y = bn_leaky(y, a.rmean[layer * C + co], a.rvar[layer * C + co], gamma[co],
                       beta[co], a.eps, a.slope);
        dst[i] = from_float<T>(y);
      }
      // Uniform across the block: every thread runs the same tiles.
      if (a.train) bn_block_partials(y, y * y, C, a.partials + tile * 2 * C);
    }
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

  // Final conv 32->1, one thread per (b, d, h, w), into the f32 cost.
  const int64_t ncost = static_cast<int64_t>(B) * D * H * W;
  for (int64_t i = tid; i < ncost; i += stride) {
    int64_t r = i;
    const int w = static_cast<int>(r % W);
    r /= W;
    const int h = static_cast<int>(r % H);
    r /= H;
    const int d = static_cast<int>(r % D);
    const int b = static_cast<int>(r / D);
    a.cost[i] = conv3d_round<T>(
        conv3d_tap_sum<T>(src, static_cast<const T*>(a.final_kernel), b, d, h, w, 0, D, H, W,
                          C, 1), a.final_bias[0]);
  }
  grid.sync();

  // Soft-argmin + FCS per pixel.
  const int64_t hw = static_cast<int64_t>(H) * W;
  for (int64_t p = tid; p < static_cast<int64_t>(B) * hw; p += stride) {
    const int64_t b = p / hw;
    soft_argmin_fcs_pixel(a.cost + b * D * hw + p % hw, hw, D, a.disp + p, a.fcs + p);
  }
}

// partials holds nparts rows of 2 * C floats, one per tile of
// STEREO_BN_TILE elements of the volume: nparts = ceil(B*D*H*W*C /
// STEREO_BN_TILE). Returns a CUDA error code (0 on success).
extern "C" int stereo_coarse_head_forward(
    const void* fl, const void* fr, const void* kernels, const void* biases,
    const void* scales, const void* bn_biases, const void* rmean, const void* rvar,
    const void* final_kernel, const void* final_bias, void* disp, void* fcs, void* mu,
    void* var, void* act0, void* act1, void* cost, void* partials, int nparts, int B, int H,
    int W, int C, int D, int train, float eps, float slope, int dtype, void* stream) {
  const int64_t nvol = static_cast<int64_t>(B) * D * H * W * C;
  if (B < 1 || H < 1 || W < 1 || D < 3 || C < 1 || STEREO_HEAD_THREADS % C != 0 ||
      blocks_for(nvol, STEREO_HEAD_THREADS) != static_cast<unsigned>(nparts))
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
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, STEREO_HEAD_THREADS, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  // Every block must be resident at once for the grid barrier; more blocks
  // than tiles would have nothing to do.
  const int blocks = per_sm * sms < nparts ? per_sm * sms : nparts;
  if (blocks < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  CoarseHeadArgs args{
      fl, fr, kernels, static_cast<const float*>(biases), static_cast<const float*>(scales),
      static_cast<const float*>(bn_biases), static_cast<const float*>(rmean),
      static_cast<const float*>(rvar), final_kernel, static_cast<const float*>(final_bias),
      static_cast<float*>(disp), static_cast<float*>(fcs), static_cast<float*>(mu),
      static_cast<float*>(var), act0, act1, static_cast<float*>(cost),
      static_cast<float*>(partials), B, H, W, C, D, train, eps, slope};
  void* params[] = {&args};
  err = cudaLaunchCooperativeKernel(fn, dim3(blocks), dim3(STEREO_HEAD_THREADS), params, 0,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
