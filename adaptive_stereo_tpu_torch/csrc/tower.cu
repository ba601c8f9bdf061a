// Edge-aware refinement tower, forward and backward (train and eval mode).
//
// Replaces the TPU kernels of adaptive_stereo_tpu/ops/pallas/tower.py:
// the forward chain _fwd_layer -> pl.pallas_call of _fwd_kernel (:178, :285)
// and the backward chain _bwd_layer -> pl.pallas_call of _bwd_kernel (:345,
// :501), entry tower_pallas (:561). The tower is 8 full-resolution layers
// (reference stereo_net.py:88-121): a 3x3 conv 4->32, six dilated residual
// blocks 32->32 (dilations 1, 2, 4, 8, 1, 1), a 3x3 conv 32->1; layers 0-6
// carry BatchNorm + LeakyReLU 0.2. Activations are channels-last
// (B, H, W, C) on the plain layout: the TPU kernel's 2x2 space-to-depth
// packing and padded flattened rows were a 128-lane layout device and are
// not ported.
//
// Forward, layer p (stereo_tower_conv, prologue kBn / kBnResidual):
//   x_p = round_T(leaky(y_{p-1} * nrm + shift) [+ x_{p-1} for p >= 2])
//   y_p = round_T(conv3x3_dil(x_p) + bias)        (f32 accumulation)
// The previous layer's BatchNorm, LeakyReLU and residual are applied while
// the input tile is loaded (zero outside the image), x_p is written for the
// backward, and in train mode each block writes per-channel sums of the
// rounded y_p and y_p^2 into its own row of a partials array;
// stereo_bn_stats_finalize (csrc/aggregation.cu) reduces the rows in a fixed
// order to mu and var = E[y^2] - mu^2, with no float atomics.
//
// Backward, layer p = 7 .. 0 (tower_backward, tower.py:516-557):
//   stereo_tower_grad_y   gl = gx_{p+1} * leaky'(y_p*nrm + shift),
//                         gy = nrm * (gl - m1 - xhat * m2) (the exact
//                         batch-statistics BN gradient; gy = g for p = 7),
//                         rounded to T, with per-block sums for db
//   stereo_tower_wgrad    per-block partial dW[tap][ci][co] = sum x_p * gy
//   stereo_tower_conv     (epilogue kInputGrad) gx_p by the transposed conv
//                         (the wrapper hands it the weights with the taps
//                         reversed and ci/co swapped), plus the residual
//                         gx_{p+1} for 1 <= p <= 6, and per-block sums
//                         S1 = sum gl_{p-1}, S2 = sum gl_{p-1} * xhat_{p-1}
//                         for layer p - 1
//   stereo_column_sum     every cross-block reduction (db, dW, S1/S2), rows
//                         in a fixed order, in double
//
// Bound on an H100 at the training shape (2, 320, 960): the forward does
// about 70 GFLOP over about 1 GB and the backward twice the operations, so
// bf16 tensor cores would make both bound by bytes (a few tenths of a ms).
// Design (simple first): direct convolution on the CUDA cores from shared
// memory. A block owns an 8x16 pixel tile; its input tile with a halo of
// the dilation is staged once in shared memory as f32 (the prologue applied
// once per element), and the weights too. Each thread accumulates 4 pixels
// x 4 output channels (one float4 of weights and four broadcast inputs per
// step). The weight gradient reduces over pixels per block, in a fixed set
// of tiles per block, and a column sum finishes it. A tensor-core
// (wgmma implicit GEMM) version is later work.

#include "common.cuh"
#include "bn_stats.cuh"

#define TOWER_TH 8
#define TOWER_TW 16
#define TOWER_PIX (TOWER_TH * TOWER_TW)
#define TOWER_THREADS 256

enum TowerPrologue : int { kPlain = 0, kBn = 1, kBnResidual = 2 };
enum TowerEpilogue : int { kForward = 0, kInputGrad = 1 };

template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_float(from_float<T>(v));
}

// Channel stride of a staged pixel in shared memory: 33 for 32 channels, so
// that four neighbouring pixels read by one warp fall in different banks.
__host__ __device__ constexpr int tower_cs(int c) { return c == 32 ? 33 : c; }

__host__ __device__ constexpr int tower_tile_floats(int c, int dil) {
  return (TOWER_TH + 2 * dil) * (TOWER_TW + 2 * dil) * tower_cs(c);
}

// Stage the (TH + 2 dil) x (TW + 2 dil) x CIN input tile whose top-left
// interior pixel is (h0, w0), as f32, zero outside the image. With a BN
// prologue the staged value is round_T(leaky(in * nrm + shift) [+ res]),
// written to x_out as well for the tile's interior pixels.
template <typename T, int CIN>
__device__ __forceinline__ void stage_tile(float* s_in, const T* in, const T* res,
                                           const float* nrm, const float* shift, T* x_out,
                                           int prologue, int b, int h0, int w0, int H, int W,
                                           int dil, float slope) {
  const int tw = TOWER_TW + 2 * dil;
  const int n = (TOWER_TH + 2 * dil) * tw * CIN;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int ci = i % CIN;
    const int r = i / CIN;
    const int cx = r % tw;
    const int cy = r / tw;
    const int gh = h0 - dil + cy;
    const int gw = w0 - dil + cx;
    float v = 0.0f;
    if (gh >= 0 && gh < H && gw >= 0 && gw < W) {
      const int64_t gi = ((static_cast<int64_t>(b) * H + gh) * W + gw) * CIN + ci;
      v = to_float(in[gi]);
      if (prologue != kPlain) {
        v = v * nrm[ci] + shift[ci];
        v = v >= 0.0f ? v : slope * v;
        if (prologue == kBnResidual) v += to_float(res[gi]);
        v = round_to<T>(v);
        if (x_out != nullptr && cy >= dil && cy < dil + TOWER_TH && cx >= dil &&
            cx < dil + TOWER_TW)
          x_out[gi] = from_float<T>(v);
      }
    }
    s_in[r * tower_cs(CIN) + ci] = v;
  }
}

struct TowerEpilogueArgs {
  const float* bias;   // (COUT) conv bias (kForward)
  const void* skip;    // (B,H,W,COUT) residual gradient gx_{p+1} (kInputGrad), or null
  const void* yprev;   // (B,H,W,COUT) y_{p-1} for the S1/S2 sums (kInputGrad), or null
  const float* mu;     // (COUT) batch statistics and BN terms of layer p - 1
  const float* inv;
  const float* nrm;
  const float* shift;
};

// The output value at (b, gh, gw, co) from the f32 sum acc; adds its
// contribution to the per-channel sums s1/s2. Returns without a store
// outside the image.
template <typename T>
__device__ __forceinline__ void tower_epilogue(float acc, int epilogue,
                                               const TowerEpilogueArgs& e, T* out, int64_t gi,
                                               int co, float slope, float& s1, float& s2) {
  if (epilogue == kForward) {
    const float y = round_to<T>(acc + e.bias[co]);
    out[gi] = from_float<T>(y);
    s1 += y;
    s2 += y * y;
    return;
  }
  float g = acc;
  if (e.skip != nullptr) g += to_float(static_cast<const T*>(e.skip)[gi]);
  if (e.yprev != nullptr) {
    const float y = to_float(static_cast<const T*>(e.yprev)[gi]);
    const float xhat = (y - e.mu[co]) * e.inv[co];
    const float gl = (y * e.nrm[co] + e.shift[co] >= 0.0f) ? g : slope * g;
    s1 += gl;
    s2 += gl * xhat;
  }
  out[gi] = from_float<T>(g);
}

// One 3x3 dilated conv layer over an 8x16 tile per block (grid: tiles along
// W, tiles along H, B). Shared memory: the weights as f32 [9][CIN][COUT],
// then the staged input tile. partials, if not null, gets the block's row
// [2][COUT] of channel sums (COUT == 32 only).
template <typename T, int CIN, int COUT>
__global__ void __launch_bounds__(TOWER_THREADS)
    tower_conv_kernel(const T* __restrict__ in, const T* __restrict__ res,
                      const float* __restrict__ pro_nrm, const float* __restrict__ pro_shift,
                      T* __restrict__ x_out, const T* __restrict__ wts, T* __restrict__ out,
                      float* __restrict__ partials, TowerEpilogueArgs e, int H, int W, int dil,
                      int prologue, int epilogue, float slope) {
  extern __shared__ float4 tower_smem4[];
  float* s_w = reinterpret_cast<float*>(tower_smem4);
  float* s_in = s_w + 9 * CIN * COUT;
  const int b = blockIdx.z;
  const int h0 = blockIdx.y * TOWER_TH;
  const int w0 = blockIdx.x * TOWER_TW;
  const int tw = TOWER_TW + 2 * dil;
  constexpr int CS = tower_cs(CIN);

  for (int i = threadIdx.x; i < 9 * CIN * COUT; i += blockDim.x) s_w[i] = to_float(wts[i]);
  stage_tile<T, CIN>(s_in, in, res, pro_nrm, pro_shift, x_out, prologue, b, h0, w0, H, W,
                     dil, slope);
  __syncthreads();

  if constexpr (COUT == 32) {
    // Thread: output channels 4*co4 .. 4*co4+3 of pixels pg + 32 j, j < 4.
    const int co4 = threadIdx.x & 7;
    const int pg = threadIdx.x >> 3;
    float acc[4][4] = {};
    int base[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int q = pg + 32 * j;
      base[j] = ((q / TOWER_TW) * tw + q % TOWER_TW) * CS;
    }
    for (int ky = 0; ky < 3; ++ky) {
      for (int kx = 0; kx < 3; ++kx) {
        const int toff = (ky * dil * tw + kx * dil) * CS;
        const float* wp = s_w + (ky * 3 + kx) * CIN * 32 + 4 * co4;
#pragma unroll 4
        for (int ci = 0; ci < CIN; ++ci) {
          const float4 w4 = *reinterpret_cast<const float4*>(wp + ci * 32);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float xv = s_in[base[j] + toff + ci];
            acc[j][0] = fmaf(xv, w4.x, acc[j][0]);
            acc[j][1] = fmaf(xv, w4.y, acc[j][1]);
            acc[j][2] = fmaf(xv, w4.z, acc[j][2]);
            acc[j][3] = fmaf(xv, w4.w, acc[j][3]);
          }
        }
      }
    }
    float s1[4] = {}, s2[4] = {};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int q = pg + 32 * j;
      const int gh = h0 + q / TOWER_TW;
      const int gw = w0 + q % TOWER_TW;
      if (gh >= H || gw >= W) continue;
      const int64_t gi = ((static_cast<int64_t>(b) * H + gh) * W + gw) * 32;
#pragma unroll
      for (int c = 0; c < 4; ++c)
        tower_epilogue<T>(acc[j][c], epilogue, e, out, gi + 4 * co4 + c, 4 * co4 + c, slope,
                          s1[c], s2[c]);
    }
    if (partials != nullptr) {
      // Fixed-order block sums: thread t < 32 adds channel t over pg = 0..31.
      __shared__ float red[2][32][33];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        red[0][pg][4 * co4 + c] = s1[c];
        red[1][pg][4 * co4 + c] = s2[c];
      }
      __syncthreads();
      if (threadIdx.x < 32) {
        float a = 0.0f, q = 0.0f;
        for (int g = 0; g < 32; ++g) {
          a += red[0][g][threadIdx.x];
          q += red[1][g][threadIdx.x];
        }
        const int64_t blk =
            (static_cast<int64_t>(blockIdx.z) * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
        partials[blk * 64 + threadIdx.x] = a;
        partials[blk * 64 + 32 + threadIdx.x] = q;
      }
    }
  } else {
    // Few output channels (layer 7 forward: 1; layer 0 input gradient: 4):
    // one output per thread and step; no channel sums.
    for (int o = threadIdx.x; o < TOWER_PIX * COUT; o += blockDim.x) {
      const int q = o / COUT;
      const int co = o % COUT;
      const int gh = h0 + q / TOWER_TW;
      const int gw = w0 + q % TOWER_TW;
      if (gh >= H || gw >= W) continue;
      const int base = ((q / TOWER_TW) * tw + q % TOWER_TW) * CS;
      float acc = 0.0f;
      for (int ky = 0; ky < 3; ++ky)
        for (int kx = 0; kx < 3; ++kx) {
          const float* xp = s_in + base + (ky * dil * tw + kx * dil) * CS;
          const float* wp = s_w + (ky * 3 + kx) * CIN * COUT + co;
          for (int ci = 0; ci < CIN; ++ci) acc = fmaf(xp[ci], wp[ci * COUT], acc);
        }
      float s1 = 0.0f, s2 = 0.0f;
      tower_epilogue<T>(acc, epilogue, e, out,
                        ((static_cast<int64_t>(b) * H + gh) * W + gw) * COUT + co, co, slope,
                        s1, s2);
    }
  }
}

// gy of layer p from the gradient g of its output (gx_{p+1}, or the tower's
// output gradient for p = 7 when y is null), rounded to T; per-block sums of
// the f32 gy for db (bn_stats.cuh rows, the second half unused).
template <typename T>
__global__ void __launch_bounds__(STEREO_BN_TILE)
    tower_grad_y_kernel(const T* __restrict__ g, const T* __restrict__ y,
                        const float* __restrict__ mu, const float* __restrict__ inv,
                        const float* __restrict__ nrm, const float* __restrict__ shift,
                        const float* __restrict__ m1, const float* __restrict__ m2,
                        T* __restrict__ gy, float* __restrict__ partials, int64_t n, int C,
                        float slope) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  float v = 0.0f;
  if (i < n) {
    const int c = static_cast<int>(i % C);
    v = to_float(g[i]);
    if (y != nullptr) {
      const float yv = to_float(y[i]);
      const float xhat = (yv - mu[c]) * inv[c];
      const float gl = (yv * nrm[c] + shift[c] >= 0.0f) ? v : slope * v;
      v = nrm[c] * (gl - m1[c] - xhat * m2[c]);
    }
    gy[i] = from_float<T>(v);
  }
  bn_block_partials(v, 0.0f, C, partials + static_cast<int64_t>(blockIdx.x) * 2 * C);
}

// Partial weight gradient: block k sums, over the pixels of tiles k,
// k + gridDim.x, ..., dW[tap][ci][co] = x[pix + off(tap)][ci] * gy[pix][co]
// into partials[k][9 * CIN * COUT].
template <typename T, int CIN, int COUT>
__global__ void __launch_bounds__(TOWER_THREADS)
    tower_wgrad_kernel(const T* __restrict__ x, const T* __restrict__ gy,
                       float* __restrict__ partials, int B, int H, int W, int dil) {
  extern __shared__ float4 tower_smem4[];
  float* s_g = reinterpret_cast<float*>(tower_smem4);
  float* s_x = s_g + TOWER_PIX * COUT;
  constexpr int CS = tower_cs(CIN);
  constexpr int E = 9 * CIN * COUT;
  const int tw = TOWER_TW + 2 * dil;
  const int ntx = (W + TOWER_TW - 1) / TOWER_TW;
  const int nty = (H + TOWER_TH - 1) / TOWER_TH;
  const int ntiles = B * nty * ntx;
  float* row = partials + static_cast<int64_t>(blockIdx.x) * E;

  if constexpr (COUT == 32) {
    // Thread: output channels 4*co4 .. +3 of rows r + 32 j of (tap, ci).
    constexpr int NJ = (9 * CIN + 31) / 32;
    const int co4 = threadIdx.x & 7;
    const int r = threadIdx.x >> 3;
    float acc[NJ][4] = {};
    int off[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int rr = min(r + 32 * j, 9 * CIN - 1);
      const int tap = rr / CIN;
      off[j] = ((tap / 3) * dil * tw + (tap % 3) * dil) * CS + rr % CIN;
    }
    for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
      const int b = t / (nty * ntx);
      const int h0 = (t / ntx) % nty * TOWER_TH;
      const int w0 = t % ntx * TOWER_TW;
      __syncthreads();
      stage_tile<T, CIN>(s_x, x, nullptr, nullptr, nullptr, nullptr, kPlain, b, h0, w0, H, W,
                         dil, 0.0f);
      for (int i = threadIdx.x; i < TOWER_PIX * 32; i += blockDim.x) {
        const int q = i / 32;
        const int gh = h0 + q / TOWER_TW;
        const int gw = w0 + q % TOWER_TW;
        s_g[i] = (gh < H && gw < W)
                     ? to_float(gy[((static_cast<int64_t>(b) * H + gh) * W + gw) * 32 + i % 32])
                     : 0.0f;
      }
      __syncthreads();
      for (int q = 0; q < TOWER_PIX; ++q) {
        const float4 g4 = *reinterpret_cast<const float4*>(s_g + q * 32 + 4 * co4);
        const float* xq = s_x + ((q / TOWER_TW) * tw + q % TOWER_TW) * CS;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const float xv = xq[off[j]];
          acc[j][0] = fmaf(xv, g4.x, acc[j][0]);
          acc[j][1] = fmaf(xv, g4.y, acc[j][1]);
          acc[j][2] = fmaf(xv, g4.z, acc[j][2]);
          acc[j][3] = fmaf(xv, g4.w, acc[j][3]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int rr = r + 32 * j;
      if (rr >= 9 * CIN) continue;
#pragma unroll
      for (int c = 0; c < 4; ++c) row[rr * 32 + 4 * co4 + c] = acc[j][c];
    }
  } else {
    // Few output channels (layer 7: 1): entries e = tid, tid + 256, ...
    constexpr int NE = (E + TOWER_THREADS - 1) / TOWER_THREADS;
    float acc[NE] = {};
    for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
      const int b = t / (nty * ntx);
      const int h0 = (t / ntx) % nty * TOWER_TH;
      const int w0 = t % ntx * TOWER_TW;
      __syncthreads();
      stage_tile<T, CIN>(s_x, x, nullptr, nullptr, nullptr, nullptr, kPlain, b, h0, w0, H, W,
                         dil, 0.0f);
      for (int i = threadIdx.x; i < TOWER_PIX * COUT; i += blockDim.x) {
        const int q = i / COUT;
        const int gh = h0 + q / TOWER_TW;
        const int gw = w0 + q % TOWER_TW;
        s_g[i] = (gh < H && gw < W)
                     ? to_float(gy[((static_cast<int64_t>(b) * H + gh) * W + gw) * COUT +
                                   i % COUT])
                     : 0.0f;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < NE; ++k) {
        const int ent = threadIdx.x + k * TOWER_THREADS;
        if (ent >= E) continue;
        const int co = ent % COUT;
        const int rr = ent / COUT;
        const int tap = rr / CIN;
        const int o = ((tap / 3) * dil * tw + (tap % 3) * dil) * CS + rr % CIN;
        for (int q = 0; q < TOWER_PIX; ++q)
          acc[k] = fmaf(s_x[((q / TOWER_TW) * tw + q % TOWER_TW) * CS + o], s_g[q * COUT + co],
                        acc[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < NE; ++k) {
      const int ent = threadIdx.x + k * TOWER_THREADS;
      if (ent < E) row[ent] = acc[k];
    }
  }
}

// out[c] = sum over rows r < nrows of partials[r * stride + c], c < ncols:
// one block per column, rows in a fixed order per thread, then a fixed
// tree; the sums are in double.
__global__ void __launch_bounds__(TOWER_THREADS)
    column_sum_kernel(const float* __restrict__ partials, int nrows, int stride,
                      float* __restrict__ out) {
  __shared__ double sh[TOWER_THREADS];
  const int c = blockIdx.x;
  double a = 0.0;
  for (int r = threadIdx.x; r < nrows; r += blockDim.x)
    a += partials[static_cast<int64_t>(r) * stride + c];
  sh[threadIdx.x] = a;
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) sh[threadIdx.x] += sh[threadIdx.x + s];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[c] = static_cast<float>(sh[0]);
}

template <typename T, int CIN, int COUT>
static int launch_conv(const void* in, const void* res, const float* nrm, const float* shift,
                       void* x_out, const void* wts, void* out, float* partials,
                       const TowerEpilogueArgs& e, int B, int H, int W, int dil, int prologue,
                       int epilogue, float slope, cudaStream_t s) {
  const size_t smem = sizeof(float) * (9 * CIN * COUT + tower_tile_floats(CIN, dil));
  auto kernel = tower_conv_kernel<T, CIN, COUT>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((W + TOWER_TW - 1) / TOWER_TW, (H + TOWER_TH - 1) / TOWER_TH, B);
  kernel<<<grid, TOWER_THREADS, smem, s>>>(
      static_cast<const T*>(in), static_cast<const T*>(res), nrm, shift, static_cast<T*>(x_out),
      static_cast<const T*>(wts), static_cast<T*>(out), partials, e, H, W, dil, prologue,
      epilogue, slope);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
static int dispatch_conv(int cin, int cout, const void* in, const void* res, const float* nrm,
                         const float* shift, void* x_out, const void* wts, void* out,
                         float* partials, const TowerEpilogueArgs& e, int B, int H, int W,
                         int dil, int prologue, int epilogue, float slope, cudaStream_t s) {
#define TOWER_CONV_CASE(CI, CO)                                                               \
  if (cin == CI && cout == CO)                                                                \
    return launch_conv<T, CI, CO>(in, res, nrm, shift, x_out, wts, out, partials, e, B, H, W, \
                                  dil, prologue, epilogue, slope, s);
  TOWER_CONV_CASE(4, 32)   // layer 0 forward
  TOWER_CONV_CASE(32, 32)  // layers 1-6 forward, input gradients of layers 1-6
  TOWER_CONV_CASE(32, 1)   // layer 7 forward
  TOWER_CONV_CASE(1, 32)   // input gradient of layer 7
  TOWER_CONV_CASE(32, 4)   // input gradient of layer 0
#undef TOWER_CONV_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T, int CIN, int COUT>
static int launch_wgrad(const void* x, const void* gy, float* partials, int nblocks, int B,
                        int H, int W, int dil, cudaStream_t s) {
  const size_t smem = sizeof(float) * (TOWER_PIX * COUT + tower_tile_floats(CIN, dil));
  auto kernel = tower_wgrad_kernel<T, CIN, COUT>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<nblocks, TOWER_THREADS, smem, s>>>(static_cast<const T*>(x),
                                               static_cast<const T*>(gy), partials, B, H, W, dil);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
static int dispatch_wgrad(int cin, int cout, const void* x, const void* gy, float* partials,
                          int nblocks, int B, int H, int W, int dil, cudaStream_t s) {
  if (cin == 4 && cout == 32) return launch_wgrad<T, 4, 32>(x, gy, partials, nblocks, B, H, W, dil, s);
  if (cin == 32 && cout == 32) return launch_wgrad<T, 32, 32>(x, gy, partials, nblocks, B, H, W, dil, s);
  if (cin == 32 && cout == 1) return launch_wgrad<T, 32, 1>(x, gy, partials, nblocks, B, H, W, dil, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

static bool tower_dil_ok(int dil) { return dil == 1 || dil == 2 || dil == 4 || dil == 8; }

// One conv layer of the tower (forward, or the input gradient). in: the
// layer's input (x0, y_{p-1}, or gy); res: x_{p-1} (prologue kBnResidual);
// nrm/shift: the previous layer's BN terms (prologues kBn*); x_out: x_p, or
// null; wts: [9][cin][cout] in the storage type; bias (kForward); out:
// (B,H,W,cout); partials: [blocks][2][cout] channel sums (cout == 32), or
// null. kInputGrad: skip = gx_{p+1} or null; yprev = y_{p-1} or null, with
// mu/inv/nrm/shift of layer p - 1.
extern "C" int stereo_tower_conv(const void* in, const void* res, const void* nrm,
                                 const void* shift, void* x_out, const void* wts,
                                 const void* bias, void* out, void* partials, const void* skip,
                                 const void* yprev, const void* e_mu, const void* e_inv,
                                 const void* e_nrm, const void* e_shift, int B, int H, int W,
                                 int cin, int cout, int dil, int prologue, int epilogue,
                                 float slope, int dtype, void* stream) {
  if (B < 1 || H < 1 || W < 1 || !tower_dil_ok(dil) || (partials != nullptr && cout != 32))
    return static_cast<int>(cudaErrorInvalidValue);
  TowerEpilogueArgs e{static_cast<const float*>(bias), skip, yprev,
                      static_cast<const float*>(e_mu), static_cast<const float*>(e_inv),
                      static_cast<const float*>(e_nrm), static_cast<const float*>(e_shift)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* n = static_cast<const float*>(nrm);
  const float* sh = static_cast<const float*>(shift);
  float* pa = static_cast<float*>(partials);
  if (dtype == kFloat32)
    return dispatch_conv<float>(cin, cout, in, res, n, sh, x_out, wts, out, pa, e, B, H, W, dil,
                                prologue, epilogue, slope, s);
  if (dtype == kBFloat16)
    return dispatch_conv<__nv_bfloat16>(cin, cout, in, res, n, sh, x_out, wts, out, pa, e, B,
                                        H, W, dil, prologue, epilogue, slope, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// gy (n elements, C channels) and partials [ceil(n / 256)][2][C] (the db
// sums in the first C columns). y null: gy = g (the last layer).
extern "C" int stereo_tower_grad_y(const void* g, const void* y, const void* mu,
                                   const void* inv, const void* nrm, const void* shift,
                                   const void* m1, const void* m2, void* gy, void* partials,
                                   int nparts, int n, int C, float slope, int dtype,
                                   void* stream) {
  const int threads = STEREO_BN_TILE;
  if (n < 1 || threads % C != 0 || blocks_for(n, threads) != static_cast<unsigned>(nparts))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* f[6] = {static_cast<const float*>(mu), static_cast<const float*>(inv),
                       static_cast<const float*>(nrm), static_cast<const float*>(shift),
                       static_cast<const float*>(m1), static_cast<const float*>(m2)};
  float* pa = static_cast<float*>(partials);
  if (dtype == kFloat32) {
    tower_grad_y_kernel<float><<<nparts, threads, 0, s>>>(
        static_cast<const float*>(g), static_cast<const float*>(y), f[0], f[1], f[2], f[3],
        f[4], f[5], static_cast<float*>(gy), pa, n, C, slope);
  } else if (dtype == kBFloat16) {
    tower_grad_y_kernel<__nv_bfloat16><<<nparts, threads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(g), static_cast<const __nv_bfloat16*>(y), f[0], f[1],
        f[2], f[3], f[4], f[5], static_cast<__nv_bfloat16*>(gy), pa, n, C, slope);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Partial weight gradients [nblocks][9 * cin * cout] of one layer from its
// input x (B,H,W,cin) and output gradient gy (B,H,W,cout).
extern "C" int stereo_tower_wgrad(const void* x, const void* gy, void* partials, int nblocks,
                                  int B, int H, int W, int cin, int cout, int dil, int dtype,
                                  void* stream) {
  if (B < 1 || H < 1 || W < 1 || nblocks < 1 || !tower_dil_ok(dil))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* pa = static_cast<float*>(partials);
  if (dtype == kFloat32) return dispatch_wgrad<float>(cin, cout, x, gy, pa, nblocks, B, H, W, dil, s);
  if (dtype == kBFloat16)
    return dispatch_wgrad<__nv_bfloat16>(cin, cout, x, gy, pa, nblocks, B, H, W, dil, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// out[c] = sum_r partials[r * stride + c] for c < ncols, r < nrows.
extern "C" int stereo_column_sum(const void* partials, int nrows, int stride, int ncols,
                                 void* out, void* stream) {
  if (nrows < 1 || ncols < 1 || stride < ncols) return static_cast<int>(cudaErrorInvalidValue);
  column_sum_kernel<<<ncols, TOWER_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(partials), nrows, stride, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
