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
// backward, and in train mode each tile's per-channel sums of the rounded
// y_p and y_p^2 go to the tile's own row of a partials array;
// stereo_tower_stats reduces the rows in a fixed order, in double, to mu and
// var = E[y^2] - mu^2 (bn_stats.cuh's rule), with no float atomics.
//
// Backward, layer p = 7 .. 0 (tower_backward, tower.py:516-557), at most
// four launches a layer:
//   stereo_tower_grad_y   gl = gx_{p+1} * leaky'(y_p*nrm + shift),
//                         gy = nrm * (gl - m1 - xhat * m2) (the exact
//                         batch-statistics BN gradient), rounded to T; for
//                         p = 7 gy is the tower's output gradient and this
//                         launch is skipped
//   stereo_tower_wgrad    per-block partial dW[tap][ci][co] = sum x_p * gy
//                         and db[co] = sum gy, one row per block
//   stereo_tower_conv     (epilogue kInputGrad) gx_p by the transposed conv
//                         (the wrapper hands it the weights with the taps
//                         reversed and ci/co swapped), plus the residual
//                         gx_{p+1} for 1 <= p <= 6, and per-tile sums
//                         S1 = sum gl_{p-1}, S2 = sum gl_{p-1} * xhat_{p-1}
//                         for layer p - 1
//   stereo_tower_sums     every cross-block reduction of the layer (db and
//                         dW from the wgrad rows, S1/S2 from the conv's) in
//                         one launch: neighbouring threads take neighbouring
//                         columns, rows in a fixed order, in double
//
// Bound on an H100 at the training shape (2, 320, 960): the forward does
// about 70 GFLOP over about 0.56 GB and the backward twice the operations,
// so on the bf16 tensor cores both are bound by bytes (about 0.17 ms each).
//
// bfloat16: implicit GEMMs on the tensor cores (mma.cuh: cp.async,
// swizzled 64-byte channel rows, ldmatrix, mma.sync m16n8k16 with f32
// accumulators). Every operand is already rounded to bf16 (x_p, gy and the
// weights are T), so the products are exact and only the order of the f32
// sums differs from a CUDA-core sum.
//   conv (tower_conv_mma_kernel): layers 1-6 forward and their input
//     gradients (32 -> 32), and on one n8 tile with the weights
//     zero-padded, layer 7's forward (32 -> 1) and layer 0's input
//     gradient (32 -> 4). A block owns an 8x16 pixel tile at a time (a
//     persistent grid walks the tiles; a tile's outputs and sums do not
//     depend on which block computes it). It stages the layer's weights
//     once, and per tile the (8 + 2d) x (16 + 2d) input halo: by cp.async
//     for an input gradient, by 16-byte loads through the BN + LeakyReLU +
//     residual prologue for the forward. Warp r takes tile row r (one m16
//     tile of pixels) against all output channels; K = 9 taps x 2 k16
//     halves of ci in a fixed order. Per-channel sums reduce over the 8 row
//     groups by shuffles, then over the warps in order.
//   wgrad (tower_wgrad_mma_kernel): for 32 input channels M = 288 (tap,
//     ci), N = COUT, K = the pixels of a fixed set of tiles per block
//     (WGRAD_BLOCKS). Warp k < 9 owns tap k (two m16 tiles of ci); A is the
//     shifted halo read with ldmatrix.trans, B the staged gy tile (layer 7:
//     1 channel padded to 8). Layer 0 (4 input channels) takes the
//     transpose: M = co from gy, N = ci from the halo padded to 8. A tenth
//     warp multiplies gy by a matrix of ones: db, the column sums of gy,
//     in the same pass.
// The input is staged through shared memory as it is, so a layer with 4 or
// 1 input channels (layer 0's forward, layer 7's input gradient, K = 36 and
// 9) stays a direct convolution on the CUDA cores (tower_conv_kernel), as
// does float32 (tower_conv_kernel, tower_wgrad_kernel): TF32 would keep
// about 3 digits over K = 288.

#include <type_traits>

#include "common.cuh"
#include "mma.cuh"

#define TOWER_TH 8
#define TOWER_TW 16
#define TOWER_PIX (TOWER_TH * TOWER_TW)
#define TOWER_THREADS 256
#define TOWER_C 32                 // channels of the 32-channel activations
#define WGRAD_MMA_THREADS 320      // 9 tap warps + the db warp
#define SUM_SLICES 32              // row slices of a column in stereo_tower_sums

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

// ---- bf16 convs on the tensor cores ---------------------------------------
//
// Staged rows are 64 bytes (32 channels, swizzled, mma.cuh) or, for a side
// of 4 or 1 channels, 16 bytes (8 channels, zero-padded: 8 consecutive
// such rows fill 128 bytes, so ldmatrix needs no swizzle there).

__host__ __device__ constexpr int mma_halo_rows(int dil) {
  return (TOWER_TH + 2 * dil) * (TOWER_TW + 2 * dil);
}
// Elements of one staged row of a side with c channels.
__host__ __device__ constexpr int mma_row(int c) { return c == TOWER_C ? TOWER_C : 8; }
// Dynamic shared memory of tower_conv_mma_kernel<COUT>: the weights as
// 9 x 32 rows, then the halo.
static inline size_t conv_mma_smem(int cout, int dil) {
  return static_cast<size_t>(9 * TOWER_C * mma_row(cout) + mma_halo_rows(dil) * TOWER_C) * 2;
}
// ... and of tower_wgrad_mma_kernel<CIN, COUT>: the gy tile (128 rows),
// then the halo.
static inline size_t wgrad_mma_smem(int cin, int cout, int dil) {
  return static_cast<size_t>(TOWER_PIX * mma_row(cout) + mma_halo_rows(dil) * mma_row(cin)) * 2;
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Stage the (8 + 2d) x (16 + 2d) x 32 halo of the tile at (b, h0, w0) into
// swizzled rows (row R = cy * tw + cx), zeros outside the image. kPlain:
// cp.async, complete at cp_async_wait_all. kBn / kBnResidual: 16-byte loads
// through round_T(leaky(in * nrm + shift) [+ res]) with nrm / shift from
// shared memory, and x_out written for the tile's interior pixels.
__device__ __forceinline__ void stage_halo_mma(__nv_bfloat16* halo, const __nv_bfloat16* in,
                                               const __nv_bfloat16* res, const float (&pro)[2][32],
                                               __nv_bfloat16* x_out, int prologue, int b,
                                               int h0, int w0, int H, int W, int dil,
                                               float slope) {
  const int tw = TOWER_TW + 2 * dil;
  const int n = mma_halo_rows(dil) * 4;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int R = i >> 2, c = i & 3;
    const int cy = R / tw, cx = R - cy * tw;
    const int gh = h0 - dil + cy, gw = w0 - dil + cx;
    const bool ok = gh >= 0 && gh < H && gw >= 0 && gw < W;
    const int64_t gi = ok ? ((static_cast<int64_t>(b) * H + gh) * W + gw) * TOWER_C + c * 8 : 0;
    __nv_bfloat16* dst = halo + swz(R, c);
    if (prologue == kPlain) {
      cp_async16(dst, in + gi, ok);
      continue;
    }
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (ok) {
      const uint4 yv = *reinterpret_cast<const uint4*>(in + gi);
      uint4 rv = make_uint4(0u, 0u, 0u, 0u);
      if (prologue == kBnResidual) rv = *reinterpret_cast<const uint4*>(res + gi);
      const __nv_bfloat162* y2 = reinterpret_cast<const __nv_bfloat162*>(&yv);
      const __nv_bfloat162* r2 = reinterpret_cast<const __nv_bfloat162*>(&rv);
      __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 yf = __bfloat1622float2(y2[j]);
        const int ch = c * 8 + 2 * j;
        float v0 = yf.x * pro[0][ch] + pro[1][ch];
        float v1 = yf.y * pro[0][ch + 1] + pro[1][ch + 1];
        v0 = v0 >= 0.0f ? v0 : slope * v0;
        v1 = v1 >= 0.0f ? v1 : slope * v1;
        if (prologue == kBnResidual) {
          const float2 rf = __bfloat1622float2(r2[j]);
          v0 += rf.x;
          v1 += rf.y;
        }
        o2[j] = __floats2bfloat162_rn(v0, v1);
      }
      if (x_out != nullptr && cy >= dil && cy < dil + TOWER_TH && cx >= dil &&
          cx < dil + TOWER_TW)
        *reinterpret_cast<uint4*>(x_out + gi) = v;
    }
    *reinterpret_cast<uint4*>(dst) = v;
  }
}

// Tile t of a persistent grid is (b, ty, tx) = (t / (nty ntx), t / ntx % nty,
// t % ntx).
struct TowerTile {
  int b, h0, w0;
};
__device__ __forceinline__ TowerTile tower_tile(int t, int nty, int ntx) {
  return {t / (nty * ntx), (t / ntx) % nty * TOWER_TH, t % ntx * TOWER_TW};
}

// One 32 -> COUT layer in bf16 (forward or input gradient; arguments as
// tower_conv_kernel's): the 32 -> 32 layers, layer 7's forward (COUT = 1)
// and layer 0's input gradient (COUT = 4), the last two on one n8 tile with
// the weights zero-padded to 8 output channels. A persistent grid: block k
// computes tiles k, k + gridDim.x, ...; tile t's channel sums (COUT = 32)
// go to partials row t.
template <int COUT>
__global__ void __launch_bounds__(TOWER_THREADS)
    tower_conv_mma_kernel(const __nv_bfloat16* __restrict__ in,
                          const __nv_bfloat16* __restrict__ res,
                          const float* __restrict__ pro_nrm, const float* __restrict__ pro_shift,
                          __nv_bfloat16* __restrict__ x_out,
                          const __nv_bfloat16* __restrict__ wts, __nv_bfloat16* __restrict__ out,
                          float* __restrict__ partials, TowerEpilogueArgs e, int B, int H, int W,
                          int dil, int prologue, int epilogue, float slope) {
  constexpr int NT = COUT == TOWER_C ? 4 : 1;  // n8 tiles of output channels
  extern __shared__ __align__(128) unsigned char tower_mma_smem[];
  __nv_bfloat16* s_w = reinterpret_cast<__nv_bfloat16*>(tower_mma_smem);
  __nv_bfloat16* halo = s_w + 9 * TOWER_C * mma_row(COUT);
  __shared__ float pro[2][32];
  __shared__ float red[2][TOWER_THREADS / 32][32];
  const int tw = TOWER_TW + 2 * dil;
  const int ntx = (W + TOWER_TW - 1) / TOWER_TW, nty = (H + TOWER_TH - 1) / TOWER_TH;
  const int ntiles = B * nty * ntx;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const __nv_bfloat16* skip = static_cast<const __nv_bfloat16*>(e.skip);
  const __nv_bfloat16* yprev = static_cast<const __nv_bfloat16*>(e.yprev);

  if constexpr (COUT == TOWER_C) {
    for (int i = threadIdx.x; i < 9 * TOWER_C * 4; i += blockDim.x)
      cp_async16(s_w + swz(i >> 2, i & 3), wts + (i >> 2) * TOWER_C + (i & 3) * 8, true);
  } else {  // plain stores, visible after the first tile's barrier
    for (int i = threadIdx.x; i < 9 * TOWER_C * 8; i += blockDim.x)
      s_w[i] = (i & 7) < COUT ? wts[(i >> 3) * COUT + (i & 7)] : __float2bfloat16_rn(0.0f);
  }
  if (threadIdx.x < 32 && prologue != kPlain) {
    pro[0][threadIdx.x] = pro_nrm[threadIdx.x];
    pro[1][threadIdx.x] = pro_shift[threadIdx.x];
  }
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const TowerTile tile = tower_tile(t, nty, ntx);
    __syncthreads();  // the previous tile's halo and sums are consumed
    stage_halo_mma(halo, in, res, pro, x_out, prologue, tile.b, tile.h0, tile.w0, H, W, dil,
                   slope);
    cp_async_wait_all();
    __syncthreads();

    // Warp r: pixels (h0 + r, w0 + m), m < 16, against the output channels.
    float acc[NT][4] = {};
#pragma unroll 1
    for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        const int tap = ky * 3 + kx;
        const int R = (warp + ky * dil) * tw + kx * dil + (lane & 15);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          unsigned a[4];
          ldsm_x4(a, halo + swz(R, half * 2 + (lane >> 4)));
          const int Rk = tap * TOWER_C + half * 16 + (lane & 15);
          if constexpr (NT == 4) {
            unsigned b0[4], b1[4];
            ldsm_x4_trans(b0, s_w + swz(Rk, lane >> 4));
            ldsm_x4_trans(b1, s_w + swz(Rk, 2 + (lane >> 4)));
            mma_bf16(acc[0], a, b0[0], b0[1]);
            mma_bf16(acc[1], a, b0[2], b0[3]);
            mma_bf16(acc[2], a, b1[0], b1[1]);
            mma_bf16(acc[3], a, b1[2], b1[3]);
          } else {
            unsigned b[2];
            ldsm_x2_trans(b, s_w + Rk * 8);
            mma_bf16(acc[0], a, b[0], b[1]);
          }
        }
      }
    }

    // acc[nt][2 * hr + k]: pixel m = g + 8 hr, channel nt * 8 + 2q + k.
    float s1[NT][2] = {}, s2[NT][2] = {};
    const int gh = tile.h0 + warp;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int gw = tile.w0 + g + 8 * hr;
      if (gh >= H || gw >= W) continue;
      const int64_t gi = ((static_cast<int64_t>(tile.b) * H + gh) * W + gw) * COUT;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int co = nt * 8 + 2 * q;
        if (co >= COUT) continue;
        float v0 = acc[nt][2 * hr], v1 = acc[nt][2 * hr + 1];
        if (epilogue == kForward) {
          v0 = bf16_round(v0 + e.bias[co]);
          if (COUT > 1) v1 = bf16_round(v1 + e.bias[co + 1]);
          s1[nt][0] += v0;
          s1[nt][1] += v1;
          s2[nt][0] += v0 * v0;
          s2[nt][1] += v1 * v1;
        } else if constexpr (COUT == TOWER_C) {
          if (skip != nullptr) {
            const float2 sk =
                __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(skip + gi + co));
            v0 += sk.x;
            v1 += sk.y;
          }
          if (yprev != nullptr) {
            const float2 y =
                __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(yprev + gi + co));
            const float gv[2] = {v0, v1}, yv[2] = {y.x, y.y};
#pragma unroll
            for (int k = 0; k < 2; ++k) {
              const int c = co + k;
              const float xhat = (yv[k] - e.mu[c]) * e.inv[c];
              const float gl = (yv[k] * e.nrm[c] + e.shift[c] >= 0.0f) ? gv[k] : slope * gv[k];
              s1[nt][k] += gl;
              s2[nt][k] += gl * xhat;
            }
          }
        }
        if constexpr (COUT == 1)
          out[gi] = __float2bfloat16_rn(v0);
        else
          *reinterpret_cast<__nv_bfloat162*>(out + gi + co) = __floats2bfloat162_rn(v0, v1);
      }
    }
    if (COUT == TOWER_C && partials != nullptr) {
      // Over the 8 row groups g (lanes q, q + 4, ..., q + 28), then over the
      // warps in order.
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int k = 0; k < 2; ++k)
#pragma unroll
          for (int off = 4; off < 32; off <<= 1) {
            s1[nt][k] += __shfl_xor_sync(0xffffffffu, s1[nt][k], off);
            s2[nt][k] += __shfl_xor_sync(0xffffffffu, s2[nt][k], off);
          }
      if (g == 0) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            red[0][warp][nt * 8 + 2 * q + k] = s1[nt][k];
            red[1][warp][nt * 8 + 2 * q + k] = s2[nt][k];
          }
      }
      __syncthreads();
      if (threadIdx.x < 32) {
        float a = 0.0f, sq = 0.0f;
#pragma unroll
        for (int w = 0; w < TOWER_THREADS / 32; ++w) {
          a += red[0][w][threadIdx.x];
          sq += red[1][w][threadIdx.x];
        }
        partials[static_cast<int64_t>(t) * 64 + threadIdx.x] = a;
        partials[static_cast<int64_t>(t) * 64 + 32 + threadIdx.x] = sq;
      }
    }
  }
}

// Eight consecutive elements as f32, in one or two 16-byte accesses.
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    v[2 * j] = f.x;
    v[2 * j + 1] = f.y;
  }
}
__device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&v)[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) h[j] = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

// gy of layer p < 7 from the gradient g = gx_{p+1} of its output, rounded
// to T (n elements, C channels; 8 consecutive elements a thread).
template <typename T>
__global__ void __launch_bounds__(TOWER_THREADS)
    tower_grad_y_kernel(const T* __restrict__ g, const T* __restrict__ y,
                        const float* __restrict__ mu, const float* __restrict__ inv,
                        const float* __restrict__ nrm, const float* __restrict__ shift,
                        const float* __restrict__ m1, const float* __restrict__ m2,
                        T* __restrict__ gy, int64_t n, int C, float slope) {
  const int64_t i = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) * 8;
  if (i >= n) return;
  const int c0 = static_cast<int>(i % C);
  float gv[8], yv[8], out[8];
  load8(g + i, gv);
  load8(y + i, yv);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = c0 + j;
    const float xhat = (yv[j] - mu[c]) * inv[c];
    const float gl = (yv[j] * nrm[c] + shift[c] >= 0.0f) ? gv[j] : slope * gv[j];
    out[j] = nrm[c] * (gl - m1[c] - xhat * m2[c]);
  }
  store8(gy + i, out);
}

// mu and var of the 32 channels from per-tile rows [nrows][2][32] of sums
// of y and y^2, over count elements a channel: thread (slice s, column c)
// sums rows s, s + STATS_SLICES, ... of column c in double; then thread
// c < 32 adds the slices in order, for y (column c) and y^2 (column 32 + c).
#define STATS_SLICES 16
__global__ void __launch_bounds__(64 * STATS_SLICES)
    tower_stats_kernel(const float* __restrict__ partials, int nrows, int count,
                       float* __restrict__ mu, float* __restrict__ var) {
  __shared__ double sh[STATS_SLICES][64];
  const int c = threadIdx.x & 63, s = threadIdx.x >> 6;
  double a = 0.0;
  for (int r = s; r < nrows; r += STATS_SLICES) a += partials[static_cast<int64_t>(r) * 64 + c];
  sh[s][c] = a;
  __syncthreads();
  if (threadIdx.x < 32) {
    double y = 0.0, q = 0.0;
    for (int j = 0; j < STATS_SLICES; ++j) {
      y += sh[j][threadIdx.x];
      q += sh[j][32 + threadIdx.x];
    }
    const double m = y / count;
    mu[threadIdx.x] = static_cast<float>(m);
    var[threadIdx.x] = static_cast<float>(q / count - m * m);
  }
}

// Partial weight and bias gradients in f32: block k sums, over the pixels of
// tiles k, k + gridDim.x, ..., dW[tap][ci][co] = x[pix + off(tap)][ci] *
// gy[pix][co] and db[co] = gy[pix][co] into partials[k][9 * CIN * COUT + COUT].
template <int CIN, int COUT>
__global__ void __launch_bounds__(TOWER_THREADS)
    tower_wgrad_kernel(const float* __restrict__ x, const float* __restrict__ gy,
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
  float* row = partials + static_cast<int64_t>(blockIdx.x) * (E + COUT);

  if constexpr (COUT == 32) {
    // Thread: output channels 4*co4 .. +3 of rows r + 32 j of (tap, ci).
    constexpr int NJ = (9 * CIN + 31) / 32;
    const int co4 = threadIdx.x & 7;
    const int r = threadIdx.x >> 3;
    float acc[NJ][4] = {};
    float db[4] = {};  // the sums of gy over the pixels in order: db
    int off[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int rr = min(r + 32 * j, 9 * CIN - 1);
      const int tap = rr / CIN;
      off[j] = ((tap / 3) * dil * tw + (tap % 3) * dil) * CS + rr % CIN;
    }
    for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
      const auto [b, h0, w0] = tower_tile(t, nty, ntx);
      __syncthreads();
      stage_tile<float, CIN>(s_x, x, nullptr, nullptr, nullptr, nullptr, kPlain, b, h0, w0, H, W,
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
        db[0] += g4.x;
        db[1] += g4.y;
        db[2] += g4.z;
        db[3] += g4.w;
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
    if (r == 0)
#pragma unroll
      for (int c = 0; c < 4; ++c) row[E + 4 * co4 + c] = db[c];
  } else {
    // Few output channels (layer 7: 1): entries e = tid, tid + 256, ...
    constexpr int NE = (E + TOWER_THREADS - 1) / TOWER_THREADS;
    float acc[NE] = {};
    // db: thread t adds gy[q][t % COUT] over the pixels q = t / COUT + k * DBS
    // of every tile, in order; the DBS slices are added in order at the end.
    constexpr int DBS = TOWER_THREADS / COUT;
    float db = 0.0f;
    for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
      const auto [b, h0, w0] = tower_tile(t, nty, ntx);
      __syncthreads();
      stage_tile<float, CIN>(s_x, x, nullptr, nullptr, nullptr, nullptr, kPlain, b, h0, w0, H, W,
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
      for (int q = threadIdx.x / COUT; q < TOWER_PIX; q += DBS)
        db += s_g[q * COUT + threadIdx.x % COUT];
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
    __shared__ float db_slices[TOWER_THREADS];
    db_slices[threadIdx.x] = db;
    __syncthreads();
    if (threadIdx.x < COUT) {
      float a = 0.0f;
      for (int j = 0; j < DBS; ++j) a += db_slices[j * COUT + threadIdx.x];
      row[E + threadIdx.x] = a;
    }
  }
}

// Weight and bias gradients in bf16 on the tensor cores (rows as
// tower_wgrad_kernel's: 9 * CIN * COUT dW entries, then COUT db), for the
// layers 1-6 (32 -> 32), layer 7 (32 -> 1) and layer 0 (4 -> 32). Warp
// k < 9 owns tap k = 3 ky + kx, whose operand is the halo shifted by the
// tap; warp 9 multiplies gy by a matrix of ones, so its products are the
// column sums of gy (db). K steps over the tile rows in order (16 pixels
// each), tiles in order.
//   CIN = 32: M = ci (two m16 tiles), A = the shifted halo read with
//     ldmatrix.trans; N = co, B = the gy tile (COUT = 1: one n8 tile, gy
//     zero-padded to 8 channels).
//   CIN = 4: the transpose, M = co (two m16 tiles), A = the gy tile read
//     with ldmatrix.trans; N = ci, B = the shifted halo, zero-padded to 8
//     channels (one n8 tile).
template <int CIN, int COUT>
__global__ void __launch_bounds__(WGRAD_MMA_THREADS)
    tower_wgrad_mma_kernel(const __nv_bfloat16* __restrict__ x,
                           const __nv_bfloat16* __restrict__ gy, float* __restrict__ partials,
                           int B, int H, int W, int dil) {
  static_assert((CIN == 32 && (COUT == 32 || COUT == 1)) || (CIN == 4 && COUT == 32),
                "the tower's layers");
  constexpr int NT = CIN == TOWER_C && COUT == TOWER_C ? 4 : 1;  // n8 tiles
  constexpr unsigned kOnes = 0x3F803F80u;                        // two bf16 1.0
  extern __shared__ __align__(128) unsigned char tower_mma_smem[];
  __nv_bfloat16* s_g = reinterpret_cast<__nv_bfloat16*>(tower_mma_smem);
  __nv_bfloat16* halo = s_g + TOWER_PIX * mma_row(COUT);
  const int tw = TOWER_TW + 2 * dil;
  const int ntx = (W + TOWER_TW - 1) / TOWER_TW, nty = (H + TOWER_TH - 1) / TOWER_TH;
  const int ntiles = B * nty * ntx;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const int ky = warp / 3, kx = warp % 3;
  float acc[2][NT][4] = {};

  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const TowerTile tile = tower_tile(t, nty, ntx);
    __syncthreads();
    for (int i = threadIdx.x; i < mma_halo_rows(dil) * (CIN == TOWER_C ? 4 : 1);
         i += blockDim.x) {
      const int R = CIN == TOWER_C ? i >> 2 : i, c = CIN == TOWER_C ? i & 3 : 0;
      const int cy = R / tw, cx = R - cy * tw;
      const int gh = tile.h0 - dil + cy, gw = tile.w0 - dil + cx;
      const bool ok = gh >= 0 && gh < H && gw >= 0 && gw < W;
      const int64_t gi = ok ? ((static_cast<int64_t>(tile.b) * H + gh) * W + gw) * CIN + c * 8 : 0;
      if constexpr (CIN == TOWER_C) {
        cp_async16(halo + swz(R, c), x + gi, ok);
      } else {  // 4 channels (8 bytes) and 4 zeros
        const uint2 v = ok ? *reinterpret_cast<const uint2*>(x + gi) : make_uint2(0u, 0u);
        *reinterpret_cast<uint4*>(halo + R * 8) = make_uint4(v.x, v.y, 0u, 0u);
      }
    }
    for (int i = threadIdx.x; i < TOWER_PIX * (COUT == TOWER_C ? 4 : 1); i += blockDim.x) {
      const int P = COUT == TOWER_C ? i >> 2 : i, c = COUT == TOWER_C ? i & 3 : 0;
      const int gh = tile.h0 + P / TOWER_TW, gw = tile.w0 + P % TOWER_TW;
      const bool ok = gh < H && gw < W;
      const int64_t gi =
          ok ? ((static_cast<int64_t>(tile.b) * H + gh) * W + gw) * COUT + c * 8 : 0;
      if constexpr (COUT == TOWER_C) {
        cp_async16(s_g + swz(P, c), gy + gi, ok);
      } else {  // 1 channel and 7 zeros
        const unsigned v = ok ? static_cast<unsigned>(
                                    *reinterpret_cast<const unsigned short*>(gy + gi))
                              : 0u;
        *reinterpret_cast<uint4*>(s_g + P * 8) = make_uint4(v, 0u, 0u, 0u);
      }
    }
    cp_async_wait_all();
    __syncthreads();
#pragma unroll 1
    for (int r = 0; r < TOWER_TH; ++r) {
      // Pixel rows of this k step: lanes 0-15 address pixels 0-15 (x2 and
      // x4 B loads); for a transposed A, matrix i = lane / 8 holds channel
      // chunk i & 1 and pixels 8 (i >> 1) .. + 7.
      const int P = r * TOWER_TW + (lane & 15);
      const int PA = r * TOWER_TW + ((lane >> 4) & 1) * 8 + (lane & 7);
      const int shift = ky * dil * tw + kx * dil;
      if constexpr (CIN == TOWER_C) {
        unsigned b[2 * NT];
        if constexpr (NT == 4) {
          unsigned b0[4], b1[4];
          ldsm_x4_trans(b0, s_g + swz(P, lane >> 4));
          ldsm_x4_trans(b1, s_g + swz(P, 2 + (lane >> 4)));
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            b[j] = b0[j];
            b[4 + j] = b1[j];
          }
        } else {
          ldsm_x2_trans(b, s_g + P * 8);
        }
        if (warp < 9) {
          const int R = (PA / TOWER_TW) * tw + PA % TOWER_TW + shift;
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            unsigned a[4];
            ldsm_x4_trans(a, halo + swz(R, 2 * mt + ((lane >> 3) & 1)));
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) mma_bf16(acc[mt][nt], a, b[2 * nt], b[2 * nt + 1]);
          }
        } else {
          const unsigned ones[4] = {kOnes, kOnes, kOnes, kOnes};
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) mma_bf16(acc[0][nt], ones, b[2 * nt], b[2 * nt + 1]);
        }
      } else {
        unsigned a[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          ldsm_x4_trans(a[mt], s_g + swz(PA, 2 * mt + ((lane >> 3) & 1)));
        unsigned b[2] = {kOnes, kOnes};
        if (warp < 9) {
          const int R = (P / TOWER_TW) * tw + P % TOWER_TW + shift;
          ldsm_x2_trans(b, halo + R * 8);
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) mma_bf16(acc[mt][0], a[mt], b[0], b[1]);
      }
    }
  }
  // acc[mt][nt][2 hr + k]: row 16 mt + g + 8 hr, column 8 nt + 2q + k.
  constexpr int E = 9 * CIN * COUT;
  float* row = partials + static_cast<int64_t>(blockIdx.x) * (E + COUT);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr)
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const int m = 16 * mt + g + 8 * hr, n = 8 * nt + 2 * q + k;
          const float v = acc[mt][nt][2 * hr + k];
          if constexpr (CIN == TOWER_C) {  // m = ci, n = co
            if (n >= COUT) continue;
            if (warp < 9)
              row[(warp * TOWER_C + m) * COUT + n] = v;
            else if (g == 0 && hr == 0 && mt == 0)  // every row of the ones-product
              row[E + n] = v;
          } else {  // m = co, n = ci
            if (warp < 9 && n < CIN)
              row[(warp * CIN + n) * COUT + m] = v;
            else if (warp == 9 && q == 0 && k == 0)  // every column of the ones-product
              row[E + m] = v;
          }
        }
}

// One segment of a cross-block sum: out[c] = sum_r partials[r * ncols + c].
struct SumSegment {
  const float* partials;
  int nrows, ncols;
  float* out;
};

// The columns of segment a, then those of b, 32 to a block: lane l of warp
// s takes column 32 * blockIdx.x + l and sums its rows s, s + 32, ... in
// order, in double; then warp 0 adds the 32 slices in order.
__global__ void __launch_bounds__(32 * SUM_SLICES)
    tower_sums_kernel(SumSegment a, SumSegment b) {
  __shared__ double sh[SUM_SLICES][32];
  const int lane = threadIdx.x & 31, slice = threadIdx.x >> 5;
  int c = blockIdx.x * 32 + lane;
  const bool in_a = c < a.ncols;
  const SumSegment s = in_a ? a : b;
  if (!in_a) c -= a.ncols;
  const bool valid = c < s.ncols;
  double acc = 0.0;
  if (valid)
    for (int r = slice; r < s.nrows; r += SUM_SLICES)
      acc += s.partials[static_cast<int64_t>(r) * s.ncols + c];
  sh[slice][lane] = acc;
  __syncthreads();
  if (slice == 0 && valid) {
    double t = 0.0;
    for (int j = 0; j < SUM_SLICES; ++j) t += sh[j][lane];
    s.out[c] = static_cast<float>(t);
  }
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

// The persistent grid of tower_conv_mma_kernel: as many blocks as fit on
// the card at once, at most one a tile.
template <int COUT>
static int launch_conv_mma(const void* in, const void* res, const float* nrm, const float* shift,
                           void* x_out, const void* wts, void* out, float* partials,
                           const TowerEpilogueArgs& e, int B, int H, int W, int dil,
                           int prologue, int epilogue, float slope, cudaStream_t s) {
  const size_t smem = conv_mma_smem(COUT, dil);
  auto kernel = tower_conv_mma_kernel<COUT>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, TOWER_THREADS,
                                                           smem)) != cudaSuccess)
    return static_cast<int>(err);
  const int64_t ntiles = static_cast<int64_t>(B) * ((H + TOWER_TH - 1) / TOWER_TH) *
                         ((W + TOWER_TW - 1) / TOWER_TW);
  const int grid = static_cast<int>(min(ntiles, static_cast<int64_t>(max(per_sm, 1)) * sms));
  kernel<<<grid, TOWER_THREADS, smem, s>>>(
      static_cast<const __nv_bfloat16*>(in), static_cast<const __nv_bfloat16*>(res), nrm, shift,
      static_cast<__nv_bfloat16*>(x_out), static_cast<const __nv_bfloat16*>(wts),
      static_cast<__nv_bfloat16*>(out), partials, e, B, H, W, dil, prologue, epilogue, slope);
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
#define TOWER_CONV_MMA_CASE(CO)                                                               \
  if (cin == 32 && cout == CO)                                                                \
    return launch_conv_mma<CO>(in, res, nrm, shift, x_out, wts, out, partials, e, B, H, W,    \
                               dil, prologue, epilogue, slope, s);
  // Layers 1-6 forward and their input gradients (32 -> 32), layer 7
  // forward (32 -> 1), the input gradient of layer 0 (32 -> 4):
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    TOWER_CONV_MMA_CASE(32)
    TOWER_CONV_MMA_CASE(1)
    TOWER_CONV_MMA_CASE(4)
  } else {
    TOWER_CONV_CASE(32, 32)
    TOWER_CONV_CASE(32, 1)
    TOWER_CONV_CASE(32, 4)
  }
  TOWER_CONV_CASE(4, 32)   // layer 0 forward
  TOWER_CONV_CASE(1, 32)   // input gradient of layer 7
#undef TOWER_CONV_MMA_CASE
#undef TOWER_CONV_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int CIN, int COUT>
static int launch_wgrad(const void* x, const void* gy, float* partials, int nblocks, int B,
                        int H, int W, int dil, cudaStream_t s) {
  const size_t smem = sizeof(float) * (TOWER_PIX * COUT + tower_tile_floats(CIN, dil));
  auto kernel = tower_wgrad_kernel<CIN, COUT>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<nblocks, TOWER_THREADS, smem, s>>>(static_cast<const float*>(x),
                                               static_cast<const float*>(gy), partials, B, H, W,
                                               dil);
  return static_cast<int>(cudaGetLastError());
}

template <int CIN, int COUT>
static int launch_wgrad_mma(const void* x, const void* gy, float* partials, int nblocks, int B,
                            int H, int W, int dil, cudaStream_t s) {
  const size_t smem = wgrad_mma_smem(CIN, COUT, dil);
  auto kernel = tower_wgrad_mma_kernel<CIN, COUT>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<nblocks, WGRAD_MMA_THREADS, smem, s>>>(static_cast<const __nv_bfloat16*>(x),
                                                   static_cast<const __nv_bfloat16*>(gy),
                                                   partials, B, H, W, dil);
  return static_cast<int>(cudaGetLastError());
}

// bf16 on the tensor cores, f32 on the CUDA cores.
template <typename T>
static int dispatch_wgrad(int cin, int cout, const void* x, const void* gy, float* partials,
                          int nblocks, int B, int H, int W, int dil, cudaStream_t s) {
#define TOWER_WGRAD_CASE(CI, CO)                                                          \
  if (cin == CI && cout == CO) {                                                          \
    if constexpr (std::is_same<T, __nv_bfloat16>::value)                                  \
      return launch_wgrad_mma<CI, CO>(x, gy, partials, nblocks, B, H, W, dil, s);         \
    else                                                                                  \
      return launch_wgrad<CI, CO>(x, gy, partials, nblocks, B, H, W, dil, s);             \
  }
  TOWER_WGRAD_CASE(32, 32)  // layers 1-6
  TOWER_WGRAD_CASE(32, 1)   // layer 7
  TOWER_WGRAD_CASE(4, 32)   // layer 0
#undef TOWER_WGRAD_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

static bool tower_dil_ok(int dil) { return dil == 1 || dil == 2 || dil == 4 || dil == 8; }

// One conv layer of the tower (forward, or the input gradient). in: the
// layer's input (x0, y_{p-1}, or gy); res: x_{p-1} (prologue kBnResidual);
// nrm/shift: the previous layer's BN terms (prologues kBn*); x_out: x_p, or
// null; wts: [9][cin][cout] in the storage type; bias (kForward); out:
// (B,H,W,cout); partials: [tiles][2][cout] channel sums (cout == 32), or
// null. kInputGrad: skip = gx_{p+1} or null; yprev = y_{p-1} or null, with
// mu/inv/nrm/shift of layer p - 1. The bf16 32 -> 32 instance reads and
// writes its activations and weights in 16-byte chunks: they must start on
// a 16-byte boundary.
extern "C" int stereo_tower_conv(const void* in, const void* res, const void* nrm,
                                 const void* shift, void* x_out, const void* wts,
                                 const void* bias, void* out, void* partials, const void* skip,
                                 const void* yprev, const void* e_mu, const void* e_inv,
                                 const void* e_nrm, const void* e_shift, int B, int H, int W,
                                 int cin, int cout, int dil, int prologue, int epilogue,
                                 float slope, int dtype, void* stream) {
  if (B < 1 || H < 1 || W < 1 || !tower_dil_ok(dil) ||
      (cout != 32 && (partials != nullptr || skip != nullptr || yprev != nullptr)))
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

// gy (n elements, C channels, C a multiple of 8; g, y and gy on 16-byte
// boundaries) of a layer followed by a BatchNorm.
extern "C" int stereo_tower_grad_y(const void* g, const void* y, const void* mu,
                                   const void* inv, const void* nrm, const void* shift,
                                   const void* m1, const void* m2, void* gy, int n, int C,
                                   float slope, int dtype, void* stream) {
  if (n < 1 || C < 8 || C % 8 != 0 || n % C != 0 || g == nullptr || y == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* f[6] = {static_cast<const float*>(mu), static_cast<const float*>(inv),
                       static_cast<const float*>(nrm), static_cast<const float*>(shift),
                       static_cast<const float*>(m1), static_cast<const float*>(m2)};
  const unsigned blocks = blocks_for(n / 8, TOWER_THREADS);
  if (dtype == kFloat32) {
    tower_grad_y_kernel<float><<<blocks, TOWER_THREADS, 0, s>>>(
        static_cast<const float*>(g), static_cast<const float*>(y), f[0], f[1], f[2], f[3],
        f[4], f[5], static_cast<float*>(gy), n, C, slope);
  } else if (dtype == kBFloat16) {
    tower_grad_y_kernel<__nv_bfloat16><<<blocks, TOWER_THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(g), static_cast<const __nv_bfloat16*>(y), f[0], f[1],
        f[2], f[3], f[4], f[5], static_cast<__nv_bfloat16*>(gy), n, C, slope);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Partial weight and bias gradients [nblocks][9 * cin * cout + cout] of one
// layer from its input x (B,H,W,cin) and output gradient gy (B,H,W,cout).
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

// out_a[c] = sum_r partials_a[r * cols_a + c] for c < cols_a, r < rows_a,
// and the same for segment b (cols_b = 0: none), in one launch.
extern "C" int stereo_tower_sums(const void* partials_a, int rows_a, int cols_a, void* out_a,
                                 const void* partials_b, int rows_b, int cols_b, void* out_b,
                                 void* stream) {
  if (rows_a < 1 || cols_a < 1 || cols_b < 0 || (cols_b > 0 && rows_b < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const SumSegment a{static_cast<const float*>(partials_a), rows_a, cols_a,
                     static_cast<float*>(out_a)};
  const SumSegment b{static_cast<const float*>(partials_b), rows_b, cols_b,
                     static_cast<float*>(out_b)};
  const unsigned blocks = blocks_for(static_cast<int64_t>(cols_a) + cols_b, 32);
  tower_sums_kernel<<<blocks, 32 * SUM_SLICES, 0, static_cast<cudaStream_t>(stream)>>>(a, b);
  return static_cast<int>(cudaGetLastError());
}

// The batch statistics mu, var (32 channels) of a tower layer from the
// forward conv's per-tile rows [nrows][2][32], over count pixels.
extern "C" int stereo_tower_stats(const void* partials, int nrows, int count, void* mu,
                                  void* var, void* stream) {
  if (nrows < 1 || count < 1) return static_cast<int>(cudaErrorInvalidValue);
  tower_stats_kernel<<<1, 64 * STATS_SLICES, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(partials), nrows, count, static_cast<float*>(mu),
      static_cast<float*>(var));
  return static_cast<int>(cudaGetLastError());
}
