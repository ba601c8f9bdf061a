// The conv layer of the aggregation stack, shared by csrc/aggregation.cu
// (one layer per launch) and csrc/coarse_head.cu (the whole head in one
// launch), so that both compute every output alike:
//
//   y   = round_T(sum_{taps, ci} x[b, d+kd-1, h+kh-1, w+kw-1, ci] * k[tap, ci, co]
//                 + bias[co])                      (f32 accumulation)
//   out = round_T(leaky_0.2((y - mean[co]) * rsqrt(var[co] + eps) * gamma[co]
//                           + beta[co]))           (BN layers)
//
// Activations are channels-last (B, D, H, W, 32); weights are [tap][ci][co]
// with tap = (kd * 3 + kh) * 3 + kw (the DHWIO layout), co < 32 or co = 0
// (the final layer). Zero padding 1 in d, h and w.
//
// The work is cut into row tiles: one tile is a fixed (b, d, h) and a run
// of at most STEREO_TILE_MAX_W consecutive w (the wrapper's tile_plan picks
// the run length wc), and one block of STEREO_CONV_THREADS threads computes
// one tile at a time. Tile j covers w in [(j % ntw) * wc, ...) of row
// j / ntw, ntw = ceil(W / wc).
//
// bfloat16: an implicit GEMM on the tensor cores. Per tile, M = the tile's
// w (padded to mt, a multiple of 16), N = Cout, K = 27 taps x 32 channels
// = 864. The block stages the input halo, 3 (d) x 3 (h) x (mt + 2) (w) rows
// of 32 channels, with cp.async (L2 only: the fused head reads activations
// that other blocks wrote in the same launch) and zero-fill outside the
// volume; the caller stages the layer's weights beside it. Rows are 64
// bytes, swizzled as mma.cuh says, so ldmatrix is free of bank conflicts
// without padding. Each warp takes units of 16 rows x 16 output channels
// (mma.sync m16n8k16, bf16 -> f32, two n8 tiles), unit u = warp, warp + 8,
// ..., and walks K in a fixed order: taps in order, then the two k16
// halves of ci.
//
// float32: today's CUDA-core body, one output at a time in f32 fmaf, taps
// and channels in order (conv3d_tap_sum); the tensor cores' TF32 would keep
// about 3 digits over K = 864.
//
// Train mode: each tile's per-channel sums of y and y^2 (over its w < W)
// go to the tile's own row of partials, summed in a fixed order; the caller
// reduces the rows with bn_finalize (bn_stats.cuh).
#pragma once

#include <type_traits>

#include "bn_stats.cuh"
#include "common.cuh"
#include "mma.cuh"

#define STEREO_CONV_C 32           // channels of every activation
#define STEREO_TILE_MAX_W 80       // most w positions of one row tile
#define STEREO_CONV_THREADS STEREO_BN_TILE  // threads of a block (8 warps)

// Rows of one row tile's GEMM (wc padded to 16) and of its halo slabs.
__host__ __device__ __forceinline__ int tile_mt(int wc) { return (wc + 15) / 16 * 16; }
__host__ __device__ __forceinline__ int tile_halo_rows(int wc) { return tile_mt(wc) + 2; }
// Halo bytes, and the weights' bytes, of one block's bf16 staging.
__host__ __device__ __forceinline__ int tile_halo_bytes(int wc) {
  return 9 * tile_halo_rows(wc) * STEREO_CONV_C * 2;
}
#define STEREO_TILE_WEIGHT_BYTES (27 * STEREO_CONV_C * STEREO_CONV_C * 2)
// Dynamic shared memory of a block (ops/cuda/aggregation.py:tile_plan).
static inline int tile_smem(int dtype, int wc) {
  return dtype == kBFloat16 ? tile_halo_bytes(wc) + STEREO_TILE_WEIGHT_BYTES : 0;
}
// Row tiles of a (B, D, H, W) volume cut into runs of wc.
static inline int64_t tile_count(int B, int D, int H, int W, int wc) {
  return static_cast<int64_t>(B) * D * H * ((W + wc - 1) / wc);
}

enum ConvEpilogue : int {
  kConvOnly = 0,     // y (the final layer)
  kConvBnLeaky = 1,  // round_T(leaky(bn(y))) with the given statistics
  kConvStats = 2,    // y, and the tile's sums of y and y^2 into its row
};

// One layer's weights and epilogue. k is the layer's [27][32][cout] weights
// in T (the bf16 path reads them from the block's staging, stage_weights).
struct ConvLayer {
  const void* k;
  const float* bias;
  const float* mean;
  const float* var;
  const float* gamma;
  const float* beta;
  int epilogue;
  float eps, slope;
};

struct RowTile {
  int b, d, h, w0, wn;
  int64_t pos;  // flat index of (b, d, h, w0) among the B*D*H*W positions
};

__device__ __forceinline__ RowTile row_tile(int64_t tile, int D, int H, int W, int wc) {
  const int ntw = (W + wc - 1) / wc;
  RowTile t;
  const int j = static_cast<int>(tile % ntw);
  int64_t r = tile / ntw;
  t.h = static_cast<int>(r % H);
  r /= H;
  t.d = static_cast<int>(r % D);
  t.b = static_cast<int>(r / D);
  t.w0 = j * wc;
  t.wn = min(wc, W - t.w0);
  t.pos = ((static_cast<int64_t>(t.b) * D + t.d) * H + t.h) * W + t.w0;
  return t;
}

// The f32 sum of one conv output (b, d, h, w, co), taps in order and input
// channels in order within a tap; taps outside the volume are skipped. x
// carries no __restrict__: the fused head reads activations that other
// blocks wrote earlier in the same launch, so they must not go through the
// read-only (non-coherent) cache.
template <typename T>
__device__ __forceinline__ float conv3d_tap_sum(const T* x, const T* __restrict__ k, int b,
                                                int d, int h, int w, int co, int D, int H,
                                                int W, int Cin, int Cout) {
  float acc = 0.0f;
  for (int kd = 0; kd < 3; ++kd) {
    const int dd = d + kd - 1;
    if (dd < 0 || dd >= D) continue;
    for (int kh = 0; kh < 3; ++kh) {
      const int hh = h + kh - 1;
      if (hh < 0 || hh >= H) continue;
      for (int kw = 0; kw < 3; ++kw) {
        const int ww = w + kw - 1;
        if (ww < 0 || ww >= W) continue;
        const T* xp = x + (((static_cast<int64_t>(b) * D + dd) * H + hh) * W + ww) * Cin;
        const T* kp = k + static_cast<int64_t>((kd * 3 + kh) * 3 + kw) * Cin * Cout + co;
        for (int ci = 0; ci < Cin; ++ci) {
          acc = fmaf(to_float(xp[ci]), to_float(kp[static_cast<int64_t>(ci) * Cout]), acc);
        }
      }
    }
  }
  return acc;
}

// The conv output rounded to the compute type: BatchNorm sees what the plain
// stack's conv would have stored.
template <typename T>
__device__ __forceinline__ float conv3d_round(float acc, float bias) {
  return to_float(from_float<T>(acc + bias));
}

// BatchNorm with the given statistics, then LeakyReLU (f32; the caller
// rounds to the compute type).
__device__ __forceinline__ float bn_leaky(float y, float mean, float var, float gamma,
                                          float beta, float eps, float slope) {
  y = (y - mean) * rsqrtf(var + eps) * gamma + beta;
  return y >= 0.0f ? y : slope * y;
}

// ---- bf16 staging and tensor-core product -------------------------------

__device__ __forceinline__ unsigned char* conv_smem() {
  extern __shared__ __align__(128) unsigned char stereo_conv_smem[];
  return stereo_conv_smem;
}
__device__ __forceinline__ __nv_bfloat16* tile_halo(unsigned char* smem) {
  return reinterpret_cast<__nv_bfloat16*>(smem);
}
__device__ __forceinline__ __nv_bfloat16* tile_weights(unsigned char* smem, int wc) {
  return reinterpret_cast<__nv_bfloat16*>(smem + tile_halo_bytes(wc));
}

// Stage the tile's input halo: row R = slab * rows + p holds position
// (d + kd - 1, h + kh - 1, w0 - 1 + p), slab = kd * 3 + kh; zeros outside
// the volume. Completes at cp_async_wait_all.
__device__ __forceinline__ void stage_halo(const __nv_bfloat16* x, __nv_bfloat16* halo,
                                           const RowTile& t, int D, int H, int W, int rows) {
  const int n = 9 * rows * 4;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int R = i >> 2, c = i & 3;
    const int slab = R / rows, p = R - slab * rows;
    const int dd = t.d + slab / 3 - 1, hh = t.h + slab % 3 - 1, ww = t.w0 - 1 + p;
    const bool ok = dd >= 0 && dd < D && hh >= 0 && hh < H && ww >= 0 && ww < W;
    const __nv_bfloat16* src = x;
    if (ok) src += (((static_cast<int64_t>(t.b) * D + dd) * H + hh) * W + ww) * STEREO_CONV_C + c * 8;
    cp_async16(halo + swz(R, c), src, ok);
  }
}

// Stage a layer's bf16 weights: COUT = 32 as 864 swizzled 64-byte rows
// (cp.async, completes at cp_async_wait_all); COUT = 1 as 864 rows of 8
// with co 1..7 zero (plain stores, visible after the next __syncthreads).
template <int COUT>
__device__ __forceinline__ void stage_weights(const __nv_bfloat16* k, __nv_bfloat16* wts) {
  if constexpr (COUT == STEREO_CONV_C) {
    for (int i = threadIdx.x; i < 27 * STEREO_CONV_C * 4; i += blockDim.x)
      cp_async16(wts + swz(i >> 2, i & 3), k + (i >> 2) * STEREO_CONV_C + (i & 3) * 8, true);
  } else {
    static_assert(COUT == 1, "the stack's layers have 32 or 1 output channels");
    for (int i = threadIdx.x; i < 27 * STEREO_CONV_C * 8; i += blockDim.x)
      wts[i] = (i & 7) ? from_float<__nv_bfloat16>(0.0f) : k[i >> 3];
  }
}

// One warp's unit: rows m0..m0+15 of the tile against NT n8 tiles of output
// channels from n-chunk nc (NT = 2: channels 16 * nc .. +15 of 32; NT = 1:
// the final layer's padded 8). acc[j] is the m16n8 accumulator of n8 tile j.
template <int NT>
__device__ __forceinline__ void mma_unit(const __nv_bfloat16* halo, const __nv_bfloat16* wts,
                                         int rows, int m0, int nc, float (&acc)[NT][4]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
#pragma unroll 1
  for (int slab = 0; slab < 9; ++slab) {
#pragma unroll
    for (int kw = 0; kw < 3; ++kw) {
      const int tap = slab * 3 + kw;
      // A: lanes 0-15 give rows m0..m0+15 at k 0-7, lanes 16-31 at k 8-15.
      const int R = slab * rows + m0 + (lane & 15) + kw;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        unsigned a[4];
        ldsm_x4(a, halo + swz(R, half * 2 + (lane >> 4)));
        const int Rk = tap * STEREO_CONV_C + half * 16 + (lane & 15);
        if constexpr (NT == 2) {
          unsigned b[4];
          ldsm_x4_trans(b, wts + swz(Rk, nc * 2 + (lane >> 4)));
          mma_bf16(acc[0], a, b[0], b[1]);
          mma_bf16(acc[1], a, b[2], b[3]);
        } else {
          unsigned b[2];
          ldsm_x2_trans(b, wts + Rk * 8);
          mma_bf16(acc[0], a, b[0], b[1]);
        }
      }
    }
  }
}

// ---- one row tile ---------------------------------------------------------

// This block's per-channel sums (s[0][j] of y, s[1][j] of y^2 for slot j <
// blockDim.x, channel j % 32) to row[0][c], row[1][c]: slots in order.
__device__ __forceinline__ void tile_partials(float (&s)[2][STEREO_CONV_THREADS], float* row) {
  __syncthreads();
  const int c = threadIdx.x;
  if (c < STEREO_CONV_C) {
    float a = 0.0f, q = 0.0f;
    for (int j = c; j < static_cast<int>(blockDim.x); j += STEREO_CONV_C) {
      a += s[0][j];
      q += s[1][j];
    }
    row[c] = a;
    row[STEREO_CONV_C + c] = q;
  }
}

// Compute one row tile of a layer into out (position-major, COUT channels)
// and, for kConvStats, its partial sums into row. Every thread of the block
// calls it. bf16: the layer's weights must have been staged (stage_weights)
// into tile_weights(smem, wc) by this block, and the block must be done
// with the halo of its previous tile (the function ends with a barrier).
template <typename T, int COUT, typename OutT>
__device__ void conv3d_row_tile(const T* x, const ConvLayer& L, const RowTile& t, int D,
                                int H, int W, int wc, OutT* out, float* row) {
  __shared__ float sums[2][STEREO_CONV_THREADS];
  const bool stats = L.epilogue == kConvStats;
  if constexpr (std::is_same<T, float>::value) {
    const float* k = static_cast<const float*>(L.k);
    const int n = t.wn * COUT;
    float s1 = 0.0f, s2 = 0.0f;
    // COUT divides blockDim.x: thread i keeps channel i % COUT.
    for (int e = threadIdx.x; e < n; e += blockDim.x) {
      const int co = e % COUT;
      float y = conv3d_round<T>(conv3d_tap_sum<T>(x, k, t.b, t.d, t.h, t.w0 + e / COUT, co,
                                                  D, H, W, STEREO_CONV_C, COUT),
                                L.bias[co]);
      if (stats) {
        s1 += y;
        s2 += y * y;
      } else if (L.epilogue == kConvBnLeaky) {
        y = bn_leaky(y, L.mean[co], L.var[co], L.gamma[co], L.beta[co], L.eps, L.slope);
      }
      out[t.pos * COUT + e] = from_float<OutT>(y);
    }
    if (stats) {
      sums[0][threadIdx.x] = s1;
      sums[1][threadIdx.x] = s2;
    }
  } else {
    static_assert(std::is_same<T, __nv_bfloat16>::value, "float or bfloat16");
    unsigned char* smem = conv_smem();
    const int rows = tile_halo_rows(wc);
    stage_halo(x, tile_halo(smem), t, D, H, W, rows);
    cp_async_wait_all();
    __syncthreads();
    const __nv_bfloat16* halo = tile_halo(smem);
    const __nv_bfloat16* wts = tile_weights(smem, wc);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, q = lane & 3;
    const int mtiles = tile_mt(wc) / 16;
    constexpr int NT = COUT == STEREO_CONV_C ? 2 : 1;
    constexpr int NC = COUT == STEREO_CONV_C ? 2 : 1;  // n-chunks of NT n8 tiles
    float s[2][NT][2] = {};
    for (int u = warp; u < mtiles * NC; u += blockDim.x / 32) {
      const int m0 = (u / NC) * 16, nc = u % NC;
      float acc[NT][4];
      mma_unit<NT>(halo, wts, rows, m0, nc, acc);
      // acc[j][2 * hr + e]: row m0 + g + 8 * hr, channel nc * 16 + j * 8 + 2q + e.
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int w = m0 + g + 8 * hr;
        if (w >= t.wn) continue;
        const int64_t p = t.pos + w;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          if constexpr (COUT == STEREO_CONV_C) {
            const int co = nc * 16 + j * 8 + 2 * q;
            float y[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              y[e] = conv3d_round<T>(acc[j][2 * hr + e], L.bias[co + e]);
              if (stats) {
                s[0][j][e] += y[e];
                s[1][j][e] += y[e] * y[e];
              } else if (L.epilogue == kConvBnLeaky) {
                y[e] = bn_leaky(y[e], L.mean[co + e], L.var[co + e], L.gamma[co + e],
                                L.beta[co + e], L.eps, L.slope);
              }
            }
            if constexpr (std::is_same<OutT, __nv_bfloat16>::value) {
              *reinterpret_cast<__nv_bfloat162*>(out + p * COUT + co) =
                  __floats2bfloat162_rn(y[0], y[1]);
            } else {
              out[p * COUT + co] = from_float<OutT>(y[0]);
              out[p * COUT + co + 1] = from_float<OutT>(y[1]);
            }
          } else if (q == 0) {  // the final layer: channel 0 of the padded 8
            out[p] = from_float<OutT>(conv3d_round<T>(acc[j][2 * hr], L.bias[0]));
          }
        }
      }
    }
    if (COUT == STEREO_CONV_C && stats) {
      // Sum over the 8 row groups g (lanes q, q + 4, ..., q + 28), then lane
      // q < 4 holds channels nc * 16 + j * 8 + 2q + e of this warp's units.
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
#pragma unroll
            for (int off = 4; off < 32; off <<= 1)
              s[i][j][e] += __shfl_xor_sync(0xffffffffu, s[i][j][e], off);
      // Slot warp * 32 + c holds channel c: this warp's n-chunk, zeros in
      // the other (a warp's units share one n-chunk, as the 8 warps are an
      // even count).
      sums[0][threadIdx.x] = 0.0f;
      sums[1][threadIdx.x] = 0.0f;
      __syncwarp();
      const int nc = warp % NC;
      if (g == 0 && warp < mtiles * NC) {
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = nc * 16 + j * 8 + 2 * q + e;
            sums[0][warp * 32 + c] = s[0][j][e];
            sums[1][warp * 32 + c] = s[1][j][e];
          }
      }
    }
  }
  if (stats) tile_partials(sums, row);
  __syncthreads();
}
