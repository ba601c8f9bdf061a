// Cost-volume aggregation stack, eval mode: one layer per launch.
//
// Replaces the TPU kernel adaptive_stereo_tpu/ops/pallas/aggregation.py
// (aggregate_cost_volume_pallas -> _forward -> pl.pallas_call of _kernel /
// _stack_body) in eval mode. The stack is
//
//   4 x [Conv3d 32->32 k3 pad 1 + bias, BatchNorm (running stats),
//        LeakyReLU 0.2] + Conv3d 32->1 k3 pad 1 + bias
//
// and the wrapper launches this kernel once per layer (five launches).
// One layer, for each output (b, d, h, w, co):
//
//   y  = round_T(sum_{taps, ci} x[b, d+kd-1, h+kh-1, w+kw-1, ci] * k[tap, ci, co]
//                + bias[co])                       (f32 accumulation)
//   out = round_T(leaky_0.2((y - mean[co]) * rsqrt(var[co] + eps) * gamma[co]
//                           + beta[co]))           (BN layers)
//   out = y                                        (the final 32->1 layer)
//
// The conv output is rounded to the compute type before BatchNorm sees it,
// as in aggregate_cost_volume_ref and the TPU kernel.
// Bound on an H100: operations. Each 32->32 layer is 2*27*32*32 = 55,296
// operations per output position, about 1.0 GFLOP at the serving shape
// (1,12,20,76), against about 2.3 MB moved (bf16 in and out, plus
// weights). The tensor-core bound of the whole stack is about 4 us.
// Design (simple first): one thread per output element, output channel
// fastest. The 32 threads of a warp share one output position, so every
// read of an input activation is a broadcast and every read of the weights
// (laid out [tap][ci][co]) is coalesced; both stay in L1. Zero padding is a
// skipped tap. This runs on the CUDA cores, not the tensor cores; a wgmma
// implicit-GEMM version is later work. Unlike the TPU kernel it has no
// W % 4 limit and keeps no activation resident between layers.
// Train-mode batch statistics (a reduction across blocks) are not
// implemented here; the wrapper refuses train=True on the card.

#include "common.cuh"

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
  // Conv output rounded to the compute type: BatchNorm sees what the plain
  // stack's conv would have stored.
  float y = to_float(from_float<T>(acc + bias[co]));
  if (has_bn) {
    y = (y - mean[co]) * rsqrtf(var[co] + eps) * gamma[co] + beta[co];
    y = y >= 0.0f ? y : slope * y;
  }
  out[i] = from_float<T>(y);
}

extern "C" int stereo_conv3d_bn_leaky_forward(const void* x, const void* k, const void* bias,
                                              const void* mean, const void* var,
                                              const void* gamma, const void* beta, void* out,
                                              int B, int D, int H, int W, int Cin, int Cout,
                                              int has_bn, float eps, float slope, int dtype,
                                              void* stream) {
  const int64_t n = static_cast<int64_t>(B) * D * H * W * Cout;
  if (n == 0) return 0;
  const int threads = 256;
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
