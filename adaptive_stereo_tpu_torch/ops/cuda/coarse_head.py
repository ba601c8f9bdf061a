"""The fused coarse head: CUDA kernel wrapper and its plain version.

Counterpart of adaptive_stereo_tpu/ops/pallas/coarse_head.py
(coarse_head_pallas, and its plain twin coarse_head_ref). From the two
coarse feature maps it computes, in one pass, what kernels 1-3 compute in
turn: the difference cost volume, the 5-layer aggregation stack and the
soft-argmin + FCS epilogue.

Both functions take the JAX package's arguments:
  f_l, f_r   (B, h, w, 32) coarse features in the compute dtype (float32 or
             bfloat16)
  params, run_stats   as ops/cuda/aggregation.py
  train      True: batch statistics (fast variance), returned as mu/var;
             False: the running statistics, echoed back as mu/var
  num_disp   D, the candidate disparities (>= 3 for FCS)
and return (disp (B, h, w) float32, fcs (B, h, w) float32, mu (4, 32)
float32, var (4, 32) float32).

coarse_head_ref is the plain version: the port's plain cost volume,
aggregation stack, soft-argmin and FCS, composed. coarse_head_cuda launches
csrc/coarse_head.cu once (a cooperative launch over the row tiles of
aggregation.tile_plan) on CUDA tensors, and takes the plain version for CPU
tensors only; on CUDA, a shape or dtype that coarse_head_cuda_supported
refuses raises, as does a refused launch.

On CUDA the wrapper is a torch.autograd.Function, differentiable in f_l,
f_r and the params through the disparity (FCS, mu and var carry no
gradient, nor do the running statistics). Its backward is the JAX custom
VJP (ops/pallas/coarse_head.py:288-300): recompute the disparity through
coarse_head_ref and take autograd of it, with the incoming gradient in
float32.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..cost_volume import difference_cost_volume
from ..fcs import feature_contrast_mean
from ..soft_argmin import soft_argmin
from . import _build
from .aggregation import (CHANNELS, LEAKY_SLOPE, NUM_BN_LAYERS, PARAM_NAMES, _partials,
                          aggregate_cost_volume_ref, tile_plan)

__all__ = ["coarse_head_cuda", "coarse_head_cuda_supported", "coarse_head_ref"]

# The kernel indexes with 64-bit offsets but passes B*D*h*w as a 32-bit
# count; this keeps every size it is given inside int32.
_MAX_ELEMENTS = 2**31 - 1

Outputs = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def coarse_head_ref(f_l: torch.Tensor, f_r: torch.Tensor, params: Dict[str, torch.Tensor],
                    run_stats: Tuple[torch.Tensor, torch.Tensor], train: bool,
                    num_disp: int, eps: float = 1e-5) -> Outputs:
    """Plain coarse head: difference_cost_volume -> aggregate_cost_volume_ref
    -> soft_argmin and feature_contrast_mean of the float32 cost."""
    cost5 = difference_cost_volume(f_l, f_r, num_disp)
    out, mu, var = aggregate_cost_volume_ref(cost5, params, run_stats, train, eps)
    cost = out.float()
    return soft_argmin(cost, dim=1), feature_contrast_mean(cost), mu, var


def coarse_head_cuda_supported(feat_shape, num_disp: int, dtype: torch.dtype) -> bool:
    """True when csrc/coarse_head.cu takes features of this shape and dtype:
    (B, h, w, 32) with B, h, w >= 1, D >= 3, float32 or bfloat16, and every
    buffer of the launch within int32 elements. This covers every shape the
    TPU kernel admits (C = 32, D >= 3, within its VMEM budget)."""
    if len(feat_shape) != 4 or dtype not in _build.DTYPE_CODES:
        return False
    b, h, w, c = feat_shape
    return (c == CHANNELS and min(b, h, w) >= 1 and num_disp >= 3
            and b * num_disp * h * w * c <= _MAX_ELEMENTS)


class _CoarseHead(torch.autograd.Function):
    @staticmethod
    def forward(ctx, f_l, f_r, rmean, rvar, train, num_disp, eps, *values):
        disp, fcs, mu, var = _launch(f_l, f_r, dict(zip(PARAM_NAMES, values)), (rmean, rvar),
                                     train, num_disp, eps)
        ctx.save_for_backward(f_l, f_r, rmean, rvar, *values)
        ctx.train, ctx.num_disp, ctx.eps = train, num_disp, eps
        ctx.mark_non_differentiable(fcs, mu, var)
        return disp, fcs, mu, var

    @staticmethod
    def backward(ctx, g_disp, _g_fcs, _g_mu, _g_var):
        f_l, f_r, rmean, rvar, *values = ctx.saved_tensors
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_() for t in (f_l, f_r, *values)]
            disp = coarse_head_ref(inputs[0], inputs[1], dict(zip(PARAM_NAMES, inputs[2:])),
                                   (rmean, rvar), ctx.train, ctx.num_disp, ctx.eps)[0]
            grads = torch.autograd.grad(disp, inputs, g_disp.float())
        return (grads[0], grads[1], None, None, None, None, None, *grads[2:])


def coarse_head_cuda(f_l: torch.Tensor, f_r: torch.Tensor, params: Dict[str, torch.Tensor],
                     run_stats: Tuple[torch.Tensor, torch.Tensor], train: bool,
                     num_disp: int, eps: float = 1e-5) -> Outputs:
    """The coarse head through csrc/coarse_head.cu: one launch.
    Differentiable in f_l, f_r and params through the disparity."""
    if f_l.device.type == "cpu" and f_r.device.type == "cpu":
        return coarse_head_ref(f_l, f_r, params, run_stats, train, num_disp, eps)
    return _CoarseHead.apply(f_l, f_r, run_stats[0], run_stats[1], train, num_disp, eps,
                             *(params[name] for name in PARAM_NAMES))


def _launch(f_l, f_r, params, run_stats, train, num_disp, eps):
    _build.require_cuda(f_l, "f_l", tuple(_build.DTYPE_CODES))
    _build.require_cuda(f_r, "f_r", (f_l.dtype,), tuple(f_l.shape))
    if not coarse_head_cuda_supported(tuple(f_l.shape), num_disp, f_l.dtype):
        raise ValueError(
            f"coarse_head_cuda does not take features {tuple(f_l.shape)} {f_l.dtype} with "
            f"D={num_disp}: it needs (B, h, w, {CHANNELS}), D >= 3 and float32 or bfloat16 "
            "(callers gate on coarse_head_cuda_supported)")
    b, h, w, c = f_l.shape
    cdtype, dev = f_l.dtype, f_l.device

    def take(t, name, shape, dtype):
        t = t.to(dtype).contiguous()
        _build.require_cuda(t, name, shape=shape)
        return t

    vec = (NUM_BN_LAYERS, CHANNELS)
    kernels = take(params["kernels"], "kernels", (NUM_BN_LAYERS, 3, 3, 3, c, c), cdtype)
    _build.require_aligned(kernels, "kernels")
    f32 = [take(t, name, vec, torch.float32) for t, name in (
        (params["biases"], "biases"), (params["scales"], "scales"),
        (params["bn_biases"], "bn_biases"), (run_stats[0], "running mean"),
        (run_stats[1], "running var"))]
    final_kernel = take(params["final_kernel"], "final_kernel", (3, 3, 3, c, 1), cdtype)
    final_bias = take(params["final_bias"], "final_bias", (1,), torch.float32)

    disp = torch.empty((b, h, w), dtype=torch.float32, device=dev)
    fcs = torch.empty_like(disp)
    mu = torch.empty(vec, dtype=torch.float32, device=dev)
    var = torch.empty_like(mu)
    act0 = torch.empty((b, num_disp, h, w, c), dtype=cdtype, device=dev)
    act1 = torch.empty_like(act0)
    cost = torch.empty((b, num_disp, h, w), dtype=torch.float32, device=dev)
    # The row tiles of kernel 2 (csrc/conv3d.cuh), one row of partial sums each.
    plan = tile_plan(b, num_disp, h, w, cdtype)
    partials = _partials(plan, dev)

    lib = _build.library()
    with torch.cuda.device(dev):
        status = lib.stereo_coarse_head_forward(
            f_l.data_ptr(), f_r.data_ptr(), kernels.data_ptr(), *(t.data_ptr() for t in f32),
            final_kernel.data_ptr(), final_bias.data_ptr(), disp.data_ptr(), fcs.data_ptr(),
            mu.data_ptr(), var.data_ptr(), act0.data_ptr(), act1.data_ptr(), cost.data_ptr(),
            partials.data_ptr(), plan.nparts, b, h, w, c, num_disp, plan.wc, plan.smem,
            int(train), eps, LEAKY_SLOPE, _build.DTYPE_CODES[cdtype], _build.stream_of(f_l))
    _build.check(status, "stereo_coarse_head_forward")
    coarse_head_cuda.launches += 1
    return disp, fcs, mu, var


coarse_head_cuda.launches = 0
