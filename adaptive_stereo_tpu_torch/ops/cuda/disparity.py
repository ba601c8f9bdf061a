"""Fused soft-argmin + FCS: CUDA kernel wrapper and its plain version.

Counterpart of adaptive_stereo_tpu/ops/pallas/disparity.py
(soft_argmin_fcs_pallas). The kernel is csrc/disparity.cu. The plain
version, soft_argmin_fcs_ref, composes ops/soft_argmin.py and ops/fcs.py.
The wrapper takes the plain version for CPU tensors only; on CUDA tensors it
launches the kernel or raises.

On CUDA the wrapper is a torch.autograd.Function whose backward is the
kernel stereo_soft_argmin_backward, one launch, the counterpart of the JAX
custom VJP (ops/pallas/disparity.py:89-100, plain jnp there):
d disp / d cost_j = p_j * (j - disp), and FCS is a stop-gradient. Its plain
version is soft_argmin_fcs_backward, which the Function takes for CPU
tensors. Launches are counted in soft_argmin_fcs_cuda.launches and
.backward_launches, and each launch adds its work to the open counts of
work.py (no flops: the plain version holds no product).
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..fcs import feature_contrast_mean
from ..soft_argmin import soft_argmin
from . import _build, work

__all__ = ["soft_argmin_fcs_backward", "soft_argmin_fcs_cuda", "soft_argmin_fcs_flops",
           "soft_argmin_fcs_ref"]


def soft_argmin_fcs_flops(b: int, d: int, h: int, w: int) -> int:
    """FlopCounterMode's count of the plain version (softmax, top-2 and
    sums, no product): 0, forward and backward."""
    return 0


def soft_argmin_fcs_ref(cost: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: (soft_argmin, feature_contrast_mean) of a (B, D, H, W)
    cost, both float32 (B, H, W)."""
    cost = cost.float()
    return soft_argmin(cost, dim=1), feature_contrast_mean(cost)


def soft_argmin_fcs_backward(cost: torch.Tensor, disp: torch.Tensor,
                             g_disp: torch.Tensor) -> torch.Tensor:
    """dL/dcost (B, D, H, W) from the gradient g_disp (B, H, W) of the
    expected disparity: g * p_j * (j - disp)."""
    p = torch.softmax(cost.float(), dim=1)
    dvals = torch.arange(cost.shape[1], dtype=torch.float32,
                         device=cost.device).reshape(1, -1, 1, 1)
    return (g_disp[:, None] * p * (dvals - disp[:, None])).to(cost.dtype)


class _SoftArgminFcs(torch.autograd.Function):
    @staticmethod
    def forward(ctx, cost):
        disp, fcs = _launch(cost)
        ctx.save_for_backward(cost, disp)
        ctx.mark_non_differentiable(fcs)
        return disp, fcs

    @staticmethod
    def backward(ctx, g_disp, _g_fcs):
        cost, disp = ctx.saved_tensors
        g_disp = g_disp.contiguous()
        if cost.device.type == "cpu":
            return soft_argmin_fcs_backward(cost, disp, g_disp)
        return _launch_backward(cost, disp, g_disp)


def soft_argmin_fcs_cuda(cost: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expected disparity and FCS, each (B, H, W) float32, from a float32
    (B, D, H, W) pre-softmax cost with D >= 3. Differentiable in the
    disparity; FCS carries no gradient."""
    if cost.device.type == "cpu":
        return soft_argmin_fcs_ref(cost)
    return _SoftArgminFcs.apply(cost)


def _launch(cost: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    _build.require_cuda(cost, "cost", (torch.float32,))
    if cost.dim() != 4:
        raise ValueError(f"cost must be (B, D, H, W), got {tuple(cost.shape)}")
    b, d, h, w = cost.shape
    if d < 3:
        raise ValueError(f"FCS requires D >= 3 disparities, got D={d}")
    disp = torch.empty((b, h, w), dtype=torch.float32, device=cost.device)
    fcs = torch.empty_like(disp)
    lib = _build.library()
    with torch.cuda.device(cost.device):
        status = lib.stereo_soft_argmin_fcs_forward(
            cost.data_ptr(), disp.data_ptr(), fcs.data_ptr(), b, d, h * w,
            _build.stream_of(cost))
    _build.check(status, "stereo_soft_argmin_fcs_forward")
    soft_argmin_fcs_cuda.launches += 1
    work.add("soft_argmin_fcs", soft_argmin_fcs_flops(b, d, h, w),
             (cost.numel() + 2 * disp.numel()) * 4)
    return disp, fcs


def _launch_backward(cost: torch.Tensor, disp: torch.Tensor,
                     g_disp: torch.Tensor) -> torch.Tensor:
    """dL/dcost (B, D, H, W) float32: one launch of
    stereo_soft_argmin_backward on the saved cost and disparity."""
    _build.require_cuda(cost, "cost", (torch.float32,))
    if cost.dim() != 4:
        raise ValueError(f"cost must be (B, D, H, W), got {tuple(cost.shape)}")
    b, d, h, w = cost.shape
    _build.require_cuda(disp, "disp", (torch.float32,), (b, h, w))
    _build.require_cuda(g_disp, "g_disp", (torch.float32,), (b, h, w))
    g_cost = torch.empty_like(cost)
    lib = _build.library()
    with torch.cuda.device(cost.device):
        status = lib.stereo_soft_argmin_backward(
            cost.data_ptr(), disp.data_ptr(), g_disp.data_ptr(), g_cost.data_ptr(), b, d,
            h * w, _build.stream_of(cost))
    _build.check(status, "stereo_soft_argmin_backward")
    soft_argmin_fcs_cuda.backward_launches += 1
    work.add("soft_argmin_fcs backward", soft_argmin_fcs_flops(b, d, h, w),
             (2 * cost.numel() + 2 * disp.numel()) * 4)
    return g_cost


soft_argmin_fcs_cuda.launches = 0
soft_argmin_fcs_cuda.backward_launches = 0
