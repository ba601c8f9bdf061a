"""Difference cost volume: CUDA kernel wrapper and its plain version.

Counterpart of adaptive_stereo_tpu/ops/pallas/cost_volume.py
(difference_cost_volume_pallas). The kernel is csrc/cost_volume.cu. The
plain version is ops/cost_volume.py:difference_cost_volume, re-exported here
as difference_cost_volume_ref. The wrapper takes the plain version for CPU
tensors only; on CUDA tensors it launches the kernel or raises.

On CUDA the wrapper is a torch.autograd.Function whose backward is the
kernel stereo_cost_volume_backward, one launch, the counterpart of the JAX
custom VJP (ops/pallas/cost_volume.py:87-104, plain jnp there): masked
shift-sums of the incoming gradient,
    dL/df_l[x] = sum_d g[d, x] (x >= d),  dL/df_r[x] = -sum_d g[d, x + d].
Its plain version is difference_cost_volume_backward, which the Function
takes for CPU tensors. Each kernel takes 16-byte chunks where C * itemsize
is a multiple of 16 and every pointer is 16-byte aligned, else one element a
thread; the C entry points pick. Launches are counted in
difference_cost_volume_cuda.launches and .backward_launches, and each
launch adds its work to the open counts of work.py (no flops: the plain
version holds no product).
"""

from __future__ import annotations

import torch

from ..cost_volume import difference_cost_volume as difference_cost_volume_ref
from . import _build, work

__all__ = ["difference_cost_volume_backward", "difference_cost_volume_cuda",
           "difference_cost_volume_flops", "difference_cost_volume_ref"]


def difference_cost_volume_flops(b: int, h: int, w: int, c: int, num_disp: int) -> int:
    """FlopCounterMode's count of the plain version (subtractions and
    copies, no product): 0, forward and backward."""
    return 0


def difference_cost_volume_backward(g: torch.Tensor):
    """(dL/df_l, dL/df_r), each (B, H, W, C), from the gradient g
    (B, D, H, W, C) of the cost volume."""
    b, d, h, w, c = g.shape
    d_fl = torch.zeros((b, h, w, c), dtype=g.dtype, device=g.device)
    d_fr = torch.zeros_like(d_fl)
    for di in range(min(d, w)):
        d_fl[:, :, di:] += g[:, di, :, di:]
        d_fr[:, :, : w - di] -= g[:, di, :, di:]
    return d_fl, d_fr


class _CostVolume(torch.autograd.Function):
    @staticmethod
    def forward(ctx, f_l, f_r, num_disp):
        return _launch(f_l, f_r, num_disp)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        if g.device.type == "cpu":
            d_fl, d_fr = difference_cost_volume_backward(g)
        else:
            d_fl, d_fr = _launch_backward(g)
        return d_fl, d_fr, None


def difference_cost_volume_cuda(f_l: torch.Tensor, f_r: torch.Tensor,
                                num_disp: int) -> torch.Tensor:
    """Cost volume (B, D, H, W, C) from features (B, H, W, C), float32 or
    bfloat16. Bitwise equal to difference_cost_volume_ref. Differentiable."""
    if f_l.device.type == "cpu" and f_r.device.type == "cpu":
        return difference_cost_volume_ref(f_l, f_r, num_disp)
    return _CostVolume.apply(f_l, f_r, num_disp)


def _launch(f_l: torch.Tensor, f_r: torch.Tensor, num_disp: int) -> torch.Tensor:
    dtypes = tuple(_build.DTYPE_CODES)
    _build.require_cuda(f_l, "f_l", dtypes)
    _build.require_cuda(f_r, "f_r", (f_l.dtype,), tuple(f_l.shape))
    if f_l.dim() != 4:
        raise ValueError(f"features must be (B, H, W, C), got {tuple(f_l.shape)}")
    if num_disp < 1:
        raise ValueError("num_disp must be >= 1")
    b, h, w, c = f_l.shape
    out = torch.empty((b, num_disp, h, w, c), dtype=f_l.dtype, device=f_l.device)
    lib = _build.library()
    with torch.cuda.device(f_l.device):
        status = lib.stereo_cost_volume_forward(
            f_l.data_ptr(), f_r.data_ptr(), out.data_ptr(), b, h, w, c, num_disp,
            _build.DTYPE_CODES[f_l.dtype], _build.stream_of(f_l))
    _build.check(status, "stereo_cost_volume_forward")
    difference_cost_volume_cuda.launches += 1
    work.add("difference_cost_volume", difference_cost_volume_flops(b, h, w, c, num_disp),
             (2 * f_l.numel() + out.numel()) * f_l.element_size())
    return out


def _launch_backward(g: torch.Tensor):
    """(dL/df_l, dL/df_r) from a contiguous CUDA g (B, D, H, W, C): one launch
    of stereo_cost_volume_backward, bitwise equal to
    difference_cost_volume_backward."""
    _build.require_cuda(g, "g", tuple(_build.DTYPE_CODES))
    if g.dim() != 5:
        raise ValueError(f"g must be (B, D, H, W, C), got {tuple(g.shape)}")
    b, d, h, w, c = g.shape
    d_fl = torch.empty((b, h, w, c), dtype=g.dtype, device=g.device)
    d_fr = torch.empty_like(d_fl)
    lib = _build.library()
    with torch.cuda.device(g.device):
        status = lib.stereo_cost_volume_backward(
            g.data_ptr(), d_fl.data_ptr(), d_fr.data_ptr(), b, h, w, c, d,
            _build.DTYPE_CODES[g.dtype], _build.stream_of(g))
    _build.check(status, "stereo_cost_volume_backward")
    difference_cost_volume_cuda.backward_launches += 1
    work.add("difference_cost_volume backward", difference_cost_volume_flops(b, h, w, c, d),
             (g.numel() + 2 * d_fl.numel()) * g.element_size())
    return d_fl, d_fr


difference_cost_volume_cuda.launches = 0
difference_cost_volume_cuda.backward_launches = 0
