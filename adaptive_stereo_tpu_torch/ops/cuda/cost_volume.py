"""Difference cost volume: CUDA kernel wrapper and its plain version.

Counterpart of adaptive_stereo_tpu/ops/pallas/cost_volume.py
(difference_cost_volume_pallas). The kernel is csrc/cost_volume.cu. The
plain version is ops/cost_volume.py:difference_cost_volume, re-exported here
as difference_cost_volume_ref. The wrapper takes the plain version for CPU
tensors only; on CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from ..cost_volume import difference_cost_volume as difference_cost_volume_ref
from . import _build

__all__ = ["difference_cost_volume_cuda", "difference_cost_volume_ref"]


def difference_cost_volume_cuda(f_l: torch.Tensor, f_r: torch.Tensor,
                                num_disp: int) -> torch.Tensor:
    """Cost volume (B, D, H, W, C) from features (B, H, W, C), float32 or
    bfloat16. Bitwise equal to difference_cost_volume_ref."""
    if f_l.device.type == "cpu" and f_r.device.type == "cpu":
        return difference_cost_volume_ref(f_l, f_r, num_disp)
    dtypes = tuple(_build.DTYPE_CODES)
    _build.require_cuda(f_l, "f_l", dtypes)
    _build.require_cuda(f_r, "f_r", (f_l.dtype,), tuple(f_l.shape))
    _build.forward_only("difference_cost_volume_cuda", f_l, f_r)
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
    return out


difference_cost_volume_cuda.launches = 0
