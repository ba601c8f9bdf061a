"""Soft-argmin disparity regression (plain PyTorch).

Counterpart of adaptive_stereo_tpu/ops/soft_argmin.py (soft_argmin and
softmax_disparity): softmax (not softmin) over the disparity axis of the
aggregated pre-softmax cost, then the expectation sum_d d * p(d). The
reduction runs in float32.
"""

from __future__ import annotations

import torch


def softmax_disparity(cost: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """Softmax over the disparity axis of a (B, D, H, W) cost volume."""
    return torch.softmax(cost, dim=dim)


def soft_argmin(cost: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """Softmax expectation over the disparity axis of a (B, D, H, W) cost.

    Returns the expected disparity, shape (B, H, W), float32 (or wider).
    """
    cost = cost.to(torch.promote_types(cost.dtype, torch.float32))
    d = cost.shape[dim]
    p = torch.softmax(cost, dim=dim)
    shape = [1] * cost.ndim
    shape[dim] = d
    dvals = torch.arange(d, dtype=p.dtype, device=p.device).reshape(shape)
    return torch.sum(p * dvals, dim=dim)
