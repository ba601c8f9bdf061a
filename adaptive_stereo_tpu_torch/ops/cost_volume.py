"""Difference cost-volume construction (plain PyTorch).

Counterpart of adaptive_stereo_tpu/ops/cost_volume.py. For each candidate
disparity d in [0, D):

    cost[b, d, y, x, :] = f_l[b, y, x, :] - f_r[b, y, x - d, :]   if x >= d
                          0                                        otherwise

Columns x < d are exact zeros, and a slice with d >= W is all zeros (the
reference's empty strided write). Layout (B, D, H, W, C), as in the JAX
package.
"""

from __future__ import annotations

import torch


def difference_cost_volume(f_l: torch.Tensor, f_r: torch.Tensor,
                           num_disp: int) -> torch.Tensor:
    """Build a difference cost volume.

    Args:
      f_l: left feature map, shape (B, H, W, C).
      f_r: right feature map, shape (B, H, W, C).
      num_disp: number of candidate disparities D.

    Returns:
      Cost volume of shape (B, D, H, W, C) in the features' dtype.
    """
    if f_l.shape != f_r.shape:
        raise ValueError(f"feature shapes differ: {tuple(f_l.shape)} vs {tuple(f_r.shape)}")
    if num_disp < 1:
        raise ValueError("num_disp must be >= 1")
    b, h, w, c = f_l.shape
    out = f_l.new_zeros((b, num_disp, h, w, c))
    for d in range(min(num_disp, w)):
        out[:, d, :, d:] = f_l[:, :, d:] - f_r[:, :, : w - d]
    return out
