"""Feature Contrast Score (FCS), the cost-volume OOD signal (plain PyTorch).

Counterparts of adaptive_stereo_tpu/ops/fcs.py:feature_contrast_mean and
feature_contrast_median. Per pixel, FCS = top1 - mean(sorted[2:]) =
top1 - (sum - top1 - top2) / (D - 2).
A duplicated maximum is its own runner-up (torch.topk and the reference's
sort both return it twice), which is the first-occurrence tie rule of the
fused kernel.
"""

from __future__ import annotations

import torch


def feature_contrast_mean(cost_volume: torch.Tensor) -> torch.Tensor:
    """Max-minus-mean FCS over the disparity axis of a (B, D, H, W) cost,
    skipping the top-2 disparities. Computed without gradient; returns
    (B, H, W)."""
    d = cost_volume.shape[1]
    if d < 3:
        raise ValueError(f"FCS requires D >= 3 disparities, got {d}")
    cv = cost_volume.detach()
    top2 = torch.topk(cv, 2, dim=1).values
    total = torch.sum(cv, dim=1)
    mean_nonmax = (total - top2[:, 0] - top2[:, 1]) / (d - 2)
    return top2[:, 0] - mean_nonmax


def feature_contrast_median(cost_volume: torch.Tensor) -> torch.Tensor:
    """Max-minus-median FCS over the disparity axis of a (B, D, H, W) cost
    (reference feature_contrast.py:4-9), without gradient; returns
    (B, H, W). The median is sorted[(D - 1) // 2], the lower middle value
    for an even D, as torch.median takes it."""
    cv = cost_volume.detach()
    median = torch.sort(cv, dim=1).values[:, (cv.shape[1] - 1) // 2]
    return torch.amax(cv, dim=1) - median
