"""Helpers of the adaptation steps, copied from
adaptive_stereo_tpu/engine/steps.py (that module imports JAX)."""

from __future__ import annotations

from typing import Dict

import torch

from ..ops.fcs import feature_contrast_mean


def mean_fcs_from_outputs(outputs: Dict[str, torch.Tensor], side: str,
                          coarse: int) -> torch.Tensor:
    """Mean image FCS: the fused epilogue's per-pixel map
    (outputs['fcs_<side>/<coarse>']) if present, else derived from the cost
    volume (JAX steps.py:36-43)."""
    key = f"fcs_{side}/{coarse}"
    if key in outputs:
        return outputs[key].mean()
    return feature_contrast_mean(outputs[f"cost_volume_{side}/{coarse}"]).mean()


def epe(pred_disp: torch.Tensor, gt_disp: torch.Tensor) -> torch.Tensor:
    """Mean absolute disparity error over gt > 0 (reference train.py:103;
    JAX steps.py:61-65)."""
    mask = (gt_disp > 0).float()
    err = torch.abs(pred_disp - gt_disp) * mask
    return err.sum() / torch.clamp(mask.sum(), min=1.0)
