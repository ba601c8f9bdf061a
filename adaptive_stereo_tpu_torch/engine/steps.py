"""Helpers of the adaptation steps and the eval step, counterparts of
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


def make_eval_step(model: torch.nn.Module, input_scale: int, k: int):
    """Per-batch eval metrics, the comparison contract (reference
    train.py:74-126; JAX steps.py:117-146): EPE over gt > 0, D1-all at
    2/3/4/5 px and the mean image FCS, from an eval-mode forward of the
    model's current weights. eval_step(batch) takes a dict of tensors on
    the model's device and returns a dict of 0-d tensors."""
    coarse = input_scale + k

    @torch.no_grad()
    def eval_step(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        model.eval()
        outputs = model(batch[f"color_l/{input_scale}"], batch[f"color_r/{input_scale}"],
                        side="l", output_cost_volume=True)
        pred = outputs[f"pred_disp_l/{input_scale}"]
        gt = batch[f"gt_disp_l/{input_scale}"]
        maskf = (gt > 0).float()
        n_valid = torch.clamp(maskf.sum(), min=1.0)
        abs_err = torch.abs(pred - gt)
        metrics = {"EPE": (abs_err * maskf).sum() / n_valid}
        for t in (2, 3, 4, 5):
            # The reference divides by the unfloored count here.
            metrics[f"D1_all_{t}px"] = (maskf * (abs_err > t)).sum() / maskf.sum()
        metrics["FCS"] = mean_fcs_from_outputs(outputs, "l", coarse)
        # In sorted key order, as the JAX step's output dict (and so the
        # columns of trials.csv) comes back.
        return dict(sorted(metrics.items()))

    return eval_step
