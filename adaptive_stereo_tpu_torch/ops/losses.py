"""Supervised and self-supervised (Monodepth) losses (plain PyTorch).

Counterpart of adaptive_stereo_tpu/ops/losses.py, with the reference's
numerics (adaptive_stereo/utils/loss_functions.py):
- khamis_robust_loss (:6-15): mean over gt > 0 of sqrt((gt-pred)^2 + 4)/2 - 1,
  with the count floored at 1.
- ssim (:41-72): 3x3 average pools with count_include_pad=True (every window
  divides by 9, zero padding included), then clamp((1 - SSIM)/2, 0, 1).
- monodepth_edge_aware_smoothness_loss (:75-103): image-gradient-weighted
  disparity gradients, zero-padded back to full resolution.
- monodepth_loss (:106-138): 0.85*SSIM + 0.15*L1 + w_s*smoothness, with the
  disparity normalised by its mean in the smoothness term.
- monodepth_single_loss (adapt.py:78-86): the single-sided loss, a masked
  mean sum(l*m) / max(sum(m), 1) over the warp's validity mask.

All functions take (B, H, W, C) tensors; disparities are (B, H, W, 1).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .warp import linear_warp


def khamis_robust_loss(pred_disp: torch.Tensor, gt_disp: torch.Tensor) -> torch.Tensor:
    """Two-parameter robust loss from StereoNet (Khamis et al. 2018)."""
    mask = (gt_disp > 0).to(pred_disp.dtype)
    num_valid = torch.clamp(mask.sum(), min=1.0)
    err = torch.sqrt((gt_disp - pred_disp) ** 2 + 4.0) / 2.0 - 1.0
    return (err * mask).sum() / num_valid


def _avg_pool_3x3(x: torch.Tensor) -> torch.Tensor:
    """3x3 stride-1 average pool of a (B, H, W, C) tensor, zero padded,
    dividing by 9 everywhere (count_include_pad=True)."""
    out = F.avg_pool2d(x.permute(0, 3, 1, 2), 3, stride=1, padding=1, count_include_pad=True)
    return out.permute(0, 2, 3, 1)


def ssim(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Structural-similarity loss map clamp((1 - SSIM)/2, 0, 1)."""
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    mu_x, mu_y = _avg_pool_3x3(x), _avg_pool_3x3(y)
    sigma_x = _avg_pool_3x3(x * x) - mu_x * mu_x
    sigma_y = _avg_pool_3x3(y * y) - mu_y * mu_y
    sigma_xy = _avg_pool_3x3(x * y) - mu_x * mu_y
    ssim_n = (2 * mu_x * mu_y + c1) * (2 * sigma_xy + c2)
    ssim_d = (mu_x ** 2 + mu_y ** 2 + c1) * (sigma_x + sigma_y + c2)
    return torch.clamp((1 - ssim_n / ssim_d) / 2, 0.0, 1.0)


def monodepth_edge_aware_smoothness_loss(disp: torch.Tensor, img: torch.Tensor) -> torch.Tensor:
    """Edge-aware smoothness map (B, H, W, 1) of disp (B, H, W, 1) guided by
    img (B, H, W, 3), zero-padded at the last column and row."""
    grad_disp_x = torch.abs(disp[:, :, :-1] - disp[:, :, 1:])
    grad_disp_y = torch.abs(disp[:, :-1] - disp[:, 1:])
    grad_img_x = torch.abs(img[:, :, :-1] - img[:, :, 1:]).mean(dim=-1, keepdim=True)
    grad_img_y = torch.abs(img[:, :-1] - img[:, 1:]).mean(dim=-1, keepdim=True)
    grad_disp_x = F.pad(grad_disp_x * torch.exp(-grad_img_x), (0, 0, 0, 1))
    grad_disp_y = F.pad(grad_disp_y * torch.exp(-grad_img_y), (0, 0, 0, 0, 0, 1))
    return grad_disp_x + grad_disp_y


def monodepth_loss(pred_disp: torch.Tensor, true_img: torch.Tensor, warped_img: torch.Tensor,
                   smoothness_weight: float = 0.001):
    """Monodepth photometric loss map 0.85*SSIM + 0.15*L1 + w_s*smooth.
    Returns (total, l1, ssim, smooth) maps, each (B, H, W, 1)."""
    photo_ssim = ssim(true_img, warped_img).mean(dim=-1, keepdim=True)
    photo_l1 = torch.abs(true_img - warped_img).mean(dim=-1, keepdim=True)
    l_photo = 0.85 * photo_ssim + 0.15 * photo_l1
    mean_disp = pred_disp.mean(dim=(1, 2), keepdim=True)
    l_smooth = monodepth_edge_aware_smoothness_loss(pred_disp / (mean_disp + 1e-7), true_img)
    return l_photo + smoothness_weight * l_smooth, photo_l1, photo_ssim, l_smooth


def monodepth_single_loss(left_img: torch.Tensor, right_img: torch.Tensor,
                          pred_disp_l: torch.Tensor, smoothness_weight: float = 1e-3,
                          max_disp: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-sided adaptation loss (reference adapt.py:78-86): warp the right
    image to the left view with the left disparity, photometric loss, masked
    mean over the warp's validity mask. Returns (scalar loss, left_warped)."""
    left_warped, mask = linear_warp(right_img, pred_disp_l, right_to_left=True,
                                    max_disp=max_disp)
    l_total = monodepth_loss(pred_disp_l, left_img, left_warped, smoothness_weight)[0]
    m = mask.to(l_total.dtype)
    return (l_total * m).sum() / torch.clamp(m.sum(), min=1.0), left_warped
