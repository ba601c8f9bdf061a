"""Differentiable linear (horizontal-disparity) image warping (plain PyTorch).

Counterpart of adaptive_stereo_tpu/ops/warp.py:linear_warp, which mirrors
the reference (adaptive_stereo/models/linear_warping.py:6-57): a sampling
grid offset by the disparity, normalised with u = 2*x/W - 1 and sampled by
F.grid_sample(mode="bilinear", padding_mode="border", align_corners=False).

The numerical quirk is kept on purpose: u = 2*x/W - 1 is the
align_corners=True formula, and grid_sample with align_corners=False
un-normalises it to ((u + 1) * W - 1) / 2 = x - 0.5, so every sample lands
half a pixel left of and above its nominal position. The validity mask is
u, v in [-1, 1] before that shift, i.e. 0 <= x -/+ disp <= W.

The JAX package computes the sample as a banded one-hot matmul, a TPU layout
device; the port samples with grid_sample, which is the JAX package's exact
("highest" precision) warp. With max_disp the JAX warp keeps each source
inside its band, which equals clamping the disparity to max_disp for the
sample (the mask keeps the unclamped disparity); the port does that.
Layouts are the JAX package's: images (B, H, W, C), disparities (B, H, W)
or (B, H, W, 1).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def linear_warp(img: torch.Tensor, positive_disp: torch.Tensor,
                right_to_left: bool = True,
                max_disp: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Warp img horizontally by a positive disparity map.

    right_to_left: out(x, y) = img(x - disp(x, y), y) (synthesise the left
    view from the right image); else out(x, y) = img(x + disp(x, y), y).

    Returns (warped (B, H, W, C) in img's dtype, valid mask (B, H, W, 1)
    bool, False where the source column is out of frame)."""
    disp = positive_disp[..., 0] if positive_disp.dim() == img.dim() else positive_disp
    b, h, w, _ = img.shape
    dtype = torch.promote_types(img.dtype, torch.float32)
    disp = disp.to(dtype)
    x = torch.arange(w, dtype=dtype, device=img.device)
    sign = -1.0 if right_to_left else 1.0
    sample_x = x + sign * disp
    valid = (sample_x >= 0.0) & (sample_x <= w)
    if max_disp is not None:
        disp = torch.clamp(disp, max=float(max_disp))
        sample_x = x + sign * disp
    u = 2.0 * sample_x / w - 1.0
    y = torch.arange(h, dtype=dtype, device=img.device)
    v = (2.0 * y / h - 1.0)[None, :, None].expand(b, h, w)
    grid = torch.stack([u, v], dim=-1)
    warped = F.grid_sample(img.to(dtype).permute(0, 3, 1, 2), grid, mode="bilinear",
                           padding_mode="border", align_corners=False)
    return warped.permute(0, 2, 3, 1).to(img.dtype), valid[..., None]


def convert_disp_to_flow(positive_disp: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Left positive-disparity map -> normalised sampling grid (B, H, W, 2):
    F(x, y) = (x - d(x, y), y) with the reference's u = 2*x/W - 1
    (adaptive_stereo_tpu/ops/warp.py:convert_disp_to_flow)."""
    disp = positive_disp[..., 0] if positive_disp.dim() == 4 else positive_disp
    b = disp.shape[0]
    dev = disp.device
    cols = torch.arange(width, dtype=torch.float32, device=dev)[None, None, :]
    rows = torch.arange(height, dtype=torch.float32, device=dev)[None, :, None]
    u = 2.0 * (cols - disp.float()) / width - 1.0
    v = (2.0 * rows / height - 1.0).expand(b, height, width)
    return torch.stack([u, v], dim=-1)
