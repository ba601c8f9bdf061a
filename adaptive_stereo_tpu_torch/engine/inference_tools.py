"""Offline inference tools (reference evaluate_model.py:23-126; counterpart
of adaptive_stereo_tpu/engine/inference_tools.py):
- save: each image's predicted disparity as .npy;
- playback: per-image EPE and side-by-side PNGs (the reference's OpenCV
  windows, headless);
- video: colorized-disparity frames for assembling a video.

Each takes a StereoModel (its weights, or `variables` in the JAX layout
loaded into it first) and runs its eval-mode forward on the model's device.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from ..models import state_dicts_from_jax
from ..utils.visualization import apply_disparity_colormap, save_png, side_by_side


def _forward_fn(model: torch.nn.Module, variables: Optional[dict], input_scale: int):
    """item -> its predicted disparity (H, W) on the host."""
    if variables is not None:
        model.load_state_dicts(*state_dicts_from_jax(variables, model.feature_net.k))
    device = next(model.parameters()).device

    @torch.no_grad()
    def forward(item) -> np.ndarray:
        model.eval()
        left, right = (torch.from_numpy(np.ascontiguousarray(item[f"color_{v}/{input_scale}"]))
                       [None].to(device) for v in "lr")
        pred = model(left, right, side="l")[f"pred_disp_l/{input_scale}"]
        return pred[0, ..., 0].cpu().numpy()

    return forward


def _count(dataset, limit: Optional[int]) -> int:
    return len(dataset) if limit is None else min(limit, len(dataset))


def save_disparities(model, variables, dataset, output_folder: str, input_scale: int,
                     limit: Optional[int] = None) -> int:
    """Dump pred_disp_l/<s> of each dataset item as <i>_pred_disp.npy
    (reference evaluate_model.py:34-70). Returns the count."""
    os.makedirs(output_folder, exist_ok=True)
    forward = _forward_fn(model, variables, input_scale)
    n = _count(dataset, limit)
    for i in range(n):
        np.save(os.path.join(output_folder, f"{i:06d}_pred_disp.npy"), forward(dataset[i]))
    return n


def playback(model, variables, dataset, output_folder: str, input_scale: int,
             limit: Optional[int] = None) -> Dict[str, float]:
    """Per-image EPE and side-by-side (left | colorized prediction |
    colorized ground truth) PNGs (reference evaluate_model.py:72-96,
    headless). Returns {'EPE': mean, 'count': n}."""
    os.makedirs(output_folder, exist_ok=True)
    forward = _forward_fn(model, variables, input_scale)
    n = _count(dataset, limit)
    epes = []
    for i in range(n):
        item = dataset[i]
        disp = forward(item)
        panels = [item[f"color_l/{input_scale}"], apply_disparity_colormap(disp)]
        gt_key = f"gt_disp_l/{input_scale}"
        if gt_key in item:
            gt = item[gt_key][..., 0]
            mask = gt > 0
            epe = float(np.abs(disp - gt)[mask].mean()) if mask.any() else float("nan")
            epes.append(epe)
            print(f"[playback] image {i}: EPE={epe:.3f}")
            panels.append(apply_disparity_colormap(gt))
        save_png(os.path.join(output_folder, f"{i:06d}.png"), side_by_side(*panels))
    return {"EPE": float(np.mean(epes)) if epes else float("nan"), "count": n}


def render_video_frames(model, variables, dataset, output_folder: str, input_scale: int,
                        limit: Optional[int] = None) -> int:
    """Colorized disparity under the left image, one PNG a frame (reference
    evaluate_model.py:98-119). Returns the count."""
    os.makedirs(output_folder, exist_ok=True)
    forward = _forward_fn(model, variables, input_scale)
    n = _count(dataset, limit)
    for i in range(n):
        item = dataset[i]
        frame = np.concatenate([item[f"color_l/{input_scale}"],
                                apply_disparity_colormap(forward(item))], axis=0)
        save_png(os.path.join(output_folder, f"frame_{i:06d}.png"), frame)
    return n
