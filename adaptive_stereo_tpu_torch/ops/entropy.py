"""Image entropy utilities (exploratory OOD signals, not on the adaptation
step's path).

Counterpart of adaptive_stereo_tpu/ops/entropy.py (reference
adaptive_stereo/utils/entropy.py:4-46).
"""

from __future__ import annotations

import torch


def _shannon_entropy_from_counts(bin_counts: torch.Tensor, num_pixels: int) -> torch.Tensor:
    bin_probs = bin_counts.to(torch.float32) / float(num_pixels)
    safe = torch.where(bin_probs > 0, bin_probs, torch.ones_like(bin_probs))
    log_probs = torch.where(bin_probs > 0, torch.log2(safe), torch.zeros_like(bin_probs))
    return -(bin_probs * log_probs).sum()


def grayscale_shannon_entropy(img: torch.Tensor) -> torch.Tensor:
    """Shannon entropy of the 256-bin grayscale intensity histogram of a
    float image in [0, 1], any shape (one image, not a batch)."""
    img_256 = torch.clamp((255.0 * img).to(torch.int32), 0, 255)
    counts = torch.bincount(img_256.reshape(-1).long(), minlength=256)
    return _shannon_entropy_from_counts(counts, img_256.numel())


def gradient_shannon_entropy(img: torch.Tensor) -> torch.Tensor:
    """Entropy of the horizontal intensity-gradient histogram (256 bins over
    [-255, 255], as torch.histc(256, min=-255, max=255)) of one (H, W)
    image."""
    if img.dim() != 2:
        raise ValueError("gradient_shannon_entropy expects a single (H, W) image")
    img_256 = (255.0 * img).to(torch.int32)
    diff_x = (img_256[:, 1:] - img_256[:, :-1]).to(torch.float32)
    # 256 uniform bins over [-255, 255]; the right edge falls in the last bin.
    bin_idx = torch.clamp(((diff_x + 255.0) * (256.0 / 510.0)).to(torch.int32), 0, 255)
    counts = torch.bincount(bin_idx.reshape(-1).long(), minlength=256)
    return _shannon_entropy_from_counts(counts, diff_x.numel())
