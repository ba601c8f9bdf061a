"""Plain PyTorch ops (counterparts of adaptive_stereo_tpu/ops/)."""

from .cost_volume import difference_cost_volume
from .fcs import feature_contrast_mean
from .soft_argmin import soft_argmin

__all__ = ["difference_cost_volume", "feature_contrast_mean", "soft_argmin"]
