"""Plain PyTorch ops (counterparts of adaptive_stereo_tpu/ops/)."""

from .cost_volume import difference_cost_volume
from .ema import online_ema
from .fcs import feature_contrast_mean
from .losses import (khamis_robust_loss, monodepth_edge_aware_smoothness_loss, monodepth_loss,
                     monodepth_single_loss, ssim)
from .soft_argmin import soft_argmin
from .warp import convert_disp_to_flow, linear_warp

__all__ = ["convert_disp_to_flow", "difference_cost_volume", "feature_contrast_mean",
           "khamis_robust_loss", "linear_warp", "monodepth_edge_aware_smoothness_loss",
           "monodepth_loss", "monodepth_single_loss", "online_ema", "soft_argmin", "ssim"]
