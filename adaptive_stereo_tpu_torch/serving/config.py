"""Serving configuration: the same fields and defaults as
adaptive_stereo_tpu/serving/config.py (behavioural contract of the reference
ros/config.py:12-62, minus ROS topic plumbing)."""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


def _default_intrinsics() -> np.ndarray:
    return np.array(
        [[1329.0, 0.0, 607.5], [0.0, 1329.0, 159.5], [0.0, 0.0, 1.0]], np.float64
    )


@dataclass
class ServingConfig:
    model_input_height: int = 320
    model_input_width: int = 1216
    stereonet_k: int = 4
    input_scale: int = 0
    # Folder holding the reference's feature_net.pth / stereo_net.pth.
    load_weights_folder: str = ""

    max_depth: float = 100.0
    stereo_baseline_meters: float = 1.0
    voxel_disp_scale: int = 2        # pyramid scale used for the voxel map
    voxel_scale_meters: float = 0.15
    publish_disp_hz: float = 20.0
    publish_color_point_cloud: bool = True
    camera_intrinsics: np.ndarray = field(default_factory=_default_intrinsics)
    compute_dtype: str = "bfloat16"
    # Kept for field parity with the JAX config. The port's aggregation
    # stack always runs on its CUDA kernel; this field selects nothing.
    pallas_aggregation: bool = False
    # True: the coarse head (cost volume, aggregation stack, soft-argmin +
    # FCS) runs as ONE fused CUDA kernel (csrc/coarse_head.cu) instead of
    # the three kernels in turn; the same function, the same weights. Off by
    # default, as in the JAX config. On the CPU both run the plain versions.
    fused_coarse_head: bool = False
