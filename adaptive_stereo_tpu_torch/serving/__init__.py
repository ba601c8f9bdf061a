"""Serving: stream-ingest stereo depth engine (counterpart of
adaptive_stereo_tpu/serving/)."""

from .config import ServingConfig
from .stream import (
    AsyncStereoDepthEngine,
    StereoDepthEngine,
    depth_to_pointcloud,
    disparity_to_depth,
    replay_dataset_stream,
    voxel_downsample,
)

__all__ = [
    "AsyncStereoDepthEngine",
    "ServingConfig",
    "StereoDepthEngine",
    "depth_to_pointcloud",
    "disparity_to_depth",
    "replay_dataset_stream",
    "voxel_downsample",
]
