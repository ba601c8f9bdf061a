"""Utilities (counterpart of adaptive_stereo_tpu/utils/): run provenance,
console metric banners and trials.csv, the OVS reservoir and priority
queue, and the disparity colormap and PNG panels."""

from .stereo_priority_queue import StereoPriorityQueue
from .stereo_reservoir import StereoReservoir

__all__ = ["StereoPriorityQueue", "StereoReservoir"]
