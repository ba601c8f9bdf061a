"""Analysis tools (counterpart of adaptive_stereo_tpu/analysis/): the
StereoNet timing benchmark. The FCS/OOD analysis, the results pipeline and
the cost-volume plots are not ported yet."""

from .timing import time_stereonet

__all__ = ["time_stereonet"]
