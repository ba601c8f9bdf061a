"""Analysis tools (counterpart of adaptive_stereo_tpu/analysis/): the
StereoNet timing benchmark, the FCS OOD analysis (its numeric functions)
and the reconstruction-based OOD baselines. The results pipeline, the
TensorBoard extraction, the cost-volume plots, profiling and the OOD plots
are not ported yet."""

from .ood import (
    compute_fcs_for_loader,
    compute_precision_recall,
    derive_percentile_threshold,
    precision_recall_curve,
)
from .reconstruction_ood import (
    reconstruction_precision_recall,
    reconstruction_scores,
    train_autoencoder,
)
from .timing import time_stereonet

__all__ = [
    "compute_fcs_for_loader",
    "compute_precision_recall",
    "derive_percentile_threshold",
    "precision_recall_curve",
    "reconstruction_precision_recall",
    "reconstruction_scores",
    "time_stereonet",
    "train_autoencoder",
]
