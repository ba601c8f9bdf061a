"""Analysis tools (counterpart of adaptive_stereo_tpu/analysis/): the
StereoNet timing benchmark, the FCS OOD analysis and its plots, the
reconstruction-based OOD baselines, the results pipeline (trials.csv ->
results table, CSV and plots), the TensorBoard scalar extraction, the
cost-volume dumps and slice plots, and profiling. The plots are drawn by
the port's own figure writer (figure.py, PDF or SVG)."""

from .ood import (
    compute_fcs_for_loader,
    compute_precision_recall,
    derive_percentile_threshold,
    plot_fcs_histogram,
    plot_precision_recall,
    precision_recall_curve,
)
from .reconstruction_ood import (
    reconstruction_precision_recall,
    reconstruction_scores,
    train_autoencoder,
)
from .results import collate_trials, results_to_csv
from .timing import time_stereonet

__all__ = [
    "collate_trials",
    "compute_fcs_for_loader",
    "compute_precision_recall",
    "derive_percentile_threshold",
    "plot_fcs_histogram",
    "plot_precision_recall",
    "precision_recall_curve",
    "reconstruction_precision_recall",
    "reconstruction_scores",
    "results_to_csv",
    "time_stereonet",
    "train_autoencoder",
]
