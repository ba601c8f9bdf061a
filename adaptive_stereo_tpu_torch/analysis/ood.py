"""FCS-based OOD analysis, the numeric half (counterpart of
adaptive_stereo_tpu/analysis/ood.py:19-75; reference
evaluation/ood_analysis.py).

Per-image Feature Contrast Scores of a loader (an eval forward, so the
cost-volume and soft-argmin kernels on the card), the precision / recall
of the threshold classifier "novel iff FCS <= cutoff" (reference
:108-119) and the Gaussian-percentile threshold that produced the canonical
OOD thresholds (reference :196-236: a percentile of a normal fit to the
training domain's FCS). The percentile uses the standard library's
statistics.NormalDist in place of scipy.stats.norm.

Not ported yet: plot_fcs_histogram and plot_precision_recall, which need
matplotlib.
"""

from __future__ import annotations

import math
import statistics
from typing import Optional, Tuple

import numpy as np
import torch

from ..models import state_dicts_from_jax


def compute_fcs_for_loader(model: torch.nn.Module, variables: Optional[dict], loader,
                           input_scale: int, k: int,
                           max_batches: Optional[int] = None) -> np.ndarray:
    """Per-image mean FCS over a loader, eval mode, on the model's device.
    variables: JAX-layout {'params', 'batch_stats'} loaded into the model
    first, or None for the model's own weights. Returns (N,)."""
    if variables is not None:
        model.load_state_dicts(*state_dicts_from_jax(variables, k))
    dev = next(model.parameters()).device
    coarse = input_scale + k
    model.eval()
    scores = []
    with torch.no_grad():
        for i, batch in enumerate(loader):
            if max_batches is not None and i >= max_batches:
                break
            left, right = (torch.as_tensor(batch[f"color_{side}/{input_scale}"]).to(dev)
                           for side in "lr")
            fcs = model(left, right, side="l")[f"fcs_l/{coarse}"]
            scores.append(fcs.mean(dim=(1, 2)).cpu().numpy())
    return np.concatenate(scores)


def compute_precision_recall(train_values: np.ndarray, novel_values: np.ndarray,
                             cutoff: float) -> Tuple[float, float]:
    """Classifier: novel iff value <= cutoff (reference ood_analysis.py:105-119)."""
    tp = int((novel_values <= cutoff).sum())
    fn = int((novel_values > cutoff).sum())
    fp = int((train_values <= cutoff).sum())
    pr = tp / (tp + fp) if (tp + fp) > 0 else 1.0
    re = tp / (tp + fn)
    return pr, re


def precision_recall_curve(train_values: np.ndarray, novel_values: np.ndarray,
                           num: int = 100):
    """PR over cutoffs spanning the novel FCS range (reference :122-137)."""
    cutoffs = np.linspace(novel_values.min(), novel_values.max(), num=num)
    pr = np.zeros(num)
    re = np.zeros(num)
    for i, c in enumerate(cutoffs):
        pr[i], re[i] = compute_precision_recall(train_values, novel_values, c)
    return cutoffs, pr, re


def derive_percentile_threshold(train_values: np.ndarray, percentile: float = 0.05) -> float:
    """Gaussian-fit percentile of the training domain's FCS distribution:
    how the canonical OOD thresholds were derived (reference :204-209)."""
    mu = float(train_values.mean())
    sigma = math.sqrt(float(train_values.var()))
    return float(statistics.NormalDist(mu, sigma).inv_cdf(percentile))
