"""FCS-based OOD analysis (counterpart of adaptive_stereo_tpu/analysis/ood.py;
reference evaluation/ood_analysis.py).

Per-image Feature Contrast Scores of a loader (an eval forward, so the
cost-volume and soft-argmin kernels on the card), the precision / recall
of the threshold classifier "novel iff FCS <= cutoff" (reference
:108-119) and the Gaussian-percentile threshold that produced the canonical
OOD thresholds (reference :196-236: a percentile of a normal fit to the
training domain's FCS). The percentile uses the standard library's
statistics.NormalDist in place of scipy.stats.norm.

The two plots, the FCS histograms of both domains with the fitted normal
and its percentile line, and the precision / recall curve, are drawn by
analysis/figure.py in place of matplotlib: the same series (np.histogram
densities, as plt.hist(density=True) computes them; the normal pdf by its
formula, with scipy's dtypes) into PDF or SVG.
"""

from __future__ import annotations

import math
import statistics
from typing import Optional, Tuple

import numpy as np
import torch

from ..models import state_dicts_from_jax
from .figure import subplots


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


def normal_pdf(x: np.ndarray, mu, sigma: float) -> np.ndarray:
    """The normal density at x, as scipy.stats.norm.pdf(x, mu, sigma)
    computes it: x, mu and sigma as arrays (so x - mu in their own dtype,
    float32 for float32 FCS), the standardised value in float64."""
    x, mu, sigma = map(np.asarray, (x, mu, sigma))
    z = np.asarray((x - mu) / sigma, dtype=np.promote_types(x.dtype, np.float64))
    return np.exp(-z ** 2 / 2.0) / math.sqrt(2 * math.pi) / sigma


def plot_fcs_histogram(train_values: np.ndarray, novel_values: np.ndarray, output_path: str,
                       percentile: float = 0.05) -> None:
    """Overlaid train/novel FCS histograms (40 shared bins, densities) with
    the fitted normal of the training domain and its percentile line
    (reference :190-236)."""
    fig, ax = subplots()
    bins = np.histogram(np.hstack((train_values, novel_values)), bins=40)[1]
    y1, _ = ax.hist(train_values, bins, color="blue", alpha=0.5, label="train")
    y2, _ = ax.hist(novel_values, bins, color="red", alpha=0.5, label="novel")
    ax.set_xlabel("feature contrast score")
    ax.set_ylabel("frequency")
    pct_x = derive_percentile_threshold(train_values, percentile)
    ax.vlines(pct_x, 0, max(y1.max(), y2.max()), colors="black", linestyles=(0, (5, 5)))
    ax.plot(bins, normal_pdf(bins, train_values.mean(), math.sqrt(train_values.var())),
            color="black")
    ax.legend(loc="upper left", fontsize=12.0)  # matplotlib's "large"
    fig.savefig(output_path)


def plot_precision_recall(train_values: np.ndarray, novel_values: np.ndarray,
                          output_path: str) -> None:
    """Precision against recall over the cutoffs of precision_recall_curve."""
    _, pr, re = precision_recall_curve(train_values, novel_values)
    fig, ax = subplots()
    ax.plot(re, pr)
    ax.set_xlabel("recall")
    ax.set_ylabel("precision")
    ax.set_ylim(0, 1.05)
    fig.savefig(output_path)
