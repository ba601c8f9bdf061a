"""Online exponential moving average (TensorBoard smoothing semantics).

Counterpart of adaptive_stereo_tpu/ops/ema.py (reference
adaptive_stereo/utils/ema.py:1-13): smooths the raw Feature Contrast Score
stream before OOD thresholding (weight 0.999).
"""

from __future__ import annotations


def online_ema(s_last: float, v_new: float, weight: float = 0.999) -> float:
    """One EMA update: s = w*s_last + (1-w)*v_new."""
    return s_last * weight + (1.0 - weight) * v_new
