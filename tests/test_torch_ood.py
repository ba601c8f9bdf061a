"""The numeric half of the FCS OOD analysis (analysis/ood.py) against the
JAX package's (adaptive_stereo_tpu/analysis/ood.py), on the CPU.

- compute_fcs_for_loader: per-image FCS of the eval forward at 32x64, k=2,
  maxdisp 47, float32, from the same variables, within the model band of
  tests/test_torch_model.py (2e-3 + 1e-4 relative);
- compute_precision_recall and precision_recall_curve: equal;
- derive_percentile_threshold (statistics.NormalDist in place of
  scipy.stats.norm): within 1e-9.
"""

import numpy as np
import pytest

from adaptive_stereo_tpu.analysis.ood import (
    compute_fcs_for_loader as jax_fcs,
    compute_precision_recall as jax_pr,
    derive_percentile_threshold as jax_threshold,
    precision_recall_curve as jax_curve,
)
from adaptive_stereo_tpu.models import StereoModel as JaxStereoModel
from adaptive_stereo_tpu_torch.analysis import (compute_fcs_for_loader, compute_precision_recall,
                                                derive_percentile_threshold,
                                                precision_recall_curve)
from adaptive_stereo_tpu_torch.models import StereoModel
from test_torch_train import H, K, MAXDISP, OUT_TOL, S, _frames, _variables


def _values(seed, n, loc):
    return np.random.RandomState(seed).normal(loc, 1.5, n).astype(np.float32)


@pytest.mark.parametrize("percentile", [0.01, 0.05, 0.5, 0.9])
def test_percentile_threshold_matches_scipy(percentile):
    train = _values(0, 200, 12.0)
    got = derive_percentile_threshold(train, percentile)
    want = jax_threshold(train, percentile)
    print(f"percentile {percentile}: port {got!r}, JAX (scipy) {want!r}")
    assert abs(got - want) <= 1e-9
    assert (got < train.mean()) == (percentile < 0.5)


def test_precision_recall_and_curve_match_jax():
    train, novel = _values(1, 300, 12.0), _values(2, 150, 9.0)
    for cutoff in (8.0, 10.5, 12.0, 20.0):
        assert compute_precision_recall(train, novel, cutoff) == jax_pr(train, novel, cutoff)
    got, want = precision_recall_curve(train, novel, 25), jax_curve(train, novel, 25)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_fcs_for_loader_matches_jax():
    """Two loaders' worth of batches (sizes 2 and 1) through max_batches;
    the port takes JAX's variables into its model."""
    variables = _variables(3)
    rng = np.random.RandomState(4)
    loader = []
    for n in (2, 1, 2):
        left, right = _frames(rng, n)
        loader.append({f"color_l/{S}": left, f"color_r/{S}": right})
    model = StereoModel(k=K, input_scale=S, maxdisp=MAXDISP, device="cpu")
    got = compute_fcs_for_loader(model, variables, loader, S, K, max_batches=2)
    jax_model = JaxStereoModel(k=K, input_scale=S, maxdisp=MAXDISP)
    want = jax_fcs(jax_model, variables, loader, S, K, max_batches=2)
    print(f"FCS per image: port {got}, JAX {want}")
    assert got.shape == want.shape == (3,) and H == loader[0][f"color_l/{S}"].shape[1]
    np.testing.assert_allclose(got, want, **OUT_TOL)
    again = compute_fcs_for_loader(model, None, loader, S, K)
    np.testing.assert_array_equal(again[:3], got)
    assert again.shape == (5,)
