"""Port's plain ops vs the JAX package's, float32 on both sides.

adaptive_stereo_tpu_torch/ops/{cost_volume,soft_argmin,fcs}.py against
adaptive_stereo_tpu/ops/{cost_volume,soft_argmin,fcs}.py on the same numpy
inputs made from a seed.

Tolerances: the cost volume is one float32 subtraction per element on both
sides, so it must be bitwise equal. Soft-argmin and FCS reduce over D in
float32 in different orders: 1e-5 absolute and relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaptive_stereo_tpu.ops import (
    difference_cost_volume as jax_cost_volume,
    feature_contrast_mean as jax_fcs,
    soft_argmin as jax_soft_argmin,
)
from adaptive_stereo_tpu_torch.ops import (
    difference_cost_volume,
    feature_contrast_mean,
    soft_argmin,
)

REDUCTION_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("b,h,w,c,d", [
    (1, 4, 12, 8, 5),
    (2, 8, 16, 32, 12),
    (1, 4, 6, 4, 8),  # D >= W: the slices d >= W are all zeros
])
def test_cost_volume_matches_jax(b, h, w, c, d):
    rng = np.random.RandomState(b * 1000 + w)
    fl = rng.randn(b, h, w, c).astype(np.float32)
    fr = rng.randn(b, h, w, c).astype(np.float32)
    ref = np.asarray(jax_cost_volume(jnp.asarray(fl), jnp.asarray(fr), d))
    out = difference_cost_volume(torch.from_numpy(fl), torch.from_numpy(fr), d).numpy()
    assert out.shape == (b, d, h, w, c)
    np.testing.assert_array_equal(out, ref)
    for di in range(min(d, w)):
        assert not out[:, di, :, :di].any()  # x < d border is exactly zero
    assert not out[:, w:].any()


def test_cost_volume_rejects_bad_arguments():
    f = torch.zeros(1, 2, 3, 4)
    with pytest.raises(ValueError):
        difference_cost_volume(f, torch.zeros(1, 2, 4, 4), 2)
    with pytest.raises(ValueError):
        difference_cost_volume(f, f, 0)


@pytest.mark.parametrize("b,d,h,w", [(2, 12, 8, 16), (1, 24, 4, 32)])
def test_soft_argmin_and_fcs_match_jax(b, d, h, w):
    cost = (np.random.RandomState(d).randn(b, d, h, w) * 5).astype(np.float32)
    t = torch.from_numpy(cost)
    np.testing.assert_allclose(soft_argmin(t, dim=1).numpy(),
                               np.asarray(jax_soft_argmin(jnp.asarray(cost), axis=1)),
                               **REDUCTION_TOL)
    np.testing.assert_allclose(feature_contrast_mean(t).numpy(),
                               np.asarray(jax_fcs(jnp.asarray(cost))), **REDUCTION_TOL)


def test_fcs_duplicated_max_matches_jax():
    # A duplicated max is its own runner-up (first-occurrence tie rule).
    cost = np.zeros((1, 6, 2, 2), np.float32)
    cost[:, 2] = 3.0
    cost[:, 4] = 3.0
    out = feature_contrast_mean(torch.from_numpy(cost)).numpy()
    np.testing.assert_allclose(out, np.asarray(jax_fcs(jnp.asarray(cost))), atol=1e-6)
    np.testing.assert_allclose(out, 3.0, atol=1e-6)  # 3 - mean(0, 0, 0, 0)


def test_fcs_needs_three_disparities():
    with pytest.raises(ValueError):
        feature_contrast_mean(torch.zeros(1, 2, 3, 3))
