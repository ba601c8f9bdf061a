"""The port's warp and losses (adaptive_stereo_tpu_torch/ops/warp.py,
ops/losses.py, ops/ema.py) against the JAX package's, float32 on both sides,
on numpy inputs from a seed.

The JAX warp runs at warp_precision "highest" (the exact one-hot
contraction); the port samples with F.grid_sample. Disparities run from
below 0 to past the image width, so some samples fall past the border (the
border clamp, zero gradient there) and some outside the validity mask.

Tolerances: warp values 1e-5 absolute (a bilinear sample of values in
[0, 1]; grid_sample recovers the source column from the normalised grid,
which rounds differently from JAX's direct x - d - 0.5); SSIM, L1 and the
losses 1e-5 absolute and relative; gradients with respect to the disparity
1e-4 absolute + 1e-3 relative (the bilinear weight's derivative is the
difference of two neighbours, and both sides reach the same float32 sums in
other orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaptive_stereo_tpu.ops import ema as jax_ema
from adaptive_stereo_tpu.ops import losses as jl
from adaptive_stereo_tpu.ops import warp as jw
from adaptive_stereo_tpu_torch.ops import ema, losses, warp

VAL_TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=1e-4, rtol=1e-3)


def _inputs(seed, b=2, h=12, w=20):
    rng = np.random.RandomState(seed)
    left = rng.rand(b, h, w, 3).astype(np.float32)
    right = rng.rand(b, h, w, 3).astype(np.float32)
    # From -2 px to past the width: in range, past the border and masked out.
    disp = rng.uniform(-2.0, w + 4.0, (b, h, w, 1)).astype(np.float32)
    disp[:, :, : w // 2] = rng.uniform(0.0, 6.0, (b, h, w // 2, 1))
    return left, right, disp


@pytest.mark.parametrize("right_to_left", [True, False])
@pytest.mark.parametrize("max_disp", [None, 8])
def test_linear_warp_matches_jax(right_to_left, max_disp):
    img, _, disp = _inputs(0)
    ref, ref_mask = jw.linear_warp(jnp.asarray(img), jnp.asarray(disp), right_to_left,
                                   max_disp=max_disp, precision="highest")
    out, mask = warp.linear_warp(torch.from_numpy(img), torch.from_numpy(disp), right_to_left,
                                 max_disp=max_disp)
    assert out.shape == ref.shape and mask.shape == ref_mask.shape
    np.testing.assert_array_equal(mask.numpy(), np.asarray(ref_mask))
    assert 0 < mask.float().mean() < 1
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **VAL_TOL)


def test_linear_warp_gradient_matches_jax():
    img, _, disp = _inputs(1)
    wts = np.random.RandomState(5).randn(*img.shape).astype(np.float32)

    def jax_fn(d):
        out, _ = jw.linear_warp(jnp.asarray(img), d, True, precision="highest")
        return jnp.sum(out * wts)

    ref = jax.grad(jax_fn)(jnp.asarray(disp))
    d = torch.from_numpy(disp).requires_grad_()
    out, _ = warp.linear_warp(torch.from_numpy(img), d, True)
    (out * torch.from_numpy(wts)).sum().backward()
    np.testing.assert_allclose(d.grad.numpy(), np.asarray(ref), **GRAD_TOL)


def test_convert_disp_to_flow_matches_jax():
    _, _, disp = _inputs(2)
    ref = jw.convert_disp_to_flow(jnp.asarray(disp), 12, 20)
    out = warp.convert_disp_to_flow(torch.from_numpy(disp), 12, 20)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **VAL_TOL)


def test_ssim_and_smoothness_match_jax():
    left, right, disp = _inputs(3)
    np.testing.assert_allclose(
        losses.ssim(torch.from_numpy(left), torch.from_numpy(right)).numpy(),
        np.asarray(jl.ssim(jnp.asarray(left), jnp.asarray(right))), **VAL_TOL)
    np.testing.assert_allclose(
        losses.monodepth_edge_aware_smoothness_loss(torch.from_numpy(disp),
                                                    torch.from_numpy(left)).numpy(),
        np.asarray(jl.monodepth_edge_aware_smoothness_loss(jnp.asarray(disp),
                                                           jnp.asarray(left))), **VAL_TOL)
    ref = jl.monodepth_loss(jnp.asarray(disp), jnp.asarray(left), jnp.asarray(right), 1e-3)
    out = losses.monodepth_loss(torch.from_numpy(disp), torch.from_numpy(left),
                                torch.from_numpy(right), 1e-3)
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **VAL_TOL)


@pytest.mark.parametrize("max_disp", [None, 192])
def test_monodepth_single_loss_and_gradient_match_jax(max_disp):
    left, right, disp = _inputs(4)

    def jax_fn(d):
        return jl.monodepth_single_loss(jnp.asarray(left), jnp.asarray(right), d, 1e-3,
                                        max_disp=max_disp, warp_precision="highest")[0]

    ref_loss, ref_grad = jax.value_and_grad(jax_fn)(jnp.asarray(disp))
    d = torch.from_numpy(disp).requires_grad_()
    loss, warped = losses.monodepth_single_loss(torch.from_numpy(left), torch.from_numpy(right),
                                                d, 1e-3, max_disp=max_disp)
    loss.backward()
    assert float(ref_loss) > 0
    np.testing.assert_allclose(loss.item(), float(ref_loss), **VAL_TOL)
    np.testing.assert_allclose(d.grad.numpy(), np.asarray(ref_grad), **GRAD_TOL)
    assert warped.shape == left.shape


def test_khamis_robust_loss_and_gradient_match_jax():
    rng = np.random.RandomState(6)
    pred = (rng.rand(2, 8, 10, 1) * 40).astype(np.float32)
    gt = (rng.rand(2, 8, 10, 1) * 40).astype(np.float32)
    gt[:, :2] = 0.0  # no ground truth there
    ref_loss, ref_grad = jax.value_and_grad(
        lambda p: jl.khamis_robust_loss(p, jnp.asarray(gt)))(jnp.asarray(pred))
    p = torch.from_numpy(pred).requires_grad_()
    loss = losses.khamis_robust_loss(p, torch.from_numpy(gt))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref_loss), **VAL_TOL)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(ref_grad), **GRAD_TOL)
    # No valid pixel: the count is floored at 1 and the loss is 0.
    assert losses.khamis_robust_loss(p, torch.zeros_like(p)).item() == 0.0


def test_online_ema_matches_jax():
    assert ema.online_ema(2.0, 5.0) == jax_ema.online_ema(2.0, 5.0)
    assert ema.online_ema(2.0, 5.0, 0.5) == jax_ema.online_ema(2.0, 5.0, 0.5) == 3.5
