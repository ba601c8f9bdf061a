"""The refinement tower's plain version (ops/cuda/tower.py:tower_ref) against
the TPU kernel it stands for, float32 on both sides, on numpy inputs from a
seed, at the shape of tests/test_pallas_tower.py: B = 2, s2d 8x16, so 16x32
on the port's plain layout.

- forward against tower_pallas in interpret mode (train and eval);
- backward against jax.grad of the kernel's golden twin _tower_ref_raw
  (dx0, every dW and db, dgamma, dbeta), and against tower_pallas's own
  custom VJP in interpret mode;
- tower_cuda on CPU tensors is tower_ref; on any other device it never takes
  the plain version.

The JAX side works on the 2x2 space-to-depth layout; space_to_depth /
depth_to_space carry inputs and results across (exact permutations).

Tolerances (float32): the residual 2e-4 absolute + 2e-4 relative, the batch
statistics 1e-4 absolute and relative, against tower_pallas the band
tests/test_pallas_tower.py uses (2e-3 relative to the mean |residual|).
Gradients, relative to the largest gradient entry gmax over all of them:
median |diff| < 1e-4 gmax in every tensor, which a wrong term of the
formula (O(1) relative errors everywhere) breaks, and max |diff| < 1e-2
gmax. tests/test_pallas_tower.py bounds the max at 2e-3 gmax; here a
LeakyReLU branch flips: a layer-0 pre-activation of the seed-1 inputs is
3.9e-7 (float32 reassociation decides its sign), which moves one channel's
dgamma/dbeta and dW0 column and the dx0 of the pixels below it by up to
4.0e-3 gmax, while every other entry agrees within 3e-6 gmax.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaptive_stereo_tpu.models.s2d_refinement import (
    _TOWER_DILATIONS,
    _tower_ref_raw,
    depth_to_space,
    scatter_kernel_s2d,
    space_to_depth,
)
from adaptive_stereo_tpu.ops.pallas import tower as tw
from adaptive_stereo_tpu_torch.ops.cuda import (
    tower_backward_cuda,
    tower_cuda,
    tower_forward_cuda,
    tower_ref,
)
from adaptive_stereo_tpu_torch.ops.cuda.tower import DILATIONS

B, H2, W2 = 2, 8, 16
H, W = 2 * H2, 2 * W2


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    kernels = [rng.randn(3, 3, 4, 32) * 0.2] + [rng.randn(3, 3, 32, 32) * 0.1
                                                for _ in range(6)] + [rng.randn(3, 3, 32, 1) * 0.1]
    biases = [rng.randn(c) * 0.1 for c in [32] * 7 + [1]]
    f32 = lambda a: np.asarray(a, np.float32)
    return dict(
        x0=f32(rng.rand(B, H, W, 4)),
        kernels=[f32(k) for k in kernels],
        biases=[f32(b) for b in biases],
        gammas=f32(1 + 0.1 * rng.randn(7, 32)),
        betas=f32(0.1 * rng.randn(7, 32)),
        rmeans=f32(rng.rand(7, 32) * 0.2),
        rvars=f32(1 + rng.rand(7, 32)),
    )


def _torch_args(a, requires_grad=False):
    t = lambda x: torch.from_numpy(np.array(x)).requires_grad_(requires_grad)
    params = {"kernels": [t(k) for k in a["kernels"]], "biases": [t(b) for b in a["biases"]],
              "gammas": t(a["gammas"]), "betas": t(a["betas"])}
    return t(a["x0"]), params, (torch.from_numpy(a["rmeans"]), torch.from_numpy(a["rvars"]))


def _pallas(a, train, xs=None, kernels=None, biases=None, gammas=None, betas=None):
    """tower_pallas in interpret mode, as models/s2d_refinement.py calls it;
    returns the plain-layout residual (B, H, W, 1), mu, var."""
    xs = space_to_depth(jnp.asarray(a["x0"])) if xs is None else xs
    kernels = [jnp.asarray(k) for k in a["kernels"]] if kernels is None else kernels
    biases = [jnp.asarray(b) for b in a["biases"]] if biases is None else biases
    gammas = jnp.asarray(a["gammas"]) if gammas is None else gammas
    betas = jnp.asarray(a["betas"]) if betas is None else betas
    ws, bs = [], []
    for p in range(8):
        k2, _ = scatter_kernel_s2d(kernels[p], _TOWER_DILATIONS[p])
        ws.append(jnp.pad(k2, [(0, 0), (0, 0), (0, 128 - k2.shape[2]), (0, 128 - k2.shape[3])]))
        bs.append(jnp.pad(jnp.tile(biases[p], 4), (0, 128 - 4 * biases[p].shape[0])))
    tile = lambda v: jnp.tile(jnp.asarray(v), (1, 4))
    x0p = jnp.pad(xs, [(0, 0), (4, 4), (4, 4), (0, 112)]).reshape(B, (H2 + 8) * (W2 + 8), 128)
    y7, mu_t, var_t = tw.tower_pallas(x0p, jnp.stack(ws), jnp.stack(bs), tile(gammas),
                                      tile(betas), tile(a["rmeans"]), tile(a["rvars"]), train,
                                      True, H2, W2)
    res = y7.reshape(B, H2 + 8, W2 + 8, 128)[:, 4:4 + H2, 4:4 + W2, :4]
    return depth_to_space(res), mu_t[:, :32], var_t[:, :32]


def test_dilations_are_the_reference_tower():
    assert DILATIONS == _TOWER_DILATIONS == (1, 1, 2, 4, 8, 1, 1, 1)


@pytest.mark.parametrize("train", [True, False])
def test_tower_ref_forward_matches_raw_twin_and_pallas(train):
    a = _inputs()
    x0, params, run_stats = _torch_args(a)
    y, mu, var, xs, ys = tower_ref(x0, params, run_stats, train, buffers=True)
    assert y.shape == (B, H, W, 1) and mu.shape == var.shape == (7, 32)
    assert len(xs) == 7 and len(ys) == 8
    assert all(t.shape == (B, H, W, 32) for t in xs + ys[:-1])

    res_raw, mu_raw, var_raw = _tower_ref_raw(
        space_to_depth(jnp.asarray(a["x0"])), [jnp.asarray(k) for k in a["kernels"]],
        [jnp.asarray(b) for b in a["biases"]], jnp.asarray(a["gammas"]),
        jnp.asarray(a["betas"]), jnp.asarray(a["rmeans"]), jnp.asarray(a["rvars"]), train)
    np.testing.assert_allclose(y.numpy(), np.asarray(depth_to_space(res_raw)),
                               atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(mu.numpy(), np.asarray(mu_raw), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(var.numpy(), np.asarray(var_raw), atol=1e-4, rtol=1e-4)

    res_pl, mu_pl, var_pl = _pallas(a, train)
    scale = np.abs(np.asarray(res_pl)).mean() + 1e-6
    np.testing.assert_allclose(y.numpy(), np.asarray(res_pl), atol=2e-3 * scale, rtol=2e-3)
    np.testing.assert_allclose(mu.numpy(), np.asarray(mu_pl), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(var.numpy(), np.asarray(var_pl), atol=1e-4, rtol=1e-4)
    if not train:  # eval mode echoes the running statistics
        np.testing.assert_array_equal(mu.numpy(), a["rmeans"])
        np.testing.assert_array_equal(var.numpy(), a["rvars"])


def _port_grads(a, g_out):
    x0, params, run_stats = _torch_args(a, requires_grad=True)
    y, _, _ = tower_cuda(x0, params, run_stats, True)
    (y * torch.from_numpy(g_out)).sum().backward()
    return ([x0.grad] + [k.grad for k in params["kernels"]] + [b.grad for b in params["biases"]]
            + [params["gammas"].grad, params["betas"].grad])


def _assert_grads_close(got, want):
    want = [np.asarray(w, np.float32) for w in want]
    gmax = max(np.abs(w).max() for w in want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, i
        d = np.abs(g.numpy() - w)
        assert np.median(d) / gmax < 1e-4, (i, np.median(d), gmax)
        assert d.max() / gmax < 1e-2, (i, d.max(), gmax)


def _jax_grads(a, g_out, tower_fn):
    g_s2d = space_to_depth(jnp.asarray(g_out))

    def loss(args):
        xs, ks, bs, gam, bet = args
        res = tower_fn(xs, ks, bs, gam, bet)
        return jnp.sum(res * g_s2d)

    args = (space_to_depth(jnp.asarray(a["x0"])), [jnp.asarray(k) for k in a["kernels"]],
            [jnp.asarray(b) for b in a["biases"]], jnp.asarray(a["gammas"]),
            jnp.asarray(a["betas"]))
    g = jax.grad(loss)(args)
    return [depth_to_space(g[0])] + list(g[1]) + list(g[2]) + [g[3], g[4]]


def test_tower_ref_backward_matches_raw_twin_autodiff():
    """Train mode: the batch-statistics BatchNorm gradient with its
    mean-subtraction terms, the residual pass-through, dgamma and dbeta."""
    a = _inputs(1)
    g_out = np.random.RandomState(2).randn(B, H, W, 1).astype(np.float32)
    rm, rv = jnp.asarray(a["rmeans"]), jnp.asarray(a["rvars"])
    want = _jax_grads(a, g_out, lambda xs, ks, bs, gam, bet: _tower_ref_raw(
        xs, ks, bs, gam, bet, rm, rv, True)[0])
    _assert_grads_close(_port_grads(a, g_out), want)


def test_tower_ref_backward_matches_pallas_custom_vjp():
    """The same gradients against tower_pallas's own backward kernels
    (interpret mode): the chain the CUDA backward kernels replace."""
    a = _inputs(3)
    g_out = np.random.RandomState(4).randn(B, H, W, 1).astype(np.float32)
    t0 = time.perf_counter()
    want = _jax_grads(a, g_out, lambda xs, ks, bs, gam, bet: space_to_depth(
        _pallas(a, True, xs, ks, bs, gam, bet)[0]))
    print(f"tower_pallas backward, interpret mode: {time.perf_counter() - t0:.1f} s")
    _assert_grads_close(_port_grads(a, g_out), want)


def test_tower_cuda_on_cpu_is_the_plain_version():
    a = _inputs(5)
    x0, params, run_stats = _torch_args(a)
    for train in (False, True):
        got = tower_cuda(x0, params, run_stats, train)
        want = tower_ref(x0, params, run_stats, train)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


def test_tower_wrappers_never_take_the_plain_version_off_the_cpu():
    """A tensor that is not on the CPU goes to the kernel path, which
    validates it and raises here (a meta tensor is not a CUDA tensor); no
    launch is counted."""
    a = _inputs(6)
    _, params, run_stats = _torch_args(a)
    before = (tower_forward_cuda.launches, tower_backward_cuda.launches)
    x0 = torch.empty(B, H, W, 4, device="meta")
    for train in (False, True):
        with pytest.raises(ValueError, match="CUDA tensor"):
            tower_cuda(x0, params, run_stats, train)
    assert (tower_forward_cuda.launches, tower_backward_cuda.launches) == before
