"""The CUDA kernels' plain versions vs the TPU kernels (Pallas, interpreter
mode on the CPU, as tests/test_pallas_kernels.py runs them).

On CPU tensors each wrapper of adaptive_stereo_tpu_torch/ops/cuda takes its
plain version; these tests hold that plain version against the Pallas
kernel it stands for, float32 on both sides, on numpy inputs from a seed.
The kernels themselves build and run only on the card (chip_smoke.py).

Tolerances: cost volume bitwise equal (one float32 subtraction per
element). Soft-argmin + FCS 1e-5 absolute and relative (float32 reductions
over D in different orders). Aggregation 1e-4 absolute and relative, the
band tests/test_pallas_kernels.py uses for the Pallas kernel against its jnp
twin (five stacked float32 convolutions of 864 terms each). The fused
coarse head: disparity and FCS within the aggregation band (they are
functions of the aggregated cost), batch mu/var 1e-4 relative + 1e-5
absolute (float32 means over B*D*H*W in different orders).

Backward of kernels 1-3: on the card each wrapper is a
torch.autograd.Function whose backward is plain PyTorch. These tests drive
those Functions on the CPU, with the kernel launch replaced by the plain
forward, and hold the gradients against jax.vjp of the Pallas functions:
the cost volume bitwise (sums of the same float32 terms in the same order),
soft-argmin 1e-5 absolute and relative, aggregation the aggregation band.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaptive_stereo_tpu.ops.pallas import (
    aggregate_cost_volume_pallas,
    coarse_head_pallas,
    aggregate_cost_volume_ref as jax_aggregate_ref,
    difference_cost_volume_pallas,
    soft_argmin_fcs_pallas,
)
from adaptive_stereo_tpu_torch.ops.cuda import aggregation as agg_mod
from adaptive_stereo_tpu_torch.ops.cuda import cost_volume as cv_mod
from adaptive_stereo_tpu_torch.ops.cuda import disparity as disp_mod
from adaptive_stereo_tpu_torch.ops.cuda import (
    aggregate_cost_volume_cuda,
    coarse_head_cuda,
    coarse_head_cuda_supported,
    difference_cost_volume_cuda,
    soft_argmin_fcs_cuda,
    tower_cuda,
)

DISP_TOL = dict(rtol=1e-5, atol=1e-5)
AGG_TOL = dict(rtol=1e-4, atol=1e-4)
STATS_TOL = dict(rtol=1e-4, atol=1e-5)


def _agg_inputs(rng, b, d, h, w, scale=0.1):
    params = {
        "kernels": rng.randn(4, 3, 3, 3, 32, 32) * scale,
        "biases": rng.randn(4, 32) * scale,
        "scales": 1 + rng.randn(4, 32) * scale,
        "bn_biases": rng.randn(4, 32) * scale,
        "final_kernel": rng.randn(3, 3, 3, 32, 1) * scale,
        "final_bias": rng.randn(1) * scale,
    }
    params = {k: v.astype(np.float32) for k, v in params.items()}
    stats = ((rng.randn(4, 32) * 0.05).astype(np.float32),
             (1 + rng.rand(4, 32) * 0.1).astype(np.float32))
    cost = rng.randn(b, d, h, w, 32).astype(np.float32)
    return cost, params, stats


def _jax(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _torch(tree):
    return {k: torch.from_numpy(v) for k, v in tree.items()}


@pytest.mark.parametrize("b,h,w,c,d", [(1, 4, 12, 8, 5), (1, 5, 16, 32, 12),
                                       (1, 4, 6, 4, 8)])
def test_cost_volume_plain_matches_pallas(b, h, w, c, d):
    rng = np.random.RandomState(w)
    fl = rng.randn(b, h, w, c).astype(np.float32)
    fr = rng.randn(b, h, w, c).astype(np.float32)
    ref = difference_cost_volume_pallas(jnp.asarray(fl), jnp.asarray(fr), d, interpret=True)
    out = difference_cost_volume_cuda(torch.from_numpy(fl), torch.from_numpy(fr), d)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("b,d,h,w", [(2, 12, 8, 16), (1, 12, 4, 8)])
def test_soft_argmin_fcs_plain_matches_pallas(b, d, h, w):
    cost = (np.random.RandomState(h).randn(b, d, h, w) * 5).astype(np.float32)
    disp_ref, fcs_ref = soft_argmin_fcs_pallas(jnp.asarray(cost), interpret=True)
    disp, fcs = soft_argmin_fcs_cuda(torch.from_numpy(cost))
    assert disp.dtype == fcs.dtype == torch.float32
    np.testing.assert_allclose(disp.numpy(), np.asarray(disp_ref), **DISP_TOL)
    np.testing.assert_allclose(fcs.numpy(), np.asarray(fcs_ref), **DISP_TOL)


def test_soft_argmin_fcs_plain_duplicate_max_matches_pallas():
    cost = np.zeros((1, 6, 2, 2), np.float32)
    cost[:, 2] = 3.0
    cost[:, 4] = 3.0
    disp_ref, fcs_ref = soft_argmin_fcs_pallas(jnp.asarray(cost), interpret=True)
    disp, fcs = soft_argmin_fcs_cuda(torch.from_numpy(cost))
    np.testing.assert_allclose(fcs.numpy(), np.asarray(fcs_ref), atol=1e-6)
    np.testing.assert_allclose(disp.numpy(), np.asarray(disp_ref), **DISP_TOL)


@pytest.mark.parametrize("b,d,h,w", [(1, 12, 4, 8), (2, 5, 3, 12)])
def test_aggregation_plain_matches_pallas_eval(b, d, h, w):
    cost, params, stats = _agg_inputs(np.random.RandomState(b * 100 + d), b, d, h, w)
    ref, mu_r, var_r = aggregate_cost_volume_pallas(
        jnp.asarray(cost), _jax(params), tuple(map(jnp.asarray, stats)), False,
        interpret=True)
    out, mu, var = aggregate_cost_volume_cuda(
        torch.from_numpy(cost), _torch(params), tuple(map(torch.from_numpy, stats)),
        train=False)
    assert out.shape == (b, d, h, w) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **AGG_TOL)
    # Eval mode echoes the running statistics.
    np.testing.assert_array_equal(mu.numpy(), np.asarray(mu_r))
    np.testing.assert_array_equal(var.numpy(), np.asarray(var_r))


def test_aggregation_plain_train_statistics_match_jax():
    """The plain version also serves train mode on CPU tensors: batch
    statistics with the fast variance, as the JAX twin computes them."""
    cost, params, stats = _agg_inputs(np.random.RandomState(11), 2, 6, 4, 8)
    ref, mu_r, var_r = jax_aggregate_ref(
        jnp.asarray(cost), _jax(params), tuple(map(jnp.asarray, stats)), True)
    out, mu, var = aggregate_cost_volume_cuda(
        torch.from_numpy(cost), _torch(params), tuple(map(torch.from_numpy, stats)),
        train=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **AGG_TOL)
    np.testing.assert_allclose(mu.numpy(), np.asarray(mu_r), **STATS_TOL)
    np.testing.assert_allclose(var.numpy(), np.asarray(var_r), **STATS_TOL)


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("b,d,h,w", [(1, 12, 8, 16), (2, 5, 6, 12)])
def test_coarse_head_plain_matches_pallas(b, d, h, w, train):
    rng = np.random.RandomState(b * 100 + d)
    _, params, stats = _agg_inputs(rng, 1, 1, 1, 1)
    fl = rng.randn(b, h, w, 32).astype(np.float32)
    fr = rng.randn(b, h, w, 32).astype(np.float32)
    ref = coarse_head_pallas(jnp.asarray(fl), jnp.asarray(fr), _jax(params),
                             tuple(map(jnp.asarray, stats)), d, train, interpret=True)
    out = coarse_head_cuda(torch.from_numpy(fl), torch.from_numpy(fr), _torch(params),
                           tuple(map(torch.from_numpy, stats)), train, d)
    for got, want, name in zip(out, ref, ("disp", "fcs", "mu", "var")):
        assert got.dtype == torch.float32 and tuple(got.shape) == want.shape, name
        tol = AGG_TOL if name in ("disp", "fcs") else STATS_TOL
        np.testing.assert_allclose(got.numpy(), np.asarray(want), err_msg=name, **tol)
    if not train:  # eval mode echoes the running statistics
        np.testing.assert_array_equal(out[2].numpy(), stats[0])
        np.testing.assert_array_equal(out[3].numpy(), stats[1])


def test_coarse_head_admission():
    assert coarse_head_cuda_supported((1, 20, 76, 32), 12, torch.bfloat16)
    assert coarse_head_cuda_supported((2, 6, 12, 32), 3, torch.float32)
    assert not coarse_head_cuda_supported((1, 20, 76, 16), 12, torch.bfloat16)  # C != 32
    assert not coarse_head_cuda_supported((1, 20, 76, 32), 2, torch.bfloat16)   # D < 3
    assert not coarse_head_cuda_supported((1, 20, 76, 32), 12, torch.float16)
    assert not coarse_head_cuda_supported((20, 76, 32), 12, torch.float32)


def test_wrappers_never_take_the_plain_version_off_the_cpu():
    """A tensor that is not on the CPU goes to the kernel path, which
    validates it and raises here (a meta tensor is not a CUDA tensor); it
    never falls back to the plain version, and counts no launch."""
    wrappers = (difference_cost_volume_cuda, aggregate_cost_volume_cuda, soft_argmin_fcs_cuda,
                coarse_head_cuda)
    before = [w.launches for w in wrappers]
    f = torch.empty(1, 4, 8, 32, device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        difference_cost_volume_cuda(f, f, 4)
    with pytest.raises(ValueError, match="CUDA tensor"):
        soft_argmin_fcs_cuda(torch.empty(1, 12, 4, 8, device="meta"))
    _, params, stats = _agg_inputs(np.random.RandomState(0), 1, 1, 1, 1)
    for train in (False, True):
        with pytest.raises(ValueError, match="CUDA tensor"):
            aggregate_cost_volume_cuda(torch.empty(1, 12, 4, 8, 32, device="meta"),
                                       _torch(params), tuple(map(torch.from_numpy, stats)),
                                       train=train)
        with pytest.raises(ValueError, match="CUDA tensor"):
            coarse_head_cuda(f, f, _torch(params), tuple(map(torch.from_numpy, stats)),
                             train, 12)
        tower = {"kernels": [torch.zeros(3, 3, 4, 32)] + [torch.zeros(3, 3, 32, 32)] * 6
                 + [torch.zeros(3, 3, 32, 1)], "biases": [torch.zeros(32)] * 7 + [torch.zeros(1)],
                 "gammas": torch.ones(7, 32), "betas": torch.zeros(7, 32)}
        with pytest.raises(ValueError, match="CUDA tensor"):
            tower_cuda(torch.empty(1, 8, 16, 4, device="meta"), tower,
                       (torch.zeros(7, 32), torch.ones(7, 32)), train)
    assert [w.launches for w in wrappers] == before


@pytest.mark.parametrize("b,h,w,c,d", [(1, 4, 12, 8, 5), (2, 3, 6, 4, 8)])
def test_cost_volume_backward_matches_pallas_vjp(monkeypatch, b, h, w, c, d):
    rng = np.random.RandomState(w)
    fl, fr = (rng.randn(b, h, w, c).astype(np.float32) for _ in range(2))
    g = rng.randn(b, d, h, w, c).astype(np.float32)
    _, vjp = jax.vjp(lambda x, y: difference_cost_volume_pallas(x, y, d, interpret=True),
                     jnp.asarray(fl), jnp.asarray(fr))
    ref = vjp(jnp.asarray(g))
    monkeypatch.setattr(cv_mod, "_launch", lambda x, y, n: cv_mod.difference_cost_volume_ref(
        x.detach(), y.detach(), n))
    tl, tr = (torch.from_numpy(x).requires_grad_() for x in (fl, fr))
    out = cv_mod._CostVolume.apply(tl, tr, d)
    out.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(tl.grad.numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(tr.grad.numpy(), np.asarray(ref[1]))


def test_soft_argmin_backward_matches_pallas_vjp(monkeypatch):
    rng = np.random.RandomState(3)
    cost = (rng.randn(2, 12, 4, 8) * 5).astype(np.float32)
    g = rng.randn(2, 4, 8).astype(np.float32)
    (_, _), vjp = jax.vjp(lambda c: soft_argmin_fcs_pallas(c, interpret=True), jnp.asarray(cost))
    ref, = vjp((jnp.asarray(g), jnp.zeros((2, 4, 8), jnp.float32)))
    monkeypatch.setattr(disp_mod, "_launch",
                        lambda c: tuple(t.detach() for t in disp_mod.soft_argmin_fcs_ref(c)))
    t = torch.from_numpy(cost).requires_grad_()
    disp, fcs = disp_mod._SoftArgminFcs.apply(t)
    assert not fcs.requires_grad
    disp.backward(torch.from_numpy(g))
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(ref), **DISP_TOL)


@pytest.mark.parametrize("train", [False, True])
def test_aggregation_backward_matches_pallas_vjp(monkeypatch, train):
    cost, params, stats = _agg_inputs(np.random.RandomState(21), 2, 5, 3, 8)
    g = np.random.RandomState(22).randn(2, 5, 3, 8).astype(np.float32)
    jstats = tuple(map(jnp.asarray, stats))
    _, vjp = jax.vjp(lambda c, p: aggregate_cost_volume_pallas(c, p, jstats, train,
                                                               interpret=True)[0],
                     jnp.asarray(cost), _jax(params))
    g_cost, g_params = vjp(jnp.asarray(g))

    def launch(c, p, run_stats, tr, eps):
        return tuple(t.detach() for t in agg_mod.aggregate_cost_volume_ref(c, p, run_stats,
                                                                          tr, eps))

    monkeypatch.setattr(agg_mod, "_launch", launch)
    tc = torch.from_numpy(cost).requires_grad_()
    tp = {k: v.requires_grad_() for k, v in _torch(params).items()}
    out, mu, var = agg_mod._Aggregation.apply(tc, *map(torch.from_numpy, stats), train, 1e-5,
                                              *(tp[n] for n in agg_mod.PARAM_NAMES))
    assert not mu.requires_grad and not var.requires_grad
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(tc.grad.numpy(), np.asarray(g_cost), **AGG_TOL)
    for name in agg_mod.PARAM_NAMES:
        np.testing.assert_allclose(tp[name].grad.numpy(), np.asarray(g_params[name]),
                                   err_msg=name, **AGG_TOL)
