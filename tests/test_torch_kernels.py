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

Backward of kernels 1-4: on the card each wrapper is a
torch.autograd.Function whose backward is a kernel of its own (kernels 1
and 3) or plain PyTorch (kernels 2 and 4); on CPU tensors it takes the
plain backward. These tests drive those Functions on the CPU, with the
kernel launch replaced by the plain forward, and hold the gradients
against jax.vjp of the Pallas functions: the cost volume bitwise (sums of
the same float32 terms in the same order), soft-argmin 1e-5 absolute and
relative, aggregation and the fused coarse head the aggregation band.

The row tiles of kernels 2 and 4 (aggregation.tile_plan) are checked here
too, and what the wrappers hand the C entry points, through a stand-in for
the kernel library that records the calls.
"""

import contextlib

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
from adaptive_stereo_tpu_torch.ops.cuda import _build
from adaptive_stereo_tpu_torch.ops.cuda import aggregation as agg_mod
from adaptive_stereo_tpu_torch.ops.cuda import coarse_head as head_mod
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
# The fused coarse head's gradient, per tensor, in relative L2 (the band of
# tests/test_torch_train.py): on (2, 5, 4, 8) a layer-3 pre-activation is
# 1e-6, which float32 rounding (7e-6 here) puts on either side of the
# LeakyReLU, and in train mode the flip moves every gradient below it
# through the batch statistics, by up to 3 % of the largest entry (relative
# L2 at most 7.3e-3; in eval mode 9e-6). A wrong term moves them by O(1).
HEAD_GRAD_REL_L2 = 2e-2
# Shared memory one block of an H100 can have.
SMEM_PER_BLOCK = 232_448


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

    def counts():
        return [(w.launches, getattr(w, "backward_launches", None)) for w in wrappers]

    before = counts()
    f = torch.empty(1, 4, 8, 32, device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        difference_cost_volume_cuda(f, f, 4)
    with pytest.raises(ValueError, match="CUDA tensor"):
        cv_mod._launch_backward(torch.empty(1, 4, 4, 8, 32, device="meta"))
    cost = torch.empty(1, 12, 4, 8, device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        soft_argmin_fcs_cuda(cost)
    with pytest.raises(ValueError, match="CUDA tensor"):
        disp_mod._launch_backward(cost, torch.empty(1, 4, 8, device="meta"),
                                  torch.empty(1, 4, 8, device="meta"))
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
    assert counts() == before


# (1, 2, 3, 8, 5): D > W with C * 4 = 32 bytes, every slice from d = 3 on zero.
@pytest.mark.parametrize("b,h,w,c,d", [(1, 4, 12, 8, 5), (2, 3, 6, 4, 8), (1, 2, 3, 8, 5)])
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
    before = difference_cost_volume_cuda.backward_launches
    out = cv_mod._CostVolume.apply(tl, tr, d)
    out.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(tl.grad.numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(tr.grad.numpy(), np.asarray(ref[1]))
    # CPU tensors take the plain backward: no kernel launch is counted.
    assert difference_cost_volume_cuda.backward_launches == before


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


@pytest.mark.parametrize("train", [False, True])
def test_coarse_head_backward_matches_pallas_vjp(monkeypatch, train):
    """Kernel 4's gradient through the disparity, as JAX's custom VJP gives
    it; FCS, mu and var carry none, nor do the running statistics."""
    b, d, h, w = 2, 5, 4, 8
    rng = np.random.RandomState(31)
    _, params, stats = _agg_inputs(rng, 1, 1, 1, 1)
    fl, fr = (rng.randn(b, h, w, 32).astype(np.float32) for _ in range(2))
    g = rng.randn(b, h, w).astype(np.float32)
    jstats = tuple(map(jnp.asarray, stats))
    _, vjp = jax.vjp(lambda x, y, p: coarse_head_pallas(x, y, p, jstats, d, train,
                                                        interpret=True)[0],
                     jnp.asarray(fl), jnp.asarray(fr), _jax(params))
    g_fl, g_fr, g_params = vjp(jnp.asarray(g))

    def launch(f_l, f_r, p, run_stats, tr, num_disp, eps):
        return tuple(t.detach() for t in head_mod.coarse_head_ref(f_l, f_r, p, run_stats, tr,
                                                                  num_disp, eps))

    monkeypatch.setattr(head_mod, "_launch", launch)
    tl, tr_ = (torch.from_numpy(x).requires_grad_() for x in (fl, fr))
    tp = {k: v.requires_grad_() for k, v in _torch(params).items()}
    rmean, rvar = (torch.from_numpy(v).requires_grad_() for v in stats)
    disp, fcs, mu, var = head_mod._CoarseHead.apply(tl, tr_, rmean, rvar, train, d, 1e-5,
                                                    *(tp[n] for n in agg_mod.PARAM_NAMES))
    assert not (fcs.requires_grad or mu.requires_grad or var.requires_grad)
    disp.backward(torch.from_numpy(g))
    assert rmean.grad is None and rvar.grad is None
    got = {"f_l": tl.grad, "f_r": tr_.grad, **{n: tp[n].grad for n in agg_mod.PARAM_NAMES}}
    want = {"f_l": g_fl, "f_r": g_fr, **g_params}
    gmax = max(np.abs(np.asarray(v)).max() for v in want.values())
    # Exactly 0: soft-argmin ignores a shift of the whole cost (final_bias),
    # and a train-mode BatchNorm removes the conv bias before it.
    zero = {"final_bias"} | ({"biases"} if train else set())
    for name, a in got.items():
        a, r = a.numpy(), np.asarray(want[name])
        if name in zero:
            assert max(np.abs(a).max(), np.abs(r).max()) <= 1e-5 * gmax, name
            continue
        assert np.linalg.norm(a - r) <= HEAD_GRAD_REL_L2 * np.linalg.norm(r), name


def _tiles(plan, w):
    """(w0, wn) of the row tiles of one (b, d, h) row, as csrc/conv3d.cuh
    cuts it (row_tile)."""
    return [(j * plan.wc, min(plan.wc, w - j * plan.wc)) for j in range(plan.tiles_per_row)]


def _check_plan(b, d, h, w):
    for dtype in (torch.bfloat16, torch.float32):
        plan = agg_mod.tile_plan(b, d, h, w, dtype)
        assert 1 <= plan.wc <= agg_mod.TILE_MAX_W, (w, plan)
        covered = [x for w0, wn in _tiles(plan, w) for x in range(w0, w0 + wn)]
        assert covered == list(range(w)), (w, plan)  # every w once, no empty tile
        assert plan.nparts == b * d * h * plan.tiles_per_row
        assert 0 <= plan.smem <= SMEM_PER_BLOCK
        if dtype == torch.bfloat16:  # halo + weights, two blocks on an SM
            mt = -(-plan.wc // 16) * 16
            assert plan.smem == 9 * (mt + 2) * 64 + 27 * 32 * 32 * 2 <= 113 * 1024
        else:
            assert plan.smem == 0


def test_tile_plan_covers_every_width():
    for w in range(1, 1025):
        _check_plan(1, 1, 1, w)
    assert agg_mod.tile_plan(1, 12, 20, 76).wc == 76
    assert agg_mod.tile_plan(1, 12, 3, 300)[:2] == (75, 4)


@pytest.mark.parametrize("b,d,h,w,tiles", [
    (1, 12, 20, 76, 240),    # serving, k=4 (320x1216)
    (2, 12, 20, 60, 480),    # the adapt step, k=4 (320x960, batch 2)
    (1, 24, 40, 152, 1920),  # serving, k=3: W = 152 in two tiles of 76
    (1, 12, 8, 16, 96), (2, 5, 6, 12, 60), (2, 6, 4, 8, 48), (2, 5, 3, 8, 30),  # tests
    (2, 3, 5, 7, 30), (1, 12, 3, 300, 144),  # the chip check's tail and split shapes
])
def test_tile_plan_at_the_ports_shapes(b, d, h, w, tiles):
    _check_plan(b, d, h, w)
    assert agg_mod.tile_plan(b, d, h, w).nparts == tiles


class _FakeLibrary:
    """Records the C entry points' arguments, returns success."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        return lambda *args: self.calls.append((name, args)) or 0


@pytest.fixture
def fake_library(monkeypatch):
    """Run a wrapper's launch code on CPU tensors against _FakeLibrary, and
    record the partial-sum scratch each launch allocates."""
    lib = _FakeLibrary()
    partials = []
    make = agg_mod._partials

    def recording(plan, device):
        partials.append(make(plan, device))
        return partials[-1]

    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(_build, "require_cuda", lambda *a, **k: None)
    monkeypatch.setattr(_build, "stream_of", lambda t: 0)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(agg_mod, "_partials", recording)
    monkeypatch.setattr(head_mod, "_partials", recording)
    return lib, partials


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("b,d,h,w", [(2, 3, 5, 7), (1, 12, 3, 300)])
def test_aggregation_hands_the_kernel_its_tile_plan(fake_library, b, d, h, w, train, dtype):
    lib, partials = fake_library
    cost, params, stats = _agg_inputs(np.random.RandomState(5), b, d, h, w)
    plan = agg_mod.tile_plan(b, d, h, w, dtype)
    before = aggregate_cost_volume_cuda.launches
    agg_mod._launch(torch.from_numpy(cost).to(dtype), _torch(params),
                    tuple(map(torch.from_numpy, stats)), train, 1e-5)
    names = [name for name, _ in lib.calls]
    assert aggregate_cost_volume_cuda.launches - before == len(names) == (13 if train else 5)
    for name, args in lib.calls:
        if name == "stereo_conv3d_bn_leaky_forward":
            assert args[8:12] == (b, d, h, w) and args[14:16] == (plan.wc, plan.smem)
        elif name == "stereo_conv3d_stats_forward":
            assert args[5:10] == (plan.nparts, b, d, h, w)
            assert args[10:12] == (plan.wc, plan.smem)
            assert args[4] == partials[0].data_ptr()
        elif name == "stereo_bn_stats_finalize":
            assert args[1:4] == (plan.nparts, 32, b * d * h * w)
    assert len(partials) == int(train)
    if train:
        assert tuple(partials[0].shape) == (plan.nparts, 2, 32)
        assert plan.nparts == b * d * h * len(_tiles(plan, w))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,d,h,w", [(1, 12, 20, 76), (2, 3, 5, 7), (1, 12, 3, 300)])
def test_coarse_head_hands_the_kernel_its_tile_plan(fake_library, b, d, h, w, dtype):
    lib, partials = fake_library
    _, params, stats = _agg_inputs(np.random.RandomState(6), 1, 1, 1, 1)
    f = torch.zeros(b, h, w, 32, dtype=dtype)
    plan = agg_mod.tile_plan(b, d, h, w, dtype)
    head_mod._launch(f, f, _torch(params), tuple(map(torch.from_numpy, stats)), True, d, 1e-5)
    (name, args), = lib.calls
    assert name == "stereo_coarse_head_forward"
    assert args[17] == partials[0].data_ptr() and args[18] == plan.nparts
    assert args[19:27] == (b, h, w, 32, d, plan.wc, plan.smem, 1)
    assert tuple(partials[0].shape) == (plan.nparts, 2, 32)
    assert plan.nparts == b * d * h * len(_tiles(plan, w))


def test_aggregation_refuses_a_cost_off_a_16_byte_boundary(fake_library):
    """The kernel stages the cost in 16-byte chunks: a view that starts
    between them is refused before anything launches."""
    lib, _ = fake_library
    cost, params, stats = _agg_inputs(np.random.RandomState(7), 1, 3, 2, 4)
    flat = torch.from_numpy(np.concatenate([[0.0], cost.ravel()]).astype(np.float32))
    shifted = flat[1:].view(cost.shape)
    assert shifted.data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte boundary"):
        agg_mod._launch(shifted, _torch(params), tuple(map(torch.from_numpy, stats)), False,
                        1e-5)
    assert lib.calls == []


def _offset_view(t):
    """t's values in a view whose data starts one element past the
    allocation, so off a 16-byte boundary."""
    flat = torch.cat([t.flatten()[:1], t.flatten()])
    view = flat[1:].view(t.shape)
    assert view.data_ptr() % 16
    return view


# (dtype, C, offset view, 16-byte path): C * itemsize a multiple of 16 and
# aligned data take the 16-byte path; C = 4 in bf16 (8 bytes), C = 3 in f32
# and a view off a 16-byte boundary take the scalar path.
CV_PATHS = [(torch.float32, 4, False, True), (torch.bfloat16, 4, False, False),
            (torch.bfloat16, 32, False, True), (torch.bfloat16, 32, True, False),
            (torch.float32, 3, False, False), (torch.float32, 8, True, False)]


def _takes_16_byte_path(args, itemsize):
    """The path the cost-volume entry points take for these arguments
    (csrc/cost_volume.cu, vec_ok): C * itemsize a multiple of 16 and the
    three pointers on 16-byte boundaries."""
    return args[6] * itemsize % 16 == 0 and all(p % 16 == 0 for p in args[:3])


@pytest.mark.parametrize("dtype,c,offset,vec", CV_PATHS)
def test_cost_volume_forward_hands_the_kernel_its_path(fake_library, dtype, c, offset, vec):
    lib, _ = fake_library
    b, h, w, d = 2, 3, 7, 9
    fl, fr = torch.zeros(b, h, w, c, dtype=dtype), torch.ones(b, h, w, c, dtype=dtype)
    if offset:
        fl = _offset_view(fl)
    before = difference_cost_volume_cuda.launches
    out = cv_mod._launch(fl, fr, d)
    (name, args), = lib.calls
    assert name == "stereo_cost_volume_forward"
    assert args[:3] == (fl.data_ptr(), fr.data_ptr(), out.data_ptr())
    assert args[3:9] == (b, h, w, c, d, _build.DTYPE_CODES[dtype])
    assert _takes_16_byte_path(args, dtype.itemsize) == vec
    assert out.shape == (b, d, h, w, c) and out.dtype == dtype
    assert difference_cost_volume_cuda.launches - before == 1


@pytest.mark.parametrize("dtype,c,offset,vec", CV_PATHS)
def test_cost_volume_backward_hands_the_kernel_its_path(fake_library, dtype, c, offset, vec):
    lib, _ = fake_library
    b, h, w, d = 2, 3, 7, 9
    g = torch.zeros(b, d, h, w, c, dtype=dtype)
    if offset:
        g = _offset_view(g)
    before = (difference_cost_volume_cuda.launches, difference_cost_volume_cuda.backward_launches)
    d_fl, d_fr = cv_mod._launch_backward(g)
    (name, args), = lib.calls
    assert name == "stereo_cost_volume_backward"
    assert args[:3] == (g.data_ptr(), d_fl.data_ptr(), d_fr.data_ptr())
    assert args[3:9] == (b, h, w, c, d, _build.DTYPE_CODES[dtype])
    assert _takes_16_byte_path(args, dtype.itemsize) == vec
    for t in (d_fl, d_fr):
        assert t.shape == (b, h, w, c) and t.dtype == dtype
    assert (difference_cost_volume_cuda.launches,
            difference_cost_volume_cuda.backward_launches - 1) == before


@pytest.mark.parametrize("b,d,h,w", [(1, 12, 20, 76), (2, 12, 20, 60), (2, 40, 5, 7)])
def test_soft_argmin_hands_the_kernels_their_arguments(fake_library, b, d, h, w):
    """The forward and the backward each make one call with the pointers
    and (B, D, H * W); the forward counts in launches, the backward in
    backward_launches."""
    lib, _ = fake_library
    cost = torch.zeros(b, d, h, w)
    before = (soft_argmin_fcs_cuda.launches, soft_argmin_fcs_cuda.backward_launches)
    disp, fcs = disp_mod._launch(cost)
    g = torch.ones(b, h, w)
    g_cost = disp_mod._launch_backward(cost, disp, g)
    (fwd, fargs), (bwd, bargs) = lib.calls
    assert fwd == "stereo_soft_argmin_fcs_forward" and bwd == "stereo_soft_argmin_backward"
    assert fargs[:6] == (cost.data_ptr(), disp.data_ptr(), fcs.data_ptr(), b, d, h * w)
    assert bargs[:7] == (cost.data_ptr(), disp.data_ptr(), g.data_ptr(), g_cost.data_ptr(), b, d,
                         h * w)
    assert disp.shape == fcs.shape == (b, h, w) and g_cost.shape == (b, d, h, w)
    assert g_cost.dtype == disp.dtype == torch.float32
    assert (soft_argmin_fcs_cuda.launches - 1, soft_argmin_fcs_cuda.backward_launches - 1) == before

