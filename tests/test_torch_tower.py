"""The refinement tower's plain version (ops/cuda/tower.py:tower_ref) against
the TPU kernel it stands for, float32 on both sides, on numpy inputs from a
seed, at the shape of tests/test_pallas_tower.py: B = 2, s2d 8x16, so 16x32
on the port's plain layout.

- forward against tower_pallas in interpret mode (train and eval);
- backward against jax.grad of the kernel's golden twin _tower_ref_raw
  (dx0, every dW and db, dgamma, dbeta) in train and in eval mode (the
  running statistics' affine map), and against tower_pallas's own custom
  VJP in interpret mode;
- tower_cuda on CPU tensors is tower_ref; on any other device it never takes
  the plain version;
- the CUDA chains' launch sequence (tower_forward_cuda, tower_backward_cuda)
  run on CPU tensors against a stand-in library that records the C calls:
  launch counts, dilations and channels per layer, the partial-sum rows and
  columns handed to each reduction, in eval mode the running statistics
  and zero batch-mean terms handed to grad_y; the autograd Function's
  eval-mode backward runs that chain; and the transposed-tap weights of
  the input gradient against autograd of F.conv2d.

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

import contextlib
import ctypes
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

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
from adaptive_stereo_tpu_torch.ops.cuda import _build
from adaptive_stereo_tpu_torch.ops.cuda import tower as tower_mod
from adaptive_stereo_tpu_torch.ops.cuda.tower import (
    DILATIONS,
    WGRAD_BLOCKS,
    tile_count,
    transposed_taps,
)

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


def _port_grads(a, g_out, train=True):
    x0, params, run_stats = _torch_args(a, requires_grad=True)
    y, _, _ = tower_cuda(x0, params, run_stats, train)
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


def test_tower_ref_eval_backward_matches_raw_twin_autodiff():
    """Eval mode: BatchNorm is the running statistics' affine map, so the
    gradient has no batch-mean terms; dgamma and dbeta are sums over the
    running-statistics xhat (the gradient the GT-free study's probe takes
    through an eval forward)."""
    a = _inputs(7)
    g_out = np.random.RandomState(8).randn(B, H, W, 1).astype(np.float32)
    rm, rv = jnp.asarray(a["rmeans"]), jnp.asarray(a["rvars"])
    want = _jax_grads(a, g_out, lambda xs, ks, bs, gam, bet: _tower_ref_raw(
        xs, ks, bs, gam, bet, rm, rv, False)[0])
    _assert_grads_close(_port_grads(a, g_out, train=False), want)
    # Not the train-mode gradient: the batch terms move every dgamma.
    train = _port_grads(a, g_out, train=True)
    assert np.abs(train[-2].numpy() - np.asarray(want[-2])).max() > 1e-2 * np.abs(
        np.asarray(want[-2])).max()


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


# ---- the kernels' launch sequence, against a stand-in library -------------

CHANNELS = [(4, 32)] + [(32, 32)] * 6 + [(32, 1)]
LAUNCH_SHAPES = [(2, 16, 48), (1, 37, 53)]  # tiles that divide evenly; a tail


class _FakeLibrary:
    """Records the C entry points' arguments, returns success."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        return lambda *args: self.calls.append((name, args)) or 0


@pytest.fixture
def fake_library(monkeypatch):
    """Run the tower wrappers' launch code on CPU tensors against
    _FakeLibrary, and record the partial-sum scratch they allocate."""
    lib = _FakeLibrary()
    partials = []
    make = tower_mod._partials

    def recording(rows, cols, device):
        partials.append(make(rows, cols, device))
        return partials[-1]

    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(_build, "require_cuda", lambda *a, **k: None)
    monkeypatch.setattr(_build, "stream_of", lambda t: 0)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(tower_mod, "_partials", recording)
    return lib, partials


def _chain_args(b, h, w, dtype):
    z = lambda *shape: torch.zeros(shape, dtype=dtype)
    kernels = [z(3, 3, ci, co) for ci, co in CHANNELS]
    biases = [torch.zeros(co) for _, co in CHANNELS]
    run_stats = (torch.zeros(7, 32), torch.ones(7, 32))
    return z(b, h, w, 4), kernels, biases, torch.ones(7, 32), torch.zeros(7, 32), run_stats


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("b,h,w", LAUNCH_SHAPES)
def test_tower_forward_launch_sequence(fake_library, b, h, w, train, dtype):
    """One conv launch a layer (dilation, channels, prologue as the tower's),
    each followed in train mode by the statistics reduction over the conv's
    per-tile rows: 15 launches, 8 in eval mode."""
    lib, partials = fake_library
    x0, kernels, biases, gammas, betas, run_stats = _chain_args(b, h, w, dtype)
    before = tower_forward_cuda.launches
    y7, mu, var, xs, ys = tower_forward_cuda(x0, kernels, biases, gammas, betas, run_stats,
                                             train)
    names = [name for name, _ in lib.calls]
    assert tower_forward_cuda.launches - before == len(names) == (15 if train else 8)
    want = []
    for p in range(8):
        want += ["stereo_tower_conv"] + (["stereo_tower_stats"] if train and p < 7 else [])
    assert names == want
    tiles = tile_count(b, h, w)
    assert tiles == b * -(-h // 8) * -(-w // 16)
    assert len(partials) == 1 and tuple(partials[0].shape) == (tiles, 64)
    convs = [args for name, args in lib.calls if name == "stereo_tower_conv"]
    for p, args in enumerate(convs):
        assert args[15:21] == (b, h, w, *CHANNELS[p], DILATIONS[p])
        assert args[21:23] == (0 if p == 0 else 1 if p == 1 else 2, 0)  # prologue, forward
        assert args[8] == (partials[0].data_ptr() if train and p < 7 else None)
        assert (args[1] is None) == (p < 2)  # the residual x_{p-1}
    for name, args in lib.calls:
        if name == "stereo_tower_stats":
            assert args[:3] == (partials[0].data_ptr(), tiles, b * h * w)
    assert y7.shape == (b, h, w, 1) and len(xs) == 7 and len(ys) == 8
    assert mu.shape == var.shape == (7, 32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,w", LAUNCH_SHAPES)
def test_tower_backward_launch_sequence(fake_library, b, h, w, dtype):
    """At most 4 launches a layer, 31 a chain: layer 7 takes its output
    gradient as gy (no grad_y launch); each layer's weight and bias
    gradients come from WGRAD_BLOCKS (or fewer) block rows, and one launch
    reduces them together with the input-gradient conv's per-tile S1/S2
    rows for the layer below (none below layer 0)."""
    lib, partials = fake_library
    x0, kernels, _, gammas, betas, _ = _chain_args(b, h, w, dtype)
    xs = [torch.zeros(b, h, w, 32, dtype=dtype) for _ in range(7)]
    ys = [torch.zeros(b, h, w, 32, dtype=dtype) for _ in range(7)]
    ys.append(torch.zeros(b, h, w, 1, dtype=dtype))
    before = tower_backward_cuda.launches
    dx0, dws, dbs, dgamma, dbeta = tower_backward_cuda(
        torch.zeros(b, h, w, 1), x0, xs, ys, kernels, gammas, betas, torch.zeros(7, 32),
        torch.ones(7, 32))
    names = [name for name, _ in lib.calls]
    layer = ["stereo_tower_wgrad", "stereo_tower_conv", "stereo_tower_sums"]
    assert names == layer + (["stereo_tower_grad_y"] + layer) * 7
    assert tower_backward_cuda.launches - before == len(names) == 31 <= 32
    tiles, blocks = tile_count(b, h, w), min(tile_count(b, h, w), WGRAD_BLOCKS)
    by_name = {n: [args for name, args in lib.calls if name == n] for n in set(names)}
    s_rows = partials[0]
    assert tuple(s_rows.shape) == (tiles, 64)
    for i, p in enumerate(range(7, -1, -1)):
        (cin, cout), d = CHANNELS[p], DILATIONS[p]
        cols = 9 * cin * cout + cout
        w_rows = partials[1 + i]
        assert tuple(w_rows.shape) == (blocks, cols)
        wg = by_name["stereo_tower_wgrad"][i]
        assert wg[2] == w_rows.data_ptr() and wg[3:11] == (blocks, b, h, w, cin, cout, d,
                                                          _build.DTYPE_CODES[dtype])
        conv = by_name["stereo_tower_conv"][i]
        assert conv[15:23] == (b, h, w, cout, cin, d, 0, 1)  # plain prologue, input grad
        assert conv[8] == (s_rows.data_ptr() if p >= 1 else None)
        assert (conv[9] is not None) == (1 <= p <= 6)  # the residual's gradient
        sums = by_name["stereo_tower_sums"][i]
        assert sums[0] == w_rows.data_ptr() and sums[1:3] == (blocks, cols)
        if p >= 1:
            assert sums[4] == s_rows.data_ptr() and sums[5:7] == (tiles, 64)
        else:
            assert sums[4] is None and sums[5:7] == (0, 0) and sums[7] is None
        assert dws[p].shape == (3, 3, cin, cout) and dws[p].dtype == dtype
        assert dbs[p].shape == (cout,)
    for args in by_name["stereo_tower_grad_y"]:
        assert args[9:11] == (b * h * w * 32, 32)
    assert len(partials) == 9
    assert dx0.shape == (b, h, w, 4) and dgamma.shape == dbeta.shape == (7, 32)


class _VectorReadingLibrary(_FakeLibrary):
    """_FakeLibrary that also reads grad_y's six f32 vectors (mu, inv, nrm,
    shift, m1, m2) at the launch, while the wrapper holds them."""

    def __init__(self):
        super().__init__()
        self.vectors = []

    def stereo_tower_grad_y(self, *args):
        self.calls.append(("stereo_tower_grad_y", args))
        self.vectors.append([np.ctypeslib.as_array((ctypes.c_float * 32).from_address(ptr)).copy()
                             for ptr in args[2:8]])
        return 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tower_eval_backward_launch_sequence(fake_library, monkeypatch, dtype):
    """train=False: the same 31 launches, and each layer's grad_y gets the
    running statistics and their BN terms, with m1 = m2 = 0 (no batch-mean
    terms): gy = nrm * gl."""
    lib = _VectorReadingLibrary()
    monkeypatch.setattr(_build, "library", lambda: lib)
    b, h, w = LAUNCH_SHAPES[1]
    x0, kernels, _, _, _, _ = _chain_args(b, h, w, dtype)
    rng = np.random.RandomState(9)
    gammas = torch.from_numpy(1 + 0.1 * rng.randn(7, 32).astype(np.float32))
    betas = torch.from_numpy(0.1 * rng.randn(7, 32).astype(np.float32))
    rmean = torch.from_numpy(0.2 * rng.rand(7, 32).astype(np.float32))
    rvar = torch.from_numpy(1 + rng.rand(7, 32).astype(np.float32))
    xs = [torch.zeros(b, h, w, 32, dtype=dtype) for _ in range(7)]
    ys = [torch.zeros(b, h, w, 32, dtype=dtype) for _ in range(7)] + [
        torch.zeros(b, h, w, 1, dtype=dtype)]
    before = tower_backward_cuda.launches
    tower_backward_cuda(torch.zeros(b, h, w, 1), x0, xs, ys, kernels, gammas, betas, rmean,
                        rvar, 1e-5, train=False)
    names = [name for name, _ in lib.calls]
    layer = ["stereo_tower_wgrad", "stereo_tower_conv", "stereo_tower_sums"]
    assert names == layer + (["stereo_tower_grad_y"] + layer) * 7
    assert tower_backward_cuda.launches - before == 31
    assert len(lib.vectors) == 7
    for p, (mu, inv, nrm, shift, m1, m2) in zip(range(6, -1, -1), lib.vectors):
        want_inv = torch.rsqrt(rvar[p] + 1e-5)
        np.testing.assert_array_equal(mu, rmean[p].numpy())
        np.testing.assert_array_equal(inv, want_inv.numpy())
        np.testing.assert_array_equal(nrm, (gammas[p] * want_inv).numpy())
        np.testing.assert_array_equal(shift, (betas[p] - rmean[p] * (gammas[p] * want_inv)).numpy())
        assert not m1.any() and not m2.any()


def test_tower_autograd_function_runs_the_eval_backward_chain(fake_library):
    """The autograd Function tower_cuda applies to CUDA tensors, driven on
    CPU tensors against the stand-in library: in eval mode its backward
    runs the 31-launch chain (it used to raise NotImplementedError), after
    an 8-launch forward."""
    lib, _ = fake_library
    b, h, w = LAUNCH_SHAPES[0]
    x0, kernels, biases, gammas, betas, run_stats = _chain_args(b, h, w, torch.float32)
    leaves = [t.requires_grad_() for t in [x0, gammas, betas, *kernels, *biases]]
    fwd, bwd = tower_forward_cuda.launches, tower_backward_cuda.launches
    y7, mu, var = tower_mod._Tower.apply(x0, run_stats[0], run_stats[1], False, 1e-5, gammas,
                                         betas, *kernels, *biases)
    assert tower_forward_cuda.launches - fwd == 8
    grads = torch.autograd.grad(y7.sum(), leaves)
    assert tower_backward_cuda.launches - bwd == 31
    assert [g.shape for g in grads] == [t.shape for t in leaves]
    assert [name for name, _ in lib.calls].count("stereo_tower_grad_y") == 7


def test_tower_backward_refuses_a_buffer_off_a_16_byte_boundary(fake_library):
    """The bf16 kernels stage x and the weights in 16-byte chunks: a saved
    buffer that starts between them is refused before anything launches."""
    lib, _ = fake_library
    b, h, w = 1, 8, 16
    x0, kernels, _, gammas, betas, _ = _chain_args(b, h, w, torch.bfloat16)
    flat = torch.zeros(1 + b * h * w * 32, dtype=torch.bfloat16)
    xs = [torch.zeros(b, h, w, 32, dtype=torch.bfloat16) for _ in range(7)]
    xs[3] = flat[1:].view(b, h, w, 32)
    ys = [torch.zeros(b, h, w, 32, dtype=torch.bfloat16) for _ in range(7)]
    ys.append(torch.zeros(b, h, w, 1, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="16-byte boundary"):
        tower_backward_cuda(torch.zeros(b, h, w, 1), x0, xs, ys, kernels, gammas, betas,
                            torch.zeros(7, 32), torch.ones(7, 32))
    assert lib.calls == []


@pytest.mark.parametrize("cin,cout,d", [(4, 32, 1), (32, 32, 8), (32, 1, 1), (32, 32, 2)])
def test_transposed_taps_give_the_input_gradient(cin, cout, d):
    """The input-gradient launch convolves gy with transposed_taps(k): taps
    reversed, channels swapped; that conv is the adjoint of the layer's."""
    rng = np.random.RandomState(cin + cout + d)
    k = rng.randn(3, 3, cin, cout).astype(np.float32)
    wt = transposed_taps(torch.from_numpy(k)).numpy()
    assert wt.shape == (3, 3, cout, cin)
    for ky in range(3):
        for kx in range(3):
            np.testing.assert_array_equal(wt[ky, kx], k[2 - ky, 2 - kx].T)
    x = torch.from_numpy(rng.randn(2, cin, 11, 19).astype(np.float32)).requires_grad_()
    gy = torch.from_numpy(rng.randn(2, cout, 11, 19).astype(np.float32))
    y = F.conv2d(x, torch.from_numpy(k).permute(3, 2, 0, 1), padding=d, dilation=d)
    (y * gy).sum().backward()
    gx = F.conv2d(gy, torch.from_numpy(wt).permute(3, 2, 0, 1), padding=d, dilation=d)
    np.testing.assert_allclose(gx.numpy(), x.grad.numpy(), atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("b,h,w,tiles", [(2, 320, 960, 4800), (1, 37, 53, 20), (2, 16, 48, 12),
                                          (1, 1, 1, 1)])
def test_tile_count_at_the_ports_shapes(b, h, w, tiles):
    assert tile_count(b, h, w) == tiles
