"""The fleet and data-parallel layer of the port (adaptive_stereo_tpu_torch/
parallel/) against the JAX package's (adaptive_stereo_tpu/parallel/), float32
on both sides, at the shapes of tests/test_parallel.py: k=3, input_scale 1,
32x64, N=4 streams. JAX runs on conftest's 8-device virtual CPU mesh, the
port in this process on a one-rank gloo group (make_mesh(device="cpu")).
The JAX weights come from flax init with every BatchNorm statistic redrawn
from a numpy seed (tests/test_torch_train.py _randomize_bn) and are carried
over by state_dicts_from_jax; the frames are numpy arrays from seeds.

Bands, those of tests/test_torch_stream_adapt.py's chains (defined in
tests/test_torch_train.py), none wider:
- decisions (novel, did_add, do_update) and summaries equal, each novelty
  decision's margin to its threshold wider than 2e-3 relative;
- per-stream values (losses, FCS, EPE, the EMA) of a step before any update
  was applied 1e-5 absolute and relative, later ones 1e-4 + 2e-3 relative;
- parameters within 2 lr per applied update (each update also rounds a
  parameter once: plus one float32 spacing of it per update), median
  difference below 0.1 lr; running statistics 2 lr per applied update
  absolute + 1e-3 relative;
- gradients per tensor within 2e-2 in relative L2 norm (tensors whose
  exact gradient is 0, _structurally_zero, within 1e-5 of the largest on
  both sides); the Adam moments within 2e-2 (first) and 4e-2 (second)
  (tests/test_torch_train_loop.py), per module (feature net, aggregation,
  refinement) as that file holds gradients against its float64 run: a
  single tensor can sit at a kink of the loss, a LeakyReLU whose
  pre-activation lies within float32 rounding of 0 and takes its branch
  by rounding, each framework its own way (the test prints the largest
  per-tensor difference beside each module's).
Port against port: the fleet's per-stream step against the single-stream
step, remat against no remat and the data-parallel step at one rank
against the train step are bitwise equal; the fused step against the
weighted mean of per-stream gradients within JAX's own band
(tests/test_parallel.py: 2e-4 relative + 2e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaptive_stereo_tpu.engine.state import create_train_state as jax_train_state
from adaptive_stereo_tpu.engine.steps import make_adapt_forward_backward as jax_fwd_bwd
from adaptive_stereo_tpu.models import StereoModel as JaxStereoModel
from adaptive_stereo_tpu.parallel import FleetDriver as JaxFleetDriver
from adaptive_stereo_tpu.parallel import FleetStream as JaxFleetStream
from adaptive_stereo_tpu.parallel import fleet_adapt as jax_fleet_adapt
from adaptive_stereo_tpu.parallel import init_fleet_fcs_ema as jax_ema
from adaptive_stereo_tpu.parallel import make_fleet_apply_updates as jax_apply
from adaptive_stereo_tpu.parallel import make_fleet_fwd_bwd as jax_fleet_fwd_bwd
from adaptive_stereo_tpu.parallel import make_fused_fleet_step as jax_fused
from adaptive_stereo_tpu.parallel import make_mesh as jax_mesh
from adaptive_stereo_tpu.parallel import make_parallel_train_step as jax_parallel_train
from adaptive_stereo_tpu_torch.engine import (create_train_state,
                                              make_adapt_forward_backward, make_train_step)
from adaptive_stereo_tpu_torch.models import StereoModel, state_dicts_from_jax
from adaptive_stereo_tpu_torch.parallel import (FleetDriver, FleetStream, data_sharding,
                                                fleet_adapt, init_fleet_fcs_ema,
                                                local_data_slice, make_fleet_apply_updates,
                                                make_fleet_fwd_bwd, make_fused_fleet_step,
                                                make_mesh, make_parallel_train_step)
from test_torch_train import (AFTER_UPDATE_TOL, GRAD_REL_L2, LOG_TOL, MEDIAN_PARAM_LR,
                              STATS_TOL, _randomize_bn, _structurally_zero)

K, S, H, W, N = 3, 1, 32, 64, 4
LR = 5e-5
OPTIONS = dict(use_er=True, use_vs=True, clip_grad_norm=True)
# A novelty threshold between the streams' smoothed FCS values (about 1.06
# and 1.23 on these frames), so that novel differs across streams.
THRESHOLD = 1.1
# Three gated steps: would_add and in_progress per stream.
WOULD_ADD = [[True, False, True, False], [False, True, True, False], [True, True, False, False]]
IN_PROGRESS = [[True, True, False, True], [True, False, True, True], [True, True, True, False]]
CHAIN_SEEDS = [(11, 12), (13, 14), (15, 16)]
DECISIONS = ("novel", "did_add", "do_update")
MODULES = {"feature": "feature_net.", "aggregation": ("stereo_net.filter.",
                                                      "stereo_net.conv3d_alone."),
           "refinement": "stereo_net.edge_aware_refinements."}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads (see tests/test_torch_driver.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def frames(seed, n=N):
    """A stacked batch of n streams: numpy color_l, color_r, gt_disp_l."""
    r = np.random.RandomState(seed)
    return {f"color_l/{S}": r.rand(n, H, W, 3).astype(np.float32),
            f"color_r/{S}": r.rand(n, H, W, 3).astype(np.float32),
            f"gt_disp_l/{S}": (r.rand(n, H, W, 1) * 8).astype(np.float32)}


def jax_variables(seed=0):
    rng = np.random.RandomState(seed)
    x = jnp.asarray(rng.rand(1, H, W, 3).astype(np.float32))
    v = JaxStereoModel(k=K, input_scale=S).init(jax.random.PRNGKey(seed), x, x, train=False)
    return _randomize_bn(jax.tree.map(np.asarray, dict(v)), rng)


@pytest.fixture(scope="module")
def variables():
    return jax_variables()


def jax_setup(variables):
    model = JaxStereoModel(k=K, input_scale=S)
    x = jnp.zeros((1, H, W, 3))
    return model, jax_train_state(model, jax.random.PRNGKey(0), x, x, LR, variables)


def port_setup(variables):
    model = StereoModel(k=K, input_scale=S, device="cpu")
    return model, create_train_state(model, learning_rate=LR, variables=variables)


def jnp_batch(b):
    return {key: jnp.asarray(v) for key, v in b.items()}


def torch_batch(b):
    return {key: torch.from_numpy(v) for key, v in b.items()}


def named(params, batch_stats):
    """Port-named numpy tensors of a JAX-layout tree."""
    fsd, ssd = state_dicts_from_jax(jax.tree.map(np.asarray, {"params": params,
                                                              "batch_stats": batch_stats}), K)
    return {**{f"feature_net.{k}": v.numpy() for k, v in fsd.items()},
            **{f"stereo_net.{k}": v.numpy() for k, v in ssd.items()}}


def live_names(model):
    return [n for n, _ in model.named_parameters() if ".conv2." not in n]


def buffer_names(model):
    return [n for n, _ in model.named_buffers()
            if n.endswith(("running_mean", "running_var")) and ".conv2." not in n]


def assert_tensors_close(got, want, band, label):
    """Per tensor relative L2 within band; structurally zero tensors within
    1e-5 of the largest on both sides."""
    top = max(np.abs(w).max() for w in want.values())
    worst = 0.0
    for n, w in want.items():
        g = got[n]
        if _structurally_zero(n):
            assert np.abs(g).max() <= 1e-5 * top and np.abs(w).max() <= 1e-5 * top, (label, n)
            continue
        rel = np.linalg.norm(g - w) / np.linalg.norm(w)
        worst = max(worst, rel)
        assert rel <= band, (label, n, rel)
    print(f"{label}: largest relative L2 difference {worst:.3g} (band {band})")


def assert_weights_match(model, state, jstate, before, updates, step_by_step=True):
    """Parameters and the Adam count against JAX's; with step_by_step the
    running statistics and the Adam moments too."""
    want = named(jstate.params, jstate.batch_stats)
    got = {n: t.detach().numpy() for n, t in model.state_dict().items()}
    names = live_names(model)
    diffs = np.concatenate([np.abs(got[n] - want[n]).ravel() for n in names])
    # Each update rounds a parameter once: one float32 spacing of it each.
    spacing = np.concatenate([updates * np.spacing(np.abs(want[n])).ravel() for n in names])
    moved = max(np.abs(want[n] - before[n]).max() for n in names)
    print(f"parameters moved up to {moved:.3g}; port vs JAX max {diffs.max():.3g}, median "
          f"{np.median(diffs):.3g} after {updates} updates")
    assert moved > 0.5 * LR
    assert (diffs <= 2 * LR * updates + spacing).all()
    assert np.median(diffs) <= MEDIAN_PARAM_LR * LR
    adam = jstate.opt_state.inner_state[0]
    assert int(state.count) == int(adam.count) == int(jstate.opt_state.count)
    if not step_by_step:
        return
    for n in buffer_names(model):
        np.testing.assert_allclose(got[n], want[n], atol=2 * LR * updates, rtol=1e-3, err_msg=n)
    for moment, mine, band in (("mu", state.m, GRAD_REL_L2), ("nu", state.v, 2 * GRAD_REL_L2)):
        want_m = named(getattr(adam, moment), jstate.batch_stats)
        for module, prefix in MODULES.items():
            idx = [i for i, n in enumerate(names) if n.startswith(prefix)
                   and not _structurally_zero(n)]
            cat = lambda ts: np.concatenate([np.ravel(ts[i]) for i in idx])
            a, b = cat([t.numpy() for t in mine]), cat([want_m[n] for n in names])
            rel = np.linalg.norm(a - b) / np.linalg.norm(b)
            worst = max((np.linalg.norm(mine[i].numpy() - want_m[names[i]])
                         / np.linalg.norm(want_m[names[i]]), names[i]) for i in idx)
            print(f"Adam {moment}, {module}: relative L2 difference {rel:.3g} (band {band}); "
                  f"largest per tensor {worst[0]:.3g} ({worst[1]})")
            assert rel <= band, (moment, module, rel)


def port_from_jax(jstate):
    """The port's model and train state holding a JAX train state's
    parameters, statistics, Adam moments, count and step."""
    model, state = port_setup(jax.tree.map(np.asarray, {"params": jstate.params,
                                                        "batch_stats": jstate.batch_stats}))
    adam = jstate.opt_state.inner_state[0]
    names = live_names(model)
    for moment, dst in (("mu", state.m), ("nu", state.v)):
        want = named(getattr(adam, moment), jstate.batch_stats)
        for n, t in zip(names, dst):
            t.copy_(torch.from_numpy(want[n]))
    state.count.fill_(int(adam.count))
    state.step.fill_(int(jstate.step))
    return model, state


def assert_aux_matches(aux, jaux, tol, label):
    for key in DECISIONS:
        np.testing.assert_array_equal(aux[key].numpy(), np.asarray(jaux[key]),
                                      err_msg=f"{label} {key}")
    assert set(aux) == set(jaux), label
    for key in aux:
        if key not in DECISIONS:
            np.testing.assert_allclose(aux[key].numpy(), np.asarray(jaux[key]),
                                       err_msg=f"{label} {key}", **tol)


def novelty_margins(aux):
    """Relative margins of the smoothed FCS to the threshold."""
    return np.abs(np.asarray(aux["fcs_smoothed"]) - THRESHOLD) / THRESHOLD


# --- make_fleet_fwd_bwd -----------------------------------------------------

@pytest.fixture(scope="module")
def fwd_bwd_batches():
    return frames(1), frames(2)


@pytest.fixture(scope="module")
def jax_fwd_bwd_result(variables, fwd_bwd_batches):
    """JAX's per-stream gradients and statistics (numpy trees with a
    leading stream axis) and aux."""
    model, js = jax_setup(variables)
    fleet = jax_fleet_fwd_bwd(jax_fwd_bwd(model, S, K, use_er=True), jax_mesh(N))
    b, e = fwd_bwd_batches
    out = fleet(js.params, js.batch_stats, jnp_batch(b), jnp_batch(e))
    return tuple(jax.tree.map(np.asarray, x) for x in out)


def stream_named(grads_n, stats_n, i):
    """Stream i's gradients and statistics of JAX's trees, port-named."""
    at = lambda tree: jax.tree.map(lambda x: x[i], tree)
    return named(at(grads_n), at(stats_n))


def test_fleet_fwd_bwd_matches_jax_and_the_single_stream_step(variables, fwd_bwd_batches,
                                                                jax_fwd_bwd_result):
    b, e = (torch_batch(x) for x in fwd_bwd_batches)
    model, state = port_setup(variables)
    single = make_adapt_forward_backward(model, S, K, use_er=True)
    fleet = make_fleet_fwd_bwd(single)
    grads_n, stats_n, aux_n = fleet(state, b, e)
    names = live_names(model)
    assert aux_n["fcs_raw"].shape == (N,) and len(grads_n) == len(names)
    j_grads, j_stats, j_aux = jax_fwd_bwd_result
    for key, value in j_aux.items():
        np.testing.assert_allclose(aux_n[key].numpy(), value, err_msg=key, **LOG_TOL)
    shared = [b_.clone() for b_ in state.buffers]
    for i in range(N):
        want = stream_named(j_grads, j_stats, i)
        assert_tensors_close({n: g[i].numpy() for n, g in zip(names, grads_n)},
                             {n: want[n] for n in names}, GRAD_REL_L2, f"stream {i} gradients")
        for n, x in zip(buffer_names(model), stats_n):
            np.testing.assert_allclose(x[i].numpy(), want[n], err_msg=n, **STATS_TOL)
        # The port's single-stream step on stream i alone, from the shared
        # statistics: the same bits.
        model_i, state_i = port_setup(variables)
        g_i, aux_i = make_adapt_forward_backward(model_i, S, K, use_er=True)(
            state_i, {k: v[i:i + 1] for k, v in b.items()}, {k: v[i:i + 1] for k, v in e.items()})
        assert all(torch.equal(g, gs[i]) for g, gs in zip(g_i, grads_n))
        assert all(torch.equal(x, xs[i]) for x, xs in zip(state_i.buffers, stats_n))
        assert all(torch.equal(aux_i[key], aux_n[key][i]) for key in aux_i)
    # The state's statistics are left as they were.
    assert all(torch.equal(x, y) for x, y in zip(state.buffers, shared))


# --- make_fused_fleet_step: the gated chain ---------------------------------

def jax_chain(variables, bn_mode, mesh):
    """JAX's chain: the train state and EMA before each step and after the
    last, and each step's aux."""
    model, js = jax_setup(variables)
    step = jax_fused(model, mesh, S, K, ood_threshold=THRESHOLD, bn_mode=bn_mode, **OPTIONS)
    states, emas, auxes = [js], [jax_ema(N)], []
    for (sb, se), would, prog in zip(CHAIN_SEEDS, WOULD_ADD, IN_PROGRESS):
        js, ema, aux = step(states[-1], emas[-1], jnp_batch(frames(sb)),
                            jnp_batch(frames(se)), jnp.asarray(would), jnp.asarray(prog))
        states.append(js)
        emas.append(ema)
        auxes.append({key: np.asarray(v) for key, v in aux.items()})
    return states, [tuple(np.asarray(x) for x in e) for e in emas], auxes


def port_step(model, bn_mode, remat=False):
    return make_fused_fleet_step(model, make_mesh(device="cpu"), S, K, ood_threshold=THRESHOLD,
                                 bn_mode=bn_mode, remat=remat, **OPTIONS)


def run_chain_step(step, state, ema, i):
    (sb, se), would, prog = CHAIN_SEEDS[i], WOULD_ADD[i], IN_PROGRESS[i]
    return step(state, ema, torch_batch(frames(sb)), torch_batch(frames(se)), would, prog)


def port_chain(variables, bn_mode, remat=False):
    model, state = port_setup(variables)
    step = port_step(model, bn_mode, remat)
    ema = init_fleet_fcs_ema(N, "cpu")
    auxes = []
    for i in range(len(CHAIN_SEEDS)):
        state, ema, aux = run_chain_step(step, state, ema, i)
        auxes.append(aux)
    return model, state, ema, auxes


@pytest.fixture(scope="module")
def jax_chains(variables):
    """JAX's chains: per_stream on four devices (one stream each), shared on
    one device (its statistics span the same four streams as the port's)."""
    return {"per_stream": jax_chain(variables, "per_stream", jax_mesh(N)),
            "shared": jax_chain(variables, "shared", jax_mesh(1))}


@pytest.mark.parametrize("bn_mode", ["per_stream", "shared"])
def test_fused_fleet_step_chain_matches_jax(variables, jax_chains, bn_mode):
    """The three-step chain run freely on each side: every aux row, the
    EMA, the parameters and the Adam count in the chain's bands. The running
    statistics and the Adam moments are held step by step, from a common
    state, in the test below: along a free chain the two sides' parameters
    come to differ by up to 2 lr (entries whose gradient is rounding noise
    step by +-lr), which moves every later gradient, and moves the
    refinement's first BatchNorm mean, whose conv reads the upsampled
    disparity (tens of pixels), by more than a band of 2 lr per update."""
    states, j_emas, j_auxes = jax_chains[bn_mode]
    model, state, ema, auxes = port_chain(variables, bn_mode)
    updates = 0
    for i, (aux, jaux) in enumerate(zip(auxes, j_auxes)):
        print(f"step {i}: novel {aux['novel'].tolist()}, do_update {aux['do_update'].tolist()}, "
              f"smoothed FCS {aux['fcs_smoothed'].tolist()}")
        assert_aux_matches(aux, jaux, LOG_TOL if updates == 0 else AFTER_UPDATE_TOL,
                           f"step {i}")
        assert novelty_margins(jaux).min() > AFTER_UPDATE_TOL["rtol"]
        updates += int(np.asarray(jaux["do_update"]).any())
    # The gate differs across streams; every step applies an update.
    novel = np.array([a["novel"].numpy() for a in auxes])
    assert novel.any() and not novel.all()
    assert updates == len(CHAIN_SEEDS)
    np.testing.assert_allclose(ema[0].numpy(), j_emas[-1][0], **AFTER_UPDATE_TOL)
    np.testing.assert_array_equal(ema[1].numpy(), j_emas[-1][1])
    assert int(state.step) == int(states[-1].step) == len(CHAIN_SEEDS)
    assert_weights_match(model, state, states[-1], named(variables["params"],
                                                         variables["batch_stats"]), updates,
                         step_by_step=False)


@pytest.mark.parametrize("bn_mode", ["per_stream", "shared"])
def test_fused_fleet_step_from_each_jax_state_matches_jax(variables, jax_chains, bn_mode):
    """Each step of the chain from JAX's state before it (parameters,
    statistics, Adam moments and count, the EMA): the aux row in the band of
    a step before any update, the parameters, statistics and Adam moments
    after it in the bands of one update."""
    states, j_emas, j_auxes = jax_chains[bn_mode]
    for i in range(len(CHAIN_SEEDS)):
        model, state = port_from_jax(states[i])
        ema = tuple(torch.from_numpy(x.copy()) for x in j_emas[i])
        state, ema, aux = run_chain_step(port_step(model, bn_mode), state, ema, i)
        assert_aux_matches(aux, j_auxes[i], LOG_TOL, f"step {i}")
        np.testing.assert_allclose(ema[0].numpy(), j_emas[i + 1][0], **LOG_TOL)
        assert int(state.step) == int(states[i + 1].step)
        assert_weights_match(model, state, states[i + 1],
                             named(states[i].params, states[i].batch_stats), 1)


@pytest.mark.parametrize("bn_mode", ["per_stream", "shared"])
def test_remat_changes_no_result(variables, bn_mode):
    """remat=True recomputes the forwards in the backward; the step restores
    the running statistics its forwards left, so every result, the
    statistics included, is the same bits."""
    _, st_a, ema_a, aux_a = port_chain(variables, bn_mode)
    _, st_b, ema_b, aux_b = port_chain(variables, bn_mode, remat=True)
    for group in ("params", "buffers", "m", "v"):
        assert all(torch.equal(x, y) for x, y in zip(getattr(st_a, group),
                                                     getattr(st_b, group))), group
    assert torch.equal(st_a.count, st_b.count) and torch.equal(ema_a[0], ema_b[0])
    for a, b in zip(aux_a, aux_b):
        assert all(torch.equal(a[key], b[key]) for key in a)


def test_per_stream_forwards_start_from_the_shared_statistics(variables):
    """Per-stream mode: every stream's forward starts from the same shared
    running statistics (not from the stream before it), and the new shared
    statistics are the in_progress-weighted mean of the streams' updated
    ones."""
    b, e = torch_batch(frames(3)), torch_batch(frames(4))
    prog = [True, False, True, True]
    model, state = port_setup(variables)
    _, stats_n, _ = make_fleet_fwd_bwd(make_adapt_forward_backward(model, S, K, use_er=True))(
        state, b, e)
    for i in range(N):
        model_i, state_i = port_setup(variables)
        make_adapt_forward_backward(model_i, S, K, use_er=True)(
            state_i, {k: v[i:i + 1] for k, v in b.items()}, {k: v[i:i + 1] for k, v in e.items()})
        assert all(torch.equal(x, xs[i]) for x, xs in zip(state_i.buffers, stats_n)), i
    step = make_fused_fleet_step(model, make_mesh(device="cpu"), S, K, ood_threshold=THRESHOLD,
                                 **OPTIONS)
    step(state, init_fleet_fcs_ema(N, "cpu"), b, e, [False] * N, prog)
    wa = torch.tensor(prog, dtype=torch.float32)
    for got, s_n in zip(state.buffers, stats_n):
        want = torch.tensordot(wa, s_n, dims=([0], [0])) / wa.sum()
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-7)


# --- invariants of tests/test_parallel.py:75,97 ------------------------------

@pytest.mark.parametrize("bn_mode", ["per_stream", "shared"])
def test_masked_streams_leave_the_state_unchanged(variables, bn_mode):
    """Every stream DONE, or every stream's frame diverted to its OVS: the
    parameters, Adam moments and count keep their bits (with every stream
    DONE the statistics too); a mixed mask moves the parameters."""
    b, e = torch_batch(frames(5)), torch_batch(frames(6))

    def run(would, prog):
        model, state = port_setup(variables)
        before = [[t.clone() for t in getattr(state, g)] for g in ("params", "m", "v", "buffers")]
        step = make_fused_fleet_step(model, make_mesh(device="cpu"), S, K, ood_threshold=1e9,
                                     bn_mode=bn_mode, **OPTIONS)
        _, _, aux = step(state, init_fleet_fcs_ema(N, "cpu"), b, e, would, prog)
        same = [all(torch.equal(x, y) for x, y in zip(old, getattr(state, g)))
                for old, g in zip(before, ("params", "m", "v", "buffers"))]
        return same, int(state.count), int(aux["do_update"].sum())

    assert run([False] * N, [False] * N) == ([True] * 4, 0, 0)          # all DONE
    same, count, updates = run([True] * N, [True] * N)                   # all diverted
    assert same[:3] == [True] * 3 and not same[3] and count == updates == 0
    same, count, updates = run([True, False, True, False], [True] * N)   # mixed
    assert not any(same[:3]) and count == 1 and updates == 2


def test_fused_step_is_the_weighted_mean_of_per_stream_gradients(variables):
    """The fused step (one backward per stream into the bucket) equals
    make_fleet_fwd_bwd's per-stream gradients combined by
    make_fleet_apply_updates with the same do_update."""
    b, e = torch_batch(frames(7)), torch_batch(frames(8))
    would = [True, False, True, False]
    model_a, state_a = port_setup(variables)
    step = make_fused_fleet_step(model_a, make_mesh(device="cpu"), S, K, ood_threshold=1e9,
                                 **OPTIONS)
    _, _, aux = step(state_a, init_fleet_fcs_ema(N, "cpu"), b, e, would, [True] * N)
    np.testing.assert_array_equal(aux["do_update"].numpy(), ~np.array(would))
    model_b, state_b = port_setup(variables)
    grads_n, stats_n, _ = make_fleet_fwd_bwd(
        make_adapt_forward_backward(model_b, S, K, use_er=True))(state_b, b, e)
    make_fleet_apply_updates(True)(state_b, grads_n, stats_n, aux["do_update"])
    for x, y in zip(state_a.params, state_b.params):
        torch.testing.assert_close(x, y, rtol=2e-4, atol=2e-6)


# --- make_fleet_apply_updates and FleetDriver against JAX ---------------------

@pytest.mark.parametrize("do_update", [[True, False, True, True], [False] * N])
def test_fleet_apply_updates_matches_jax(variables, jax_fwd_bwd_result, do_update):
    """JAX's per-stream gradients and statistics into both apply steps: the
    weighted mean, the clip, one masked Adam step, the statistics' mean."""
    j_grads, j_stats, _ = jax_fwd_bwd_result
    model, state = port_setup(variables)
    per_stream = [stream_named(j_grads, j_stats, i) for i in range(N)]
    stack = lambda names: [torch.from_numpy(np.stack([p[n] for p in per_stream]))
                           for n in names]
    make_fleet_apply_updates(True)(state, stack(live_names(model)), stack(buffer_names(model)),
                                   torch.tensor(do_update))
    _, js = jax_setup(variables)
    js = jax_apply(True)(js, j_grads, j_stats, jnp.asarray(do_update))
    want = named(js.params, js.batch_stats)
    got = {n: t.detach().numpy() for n, t in model.state_dict().items()}
    for n in live_names(model) + buffer_names(model):
        np.testing.assert_allclose(got[n], want[n], rtol=1e-6, atol=1e-9, err_msg=n)
    assert int(state.count) == int(js.opt_state.count) == int(any(do_update))
    assert int(state.step) == int(js.step) == 1


def test_fleet_driver_matches_jax():
    rng = np.random.RandomState(10)
    port, ref = FleetDriver(N, 0.5, 0.9), JaxFleetDriver(N, 0.5, 0.9)
    for _ in range(5):
        fcs = rng.uniform(0.3, 0.7, N).astype(np.float32)
        got, want = port.smooth_and_gate(fcs), ref.smooth_and_gate(fcs)
        np.testing.assert_array_equal(got["fcs_smoothed"], want["fcs_smoothed"])
        np.testing.assert_array_equal(got["novel"], want["novel"])


# --- make_parallel_train_step ------------------------------------------------

def jax_train_result(variables, batch, train_bn):
    model, js = jax_setup(variables)
    step = jax_parallel_train(model, js.tx, jax_mesh(1), S, [S, S + K], clip_grad_norm=True,
                              train_bn=train_bn)
    js, losses = step(js, jnp_batch(batch))
    return js, {key: float(v) for key, v in losses.items()}


@pytest.mark.parametrize("train_bn", [True, False])
def test_parallel_train_step_matches_jax(variables, train_bn):
    batch = frames(20)
    js, j_losses = jax_train_result(variables, batch, train_bn)
    model, state = port_setup(variables)
    step = make_parallel_train_step(model, make_mesh(device="cpu"), S, [S, S + K],
                                    clip_grad_norm=True, train_bn=train_bn)
    shard = data_sharding(make_mesh(device="cpu"))
    state, losses = step(state, {key: shard(v) for key, v in batch.items()})
    assert set(losses) == set(j_losses)
    for key, value in j_losses.items():
        np.testing.assert_allclose(float(losses[key]), value, err_msg=key, **LOG_TOL)
    assert_weights_match(model, state, js, named(variables["params"], variables["batch_stats"]),
                         1)
    if not train_bn:  # eval-mode BatchNorm leaves the statistics as they were
        before = named(variables["params"], variables["batch_stats"])
        assert all(np.array_equal(x.numpy(), before[n])
                   for x, n in zip(state.buffers, buffer_names(model)))


@pytest.mark.parametrize("train_bn", [True, False])
def test_parallel_train_step_at_one_rank_is_the_train_step(variables, train_bn):
    """At one rank the all_reduce is an identity and the mean a division by
    1: the data-parallel step is make_train_step, bit for bit."""
    batch = torch_batch(frames(21))
    model_a, state_a = port_setup(variables)
    state_a, losses_a = make_parallel_train_step(model_a, make_mesh(device="cpu"), S, [S, S + K],
                                                 True, train_bn=train_bn)(state_a, batch)
    model_b, state_b = port_setup(variables)
    state_b, losses_b = make_train_step(model_b, S, [S, S + K], True, train_bn)(state_b, batch)
    for group in ("params", "buffers", "m", "v"):
        assert all(torch.equal(x, y) for x, y in zip(getattr(state_a, group),
                                                     getattr(state_b, group))), group
    assert losses_a.keys() == losses_b.keys()
    assert all(torch.equal(losses_a[k], losses_b[k]) for k in losses_a)


# --- fleet_adapt --------------------------------------------------------------

class TinyDataset:
    """Four frames of a stream (tests/test_parallel.py's)."""

    def __init__(self, seed):
        r = np.random.RandomState(seed)
        self.items = [{f"color_l/{S}": r.rand(H, W, 3).astype(np.float32),
                       f"color_r/{S}": r.rand(H, W, 3).astype(np.float32),
                       f"gt_disp_l/{S}": (r.rand(H, W, 1) * 8).astype(np.float32)}
                      for _ in range(4)]

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


FLEET_ADAPT = dict(num_steps=4, ood_threshold=1e9, adapt_mode="VS+ER", ovs_buffer_size=2,
                   ovs_validate_hz=2, clip_grad_norm=True, seed=123)


def test_fleet_adapt_matches_jax(variables):
    jmodel, js = jax_setup(variables)
    ref = jax_fleet_adapt(jmodel, js, [JaxFleetStream(TinyDataset(i), f"cam{i}",
                                                      er_dataset=TinyDataset(50 + i))
                                       for i in range(N)],
                          S, K, mesh=jax_mesh(N), **FLEET_ADAPT)
    model, state = port_setup(variables)
    streams = [FleetStream(TinyDataset(i), f"cam{i}", er_dataset=TinyDataset(50 + i))
               for i in range(N)]
    got = fleet_adapt(model, state, streams, S, K, mesh=make_mesh(device="cpu"), **FLEET_ADAPT)
    print("JAX", ref["streams"], "\nport", got["streams"])
    assert got["streams"] == ref["streams"]
    assert all(s["steps"] == 4 and s["ovs_size"] > 0 for s in got["streams"])
    assert 0 < sum(s["gradient_updates"] for s in got["streams"]) < 4 * N
    for st in streams:
        assert len(st.fcs_history) == 4
    assert_weights_match(model, got["state"], ref["state"],
                         named(variables["params"], variables["batch_stats"]),
                         int(got["state"].count))


# --- the mesh -----------------------------------------------------------------

def test_mesh_slices_and_its_errors():
    mesh = make_mesh(device="cpu")
    assert (mesh.rank, mesh.world_size, mesh.device.type) == (0, 1, "cpu")
    assert local_data_slice([1, 2, 3, 4], mesh) == [1, 2, 3, 4]
    x = np.arange(8, dtype=np.float32).reshape(4, 2)
    assert torch.equal(data_sharding(mesh)(x), torch.from_numpy(x))
    with pytest.raises(ValueError, match="requested 2 devices, have 1"):
        make_mesh(2, device="cpu")
    model = StereoModel(k=K, input_scale=S, device="cpu")
    with pytest.raises(ValueError, match="unknown bn_mode"):
        make_fused_fleet_step(model, mesh, S, K, bn_mode="grouped")
    with pytest.raises(ValueError, match="warp_precision"):
        make_fused_fleet_step(model, mesh, S, K, warp_precision="default")


def test_mesh_and_fleet_state_default_to_cuda_and_raise_without_it(monkeypatch):
    """Without device= the mesh and the EMA go to CUDA; where there is none
    they raise, and nothing carries on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_mesh(device="cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_mesh()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_fleet_fcs_ema(N)
    values, init = init_fleet_fcs_ema(N, "cpu")
    assert values.dtype == torch.float32 and init.dtype == torch.bool and values.shape == (N,)
    assert not init.any()
