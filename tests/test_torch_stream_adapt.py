"""`adapt --engine pytree` against the JAX package's structured engine
(adaptive_stereo_tpu/engine/stream_adapt.py), float32, at the shapes of
tests/test_torch_train.py (32x64, k=2, maxdisp 47, fused_siamese and the
tower; JAX s2d_refinement). The port runs it as the flat engine with
fused_er_forward=False (engine/flat_stream.py):

- adapt chains with use_vs, with and without experience replay and the
  left-right loss, then a done step and a validation: the ring log, the
  frame count (JAX's train.step, the port's log_pos) and the update
  count, the reservoir and the final weights;
- the driver, adapt_streaming(engine="pytree") against JAX's on the tiny
  synthetic datasets of tests/test_torch_driver.py with all four guard
  channels: steps, updates, rollbacks, the final machine state, every
  guard and plateau decision, trials.csv;
- the options the pytree engine refuses, as JAX does.

Tolerances are the flat engine's (tests/test_torch_train.py and
tests/test_torch_driver.py): the decisions equal, log rows up to the first
applied update 1e-5 absolute and relative, later rows, reservoir values
and validation results 1e-4 + 2e-3 relative, parameters within 2 lr per
applied update with a median under 0.1 lr, every driver decision's margin
to its threshold wider than 2e-3 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import adaptive_stereo_tpu.engine.config as jax_config
import adaptive_stereo_tpu.engine.stream_driver as jax_driver
import adaptive_stereo_tpu_torch.engine.config as port_config
import adaptive_stereo_tpu_torch.engine.stream_driver as port_driver
from adaptive_stereo_tpu.engine.state import create_train_state as jax_train_state
from adaptive_stereo_tpu.engine.stream_adapt import (init_stream_state as jax_init_state,
                                                     make_streaming_steps as jax_make_steps)
from adaptive_stereo_tpu.models import StereoModel as JaxStereoModel
from adaptive_stereo_tpu_torch.engine import (LOG_COLS, FlatStreamState, init_flat_stream_state,
                                              make_flat_streaming_steps)
from adaptive_stereo_tpu_torch.models import state_dicts_from_jax
from test_torch_driver import GUARD, _cfg, _margins, _read_csv, _record, data  # noqa: F401
from test_torch_train import (AFTER_UPDATE_TOL, H, K, LOG_TOL, LR, MAXDISP, MEDIAN_PARAM_LR, S,
                              W, _assert_running_stats, _frames, _port, _variables)

OPTIONS = dict(use_vs=True, ood_threshold=12.76, clip_grad_norm=True)
INDICES = [0, 0, 1, 0]
CAPACITY = 8
COLS = {c: i for i, c in enumerate(LOG_COLS)}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads (see tests/test_torch_driver.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _weights(variables):
    fsd, ssd = state_dicts_from_jax(variables, K)
    return {**{f"feature_net.{k}": v.numpy() for k, v in fsd.items()},
            **{f"stereo_net.{k}": v.numpy() for k, v in ssd.items()}}


@pytest.mark.parametrize("use_er, use_leftright", [(True, False), (False, False),
                                                   (True, True), (False, True)])
def test_chain_done_and_validate_match_jax(use_er, use_leftright):
    variables = _variables(7)
    rng = np.random.RandomState(8)
    frames = [_frames(rng) for _ in range(3)]
    er_left, er_right = _frames(rng)
    gt = (rng.rand(1, H, W, 1) * 30).astype(np.float32)
    options = dict(OPTIONS, use_er=use_er, use_leftright=use_leftright)

    jmodel = JaxStereoModel(k=K, input_scale=S, maxdisp=MAXDISP, fused_siamese=True,
                            s2d_refinement=True)
    x = jnp.zeros((1, H, W, 3))
    jss = jax_init_state(jax_train_state(jmodel, jax.random.PRNGKey(0), x, x, LR, variables),
                         CAPACITY, H, W, 64, seed=0)
    j_adapt, j_done, j_validate = jax_make_steps(jmodel, S, K, warp_precision="highest",
                                                 **options)
    model = _port(variables, fused_siamese=True, fused_tower=True)
    ss = init_flat_stream_state(model, LR, CAPACITY, H, W, 64, seed=0, device="cpu")
    adapt, done, validate, _ = make_flat_streaming_steps(model, S, K, fused_er_forward=False,
                                                         **options)

    t = lambda a: torch.from_numpy(a)
    keys = (f"color_l/{S}", f"color_r/{S}", f"gt_disp_l/{S}")
    er = dict(zip(keys, (er_left, er_right, gt)))
    for idx in INDICES:
        batch = dict(zip(keys, (*frames[idx], gt)))
        jss = j_adapt(jss, {k: jnp.asarray(v) for k, v in batch.items()},
                      {k: jnp.asarray(v) for k, v in er.items()}, jnp.asarray(idx, jnp.int32))
        ss = adapt(ss, *(t(batch[k]) for k in keys), *(t(er[k]) for k in keys), idx)
    batch = dict(zip(keys, (*frames[2], gt)))
    jss = j_done(jss, {k: jnp.asarray(v) for k, v in batch.items()}, jnp.asarray(2, jnp.int32))
    ss = done(ss, *(t(batch[k]) for k in keys), 2)
    jss, j_avg, j_size, j_disp = j_validate(jss)
    ss, avg, size, mean_disp = validate(ss)

    n = len(INDICES) + 1
    ref_log, log = np.asarray(jss.log)[:n], ss.log.numpy()[:n]
    print(f"use_er={use_er} use_leftright={use_leftright}\nJAX log:\n{ref_log}\nport log:\n{log}")
    for c in ("novel", "did_add", "do_update"):
        np.testing.assert_array_equal(log[:, COLS[c]], ref_log[:, COLS[c]], err_msg=c)
    first = list(log[:, COLS["do_update"]]).index(1.0)
    np.testing.assert_allclose(log[:first + 1], ref_log[:first + 1], **LOG_TOL)
    np.testing.assert_allclose(log[first + 1:], ref_log[first + 1:], **AFTER_UPDATE_TOL)
    # The done step logs no replay and no update; replay is logged with ER.
    assert log[-1, COLS["replay_loss"]] == log[-1, COLS["do_update"]] == 0
    assert (log[:-1, COLS["replay_loss"]] > 0).all() == use_er
    updates = int(log[:, COLS["do_update"]].sum())
    assert 1 <= updates < len(INDICES)
    # The frame count advances on every frame, the count on applied updates only.
    assert int(ss.log_pos) == int(jss.train.step) == n
    assert int(ss.count) == updates
    assert int(size) == int(j_size) == int(ss.reservoir.size) < CAPACITY
    np.testing.assert_array_equal(ss.reservoir.reg_indices.numpy(),
                                  np.asarray(jss.reservoir.reg_indices))
    np.testing.assert_array_equal(ss.reservoir.left.numpy(), np.asarray(jss.reservoir.left))
    np.testing.assert_allclose(ss.reservoir.values.numpy(), np.asarray(jss.reservoir.values),
                               **AFTER_UPDATE_TOL)
    for a, b in ((avg, j_avg), (mean_disp, j_disp)):
        np.testing.assert_allclose(float(a), float(b), **AFTER_UPDATE_TOL)

    new_vars = jax.tree.map(np.asarray, {"params": jss.train.params,
                                         "batch_stats": jss.train.batch_stats})
    want, before = _weights(new_vars), _weights(variables)
    named = {n: p.detach().numpy() for n, p in model.named_parameters() if ".conv2." not in n}
    diffs = np.concatenate([np.abs(p - want[n]).ravel() for n, p in named.items()])
    moved = max(np.abs(want[n] - before[n]).max() for n in named)
    print(f"parameters moved up to {moved:.3g}; port vs JAX max {diffs.max():.3g}, "
          f"median {np.median(diffs):.3g} after {updates} updates")
    assert moved > 0.5 * LR
    assert diffs.max() <= 2 * LR * updates and np.median(diffs) <= MEDIAN_PARAM_LR * LR
    _assert_running_stats(model, new_vars, dict(atol=2 * LR * updates, rtol=1e-3))


def test_guard_snapshot_restores_the_whole_train_state():
    """The guard's snapshot of the engine state (JAX copies ss.train for the
    pytree engine): a restore brings back the parameters, the moments, the
    count and the running statistics, and leaves the observations."""
    model = _port(_variables(1), fused_siamese=True, fused_tower=True)
    ss = init_flat_stream_state(model, LR, 2, H, W, 8, device="cpu")
    snap = port_driver.guard_snapshot(ss)
    with torch.no_grad():
        for group in (ss.params, ss.m, ss.v, ss.buffers):
            for tensor in group:
                tensor.add_(1.0)
    for scalar in (ss.count, ss.log_pos):
        scalar.add_(3)
    assert port_driver.guard_restore(ss, snap) is ss
    again = port_driver.guard_snapshot(ss)
    assert set(snap) == {"params", "m", "v", "buffers", "count"}
    for key, value in snap.items():
        if isinstance(value, list):
            assert all(torch.equal(a, b) for a, b in zip(value, again[key])), key
        else:
            assert torch.equal(value, again[key]), key
    assert int(ss.log_pos) == 3


def test_adapt_streaming_pytree_matches_jax(data, tmp_path, monkeypatch):
    variables = data[2]
    j_events, p_events = [], []
    _record(monkeypatch, jax_driver, j_events)
    _record(monkeypatch, port_driver, p_events)
    ref = jax_driver.adapt_streaming(_cfg(jax_config, data, tmp_path, "jax", **GUARD),
                                     variables=variables, engine="pytree")
    got = port_driver.adapt_streaming(_cfg(port_config, data, tmp_path, "port", **GUARD),
                                      variables=variables, engine="pytree", device="cpu")
    for key in ("steps", "gradient_updates", "guard_rollbacks", "final_state"):
        print(f"{key}: JAX {ref[key]}, port {got[key]}")
        assert got[key] == ref[key], key
    assert got["steps"] == 12 and got["gradient_updates"] > 0
    ss = got["stream_state"]
    assert isinstance(ss, FlatStreamState)

    n = got["steps"]
    log, ref_log = ss.log.numpy()[:n], np.asarray(ref["stream_state"].log)[:n]
    for c in ("novel", "did_add", "do_update"):
        np.testing.assert_array_equal(log[:, COLS[c]], ref_log[:, COLS[c]], err_msg=c)
    np.testing.assert_allclose(log, ref_log, **AFTER_UPDATE_TOL)
    assert int(ss.log_pos) == int(ref["stream_state"].log_pos) == n

    assert [(e[0], e[3]) for e in p_events] == [(e[0], e[3]) for e in j_events]
    assert {e[0] for e in p_events} >= {"check", "check_lr", "check_train_epe", "transition"}
    margins = [("novelty: smoothed FCS vs ood_threshold", abs(1e9 - v) / 1e9)
               for v in log[:, COLS["fcs_smoothed"]]]
    for pe, je in zip(p_events, j_events):
        np.testing.assert_allclose(pe[1], je[1], err_msg=pe[0], **AFTER_UPDATE_TOL)
        margins += _margins(pe, GUARD)
    for what, m in margins:
        print(f"decision margin, {what}: {m:.4g}")
    assert min(m for _, m in margins) > AFTER_UPDATE_TOL["rtol"]

    head, rows = _read_csv(tmp_path / "port" / "trials.csv")
    ref_head, ref_rows = _read_csv(tmp_path / "jax" / "trials.csv")
    assert head == ref_head and len(rows) == len(ref_rows) == 3
    for row, ref_row in zip(rows, ref_rows):
        for name, a, b in zip(head, row, ref_row):
            if name in ("trial", "step", "GRADIENT_UPDATES") or b == "":
                assert a == b, name
            else:
                np.testing.assert_allclose(float(a), float(b), err_msg=name, **AFTER_UPDATE_TOL)
    # Only the flat engine writes the streaming state beside the weights.
    assert not (tmp_path / "port" / "models" / f"weights_{n}" / "stream_state.msgpack").exists()


@pytest.mark.parametrize("option, message", [
    (dict(done_batch=2), "done_batch > 1 requires engine='flat'"),
    (dict(device_cache=True), "device_cache requires engine='flat'"),
    (dict(resume_from="somewhere"), "resume_from requires engine='flat'"),
    (dict(loss_dtype="bfloat16"), "loss_dtype requires engine='flat'"),
    (dict(engine="bogus"), "unknown engine 'bogus'"),
])
def test_pytree_refuses_the_flat_engines_options(data, tmp_path, option, message):
    option = dict(option)
    adapt = {"loss_dtype": option.pop("loss_dtype")} if "loss_dtype" in option else {}
    engine = option.pop("engine", "pytree")
    cfg = _cfg(port_config, data, tmp_path, "refused", **adapt)
    with pytest.raises(ValueError, match=message):
        port_driver.adapt_streaming(cfg, variables=data[2], engine=engine, device="cpu",
                                    **option)
    assert not (tmp_path / "refused").exists()
