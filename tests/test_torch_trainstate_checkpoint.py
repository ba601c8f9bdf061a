"""The whole-train-state checkpoint (engine/checkpoint.py save_checkpoint /
load_checkpoint) against the JAX package's, on the CPU at 32x64, k=2:

- a JAX checkpoint loads into the port: step, parameters, BatchNorm
  statistics, both optimizer counts, Adam's mu and nu and the learning
  rate all equal, and the port writes the same file back byte for byte;
- a port checkpoint loads into JAX's load_checkpoint, every leaf equal in
  value and dtype;
- a file whose two optimizer counts differ is refused.

The states have taken supervised steps, one masked (skipped) update, so
the step and the counts differ, and a learning-rate halving.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaptive_stereo_tpu.engine.checkpoint import load_checkpoint as jax_load_checkpoint
from adaptive_stereo_tpu.engine.checkpoint import save_checkpoint as jax_save_checkpoint
from adaptive_stereo_tpu.engine.state import create_train_state as jax_create_state
from adaptive_stereo_tpu.engine.steps import make_apply_updates as jax_make_apply_updates
from adaptive_stereo_tpu.engine.steps import make_train_step as jax_make_train_step
from adaptive_stereo_tpu.models import StereoModel as JaxStereoModel
from adaptive_stereo_tpu_torch.engine import (create_train_state, load_checkpoint,
                                              make_apply_updates, make_train_step,
                                              save_checkpoint)
from adaptive_stereo_tpu_torch.engine.checkpoint import packb, unpackb
from adaptive_stereo_tpu_torch.models import StereoModel, variables_from_state_dicts
from test_torch_train import _variables

H, W, K, S, MAXDISP = 32, 64, 2, 0, 47
LR = 1e-4


def _batch(seed):
    rng = np.random.RandomState(seed)
    return {f"color_l/{S}": rng.rand(2, H, W, 3).astype(np.float32),
            f"color_r/{S}": rng.rand(2, H, W, 3).astype(np.float32),
            f"gt_disp_l/{S}": (rng.rand(2, H, W, 1) * 30).astype(np.float32)}


def _port_model():
    return StereoModel(k=K, input_scale=S, maxdisp=MAXDISP, device="cpu")


def _jax_state():
    model = JaxStereoModel(k=K, input_scale=S, maxdisp=MAXDISP)
    x = jnp.zeros((1, H, W, 3))
    return model, jax_create_state(model, jax.random.PRNGKey(0), x, x, LR,
                                   variables=_variables(11))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _flat(tree[key], f"{prefix}/{key}")
    else:
        yield prefix, np.asarray(tree)


def _assert_trees_equal(a, b):
    fa, fb = dict(_flat(a)), dict(_flat(b))
    assert sorted(fa) == sorted(fb)
    for key in fa:
        assert fa[key].dtype == fb[key].dtype, key
        np.testing.assert_array_equal(fa[key], fb[key], err_msg=key)


def _read(folder):
    with open(os.path.join(folder, "state.msgpack"), "rb") as f:
        return f.read()


def test_jax_checkpoint_loads_into_the_port(tmp_path):
    model, state = _jax_state()
    step = jax_make_train_step(model, state.tx, S, [S, S + K], True)
    for seed in (1, 2):
        state, _ = step(state, {k: jnp.asarray(v) for k, v in _batch(seed).items()})
    # A masked update: the step advances, the optimizer state stays.
    grads = jax.tree.map(jnp.ones_like, state.params)
    state = jax_make_apply_updates(True)(state, grads, state.batch_stats, jnp.asarray(False))
    state = state.with_learning_rate(state.learning_rate * 0.5)
    folder = jax_save_checkpoint(str(tmp_path / "jax"), state, 3, {"note": "jax"})

    port = create_train_state(_port_model(), torch.Generator().manual_seed(0), 1e-2)
    load_checkpoint(folder, port)
    assert (int(port.step), int(port.count)) == (3, 2)
    assert port.learning_rate == state.learning_rate == np.float32(LR / 2)
    want = unpackb(_read(folder))
    mine = variables_from_state_dicts(port.model.feature_net.state_dict(),
                                      port.model.stereo_net.state_dict(), K)
    _assert_trees_equal(mine["params"], want["params"])
    _assert_trees_equal(mine["batch_stats"], want["batch_stats"])
    adam = state.opt_state.inner_state[0]
    for moment, tensors in (("mu", port.m), ("nu", port.v)):
        tree = jax.tree.map(np.asarray, getattr(adam, moment))
        assert sum(t.numel() for t in tensors) == sum(v.size for _, v in _flat(tree))
    # Written back, the file is the same bytes: every leaf (mu and nu
    # included) round-trips exactly.
    again = save_checkpoint(str(tmp_path / "port"), port, 3)
    assert _read(again) == _read(folder)


def test_port_checkpoint_loads_into_jax(tmp_path):
    port = create_train_state(_port_model(), None, LR, variables=_variables(12))
    step = make_train_step(port.model, S, [S, S + K], True)
    for seed in (3, 4):
        port, _ = step(port, {k: torch.from_numpy(v) for k, v in _batch(seed).items()})
    grads = [torch.ones_like(p) for p in port.params]
    port = make_apply_updates(True)(port, grads, torch.tensor(False))
    port = port.with_learning_rate(port.learning_rate * 0.5)
    folder = save_checkpoint(str(tmp_path / "port"), port, 3, {"note": "port"})

    _, template = _jax_state()
    restored = jax_load_checkpoint(folder, template)
    assert int(restored.step) == 3
    assert int(restored.opt_state.count) == int(restored.opt_state.inner_state[0].count) == 2
    assert restored.learning_rate == port.learning_rate
    got = {"step": restored.step, "params": restored.params,
           "batch_stats": restored.batch_stats,
           "opt_state": {"count": restored.opt_state.count,
                         "hyperparams": dict(restored.opt_state.hyperparams),
                         "mu": restored.opt_state.inner_state[0].mu,
                         "nu": restored.opt_state.inner_state[0].nu}}
    saved = unpackb(_read(folder))
    want = {"step": saved["step"], "params": saved["params"],
            "batch_stats": saved["batch_stats"],
            "opt_state": {"count": saved["opt_state"]["count"],
                          "hyperparams": saved["opt_state"]["hyperparams"],
                          "mu": saved["opt_state"]["inner_state"]["0"]["mu"],
                          "nu": saved["opt_state"]["inner_state"]["0"]["nu"]}}
    _assert_trees_equal(jax.tree.map(np.asarray, got), want)
    # And the values are the port's own tensors.
    mine = variables_from_state_dicts(port.model.feature_net.state_dict(),
                                      port.model.stereo_net.state_dict(), K)
    _assert_trees_equal(jax.tree.map(np.asarray, restored.params), mine["params"])
    with open(os.path.join(folder, "meta.json")) as f:
        assert '"note": "port"' in f.read()


def test_checkpoint_with_unequal_counts_is_refused(tmp_path):
    port = create_train_state(_port_model(), torch.Generator().manual_seed(1), LR)
    folder = save_checkpoint(str(tmp_path), port, 0)
    payload = unpackb(_read(folder))
    payload["opt_state"]["count"] = np.asarray(5, np.int32)
    with open(os.path.join(folder, "state.msgpack"), "wb") as f:
        f.write(packb(payload))
    with pytest.raises(ValueError, match="counts differ"):
        load_checkpoint(folder, port)
