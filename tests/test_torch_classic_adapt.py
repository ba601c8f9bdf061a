"""The classic adaptation engine, adapt() (engine/adapt.py), against JAX
adapt() on the CPU, in NONSTOP, ER, VS and VS+ER (tests/
test_torch_classic_policies.py: NONE, the priority-queue policy and the
left-right loss).

One tiny synthetic dataset (32x64, k=2, maxdisp 47; 6 + 2 novel-domain
frames, 4 + 2 training-domain frames), the same variables (flax init with
redrawn BatchNorm statistics), float32, two epochs (12 steps), reservoir
2, validation every 3 steps, evals at 6 and 12, ood_threshold 1e9 (every
frame novel), lr 2e-5. Compared: the step_hook records (decisions exactly
equal, values in the band), the plateau transitions, gradient updates,
final state, trials.csv and the final checkpoint's weights, step and count.

Bands (tests/test_torch_train.py's): values up to the first applied update
LOG_TOL (1e-5), after it AFTER_UPDATE_TOL (1e-4 + 2e-3 relative);
parameters within 2 lr per applied update with a median under 0.1 lr.
Running statistics: AFTER_UPDATE_TOL plus 2 lr per applied update, since
each batch mean carries the bias of the conv in front of its BatchNorm, a
parameter whose exact gradient is 0 and which each framework's Adam moves
by +-lr a step its own way (tests/test_torch_train.py; after NONSTOP's
12 updates the running means differed by up to 5.9e-4). Every decision's
margin to its threshold (the novelty gate, each plateau comparison) is
printed and must exceed 2e-3 relative, so no branch can flip within the
band. lr 2e-5 keeps twelve updates of the NONSTOP chain inside the band
(at 1e-4 the FCS had drifted 4e-3 relative by step 8); at it, the one
plateau comparison of each run is 5e-3 to 3e-2 from its threshold.
"""

import csv
import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import adaptive_stereo_tpu.engine.config as jax_config
import adaptive_stereo_tpu_torch.engine.config as port_config
from adaptive_stereo_tpu.engine.checkpoint import load_variables as jax_load
from adaptive_stereo_tpu.models import StereoModel as JaxStereoModel
from adaptive_stereo_tpu_torch.data import generate_synthetic_dataset
from adaptive_stereo_tpu_torch.models import state_dicts_from_jax
from test_torch_train import AFTER_UPDATE_TOL, LOG_TOL, MEDIAN_PARAM_LR, _randomize_bn

# The engine packages export their adapt() functions under the modules' names.
jax_adapt_mod = importlib.import_module("adaptive_stereo_tpu.engine.adapt")
port_adapt_mod = importlib.import_module("adaptive_stereo_tpu_torch.engine.adapt")

H, W, K, S, MAXDISP = 32, 64, 2, 0, 47
LR = 2e-5
MARGIN = AFTER_UPDATE_TOL["rtol"]
VALUES = ("fcs_raw", "fcs_smoothed", "mono_loss", "replay_loss", "epe")
DECISIONS = ("novel", "did_add", "do_update", "state")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads (see tests/test_torch_driver.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _prefixed(variables):
    fsd, ssd = state_dicts_from_jax(variables, K)
    return {**{f"feature_net.{k}": v.numpy() for k, v in fsd.items()},
            **{f"stereo_net.{k}": v.numpy() for k, v in ssd.items()}}


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("classic")
    train, novel = str(root / "train"), str(root / "novel")
    generate_synthetic_dataset(train, name="synth", num_train=4, num_val=2, height=H, width=W,
                               max_disp=12.0, seed=0)
    generate_synthetic_dataset(novel, name="synth", num_train=6, num_val=2, height=H, width=W,
                               max_disp=12.0, seed=50, domain_shift=True)
    x = jnp.zeros((1, H, W, 3))
    v = JaxStereoModel(k=K, input_scale=S, maxdisp=MAXDISP).init(jax.random.PRNGKey(0), x, x,
                                                                  train=False)
    variables = _randomize_bn(jax.tree.map(np.asarray, dict(v)), np.random.RandomState(0))
    return train, novel, variables


def _cfg(mod, data, log_dir, name, mode, lr=LR, **adapt):
    train, novel, _ = data
    options = dict(adapt_mode=mode, ovs_buffer_size=2, ovs_validate_hz=3,
                   val_improve_retries=1, eval_hz=6, ood_threshold=1e9,
                   train_dataset_path=train, train_dataset_name="Synthetic",
                   train_split="synth")
    options.update(adapt)
    return mod.ExperimentConfig(
        model_name=name, log_dir=str(log_dir), num_epochs=2, log_frequency=3,
        model=mod.ModelConfig(k=K, input_scale=S, maxdisp=MAXDISP),
        optim=mod.OptimConfig(learning_rate=lr, clip_grad_norm=True),
        data=mod.DataConfig(dataset_path=novel, dataset_name="Synthetic", split="synth",
                            height=H, width=W, batch_size=1, num_workers=0),
        adapt=mod.AdaptConfig(**options))


def _record_transitions(monkeypatch, mod, events):
    orig = mod.StateMachine.transition

    def transition(self, retries):
        before = (self.prev_ovs_loss, self.ovs_did_change, self.ovs.average_value())
        state = orig(self, retries)
        events.append((before, state.name))
        return state
    monkeypatch.setattr(mod.StateMachine, "transition", transition)


def _read_csv(path):
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    return rows[0], rows[1:]


def check_adapt_against_jax(mode, extra, data, tmp_path, monkeypatch, jax_kw=None,
                            port_kw=None, margins=(), lr=LR):
    """Run both engines on one configuration and hold the port to JAX.
    jax_kw / port_kw: more arguments of each adapt() (the reconstruction
    gate's model); margins: more (what, relative margin) decisions to hold
    above the band; lr: the learning rate, which the parameter and running
    statistics bands scale with. Returns the per-step records of both
    runs."""
    variables = data[2]
    records = {"jax": [], "port": []}
    events = {"jax": [], "port": []}
    _record_transitions(monkeypatch, jax_adapt_mod, events["jax"])
    _record_transitions(monkeypatch, port_adapt_mod, events["port"])
    ref = jax_adapt_mod.adapt(_cfg(jax_config, data, tmp_path, "jax", mode, lr, **extra),
                              variables=variables,
                              step_hook=lambda s, r: records["jax"].append(r), **(jax_kw or {}))
    got = port_adapt_mod.adapt(_cfg(port_config, data, tmp_path, "port", mode, lr, **extra),
                               variables=variables, device="cpu",
                               step_hook=lambda s, r: records["port"].append(r),
                               **(port_kw or {}))
    for key in ("steps", "gradient_updates", "final_state"):
        print(f"{key}: JAX {ref[key]}, port {got[key]}")
        assert got[key] == ref[key], key
    assert got["steps"] == 12

    # The per-step records: decisions exact, values in the band.
    assert len(records["port"]) == len(records["jax"]) == 12
    updates = [r["do_update"] for r in records["port"]]
    first = updates.index(True) if any(updates) else len(updates)
    for i, (a, b) in enumerate(zip(records["port"], records["jax"])):
        assert sorted(a) == sorted(b)
        assert [a[k] for k in DECISIONS] == [b[k] for k in DECISIONS], i
        for key in VALUES:
            if b[key] is None:
                assert a[key] is None, key
                continue
            np.testing.assert_allclose(a[key], b[key], err_msg=f"step {i} {key}",
                                       **(LOG_TOL if i <= first else AFTER_UPDATE_TOL))
    states = [r["state"] for r in records["port"]]
    print(f"states: {states}; updates {sum(updates)}; did_add "
          f"{sum(r['did_add'] for r in records['port'])}")
    if mode == "NONE":
        assert set(states) == {"DONE"} and got["gradient_updates"] == 0
    elif extra.get("ovs_policy") == "priority_queue":
        # Every frame is novel, and under this policy a novel frame always
        # diverts from the update; the heap decides admission by loss.
        assert got["gradient_updates"] == 0 and 0 < sum(r["did_add"] for r in records["port"])
    else:
        assert got["gradient_updates"] > 0

    # Every decision's margin to its threshold.
    margins = list(margins)
    if mode in ("VS", "VS+ER"):
        margins += [("novelty: smoothed FCS vs ood_threshold", abs(1e9 - r["fcs_smoothed"]) / 1e9)
                    for r in records["port"]]
    assert [e[1] for e in events["port"]] == [e[1] for e in events["jax"]]
    for ((prev, changed, loss), _), ((j_prev, _, j_loss), _) in zip(events["port"],
                                                                   events["jax"]):
        np.testing.assert_allclose(loss, j_loss, **AFTER_UPDATE_TOL)
        if np.isfinite(prev) and not changed:
            margins.append(("plateau: OVS loss vs previous", abs(loss - prev) / prev))
    for what, m in margins:
        print(f"decision margin, {what}: {m:.4g}")
    assert all(m > MARGIN for _, m in margins)

    # trials.csv: the same columns and rows; counters exact, metrics in band.
    head, rows = _read_csv(tmp_path / "port" / "trials.csv")
    ref_head, ref_rows = _read_csv(tmp_path / "jax" / "trials.csv")
    assert head == ref_head and len(rows) == len(ref_rows) == 3
    assert [r[head.index("step")] for r in rows] == ["-1", "6", "12"]
    for row, ref_row in zip(rows, ref_rows):
        for name, a, b in zip(head, row, ref_row):
            if name in ("trial", "step", "GRADIENT_UPDATES") or b == "":
                assert a == b, name
            else:
                np.testing.assert_allclose(float(a), float(b), err_msg=name,
                                           **AFTER_UPDATE_TOL)

    # The final checkpoint, read by the JAX package's loader.
    final = os.path.join("models", "weights_12")
    mine = _prefixed(jax_load(str(tmp_path / "port" / final)))
    want = _prefixed(jax_load(str(tmp_path / "jax" / final)))
    n_updates = got["gradient_updates"]
    live = [k for k in want if ".conv2." not in k and not k.endswith(
        ("running_mean", "running_var", "num_batches_tracked"))]
    diffs = np.concatenate([np.abs(mine[k] - want[k]).ravel() for k in live])
    print(f"final weights: max {diffs.max():.3g}, median {np.median(diffs):.3g} "
          f"({n_updates} updates of lr {lr})")
    assert diffs.max() <= 2 * lr * max(n_updates, 1) and np.median(diffs) <= MEDIAN_PARAM_LR * lr
    for k in want:
        if k.endswith(("running_mean", "running_var")) and ".conv2." not in k:
            np.testing.assert_allclose(mine[k], want[k], rtol=AFTER_UPDATE_TOL["rtol"],
                                       atol=AFTER_UPDATE_TOL["atol"] + 2 * lr * n_updates,
                                       err_msg=k)
    state, j_state = got["state"], ref["state"]
    assert int(state.step) == int(j_state.step)
    assert int(state.count) == int(j_state.opt_state.count) == n_updates
    return records


@pytest.mark.parametrize("mode", ["NONSTOP", "ER", "VS", "VS+ER"])
def test_adapt_matches_jax(mode, data, tmp_path, monkeypatch):
    check_adapt_against_jax(mode, {}, data, tmp_path, monkeypatch)
