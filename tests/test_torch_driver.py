"""The streaming adaptation driver (engine/stream_driver.py) and the
`adapt` command line against the JAX package, on the CPU:

- _PlateauMachine and TrustRegionGuard against the JAX classes on scripted
  sequences (losses, disparities, probes, churn, NaN and inf): every
  decision and every attribute equal after every call;
- adapt_streaming against JAX adapt_streaming(engine="flat") on one tiny
  synthetic dataset (32x64, k=2, maxdisp 47) from the same variables, in
  float32, with VS+ER, the fused ER forward, the tower, done_batch=2 and
  all four guard channels, over two epochs: the steps, gradient updates,
  rollbacks, final machine state, the ring log's decisions, every guard and
  plateau decision, trials.csv and the final checkpoint's weights. The
  reservoir stays below capacity, so no random draw decides. Values are
  held to tests/test_torch_train.py's after-update band (1e-4 + 2e-3
  relative; parameters within 2 lr per applied update, median under 0.1
  lr). Every decision's margin to its threshold is printed and must exceed
  that band's 2e-3 relative, so the two runs cannot take different
  branches within the tolerance;
- a resumed run equal to an uninterrupted one, bit for bit, with the
  reservoir's random draws deciding (capacity 2);
- the command line: a run from a checkpoint the port wrote, and the named
  errors (a bogus --adapt_mode, no weights, a missing folder, `--engine
  pytree` without weights (it reaches the driver), `--device_cache` with
  the pytree engine, the classic engine's flag checks, and the classic
  engine's reconstruction gate without its autoencoder).
"""

import csv
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import adaptive_stereo_tpu.engine.config as jax_config
import adaptive_stereo_tpu.engine.stream_driver as jax_driver
import adaptive_stereo_tpu_torch.engine.config as port_config
import adaptive_stereo_tpu_torch.engine.stream_driver as port_driver
from adaptive_stereo_tpu.engine.adapt import State as JaxState
from adaptive_stereo_tpu.engine.checkpoint import load_variables as jax_load
from adaptive_stereo_tpu_torch.cli import main
from adaptive_stereo_tpu_torch.engine import adapt as adapt_classic
from adaptive_stereo_tpu_torch.data import generate_synthetic_dataset
from adaptive_stereo_tpu_torch.engine import LOG_COLS, State, load_stream_checkpoint, save_variables
from adaptive_stereo_tpu_torch.engine.flat_stream import init_flat_stream_state
from adaptive_stereo_tpu_torch.models import StereoModel, state_dicts_from_jax
from test_torch_train import AFTER_UPDATE_TOL, MEDIAN_PARAM_LR, _randomize_bn

H, W, K, S, MAXDISP = 32, 64, 2, 0, 47
LR = 1e-4
MARGIN = AFTER_UPDATE_TOL["rtol"]
COLS = {c: i for i, c in enumerate(LOG_COLS)}
# Guard channels of the parity run: the loss and disparity channels in band,
# the train-EPE channel rolling back twice, the L-R channel in band.
GUARD = dict(ovs_guard_tolerance=0.5, ovs_guard_disp_band=4.0,
             ovs_guard_train_epe_factor=0.38, ovs_guard_lr_factor=3.0)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: the driver's loader threads and the test
    runner's other worker processes share the cores, and a full team of
    spinning threads a process slows these CPU runs by an order of
    magnitude when the suite runs in parallel."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


# --- the host-side machines against the JAX classes -------------------------

def _guard_attrs(g):
    return (g.best, g.stale, g.rollbacks, g.snap, g.epe_snap, g.lr_snap, g.disp_ref,
            g.train_epe_ref, g.lr_ref, g.enabled)


def _same(a, b):
    return all(x == y or (isinstance(x, float) and np.isnan(x) and np.isnan(y))
               for x, y in zip(a, b))


def _value(rng, scale):
    r = rng.rand()
    if r < 0.05:
        return float("nan")
    if r < 0.08:
        return float("inf")
    return float(scale * np.exp(rng.uniform(-1.5, 1.5)))


@pytest.mark.parametrize("channels", [(0.1, 0, 0, 0), (0, 4, 0, 0), (0, 0, 2, 0), (0, 0, 0, 1.3),
                                      (0.1, 4, 2, 1.3), (0.3, 3, 1.5, 1.2), (0, 0, 0, 0)])
def test_trust_region_guard_matches_jax(channels):
    tol, band, epe, lr = channels
    guards = [mod.TrustRegionGuard(tol, lambda s: s, lambda s, snap: snap, disp_band=band,
                                   train_epe_factor=epe, lr_factor=lr)
              for mod in (jax_driver, port_driver)]
    rng = np.random.RandomState(int(100 * sum(channels)))
    if band and rng.rand() < 0.5:
        for g in guards:
            g.pin_initial("pre", 10.0)
    for i in range(300):
        op = rng.randint(5)
        state = f"m{i}"
        if op == 0:
            args = ("check", state, _value(rng, 1.0), _value(rng, 10.0))
        elif op == 1:
            args = ("check_lr", state, _value(rng, 5.0))
        elif op == 2:
            args = ("check_train_epe", state, _value(rng, 5.0), epe)
        elif op == 3:
            args = ("mark_churn",)
        else:
            args = ("check", state, _value(rng, 1.0), None)
        out = [getattr(g, args[0])(*args[1:]) for g in guards]
        assert out[0] == out[1], (i, args)
        assert _same(_guard_attrs(guards[0]), _guard_attrs(guards[1])), (i, args)
    print(f"channels {channels}: {guards[1].rollbacks} rollbacks in 300 calls")
    if any(channels):
        assert guards[1].rollbacks > 0


@pytest.mark.parametrize("retries", [1, 2, 3])
def test_plateau_machine_matches_jax(retries):
    machines = [jax_driver._PlateauMachine(JaxState.IN_PROGRESS, retries),
                port_driver._PlateauMachine(State.IN_PROGRESS, retries)]
    rng = np.random.RandomState(retries)
    done = 0
    for i in range(200):
        r, loss = rng.rand(), 0.5 + 0.1 * rng.randint(7)
        for m in machines:
            if r < 0.1:
                m.restart()
            elif r < 0.3:
                m.ovs_did_change = True
            else:
                m.transition(loss)
        a, b = machines
        assert (a.state.name, a.prev_loss, a.ovs_did_change, a.iters_without_improvement) == \
            (b.state.name, b.prev_loss, b.ovs_did_change, b.iters_without_improvement), i
        done += a.state.name == "DONE"
    assert done > 0


# --- adapt_streaming against the JAX driver ---------------------------------

@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("driver")
    train, novel = str(root / "train"), str(root / "novel")
    generate_synthetic_dataset(train, name="synth", num_train=4, num_val=2, height=H, width=W,
                               max_disp=12.0, seed=0)
    generate_synthetic_dataset(novel, name="synth", num_train=6, num_val=2, height=H, width=W,
                               max_disp=12.0, seed=50, domain_shift=True)
    from adaptive_stereo_tpu.models import StereoModel as JaxStereoModel

    x = jnp.zeros((1, H, W, 3))
    v = JaxStereoModel(k=K, input_scale=S, maxdisp=MAXDISP).init(jax.random.PRNGKey(0), x, x,
                                                                  train=False)
    variables = _randomize_bn(jax.tree.map(np.asarray, dict(v)), np.random.RandomState(0))
    return train, novel, variables


def _cfg(mod, data, log_dir, name, num_steps=-1, **kw):
    train, novel, _ = data
    adapt = dict(adapt_mode="VS+ER", num_steps=num_steps, ovs_buffer_size=8, ovs_validate_hz=3,
                 val_improve_retries=1, eval_hz=6, ood_threshold=1e9, skip_initial_eval=False,
                 train_dataset_path=train, train_dataset_name="Synthetic", train_split="synth")
    adapt.update(kw)
    return mod.ExperimentConfig(
        model_name=name, log_dir=str(log_dir), num_epochs=2, log_frequency=3,
        model=mod.ModelConfig(k=K, input_scale=S, maxdisp=MAXDISP, fused_siamese=True,
                              s2d_refinement=True),
        optim=mod.OptimConfig(learning_rate=LR, clip_grad_norm=True),
        data=mod.DataConfig(dataset_path=novel, dataset_name="Synthetic", split="synth",
                            height=H, width=W, batch_size=1, num_workers=2),
        adapt=mod.AdaptConfig(**adapt))


def _record(monkeypatch, mod, events):
    """Record (name, arguments, state before, outcome) of every guard and
    plateau decision of module mod's driver."""
    guard_cls, machine_cls = mod.TrustRegionGuard, mod._PlateauMachine
    for name in ("check", "check_lr", "check_train_epe"):
        orig = getattr(guard_cls, name)

        def wrapped(self, ss, *args, _orig=orig, _name=name):
            before = dict(best=self.best, stale=self.stale, disp_ref=self.disp_ref,
                          lr_ref=self.lr_ref, epe_ref=self.train_epe_ref)
            out = _orig(self, ss, *args)
            events.append((_name, [float(a) for a in args], before, out[1]))
            return out
        monkeypatch.setattr(guard_cls, name, wrapped)
    orig_transition = machine_cls.transition

    def transition(self, avg_loss):
        before = dict(prev=self.prev_loss, changed=self.ovs_did_change)
        state = orig_transition(self, avg_loss)
        events.append(("transition", [float(avg_loss)], before, state.name))
        return state
    monkeypatch.setattr(machine_cls, "transition", transition)


def _margins(event, guard):
    """Relative distances of an event's values to the thresholds its
    decision compared them with."""
    name, args, before, _ = event
    rel = lambda v, edge: abs(v - edge) / abs(edge)
    out = []
    if name == "transition":
        if np.isfinite(before["prev"]) and not before["changed"]:
            out.append(("plateau: loss vs previous", rel(args[0], before["prev"])))
    elif name == "check":
        avg, disp = args
        ref, band = before["disp_ref"], guard["ovs_guard_disp_band"]
        for edge in (ref / band, ref * band, ref / band ** 0.5, ref * band ** 0.5):
            out.append(("disparity band edge", rel(disp, edge)))
        if np.isfinite(before["best"]):
            tol = guard["ovs_guard_tolerance"]
            limits = ([before["best"] * 10.0, before["best"] * (1 + tol)] if before["stale"]
                      else [before["best"] * (1 + tol), before["best"]])
            out += [("loss limit", rel(avg, lim)) for lim in limits]
    elif name == "check_lr" and before["lr_ref"] is not None:
        out.append(("L-R limit", rel(args[0], before["lr_ref"] * guard["ovs_guard_lr_factor"])))
    elif name == "check_train_epe" and before["epe_ref"] is not None:
        out.append(("train-EPE limit", rel(args[0], before["epe_ref"] * args[1])))
    return out


def _read_csv(path):
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    return rows[0], rows[1:]


def _prefixed(variables):
    fsd, ssd = state_dicts_from_jax(variables, K)
    return {**{f"feature_net.{k}": v.numpy() for k, v in fsd.items()},
            **{f"stereo_net.{k}": v.numpy() for k, v in ssd.items()}}


def test_adapt_streaming_matches_jax(data, tmp_path, monkeypatch):
    variables = data[2]
    j_events, p_events = [], []
    _record(monkeypatch, jax_driver, j_events)
    _record(monkeypatch, port_driver, p_events)
    kw = dict(fused_er_forward=True, done_batch=2)
    ref = jax_driver.adapt_streaming(_cfg(jax_config, data, tmp_path, "jax", **GUARD),
                                     variables=variables, engine="flat", **kw)
    got = port_driver.adapt_streaming(_cfg(port_config, data, tmp_path, "port", **GUARD),
                                      variables=variables, device="cpu", **kw)
    for key in ("steps", "gradient_updates", "guard_rollbacks", "final_state"):
        print(f"{key}: JAX {ref[key]}, port {got[key]}")
        assert got[key] == ref[key], key
    assert got["steps"] == 12 and got["guard_rollbacks"] == 2 and got["gradient_updates"] > 0

    # The ring log: decisions equal, values in the band.
    n = got["steps"]
    log, ref_log = got["stream_state"].log.numpy()[:n], np.asarray(ref["stream_state"].log)[:n]
    for c in ("novel", "did_add", "do_update"):
        np.testing.assert_array_equal(log[:, COLS[c]], ref_log[:, COLS[c]], err_msg=c)
    np.testing.assert_allclose(log, ref_log, **AFTER_UPDATE_TOL)
    done_rows = (log[:, COLS["replay_loss"]] == 0).sum()
    assert done_rows >= 2  # the DONE state's (batched) done steps ran

    # Every guard and plateau decision: the same branch, values in the band,
    # and a margin to the threshold wider than the band.
    assert [(e[0], e[3]) for e in p_events] == [(e[0], e[3]) for e in j_events]
    assert {e[0] for e in p_events} == {"check", "check_lr", "check_train_epe", "transition"}
    margins = [("novelty: smoothed FCS vs ood_threshold",
                abs(1e9 - v) / 1e9) for v in log[:, COLS["fcs_smoothed"]]]
    for pe, je in zip(p_events, j_events):
        np.testing.assert_allclose(pe[1], je[1], err_msg=pe[0], **AFTER_UPDATE_TOL)
        margins += _margins(pe, GUARD)
    for what, m in margins:
        print(f"decision margin, {what}: {m:.4g}")
    assert min(m for _, m in margins) > MARGIN

    # trials.csv: the same columns and rows; counters exact, metrics in band.
    head, rows = _read_csv(tmp_path / "port" / "trials.csv")
    ref_head, ref_rows = _read_csv(tmp_path / "jax" / "trials.csv")
    assert head == ref_head and len(rows) == len(ref_rows) == 3
    for row, ref_row in zip(rows, ref_rows):
        for name, a, b in zip(head, row, ref_row):
            if name in ("trial", "step", "GRADIENT_UPDATES") or b == "":
                assert a == b, name
            else:
                np.testing.assert_allclose(float(a), float(b), err_msg=name, **AFTER_UPDATE_TOL)

    # The final checkpoint, read by the JAX package's loader.
    final = os.path.join("models", f"weights_{n}")
    mine = _prefixed(jax_load(str(tmp_path / "port" / final)))
    want = _prefixed(jax_load(str(tmp_path / "jax" / final)))
    updates = got["gradient_updates"]
    params = [k for k in want if not k.endswith(("running_mean", "running_var",
                                                 "num_batches_tracked")) and ".conv2." not in k]
    diffs = np.concatenate([np.abs(mine[k] - want[k]).ravel() for k in params])
    print(f"final weights: max {diffs.max():.3g}, median {np.median(diffs):.3g} "
          f"({updates} updates of lr {LR})")
    assert diffs.max() <= 2 * LR * updates and np.median(diffs) <= MEDIAN_PARAM_LR * LR
    for k in want:
        if k.endswith(("running_mean", "running_var")) and ".conv2." not in k:
            np.testing.assert_allclose(mine[k], want[k], atol=2 * LR * updates, rtol=1e-3,
                                       err_msg=k)


def test_resume_equals_an_uninterrupted_run(data, tmp_path):
    """Capacity 2, so the reservoir's replacement draws decide; a run cut at
    the step-6 eval and resumed from its checkpoint equals the whole run."""
    variables = data[2]
    kw = dict(ovs_buffer_size=2, ovs_validate_hz=3, val_improve_retries=99,
              ovs_guard_tolerance=0.5, eval_hz=6, skip_initial_eval=True)
    run = lambda name, steps, **extra: port_driver.adapt_streaming(
        _cfg(port_config, data, tmp_path, name, num_steps=steps, **kw), variables=variables,
        device="cpu", fused_er_forward=True, **extra)
    full = run("full", 12)
    part = run("part", 6)
    ckpt = str(tmp_path / "part" / "models" / "weights_6")
    assert os.path.exists(os.path.join(ckpt, "stream_state.msgpack"))

    # The saved stream state loads bit for bit into a fresh engine state.
    model = StereoModel(k=K, input_scale=S, maxdisp=MAXDISP, device="cpu", fused_siamese=True,
                        fused_tower=True)
    fresh = init_flat_stream_state(model, LR, 2, H, W, 512, seed=123, device="cpu")
    fresh, host, snap, _, _ = load_stream_checkpoint(ckpt, fresh)
    _assert_states_equal(fresh, part["stream_state"])
    assert host["step"] == 6 and snap is not None

    cont = run("cont", 12, resume_from=ckpt)
    a, c = full["stream_state"], cont["stream_state"]
    assert int(c.log_pos) == int(a.log_pos) == 12
    _assert_states_equal(c, a)
    assert int(a.reservoir.count) > 2  # replacements were drawn
    for key in ("steps", "gradient_updates", "guard_rollbacks", "final_state", "final_metrics"):
        assert cont[key] == full[key], key
    assert 0 < part["gradient_updates"] < full["gradient_updates"]



def test_non_finite_probe_leaves_the_lr_reference_unset(data, tmp_path, monkeypatch, capsys):
    """A non-finite pre-adaptation L-R probe leaves lr_ref None; the driver
    says so and runs on (the JAX driver fails formatting the None,
    stream_driver.py:726)."""
    nan_warp = lambda img, disp, **kw: (torch.full_like(disp, float("nan")),
                                        torch.ones_like(disp, dtype=torch.bool))
    monkeypatch.setattr(port_driver, "linear_warp", nan_warp)
    result = port_driver.adapt_streaming(
        _cfg(port_config, data, tmp_path, "nan_probe", num_steps=3, ovs_guard_lr_factor=1.5,
             skip_initial_eval=True, eval_hz=3), variables=data[2], device="cpu")
    assert result["steps"] == 3
    assert "cross-consistency nan is not finite" in capsys.readouterr().out

def _assert_states_equal(a, b):
    for f in ("params", "m", "v", "buffers"):
        for x, y in zip(getattr(a, f), getattr(b, f)):
            assert torch.equal(x, y), f
    for f in ("count", "lr", "ema_value", "ema_init", "log", "log_pos"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    for f in ("left", "right", "values", "reg_indices", "size", "count"):
        assert torch.equal(getattr(a.reservoir, f), getattr(b.reservoir, f)), f
    assert torch.equal(a.reservoir.generator.get_state(), b.reservoir.generator.get_state())


# --- the command line -------------------------------------------------------

def _args(data, tmp_path, *extra):
    train, novel, _ = data
    return ["adapt", "--model_name", "cli", "--log_dir", str(tmp_path / "logs"),
            "--dataset_path", novel, "--dataset_name", "Synthetic", "--split", "synth",
            "--height", str(H), "--width", str(W), "--stereonet_k", "3",
            "--stereonet_input_scale", "0", "--batch_size", "1", "--learning_rate", "3e-4",
            "--clip_grad_norm", "--num_steps", "4", "--eval_hz", "4", "--ovs_buffer_size", "3",
            "--ovs_validate_hz", "2", "--ood_threshold", "1e9", "--num_epochs", "1",
            "--log_frequency", "2", "--train_dataset_path", train,
            "--train_dataset_name", "Synthetic", "--train_split", "synth",
            "--num_workers", "1", *extra]


def test_cli_adapt_flat_runs_from_a_port_checkpoint(data, tmp_path, capsys):
    model = StereoModel(k=3, input_scale=0, device="cpu")
    from adaptive_stereo_tpu_torch.models import random_init_, variables_from_state_dicts

    random_init_(model, torch.Generator().manual_seed(3))
    save_variables(str(tmp_path / "w"), variables_from_state_dicts(
        model.feature_net.state_dict(), model.stereo_net.state_dict(), 3))
    rc = main(_args(data, tmp_path, "--engine", "flat", "--device", "cpu", "--done_batch", "2",
                    "--transfer_uint8", "--load_weights_folder", str(tmp_path / "w")))
    assert rc == 0
    out = capsys.readouterr().out
    assert "Done with adaptation!" in out and "EPE=" in out
    head, rows = _read_csv(tmp_path / "logs" / "cli" / "trials.csv")
    assert [r[head.index("step")] for r in rows] == ["-1", "4"]
    assert os.path.exists(tmp_path / "logs" / "cli" / "models" / "weights_4" / "state.msgpack")
    assert os.path.exists(tmp_path / "logs" / "cli" / "opt.json")


def test_cli_named_errors(data, tmp_path):
    args = lambda *extra: _args(data, tmp_path, *extra)
    with pytest.raises(SystemExit) as err:
        main(args("--adapt_mode", "BOGUS"))
    assert err.value.code == 2
    with pytest.raises(ValueError, match="needs pretrained weights"):
        main(args("--engine", "flat", "--device", "cpu"))
    with pytest.raises(FileNotFoundError, match="no checkpoint found"):
        main(args("--engine", "flat", "--device", "cpu", "--load_weights_folder",
                  str(tmp_path / "missing")))
    with pytest.raises(ValueError, match="needs pretrained weights"):
        main(args("--engine", "pytree", "--device", "cpu"))
    with pytest.raises(SystemExit, match="--ovs_guard_lr_factor require"):
        main(args("--ovs_guard_lr_factor", "1.3"))
    with pytest.raises(SystemExit, match="--resume_from requires --engine flat"):
        main(args("--resume_from", str(tmp_path)))
    with pytest.raises(SystemExit, match="--loss_dtype requires --engine flat"):
        main(args("--loss_dtype", "bfloat16"))
    with pytest.raises(ValueError, match="device_cache requires engine='flat'"):
        main(args("--engine", "pytree", "--device", "cpu", "--device_cache"))
    gated = port_config.ExperimentConfig(log_dir=str(tmp_path),
                                         adapt=port_config.AdaptConfig(gate="reconstruction"))
    with pytest.raises(ValueError, match="gate='reconstruction' requires gate_model"):
        adapt_classic(gated, variables=data[2], device="cpu")
