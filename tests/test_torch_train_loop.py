"""The supervised training slice of the port against the JAX package, on
the CPU in float32 at 32x64, k=2, maxdisp 47 (tests/test_torch_train.py's
model, JAX variables with redrawn BatchNorm statistics carried across):

- make_train_step, with and without train_bn, over 3 steps from the same
  variables and batches: the losses of every step, then the whole train
  state through each package's save_checkpoint (step and counts exact,
  parameters, BatchNorm statistics and Adam moments in the bands below);
- one step's gradients of both packages against a float64 run of the
  port;
- train() against JAX train() on one synthetic dataset with random crops
  (40x80 images cut to 32x64), flips and a shuffled loader (num_workers=0,
  so the draws come in index order): every log point's metrics and losses,
  the step count, the halved learning rate, the checkpoint folders and the
  final weights.

The train steps run at lr 1e-5. Adam's first steps move every entry whose
gradient is rounding noise by +-lr, each framework its own way, and the
feature net's train-mode gradients are sensitive to those moves: at lr
1e-4 its Adam moments differed by 1.5-2 % after 3 steps, at 1e-5 by 1.4e-3,
the rounding level (test_train_gradients_against_float64: at one step both
packages' float32 gradients lie about 1e-3 from a float64 run of the port).

Bands (tests/test_torch_train.py's, whose docstring gives the reasons):
losses of the first step LOG_TOL (1e-5), later ones and the eval metrics
AFTER_UPDATE_TOL (1e-4 + 2e-3 relative); parameters within 2 lr per update
with a median under 0.1 lr; running statistics 2 lr per update absolute +
1e-3 relative. Adam moments per tensor in relative L2: the first moment
within GRAD_REL_L2 (2e-2, the gradients' band), the second within twice
that (it is quadratic in the gradient); tensors whose exact gradient is 0
(test_torch_train._structurally_zero) are held to 1e-5 of the largest
moment on both sides.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import adaptive_stereo_tpu.engine.config as jax_config
import adaptive_stereo_tpu.utils.logging_utils as jax_logging
import adaptive_stereo_tpu_torch.engine.config as port_config
import adaptive_stereo_tpu_torch.utils.logging_utils as port_logging
from adaptive_stereo_tpu.engine.checkpoint import save_checkpoint as jax_save_checkpoint
from adaptive_stereo_tpu.engine.state import create_train_state as jax_create_state
from adaptive_stereo_tpu.engine.steps import make_train_step as jax_make_train_step
from adaptive_stereo_tpu.engine.train import train as jax_train
from adaptive_stereo_tpu.models import StereoModel as JaxStereoModel
from adaptive_stereo_tpu.ops import khamis_robust_loss_multiscale as jax_khamis_multiscale
from adaptive_stereo_tpu_torch.data import generate_synthetic_dataset
from adaptive_stereo_tpu_torch.engine import (create_train_state, make_train_step,
                                              save_checkpoint, train)
from adaptive_stereo_tpu_torch.engine.checkpoint import unpackb
from adaptive_stereo_tpu_torch.models import StereoModel, state_dicts_from_jax
from adaptive_stereo_tpu_torch.ops import khamis_robust_loss_multiscale
from test_torch_train import (AFTER_UPDATE_TOL, GRAD_REL_L2, LOG_TOL, MEDIAN_PARAM_LR,
                              _structurally_zero, _variables)

H, W, K, S, MAXDISP = 32, 64, 2, 0, 47
LR = 1e-4
STEP_LR = 1e-5
SCALES = [S, S + K]
# Zero-gradient parameters of eval-mode BatchNorm (the conv biases in front
# of a BatchNorm get gradients there).
EVAL_ZERO = ("feature_net.conv_alone.bias", "stereo_net.conv3d_alone.bias")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads (see tests/test_torch_driver.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _read(folder):
    with open(os.path.join(folder, "state.msgpack"), "rb") as f:
        return unpackb(f.read())


def _named(params, batch_stats):
    """Port-named numpy tensors of a JAX-layout params tree."""
    fsd, ssd = state_dicts_from_jax({"params": params, "batch_stats": batch_stats}, K)
    return {**{f"feature_net.{k}": v.numpy() for k, v in fsd.items()},
            **{f"stereo_net.{k}": v.numpy() for k, v in ssd.items()}}


def _live(named):
    return [n for n in named if ".conv2." not in n
            and not n.endswith(("running_mean", "running_var", "num_batches_tracked"))]


def assert_weights_close(mine, want, updates, lr):
    """Parameters and running statistics of two JAX-layout checkpoint trees."""
    a, b = (_named(t["params"], t["batch_stats"]) for t in (mine, want))
    diffs = np.concatenate([np.abs(a[n] - b[n]).ravel() for n in _live(b)])
    print(f"parameters after {updates} updates: max {diffs.max():.3g}, median "
          f"{np.median(diffs):.3g} (lr {lr})")
    assert diffs.max() <= 2 * lr * updates and np.median(diffs) <= MEDIAN_PARAM_LR * lr
    for n in b:
        if n.endswith(("running_mean", "running_var")) and ".conv2." not in n:
            np.testing.assert_allclose(a[n], b[n], atol=2 * lr * updates, rtol=1e-3, err_msg=n)


def assert_states_close(mine, want, updates, lr, zero=_structurally_zero):
    """Two train-state checkpoint trees: step and counts exact, weights and
    Adam moments in their bands."""
    assert int(mine["step"]) == int(want["step"])
    for tree in (mine, want):
        opt = tree["opt_state"]
        assert int(opt["count"]) == int(opt["inner_state"]["0"]["count"]) == updates
    np.testing.assert_array_equal(mine["opt_state"]["hyperparams"]["learning_rate"],
                                  want["opt_state"]["hyperparams"]["learning_rate"])
    assert_weights_close(mine, want, updates, lr)
    for moment, band in (("mu", GRAD_REL_L2), ("nu", 2 * GRAD_REL_L2)):
        a, b = (_named(t["opt_state"]["inner_state"]["0"][moment], t["batch_stats"])
                for t in (mine, want))
        top = max(np.abs(b[n]).max() for n in _live(b))
        worst = 0.0
        for n in _live(b):
            if zero(n):
                assert np.abs(a[n]).max() <= 1e-5 * top and np.abs(b[n]).max() <= 1e-5 * top, n
                continue
            rel = np.linalg.norm(a[n] - b[n]) / np.linalg.norm(b[n])
            worst = max(worst, rel)
            assert rel <= band, (moment, n, rel)
        print(f"Adam {moment}: largest relative L2 difference {worst:.3g} (band {band})")


@pytest.mark.parametrize("train_bn", [True, False])
def test_train_step_matches_jax(train_bn, tmp_path):
    variables = _variables(7)
    rng = np.random.RandomState(8)
    batches = [{f"color_l/{S}": rng.rand(2, H, W, 3).astype(np.float32),
                f"color_r/{S}": rng.rand(2, H, W, 3).astype(np.float32),
                f"gt_disp_l/{S}": (rng.rand(2, H, W, 1) * 30).astype(np.float32)}
               for _ in range(3)]

    jmodel = JaxStereoModel(k=K, input_scale=S, maxdisp=MAXDISP)
    x = jnp.zeros((1, H, W, 3))
    jstate = jax_create_state(jmodel, jax.random.PRNGKey(0), x, x, STEP_LR,
                              variables=variables)
    j_step = jax_make_train_step(jmodel, jstate.tx, S, SCALES, True, train_bn=train_bn)
    model = StereoModel(k=K, input_scale=S, maxdisp=MAXDISP, device="cpu")
    state = create_train_state(model, None, STEP_LR, variables=variables)
    step = make_train_step(model, S, SCALES, True, train_bn=train_bn)

    for i, batch in enumerate(batches):
        jstate, j_losses = j_step(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        state, losses = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
        assert sorted(losses) == sorted(j_losses)
        for name in losses:
            print(f"step {i} {name}: port {float(losses[name]):.6g}, JAX "
                  f"{float(j_losses[name]):.6g}")
            np.testing.assert_allclose(float(losses[name]), float(j_losses[name]),
                                       err_msg=name, **(LOG_TOL if i == 0 else AFTER_UPDATE_TOL))
    mine = _read(save_checkpoint(str(tmp_path / "port"), state, 3))
    want = _read(jax_save_checkpoint(str(tmp_path / "jax"), jstate, 3))
    assert_states_close(mine, want, 3, STEP_LR,
                        zero=_structurally_zero if train_bn else (lambda n: n in EVAL_ZERO))
    if not train_bn:  # eval-mode BatchNorm leaves the running statistics alone
        fresh = create_train_state(StereoModel(k=K, input_scale=S, maxdisp=MAXDISP,
                                               device="cpu"), None, variables=variables)
        assert all(torch.equal(a, b) for a, b in zip(state.buffers, fresh.buffers))


def test_train_gradients_against_float64():
    """One step's gradients of the multiscale Khamis loss in train mode, in
    float32 by both packages, each against the port in float64: per module
    (feature net, aggregation, refinement) the port's relative L2 error is
    at most twice JAX's own (tests/test_torch_train_bf16.py's rule)."""
    variables = _variables(7)
    rng = np.random.RandomState(8)
    batch = {f"color_l/{S}": rng.rand(2, H, W, 3).astype(np.float32),
             f"color_r/{S}": rng.rand(2, H, W, 3).astype(np.float32),
             f"gt_disp_l/{S}": (rng.rand(2, H, W, 1) * 30).astype(np.float32)}
    jmodel = JaxStereoModel(k=K, input_scale=S, maxdisp=MAXDISP)

    def jax_loss(params):
        out, _ = jmodel.apply({"params": params, "batch_stats": variables["batch_stats"]},
                              jnp.asarray(batch[f"color_l/{S}"]),
                              jnp.asarray(batch[f"color_r/{S}"]), side="l", train=True,
                              mutable=["batch_stats"])
        return jax_khamis_multiscale({k: jnp.asarray(v) for k, v in batch.items()}, out,
                                     scales=SCALES)["total_loss"]

    grads = jax.tree.map(np.asarray, jax.grad(jax_loss)(variables["params"]))
    want = _named(grads, variables["batch_stats"])

    def port_grads(dtype):
        model = StereoModel(k=K, input_scale=S, maxdisp=MAXDISP, device="cpu")
        model.load_state_dicts(*state_dicts_from_jax(variables, K))
        model = model.to(dtype).train()
        b = {k: torch.from_numpy(v).to(dtype) for k, v in batch.items()}
        out = model(b[f"color_l/{S}"], b[f"color_r/{S}"], side="l")
        khamis_robust_loss_multiscale(b, out, scales=SCALES)["total_loss"].backward()
        return {n: p.grad.double().numpy() for n, p in model.named_parameters()
                if p.grad is not None}

    f32, f64 = port_grads(torch.float32), port_grads(torch.float64)
    modules = {"feature": "feature_net.", "aggregation": ("stereo_net.filter.",
                                                          "stereo_net.conv3d_alone."),
               "refinement": "stereo_net.edge_aware_refinements."}
    for module, prefix in modules.items():
        names = [n for n in f64 if n.startswith(prefix) and not _structurally_zero(n)]
        cat = lambda d: np.concatenate([np.asarray(d[n], np.float64).ravel() for n in names])
        ref = cat(f64)
        err = lambda g: np.linalg.norm(cat(g) - ref) / np.linalg.norm(ref)
        mine, theirs = err(f32), err(want)
        print(f"{module}: port float32 vs float64 {mine:.3g}, JAX float32 vs float64 "
              f"{theirs:.3g}")
        assert theirs > 0 and mine <= 2 * theirs, module


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("train_loop") / "train")
    generate_synthetic_dataset(root, name="synth", num_train=6, num_val=2, height=40,
                               width=80, max_disp=12.0, seed=3)
    return root


def _train_cfg(mod, root, log_dir, name):
    return mod.ExperimentConfig(
        model_name=name, log_dir=str(log_dir), num_epochs=3, log_frequency=1, save_freq=1,
        model=mod.ModelConfig(k=K, input_scale=S, maxdisp=MAXDISP),
        optim=mod.OptimConfig(learning_rate=LR, scheduler_step_size=1, clip_grad_norm=True),
        data=mod.DataConfig(dataset_path=root, dataset_name="Synthetic", split="synth",
                            height=H, width=W, batch_size=2, do_hflip=True, num_workers=0))


def test_train_matches_jax(dataset, tmp_path, monkeypatch):
    points = {"jax": [], "port": []}
    for name, mod in (("jax", jax_logging), ("port", port_logging)):
        def record(self, metrics, losses, examples_per_sec, epoch, step, _name=name):
            points[_name].append((epoch, step, dict(metrics), dict(losses)))
        monkeypatch.setattr(mod.MetricsWriter, "log_scalars", record)
    variables = _variables(9)
    ref = jax_train(_train_cfg(jax_config, dataset, tmp_path, "jax"), variables=variables)
    got = train(_train_cfg(port_config, dataset, tmp_path, "port"), variables=variables,
                device="cpu")

    assert got["steps"] == ref["steps"] == 3 * 3
    assert got["state"].learning_rate == ref["state"].learning_rate == np.float32(LR / 8)
    assert [p[:2] for p in points["port"]] == [p[:2] for p in points["jax"]]
    assert len(points["port"]) == 9
    for (epoch, step, metrics, losses), (_, _, ref_metrics, ref_losses) in zip(
            points["port"], points["jax"]):
        assert sorted(metrics) == sorted(ref_metrics) and sorted(losses) == sorted(ref_losses)
        for name in ref_metrics:
            np.testing.assert_allclose(metrics[name], ref_metrics[name], err_msg=name,
                                       **AFTER_UPDATE_TOL)
        for name in ref_losses:
            np.testing.assert_allclose(losses[name], ref_losses[name], err_msg=name,
                                       **(LOG_TOL if step == 0 else AFTER_UPDATE_TOL))
        print(f"epoch {epoch} step {step}: EPE port {metrics['EPE']:.5f} JAX "
              f"{ref_metrics['EPE']:.5f}; loss port {losses['total_loss']:.5f} JAX "
              f"{ref_losses['total_loss']:.5f}")
    folders = {name: sorted(os.listdir(tmp_path / name / "models")) for name in ("jax", "port")}
    assert folders["port"] == folders["jax"] == ["weights_1", "weights_2"]
    mine = _read(str(tmp_path / "port" / "models" / "weights_2"))
    want = _read(str(tmp_path / "jax" / "models" / "weights_2"))
    assert int(mine["step"]) == int(want["step"]) == 9
    assert_weights_close(mine, want, 9, LR)
