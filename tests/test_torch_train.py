"""The training slice of the port against the JAX package, float32 on both
sides, at 32x64 with numpy inputs from a seed:

- the train-mode forward of StereoModel (outputs and the updated BatchNorm
  running statistics), on the plain module path, with fused_siamese, and
  with the refinement tower (JAX: pallas_tower=True, s2d_refinement=True,
  the Pallas kernels in interpret mode);
- one loss.backward() against jax.grad, parameter by parameter (the JAX
  gradients carried into the port's layout by state_dicts_from_jax);
- a chain of adapt_steps of engine/flat_stream.py with bench.py's options,
  then done_step and validate_step, against the JAX flat engine.

The JAX variables come from flax init with every BatchNorm scale, bias and
running statistic redrawn from a numpy seed (tests/test_torch_model.py).
maxdisp is 47 (D = 12 at k = 2): with the default 192, flax's random init
predicts disparities past the 64-pixel width, the warp mask is empty and
the Monodepth loss is 0, which would check nothing.

Tolerances: outputs 2e-3 absolute + 1e-4 relative (tests/test_torch_model.py);
running statistics 1e-5 absolute + 1e-4 relative.

Gradients: per tensor, |g - g_jax|_2 <= 2e-2 |g_jax|_2 (measured at most
7.4e-3). On a batch this small a LeakyReLU whose pre-activation is ~1e-7
takes its branch by float32 rounding, and through the batch statistics the
flip moves every gradient of its channel and of the layers below by ~1e-3
relative; a wrong term of a formula moves them by O(1). Parameters whose
exact gradient is 0 (see _structurally_zero) are held to |g| <= 1e-5 of the
largest gradient on both sides.

The chain: the decisions (novel, did_add, do_update) equal; the log rows up
to the first applied update 1e-5 absolute and relative, later rows and the
reservoir values 1e-4 absolute + 2e-3 relative (measured <= 4.5e-4): Adam's
first step moves every parameter by about lr whatever its gradient's size,
so an entry whose gradient is rounding noise (~1e-9) steps by +-lr with a
sign each framework rounds its own way. After the first update the
parameters agree but for such entries (median difference 0, max 2 lr), and
the later steps start from those slightly different models: the parameters
are held within 2 lr per applied update, with a median difference below
0.1 lr (measured 0.023 lr after three updates). The running statistics
after the chain: 2 lr per applied update absolute + 1e-3 relative (the
batch mean includes the conv bias in front of the BatchNorm, one of those
zero-gradient entries, and the variance moves with the weights; measured
5.7e-5 absolute and 1.7e-4 relative after three updates).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaptive_stereo_tpu.engine.flat_stream import (
    flat_state_to_variables,
    init_flat_stream_state as jax_init_state,
    make_flat_streaming_steps as jax_make_steps,
)
from adaptive_stereo_tpu.models import StereoModel as JaxStereoModel
from adaptive_stereo_tpu.ops import khamis_robust_loss as jax_khamis
from adaptive_stereo_tpu.ops import monodepth_single_loss as jax_mono
from adaptive_stereo_tpu_torch.engine import (
    LOG_COLS,
    init_flat_stream_state,
    live_parameters,
    make_flat_streaming_steps,
)
from adaptive_stereo_tpu_torch.models import StereoModel, state_dicts_from_jax
from adaptive_stereo_tpu_torch.ops import khamis_robust_loss, monodepth_single_loss

K, S, H, W, MAXDISP = 2, 0, 32, 64, 47
OUT_TOL = dict(atol=2e-3, rtol=1e-4)
STATS_TOL = dict(atol=1e-5, rtol=1e-4)
LOG_TOL = dict(atol=1e-5, rtol=1e-5)
AFTER_UPDATE_TOL = dict(atol=1e-4, rtol=2e-3)
LR = 5e-5
MEDIAN_PARAM_LR = 0.1
GRAD_REL_L2 = 2e-2


def _randomize_bn(tree, rng, path=()):
    out = {}
    for key, v in tree.items():
        if isinstance(v, dict):
            out[key] = _randomize_bn(v, rng, path + (key,))
            continue
        v = np.asarray(v)
        if "bn" in path and key in ("scale", "var"):
            v = rng.uniform(0.9, 1.1, v.shape).astype(np.float32)
        elif "bn" in path and key in ("bias", "mean"):
            v = rng.uniform(-0.1, 0.1, v.shape).astype(np.float32)
        out[key] = v
    return out


def _frames(rng, n=1):
    return [rng.rand(n, H, W, 3).astype(np.float32) for _ in range(2)]


def _variables(seed=0):
    rng = np.random.RandomState(seed)
    left, right = _frames(rng)
    model = JaxStereoModel(k=K, input_scale=S, maxdisp=MAXDISP)
    variables = model.init(jax.random.PRNGKey(seed), jnp.asarray(left), jnp.asarray(right),
                           train=False)
    return _randomize_bn(jax.tree.map(np.asarray, dict(variables)), rng)


def _port(variables, **kw):
    model = StereoModel(k=K, input_scale=S, maxdisp=MAXDISP, device="cpu", **kw)
    return model.load_state_dicts(*state_dicts_from_jax(variables, K))


def _assert_running_stats(model, variables, tol=STATS_TOL):
    fsd, ssd = state_dicts_from_jax(variables, K)
    mine = {**{f"feature_net.{k}": v for k, v in fsd.items()},
            **{f"stereo_net.{k}": v for k, v in ssd.items()}}
    got = model.state_dict()
    names = [n for n in mine if n.endswith(("running_mean", "running_var"))
             and ".conv2." not in n]
    assert len(names) == 2 * (6 + 4 + 7)
    for n in names:
        np.testing.assert_allclose(got[n].numpy(), mine[n].numpy(), err_msg=n, **tol)


JAX_TRAIN_CONFIGS = {
    "plain": (dict(), dict()),
    "fused_siamese": (dict(fused_siamese=True), dict(fused_siamese=True)),
    "tower": (dict(fused_siamese=True, s2d_refinement=True, pallas_tower=True),
              dict(fused_siamese=True, fused_tower=True)),
}


@pytest.mark.parametrize("config", sorted(JAX_TRAIN_CONFIGS))
def test_train_forward_and_running_stats_match_jax(config):
    jax_kw, port_kw = JAX_TRAIN_CONFIGS[config]
    variables = _variables(1)
    rng = np.random.RandomState(2)
    left, right = _frames(rng, 2)
    jmodel = JaxStereoModel(k=K, input_scale=S, maxdisp=MAXDISP, **jax_kw)
    ref, mut = jmodel.apply(variables, jnp.asarray(left), jnp.asarray(right), side="l",
                            output_cost_volume=True, train=True, mutable=["batch_stats"])
    model = _port(variables, **port_kw).train()
    out = model(torch.from_numpy(left), torch.from_numpy(right), side="l",
                output_cost_volume=True)
    for key in ref:
        np.testing.assert_allclose(out[key].detach().numpy(), np.asarray(ref[key]),
                                   err_msg=key, **OUT_TOL)
    new_vars = {"params": variables["params"],
                "batch_stats": jax.tree.map(np.asarray, mut["batch_stats"])}
    _assert_running_stats(model, new_vars)


def _loss_jax(jmodel, left, right, gt):
    def fn(params, stats):
        out, _ = jmodel.apply({"params": params, "batch_stats": stats}, left, right, side="l",
                              output_cost_volume=True, train=True, mutable=["batch_stats"])
        pred = out[f"pred_disp_l/{S}"]
        mono, _ = jax_mono(left[:1], right[:1], pred[:1], 1e-3, max_disp=MAXDISP)
        return mono + 0.05 * jax_khamis(pred[1:], gt)
    return fn


def test_loss_gradients_match_jax():
    """The adapt step's loss (Monodepth on the first row, 0.05 x Khamis on
    the second) with bench.py's model options; the port with the tower."""
    variables = _variables(3)
    rng = np.random.RandomState(4)
    left, right = _frames(rng, 2)
    gt = (rng.rand(1, H, W, 1) * 30).astype(np.float32)
    jmodel = JaxStereoModel(k=K, input_scale=S, maxdisp=MAXDISP, fused_siamese=True,
                            s2d_refinement=True)
    fn = _loss_jax(jmodel, jnp.asarray(left), jnp.asarray(right), jnp.asarray(gt))
    loss_ref, grads = jax.value_and_grad(fn)(variables["params"], variables["batch_stats"])
    zeros = jax.tree.map(np.zeros_like, variables["batch_stats"])
    g_feat, g_stereo = state_dicts_from_jax(
        {"params": jax.tree.map(np.asarray, grads), "batch_stats": zeros}, K)

    model = _port(variables, fused_siamese=True, fused_tower=True).train()
    out = model(torch.from_numpy(left), torch.from_numpy(right), side="l",
                output_cost_volume=True)
    pred = out[f"pred_disp_l/{S}"]
    mono, _ = monodepth_single_loss(torch.from_numpy(left[:1]), torch.from_numpy(right[:1]),
                                    pred[:1], 1e-3, max_disp=MAXDISP)
    loss = mono + 0.05 * khamis_robust_loss(pred[1:], torch.from_numpy(gt))
    loss.backward()
    assert mono.item() > 0
    np.testing.assert_allclose(loss.item(), float(loss_ref), atol=1e-5, rtol=1e-5)
    want = {**{f"feature_net.{k}": v for k, v in g_feat.items()},
            **{f"stereo_net.{k}": v for k, v in g_stereo.items()}}
    named = dict(model.named_parameters())
    live = {n for n, p in named.items() if any(p is q for q in live_parameters(model))}
    assert len(live) == 2 * (K + 6 * 2 + 1) + 2 * (4 * 2 + 1 + 7 * 2 + 1)
    gmax = max(np.abs(want[n].numpy()).max() for n in live)
    for name in sorted(live):
        g, w = named[name].grad.numpy(), want[name].numpy()
        if _structurally_zero(name):
            assert np.abs(g).max() <= 1e-5 * gmax and np.abs(w).max() <= 1e-5 * gmax, name
            continue
        rel = np.linalg.norm(g - w) / np.linalg.norm(w)
        assert rel <= GRAD_REL_L2, (name, rel)


def _structurally_zero(name):
    """Parameters whose exact gradient is 0 in train mode: conv biases in
    front of a batch-statistics BatchNorm, the feature tower's last bias
    (it cancels in the difference cost volume) and the last aggregation
    bias (a constant shift of the softmax's input)."""
    return (name.endswith(".0.0.bias") or name in ("feature_net.conv_alone.bias",
                                                   "stereo_net.conv3d_alone.bias"))


def _jax_engine(variables, seed, fused_er):
    model = JaxStereoModel(k=K, input_scale=S, maxdisp=MAXDISP, fused_siamese=True,
                           s2d_refinement=True)
    ss, spec = jax_init_state(variables["params"], variables["batch_stats"], LR, 16, H, W, 64,
                              seed=seed)
    steps = jax_make_steps(model, spec, S, K, use_er=True, use_vs=True, ood_threshold=12.76,
                           clip_grad_norm=True, fused_er_forward=fused_er,
                           warp_precision="highest")
    return ss, spec, steps


@pytest.mark.parametrize("fused_er", [True, False])
def test_adapt_chain_done_and_validate_match_jax(fused_er):
    """bench.py's options (use_er, use_vs, ood_threshold 12.76, clip,
    fused ER forward, fused siamese, lr 5e-5, capacity 16, log chunk 64) on
    5 adapt steps whose frame indices repeat, then a done step and a
    validation; and the same with the replay frame in a forward of its own
    (fused_er_forward=False). The reservoir stays below capacity, so no
    random draw decides anything."""
    variables = _variables(5)
    rng = np.random.RandomState(6)
    frames = [_frames(rng) for _ in range(3)]
    er_left, er_right = _frames(rng)
    gt = (rng.rand(1, H, W, 1) * 30).astype(np.float32)
    indices = [0, 0, 1, 1, 0]

    jss, spec, (j_adapt, j_done, j_validate, _) = _jax_engine(variables, 0, fused_er)
    model = _port(variables, fused_siamese=True, fused_tower=True)
    ss = init_flat_stream_state(model, LR, 16, H, W, 64, seed=0, device="cpu")
    adapt, done, validate, _ = make_flat_streaming_steps(
        model, S, K, use_er=True, use_vs=True, ood_threshold=12.76, clip_grad_norm=True,
        fused_er_forward=fused_er)
    t = torch.from_numpy
    for step, idx in enumerate(indices):
        left, right = frames[idx]
        jss = j_adapt(jss, *map(jnp.asarray, (left, right, gt, er_left, er_right, gt)),
                      jnp.asarray(idx, jnp.int32))
        ss = adapt(ss, t(left), t(right), t(gt), t(er_left), t(er_right), t(gt), idx)
    left, right = frames[2]
    jss = j_done(jss, *map(jnp.asarray, (left, right, gt)), jnp.asarray(2, jnp.int32))
    ss = done(ss, t(left), t(right), t(gt), 2)
    jss, j_avg, j_size, j_disp = j_validate(jss)
    ss, avg, size, mean_disp = validate(ss)

    n = len(indices) + 1
    ref_log, log = np.asarray(jss.log)[:n], ss.log.numpy()[:n]
    cols = {c: i for i, c in enumerate(LOG_COLS)}
    print("JAX log:\n", ref_log, "\nport log:\n", log)
    for c in ("novel", "did_add", "do_update"):
        np.testing.assert_array_equal(log[:, cols[c]], ref_log[:, cols[c]], err_msg=c)
    first = list(log[:, cols["do_update"]]).index(1.0)
    np.testing.assert_allclose(log[:first + 1], ref_log[:first + 1], **LOG_TOL)
    np.testing.assert_allclose(log[first + 1:], ref_log[first + 1:], **AFTER_UPDATE_TOL)
    assert (log[:len(indices), cols["mono_loss"]] > 0).all()
    updates = int(log[:, cols["do_update"]].sum())
    assert 1 <= updates < len(indices)
    assert int(ss.count) == int(jss.count) == updates
    assert int(size) == int(j_size) == int(ss.reservoir.size) < 16
    np.testing.assert_array_equal(ss.reservoir.reg_indices.numpy(),
                                  np.asarray(jss.reservoir.reg_indices))
    np.testing.assert_allclose(float(avg), float(j_avg), **AFTER_UPDATE_TOL)
    np.testing.assert_allclose(ss.reservoir.values.numpy(), np.asarray(jss.reservoir.values),
                               **AFTER_UPDATE_TOL)
    np.testing.assert_allclose(float(mean_disp), float(j_disp), **AFTER_UPDATE_TOL)

    new_vars = jax.tree.map(np.asarray, flat_state_to_variables(jss, spec))
    fsd, ssd = state_dicts_from_jax(new_vars, K)
    want = {**{f"feature_net.{k}": v for k, v in fsd.items()},
            **{f"stereo_net.{k}": v for k, v in ssd.items()}}
    named = dict(model.named_parameters())
    diffs = np.concatenate([np.abs(p.detach().numpy() - want[n].numpy()).ravel()
                            for n, p in named.items() if ".conv2." not in n])
    moved = np.concatenate([np.abs(want[n].numpy() - before).ravel() for n, before in (
        (n, v.numpy()) for n, v in {**{f"feature_net.{k}": v for k, v in state_dicts_from_jax(
            variables, K)[0].items()}, **{f"stereo_net.{k}": v for k, v in state_dicts_from_jax(
                variables, K)[1].items()}}.items()) if n in named and ".conv2." not in n])
    print(f"parameters moved up to {moved.max():.3g}; port vs JAX max {diffs.max():.3g}, "
          f"median {np.median(diffs):.3g}")
    assert moved.max() > 0.5 * LR
    assert diffs.max() <= 2 * LR * updates
    assert np.median(diffs) <= MEDIAN_PARAM_LR * LR
    _assert_running_stats(model, new_vars, dict(atol=2 * LR * updates, rtol=1e-3))
