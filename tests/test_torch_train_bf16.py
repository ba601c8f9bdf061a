"""The bfloat16 training path against JAX, in train mode (the float32
checks of tests/test_torch_train.py do not cover the dtype that bench.py
and the training cell run).

The port and the JAX package run in bfloat16, each held against the JAX
float32 result: the port with fused_siamese=True and fused_tower=True (on
the CPU its kernel wrappers take their plain versions), JAX with
fused_siamese=True, s2d_refinement=True, pallas_tower=True, use_pallas=True
(Pallas in interpret mode), at the shapes of tests/test_torch_train.py
(32x64, k=2, maxdisp 47, batch 2, variables from flax init with the
BatchNorm leaves redrawn from a numpy seed). The two frameworks round at
different places, so the port's bfloat16 result is not held to JAX's; its
error against JAX float32 must be at most BF16_FACTOR times JAX's own
bfloat16 error (the pattern of tests/test_torch_model.py's eval-mode
check), for:
- every train-mode output (refined and coarse disparity, FCS, cost), in
  max and in mean absolute error;
- the BatchNorm running statistics after the forward, per module (feature
  net, aggregation, refinement tower), in max and in mean;
- the gradients of the adapt step's loss (Monodepth on the stream row plus
  0.05 x Khamis on the replay row of the fused ER forward), per module, in
  relative L2 (parameters whose exact gradient is 0 left out, see
  test_torch_train._structurally_zero).
JAX's own error must be nonzero for every reading, so that no band of zero
passes a check that checks nothing. Every ratio is printed (pytest -s).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from adaptive_stereo_tpu.models import StereoModel as JaxStereoModel
from adaptive_stereo_tpu.ops import khamis_robust_loss as jax_khamis
from adaptive_stereo_tpu.ops import monodepth_single_loss as jax_mono
from adaptive_stereo_tpu_torch.engine import live_parameters
from adaptive_stereo_tpu_torch.models import state_dicts_from_jax
from adaptive_stereo_tpu_torch.ops import khamis_robust_loss, monodepth_single_loss
from test_torch_train import H, K, MAXDISP, S, W, _frames, _port, _structurally_zero, _variables

BF16_FACTOR = 2.0
JAX_FLAGS = dict(fused_siamese=True, s2d_refinement=True, pallas_tower=True, use_pallas=True)
PORT_FLAGS = dict(fused_siamese=True, fused_tower=True)


def _module(name):
    """The module of a port parameter or buffer name."""
    if name.startswith("feature_net."):
        return "feature"
    if name.startswith("stereo_net.edge_aware_refinements."):
        return "tower"
    return "aggregation"


def _prefixed(fsd, ssd):
    return {**{f"feature_net.{k}": v for k, v in fsd.items()},
            **{f"stereo_net.{k}": v for k, v in ssd.items()}}


def _hold(label, port_err, jax_err, kind=("max", "mean")):
    """port_err, jax_err: absolute errors (arrays) or, with kind=("rel L2",),
    one relative error each."""
    if kind == ("rel L2",):
        readings = {"rel L2": (float(port_err), float(jax_err))}
    else:
        readings = {"max": (port_err.max(), jax_err.max()),
                    "mean": (port_err.mean(), jax_err.mean())}
    for name, (p, j) in readings.items():
        assert j > 0, (label, name)  # a band of zero would check nothing
        print(f"{label} {name}: JAX bf16 error {j:.4g}, port/JAX ratio {p / j:.3f}")
        assert p <= BF16_FACTOR * j, (label, name, p, j)


def _jax_train(variables, dtype, left, right):
    model = JaxStereoModel(k=K, input_scale=S, maxdisp=MAXDISP, dtype=dtype, **JAX_FLAGS)
    apply = jax.jit(lambda v, l, r: model.apply(v, l, r, side="l", output_cost_volume=True,
                                                 train=True, mutable=["batch_stats"]))
    out, mut = apply(variables, jnp.asarray(left), jnp.asarray(right))
    return out, {"params": variables["params"],
                 "batch_stats": jax.tree.map(np.asarray, mut["batch_stats"])}


def _running_stats(variables):
    sd = _prefixed(*state_dicts_from_jax(variables, K))
    return {n: v.numpy() for n, v in sd.items()
            if n.endswith(("running_mean", "running_var")) and ".conv2." not in n}


def _by_module(tensors):
    out = {}
    for name in sorted(tensors):
        out.setdefault(_module(name), []).append(np.asarray(tensors[name], np.float64).ravel())
    return {m: np.concatenate(v) for m, v in out.items()}


def test_bf16_train_forward_and_running_stats_within_a_factor_of_jax():
    variables = _variables(11)
    rng = np.random.RandomState(12)
    left, right = _frames(rng, 2)
    ref, ref_vars = _jax_train(variables, None, left, right)
    jbf, jbf_vars = _jax_train(variables, jnp.bfloat16, left, right)
    model = _port(variables, dtype=torch.bfloat16, **PORT_FLAGS).train()
    with torch.no_grad():
        out = model(torch.from_numpy(left), torch.from_numpy(right), side="l",
                    output_cost_volume=True)
    assert sorted(out) == sorted(ref) == sorted(jbf)
    for key in sorted(ref):
        want = np.asarray(ref[key], np.float32)
        _hold(f"output {key}", np.abs(out[key].float().numpy() - want),
              np.abs(np.asarray(jbf[key], np.float32) - want))

    want = _by_module(_running_stats(ref_vars))
    got = _by_module({n: b.numpy() for n, b in model.named_buffers()
                      if n.endswith(("running_mean", "running_var")) and ".conv2." not in n})
    jax_bf16 = _by_module(_running_stats(jbf_vars))
    assert sorted(want) == sorted(got) == ["aggregation", "feature", "tower"]
    for module in sorted(want):
        _hold(f"running statistics, {module}", np.abs(got[module] - want[module]),
              np.abs(jax_bf16[module] - want[module]))


def _jax_grads(variables, dtype, left, right, gt):
    model = JaxStereoModel(k=K, input_scale=S, maxdisp=MAXDISP, dtype=dtype, **JAX_FLAGS)
    jl, jr = jnp.asarray(left), jnp.asarray(right)

    def loss(params):
        out, _ = model.apply({"params": params, "batch_stats": variables["batch_stats"]},
                             jl, jr, side="l", output_cost_volume=True, train=True,
                             mutable=["batch_stats"])
        pred = out[f"pred_disp_l/{S}"]
        mono, _ = jax_mono(jl[:1], jr[:1], pred[:1], 1e-3, max_disp=MAXDISP)
        return mono.astype(jnp.float32) + 0.05 * jax_khamis(pred[1:], jnp.asarray(gt))

    grads = jax.jit(jax.grad(loss))(variables["params"])
    zeros = jax.tree.map(np.zeros_like, variables["batch_stats"])
    return _prefixed(*state_dicts_from_jax(
        {"params": jax.tree.map(np.asarray, grads), "batch_stats": zeros}, K))


def test_bf16_loss_gradients_within_a_factor_of_jax():
    variables = _variables(13)
    rng = np.random.RandomState(14)
    left, right = _frames(rng, 2)
    gt = (rng.rand(1, H, W, 1) * 30).astype(np.float32)
    ref = _jax_grads(variables, None, left, right, gt)
    jbf = _jax_grads(variables, jnp.bfloat16, left, right, gt)

    model = _port(variables, dtype=torch.bfloat16, **PORT_FLAGS).train()
    t = torch.from_numpy
    out = model(t(left), t(right), side="l", output_cost_volume=True)
    pred = out[f"pred_disp_l/{S}"]
    mono, _ = monodepth_single_loss(t(left[:1]), t(right[:1]), pred[:1], 1e-3, max_disp=MAXDISP)
    loss = mono.float() + 0.05 * khamis_robust_loss(pred[1:], t(gt))
    assert mono.item() > 0
    loss.backward()
    named = dict(model.named_parameters())
    live = [n for n, p in named.items() if any(p is q for q in live_parameters(model))
            and not _structurally_zero(n)]
    want = _by_module({n: ref[n].numpy() for n in live})
    got = _by_module({n: named[n].grad.float().numpy() for n in live})
    jax_bf16 = _by_module({n: jbf[n].numpy() for n in live})
    assert sorted(want) == ["aggregation", "feature", "tower"]
    for module in sorted(want):
        norm = np.linalg.norm(want[module])
        _hold(f"loss gradient, {module}", np.linalg.norm(got[module] - want[module]) / norm,
              np.linalg.norm(jax_bf16[module] - want[module]) / norm, kind=("rel L2",))
