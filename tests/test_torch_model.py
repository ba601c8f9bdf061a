"""The port's eval-mode StereoModel vs the JAX StereoModel with
use_pallas=True, pallas_aggregation=True (Pallas kernels in interpreter
mode on the CPU), float32 on both sides; the fused coarse head against
JAX's StereoModel(fused_coarse_head=True); and both in bfloat16.

The JAX variables come from flax init with every BatchNorm scale, bias and
running statistic redrawn from a numpy seed (so the normalisation is not an
identity); state_dicts_from_jax carries them into the port.

Tolerance: 2e-3 absolute, 1e-4 relative on every output, the band
tests/test_model_parity.py uses for the JAX model against the reference
torch model (disparities are O(10-100) px after the 2^k and W/w scalings).

bfloat16: the two frameworks round at different places, so the port's
bfloat16 output is not held to JAX's bfloat16 output. Both are held to the
JAX float32 output instead: the port's bfloat16 error, in max and in mean
absolute error, is at most BF16_FACTOR times JAX's own bfloat16 error. On
these inputs the port's error measured 0.91-1.12 times JAX's, in max and in
mean, for every output at k=3 and k=4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaptive_stereo_tpu.models import StereoModel as JaxStereoModel
from adaptive_stereo_tpu.models.torch_import import (
    export_feature_net_state_dict,
    export_stereo_net_state_dict,
)
from adaptive_stereo_tpu_torch.models import (
    StereoModel,
    coarse_num_disparities,
    random_init_,
    state_dicts_from_jax,
)

MODEL_TOL = dict(atol=2e-3, rtol=1e-4)
BF16_FACTOR = 2.0


def _randomize_bn(tree, rng, path=()):
    """Redraw BatchNorm scale/bias/mean/var leaves of a flax variable tree."""
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


def _jax_setup(k, s, h, w, seed=0):
    rng = np.random.RandomState(seed)
    left = rng.rand(1, h, w, 3).astype(np.float32)
    right = rng.rand(1, h, w, 3).astype(np.float32)
    model = JaxStereoModel(k=k, input_scale=s, use_pallas=True, pallas_aggregation=True)
    variables = model.init(jax.random.PRNGKey(seed), jnp.asarray(left),
                           jnp.asarray(right), train=False)
    variables = _randomize_bn(jax.tree.map(np.asarray, dict(variables)), rng)
    return model, variables, left, right


@pytest.mark.parametrize("k,s,h,w,d_covers_width", [
    (3, 1, 64, 128, False),
    (4, 0, 64, 256, False),
    (4, 0, 64, 128, True),  # coarse width 8 <= D = 12
])
def test_eval_forward_matches_jax_pallas_model(k, s, h, w, d_covers_width):
    jmodel, variables, left, right = _jax_setup(k, s, h, w)
    ref = jmodel.apply(variables, jnp.asarray(left), jnp.asarray(right),
                       side="l", train=False)

    model = StereoModel(k=k, input_scale=s, device="cpu")
    model.load_state_dicts(*state_dicts_from_jax(variables, k)).eval()
    with torch.no_grad():
        out = model(torch.from_numpy(left), torch.from_numpy(right), side="l")

    coarse = s + k
    assert sorted(out) == sorted(ref) == sorted(
        [f"pred_disp_l/{coarse}", f"pred_disp_l/{s}", f"fcs_l/{coarse}"])
    assert (coarse_num_disparities(192, s, k) >= w // 2 ** k) == d_covers_width
    for key in ref:
        assert tuple(out[key].shape) == tuple(ref[key].shape), key
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]),
                                   err_msg=key, **MODEL_TOL)


def _port_model(variables, k, s, **kw):
    model = StereoModel(k=k, input_scale=s, device="cpu", **kw)
    return model.load_state_dicts(*state_dicts_from_jax(variables, k)).eval()


def _run_port(model, left, right, **kw):
    with torch.no_grad():
        return model(torch.from_numpy(left), torch.from_numpy(right), side="l", **kw)


@pytest.mark.parametrize("k,s,h,w", [(3, 1, 64, 128), (4, 0, 64, 256)])
def test_fused_coarse_head_matches_jax_fused_model(k, s, h, w):
    """StereoModel(fused_coarse_head=True): the JAX model runs the Pallas
    coarse head in interpreter mode, the port the plain coarse head."""
    _, variables, left, right = _jax_setup(k, s, h, w)
    jmodel = JaxStereoModel(k=k, input_scale=s, use_pallas=True, fused_coarse_head=True)
    ref = jmodel.apply(variables, jnp.asarray(left), jnp.asarray(right), side="l",
                       train=False)
    out = _run_port(_port_model(variables, k, s, fused_coarse_head=True), left, right)
    assert sorted(out) == sorted(ref) == sorted(
        [f"pred_disp_l/{s + k}", f"pred_disp_l/{s}", f"fcs_l/{s + k}"])
    for key in ref:
        assert tuple(out[key].shape) == tuple(ref[key].shape), key
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]),
                                   err_msg=key, **MODEL_TOL)


@pytest.mark.parametrize("fused", [False, True])
def test_output_cost_volume_matches_jax(fused):
    """output_cost_volume=True adds the float32 pre-softmax cost (B, D, h, w)
    and takes the three-stage path, with the fused head asked for or not."""
    k, s = 3, 1
    jmodel, variables, left, right = _jax_setup(k, s, 64, 128)
    ref = jmodel.apply(variables, jnp.asarray(left), jnp.asarray(right), side="l",
                       output_cost_volume=True, train=False)
    out = _run_port(_port_model(variables, k, s, fused_coarse_head=fused), left, right,
                    output_cost_volume=True)
    key = f"cost_volume_l/{s + k}"
    assert sorted(out) == sorted(ref) and key in out
    assert out[key].dtype == torch.float32
    assert tuple(out[key].shape) == tuple(ref[key].shape) == (1, 12, 8, 16)
    for name in ref:
        np.testing.assert_allclose(out[name].numpy(), np.asarray(ref[name]),
                                   err_msg=name, **MODEL_TOL)


def test_fused_and_composed_heads_share_the_weights():
    """The fused flag changes no parameter: both models take the same state
    dicts, and on the CPU, where both run plain versions of the same ops,
    they give the same outputs."""
    k, s = 3, 1
    _, variables, left, right = _jax_setup(k, s, 64, 128, seed=2)
    composed = _port_model(variables, k, s)
    fused = _port_model(variables, k, s, fused_coarse_head=True)
    a, b = composed.state_dict(), fused.state_dict()
    assert sorted(a) == sorted(b)
    assert all(torch.equal(a[key], b[key]) for key in a)
    out_c, out_f = _run_port(composed, left, right), _run_port(fused, left, right)
    assert sorted(out_c) == sorted(out_f)
    for key in out_c:
        assert torch.equal(out_c[key], out_f[key]), key


@pytest.mark.parametrize("k,s,h,w", [(3, 1, 64, 128), (4, 0, 64, 128)])
def test_bfloat16_error_is_within_a_factor_of_jax_bfloat16(k, s, h, w):
    """Port and JAX in bfloat16, each against the JAX float32 output. JAX
    runs its Pallas cost volume and soft-argmin + FCS (interpreter mode) and
    its XLA aggregation stack; the port its plain versions."""
    _, variables, left, right = _jax_setup(k, s, h, w)
    jl, jr = jnp.asarray(left), jnp.asarray(right)
    ref = JaxStereoModel(k=k, input_scale=s, use_pallas=True).apply(
        variables, jl, jr, side="l", train=False)
    jax_bf16 = JaxStereoModel(k=k, input_scale=s, use_pallas=True, dtype=jnp.bfloat16).apply(
        variables, jl, jr, side="l", train=False)
    port_bf16 = _run_port(_port_model(variables, k, s, dtype=torch.bfloat16), left, right)
    assert sorted(port_bf16) == sorted(ref) == sorted(jax_bf16)
    for key in ref:
        want = np.asarray(ref[key], np.float32)
        jax_err = np.abs(np.asarray(jax_bf16[key], np.float32) - want)
        port_err = np.abs(port_bf16[key].float().numpy() - want)
        assert jax_err.max() > 0, key  # a band of zero would check nothing
        print(f"k={k} {key}: JAX bf16 error max {jax_err.max():.4g}, mean "
              f"{jax_err.mean():.4g}; port/JAX ratio max {port_err.max() / jax_err.max():.3f}, "
              f"mean {port_err.mean() / jax_err.mean():.3f}")
        assert port_err.max() <= BF16_FACTOR * jax_err.max(), (key, port_err.max(),
                                                               jax_err.max())
        assert port_err.mean() <= BF16_FACTOR * jax_err.mean(), (key, port_err.mean(),
                                                                 jax_err.mean())


def test_state_dicts_match_the_jax_exporter_and_load_strictly():
    """state_dicts_from_jax writes exactly what the JAX package's exporter
    writes (same keys, same values), and both load strictly."""
    k = 3
    _, variables, _, _ = _jax_setup(k, 1, 32, 64, seed=1)
    fsd, ssd = state_dicts_from_jax(variables, k)
    p, st = variables["params"], variables["batch_stats"]
    ref_f = export_feature_net_state_dict(p["feature_net"], st["feature_net"], k)
    ref_s = export_stereo_net_state_dict(p["stereo_net"], st["stereo_net"])
    for mine, ref in ((fsd, ref_f), (ssd, ref_s)):
        assert sorted(mine) == sorted(ref)
        for key in ref:
            np.testing.assert_array_equal(mine[key].numpy(), np.asarray(ref[key]),
                                          err_msg=key)
    model = StereoModel(k=k, input_scale=1, device="cpu")
    model.load_state_dicts(fsd, ssd)
    model.load_state_dicts({k_: torch.from_numpy(np.array(v)) for k_, v in ref_f.items()},
                           {k_: torch.from_numpy(np.array(v)) for k_, v in ref_s.items()})
    assert sorted(model.feature_net.state_dict()) == sorted(ref_f)
    assert sorted(model.stereo_net.state_dict()) == sorted(ref_s)


def test_random_init_is_seeded():
    a = random_init_(StereoModel(k=3, device="cpu"), torch.Generator().manual_seed(3))
    b = random_init_(StereoModel(k=3, device="cpu"), torch.Generator().manual_seed(3))
    c = random_init_(StereoModel(k=3, device="cpu"), torch.Generator().manual_seed(4))
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[key], sb[key]) for key in sa)
    assert not torch.equal(sa["stereo_net.filter.0.0.0.weight"],
                           sc["stereo_net.filter.0.0.0.weight"])
    assert not torch.equal(sa["stereo_net.filter.0.0.1.running_var"],
                           torch.ones(32))


@pytest.mark.parametrize("in_hw, out_hw", [((20, 60), (320, 960)), ((7, 9), (37, 53)),
                                           ((37, 53), (7, 9))])
def test_resize_with_the_fixed_order_gradient_is_the_resize(in_hw, out_hw):
    """The resize whose backward is the transposed resize as two matrix
    products (the CUDA path of resize_bilinear), run on CPU tensors: the
    forward equals F.interpolate's, the gradient F.interpolate's autograd
    within float32 rounding, and two backward passes agree bit for bit."""
    from adaptive_stereo_tpu_torch.models.stereo_net import _ResizeBilinear

    gen = torch.Generator().manual_seed(0)
    x = torch.rand((2, 3, *in_hw), generator=gen, requires_grad=True)
    g = torch.rand((2, 3, *out_hw), generator=gen)
    want = torch.nn.functional.interpolate(x, size=out_hw, mode="bilinear",
                                           align_corners=False)
    (want_grad,) = torch.autograd.grad(want, x, g)
    got = _ResizeBilinear.apply(x, out_hw)
    grads = [torch.autograd.grad(_ResizeBilinear.apply(x, out_hw), x, g)[0] for _ in range(2)]
    assert torch.equal(got, want) and torch.equal(grads[0], grads[1])
    np.testing.assert_allclose(grads[0].numpy(), want_grad.numpy(), rtol=1e-5, atol=1e-6)
