"""The port's eval-mode StereoModel vs the JAX StereoModel with
use_pallas=True, pallas_aggregation=True (Pallas kernels in interpreter
mode on the CPU), float32 on both sides.

The JAX variables come from flax init with every BatchNorm scale, bias and
running statistic redrawn from a numpy seed (so the normalisation is not an
identity); state_dicts_from_jax carries them into the port.

Tolerance: 2e-3 absolute, 1e-4 relative on every output, the band
tests/test_model_parity.py uses for the JAX model against the reference
torch model (disparities are O(10-100) px after the 2^k and W/w scalings).
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


def test_train_mode_is_refused():
    model = StereoModel(k=3, input_scale=1, device="cpu")
    x = torch.zeros(1, 32, 64, 3)
    with pytest.raises(NotImplementedError):
        model.train()(x, x)


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
