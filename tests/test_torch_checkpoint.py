"""The port's checkpoints against the JAX package's: state.msgpack written by
either package loads in the other with equal arrays (the port's msgpack
codec is pure Python; flax's writes the same bytes), the reference .pth
folder loads to the same variables in both, and variables_from_state_dicts
inverts state_dicts_from_jax. All comparisons are exact."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from adaptive_stereo_tpu.engine.checkpoint import load_variables as jax_load
from adaptive_stereo_tpu.engine.checkpoint import save_variables as jax_save
from adaptive_stereo_tpu.models import StereoModel as JaxStereoModel
from adaptive_stereo_tpu.models.torch_import import (export_feature_net_state_dict,
                                                     export_stereo_net_state_dict)
from adaptive_stereo_tpu_torch.engine import load_variables, save_variables
from adaptive_stereo_tpu_torch.engine.checkpoint import packb, unpackb
from adaptive_stereo_tpu_torch.models import (StereoModel, random_init_, state_dicts_from_jax,
                                              variables_from_state_dicts)
from test_torch_model import _randomize_bn


def _jax_variables(k, seed):
    rng = np.random.RandomState(seed)
    x = jnp.zeros((1, 64, 128, 3))
    v = JaxStereoModel(k=k).init(jax.random.PRNGKey(seed), x, x, train=False)
    return _randomize_bn(jax.tree.map(np.asarray, dict(v)), rng)


def _assert_trees_equal(a, b, path=""):
    assert isinstance(a, dict) == isinstance(b, dict), path
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for key in a:
            _assert_trees_equal(a[key], b[key], f"{path}/{key}")
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, path
    np.testing.assert_array_equal(a, b, err_msg=path)


@pytest.mark.parametrize("k", [3, 4])
def test_state_msgpack_loads_across_both_packages(tmp_path, k):
    variables = _jax_variables(k, seed=k)
    jax_save(str(tmp_path / "from_jax"), variables, {"note": "jax"})
    _assert_trees_equal(load_variables(str(tmp_path / "from_jax")), variables)

    save_variables(str(tmp_path / "from_port"), variables, {"note": "port"})
    _assert_trees_equal(jax_load(str(tmp_path / "from_port")), variables)
    # The same container, byte for byte.
    assert (tmp_path / "from_port" / "state.msgpack").read_bytes() == \
        (tmp_path / "from_jax" / "state.msgpack").read_bytes()


def test_msgpack_codec_matches_flax():
    """Scalars of every width, strings, bytes, lists, maps past 15 keys,
    0-d and non-contiguous arrays, numpy scalars: the port writes flax's
    bytes, and reads flax's."""
    rng = np.random.RandomState(0)
    tree = {"a": rng.rand(3, 4).astype(np.float32), "b": {"c": np.arange(5, dtype=np.int32)},
            "step": np.asarray(12), "ints": [0, 127, 128, 70000, 2 ** 40, -1, -33, -200,
                                             -70000, -2 ** 40],
            "f": 0.25, "s": "x" * 40, "none": None, "t": True, "sc": np.float32(3.5),
            "T": rng.rand(2, 3).T, "many": {f"k{i}": i for i in range(20)},
            "bytes": b"\x00\x01" * 200, "u8": rng.randint(0, 255, (7,)).astype(np.uint8)}
    flax_bytes = serialization.msgpack_serialize(tree)
    assert packb(tree) == flax_bytes
    back = unpackb(flax_bytes)
    _assert_trees_equal({k: back[k] for k in ("a", "b", "step", "T", "u8")},
                        {k: tree[k] for k in ("a", "b", "step", "T", "u8")})
    assert back["ints"] == tree["ints"] and back["bytes"] == tree["bytes"]
    assert back["sc"] == np.float32(3.5) and isinstance(back["sc"], np.float32)
    assert back["many"] == tree["many"] and back["none"] is None and back["t"] is True


def test_variables_from_state_dicts_inverts_state_dicts_from_jax():
    k = 3
    variables = _jax_variables(k, seed=5)
    _assert_trees_equal(variables_from_state_dicts(*state_dicts_from_jax(variables, k), k),
                        variables)
    # And the other way: a port model's state dicts survive the round trip.
    model = random_init_(StereoModel(k=k, device="cpu"), torch.Generator().manual_seed(0))
    fsd, ssd = model.feature_net.state_dict(), model.stereo_net.state_dict()
    fsd2, ssd2 = state_dicts_from_jax(variables_from_state_dicts(fsd, ssd, k), k)
    for mine, back in ((fsd, fsd2), (ssd, ssd2)):
        assert sorted(mine) == sorted(back)
        for key in mine:
            if ".conv2." in key or key.endswith("num_batches_tracked"):
                continue  # dead conv2 (no JAX counterpart) and the counter
            assert torch.equal(mine[key], back[key]), key


def test_reference_folder_loads_like_jax(tmp_path):
    k = 4
    variables = _jax_variables(k, seed=7)
    p, st = variables["params"], variables["batch_stats"]
    as_torch = lambda sd: {key: torch.from_numpy(np.array(v)) for key, v in sd.items()}
    torch.save(as_torch(export_feature_net_state_dict(p["feature_net"], st["feature_net"], k)),
               tmp_path / "feature_net.pth")
    torch.save(as_torch(export_stereo_net_state_dict(p["stereo_net"], st["stereo_net"])),
               tmp_path / "stereo_net.pth")
    mine = load_variables(str(tmp_path))
    _assert_trees_equal(mine, jax.tree.map(np.asarray, jax_load(str(tmp_path))))
    _assert_trees_equal(mine, variables)


def test_missing_checkpoint_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="no checkpoint found"):
        load_variables(str(tmp_path / "nowhere"))
    os.makedirs(tmp_path / "empty")
    with pytest.raises(FileNotFoundError, match="no checkpoint found"):
        load_variables(str(tmp_path / "empty"))
