"""The paper-protocol layer of the port against the JAX package, on the CPU:

- the last four names of the op and utils surface: feature_contrast_median
  bitwise (odd and even D, ties at the maximum and at the median, bf16, no
  gradient), softmax_disparity within 1e-6 relative in float32, and
  StereoReservoir / StereoPriorityQueue exported where JAX exports them;
- experiments.py: adaptation_config field by field for the ten paper
  environments x five methods, training_config for both sources;
- run_paper_suite: the missing-mounts report and exit code equal the JAX
  script's;
- the readiness drill on the CPU (its two steps at 32x48 frames, two
  environments x two methods x four steps): every run writes trials.csv
  with the columns of the JAX driver's (the committed artifacts/
  paper_scale_r3 trials); the drill's two commands equal JAX's drill's.
"""

import contextlib
import dataclasses
import importlib.util
import io
import os
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import adaptive_stereo_tpu.ops as jax_ops
import adaptive_stereo_tpu.utils as jax_utils
from adaptive_stereo_tpu import experiments as jax_experiments
from adaptive_stereo_tpu_torch import experiments
from adaptive_stereo_tpu_torch import ops, utils
from adaptive_stereo_tpu_torch.scripts import (make_readiness_minidata, run_paper_suite,
                                               run_readiness_drill)

REPO = Path(__file__).resolve().parents[1]


def _cost(rng, b, d, h, w):
    """Costs with ties: a duplicated maximum and duplicated middle values."""
    cost = rng.randn(b, d, h, w).astype(np.float32)
    cost[:, 1] = cost.max(axis=1)                # a tie at the maximum
    cost[0, :, 0, 0] = np.repeat([0.5, 1.5], (d + 1) // 2)[:d]  # ties at the median
    return cost


@pytest.mark.parametrize("d", [7, 8, 12])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_feature_contrast_median_equals_jax(d, dtype):
    cost = _cost(np.random.RandomState(d), 2, d, 5, 6)
    want = np.asarray(jax_ops.feature_contrast_median(jnp.asarray(cost).astype(dtype)),
                      np.float32)
    x = torch.from_numpy(cost).to(getattr(torch, dtype)).requires_grad_(True)
    got = ops.feature_contrast_median(x)
    assert not got.requires_grad and got.dtype == x.dtype and got.shape == (2, 5, 6)
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_softmax_disparity_equals_jax():
    cost = np.random.RandomState(0).randn(2, 12, 5, 7).astype(np.float32) * 4
    want = np.asarray(jax_ops.softmax_disparity(jnp.asarray(cost)))
    got = ops.softmax_disparity(torch.from_numpy(cost)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    got2 = ops.softmax_disparity(torch.from_numpy(cost.transpose(0, 2, 1, 3)), dim=2).numpy()
    np.testing.assert_allclose(got2.transpose(0, 2, 1, 3), want, rtol=1e-6, atol=0)


def test_exports_are_where_jax_has_them():
    for name in ("feature_contrast_median", "softmax_disparity"):
        assert hasattr(jax_ops, name) and name in ops.__all__ and callable(getattr(ops, name))
    for name in ("StereoReservoir", "StereoPriorityQueue"):
        assert hasattr(jax_utils, name) and name in utils.__all__
    reservoir = utils.StereoReservoir(2)
    assert reservoir.size() == 0
    assert utils.StereoPriorityQueue(2).size() == 0


def _fields(cfg):
    return dataclasses.asdict(cfg)


@pytest.mark.parametrize("environment", list(jax_experiments.ADAPTATION_ENVIRONMENTS))
def test_adaptation_config_equals_jax(environment):
    assert experiments.ADAPTATION_ENVIRONMENTS == jax_experiments.ADAPTATION_ENVIRONMENTS
    paths = {"SceneFlowFlying": "/sf", "VirtualKitti": "/vk", "KittiRaw": "/kr"}
    for method in experiments.ADAPT_METHODS:
        for kw in ({}, dict(num_steps=8, height=64, width=96, eval_hz=4, ovs_validate_hz=2)):
            want = _fields(jax_experiments.adaptation_config(environment, method, paths,
                                                             "/w", "logs", **kw))
            got = _fields(experiments.adaptation_config(environment, method, paths, "/w",
                                                        "logs", **kw))
            for section, values in want.items():
                if isinstance(values, dict):
                    for name, value in values.items():
                        assert got[section][name] == value, (environment, method,
                                                             section, name)
                else:
                    assert got[section] == values, (environment, method, section)


@pytest.mark.parametrize("dataset", ["SceneFlowFlying", "VirtualKitti"])
def test_training_config_equals_jax(dataset):
    want = _fields(jax_experiments.training_config(dataset, "/data", "logs"))
    got = _fields(experiments.training_config(dataset, "/data", "logs"))
    for section, values in want.items():
        if isinstance(values, dict):
            for name, value in values.items():
                assert got[section][name] == value, (section, name)
        else:
            assert got[section] == values, section


def _jax_suite_main(argv):
    """Run scripts/run_paper_suite.py's main in this process: (stdout, code)."""
    spec = importlib.util.spec_from_file_location("jax_run_paper_suite",
                                                  REPO / "scripts" / "run_paper_suite.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    out, saved = io.StringIO(), sys.argv
    sys.argv = ["run_paper_suite.py", *argv]
    code = 0
    try:
        with contextlib.redirect_stdout(out):
            module.main()
    except SystemExit as e:
        code = e.code
    finally:
        sys.argv = saved
    return out.getvalue(), code


@pytest.mark.parametrize("mounts", ["none", "partial"])
def test_paper_suite_missing_mounts_equal_jax(mounts, tmp_path):
    argv = []
    if mounts == "partial":
        (tmp_path / "vk").mkdir()
        (tmp_path / "w").mkdir()
        argv = ["--vkitti", str(tmp_path / "vk"), "--vk_weights", str(tmp_path / "w"),
                "--environments", "clone_to_fog", "clone_to_campus", "flying_to_vk01"]
    want, want_code = _jax_suite_main(argv)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        code = run_paper_suite.main(argv)
    assert want_code == code == 2
    assert out.getvalue() == want


def test_readiness_drill_on_cpu(tmp_path, capsys):
    """The drill's two steps in this process at a small size: the minidata
    (32x48 frames, the splits of two environments) and the paper suite over
    them (two methods x four steps)."""
    data = tmp_path / "drill"
    envs = ["flying_to_vk01", "clone_to_campus"]
    # Twelve frames: the loaders read one evaluation batch (6 frames) past
    # the one they use, in both packages.
    make_readiness_minidata.make_minidata(str(data), 12, 32, 48, envs)
    rc = run_paper_suite.main([
        "--sceneflow", str(data / "sceneflow"), "--vkitti", str(data / "vkitti"),
        "--kitti_raw", str(data / "kitti_raw"), "--sf_weights", str(data / "weights" / "sf"),
        "--vk_weights", str(data / "weights" / "vk"), "--environments", *envs,
        "--methods", "nonstop", "vs+er", "--num_steps", "4", "--height", "32", "--width", "48",
        "--eval_hz", "2", "--ovs_validate_hz", "2", "--log_dir", str(data / "logs"),
        "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0, out[-3000:]
    assert "[flying_to_vk01] VS+ER @ 4 steps" in out
    jax_columns = (REPO / "artifacts" / "paper_scale_r3" /
                   "trials_faithful_vs_er.csv").read_text().splitlines()[0]
    for env in envs:
        for method in ("nonstop", "vs+er"):
            trials = data / "logs" / env / f"adapt_{env}_{method}" / "trials.csv"
            lines = trials.read_text().splitlines()
            assert lines[0] == jax_columns
            steps = [line.split(",")[1] for line in lines[1:]]
            assert steps == (["-1", "2", "4"] if method == "nonstop" else ["2", "4"]), lines
    assert (data / "vkitti" / "Scene01" / "clone" / "frames" / "rgb" / "Camera_0" /
            "rgb_00000.jpg").read_bytes()[:2] == b"\xff\xd8"
    assert os.path.exists(data / "weights" / "sf" / "state.msgpack")


def test_readiness_drill_commands_equal_jax(tmp_path, monkeypatch):
    """The drill runs JAX's drill's two commands, with the port's modules
    for its scripts and --device added."""
    spec = importlib.util.spec_from_file_location("jax_run_readiness_drill",
                                                  REPO / "scripts" / "run_readiness_drill.py")
    jax_drill = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_drill)
    want, got = [], []
    monkeypatch.setattr(jax_drill, "run", lambda cmd, log_f: want.append(cmd) or 0)
    monkeypatch.setattr(run_readiness_drill, "run", lambda cmd, log_f: got.append(cmd) or 0)
    flags = ["--data", str(tmp_path / "d"), "--log", str(tmp_path / "drill.log"),
             "--num_steps", "7", "--frames", "12"]
    monkeypatch.setattr(sys, "argv", ["run_readiness_drill.py", *flags])
    assert jax_drill.main() == 0
    assert run_readiness_drill.main([*flags, "--device", "cpu"]) == 0
    modules = ["make_readiness_minidata", "run_paper_suite"]
    assert [Path(cmd[1]).stem for cmd in want] == modules
    assert [cmd[2] for cmd in got] == [f"adaptive_stereo_tpu_torch.scripts.{m}" for m in modules]
    assert [cmd[2:] for cmd in want] == [got[0][3:], got[1][3:-2]]
    assert got[1][-2:] == ["--device", "cpu"]
