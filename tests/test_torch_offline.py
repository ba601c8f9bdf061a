"""The port's offline tools against the JAX package, on the CPU:

- apply_disparity_colormap equal bit for bit to JAX's (matplotlib's magma)
  on random maps, constant maps and edge values;
- save_png: the file decoded by imageio equals JAX's save_png output
  decoded by imageio;
- save_disparities, playback and render_video_frames against JAX's on 2
  images of a synthetic dataset, from the same variables (32x64, k=2,
  maxdisp 47): disparities within the model band of
  tests/test_torch_model.py (2e-3 + 1e-4 relative), playback EPE within
  1e-4 relative; the PNGs decoded: the left image panel within one 8-bit
  level, each colormap panel within one step of the magma table (the
  disparity's rounding may move a pixel into the next of 256 bins) and on
  at most 1 % of its pixels more than one level apart;
- time_stereonet on the CPU at a tiny size;
- the command line with --device cpu: train, evaluate in its four modes
  (eval's metrics against the JAX command line's on the same checkpoint,
  AFTER_UPDATE_TOL of tests/test_torch_train.py), timing, and adapt with
  the default classic engine.
"""

import csv
import os
import re

import imageio.v2 as imageio
import numpy as np
import pytest
import torch

from adaptive_stereo_tpu.cli import main as jax_main
from adaptive_stereo_tpu.data import StereoDataset as JaxStereoDataset
from adaptive_stereo_tpu.engine import inference_tools as jax_tools
from adaptive_stereo_tpu.models import StereoModel as JaxStereoModel
from adaptive_stereo_tpu.utils import visualization as jax_viz
from adaptive_stereo_tpu_torch.analysis import time_stereonet
from adaptive_stereo_tpu_torch.cli import main
from adaptive_stereo_tpu_torch.data import StereoDataset, generate_synthetic_dataset
from adaptive_stereo_tpu_torch.engine import playback, render_video_frames, save_disparities
from adaptive_stereo_tpu_torch.models import StereoModel
from adaptive_stereo_tpu_torch.utils.visualization import (MAGMA_RGB, apply_disparity_colormap,
                                                          save_png, side_by_side)
from test_torch_train import AFTER_UPDATE_TOL, _variables

H, W, K, S, MAXDISP = 32, 64, 2, 0, 47
DISP_TOL = dict(atol=2e-3, rtol=1e-4)
# The largest difference of two neighbouring magma entries, in 8-bit levels.
LUT_STEP = int(np.ceil(np.abs(np.diff(MAGMA_RGB, axis=0)).max() * 255)) + 1


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads (see tests/test_torch_driver.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _maps(kind):
    rng = np.random.RandomState(3)
    if kind == "random":
        return [(rng.rand(37, 53) * 100).astype(np.float32),
                rng.randn(20, 30, 1).astype(np.float32),
                np.linspace(-5, 5, 4096, dtype=np.float32).reshape(64, 64)]
    if kind == "constant":
        return [np.full((5, 7), 3.0, np.float32), np.zeros((4, 4, 1), np.float32),
                np.full((2, 3), -1e30, np.float32)]
    # Edge values: the bin boundaries k / 256 (x * 256 == k exactly), the
    # top of the range (x * 256 == 256 goes to bin 255), denormals, and
    # values a float32 ulp around the boundaries.
    edges = np.arange(257, dtype=np.float32) / 256
    near = np.concatenate([np.nextafter(edges, np.float32(2)),
                           np.nextafter(edges, np.float32(-1))])
    return [edges.reshape(1, -1), near.reshape(2, -1),
            np.array([[0.0, 1e-45, 1e-30, 1.0, 1.0 - 2 ** -24]], np.float32)]


@pytest.mark.parametrize("kind", ["random", "constant", "edges"])
def test_colormap_matches_matplotlib(kind):
    for disp in _maps(kind):
        got, want = apply_disparity_colormap(disp), jax_viz.apply_disparity_colormap(disp)
        assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_save_png_matches_imageio(tmp_path):
    rng = np.random.RandomState(4)
    img = side_by_side(rng.rand(20, 30, 3).astype(np.float32) * 1.2 - 0.1,
                       apply_disparity_colormap(rng.rand(16, 25)))
    assert img.shape == (20, 55, 3)
    save_png(str(tmp_path / "port.png"), img)
    jax_viz.save_png(str(tmp_path / "jax.png"), img)
    got, want = imageio.imread(tmp_path / "port.png"), imageio.imread(tmp_path / "jax.png")
    assert got.dtype == np.uint8 and got.shape == (20, 55, 3)
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("offline")
    data = str(root / "data")
    generate_synthetic_dataset(data, name="synth", num_train=4, num_val=2, height=H, width=W,
                               max_disp=12.0, seed=4)
    return root, data, _variables(13)


def _datasets(data):
    kw = dict(scales=[S], load_disp_right=False)
    return (StereoDataset(data, "Synthetic", "synth", H, W, "val", **kw),
            JaxStereoDataset(data, "Synthetic", "synth", H, W, "val", **kw))


def _tool_args(setup, tmp_path, name):
    _, data, variables = setup
    port_ds, jax_ds = _datasets(data)
    port_model = StereoModel(k=K, input_scale=S, maxdisp=MAXDISP, device="cpu")
    jax_model = JaxStereoModel(k=K, input_scale=S, maxdisp=MAXDISP)
    return ((port_model, variables, port_ds, str(tmp_path / f"port_{name}"), S),
            (jax_model, variables, jax_ds, str(tmp_path / f"jax_{name}"), S))


def _assert_pngs_close(got_path, want_path, panels):
    """Decoded PNGs of `panels` equal-width panels, side by side (axis 1) or
    stacked (axis 0): the first panel (the left image) within one level,
    the colormap panels within one magma step."""
    got, want = imageio.imread(got_path).astype(int), imageio.imread(want_path).astype(int)
    assert got.shape == want.shape
    axis, n = panels
    for i, (g, w) in enumerate(zip(np.split(got, n, axis=axis), np.split(want, n, axis=axis))):
        diff = np.abs(g - w)
        if i == 0:
            assert diff.max() <= 1, (got_path, i)
        else:
            assert diff.max() <= LUT_STEP and (diff > 1).mean() <= 0.01, (got_path, i,
                                                                          diff.max())


def test_save_disparities_matches_jax(setup, tmp_path):
    port, ref = _tool_args(setup, tmp_path, "save")
    assert save_disparities(*port, limit=2) == jax_tools.save_disparities(*ref, limit=2) == 2
    for i in range(2):
        name = f"{i:06d}_pred_disp.npy"
        got, want = np.load(os.path.join(port[3], name)), np.load(os.path.join(ref[3], name))
        assert got.shape == want.shape == (H, W)
        np.testing.assert_allclose(got, want, **DISP_TOL)


def test_playback_matches_jax(setup, tmp_path, capsys):
    port, ref = _tool_args(setup, tmp_path, "playback")
    want = jax_tools.playback(*ref, limit=2)
    got = playback(*port, limit=2)
    assert got["count"] == want["count"] == 2
    np.testing.assert_allclose(got["EPE"], want["EPE"], rtol=1e-4)
    out = capsys.readouterr().out
    assert len(re.findall(r"\[playback\] image \d: EPE=", out)) == 4
    for i in range(2):
        name = f"{i:06d}.png"
        assert imageio.imread(os.path.join(port[3], name)).shape == (H, 3 * W, 3)
        _assert_pngs_close(os.path.join(port[3], name), os.path.join(ref[3], name), (1, 3))


def test_render_video_frames_matches_jax(setup, tmp_path):
    port, ref = _tool_args(setup, tmp_path, "video")
    assert render_video_frames(*port, limit=2) == jax_tools.render_video_frames(*ref, limit=2)
    for i in range(2):
        name = f"frame_{i:06d}.png"
        assert imageio.imread(os.path.join(port[3], name)).shape == (2 * H, W, 3)
        _assert_pngs_close(os.path.join(port[3], name), os.path.join(ref[3], name), (0, 2))


def test_time_stereonet_runs_on_the_cpu():
    r = time_stereonet(n=2, height=32, width=64, k=2, compute_dtype="float32", device="cpu")
    assert sorted(r) == ["backprop_hz", "backprop_sec", "inference_hz", "inference_sec"]
    assert all(np.isfinite(v) and v > 0 for v in r.values())
    np.testing.assert_allclose(r["inference_hz"] * r["inference_sec"], 1.0)


# --- the command line -------------------------------------------------------

def _common(setup, *extra, device="cpu"):
    """Flags of every subcommand; device=None leaves out --device (the JAX
    parser has none, and the port's default is cuda)."""
    root, data, _ = setup
    return ["--dataset_path", data, "--dataset_name", "Synthetic", "--split", "synth",
            "--height", str(H), "--width", str(W), "--stereonet_k", "3",
            "--stereonet_input_scale", "0", "--num_workers", "1",
            "--log_dir", str(root / "logs"), *extra] + (["--device", device] if device else [])


@pytest.fixture(scope="module")
def trained(setup):
    """`train` from the command line, two epochs; returns its last checkpoint."""
    root = setup[0]
    rc = main(["train", "--model_name", "cli_train", *_common(
        setup, "--batch_size", "2", "--num_epochs", "2", "--learning_rate", "1e-4",
        "--clip_grad_norm", "--do_hflip", "--log_frequency", "1", "--scheduler_step_size",
        "1")])
    assert rc == 0
    return str(root / "logs" / "cli_train" / "models" / "weights_1")


def test_cli_train(trained, setup):
    assert sorted(os.listdir(os.path.dirname(trained))) == ["weights_1"]
    assert os.path.exists(os.path.join(trained, "state.msgpack"))
    assert os.path.exists(os.path.join(setup[0], "logs", "cli_train", "opt.json"))


def _metrics(text):
    line = [ln for ln in text.splitlines() if ln.startswith("EVAL    // ")][-1]
    return {k: float(v) for k, v in re.findall(r"(\w+)=([-\d.einf]+)", line)}


@pytest.mark.parametrize("mode", ["eval", "save", "playback", "video"])
def test_cli_evaluate(mode, trained, setup, tmp_path, capsys):
    args = ["evaluate", "--mode", mode, "--output_folder", str(tmp_path / mode), "--limit",
            "2", "--batch_size", "2", "--load_weights_folder", trained]
    assert main(args + _common(setup)) == 0
    out = capsys.readouterr().out
    if mode == "eval":
        got = _metrics(out)
        assert jax_main(args + _common(setup, device=None)) == 0
        want = _metrics(capsys.readouterr().out)
        assert sorted(got) == sorted(want) == ["D1_all_2px", "D1_all_3px", "D1_all_4px",
                                               "D1_all_5px", "EPE", "FCS"]
        for name in want:
            np.testing.assert_allclose(got[name], want[name], err_msg=name, **AFTER_UPDATE_TOL)
        assert np.isfinite(got["EPE"])
        return
    files = sorted(os.listdir(tmp_path / mode))
    expect = {"save": ["000000_pred_disp.npy", "000001_pred_disp.npy"],
              "playback": ["000000.png", "000001.png"],
              "video": ["frame_000000.png", "frame_000001.png"]}[mode]
    assert files == expect
    if mode == "playback":
        assert "Playback done: mean EPE=" in out
        assert imageio.imread(tmp_path / mode / files[0]).shape == (H, 3 * W, 3)


def test_cli_timing(setup, capsys):
    assert main(["timing", "--iterations", "2", "--height", "32", "--width", "64",
                 "--stereonet_k", "3", "--compute_dtype", "float32", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert re.search(r"-- Timing \(inference only\): [\d.]+ sec \([\d.]+ hz\)", out)
    assert re.search(r"-- Timing \(inference \+ backprop\): [\d.]+ sec \([\d.]+ hz\)", out)


def test_cli_adapt_classic(trained, setup, capsys):
    root, data, _ = setup
    rc = main(["adapt", "--model_name", "cli_adapt", *_common(
        setup, "--batch_size", "1", "--learning_rate", "1e-4", "--clip_grad_norm",
        "--num_steps", "4", "--eval_hz", "4", "--ovs_buffer_size", "2",
        "--ovs_validate_hz", "2", "--ood_threshold", "1e9", "--num_epochs", "1",
        "--log_frequency", "2", "--train_dataset_path", data, "--train_dataset_name",
        "Synthetic", "--train_split", "synth", "--load_weights_folder", trained)])
    assert rc == 0
    out = capsys.readouterr().out
    assert "Done with adaptation!" in out and "[ OVS ] ADDED" in out
    assert "Skipping gradient update" in out
    folder = os.path.join(root, "logs", "cli_adapt")
    with open(os.path.join(folder, "trials.csv"), newline="") as f:
        rows = list(csv.reader(f))
    assert [r[rows[0].index("step")] for r in rows[1:]] == ["-1", "4"]
    assert os.path.exists(os.path.join(folder, "models", "weights_4", "state.msgpack"))
    # Without --device the command runs on CUDA, and raises where there is none.
    if not torch.cuda.is_available():
        argv = ["adapt", "--model_name", "cli_adapt_cuda", *_common(setup, device=None),
                "--load_weights_folder", trained]
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(argv)
