"""Guards of the port's rules: what it imports, which device its entry
points pick, and that nothing is built or loaded at import."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import adaptive_stereo_tpu_torch
from adaptive_stereo_tpu_torch import resolve_device
from adaptive_stereo_tpu_torch.analysis import train_autoencoder
from adaptive_stereo_tpu_torch.engine import (DeviceCachedLoader, init_device_reservoir,
                                              init_flat_stream_state)
from adaptive_stereo_tpu_torch.models import StereoModel
from adaptive_stereo_tpu_torch.ops.cuda import _build
from adaptive_stereo_tpu_torch.serving import ServingConfig, StereoDepthEngine

REPO = Path(__file__).resolve().parents[1]
PORT = Path(adaptive_stereo_tpu_torch.__file__).resolve().parent
FORBIDDEN = {"jax", "jaxlib", "flax", "cv2", "matplotlib", "PIL", "imageio", "tensorboardX",
             "msgpack", "adaptive_stereo_tpu"}


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0], node.lineno
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0], node.lineno


def test_port_and_chip_smoke_import_nothing_of_jax():
    """Static scan (jax is already imported in this process): no module of
    the port, and not chip_smoke.py, imports jax, flax, cv2, matplotlib,
    PIL, imageio, tensorboardX, msgpack or the JAX package (the port decodes
    PNGs with zlib and reads flax's msgpack container itself)."""
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    bad = [f"{f.relative_to(REPO)}:{line} imports {mod}"
           for f in files for mod, line in _imported_roots(f) if mod in FORBIDDEN]
    assert not bad, bad


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        StereoModel(k=4)
    model = StereoModel(k=4, device="cpu")
    sds = (model.feature_net.state_dict(), model.stereo_net.state_dict())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        StereoDepthEngine(ServingConfig(), sds)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_flat_stream_state(model, 5e-5, 16, 32, 64, 64)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_device_reservoir(16, 32, 64)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DeviceCachedLoader([])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_autoencoder([{"color_l/0": np.zeros((1, 32, 32, 3), np.float32)}], num_steps=1)
    assert resolve_device("cpu") == torch.device("cpu")
    ss = init_flat_stream_state(model, 5e-5, 4, 32, 64, 8, device="cpu")
    assert ss.reservoir.left.device.type == ss.log.device.type == "cpu"


def test_driver_and_cli_raise_without_cuda(monkeypatch, tmp_path):
    """adapt_streaming (both engines, and the device cache) and `adapt
    --engine flat` / `--engine pytree` / `--device_cache` run on CUDA
    unless asked for the CPU: without CUDA they raise before reading any
    data."""
    from adaptive_stereo_tpu_torch.cli import main
    from adaptive_stereo_tpu_torch.engine import ExperimentConfig, adapt_streaming

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ExperimentConfig(log_dir=str(tmp_path), load_weights_folder=str(tmp_path))
    cfg.data.batch_size = 1  # the device cache's
    for kwargs in ({}, {"engine": "pytree"}, {"device_cache": True}):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            adapt_streaming(cfg, **kwargs)
    for extra in (["--engine", "flat"], ["--engine", "pytree"],
                  ["--engine", "flat", "--device_cache", "--batch_size", "1"]):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(["adapt", *extra, "--log_dir", str(tmp_path)])
    assert not any(tmp_path.iterdir())


@pytest.mark.parametrize("argv", [["train"], ["adapt"], ["evaluate", "--mode", "eval"],
                                  ["evaluate", "--mode", "playback"], ["timing"]])
def test_offline_commands_raise_without_cuda(argv, monkeypatch, tmp_path):
    """train, adapt (the classic engine, the default), evaluate and timing
    run on CUDA unless given --device cpu: without CUDA they raise before
    writing anything, and no path falls back to the CPU."""
    from adaptive_stereo_tpu_torch.cli import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    folders = ["--log_dir", str(tmp_path), "--load_weights_folder", str(tmp_path)]
    extra = {"train": folders, "adapt": folders, "timing": [],
             "evaluate": folders + ["--output_folder", str(tmp_path / "out")]}[argv[0]]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(argv + extra)
    assert not any(tmp_path.iterdir())


def test_kernel_modules_import_without_cuda_or_nvcc(tmp_path):
    """A fresh interpreter with no GPU and no nvcc imports every module of
    the port; nothing is built or loaded."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", CUDA_HOME=str(tmp_path),
               PATH=str(tmp_path), PYTHONPATH=str(REPO))
    code = (
        "import importlib, pkgutil, adaptive_stereo_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "from adaptive_stereo_tpu_torch.ops.cuda import _build\n"
        "assert _build.library.cache_info().currsize == 0\n"
        "print('imported')\n")
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "imported" in proc.stdout


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build.Path, "is_file", lambda self: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()


def test_library_name_follows_the_sources():
    """The library is named by a hash of every csrc source and the flags,
    inside the git-ignored build directory."""
    path = _build.library_path()
    assert path.parent == PORT / "_build"
    assert path.name.startswith("libstereo_kernels_") and path.suffix == ".so"
    names = {p.name for p in (PORT / "csrc").glob("*.cu")}
    assert names == {"cost_volume.cu", "aggregation.cu", "disparity.cu", "coarse_head.cu",
                     "tower.cu"}
    headers = {p.name for p in (PORT / "csrc").glob("*.cuh")}
    assert headers == {"common.cuh", "bn_stats.cuh", "conv3d.cuh", "mma.cuh",
                       "soft_argmin_fcs.cuh"}
    ignored = (REPO / ".gitignore").read_text().split()
    assert "adaptive_stereo_tpu_torch/_build/" in ignored


def test_library_name_follows_the_headers(monkeypatch, tmp_path):
    """A change to a shared header (the conv body of kernels 2 and 4 lives
    in csrc/conv3d.cuh) renames the library, so a stale build is never
    loaded; the -Xptxas -v report is named after the library beside it."""
    src = tmp_path / "csrc"
    shutil.copytree(PORT / "csrc", src)
    monkeypatch.setattr(_build, "CSRC_DIR", src)
    before = _build.library_path()
    (src / "conv3d.cuh").write_text((src / "conv3d.cuh").read_text() + "\n// edited\n")
    after = _build.library_path()
    assert after != before and after.parent == before.parent
    assert _build.ptxas_report_path() == after.parent / (after.stem + ".ptxas.txt")


@pytest.mark.parametrize("source", ["cost_volume.cu", "disparity.cu", "soft_argmin_fcs.cuh",
                                    "common.cuh"])
def test_library_name_follows_every_kernel_source(monkeypatch, tmp_path, source):
    """An edit to the sources of kernels 1 and 3 (forward and backward) or
    to the helpers they share renames the library."""
    src = tmp_path / "csrc"
    shutil.copytree(PORT / "csrc", src)
    monkeypatch.setattr(_build, "CSRC_DIR", src)
    before = _build.library_path()
    (src / source).write_text((src / source).read_text() + "\n// edited\n")
    assert _build.library_path() != before


def test_every_c_entry_point_has_argtypes():
    """Every extern "C" function in csrc has a ctypes signature, with one
    argument per C parameter (pointers and the stream as c_void_p)."""
    import re

    found = {}
    for src in (PORT / "csrc").glob("*.cu"):
        for name, args in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src.read_text()):
            found[name] = [a.strip() for a in args.split(",")]
    assert set(found) == set(_build._SIGNATURES)
    # The backward kernels of kernels 1 and 3 and the empty kernel that
    # chip_smoke.py times as the launch floor.
    assert {"stereo_cost_volume_backward", "stereo_soft_argmin_backward",
            "stereo_noop"} <= set(found)
    for name, args in found.items():
        sig = _build._SIGNATURES[name]
        assert len(sig) == len(args), name
        for a, t in zip(args, sig):
            want = {"int": _build._I, "float": _build._F}.get(a.split()[-2] if "*" not in a
                                                               else "", _build._P)
            assert t is want, (name, a)


def test_dtype_codes_match_the_header():
    header = (PORT / "csrc" / "common.cuh").read_text()
    assert "kFloat32 = 0" in header and "kBFloat16 = 1" in header
    assert _build.DTYPE_CODES == {torch.float32: 0, torch.bfloat16: 1}
