"""The port's native host library (data/native.py, csrc/stereo_native.cpp)
against the JAX package's (adaptive_stereo_tpu/data/native.py over
native/stereo_native.cpp), on the CPU.

The JAX library is built here from its own source with its Makefile's
flags (-O3 -march=native -fPIC -std=c++17) and bound by the JAX module's
own loader. Held bit for bit: the voxel grid (after sorting rows: both
return the hash map's order), the PFM reader and uint8 -> float32. The
resize is held bit for bit to JAX's source built with the port's flags and
to a float32 transcription of its loop; against the Makefile's build it is
held to four ulps of the image's largest value, because -march=native
lets the compiler fuse the three lerps' multiply-adds, each of which then
rounds once instead of twice, and the first two's differences carry into
the third (the port builds with -ffp-contract=off).

The numpy voxel_downsample of serving/stream.py is the grid's plain
version: it keys on floor(p / voxel) in float32 where the native grid keys
on floor(p * (1 / voxel)) in double, so the two agree on points kept away
from voxel faces (rows within 1e-6 after sorting) and may differ on a point
within an ulp of a face.
"""

import subprocess

import numpy as np
import pytest
import torch

from adaptive_stereo_tpu.data import native as jax_native
from adaptive_stereo_tpu.data.io import write_pfm as jax_write_pfm
from adaptive_stereo_tpu.data.loaders import load_disp_sceneflow as jax_load_disp_sceneflow
from adaptive_stereo_tpu_torch.data import native
from adaptive_stereo_tpu_torch.data.io import read_pfm
from adaptive_stereo_tpu_torch.data.loaders import load_disp_sceneflow
from adaptive_stereo_tpu_torch.serving import ServingConfig, stream, voxel_downsample

JAX_SOURCE = "native/stereo_native.cpp"
MAKEFILE_FLAGS = ["-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall"]


def _jax_library(path, flags):
    """JAX's native module bound to its source built with `flags` at path."""
    subprocess.run(["c++", *flags, "-shared", "-o", str(path), JAX_SOURCE], check=True,
                   cwd=str(native._SOURCE.parents[2]))
    jax_native._SO_PATH, jax_native._LIB, jax_native._TRIED = str(path), None, False
    assert jax_native.available()
    return jax_native._LIB


@pytest.fixture(scope="module")
def jax_libs(tmp_path_factory):
    """{'makefile': ..., 'port_flags': ...}: the JAX source built both ways;
    the JAX module is left bound to the Makefile's build."""
    root = tmp_path_factory.mktemp("jax_native")
    saved = (jax_native._SO_PATH, jax_native._LIB, jax_native._TRIED)
    libs = {"port_flags": _jax_library(root / "port.so", list(native._CXXFLAGS)),
            "makefile": _jax_library(root / "makefile.so", MAKEFILE_FLAGS)}
    yield libs
    jax_native._SO_PATH, jax_native._LIB, jax_native._TRIED = saved


def _sorted_rows(*arrays):
    rows = np.concatenate([a for a in arrays if a is not None], axis=1)
    return rows[np.lexsort(rows.T[::-1])]


def _cloud(seed, n=20000):
    """A point cloud like a served frame's: x, y spread, z in (0, 80)."""
    rng = np.random.RandomState(seed)
    pts = np.stack([rng.randn(n) * 4, rng.randn(n) * 2, rng.uniform(0.5, 80, n)], 1)
    return pts.astype(np.float32), rng.rand(n, 3).astype(np.float32)


@pytest.mark.parametrize("voxel, with_colors", [(0.15, True), (0.15, False), (0.5, True),
                                                (0.05, True)])
def test_voxel_grid_equals_jax_native(jax_libs, voxel, with_colors):
    pts, cols = _cloud(int(voxel * 100))
    cols = cols if with_colors else None
    got = native.voxel_downsample_native(pts, voxel, cols)
    want = jax_native.voxel_downsample_native(pts, voxel, cols)
    assert got[0].shape == want[0].shape and got[0].shape[0] < len(pts)
    assert (got[1] is None) == (want[1] is None) == (not with_colors)
    np.testing.assert_array_equal(_sorted_rows(*got), _sorted_rows(*want))


def test_voxel_grid_of_no_points(jax_libs):
    pts, cols = native.voxel_downsample_native(np.zeros((0, 3), np.float32), 0.15,
                                               np.zeros((0, 3), np.float32))
    assert pts.shape == cols.shape == (0, 3)


def test_voxel_grid_against_its_plain_version_away_from_faces():
    """Points whose coordinates lie at least 1 % of a voxel from a face fall
    in the same voxel under both keyings: the same voxel count, rows within
    1e-6 after sorting."""
    voxel = 0.15
    pts, cols = _cloud(7, 40000)
    frac = pts.astype(np.float64) / voxel
    frac -= np.floor(frac)
    keep = ((frac > 0.01) & (frac < 0.99)).all(axis=1)
    pts, cols = pts[keep], cols[keep]
    got = native.voxel_downsample_native(pts, voxel, cols)
    want = voxel_downsample(pts, voxel, cols)
    assert got[0].shape == want[0].shape
    np.testing.assert_allclose(_sorted_rows(*got), _sorted_rows(*want), atol=1e-6, rtol=0)


@pytest.mark.parametrize("shape", [(31, 45), (31, 45, 3)])
def test_pfm_read_equals_jax_native(jax_libs, tmp_path, shape):
    data = np.random.RandomState(len(shape)).randn(*shape).astype(np.float32) * 50
    path = str(tmp_path / "d.pfm")
    jax_write_pfm(path, data)
    got, scale = native.pfm_read_native(path)
    want, _ = jax_native.pfm_read_native(path)
    assert scale == 1.0 and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, read_pfm(path)[0])


def test_sceneflow_loader_reads_through_the_native_library(jax_libs, tmp_path, monkeypatch):
    data = np.random.RandomState(3).rand(20, 30).astype(np.float32) * 90
    path = str(tmp_path / "d.pfm")
    jax_write_pfm(path, data)
    calls = []
    read = native.pfm_read_native
    monkeypatch.setattr("adaptive_stereo_tpu_torch.data.loaders.pfm_read_native",
                        lambda p: calls.append(p) or read(p))
    got = load_disp_sceneflow(path)
    assert calls == [path] and got.shape == (20, 30, 1)
    np.testing.assert_array_equal(got, jax_load_disp_sceneflow(path))
    with pytest.raises(IOError, match="pfm_read header failed"):
        native.pfm_read_native(str(tmp_path / "missing.pfm"))


def _resize_f32(img, oh, ow):
    """The C loop of resize_bilinear_f32 in float32, each operation rounded."""
    h, w, _ = img.shape

    def taps(n_out, n_in):
        f = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
        f = np.clip(f, 0.0, n_in - 1)
        i0 = f.astype(np.int64)
        return i0, np.minimum(i0 + 1, n_in - 1), (f - i0).astype(np.float32)

    x0, x1, wx = taps(ow, w)
    y0, y1, wy = taps(oh, h)
    wx, wy = wx[None, :, None], wy[:, None, None]
    p00, p01 = img[y0][:, x0], img[y0][:, x1]
    p10, p11 = img[y1][:, x0], img[y1][:, x1]
    top = p00 + wx * (p01 - p00)
    bot = p10 + wx * (p11 - p10)
    return top + wy * (bot - top)


@pytest.mark.parametrize("out_hw", [(16, 32), (80, 100), (37, 53), (9, 7)])
def test_resize_equals_jax_native(jax_libs, out_hw):
    img = np.random.RandomState(0).rand(37, 53, 3).astype(np.float32)
    got = native.resize_bilinear_native(img, *out_hw)
    assert got.shape == (*out_hw, 3)
    np.testing.assert_array_equal(got, _resize_f32(img, *out_hw))
    same_flags = np.empty_like(got)
    jax_libs["port_flags"].resize_bilinear_f32(jax_native._fptr(img), 37, 53, 3,
                                               jax_native._fptr(same_flags), *out_hw)
    np.testing.assert_array_equal(got, same_flags)
    want = jax_native.resize_bilinear_native(img, *out_hw)
    diff = np.abs(got - want).max()
    print(f"resize to {out_hw}: max |port - JAX's -march=native build| {diff:.3g}")
    assert diff <= 4 * np.spacing(img.max())


def test_u8_to_f32_equals_jax_native(jax_libs):
    img = np.random.RandomState(1).randint(0, 256, (13, 17, 3)).astype(np.uint8)
    got = native.u8_to_f32_native(img)
    want = np.empty(img.shape, np.float32)
    jax_native._load().u8_to_f32_scaled(
        img.ctypes.data_as(jax_native.ctypes.POINTER(jax_native.ctypes.c_uint8)),
        jax_native._fptr(want), img.size)
    np.testing.assert_array_equal(got, want)


def test_a_failed_build_raises_with_the_command(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "_BUILD_DIR", tmp_path)
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="building the native library failed: false"):
        native.build()
    assert not list(tmp_path.iterdir())


def test_library_is_named_by_source_and_flags_in_the_build_directory():
    path = native.library_path()
    assert path.parent == native._SOURCE.parents[1] / "_build"
    assert path.name.startswith("libstereo_native_") and path.suffix == ".so"
    assert native._SOURCE.name == "stereo_native.cpp"


def test_serving_takes_the_native_grid(monkeypatch):
    """The engine's host geometry calls the native grid, not its plain
    version."""
    calls = []
    grid = native.voxel_downsample_native
    monkeypatch.setattr(stream, "voxel_downsample_native",
                        lambda *a: calls.append(len(a[0])) or grid(*a))
    monkeypatch.setattr(stream, "voxel_downsample", lambda *a: pytest.fail("numpy grid"))

    pending = stream._Pending(torch.full((8, 12), 4.0), torch.full((8, 12), 4.0),
                              torch.rand(8, 12, 3), None, 0.0)
    engine = stream.StereoDepthEngine.__new__(stream.StereoDepthEngine)
    engine.config, engine.on_disparity, engine.on_pointcloud = ServingConfig(), None, None
    engine.k_voxel = np.array([[60.0, 0, 6], [0, 60.0, 4], [0, 0, 1]])
    out = engine._collect(pending)
    assert calls == [96] and len(out["points"]) > 0


def test_serving_engine_loads_the_library_when_built(monkeypatch):
    """The engine's constructor builds and loads the native library, so a
    missing compiler fails the construction, not the first served frame."""
    from adaptive_stereo_tpu_torch.models import StereoModel, random_init_

    model = random_init_(StereoModel(k=2, device="cpu"), torch.Generator().manual_seed(0))
    weights = (model.feature_net.state_dict(), model.stereo_net.state_dict())
    config = ServingConfig(model_input_height=32, model_input_width=64, stereonet_k=2,
                           input_scale=0, compute_dtype="float32")
    calls = []
    monkeypatch.setattr(native, "library", lambda: calls.append(1))
    stream.StereoDepthEngine(config, weights, device="cpu")
    assert calls == [1]

    def no_compiler():
        raise RuntimeError("building the native library failed: c++")
    monkeypatch.setattr(native, "library", no_compiler)
    with pytest.raises(RuntimeError, match="building the native library failed"):
        stream.StereoDepthEngine(config, weights, device="cpu")
