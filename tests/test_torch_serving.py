"""The port's serving engine vs the JAX package's, float32 on both sides,
with the default coarse head and with fused_coarse_head=True (which the JAX
engine takes on a TPU backend only, so on the CPU it runs its XLA head; the
port runs the plain versions of its kernels either way).

Same config, same weights (carried by state_dicts_from_jax), same frames
from a numpy seed. The JAX engine runs its XLA forward and cv2 resizes on
the CPU; the port's engine runs on the CPU, where the kernel wrappers take
their plain versions and the voxel-scale resizes are F.interpolate.

Tolerances: disparity 2e-3 absolute + 1e-4 relative (the model band of
tests/test_model_parity.py); depth is fx*b/disp, so 1e-4 relative + 1e-3 m
absolute covers that band; points are compared after sorting rows, at
1e-3 absolute. The on_disparity images (the voxel-scale disparity through
the magma table): the port's equal bit for bit to the colormap of its own
voxel-scale disparity, and JAX's within one step of the 256-entry table
(a disparity within the band may sit on the other side of a bin's edge)
with at most 1 % of the pixels apart.
"""

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from adaptive_stereo_tpu.data import StereoDataset as JaxStereoDataset
from adaptive_stereo_tpu.models import StereoModel as JaxStereoModel
from adaptive_stereo_tpu.serving import (
    ServingConfig as JaxServingConfig,
    StereoDepthEngine as JaxEngine,
    replay_dataset_stream as jax_replay,
)
from adaptive_stereo_tpu_torch.data import StereoDataset, generate_synthetic_dataset
from adaptive_stereo_tpu_torch.models import state_dicts_from_jax
from adaptive_stereo_tpu_torch.serving import (
    AsyncStereoDepthEngine,
    ServingConfig,
    StereoDepthEngine,
    replay_dataset_stream,
    voxel_downsample,
)
from adaptive_stereo_tpu_torch.utils.visualization import MAGMA_RGB, apply_disparity_colormap

H, W, K = 64, 128, 3
# The largest difference of two neighbouring magma entries.
LUT_STEP = np.abs(np.diff(MAGMA_RGB, axis=0)).max()
INTRINSICS = np.array([[60.0, 0, W / 2], [0, 60.0, H / 2], [0, 0, 1.0]])
DISP_TOL = dict(atol=2e-3, rtol=1e-4)


def _config(cls, **kw):
    return cls(model_input_height=H, model_input_width=W, stereonet_k=K, input_scale=0,
               compute_dtype="float32", voxel_disp_scale=2,
               camera_intrinsics=INTRINSICS.copy(), **kw)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.RandomState(0)
    frames = [(rng.rand(H, W, 3).astype(np.float32), rng.rand(H, W, 3).astype(np.float32))
              for _ in range(3)]
    variables = JaxStereoModel(k=K, input_scale=0).init(
        jax.random.PRNGKey(0), jnp.asarray(frames[0][0][None]),
        jnp.asarray(frames[0][1][None]), train=False)
    variables = jax.tree.map(np.asarray, dict(variables))
    return variables, frames


def _sorted_rows(a):
    return a[np.lexsort(a.T[::-1])]


def _check_engine_against_jax(setup, **kw):
    variables, frames = setup
    ref_engine = JaxEngine(_config(JaxServingConfig, **kw), variables)
    clouds = []
    engine = StereoDepthEngine(_config(ServingConfig, **kw), state_dicts_from_jax(variables, K),
                               on_pointcloud=lambda p, c, t: clouds.append(t),
                               device="cpu")
    for i, (left, right) in enumerate(frames):
        ref = ref_engine.process(left, right, timestamp=float(i))
        out = engine.process(left, right, timestamp=float(i))
        assert out["disparity"].shape == (H, W)
        np.testing.assert_allclose(out["disparity"], ref["disparity"], **DISP_TOL)
        assert out["depth"].shape == ref["depth"].shape == (H // 4, W // 4)
        np.testing.assert_allclose(out["depth"], ref["depth"], rtol=1e-4, atol=1e-3)
        assert len(out["points"]) > 0
        assert out["points"].shape == ref["points"].shape
        np.testing.assert_allclose(_sorted_rows(out["points"]),
                                   _sorted_rows(ref["points"]), atol=1e-3)
        np.testing.assert_allclose(
            _sorted_rows(np.concatenate([out["points"], out["colors"]], 1))[:, 3:],
            _sorted_rows(np.concatenate([ref["points"], ref["colors"]], 1))[:, 3:],
            atol=1e-3)
    assert clouds == [0.0, 1.0, 2.0]
    assert engine.last_inference_sec is not None


def test_engine_matches_jax_engine(setup):
    _check_engine_against_jax(setup)


def test_fused_engine_matches_jax_engine(setup):
    _check_engine_against_jax(setup, fused_coarse_head=True)


def test_async_fused_engine_matches_sync_default_engine(setup):
    """One submit/flush round of the fused async engine gives what the sync
    engine with the default head gives (on the CPU both heads are the same
    plain ops)."""
    variables, frames = setup
    sds = state_dicts_from_jax(variables, K)
    sync = StereoDepthEngine(_config(ServingConfig), sds, device="cpu")
    eng = AsyncStereoDepthEngine(_config(ServingConfig, fused_coarse_head=True), sds,
                                 device="cpu")
    assert eng.model.stereo_net.fused_coarse_head
    (left, right) = frames[0]
    assert eng.submit(left, right, timestamp=0.0) is None
    got = eng.flush()
    want = sync.process(left, right)
    for key in ("disparity", "depth", "points", "colors"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_async_engine_matches_sync_engine(setup):
    variables, frames = setup
    sds = state_dicts_from_jax(variables, K)
    sync = StereoDepthEngine(_config(ServingConfig), sds, device="cpu")
    eng = AsyncStereoDepthEngine(_config(ServingConfig), sds, device="cpu")
    results = [eng.submit(l, r, timestamp=float(i)) for i, (l, r) in enumerate(frames)]
    assert results[0] is None
    results = results[1:] + [eng.flush()]
    assert eng.flush() is None
    for (left, right), got in zip(frames, results):
        want = sync.process(left, right)
        for key in ("disparity", "depth", "points", "colors"):
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_device_resize_matches_cv2_inter_linear():
    """The voxel-scale resize on the device (F.interpolate, bilinear,
    align_corners=False) equals cv2.INTER_LINEAR, which the JAX engine
    uses, for the engine's 4x downsampling of disparity and colour."""
    rng = np.random.RandomState(2)
    disp = (rng.rand(64, 128) * 40).astype(np.float32)
    rgb = rng.rand(64, 128, 3).astype(np.float32)
    d_t = F.interpolate(torch.from_numpy(disp)[None, None], size=(16, 32),
                        mode="bilinear", align_corners=False)[0, 0].numpy()
    c_t = F.interpolate(torch.from_numpy(rgb).permute(2, 0, 1)[None], size=(16, 32),
                        mode="bilinear", align_corners=False)[0].permute(1, 2, 0).numpy()
    np.testing.assert_allclose(d_t, cv2.resize(disp, (32, 16), interpolation=cv2.INTER_LINEAR),
                               rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(c_t, cv2.resize(rgb, (32, 16), interpolation=cv2.INTER_LINEAR),
                               rtol=1e-6, atol=1e-6)


def test_voxel_downsample_merges():
    pts = np.array([[0.01, 0.01, 0.01], [0.02, 0.02, 0.02], [1.0, 1.0, 1.0]])
    cols = np.array([[1, 0, 0], [0, 1, 0], [0, 0, 1]], np.float64)
    out_pts, out_cols = voxel_downsample(pts, 0.1, cols)
    assert out_pts.shape == (2, 3)
    np.testing.assert_allclose(out_pts[np.argmin(out_pts[:, 0])], [0.015] * 3, atol=1e-6)
    np.testing.assert_allclose(out_cols[np.argmin(out_pts[:, 0])], [0.5, 0.5, 0], atol=1e-6)


def test_engine_refuses_what_is_not_ported(setup):
    variables, _ = setup
    sds = state_dicts_from_jax(variables, K)
    fused = StereoDepthEngine(_config(ServingConfig, fused_coarse_head=True), sds, device="cpu")
    assert fused.model.stereo_net.fused_coarse_head
    engine = StereoDepthEngine(_config(ServingConfig), sds, device="cpu")
    assert not engine.model.stereo_net.fused_coarse_head
    with pytest.raises(ValueError):
        engine.process(np.full((H, W, 3), 2.0, np.float32), np.zeros((H, W, 3), np.float32))


def test_engine_loads_a_reference_weights_folder(setup, tmp_path):
    variables, frames = setup
    fsd, ssd = state_dicts_from_jax(variables, K)
    torch.save(fsd, tmp_path / "feature_net.pth")
    torch.save(ssd, tmp_path / "stereo_net.pth")
    a = StereoDepthEngine(_config(ServingConfig, load_weights_folder=str(tmp_path)),
                          device="cpu")
    b = StereoDepthEngine(_config(ServingConfig), (fsd, ssd), device="cpu")
    left, right = frames[0]
    np.testing.assert_array_equal(a.process(left, right)["disparity"],
                                  b.process(left, right)["disparity"])


def test_on_disparity_matches_jax(setup):
    """Every frame publishes at publish_disp_hz 1e6; at 1e-3 only the first
    does (the rate limit)."""
    variables, frames = setup
    for hz, published in ((1e6, len(frames)), (1e-3, 1)):
        calls = {"jax": [], "port": []}
        ref_engine = JaxEngine(_config(JaxServingConfig, publish_disp_hz=hz), variables,
                               on_disparity=lambda *a: calls["jax"].append(a))
        engine = StereoDepthEngine(_config(ServingConfig, publish_disp_hz=hz),
                                   state_dicts_from_jax(variables, K), device="cpu",
                                   on_disparity=lambda *a: calls["port"].append(a))
        outs = []
        for i, (left, right) in enumerate(frames):
            ref_engine.process(left, right, timestamp=float(i))
            outs.append(engine.process(left, right, timestamp=float(i)))
        assert len(calls["port"]) == len(calls["jax"]) == published
        for (img, scale, ts), (ref_img, ref_scale, ref_ts), out in zip(calls["port"],
                                                                      calls["jax"], outs):
            assert (scale, ts) == (ref_scale, ref_ts) == (2, ts)
            assert img.shape == ref_img.shape == (H // 4, W // 4, 3)
            assert img.dtype == ref_img.dtype == np.float32
            disp_v = F.interpolate(torch.from_numpy(out["disparity"])[None, None],
                                   size=(H // 4, W // 4), mode="bilinear",
                                   align_corners=False)[0, 0].numpy()
            np.testing.assert_array_equal(img, apply_disparity_colormap(disp_v))
            diff = np.abs(img - ref_img)
            assert diff.max() <= LUT_STEP and (diff > 0).any(axis=-1).mean() <= 0.01


def test_replay_dataset_stream_matches_jax(setup, tmp_path):
    variables, _ = setup
    generate_synthetic_dataset(str(tmp_path), name="synth", num_train=2, num_val=3, height=H,
                               width=W, max_disp=12.0, seed=6)
    kw = dict(scales=[0], load_disp_right=False)
    dataset = StereoDataset(str(tmp_path), "Synthetic", "synth", H, W, "val", **kw)
    ref_dataset = JaxStereoDataset(str(tmp_path), "Synthetic", "synth", H, W, "val", **kw)
    stamps = []
    engine = StereoDepthEngine(_config(ServingConfig), state_dicts_from_jax(variables, K),
                               on_pointcloud=lambda p, c, t: stamps.append(t), device="cpu")
    got = replay_dataset_stream(engine, dataset, num_frames=2)
    want = jax_replay(JaxEngine(_config(JaxServingConfig), variables), ref_dataset,
                      num_frames=2)
    assert len(got) == len(want) == 2 and stamps == [0.0, 1.0]
    for out, ref in zip(got, want):
        np.testing.assert_allclose(out["disparity"], ref["disparity"], **DISP_TOL)
        np.testing.assert_allclose(out["depth"], ref["depth"], rtol=1e-4, atol=1e-3)
    assert len(replay_dataset_stream(engine, dataset)) == 3
