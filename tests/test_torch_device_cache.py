"""The device frame caches (engine/device_cache.py) and
adapt_streaming(device_cache=True), on the CPU.

- DeviceStreamCache holds what the JAX package's does, bit for bit: uint8
  colours at input_scale 0, float32 above it, float32 ground truth (zeros
  where the dataset has none); fetch(i) gives views into the cache;
- DeviceCachedLoader's batches go through engine/evaluate.py as they are
  (no copy) and give the loader's metrics;
- the cached driver against the upload path on the same data at input
  scale 0, bit for bit: the ring log, the final parameters, Adam's state,
  the running statistics, the reservoir and trials.csv, with all four
  guard channels (their probes read the cached validation batches), the
  fused ER forward and batched done steps; and against the upload path with
  transfer_uint8;
- device_cache refuses batch_size > 1, and runs from the command line.
"""

import numpy as np
import pytest
import torch

import adaptive_stereo_tpu_torch.engine.config as port_config
import adaptive_stereo_tpu_torch.engine.stream_driver as port_driver
from adaptive_stereo_tpu.data import StereoDataset as JaxStereoDataset
from adaptive_stereo_tpu.engine.device_cache import DeviceStreamCache as JaxStreamCache
from adaptive_stereo_tpu_torch.cli import main
from adaptive_stereo_tpu_torch.data import BatchLoader, StereoDataset
from adaptive_stereo_tpu_torch.engine import (DeviceCachedLoader, DeviceStreamCache, evaluate,
                                              save_variables)
from adaptive_stereo_tpu_torch.engine.flat_stream import dequantize_u8
from adaptive_stereo_tpu_torch.engine.steps import make_eval_step
from adaptive_stereo_tpu_torch.models import StereoModel, random_init_, variables_from_state_dicts
from test_torch_driver import GUARD, H, W, _args, _cfg, _read_csv, data  # noqa: F401
from test_torch_train import K, _port


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads (see tests/test_torch_driver.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _datasets(root, scale, uint8, subsplit="train"):
    kw = dict(scales=[scale, scale + K], do_hflip=False, random_crop=False,
              load_disp_left=True, load_disp_right=False, color_uint8=uint8)
    return [cls(root, "Synthetic", "synth", H, W, subsplit, **kw)
            for cls in (StereoDataset, JaxStereoDataset)]


@pytest.mark.parametrize("scale, uint8", [(0, True), (1, False), (0, False)])
def test_stream_cache_holds_what_jax_holds(data, scale, uint8):
    port_ds, jax_ds = _datasets(data[1], scale, uint8)
    cache = DeviceStreamCache(port_ds, scale, uint8, "cpu", num_workers=2)
    ref = JaxStreamCache(jax_ds, scale, uint8, num_workers=2)
    assert len(cache) == len(ref) == len(port_ds)
    want_dtype = torch.uint8 if uint8 else torch.float32
    assert cache.left.dtype == cache.right.dtype == want_dtype
    assert cache.gt.dtype == torch.float32 and cache.left.device.type == "cpu"
    for mine, theirs in ((cache.left, ref.left), (cache.right, ref.right), (cache.gt, ref.gt)):
        np.testing.assert_array_equal(mine.numpy(), np.asarray(theirs))
    assert cache.nbytes == sum(t.numel() * t.element_size()
                               for t in (cache.left, cache.right, cache.gt))
    frame = cache.fetch(3)
    ref_frame = ref.fetch(3)
    assert set(frame) == set(ref_frame) == {f"color_l/{scale}", f"color_r/{scale}",
                                            f"gt_disp_l/{scale}"}
    for key, value in frame.items():
        assert value.shape[0] == 1 and value._base is not None  # a view, not a copy
        np.testing.assert_array_equal(value.numpy(), np.asarray(ref_frame[key]))


def test_stream_cache_without_ground_truth_holds_zeros(data):
    port_ds, _ = _datasets(data[1], 0, True)
    items = [{k: v for k, v in port_ds[i].items() if not k.startswith("gt")} for i in range(3)]
    cache = DeviceStreamCache(port_ds, 0, True, "cpu", items=items)
    assert cache.gt.shape == (3, H, W, 1) and not cache.gt.any()


def test_cached_loader_goes_through_evaluate_as_it_is(data, monkeypatch):
    port_ds, _ = _datasets(data[1], 0, False, subsplit="val")
    loader = BatchLoader(port_ds, 2, shuffle=False, num_workers=1)
    cached = DeviceCachedLoader(loader, "cpu")
    assert len(cached) == len(loader) and cached.batch_size == 2
    model = _port(data[2], fused_siamese=True, fused_tower=True)
    step = make_eval_step(model, 0, K)
    want = evaluate(step, model, loader)
    seen = []
    monkeypatch.setattr(torch, "from_numpy", lambda *a: pytest.fail("copied a cached batch"))
    got = evaluate(lambda batch: seen.append(batch) or step(batch), model, cached)
    assert got == want
    for batch, ref in zip(seen, cached):
        assert all(batch[k] is ref[k] for k in ref)


def _states_equal(a, b):
    for f in ("params", "m", "v", "buffers"):
        assert all(torch.equal(x, y) for x, y in zip(getattr(a, f), getattr(b, f))), f
    for f in ("count", "ema_value", "ema_init", "log", "log_pos"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    for f in ("left", "right", "values", "reg_indices", "size", "count"):
        assert torch.equal(getattr(a.reservoir, f), getattr(b.reservoir, f)), f


@pytest.mark.parametrize("upload_uint8", [False, True])
def test_cached_driver_equals_the_upload_path(data, tmp_path, upload_uint8):
    variables = data[2]
    kw = dict(fused_er_forward=True, done_batch=2, device="cpu")
    run = lambda name, **extra: port_driver.adapt_streaming(
        _cfg(port_config, data, tmp_path, name, **GUARD), variables=variables, **kw, **extra)
    cached = run("cached", device_cache=True)
    upload = run("upload", transfer_uint8=upload_uint8)
    for key in ("steps", "gradient_updates", "guard_rollbacks", "final_state",
                "final_metrics"):
        assert cached[key] == upload[key], key
    assert cached["steps"] == 12 and cached["gradient_updates"] > 0
    assert cached["guard_rollbacks"] > 0  # a guard channel read the cached batches
    _states_equal(cached["stream_state"], upload["stream_state"])
    assert _read_csv(tmp_path / "cached" / "trials.csv") == \
        _read_csv(tmp_path / "upload" / "trials.csv")


def test_dequantize_u8_is_the_hosts_float32_division():
    """Every uint8 level dequantizes to the bits of the dataset's float32
    division (the card's division by a Python scalar would not: it
    multiplies by the reciprocal)."""
    levels = np.arange(256, dtype=np.uint8)
    got = dequantize_u8(torch.from_numpy(levels)).numpy()
    np.testing.assert_array_equal(got, levels.astype(np.float32) / 255.0)
    assert got.dtype == np.float32


def test_device_cache_refuses_batches_of_two(data, tmp_path):
    cfg = _cfg(port_config, data, tmp_path, "batch2", adapt_mode="ER")
    cfg.data.batch_size = 2
    with pytest.raises(ValueError, match="device_cache requires batch_size=1"):
        port_driver.adapt_streaming(cfg, variables=data[2], device_cache=True, device="cpu")


def test_cli_adapt_flat_with_device_cache(data, tmp_path, capsys):
    model = random_init_(StereoModel(k=3, input_scale=0, device="cpu"),
                         torch.Generator().manual_seed(4))
    save_variables(str(tmp_path / "w"), variables_from_state_dicts(
        model.feature_net.state_dict(), model.stereo_net.state_dict(), 3))
    rc = main(_args(data, tmp_path, "--engine", "flat", "--device_cache", "--device", "cpu",
                    "--load_weights_folder", str(tmp_path / "w")))
    assert rc == 0 and "Done with adaptation!" in capsys.readouterr().out
    head, rows = _read_csv(tmp_path / "logs" / "cli" / "trials.csv")
    assert [r[head.index("step")] for r in rows] == ["-1", "4"]
