"""The port's TensorBoard event files (utils/event_file.py, the MetricsWriter
of utils/logging_utils.py) and their reader (analysis/tb_extract.py
read_scalars) against the JAX package's writer (tensorboardX) and reader
(tensorboard's EventAccumulator), on the CPU.

- CRC-32C: the native library's against the Python table version and the
  RFC 3720 check value;
- the same add_scalar / log_scalars / log_images calls through both
  writers, read back by EventAccumulator: the same tags and steps, float32
  values bitwise (edge values included: a denormal, beyond float32's range,
  NaN, -0.0), and decoded image pixels bitwise;
- read_scalars against JAX's on a JAX-written directory of one file:
  equal; with two files in one directory, each record once (JAX's reader
  gives each twice; the test prints its count);
- a flipped byte raises naming the file and offset; a truncated last
  record is dropped;
- the streaming driver (adapt --engine flat) of both packages on the tiny
  dataset of tests/test_torch_driver.py: the same tags and steps in adapt/
  and train/, values within that test's after-update band (1e-4 + 2e-3
  relative; the two frameworks' runs are not bitwise).
"""

import io
import os

import numpy as np
import pytest
import torch
from PIL import Image
from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

import adaptive_stereo_tpu.engine.config as jax_config
import adaptive_stereo_tpu.engine.stream_driver as jax_driver
import adaptive_stereo_tpu_torch.engine.config as port_config
import adaptive_stereo_tpu_torch.engine.stream_driver as port_driver
from adaptive_stereo_tpu.analysis.tb_extract import read_scalars as jax_read_scalars
from adaptive_stereo_tpu.utils.logging_utils import MetricsWriter as JaxWriter
from adaptive_stereo_tpu_torch.analysis.tb_extract import read_scalars
from adaptive_stereo_tpu_torch.data.native import crc32c_native
from adaptive_stereo_tpu_torch.utils.event_file import (EventFileWriter, crc32c_py,
                                                        decode_event, read_records)
from adaptive_stereo_tpu_torch.utils.logging_utils import MetricsWriter
from test_torch_driver import GUARD, _cfg, _few_threads, data  # noqa: F401 (fixtures)
from test_torch_train import AFTER_UPDATE_TOL

H, W = 12, 20


def _accumulate(log_dir):
    acc = EventAccumulator(log_dir, size_guidance={"scalars": 0, "images": 0})
    acc.Reload()
    return acc


def test_crc32c_native_matches_python_and_rfc3720():
    assert crc32c_native(b"123456789") == crc32c_py(b"123456789") == 0xE3069283
    rng = np.random.RandomState(0)
    for n in (0, 1, 7, 8, 255, 4096, 100_003):
        data = rng.randint(0, 256, n).astype(np.uint8).tobytes()
        assert crc32c_native(data) == crc32c_py(data), n
    data = rng.randint(0, 256, 1000).astype(np.uint8).tobytes()
    assert crc32c_native(data[600:], crc32c_native(data[:600])) == crc32c_native(data)


def _batches(rng):
    """The inputs and outputs of a log_images call: images, disparities,
    a one-channel mask, a two-channel map (skipped), cost volumes and FCS
    maps (skipped by the default prefixes) and a 2-D map (skipped)."""
    inputs = {"color_l/0": rng.rand(2, H, W, 3).astype(np.float32),
              "gt_disp_l/0": (rng.rand(2, H, W, 1) * 30).astype(np.float32),
              "cost_volume_l/3": rng.rand(2, 4, H, W).astype(np.float32)}
    outputs = {"pred_disp_l/0": (rng.rand(2, H, W, 1) * 40).astype(np.float32),
               "mask": (rng.rand(2, H, W, 1) * 1.4 - 0.2).astype(np.float32),
               "flow": rng.rand(2, H, W, 2).astype(np.float32),
               "fcs_l/3": rng.rand(2, H, W, 1).astype(np.float32),
               "plane": rng.rand(2, H, W).astype(np.float32)}
    return inputs, outputs


def _drive(writer, as_tensors):
    rng = np.random.RandomState(1)
    conv = (lambda d: {k: torch.from_numpy(v) for k, v in d.items()}) if as_tensors else dict
    for i, v in enumerate([1.5, np.float32(2.5), 1e-40, 3.4e39, float("nan"), -0.0, 7,
                           np.float64(0.1), np.float32(1e-3)]):
        writer.add_scalar("a b/c" if i % 2 else "/fcs/raw", v, i * 2**35)
    for step in (3, 9):
        writer.log_scalars({"EPE": 1.0 / step, "D1_all_3px": 0.2}, {"Monodepth/total_loss": 0.3},
                           12.5, 1, step)
        writer.log_images(*map(conv, _batches(rng)), step)
    writer.close()


def test_writer_matches_tensorboardx(tmp_path):
    _drive(JaxWriter(str(tmp_path / "jax")), as_tensors=False)
    _drive(MetricsWriter(str(tmp_path / "port")), as_tensors=True)
    want, got = _accumulate(str(tmp_path / "jax")), _accumulate(str(tmp_path / "port"))
    for kind in ("scalars", "images"):
        assert sorted(got.Tags()[kind]) == sorted(want.Tags()[kind]), kind
    print("scalar tags", sorted(got.Tags()["scalars"]), "images", sorted(got.Tags()["images"]))
    assert {"a_b/c", "fcs/raw", "EPE", "examples_per_sec"} <= set(got.Tags()["scalars"])
    assert sorted(got.Tags()["images"]) == ["color_l/0", "gt_disp_l/0", "mask", "pred_disp_l/0"]
    for tag in want.Tags()["scalars"]:
        a, b = got.Scalars(tag), want.Scalars(tag)
        assert [e.step for e in a] == [e.step for e in b], tag
        assert np.array([e.value for e in a]).tobytes() == np.array([e.value for e in b]).tobytes()
    for tag in want.Tags()["images"]:
        a, b = got.Images(tag), want.Images(tag)
        assert [e.step for e in a] == [e.step for e in b] == [3, 9], tag
        for x, y in zip(a, b):
            assert (x.height, x.width) == (y.height, y.width) == (H, W)
            px = [np.asarray(Image.open(io.BytesIO(e.encoded_image_string))) for e in (x, y)]
            assert px[0].shape == (H, W, 3)
            np.testing.assert_array_equal(px[0], px[1], err_msg=tag)


def test_read_scalars_matches_jax_on_one_file(tmp_path):
    _drive(JaxWriter(str(tmp_path)), as_tensors=False)
    got, want = read_scalars(str(tmp_path)), jax_read_scalars(str(tmp_path))
    assert list(got) and sorted(got) == sorted(want)
    for tag in want:
        np.testing.assert_array_equal(got[tag][0], want[tag][0], err_msg=tag)
        assert got[tag][1].tobytes() == want[tag][1].tobytes(), tag
    sub = read_scalars(str(tmp_path), tags=["EPE"])
    assert list(sub) == ["EPE"] and list(sub["EPE"][0]) == [3, 9]


def test_two_files_in_one_directory_read_once(tmp_path):
    """A resumed run opens a second writer in the same log directory."""
    for lo, writer_cls in ((0, JaxWriter), (3, JaxWriter)):
        w = writer_cls(str(tmp_path / "jax"))
        for step in range(lo, lo + 3):
            w.add_scalar("fcs/raw", 0.5 * step, step)
        w.close()
        if lo == 0:  # tensorboardX would reopen the same name within the second
            name = next(f for f in os.listdir(tmp_path / "jax") if "tfevents" in f)
            os.rename(tmp_path / "jax" / name, tmp_path / "jax" / (name + ".first"))
    steps = read_scalars(str(tmp_path / "jax"))["fcs/raw"][0]
    jax_steps = jax_read_scalars(str(tmp_path / "jax"))["fcs/raw"][0]
    print(f"two files: port reads {len(steps)} records {list(steps)}, JAX {len(jax_steps)} "
          f"{list(jax_steps)}")
    assert list(steps) == list(range(6))
    assert list(jax_steps) == sorted(list(range(6)) * 2)
    writers = [MetricsWriter(str(tmp_path / "port")) for _ in range(2)]
    for i, w in enumerate(writers):
        for step in range(3 * i, 3 * i + 3):
            w.add_scalar("fcs/raw", 0.5 * step, step)
        w.close()
    files = sorted(f for f in os.listdir(tmp_path / "port") if "tfevents" in f)
    assert len(files) == 2
    steps, values = read_scalars(str(tmp_path / "port"))["fcs/raw"]
    assert list(steps) == list(range(6)) and list(values) == [0.5 * s for s in range(6)]


def test_corrupt_record_raises_and_truncated_tail_is_dropped(tmp_path):
    w = EventFileWriter(str(tmp_path / "a"))
    for step in range(5):
        w.add_scalar("loss", float(step), step)
    w.close()
    raw = open(w.path, "rb").read()
    records = list(read_records(w.path))
    assert len(records) == 6 and decode_event(records[0])["file_version"] == b"brain.Event:2"
    # The third scalar record starts after the version record and two more.
    offset = sum(len(r) + 16 for r in records[:3])
    for where in (offset + 4, offset + 14):  # the length's checksum; the data
        bad = bytearray(raw)
        bad[where] ^= 0x10
        path = tmp_path / f"bad{where}.tfevents"
        path.write_bytes(bytes(bad))
        with pytest.raises(ValueError, match=f"bad{where}.tfevents: bad .* at byte {offset}"):
            list(read_records(str(path)))
    for cut in (3, 9, 16):
        (tmp_path / "cut").mkdir(exist_ok=True)
        (tmp_path / "cut" / "x.tfevents").write_bytes(raw[:-cut])
        assert list(read_scalars(str(tmp_path / "cut"))["loss"][0]) == [0, 1, 2, 3], cut


def test_stream_driver_event_files_match_jax(data, tmp_path):
    """adapt_streaming of both packages (tests/test_torch_driver.py's run):
    the same tags and steps in each writer's directory, values within the
    after-update band."""
    variables = data[2]
    kw = dict(fused_er_forward=True, done_batch=2)
    jax_driver.adapt_streaming(_cfg(jax_config, data, tmp_path, "jax", **GUARD),
                               variables=variables, engine="flat", **kw)
    port_driver.adapt_streaming(_cfg(port_config, data, tmp_path, "port", **GUARD),
                                variables=variables, device="cpu", **kw)
    for sub in ("adapt", "train"):
        got = read_scalars(str(tmp_path / "port" / sub))
        want = jax_read_scalars(str(tmp_path / "jax" / sub))
        print(f"{sub}: " + ", ".join(f"{t} x{len(got[t][0])}" for t in sorted(got)))
        assert sorted(got) == sorted(want), sub
        for tag in want:
            np.testing.assert_array_equal(got[tag][0], want[tag][0], err_msg=tag)
            np.testing.assert_allclose(got[tag][1], want[tag][1], err_msg=tag,
                                       **AFTER_UPDATE_TOL)
    adapt = read_scalars(str(tmp_path / "port" / "adapt"))
    assert list(adapt["fcs/raw"][0]) == list(range(12))
    assert {"fcs/smoothed", "GRADIENT_UPDATES", "EPE"} <= set(adapt)
