"""The port's JPEG codec (data/jpeg.py, csrc/jpeg_codec.cpp) against cv2,
the JAX package's reader (cv2.imread(path, IMREAD_COLOR), libjpeg-turbo),
on the CPU:

- decode bitwise equal to cv2's RGB at 4:4:4, 4:2:2 and 4:2:0, quality
  75, 95 and 100, at 37x53, 64x96 and 375x1242; with restart intervals,
  optimized Huffman tables, gray, 4:4:0 and 4:1:1 sampling, noise at
  quality 100 (the IDCT's range limit), and files written by PIL and
  imageio (the JAX drill's writer): exact in every mode;
- progressive, CMYK and non-JPEG bytes raise ValueError naming what they
  are; nothing falls back;
- the port's encoder: cv2 decodes its bytes to exactly the port's decode,
  at a PSNR of at least 30 dB against the source at quality 75 and within
  1 dB of PIL's at the same settings (printed);
- chip_smoke.py's JPEG frame hashes to JPEG_FRAME_SHA256, the constant the
  card's host is held to;
- StereoDataset items of JPEG VirtualKitti and KittiRaw splits (written by
  the port's make_readiness_minidata) equal the JAX package's: frames and
  disparities at scale 0 exact, resized within test_torch_data.py's 1e-5.
"""

import hashlib
import io

import cv2
import imageio.v2 as imageio
import numpy as np
import pytest
from PIL import Image

import chip_smoke
from adaptive_stereo_tpu.data import StereoDataset as JaxStereoDataset
from adaptive_stereo_tpu_torch.data import StereoDataset, decode_jpeg, encode_jpeg, read_jpeg
from adaptive_stereo_tpu_torch.scripts.make_readiness_minidata import materialize_split

RESIZE_TOL = dict(atol=1e-5, rtol=0)
SAMPLING = {"4:4:4": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            "4:2:2": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "4:2:0": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
            "4:4:0": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
            "4:1:1": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411}


def _cv2_bytes(rgb, *params):
    ok, buf = cv2.imencode(".jpg", rgb[..., ::-1] if rgb.ndim == 3 else rgb, list(params))
    assert ok
    return buf.tobytes()


def _cv2_rgb(data: bytes) -> np.ndarray:
    return cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)[..., ::-1]


def _assert_decodes_as_cv2(data: bytes):
    got, want = decode_jpeg(data), _cv2_rgb(data)
    assert got.dtype == np.uint8 and got.shape == want.shape
    off = np.abs(got.astype(np.int16) - want).max(axis=-1) > 0
    print(f"pixels off cv2: {off.mean():.6f}")
    np.testing.assert_array_equal(got, want)


def _psnr(a, b) -> float:
    return 10 * np.log10(255.0 ** 2 / np.mean((a.astype(np.float64) - b) ** 2))


@pytest.mark.parametrize("shape", [(37, 53), (64, 96), (375, 1242)])
@pytest.mark.parametrize("quality", [75, 95, 100])
@pytest.mark.parametrize("sampling", ["4:4:4", "4:2:2", "4:2:0"])
def test_decode_equals_cv2(shape, quality, sampling):
    frame = chip_smoke.jpeg_frame(quality, shape)
    _assert_decodes_as_cv2(_cv2_bytes(frame, cv2.IMWRITE_JPEG_QUALITY, quality,
                                      cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling]))


@pytest.mark.parametrize("mode", ["restart", "optimize", "gray", "4:4:0", "4:1:1", "noise"])
def test_decode_modes_equal_cv2(mode):
    frame = chip_smoke.jpeg_frame(7, (61, 117))
    params = {"restart": (cv2.IMWRITE_JPEG_RST_INTERVAL, 3),
              "optimize": (cv2.IMWRITE_JPEG_OPTIMIZE, 1),
              "gray": (cv2.IMWRITE_JPEG_QUALITY, 90),
              "4:4:0": (cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING["4:4:0"]),
              "4:1:1": (cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING["4:1:1"]),
              "noise": (cv2.IMWRITE_JPEG_QUALITY, 100)}[mode]
    if mode == "gray":
        frame = frame[..., 1]
    if mode == "noise":
        frame = np.random.RandomState(3).randint(0, 256, frame.shape).astype(np.uint8)
    _assert_decodes_as_cv2(_cv2_bytes(frame, *params))


@pytest.mark.parametrize("writer", ["imageio", "pil-4:4:4", "pil-4:2:2", "pil-4:2:0-optimize"])
def test_decode_equals_cv2_on_pil_files(writer, tmp_path):
    frame = chip_smoke.jpeg_frame(11, (45, 70))
    path = str(tmp_path / "f.jpg")
    if writer == "imageio":
        imageio.imwrite(path, frame)
    else:
        sub = {"4:4:4": 0, "4:2:2": 1, "4:2:0": 2}[writer.split("-")[1]]
        Image.fromarray(frame).save(path, "JPEG", quality=85, subsampling=sub,
                                    optimize=writer.endswith("optimize"))
    np.testing.assert_array_equal(read_jpeg(path), cv2.imread(path, cv2.IMREAD_COLOR)[..., ::-1])


def test_unsupported_jpegs_raise():
    frame = chip_smoke.jpeg_frame(1, (24, 40))
    with pytest.raises(ValueError, match=r"progressive \(SOF2\)"):
        decode_jpeg(_cv2_bytes(frame, cv2.IMWRITE_JPEG_PROGRESSIVE, 1))
    buf = io.BytesIO()
    Image.fromarray(frame).convert("CMYK").save(buf, "JPEG")
    with pytest.raises(ValueError, match="4 components"):
        decode_jpeg(buf.getvalue())
    with pytest.raises(ValueError, match="not a JPEG"):
        decode_jpeg(b"\x89PNG\r\n\x1a\n")
    with pytest.raises(ValueError, match="corrupt JPEG"):
        decode_jpeg(_cv2_bytes(frame)[:200])


@pytest.mark.parametrize("sampling", ["4:4:4", "4:2:2", "4:2:0"])
def test_encoder_bytes_decode_alike_in_cv2(sampling):
    frame = chip_smoke.jpeg_frame(2, (120, 250))
    data = encode_jpeg(frame, quality=75, subsampling=sampling)
    _assert_decodes_as_cv2(data)
    buf = io.BytesIO()
    Image.fromarray(frame).save(buf, "JPEG", quality=75,
                                subsampling={"4:4:4": 0, "4:2:2": 1, "4:2:0": 2}[sampling])
    mine, pil = _psnr(frame, decode_jpeg(data)), _psnr(frame, _cv2_rgb(buf.getvalue()))
    print(f"{sampling} quality 75: PSNR {mine:.2f} dB ({len(data)} bytes), PIL's "
          f"{pil:.2f} dB ({len(buf.getvalue())} bytes)")
    assert mine >= 30.0 and mine >= pil - 1.0


def test_jpeg_frame_sha256():
    """The bytes phase 15 (a) of chip_smoke.py encodes and decodes on the
    card's host, held against cv2 here, where cv2 exists."""
    data = encode_jpeg(chip_smoke.jpeg_frame(), quality=chip_smoke.JPEG_QUALITY,
                       subsampling="4:2:0")
    decoded = decode_jpeg(data)
    np.testing.assert_array_equal(decoded, _cv2_rgb(data))
    assert decoded.shape == (*chip_smoke.JPEG_FRAME_SHAPE, 3)
    assert hashlib.sha256(decoded.tobytes()).hexdigest() == chip_smoke.JPEG_FRAME_SHA256


@pytest.mark.parametrize("dataset,split,disp_format", [
    ("VirtualKitti", "virtual_kitti_01_adapt", "vkitti_depth"),
    ("KittiRaw", "kitti_raw_campus_adapt", "kitti_npy")])
@pytest.mark.parametrize("uint8", [False, True])
def test_stereo_dataset_jpeg_items_equal_jax(tmp_path, dataset, split, disp_format, uint8):
    root = str(tmp_path / dataset)
    materialize_split(root, split, ("train",), 2, disp_format, seed=4, height=40, width=72)
    args = (root, dataset, split, 32, 64, "train")
    kw = dict(scales=(0, 2), color_uint8=uint8)
    mine, ref = StereoDataset(*args, **kw), JaxStereoDataset(*args, **kw)
    assert mine.lines[0].split(" ")[0].endswith(".jpg")
    for i in range(2):
        a, b = mine[i], ref[i]
        assert sorted(a) == sorted(b)
        for key in b:
            assert a[key].dtype == b[key].dtype and a[key].shape == b[key].shape, key
            if key.endswith("/0"):
                np.testing.assert_array_equal(a[key], b[key], err_msg=key)
            else:
                np.testing.assert_allclose(a[key], b[key], err_msg=key, **RESIZE_TOL)
