"""The port's image reads against the JAX package's, on the CPU, with no
pixel off:

- the EXIF Orientation tag (data/exif.py): Orientation 0-9 in both TIFF
  byte orders, spliced into a JPEG's APP1 segment and into a PNG's eXIf
  chunk, through the port's _load_rgb against the JAX package's
  (cv2.imread(path, IMREAD_COLOR)); where cv2 looks for the tag (a second
  APP1, an APP1 after the image data, an eXIf chunk after IDAT, a bad CRC,
  a truncated IFD); load_disp_vkitti against JAX's (cv2, which applies the
  tag) and load_disp_kitti_stereo against JAX's (imageio, which does not);
- progressive JPEG (csrc/jpeg_codec.cpp) against cv2.imdecode: 4:2:0,
  4:2:2, 4:4:4, 4:4:0 and gray at odd and even sizes, with restart
  intervals, PIL's progressive files with optimized tables; files whose
  data ends early, or whose scans stop before every low AC coefficient is
  refined (cv2 smooths those: block smoothing), raise ValueError;
- the committed progressive fixtures (tests/data/jpeg/) hash to
  chip_smoke.PROGRESSIVE_JPEGS, the constants the card's host is held to.
"""

import hashlib
import io
import struct
import zlib
from pathlib import Path

import cv2
import numpy as np
import pytest
from PIL import Image

import chip_smoke
from adaptive_stereo_tpu.data import loaders as jax_loaders
from adaptive_stereo_tpu.data.stereo_dataset import _load_rgb as jax_load_rgb
from adaptive_stereo_tpu_torch.data import (apply_orientation, decode_jpeg, encode_png,
                                            exif_orientation, loaders)
from adaptive_stereo_tpu_torch.data.stereo_dataset import _load_rgb

FIXTURES = Path(__file__).resolve().parent / "data" / "jpeg"


def _tiff(orientation, order="II", ifd=8, count=None, value_type=3):
    """A TIFF block whose IFD0 holds one Orientation entry."""
    e = "<" if order == "II" else ">"
    value = (struct.pack(e + "HH", orientation, 0) if value_type == 3
             else struct.pack(e + "I", orientation))
    return (order.encode() + struct.pack(e + "HI", 42, ifd) + b"\0" * (ifd - 8)
            + struct.pack(e + "H", 1 if count is None else count)
            + struct.pack(e + "HHI", 0x0112, value_type, 1) + value + struct.pack(e + "I", 0))


def _app1(block, prefix=b"Exif\0\0"):
    return b"\xff\xe1" + struct.pack(">H", len(prefix) + len(block) + 2) + prefix + block


def _chunk(kind, body):
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def _png_chunks(data):
    pos, out = 8, []
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        out.append(data[pos:pos + 12 + n])
        pos += 12 + n
    return out


def _png_with(data, *chunks, after_idat=False):
    ihdr, *rest = _png_chunks(data)
    body = rest[:-1] + list(chunks) if after_idat else list(chunks) + rest[:-1]
    return data[:8] + ihdr + b"".join(body) + rest[-1]


FRAME = chip_smoke.jpeg_frame(7, (37, 53))
JPEG = bytes(cv2.imencode(".jpg", FRAME[..., ::-1], [cv2.IMWRITE_JPEG_QUALITY, 90])[1])
PNG = encode_png(FRAME)


def _assert_reads_as_jax(path, data):
    path.write_bytes(data)
    want = jax_load_rgb(str(path), uint8=True)
    np.testing.assert_array_equal(want, cv2.imread(str(path), cv2.IMREAD_COLOR)[..., ::-1])
    got = _load_rgb(str(path), uint8=True)
    assert got.shape == want.shape and got.flags["C_CONTIGUOUS"]
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(_load_rgb(str(path)), jax_load_rgb(str(path)))
    return got


@pytest.mark.parametrize("orientation", range(10))
@pytest.mark.parametrize("order", ["II", "MM"])
@pytest.mark.parametrize("container", ["jpeg", "png"])
def test_load_rgb_applies_the_orientation_as_cv2(container, order, orientation, tmp_path):
    """Orientation 1-8 transform the image, 0 and 9 leave it; the JAX side
    is cv2.imread. Against cv2's rotate and flip of the untagged read, each
    value is the transform named in data/exif.py."""
    block = _tiff(orientation, order)
    data = (JPEG[:2] + _app1(block) + JPEG[2:] if container == "jpeg"
            else _png_with(PNG, _chunk(b"eXIf", block)))
    got = _assert_reads_as_jax(tmp_path / f"f.{container}", data)
    plain = _assert_reads_as_jax(tmp_path / f"plain.{container}",
                                 JPEG if container == "jpeg" else PNG)
    assert exif_orientation(data) == orientation
    transform = {2: lambda a: cv2.flip(a, 1), 3: lambda a: cv2.rotate(a, cv2.ROTATE_180),
                 4: lambda a: cv2.flip(a, 0), 5: lambda a: cv2.transpose(a),
                 6: lambda a: cv2.rotate(a, cv2.ROTATE_90_CLOCKWISE),
                 7: lambda a: cv2.rotate(cv2.transpose(a), cv2.ROTATE_180),
                 8: lambda a: cv2.rotate(a, cv2.ROTATE_90_COUNTERCLOCKWISE)}
    want = transform.get(orientation, lambda a: a)(plain)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(apply_orientation(plain, orientation), want)


XMP = b"http://ns.adobe.com/xap/1.0/\0<x/>"
SOS = JPEG.index(b"\xff\xda")
PLACEMENTS = {
    # JPEG: the first Orientation entry of the APP1 "Exif" segments before SOS.
    "second APP1": JPEG[:2] + _app1(_tiff(3)) + _app1(_tiff(6)) + JPEG[2:],
    "XMP APP1 first": JPEG[:2] + _app1(XMP, b"") + _app1(_tiff(6)) + JPEG[2:],
    "no tag, then a tag": (JPEG[:2] + _app1(b"II*\0\x08\0\0\0\0\0\0\0\0\0") + _app1(_tiff(8))
                           + JPEG[2:]),
    "value 0 first": JPEG[:2] + _app1(_tiff(0)) + _app1(_tiff(6)) + JPEG[2:],
    "APP1 before SOS": JPEG[:SOS] + _app1(_tiff(5)) + JPEG[SOS:],
    "APP1 after the image data": JPEG[:-2] + _app1(_tiff(6)) + JPEG[-2:],
    "APP2 Exif": JPEG[:2] + b"\xff\xe2" + _app1(_tiff(6))[2:] + JPEG[2:],
    "Exif\\0\\1 prefix": JPEG[:2] + _app1(_tiff(6), b"Exif\0\1") + JPEG[2:],
    "IFD offset past the block": JPEG[:2] + _app1(_tiff(6)[:4] + b"\xff\0\0\0" + _tiff(6)[8:])
    + JPEG[2:],
    "IFD offset 12": JPEG[:2] + _app1(_tiff(7, "MM", ifd=12)) + JPEG[2:],
    "entry count past the block": JPEG[:2] + _app1(_tiff(6, count=9)) + JPEG[2:],
    "value cut after 2 bytes": JPEG[:2] + _app1(_tiff(6)[:-6]) + JPEG[2:],
    "value cut after 1 byte": JPEG[:2] + _app1(_tiff(6)[:-7]) + JPEG[2:],
    "LONG value, II": JPEG[:2] + _app1(_tiff(6, value_type=4)) + JPEG[2:],
    "LONG value, MM": JPEG[:2] + _app1(_tiff(6, "MM", value_type=4)) + JPEG[2:],
    # PNG: the first eXIf chunk libpng accepts, wherever it stands.
    "eXIf after IDAT": _png_with(PNG, _chunk(b"eXIf", _tiff(6)), after_idat=True),
    "second eXIf": _png_with(PNG, _chunk(b"eXIf", _tiff(3)), _chunk(b"eXIf", _tiff(6))),
    "eXIf bad CRC, then one": _png_with(PNG, _chunk(b"eXIf", _tiff(3))[:-4] + b"\0\0\0\0",
                                        _chunk(b"eXIf", _tiff(6))),
    "eXIf with an Exif prefix, then one": _png_with(PNG, _chunk(b"eXIf", b"Exif\0\0" + _tiff(3)),
                                                    _chunk(b"eXIf", _tiff(8))),
    "eXIf too short, then one": _png_with(PNG, _chunk(b"eXIf", b"II"), _chunk(b"eXIf", _tiff(2))),
    "eXIf after IEND": PNG + _chunk(b"eXIf", _tiff(6)),
}


@pytest.mark.parametrize("case", list(PLACEMENTS))
def test_load_rgb_finds_the_tag_where_cv2_does(case, tmp_path):
    data = PLACEMENTS[case]
    _assert_reads_as_jax(tmp_path / ("f.png" if data[:4] == PNG[:4] else "f.jpg"), data)


def test_load_rgb_orients_16_bit_and_gray_pngs(tmp_path):
    rng = np.random.RandomState(3)
    for img in (rng.randint(0, 65536, (9, 14, 3)).astype(np.uint16),
                rng.randint(0, 256, (9, 14)).astype(np.uint8)):
        ok, data = cv2.imencode(".png", img)
        _assert_reads_as_jax(tmp_path / "f.png", _png_with(bytes(data),
                                                           _chunk(b"eXIf", _tiff(6, "MM"))))


@pytest.mark.parametrize("orientation", range(1, 9))
def test_disparity_loaders_against_jax(orientation, tmp_path):
    """load_disp_vkitti reads through cv2 in JAX (the tag applies);
    load_disp_kitti_stereo through imageio (it does not)."""
    rng = np.random.RandomState(orientation)
    depth = rng.randint(100, 65535, (7, 11)).astype(np.uint16)
    path = tmp_path / "d.png"
    path.write_bytes(_png_with(encode_png(depth), _chunk(b"eXIf", _tiff(orientation))))
    for port, jax in ((loaders.load_disp_vkitti, jax_loaders.load_disp_vkitti),
                      (loaders.load_disp_kitti_stereo, jax_loaders.load_disp_kitti_stereo)):
        got, want = port(str(path)), jax(str(path))
        assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    assert loaders.load_disp_kitti_stereo(str(path)).shape == (7, 11, 1)


# ---- progressive JPEG --------------------------------------------------------

SAMPLING = {"4:4:4": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            "4:2:2": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "4:2:0": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
            "4:4:0": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440}


def _progressive(img, quality=90, sampling="4:2:0", restart=0):
    params = [cv2.IMWRITE_JPEG_PROGRESSIVE, 1, cv2.IMWRITE_JPEG_QUALITY, quality]
    if img.ndim == 3:
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling]]
        img = img[..., ::-1]
    if restart:
        params += [cv2.IMWRITE_JPEG_RST_INTERVAL, restart]
    ok, buf = cv2.imencode(".jpg", img, params)
    assert ok
    return bytes(buf)


def _assert_decodes_as_cv2(data):
    got = decode_jpeg(data)
    want = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)[..., ::-1]
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("restart", [0, 1, 5])
@pytest.mark.parametrize("shape", [(37, 53), (64, 96), (17, 9), (1, 1)])
@pytest.mark.parametrize("sampling", ["4:4:4", "4:2:2", "4:2:0", "4:4:0", "gray"])
def test_progressive_decode_equals_cv2(sampling, shape, restart):
    frame = chip_smoke.jpeg_frame(sum(shape) + restart, shape)
    img = frame[..., 1] if sampling == "gray" else frame
    for quality in (75, 100):
        _assert_decodes_as_cv2(_progressive(img, quality, sampling, restart))


def test_progressive_decode_equals_cv2_at_kitti_size():
    _assert_decodes_as_cv2(_progressive(chip_smoke.jpeg_frame(5), 95, "4:2:0", restart=7))


@pytest.mark.parametrize("subsampling", [0, 1, 2])
@pytest.mark.parametrize("optimize", [False, True])
def test_progressive_decode_equals_cv2_on_pil_files(subsampling, optimize):
    buf = io.BytesIO()
    Image.fromarray(chip_smoke.jpeg_frame(9, (45, 70))).save(
        buf, "JPEG", quality=85, subsampling=subsampling, progressive=True, optimize=optimize)
    _assert_decodes_as_cv2(buf.getvalue())


def _scan_starts(data):
    return [i for i in range(len(data) - 1) if data[i:i + 2] == b"\xff\xda"]


def test_progressive_files_that_end_early_raise():
    data = _progressive(chip_smoke.jpeg_frame(4, (48, 72)))
    sos = _scan_starts(data)
    assert len(sos) == 10  # libjpeg's jpeg_simple_progression for YCbCr
    with pytest.raises(ValueError, match="ends early"):
        decode_jpeg(data[:(sos[-1] + len(data)) // 2])  # inside the last scan's data
    with pytest.raises(ValueError, match="ends early"):
        decode_jpeg(data[:(sos[3] + sos[4]) // 2] + b"\xff\xd9")
    with pytest.raises(ValueError, match="smooths the blocks"):
        decode_jpeg(data[:sos[-1]])  # every scan whole but the last one


def test_progressive_scripts_that_stop_early_raise_where_cv2_smooths():
    """A file whose scans stop before the last one (EOI after scan k) is
    smoothed by cv2 (libjpeg's block smoothing): its pixels are not the
    plain decode of the coefficients. The port refuses it by name."""
    data = _progressive(chip_smoke.jpeg_frame(6, (48, 72)))
    sos = _scan_starts(data)
    for k in (1, 5, 9):
        with pytest.raises(ValueError, match=r"AC coefficient \d of component \d"):
            decode_jpeg(data[:sos[k]] + b"\xff\xd9")
    _assert_decodes_as_cv2(data)


@pytest.mark.parametrize("name", sorted(chip_smoke.PROGRESSIVE_JPEGS))
def test_progressive_fixtures_hash_to_chip_smokes_constants(name):
    data = (FIXTURES / name).read_bytes()
    assert data[:2] == b"\xff\xd8" and b"\xff\xc2" in data  # progressive (SOF2)
    want = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)[..., ::-1]
    digest = hashlib.sha256(np.ascontiguousarray(want).tobytes()).hexdigest()
    assert digest == chip_smoke.PROGRESSIVE_JPEGS[name]
    assert hashlib.sha256(decode_jpeg(data).tobytes()).hexdigest() == digest


def test_progressive_frame_fixture_is_phase_15s_frame():
    """The KITTI-size fixture is phase 15's seeded frame at 4:2:0 quality
    95: its pixels are those of the port's baseline encode of the frame."""
    name = "frame_375x1242_420_q95_progressive.jpg"
    assert chip_smoke.PROGRESSIVE_JPEGS[name] == chip_smoke.JPEG_FRAME_SHA256
