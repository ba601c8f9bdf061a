"""The port's data layer against the JAX package's, on the CPU:

- data/png.py decodes PNGs that imageio wrote (8-bit gray, RGB, RGBA and
  16-bit gray; imageio's encoder picks filter types per row) and PNGs that
  it writes itself, whose rows take the filter of least absolute sum (as
  libpng picks them; checked against a pixel loop), and imageio decodes
  the latter to the same arrays: exact;
- the synthetic generator: for the same seed the decoded images and the
  .npy disparities equal the JAX generator's: exact;
- StereoDataset items equal JAX's (cv2 decode and INTER_LINEAR resize):
  colors and ground truth at scale 0 exact, resized colors and ground
  truth within 1e-5 (measured: colors exact, ground truth 4.8e-7, where
  cv2 takes its 2x2 area path for an exact halving);
- the disparity loaders (KITTI and VKITTI 16-bit PNGs, SceneFlow PFM,
  synthetic .npy) equal JAX's: exact;
- BatchLoader keeps the order with several threads;
- PFM round trip.
"""

import os
import struct
import zlib

import imageio.v2 as imageio
import numpy as np
import pytest

from adaptive_stereo_tpu.data import BatchLoader as JaxBatchLoader
from adaptive_stereo_tpu.data import StereoDataset as JaxStereoDataset
from adaptive_stereo_tpu.data import generate_synthetic_dataset as jax_generate
from adaptive_stereo_tpu.data import loaders as jax_loaders
from adaptive_stereo_tpu_torch.data import (BatchLoader, StereoDataset, decode_png, encode_png,
                                            generate_synthetic_dataset, get_disp_loader,
                                            read_pfm, read_png, write_pfm, write_png)

RESIZE_TOL = dict(atol=1e-5, rtol=0)


def _filter_types(path, per_row=False):
    """The filter byte of every row of a non-interlaced PNG: a set, or the
    list of the rows'."""
    data = open(path, "rb").read()
    pos, idat, header = 8, b"", None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat += body
    w, h, depth, color = header[:4]
    stride = 1 + w * {0: 1, 2: 3, 6: 4}[color] * depth // 8
    raw = zlib.decompress(idat)
    kinds = [raw[i * stride] for i in range(h)]
    return kinds if per_row else set(kinds)


def _images(rng, h=37, w=53):
    y, x = np.mgrid[0:h, 0:w]
    smooth = (np.sin(x / 5.0) * np.cos(y / 7.0) * 0.5 + 0.5)[..., None] * np.ones(3)
    rgb = np.clip(smooth * 255 + rng.randint(0, 4, (h, w, 3)), 0, 255).astype(np.uint8)
    return {
        "rgb": rgb,
        "gray": rgb[..., 0].copy(),
        "rgba": np.concatenate([rgb, rng.randint(0, 256, (h, w, 1)).astype(np.uint8)], -1),
        "gray16": (smooth[..., 0] * 60000 + rng.randint(0, 500, (h, w))).astype(np.uint16),
        "noise": rng.randint(0, 256, (h, w, 3)).astype(np.uint8),
    }


def test_png_decodes_what_imageio_writes(tmp_path):
    rng = np.random.RandomState(0)
    seen = set()
    for name, img in _images(rng).items():
        path = str(tmp_path / f"{name}.png")
        imageio.imwrite(path, img)
        seen |= _filter_types(path)
        got = read_png(path)
        assert got.dtype == img.dtype and got.shape == img.shape, name
        np.testing.assert_array_equal(got, img, err_msg=name)
    assert {1, 2, 4} <= seen  # imageio's adaptive rows, paeth included


def _least_sum_filters(img):
    """Per row, the filter type whose bytes, read as signed, have the least
    absolute sum (the lowest type on a tie), by a pixel loop independent of
    data/png.py."""
    x = np.asarray(img)
    x = x[..., None] if x.ndim == 2 else x
    x = np.ascontiguousarray(x.astype(">u2") if x.dtype == np.uint16 else x)
    h, w = x.shape[:2]
    rows = x.view(np.uint8).reshape(h, -1).astype(int).tolist()
    bpp = len(rows[0]) // w
    best = []
    for y in range(h):
        sums = []
        for kind in range(5):
            total = 0
            for i, v in enumerate(rows[y]):
                a = rows[y][i - bpp] if i >= bpp else 0
                b = rows[y - 1][i] if y else 0
                c = rows[y - 1][i - bpp] if y and i >= bpp else 0
                p = a + b - c
                paeth = min((abs(p - a), 0, a), (abs(p - b), 1, b), (abs(p - c), 2, c))[2]
                f = (v - (0, a, b, (a + b) // 2, paeth)[kind]) % 256
                total += min(f, 256 - f)
            sums.append(total)
        best.append(sums.index(min(sums)))
    return best


@pytest.mark.parametrize("name", ["rgb", "gray", "rgba", "gray16", "noise"])
def test_png_writes_what_imageio_and_itself_decode(tmp_path, name):
    img = _images(np.random.RandomState(1))[name]
    path = str(tmp_path / f"{name}.png")
    write_png(path, img)
    assert _filter_types(path, per_row=True) == _least_sum_filters(img)
    np.testing.assert_array_equal(imageio.imread(path), img)
    np.testing.assert_array_equal(read_png(path), img)


def test_png_written_rows_cover_every_filter_type(tmp_path):
    seen = set()
    for name, img in _images(np.random.RandomState(1)).items():
        write_png(str(tmp_path / f"{name}.png"), img)
        seen |= _filter_types(str(tmp_path / f"{name}.png"))
    # so that the round trips of test_png_writes_what_imageio_and_itself_decode
    # undo every filter type
    assert seen == {0, 1, 2, 3, 4}


def test_png_refuses_what_it_does_not_handle():
    with pytest.raises(ValueError, match="not a PNG"):
        decode_png(b"GIF89a" + b"\x00" * 20)
    with pytest.raises(ValueError, match="cannot encode"):
        encode_png(np.zeros((4, 4, 3), np.uint16))
    # One row's filter byte set to 5, with the IDAT and its CRC rewritten.
    data = encode_png(np.zeros((4, 4), np.uint8))
    pos = data.index(b"IDAT")
    (n,) = struct.unpack(">I", data[pos - 4:pos])
    raw = bytearray(zlib.decompress(data[pos + 4:pos + 4 + n]))
    raw[5] = 5
    body = zlib.compress(bytes(raw))
    chunk = (struct.pack(">I", len(body)) + b"IDAT" + body
             + struct.pack(">I", zlib.crc32(b"IDAT" + body) & 0xFFFFFFFF))
    with pytest.raises(ValueError, match="bad PNG filter type 5"):
        decode_png(data[:pos - 4] + chunk + data[pos + 8 + n:])


@pytest.mark.parametrize("kind", [dict(), dict(domain_shift=True),
                                  dict(domain_shift=True, shift_kind="fog")])
def test_synthetic_dataset_equals_jax(tmp_path, kind):
    args = dict(name="s", num_train=3, num_val=1, height=40, width=72, max_disp=12.0, seed=4,
                **kind)
    jax_generate(str(tmp_path / "jax"), **args)
    generate_synthetic_dataset(str(tmp_path / "port"), **args)
    for sub in ("left", "right", "disp_l", "disp_r"):
        names = sorted(os.listdir(tmp_path / "jax" / sub))
        assert names == sorted(os.listdir(tmp_path / "port" / sub)) and len(names) == 4
        for f in names:
            a, b = tmp_path / "jax" / sub / f, tmp_path / "port" / sub / f
            if f.endswith(".png"):
                np.testing.assert_array_equal(imageio.imread(a), read_png(str(b)))
            else:
                assert a.read_bytes() == b.read_bytes()
    for split in ("train", "val", "test"):
        rel = os.path.join("splits", "s", f"{split}_lines.txt")
        assert (tmp_path / "jax" / rel).read_text() == (tmp_path / "port" / rel).read_text()


@pytest.mark.parametrize("scales,uint8", [((0, 2), False), ((1, 3), False), ((0, 2), True)])
def test_stereo_dataset_items_equal_jax(tmp_path, scales, uint8):
    root = str(tmp_path / "d")
    generate_synthetic_dataset(root, name="s", num_train=2, num_val=1, height=40, width=72,
                               max_disp=12.0, seed=6, domain_shift=True)
    args = (root, "Synthetic", "s", 32, 64, "train")
    kw = dict(scales=scales, color_uint8=uint8)
    mine, ref = StereoDataset(*args, **kw), JaxStereoDataset(*args, **kw)
    assert len(mine) == len(ref) == 2
    for i in range(2):
        a, b = mine[i], ref[i]
        assert sorted(a) == sorted(b)
        for key in b:
            assert a[key].dtype == b[key].dtype and a[key].shape == b[key].shape, key
            if key.endswith("/0"):
                np.testing.assert_array_equal(a[key], b[key], err_msg=key)
            else:
                np.testing.assert_allclose(a[key], b[key], err_msg=key, **RESIZE_TOL)


def test_disparity_loaders_equal_jax(tmp_path):
    rng = np.random.RandomState(2)
    disp16 = rng.randint(1, 65535, (24, 40)).astype(np.uint16)
    imageio.imwrite(tmp_path / "kitti.png", disp16)
    pfm = (rng.rand(24, 40) * 80).astype(np.float32)
    write_pfm(str(tmp_path / "sf.pfm"), pfm)
    np.save(tmp_path / "syn.npy", pfm)
    np.save(tmp_path / "raw.npy", disp16.astype(np.float32))
    for name, file in (("KittiStereo2015", "kitti.png"), ("VirtualKitti", "kitti.png"),
                       ("SceneFlowDriving", "sf.pfm"), ("Synthetic", "syn.npy"),
                       ("KittiRaw", "raw.npy")):
        path = str(tmp_path / file)
        a, b = get_disp_loader(name)(path), jax_loaders.get_disp_loader(name)(path)
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape == (24, 40, 1), name
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_batch_loader_keeps_the_order(tmp_path):
    root = str(tmp_path / "d")
    generate_synthetic_dataset(root, name="s", num_train=7, num_val=1, height=24, width=40,
                               max_disp=8.0, seed=8)
    ds = StereoDataset(root, "Synthetic", "s", 24, 40, "train", scales=(0,))
    batches = list(BatchLoader(ds, 2, shuffle=False, num_workers=3, prefetch=2))
    ref = list(JaxBatchLoader(JaxStereoDataset(root, "Synthetic", "s", 24, 40, "train",
                                               scales=(0,)), 2, shuffle=False, num_workers=1))
    assert [len(b["color_l/0"]) for b in batches] == [2, 2, 2, 1]
    for i, (a, b) in enumerate(zip(batches, ref)):
        for key in b:
            np.testing.assert_array_equal(a[key], b[key])
        for j in range(len(a["color_l/0"])):
            np.testing.assert_array_equal(a["color_l/0"][j], ds[2 * i + j]["color_l/0"])
    shuffled = BatchLoader(ds, 3, shuffle=True, num_workers=2, seed=5)
    ref_shuffled = JaxBatchLoader(JaxStereoDataset(root, "Synthetic", "s", 24, 40, "train",
                                                   scales=(0,)), 3, shuffle=True, seed=5)
    for a, b in zip(shuffled, ref_shuffled):
        np.testing.assert_array_equal(a["gt_disp_l/0"], b["gt_disp_l/0"])


def test_pfm_round_trip(tmp_path):
    rng = np.random.RandomState(3)
    for shape in ((9, 13), (9, 13, 3)):
        img = rng.rand(*shape).astype(np.float32)
        write_pfm(str(tmp_path / "x.pfm"), img)
        back, scale = read_pfm(str(tmp_path / "x.pfm"))
        assert scale == 1.0
        np.testing.assert_array_equal(back, img)
