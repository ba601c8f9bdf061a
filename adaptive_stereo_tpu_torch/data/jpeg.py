"""JPEG decode and encode through the native host library
(csrc/jpeg_codec.cpp, built by data/native.py).

The JAX package reads JPEG frames with cv2.imread(path, IMREAD_COLOR)
(adaptive_stereo_tpu/data/stereo_dataset.py _load_rgb) and writes them
with imageio; the port may import neither. The decoder repeats
libjpeg-turbo's default decode (accurate integer IDCT, fancy upsampling,
fixed-point YCbCr -> RGB), so its pixels equal cv2's. It reads Huffman
JPEGs of 8-bit samples, sequential (SOF0 / SOF1) or progressive (SOF2),
gray or YCbCr, with any sampling factors, restart intervals and optimized
Huffman tables, and raises ValueError on anything else (lossless,
arithmetic coding, 12-bit samples, CMYK, Adobe RGB) and on progressive
files whose data ends early or whose scans stop before the first nine AC
coefficients of every component are at full precision (libjpeg smooths
the blocks of those; the decoder does not repeat it); nothing falls back.
The decode is raw: the EXIF orientation is data/exif.py's.

The encoder writes baseline JFIF of RGB frames: libjpeg's quality-scaled
Annex K tables, the accurate integer FDCT and the standard Huffman tables.
The C calls release the GIL (ctypes), so the loader's threads decode in
parallel.
"""

from __future__ import annotations

import ctypes

import numpy as np

from .native import library

SUBSAMPLING = {"4:4:4": (1, 1), "4:2:2": (2, 1), "4:2:0": (2, 2)}
_ERR_LEN = 256


def decode_jpeg(data: bytes) -> np.ndarray:
    """JPEG bytes -> (H, W, 3) uint8 RGB (gray repeated to three channels,
    as cv2's IMREAD_COLOR does)."""
    lib = library()
    data = bytes(data)
    h, w = ctypes.c_int64(), ctypes.c_int64()
    err = ctypes.create_string_buffer(_ERR_LEN)
    if lib.jpeg_decode(data, len(data), None, ctypes.byref(h), ctypes.byref(w), err, _ERR_LEN):
        raise ValueError(err.value.decode())
    out = np.empty((h.value, w.value, 3), np.uint8)
    if lib.jpeg_decode(data, len(data), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                       ctypes.byref(h), ctypes.byref(w), err, _ERR_LEN):
        raise ValueError(err.value.decode())
    return out


def read_jpeg(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_jpeg(f.read())


def encode_jpeg(img: np.ndarray, quality: int = 75, subsampling: str = "4:2:0") -> bytes:
    """Baseline JFIF bytes of an (H, W, 3) uint8 RGB image; subsampling
    names the chroma sampling: "4:4:4", "4:2:2" or "4:2:0"."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"cannot encode a {img.dtype} image of shape {img.shape} as JPEG")
    if subsampling not in SUBSAMPLING:
        raise ValueError(f"unknown subsampling {subsampling!r}; one of {sorted(SUBSAMPLING)}")
    src = np.ascontiguousarray(img)
    h, w = src.shape[:2]
    hs, vs = SUBSAMPLING[subsampling]
    lib = library()
    u8p = ctypes.POINTER(ctypes.c_uint8)
    cap = 2 * src.size + 4096
    while True:
        out = np.empty(cap, np.uint8)
        size = lib.jpeg_encode(src.ctypes.data_as(u8p), h, w, int(quality), hs, vs,
                               out.ctypes.data_as(u8p), cap)
        if size < 0:
            raise ValueError(f"cannot encode a {h}x{w} image as JPEG")
        if size <= cap:
            return out[:size].tobytes()
        cap = size


def write_jpeg(path: str, img: np.ndarray, quality: int = 75, subsampling: str = "4:2:0") -> None:
    with open(path, "wb") as f:
        f.write(encode_jpeg(img, quality, subsampling))
