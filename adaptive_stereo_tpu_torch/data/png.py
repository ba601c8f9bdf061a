"""PNG decode and encode with the standard library's zlib and numpy, and
a small C function for the row filters.

The JAX package reads and writes images through cv2, PIL and imageio; the
port may import none of them. Decode handles non-interlaced images of
color type 0 (gray), 2 (RGB), 4 (gray + alpha) and 6 (RGBA) at 8 or 16
bits a sample, with every filter type (0 none, 1 sub, 2 up, 3 average,
4 paeth). Encode writes 8-bit gray, RGB or RGBA and 16-bit gray, and
picks each row's filter as libpng does by default: the one whose bytes,
read as signed, have the least absolute sum.

Undoing the filters is csrc/png_unfilter.c, a loop over the bytes, built
with the host's C compiler ($CC, else cc) at the first decode into
adaptive_stereo_tpu_torch/_build/ and called through ctypes. Average and
paeth make each byte depend on its left neighbour after it is undone, so
numpy can only go along anti-diagonals of pixels, thousands of small calls
an image that hold the GIL between them; in the loader's threads those
starve the adaptation step on the main thread. Inflate (zlib) and the C
call release the GIL, as cv2's decode does in the JAX package.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import struct
import subprocess
import tempfile
import zlib
from pathlib import Path

import numpy as np

_SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "png_unfilter.c"
_BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
_CFLAGS = ("-O2", "-shared", "-fPIC")
PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _chunks(data: bytes):
    """(kind, body, crc) of each chunk up to IEND; crc is the 4 bytes the
    file stores (short where the file ends early)."""
    if data[:8] != PNG_SIGNATURE:
        raise ValueError("not a PNG file")
    pos = 8
    while pos + 8 <= len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        yield kind, data[pos + 8:pos + 8 + n], data[pos + 8 + n:pos + 12 + n]
        pos += 12 + n
        if kind == b"IEND":
            return
    raise ValueError("PNG ends before its IEND chunk")


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


@functools.lru_cache(maxsize=None)
def _unfilter_library() -> ctypes.CDLL:
    """csrc/png_unfilter.c, built unless a library of the same source and
    flags exists, and loaded."""
    digest = hashlib.sha256(" ".join(_CFLAGS).encode() + _SOURCE.read_bytes()).hexdigest()
    out = _BUILD_DIR / f"libpng_unfilter_{digest[:16]}.so"
    if not out.exists():
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
        os.close(fd)
        cmd = [os.environ.get("CC") or "cc", *_CFLAGS, "-o", tmp, str(_SOURCE)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"building the PNG unfilter failed: {' '.join(cmd)}\n"
                               f"{proc.stderr}")
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    lib.png_unfilter.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.png_unfilter.restype = ctypes.c_int
    return lib


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W) for gray or (H, W, C) array, uint8 or uint16."""
    header, idat = None, []
    for kind, body, _ in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG has no IHDR chunk")
    w, h, depth, color, _, _, interlace = header
    if color not in _CHANNELS or depth not in (8, 16):
        raise ValueError(f"unsupported PNG: color type {color}, bit depth {depth}")
    if interlace:
        raise ValueError("interlaced PNGs are not supported")
    channels = _CHANNELS[color]
    bpp = channels * depth // 8
    stream = np.frombuffer(bytearray(zlib.decompress(b"".join(idat))), np.uint8)
    if stream.size != h * (1 + w * bpp):
        raise ValueError("PNG image data has the wrong size")
    bad = _unfilter_library().png_unfilter(stream.ctypes.data, h, w * bpp, bpp)
    if bad:
        raise ValueError(f"bad PNG filter type {bad}")
    pixels = stream.reshape(h, 1 + w * bpp)[:, 1:]
    if depth == 16:
        pixels = pixels.view(">u2").astype(np.uint16)
    pixels = np.ascontiguousarray(pixels).reshape(h, w, channels)
    return pixels[..., 0] if channels == 1 else pixels


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read())


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def _filters(img: np.ndarray) -> np.ndarray:
    """img (H, W, bpp) uint8 filtered by every filter type: (5, H, W, bpp)."""
    x = img.astype(np.int16)
    a = np.zeros_like(x)
    a[:, 1:] = x[:, :-1]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, 1:] = x[:-1, :-1]
    pred = np.stack([np.zeros_like(x), a, b, (a + b) >> 1, _paeth(a, b, c)])
    return ((x - pred) & 0xFF).astype(np.uint8)


def encode_png(img: np.ndarray) -> bytes:
    """PNG bytes of an (H, W) or (H, W, C) array: uint8 with C = 1 (gray),
    3 (RGB) or 4 (RGBA), or uint16 gray."""
    img = np.asarray(img)
    if img.ndim == 2:
        img = img[..., None]
    h, w, channels = img.shape
    color = {1: 0, 3: 2, 4: 6}.get(channels)
    if color is None or img.dtype not in (np.uint8, np.uint16) or (
            img.dtype == np.uint16 and channels != 1):
        raise ValueError(f"cannot encode a {img.dtype} image of {channels} channels")
    depth = 8 * img.dtype.itemsize
    data = np.ascontiguousarray(img.astype(">u2") if depth == 16 else img)
    bpp = channels * img.dtype.itemsize
    rows = _filters(data.view(np.uint8).reshape(h, w, bpp)).reshape(5, h, w * bpp)
    kinds = np.abs(rows.view(np.int8).astype(np.int32)).sum(axis=2).argmin(axis=0)
    stream = np.concatenate([kinds.astype(np.uint8)[:, None],
                             rows[kinds, np.arange(h)]], axis=1)
    header = struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, 0)
    return (PNG_SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(stream.tobytes())) + _chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img))
