"""The native host library: PFM read, half-pixel bilinear resize, uint8 ->
float32 and the point-cloud voxel grid, in C++ through ctypes (counterpart
of adaptive_stereo_tpu/data/native.py), CRC-32C for the event files of
utils/event_file.py, and the JPEG codec of data/jpeg.py
(csrc/jpeg_codec.cpp).

csrc/stereo_native.cpp and csrc/jpeg_codec.cpp are built at the first
call with the host C++ compiler ($CXX, else c++; -O3 -fPIC -shared
-std=c++17 -ffp-contract=off) into
adaptive_stereo_tpu_torch/_build/libstereo_native_<hash of sources and
flags>.so, as data/png.py builds its C function. Unlike the JAX module,
which quietly falls back to numpy or cv2 when its library is missing, the
port builds the library or raises RuntimeError with the command and the
compiler's errors; no caller falls back.

The voxel grid keys each point on floor(p * (1 / voxel)) in double and
returns the voxels in the hash map's iteration order; serving/stream.py's
numpy voxel_downsample (floor(p / voxel) in float32, voxels in key order)
is its plain version and may put a point within an ulp of a voxel face in
the neighbouring voxel.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "stereo_native.cpp"
# Every source compiled into the library; its name hashes all of them.
_SOURCES = (_SOURCE, _SOURCE.with_name("jpeg_codec.cpp"))
_BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
# No fused multiply-adds: the resize's lerps round after the multiply, on
# every host (the JAX package's Makefile builds with -march=native, where
# the compiler may fuse them and move a result by an ulp).
_CXXFLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-ffp-contract=off")


def library_path() -> Path:
    """Where the library of the current sources and flags is built."""
    digest = hashlib.sha256(" ".join(_CXXFLAGS).encode()
                            + b"".join(src.read_bytes() for src in _SOURCES)).hexdigest()
    return _BUILD_DIR / f"libstereo_native_{digest[:16]}.so"


def build() -> Path:
    """Build the library unless one of the same source and flags exists;
    returns its path. Raises RuntimeError when the compiler fails."""
    out = library_path()
    if out.exists():
        return out
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    cmd = [os.environ.get("CXX") or "c++", *_CXXFLAGS, "-o", tmp, *map(str, _SOURCES)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as err:
        os.unlink(tmp)
        raise RuntimeError(f"building the native library failed: {' '.join(cmd)}\n{err}") from err
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"building the native library failed: {' '.join(cmd)}\n"
                           f"{proc.stderr}")
    os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The built library with its ctypes signatures (JAX native.py:43-52)."""
    lib = ctypes.CDLL(str(build()))
    i64 = ctypes.c_int64
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.pfm_read.argtypes = [ctypes.c_char_p, f32p, ctypes.POINTER(i64),
                             ctypes.POINTER(i64), ctypes.POINTER(i64)]
    lib.pfm_read.restype = ctypes.c_int
    lib.resize_bilinear_f32.argtypes = [f32p, i64, i64, i64, f32p, i64, i64]
    lib.resize_bilinear_f32.restype = None
    lib.u8_to_f32_scaled.argtypes = [ctypes.POINTER(ctypes.c_uint8), f32p, i64]
    lib.u8_to_f32_scaled.restype = None
    lib.voxel_downsample_f32.argtypes = [f32p, f32p, i64, ctypes.c_float, f32p, f32p, i64]
    lib.voxel_downsample_f32.restype = i64
    lib.crc32c_update.argtypes = [ctypes.c_uint32, ctypes.c_char_p, i64]
    lib.crc32c_update.restype = ctypes.c_uint32
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.jpeg_decode.argtypes = [ctypes.c_char_p, i64, u8p, ctypes.POINTER(i64),
                                ctypes.POINTER(i64), ctypes.c_char_p, i64]
    lib.jpeg_decode.restype = ctypes.c_int
    lib.jpeg_encode.argtypes = [u8p, i64, i64, ctypes.c_int, ctypes.c_int, ctypes.c_int, u8p,
                                i64]
    lib.jpeg_encode.restype = i64
    return lib


def crc32c_native(data: bytes, crc: int = 0) -> int:
    """CRC-32C (Castagnoli) of `data`, continuing from `crc`."""
    return library().crc32c_update(crc, data, len(data))


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def pfm_read_native(path: str) -> Tuple[np.ndarray, float]:
    """(data, 1.0): data (H, W) or (H, W, 3) float32, top-down. Raises
    IOError on a file the reader rejects."""
    lib = library()
    h, w, c = ctypes.c_int64(), ctypes.c_int64(), ctypes.c_int64()
    rc = lib.pfm_read(path.encode(), None, ctypes.byref(h), ctypes.byref(w), ctypes.byref(c))
    if rc != 0:
        raise IOError(f"pfm_read header failed ({rc}) for {path}")
    out = np.empty((h.value, w.value) if c.value == 1 else (h.value, w.value, 3), np.float32)
    rc = lib.pfm_read(path.encode(), _fptr(out), ctypes.byref(h), ctypes.byref(w),
                      ctypes.byref(c))
    if rc != 0:
        raise IOError(f"pfm_read failed ({rc}) for {path}")
    return out, 1.0


def resize_bilinear_native(img: np.ndarray, oh: int, ow: int) -> np.ndarray:
    """Half-pixel bilinear resize (align_corners=False) of an (H, W) or
    (H, W, C) image to (oh, ow, C) float32."""
    img = np.ascontiguousarray(img, np.float32)
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    out = np.empty((oh, ow, c), np.float32)
    library().resize_bilinear_f32(_fptr(img), h, w, c, _fptr(out), oh, ow)
    return out


def u8_to_f32_native(img: np.ndarray) -> np.ndarray:
    """uint8 -> float32 times 1/255, elementwise, in the input's shape."""
    src = np.ascontiguousarray(img, np.uint8)
    out = np.empty(src.shape, np.float32)
    library().u8_to_f32_scaled(src.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), _fptr(out),
                               src.size)
    return out


def voxel_downsample_native(points: np.ndarray, voxel: float,
                            colors: Optional[np.ndarray] = None):
    """The mean point (and colour) of each occupied voxel of side `voxel`:
    (M, 3) float32 points and colours (None without colours), in the hash
    map's order."""
    lib = library()
    pts = np.ascontiguousarray(points, np.float32).reshape(-1, 3)
    n = len(pts)
    out_pts = np.empty((n, 3), np.float32)
    if colors is None:
        m = lib.voxel_downsample_f32(_fptr(pts), None, n, voxel, _fptr(out_pts), None, n)
        return out_pts[:m].copy(), None
    cols = np.ascontiguousarray(colors, np.float32).reshape(-1, 3)
    if len(cols) != n:
        raise ValueError(f"{n} points but {len(cols)} colours")
    out_cols = np.empty((n, 3), np.float32)
    m = lib.voxel_downsample_f32(_fptr(pts), _fptr(cols), n, voxel, _fptr(out_pts),
                                 _fptr(out_cols), n)
    return out_pts[:m].copy(), out_cols[:m].copy()
