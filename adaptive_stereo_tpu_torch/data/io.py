"""Image / disparity file formats: PFM, .flo, .float3 (numpy only; a copy
of adaptive_stereo_tpu/data/io.py).

Fresh implementations of the on-disk format specs the reference consumes
(behavioral contract per reference adaptive_stereo/utils/io.py — the Freiburg
SceneFlow tool formats):

- PFM: ascii header ('PF' color / 'Pf' gray), 'W H', scale line whose sign
  encodes endianness, then rows of float32 stored BOTTOM-UP (so a vertical
  flip on read/write).
- .flo: 'PIEH' magic, int32 W, H, then (H, W, 2) float32 flow.
- .float3: ascii 'float', ndim, dims (one per line), float32 payload.
"""

from __future__ import annotations

import sys

import numpy as np


def read_pfm(path: str):
    """Returns (data, scale); data is (H, W) or (H, W, 3) float, top-down."""
    with open(path, "rb") as f:
        header = f.readline().rstrip()
        if header == b"PF":
            color = True
        elif header == b"Pf":
            color = False
        else:
            raise ValueError(f"{path}: not a PFM file (header {header!r})")

        dims = f.readline().decode("ascii").split()
        if len(dims) != 2:
            raise ValueError(f"{path}: malformed PFM dimension line")
        width, height = int(dims[0]), int(dims[1])

        scale = float(f.readline().decode("ascii").rstrip())
        endian = "<" if scale < 0 else ">"
        scale = abs(scale)

        count = width * height * (3 if color else 1)
        data = np.fromfile(f, endian + "f4", count)
        shape = (height, width, 3) if color else (height, width)
        # PFM stores rows bottom-up.
        return np.flipud(data.reshape(shape)).copy(), scale


def write_pfm(path: str, image: np.ndarray, scale: float = 1.0) -> None:
    image = np.asarray(image)
    if image.dtype != np.float32:
        raise ValueError("PFM requires float32 data")
    if image.ndim == 3 and image.shape[2] == 3:
        color = True
    elif image.ndim == 2 or (image.ndim == 3 and image.shape[2] == 1):
        color = False
        image = image.reshape(image.shape[0], image.shape[1])
    else:
        raise ValueError(f"bad PFM shape {image.shape}")

    with open(path, "wb") as f:
        f.write(b"PF\n" if color else b"Pf\n")
        f.write(f"{image.shape[1]} {image.shape[0]}\n".encode("ascii"))
        if image.dtype.byteorder == "<" or (
            image.dtype.byteorder == "=" and sys.byteorder == "little"
        ):
            scale = -scale
        f.write(f"{scale:f}\n".encode("ascii"))
        np.flipud(image).tofile(f)


def read_flo(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        if f.read(4) != b"PIEH":
            raise ValueError(f"{path}: missing PIEH flow magic")
        w = int(np.fromfile(f, np.int32, 1)[0])
        h = int(np.fromfile(f, np.int32, 1)[0])
        return np.fromfile(f, np.float32, w * h * 2).reshape(h, w, 2)


def write_flo(path: str, flow: np.ndarray) -> None:
    flow = np.asarray(flow, np.float32)
    with open(path, "wb") as f:
        f.write(b"PIEH")
        np.asarray([flow.shape[1], flow.shape[0]], np.int32).tofile(f)
        flow.tofile(f)


def read_float3(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        if f.readline().decode("ascii") != "float\n":
            raise ValueError(f"{path}: missing float keyword")
        ndim = int(f.readline())
        dims = [int(f.readline()) for _ in range(ndim)]
        count = int(np.prod(dims))
        data = np.fromfile(f, np.float32, count).reshape(list(reversed(dims)))
        if ndim > 2:
            data = np.transpose(data, (2, 1, 0))
            data = np.transpose(data, (1, 0, 2))
        return data


def write_float3(path: str, data: np.ndarray) -> None:
    data = np.asarray(data, np.float32)
    if data.ndim > 3:
        raise ValueError(f"bad float3 rank {data.ndim}")
    with open(path, "wb") as f:
        f.write(b"float\n")
        f.write(f"{data.ndim}\n".encode("ascii"))
        if data.ndim == 1:
            f.write(f"{data.shape[0]}\n".encode("ascii"))
        else:
            f.write(f"{data.shape[1]}\n".encode("ascii"))
            f.write(f"{data.shape[0]}\n".encode("ascii"))
            for i in range(2, data.ndim):
                f.write(f"{data.shape[i]}\n".encode("ascii"))
        if data.ndim == 2:
            data.tofile(f)
        else:
            np.transpose(data, (2, 0, 1)).tofile(f)
