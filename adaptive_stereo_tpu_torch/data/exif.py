"""The EXIF Orientation tag of a PNG or JPEG file, read and applied as
cv2.imread applies it (counterpart of the rotation that
cv2.imread(path, IMREAD_COLOR) and cv2.imread(path, IMREAD_ANYCOLOR |
IMREAD_ANYDEPTH) do in adaptive_stereo_tpu/data/stereo_dataset.py _load_rgb
and data/loaders.py load_disp_vkitti). imageio ignores the tag, so the
readers that stand for imageio's (data/loaders.py load_disp_kitti_stereo)
do not call this. The decoders (data/png.py, data/jpeg.py) stay raw, as
libpng and libjpeg are.

Where the tag is looked for, as the cv2 5.0 build with libjpeg-turbo 3.1
and libpng 1.6 reads it:
- JPEG: every APP1 segment before the first SOS whose body starts with
  b"Exif\\0\\0"; the first Orientation entry found in them counts. A tag
  after the image data is not read.
- PNG: the first eXIf chunk that libpng accepts: its CRC holds, it has at
  least 4 bytes and starts with a TIFF header (b"II*\\0" or b"MM\\0*");
  later eXIf chunks are duplicates. The chunk may follow the image data.
In the TIFF block: byte order II or MM, magic 42, the IFD0 offset; the
entries of IFD0 are read in order until one would run past the block
(an entry counts once its tag, type, count and first two value bytes are
inside). The Orientation entry (tag 0x0112) gives the 16-bit value at its
value field whatever its type and count. Values 1-8 transform the image,
anything else (or no tag) leaves it as it is.
"""

from __future__ import annotations

import struct
import zlib
from typing import Optional

import numpy as np

from .png import PNG_SIGNATURE, _chunks

ORIENTATION_TAG = 0x0112
_TIFF_HEADERS = (b"II*\x00", b"MM\x00*")


def _tiff_orientation(block: bytes) -> Optional[int]:
    """The Orientation value in IFD0 of a TIFF-structured block, or None."""
    if len(block) < 8 or block[:2] not in (b"II", b"MM"):
        return None
    e = "<" if block[:2] == b"II" else ">"
    magic, ifd = struct.unpack_from(e + "HI", block, 2)
    if magic != 42 or ifd + 2 > len(block):
        return None
    (count,) = struct.unpack_from(e + "H", block, ifd)
    for i in range(count):
        entry = ifd + 2 + 12 * i
        if entry + 10 > len(block):
            break
        (tag,) = struct.unpack_from(e + "H", block, entry)
        if tag == ORIENTATION_TAG:
            return struct.unpack_from(e + "H", block, entry + 8)[0]
    return None


def _jpeg_orientation(data: bytes) -> Optional[int]:
    pos = 2
    while pos + 4 <= len(data):
        if data[pos] != 0xFF:
            pos += 1
            continue
        marker = data[pos + 1]
        if marker == 0xFF:
            pos += 1
            continue
        if marker in (0xDA, 0xD9):  # SOS, EOI: the header ends
            return None
        if marker == 0x01 or 0xD0 <= marker <= 0xD8:  # no segment
            pos += 2
            continue
        (length,) = struct.unpack_from(">H", data, pos + 2)
        body = data[pos + 4:pos + 2 + length]
        if marker == 0xE1 and body[:6] == b"Exif\x00\x00":
            value = _tiff_orientation(body[6:])
            if value is not None:
                return value
        pos += 2 + length
    return None


def _png_orientation(data: bytes) -> Optional[int]:
    for kind, body, crc in _chunks(data):
        if (kind == b"eXIf" and body[:4] in _TIFF_HEADERS
                and crc == struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF)):
            return _tiff_orientation(body)
    return None


def exif_orientation(data: bytes) -> int:
    """The EXIF Orientation (1-8; 1 when there is none) that cv2.imread
    applies to the PNG or JPEG file `data`. A value outside 1-8 is
    returned as it stands; apply_orientation leaves the image unchanged
    for it, as cv2 does."""
    if data[:8] == PNG_SIGNATURE:
        value = _png_orientation(data)
    elif data[:2] == b"\xff\xd8":
        value = _jpeg_orientation(data)
    else:
        value = None
    return 1 if value is None else value


def apply_orientation(img: np.ndarray, orientation: int) -> np.ndarray:
    """img (H, W) or (H, W, C) transformed as cv2's ApplyExifOrientation
    does: 2 flip left-right, 3 rotate 180, 4 flip up-down, 5 transpose,
    6 rotate 90 clockwise, 7 transverse, 8 rotate 90 counter-clockwise;
    anything else unchanged. Returns a contiguous array."""
    if orientation == 2:
        img = img[:, ::-1]
    elif orientation == 3:
        img = img[::-1, ::-1]
    elif orientation == 4:
        img = img[::-1]
    elif orientation == 5:
        img = img.swapaxes(0, 1)
    elif orientation == 6:
        img = img[::-1].swapaxes(0, 1)
    elif orientation == 7:
        img = img[::-1, ::-1].swapaxes(0, 1)
    elif orientation == 8:
        img = img[:, ::-1].swapaxes(0, 1)
    return np.ascontiguousarray(img)
