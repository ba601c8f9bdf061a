"""TensorBoard event files, written and read without tensorboardX or protobuf.

The JAX package writes its scalars and images through tensorboardX
(adaptive_stereo_tpu/utils/logging_utils.py MetricsWriter) and reads them
back through tensorboard's EventAccumulator (analysis/tb_extract.py). The
port imports neither, so this module writes and reads the format itself.

A file is a sequence of TFRecord records, each

    uint64 length (little endian) | uint32 masked_crc32c(length bytes)
    | data | uint32 masked_crc32c(data)

with masked_crc32c(x) = ((crc >> 15) | (crc << 17)) + 0xa282ead8 mod 2^32 of
the CRC-32C x. Each record's data is a serialized Event protocol buffer,
encoded here by hand:

    Event    wall_time = 1 (double), step = 2 (varint),
             file_version = 3 (string, "brain.Event:2" in the first record),
             summary = 5 (Summary)
    Summary  value = 1 (repeated Value)
    Value    tag = 1 (string), simple_value = 2 (float32), image = 4 (Image)
    Image    height = 1, width = 2, colorspace = 3 (varints),
             encoded_image_string = 4 (bytes)

Fields at their proto3 default (a step of 0) are left out, as protobuf
serializes them. The files are named
events.out.tfevents.<int(time)>.<hostname>, tensorboardX's name; a second
writer opened in the same second on the same directory takes the name with
a suffix .1, .2, ... (tensorboardX would truncate the first file).

Scalars and images follow tensorboardX 2.6.4 (tensorboardX/summary.py
scalar and image): the tag is cleaned (characters outside [-/\\w.] become
"_", leading slashes go), a scalar is stored as float32, and an HWC image
that is not uint8 becomes (x * 255.0).astype(uint8), in its own dtype,
before it is encoded as PNG (data/png.py; tensorboardX's LANCZOS resize at
rescale=1 is the identity).

The CRC runs in the native host library (data/native.py crc32c_native): a
Python loop over a 320x960 PNG would take tens of milliseconds.
crc32c_py is its plain twin. Each record is flushed when written, so a run
that is killed keeps what it logged.
"""

from __future__ import annotations

import os
import re
import socket
import struct
import time
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from ..data.native import crc32c_native
from ..data.png import encode_png

FILE_VERSION = b"brain.Event:2"
_INVALID_TAG_CHARACTERS = re.compile(r"[^-/\w\.]")
_MASK_DELTA = 0xA282EAD8
_HEADER = 12  # uint64 length + uint32 crc
_VARINT, _FIXED64, _BYTES, _FIXED32 = 0, 1, 2, 5


def _crc_table() -> List[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_TABLE = _crc_table()


def crc32c_py(data: bytes, crc: int = 0) -> int:
    """CRC-32C of `data` continuing from `crc`, a byte at a time in Python:
    the plain version of data/native.py crc32c_native."""
    crc ^= 0xFFFFFFFF
    for byte in data:
        crc = _TABLE[(crc ^ byte) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    x = crc32c_native(data)
    return (((x >> 15) | (x << 17)) + _MASK_DELTA) & 0xFFFFFFFF


def encode_record(data: bytes) -> bytes:
    header = struct.pack("<Q", len(data))
    return (header + struct.pack("<I", masked_crc32c(header)) + data
            + struct.pack("<I", masked_crc32c(data)))


# --- protobuf wire format ----------------------------------------------------

def _varint(n: int) -> bytes:
    if n < 0:
        n += 1 << 64  # int64 as two's complement, ten bytes
    out = bytearray()
    while True:
        bits = n & 0x7F
        n >>= 7
        if n:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint(field << 3 | wire)


def _len_field(field: int, payload: bytes) -> bytes:
    return _key(field, _BYTES) + _varint(len(payload)) + payload


def _float32(value: float) -> bytes:
    with np.errstate(over="ignore"):  # as a C cast: beyond float32 is inf
        return np.array(value, dtype=np.float32).tobytes()


def clean_tag(name: str) -> str:
    """tensorboardX's _clean_tag."""
    return _INVALID_TAG_CHARACTERS.sub("_", name).lstrip("/")


def scalar_value(tag: str, value: float) -> bytes:
    """A Summary.Value holding a float32 simple_value."""
    return (_len_field(1, clean_tag(tag).encode())
            + _key(2, _FIXED32) + _float32(float(value)))


def image_value(tag: str, img_hwc: np.ndarray) -> bytes:
    """A Summary.Value holding an HWC image (1, 3 or 4 channels) as PNG."""
    img = np.asarray(img_hwc)
    if img.dtype != np.uint8:
        img = (img * 255.0).astype(np.uint8)
    h, w, c = img.shape
    image = (_key(1, _VARINT) + _varint(h) + _key(2, _VARINT) + _varint(w)
             + _key(3, _VARINT) + _varint(c) + _len_field(4, encode_png(img)))
    return _len_field(1, clean_tag(tag).encode()) + _len_field(4, image)


def encode_event(wall_time: float, step: int = 0, file_version: Optional[bytes] = None,
                 values: Tuple[bytes, ...] = ()) -> bytes:
    """A serialized Event: a file-version event, or a summary of `values`."""
    out = _key(1, _FIXED64) + struct.pack("<d", wall_time)
    if step:
        out += _key(2, _VARINT) + _varint(int(step))
    if file_version is not None:
        out += _len_field(3, file_version)
    if values:
        out += _len_field(5, b"".join(_len_field(1, v) for v in values))
    return out


def _fields(buf: bytes) -> Iterator[Tuple[int, int, object]]:
    """(field, wire type, value) of a message: ints for varints, bytes for
    the rest."""
    pos, n = 0, len(buf)
    while pos < n:
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == _VARINT:
            value, pos = _read_varint(buf, pos)
        elif wire == _FIXED64:
            value, pos = buf[pos:pos + 8], pos + 8
        elif wire == _FIXED32:
            value, pos = buf[pos:pos + 4], pos + 4
        elif wire == _BYTES:
            size, pos = _read_varint(buf, pos)
            value, pos = buf[pos:pos + size], pos + size
        else:
            raise ValueError(f"unsupported protobuf wire type {wire}")
        if pos > n:
            raise ValueError("protobuf message ends inside a field")
        yield field, wire, value


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    shift = result = 0
    while True:
        if pos >= len(buf):
            raise ValueError("protobuf message ends inside a varint")
        byte = buf[pos]
        pos += 1
        result |= (byte & 0x7F) << shift
        if not byte & 0x80:
            return result, pos
        shift += 7


def decode_event(data: bytes) -> Dict:
    """{'step', 'file_version' (or None), 'scalars': [(tag, value)]} of a
    serialized Event; a value is a Python float of the stored float32, as
    EventAccumulator gives it. Values of other kinds are skipped."""
    event = {"step": 0, "file_version": None, "scalars": []}
    for field, wire, value in _fields(data):
        if field == 2 and wire == _VARINT:
            event["step"] = value - (1 << 64) if value >= 1 << 63 else value
        elif field == 3 and wire == _BYTES:
            event["file_version"] = bytes(value)
        elif field == 5 and wire == _BYTES:
            for f, w, v in _fields(value):
                if f == 1 and w == _BYTES:
                    fields = {f2: v2 for f2, w2, v2 in _fields(v)
                              if (f2, w2) in ((1, _BYTES), (2, _FIXED32))}
                    if 2 in fields:
                        event["scalars"].append((bytes(fields.get(1, b"")).decode(),
                                                 struct.unpack("<f", fields[2])[0]))
    return event


def read_records(path: str) -> Iterator[bytes]:
    """The data of each record of an event file, in order. A checksum that
    does not match raises ValueError naming the file and the record's
    offset; a record cut short at the end of the file (a writer killed
    mid-write) ends the file."""
    with open(path, "rb") as f:
        buf = f.read()
    pos = 0
    while pos + _HEADER <= len(buf):
        header = buf[pos:pos + 8]
        (length,) = struct.unpack("<Q", header)
        (crc,) = struct.unpack("<I", buf[pos + 8:pos + 12])
        if crc != masked_crc32c(header):
            raise ValueError(f"{path}: bad length checksum in the record at byte {pos}")
        end = pos + _HEADER + length
        if end + 4 > len(buf):
            return  # truncated last record
        data = buf[pos + _HEADER:end]
        (crc,) = struct.unpack("<I", buf[end:end + 4])
        if crc != masked_crc32c(data):
            raise ValueError(f"{path}: bad data checksum in the record at byte {pos}")
        yield data
        pos = end + 4


class EventFileWriter:
    """One event file in log_dir: the file-version record at once, then a
    record for each add_scalar / add_image, flushed as it is written."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        base = os.path.join(log_dir, f"events.out.tfevents.{int(time.time())}."
                                     f"{socket.gethostname()}")
        path, n = base, 0
        while True:
            try:
                self._file = open(path, "xb")
                break
            except FileExistsError:
                n += 1
                path = f"{base}.{n}"
        self.path = path
        self.bytes_written = 0
        self._write(encode_event(time.time(), file_version=FILE_VERSION))

    def _write(self, event: bytes) -> None:
        record = encode_record(event)
        self._file.write(record)
        self._file.flush()
        self.bytes_written += len(record)

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._write(encode_event(time.time(), step, values=(scalar_value(tag, value),)))

    def add_image(self, tag: str, img_hwc: np.ndarray, step: int) -> None:
        self._write(encode_event(time.time(), step, values=(image_value(tag, img_hwc),)))

    def close(self) -> None:
        self._file.close()
