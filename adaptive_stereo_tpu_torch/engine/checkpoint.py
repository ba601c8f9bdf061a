"""Checkpoints in the JAX package's container (counterpart of
adaptive_stereo_tpu/engine/checkpoint.py:70-104, load_variables and
save_variables).

Layout: <folder>/state.msgpack holds {'params': ..., 'batch_stats': ...},
the JAX StereoModel's variables (models/weights.py carries them to and from
the port's state dicts), and <folder>/meta.json the metadata. The file is
flax's msgpack form: a msgpack map of nested maps whose array leaves are
msgpack extension type 1, itself the msgpack array (shape, dtype name,
C-order bytes); numpy scalars are type 3 in the same form. The port reads
and writes it with the small codec below, in pure Python (no msgpack, no
flax), so either package loads what the other wrote. (flax's forms for
complex numbers and for arrays over 1 GiB never occur in these files.) A reference weights
folder (feature_net.pth / stereo_net.pth) loads too.

The full TrainState checkpoint (optimizer state, step) waits for the
training engine.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Any, Dict, Optional

import numpy as np

_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3


# --- msgpack writer ---------------------------------------------------------

def _pack_int(n: int, out: bytearray) -> None:
    if 0 <= n < 128:
        out.append(n)
    elif -32 <= n < 0:
        out += struct.pack(">b", n)
    elif n >= 0:
        for code, fmt, hi in ((0xcc, ">B", 1 << 8), (0xcd, ">H", 1 << 16),
                              (0xce, ">I", 1 << 32), (0xcf, ">Q", 1 << 64)):
            if n < hi:
                out.append(code)
                out += struct.pack(fmt, n)
                return
        raise OverflowError(n)
    else:
        for code, fmt, lo in ((0xd0, ">b", -(1 << 7)), (0xd1, ">h", -(1 << 15)),
                              (0xd2, ">i", -(1 << 31)), (0xd3, ">q", -(1 << 63))):
            if n >= lo:
                out.append(code)
                out += struct.pack(fmt, n)
                return
        raise OverflowError(n)


def _pack_len(n: int, out: bytearray, fix: Optional[int], fix_max: int, codes) -> None:
    """A length header: the fix form below fix_max, else the 8/16/32-bit
    forms in codes (None where the type has none)."""
    if fix is not None and n < fix_max:
        out.append(fix | n)
        return
    for code, fmt, hi in zip(codes, (">B", ">H", ">I"), (1 << 8, 1 << 16, 1 << 32)):
        if code is not None and n < hi:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise OverflowError(n)


def _array_payload(arr: np.ndarray) -> bytes:
    """flax's ndarray encoding: msgpack (shape, dtype name, C-order bytes)."""
    if arr.dtype.hasobject:
        raise ValueError("object arrays cannot be serialized")
    return packb([list(arr.shape), arr.dtype.name, arr.tobytes("C")])


def _pack_ext(code: int, data: bytes, out: bytearray) -> None:
    fixed = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
    if len(data) in fixed:
        out.append(fixed[len(data)])
    else:
        _pack_len(len(data), out, None, 0, (0xc7, 0xc8, 0xc9))
    out.append(code)
    out += data


def _pack(obj, out: bytearray) -> None:
    if obj is None:
        out.append(0xc0)
    elif obj is True or obj is False:
        out.append(0xc3 if obj else 0xc2)
    elif isinstance(obj, np.ndarray):
        _pack_ext(_EXT_NDARRAY, _array_payload(obj), out)
    elif isinstance(obj, np.generic):
        _pack_ext(_EXT_NPSCALAR, _array_payload(np.asarray(obj)), out)
    elif isinstance(obj, int):
        _pack_int(obj, out)
    elif isinstance(obj, float):
        out.append(0xcb)
        out += struct.pack(">d", obj)
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _pack_len(len(data), out, 0xa0, 32, (0xd9, 0xda, 0xdb))
        out += data
    elif isinstance(obj, (bytes, bytearray)):
        _pack_len(len(obj), out, None, 0, (0xc4, 0xc5, 0xc6))
        out += obj
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), out, 0x90, 16, (None, 0xdc, 0xdd))
        for item in obj:
            _pack(item, out)
    elif isinstance(obj, dict):
        _pack_len(len(obj), out, 0x80, 16, (None, 0xde, 0xdf))
        # flax writes maps in sorted key order (its tree_map sorts them).
        items = sorted(obj.items()) if all(isinstance(k, str) for k in obj) else obj.items()
        for key, value in items:
            _pack(key, out)
            _pack(value, out)
    else:
        raise TypeError(f"cannot serialize {type(obj).__name__}")


def packb(obj) -> bytes:
    """msgpack bytes of a tree of dicts, lists, scalars, strings, bytes and
    numpy arrays (as flax's extension type), byte for byte what flax's
    msgpack_serialize writes for the same tree."""
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


# --- msgpack reader ---------------------------------------------------------

class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        view = self.data[self.pos:self.pos + n]
        self.pos += n
        return view

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def read(self):
        b = self.take(1)[0]
        if b < 0x80:
            return b
        if b >= 0xe0:
            return b - 0x100
        if 0x80 <= b <= 0x8f:
            return self.map(b & 0x0f)
        if 0x90 <= b <= 0x9f:
            return [self.read() for _ in range(b & 0x0f)]
        if 0xa0 <= b <= 0xbf:
            return str(self.take(b & 0x1f), "utf-8")
        simple = {0xc0: None, 0xc2: False, 0xc3: True}
        if b in simple:
            return simple[b]
        numbers = {0xca: ">f", 0xcb: ">d", 0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q",
                   0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q"}
        if b in numbers:
            return self.unpack(numbers[b])
        sizes = {0xc4: ">B", 0xc5: ">H", 0xc6: ">I", 0xd9: ">B", 0xda: ">H", 0xdb: ">I",
                 0xdc: ">H", 0xdd: ">I", 0xde: ">H", 0xdf: ">I", 0xc7: ">B", 0xc8: ">H",
                 0xc9: ">I"}
        if b in sizes:
            n = self.unpack(sizes[b])
            if b <= 0xc6:
                return bytes(self.take(n))
            if b >= 0xd9 and b <= 0xdb:
                return str(self.take(n), "utf-8")
            if b in (0xdc, 0xdd):
                return [self.read() for _ in range(n)]
            if b in (0xde, 0xdf):
                return self.map(n)
            return self.ext(n)
        fixext = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}
        if b in fixext:
            return self.ext(fixext[b])
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.read()
            out[key] = self.read()
        return out

    def ext(self, n: int):
        code = self.unpack(">b")
        data = bytes(self.take(n))
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f"unsupported msgpack extension type {code}")
        shape, name, buf = unpackb(data)
        arr = np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape).copy()
        return arr[()] if code == _EXT_NPSCALAR else arr


def unpackb(data: bytes):
    """The tree packb (or flax's msgpack_serialize) wrote, arrays as numpy
    arrays."""
    reader = _Reader(data)
    obj = reader.read()
    if reader.pos != len(reader.data):
        raise ValueError("trailing bytes after the msgpack object")
    return obj


# --- checkpoints ------------------------------------------------------------

def save_variables(folder: str, variables: Dict[str, Any],
                   metadata: Optional[Dict[str, Any]] = None) -> str:
    """Save bare {'params', 'batch_stats'} (JAX layout, numpy arrays; see
    models/weights.py:variables_from_state_dicts) in the container
    load_variables reads, in either package."""
    os.makedirs(folder, exist_ok=True)
    payload = {"params": variables["params"], "batch_stats": variables["batch_stats"]}
    with open(os.path.join(folder, "state.msgpack"), "wb") as f:
        f.write(packb(payload))
    with open(os.path.join(folder, "meta.json"), "w") as f:
        json.dump(metadata or {}, f, indent=2, sort_keys=True)
    return folder


def load_variables(folder: str) -> Dict[str, Any]:
    """{'params', 'batch_stats'} (JAX layout, numpy arrays) from a checkpoint
    folder: the msgpack container, or a reference weights folder
    (feature_net.pth / stereo_net.pth), found by its files."""
    msgpack_path = os.path.join(folder, "state.msgpack")
    if os.path.exists(msgpack_path):
        with open(msgpack_path, "rb") as f:
            restored = unpackb(f.read())
        return {"params": restored["params"], "batch_stats": restored["batch_stats"]}
    if os.path.exists(os.path.join(folder, "feature_net.pth")):
        from ..models.weights import load_reference_folder, variables_from_state_dicts

        fsd, ssd = load_reference_folder(folder)
        # k is the number of downsampling convs.
        k = len({n.split(".")[1] for n in fsd if n.startswith("downsample.")})
        return variables_from_state_dicts(fsd, ssd, k)
    raise FileNotFoundError(f"no checkpoint found in {folder}")
