"""The JAX package's msgpack checkpoints without ``msgpack`` or flax.

The files are written by ``frcnn_tpu/utils/serialization.py`` through
flax's ``msgpack_serialize``: a msgpack map whose array leaves are ext
type 1 (ndarray; ext 3 is a numpy scalar), each holding a nested msgpack
array ``(shape, dtype name, C-order bytes)``. This module reads and writes
the msgpack subset those files use: nil/bool, ints, floats, str, bin,
arrays, maps and ext. Read arrays come back as read-only numpy arrays
(bfloat16 leaves are widened to float32: numpy has no bfloat16); a file
written here loads with flax's ``msgpack_restore`` and so with the JAX
package's ``load_checkpoint``.
"""

from __future__ import annotations

import os
import struct
from typing import Any, Dict

import numpy as np

CHECKPOINT_VERSION = 1
_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3

_FIXED = {  # code -> (struct format, size) of fixed-width scalars
    0xca: (">f", 4), 0xcb: (">d", 8),
    0xcc: (">B", 1), 0xcd: (">H", 2), 0xce: (">I", 4), 0xcf: (">Q", 8),
    0xd0: (">b", 1), 0xd1: (">h", 2), 0xd2: (">i", 4), 0xd3: (">q", 8),
}


class _Reader:
    def __init__(self, data, raw: bool):
        self.buf = memoryview(data)
        self.pos = 0
        self.raw = raw

    def _take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def _uint(self, n: int) -> int:
        return int.from_bytes(self._take(n), "big")

    def _str(self, n: int):
        b = self._take(n)
        return bytes(b) if self.raw else str(b, "utf-8")

    def _ext(self, code: int, n: int):
        data = self._take(n)
        if code == _EXT_NDARRAY:
            return _ndarray_from_bytes(data)
        if code == _EXT_NPSCALAR:
            return _ndarray_from_bytes(data)[()]
        raise ValueError(f"unsupported msgpack ext type {code}")

    def read(self) -> Any:
        c = self._take(1)[0]
        if c <= 0x7f:
            return c
        if c >= 0xe0:
            return c - 0x100
        if 0x80 <= c <= 0x8f:
            return self._map(c & 0x0f)
        if 0x90 <= c <= 0x9f:
            return [self.read() for _ in range(c & 0x0f)]
        if 0xa0 <= c <= 0xbf:
            return self._str(c & 0x1f)
        if c == 0xc0:
            return None
        if c == 0xc2:
            return False
        if c == 0xc3:
            return True
        if c in (0xc4, 0xc5, 0xc6):                   # bin 8/16/32
            return bytes(self._take(self._uint(1 << (c - 0xc4))))
        if c in (0xc7, 0xc8, 0xc9):                   # ext 8/16/32
            n = self._uint(1 << (c - 0xc7))
            code = struct.unpack(">b", self._take(1))[0]
            return self._ext(code, n)
        if c in _FIXED:
            fmt, n = _FIXED[c]
            return struct.unpack(fmt, self._take(n))[0]
        if 0xd4 <= c <= 0xd8:                         # fixext 1..16
            code = struct.unpack(">b", self._take(1))[0]
            return self._ext(code, 1 << (c - 0xd4))
        if c in (0xd9, 0xda, 0xdb):                   # str 8/16/32
            return self._str(self._uint(1 << (c - 0xd9)))
        if c in (0xdc, 0xdd):                         # array 16/32
            return [self.read() for _ in range(self._uint(2 << (c - 0xdc)))]
        if c in (0xde, 0xdf):                         # map 16/32
            return self._map(self._uint(2 << (c - 0xde)))
        raise ValueError(f"unsupported msgpack code 0x{c:02x}")

    def _map(self, n: int) -> Dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out


def _ndarray_from_bytes(data) -> np.ndarray:
    shape, dtype_name, buffer = _Reader(data, raw=True).read()
    name = dtype_name.decode()
    if name == "bfloat16":
        bits = np.frombuffer(buffer, dtype=np.uint16).astype(np.uint32)
        return (bits << 16).view(np.float32).reshape(shape)
    return np.frombuffer(buffer, dtype=np.dtype(name)).reshape(shape)


def unpackb(data) -> Any:
    """Decode one msgpack object (strings as str, flax arrays as numpy)."""
    r = _Reader(data, raw=False)
    out = r.read()
    if r.pos != len(r.buf):
        raise ValueError("trailing bytes after the msgpack object")
    return out


def load_checkpoint(path: str) -> Dict[str, Any]:
    """The checkpoint's payload: params, batch_stats, opt_state, step,
    stats, options, config_json (``frcnn_tpu/utils/serialization.py``)."""
    with open(path, "rb") as f:
        payload = unpackb(f.read())
    if payload.get("version") != CHECKPOINT_VERSION:
        raise ValueError(
            f"unsupported checkpoint version {payload.get('version')}")
    return payload


# -- writer -------------------------------------------------------------------

def _pack_len(out: bytearray, n: int, fix: int, fix_max: int, codes):
    """A length header: a fix code, else the 8/16/32-bit form (``codes``
    with ``None`` where the form does not exist)."""
    if fix is not None and n <= fix_max:
        out.append(fix | n)
        return
    for code, size in zip(codes, (1, 2, 4)):
        if code is not None and n < (1 << (8 * size)):
            out.append(code)
            out += n.to_bytes(size, "big")
            return
    raise ValueError(f"msgpack object too long: {n}")


def _pack_ext(out: bytearray, code: int, data: bytes):
    n = len(data)
    fixext = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
    if n in fixext:
        out.append(fixext[n])
    else:
        _pack_len(out, n, None, 0, (0xc7, 0xc8, 0xc9))
    out += struct.pack(">b", code)
    out += data


def _ndarray_bytes(a: np.ndarray) -> bytes:
    if a.dtype.hasobject:
        raise ValueError("object arrays cannot be serialized")
    return packb([list(a.shape), a.dtype.name, a.tobytes("C")])


def _pack(out: bytearray, x) -> None:
    if x is None:
        out.append(0xc0)
    elif x is True or x is False:
        out.append(0xc3 if x else 0xc2)
    elif isinstance(x, np.ndarray):
        _pack_ext(out, _EXT_NDARRAY, _ndarray_bytes(x))
    elif isinstance(x, np.generic):
        _pack_ext(out, _EXT_NPSCALAR, _ndarray_bytes(np.asarray(x)))
    elif isinstance(x, int):
        if 0 <= x <= 0x7f or -32 <= x < 0:
            out += struct.pack(">b" if x < 0 else ">B", x)
        elif x >= 0:
            for code, fmt, top in ((0xcc, ">B", 1 << 8), (0xcd, ">H", 1 << 16),
                                   (0xce, ">I", 1 << 32),
                                   (0xcf, ">Q", 1 << 64)):
                if x < top:
                    out.append(code)
                    out += struct.pack(fmt, x)
                    return
            raise ValueError(f"integer too large for msgpack: {x}")
        else:
            for code, fmt, lo in ((0xd0, ">b", -(1 << 7)),
                                  (0xd1, ">h", -(1 << 15)),
                                  (0xd2, ">i", -(1 << 31)),
                                  (0xd3, ">q", -(1 << 63))):
                if x >= lo:
                    out.append(code)
                    out += struct.pack(fmt, x)
                    return
            raise ValueError(f"integer too small for msgpack: {x}")
    elif isinstance(x, float):
        out.append(0xcb)
        out += struct.pack(">d", x)
    elif isinstance(x, str):
        b = x.encode("utf-8")
        _pack_len(out, len(b), 0xa0, 31, (0xd9, 0xda, 0xdb))
        out += b
    elif isinstance(x, (bytes, bytearray, memoryview)):
        b = bytes(x)
        _pack_len(out, len(b), None, 0, (0xc4, 0xc5, 0xc6))
        out += b
    elif isinstance(x, (list, tuple)):
        _pack_len(out, len(x), 0x90, 15, (None, 0xdc, 0xdd))
        for v in x:
            _pack(out, v)
    elif isinstance(x, dict):
        _pack_len(out, len(x), 0x80, 15, (None, 0xde, 0xdf))
        for k, v in x.items():
            _pack(out, k)
            _pack(out, v)
    else:
        raise TypeError(f"cannot serialize {type(x).__name__}")


def packb(obj) -> bytes:
    """Encode one object as msgpack (numpy arrays and scalars as flax's
    ext types 1 and 3)."""
    out = bytearray()
    _pack(out, obj)
    return bytes(out)


def save_checkpoint(path: str, *, params, batch_stats, opt_state=None,
                    step: int = 0, stats=None, options=None,
                    config_json: str = "") -> None:
    """Write a checkpoint in the JAX package's format: ``params`` and
    ``batch_stats`` as flax trees of numpy arrays, ``opt_state`` as the
    flat leaf list of the optimizer state (or None). Written to a
    temporary name, then moved into place."""
    payload = {
        "version": CHECKPOINT_VERSION,
        "params": params,
        "batch_stats": batch_stats,
        "opt_state": (None if opt_state is None
                      else [np.asarray(x) for x in opt_state]),
        "step": int(step),
        "stats": stats or {},
        "options": options or {},
        "config_json": config_json,
    }
    blob = packb(payload)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(blob)
    os.replace(tmp, path)
