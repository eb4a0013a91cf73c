"""Pure-Python reader and writer of Torch7's binary serialization format
(".t7"), the JAX package's ``data/t7.py``: the reference stores its
training-data files (``create-duplo-traindata.lua:68-79``) and model
snapshots (``utilities.lua:126-134``) through ``torch.save``; this lets
users of the reference bring those files over without Torch7.

Format (little-endian; the stock ``torch.DiskFile`` binary layout):

* element   := int32 type code, then payload
* NUMBER(1) := float64
* STRING(2) := int32 length + bytes
* TABLE(3)  := int32 heap index; if unseen: int32 pair count, then
               count x (key element, value element)
* TORCH(4)  := int32 heap index; if unseen: version string element
               (b"V <n>"; legacy files put the class name here),
               class-name string element, then class payload —
               ``torch.*Tensor``: int32 ndim, ndim int64 sizes, ndim int64
               strides, int64 storageOffset (1-based), storage element;
               ``torch.*Storage``: int64 size + raw data;
               any other class: its state table element (the default
               ``torch.class`` serialization — covers the reference's Rect)
* BOOLEAN(5):= int32 0/1
* NIL(0)    := nothing

Repeated tables/objects serialize as just the heap index — the reader
memoizes by index. Function types (6/7/8) are not supported (the
reference's data files contain none).
"""

from __future__ import annotations

import struct
from typing import Any, BinaryIO, Dict

TYPE_NIL = 0
TYPE_NUMBER = 1
TYPE_STRING = 2
TYPE_TABLE = 3
TYPE_TORCH = 4
TYPE_BOOLEAN = 5

_TENSOR_DTYPES = {
    "torch.DoubleTensor": ("d", 8), "torch.FloatTensor": ("f", 4),
    "torch.LongTensor": ("q", 8), "torch.IntTensor": ("i", 4),
    "torch.ShortTensor": ("h", 2), "torch.ByteTensor": ("B", 1),
    "torch.CharTensor": ("b", 1),
}
_STORAGE_DTYPES = {
    k.replace("Tensor", "Storage"): v for k, v in _TENSOR_DTYPES.items()
}


class TorchObject:
    """A deserialized non-tensor torch class instance (e.g. the reference's
    ``Rect``): ``.torch_class`` + ``.state`` (its table)."""

    def __init__(self, torch_class: str, state):
        self.torch_class = torch_class
        self.state = state

    def __repr__(self):
        return f"TorchObject({self.torch_class}, {self.state!r})"


class TorchTensor:
    """Deserialized tensor: shape/stride metadata + flat storage list.
    ``tolist()`` materializes nested lists; ``numpy()`` an ndarray."""

    def __init__(self, torch_class, size, stride, offset, storage):
        self.torch_class = torch_class
        self.size = size
        self.stride = stride
        self.offset = offset          # 0-based into storage
        self.storage = storage        # flat python list

    def numpy(self):
        import numpy as np

        if not self.size:
            return np.zeros((0,))
        if any(s <= 0 for s in self.size):
            return np.zeros(tuple(max(s, 0) for s in self.size))
        # validate file-supplied geometry BEFORE as_strided: sizes/strides
        # from a corrupt file would otherwise read out of the backing
        # buffer (silent garbage or a segfault, not an error)
        lo = self.offset
        hi = self.offset
        for n, st in zip(self.size, self.stride):
            if st >= 0:
                hi += (n - 1) * st
            else:
                lo += (n - 1) * st
        if lo < 0 or hi >= len(self.storage):
            raise ValueError(
                f"corrupt t7 tensor: size {self.size} / stride "
                f"{self.stride} / offset {self.offset} spans [{lo}, {hi}] "
                f"outside its storage of {len(self.storage)} elements"
            )
        flat = np.asarray(self.storage)
        out = np.lib.stride_tricks.as_strided(
            flat[self.offset:],
            shape=tuple(self.size),
            strides=tuple(s * flat.itemsize for s in self.stride),
        )
        return out.copy()

    def tolist(self):
        return self.numpy().tolist()


class LuaTable(dict):
    """Lua table: dict with helpers for the 1-based array part."""

    def list(self):
        """Consecutive 1..n number-keyed values as a python list."""
        out = []
        i = 1
        while i in self or float(i) in self:
            out.append(self.get(i, self.get(float(i))))
            i += 1
        return out


class T7Reader:
    def __init__(self, f: BinaryIO):
        self.f = f
        self.memo: Dict[int, Any] = {}

    def _read(self, fmt: str):
        size = struct.calcsize(fmt)
        buf = self.f.read(size)
        if len(buf) != size:
            raise EOFError("truncated t7 file")
        return struct.unpack("<" + fmt, buf)[0]

    def _int(self) -> int:
        return self._read("i")

    def _long(self) -> int:
        return self._read("q")

    def _string(self) -> bytes:
        n = self._int()
        if n < 0:
            raise ValueError(f"corrupt t7 file: negative string length {n}")
        buf = self.f.read(n)
        if len(buf) != n:
            raise EOFError("truncated t7 file")
        return buf

    def read(self):
        t = self._int()
        if t == TYPE_NIL:
            return None
        if t == TYPE_NUMBER:
            v = self._read("d")
            return int(v) if v == int(v) and abs(v) < 2**53 else v
        if t == TYPE_STRING:
            return self._string().decode("utf-8", "replace")
        if t == TYPE_BOOLEAN:
            return self._int() == 1
        if t == TYPE_TABLE:
            idx = self._int()
            if idx in self.memo:
                return self.memo[idx]
            tbl = LuaTable()
            self.memo[idx] = tbl
            n = self._int()
            for _ in range(n):
                k = self.read()
                v = self.read()
                tbl[k] = v
            return tbl
        if t == TYPE_TORCH:
            idx = self._int()
            if idx in self.memo:
                return self.memo[idx]
            version = self._string()
            if version.startswith(b"V "):
                cls = self._string().decode()
            else:  # legacy layout: the "version" WAS the class name
                cls = version.decode()
            if cls in _TENSOR_DTYPES or cls in _STORAGE_DTYPES:
                # no nested element of a tensor/storage record can refer
                # back to this index; memoize after
                obj = self._read_torch(cls)
                self.memo[idx] = obj
                return obj
            # plain torch.class instance: register the shell BEFORE
            # reading the state table (same order as TYPE_TABLE) so a
            # self-referential field resolves instead of desyncing the
            # stream
            obj = TorchObject(cls, None)
            self.memo[idx] = obj
            obj.state = self.read()
            return obj
        raise ValueError(f"unsupported t7 type code {t}")

    def _read_torch(self, cls: str):
        if cls in _TENSOR_DTYPES:
            ndim = self._int()
            if not 0 <= ndim <= 64:
                raise ValueError(f"corrupt t7 file: tensor ndim {ndim}")
            size = [self._long() for _ in range(ndim)]
            stride = [self._long() for _ in range(ndim)]
            offset = self._long() - 1
            storage = self.read()
            data = storage.storage if isinstance(storage, TorchTensor) else storage
            return TorchTensor(cls, size, stride, offset, data or [])
        if cls in _STORAGE_DTYPES:
            fmt, width = _STORAGE_DTYPES[cls]
            n = self._long()
            if n < 0:
                raise ValueError(f"corrupt t7 file: negative storage size {n}")
            buf = self.f.read(n * width)
            if len(buf) != n * width:
                raise EOFError("truncated t7 file")
            return list(struct.unpack(f"<{n}{fmt}", buf))
        raise AssertionError(f"_read_torch called for plain class {cls}")


def load(path: str):
    with open(path, "rb") as f:
        return T7Reader(f).read()


# --- writer (used by the tests to fabricate files byte-compatible with ---
# --- torch.save; also handy for exporting back to the reference)       ---

class T7Writer:
    def __init__(self, f: BinaryIO):
        self.f = f
        self.next_idx = 1
        self.memo: Dict[int, int] = {}   # id(obj) -> heap index

    def _w(self, fmt: str, v):
        self.f.write(struct.pack("<" + fmt, v))

    def _string(self, b: bytes):
        self._w("i", len(b))
        self.f.write(b)

    def write(self, obj):
        if obj is None:
            self._w("i", TYPE_NIL)
        elif isinstance(obj, bool):
            self._w("i", TYPE_BOOLEAN)
            self._w("i", 1 if obj else 0)
        elif isinstance(obj, (int, float)):
            self._w("i", TYPE_NUMBER)
            self._w("d", float(obj))
        elif isinstance(obj, str):
            self._w("i", TYPE_STRING)
            self._string(obj.encode())
        elif isinstance(obj, TorchTensor):
            self._w("i", TYPE_TORCH)
            if self._memoize(obj):
                return
            self._string(b"V 1")
            self._string(obj.torch_class.encode())
            self._w("i", len(obj.size))
            for s in obj.size:
                self._w("q", s)
            for s in obj.stride:
                self._w("q", s)
            self._w("q", obj.offset + 1)
            self._write_storage(obj)
        elif isinstance(obj, TorchObject):
            self._w("i", TYPE_TORCH)
            if self._memoize(obj):
                return
            self._string(b"V 1")
            self._string(obj.torch_class.encode())
            self.write(obj.state)
        elif isinstance(obj, dict):
            self._w("i", TYPE_TABLE)
            if self._memoize(obj):
                return
            self._w("i", len(obj))
            for k, v in obj.items():
                self.write(k)
                self.write(v)
        elif isinstance(obj, (list, tuple)):
            self.write(LuaTable({i + 1: v for i, v in enumerate(obj)}))
        else:
            raise TypeError(f"cannot serialize {type(obj)} to t7")

    def _memoize(self, obj) -> bool:
        key = id(obj)
        if key in self.memo:
            self._w("i", self.memo[key])
            return True
        self.memo[key] = self.next_idx
        self._w("i", self.next_idx)
        self.next_idx += 1
        return False

    def _write_storage(self, t: TorchTensor):
        storage_cls = t.torch_class.replace("Tensor", "Storage")
        fmt, _ = _STORAGE_DTYPES[storage_cls]
        self._w("i", TYPE_TORCH)
        self._w("i", self.next_idx)
        self.next_idx += 1
        self._string(b"V 1")
        self._string(storage_cls.encode())
        self._w("q", len(t.storage))
        self.f.write(struct.pack(f"<{len(t.storage)}{fmt}", *t.storage))


def save(path: str, obj):
    with open(path, "wb") as f:
        T7Writer(f).write(obj)
