"""Flax `.msgpack` checkpoints read without flax or the msgpack package.

A small msgpack decoder in pure Python: maps, arrays, str, bin, ints,
floats, nil and bool, and flax's two array extension types: ext 1, an
ndarray stored as a msgpack triple (shape, dtype name, raw little-endian
bytes), and ext 3, a numpy scalar stored the same way. Any other ext code
raises. Arrays over flax's chunk size, which flax writes as
`{'__msgpack_chunked_array__', 'shape', 'chunks'}` dicts, are joined back.
A leaf whose dtype is bfloat16 (no numpy dtype) is read as uint16 and
returned as a `torch.bfloat16` tensor; every other leaf is a numpy array
or scalar.

`load_params_msgpack(path)` is the counterpart of the JAX package's
`eval/val_pipeline.load_params_msgpack`: the whole nested dict of a
checkpoint file (a TrainState's {'params', 'opt_state', 'n_iter'}, or bare
parameters or variables).
"""

from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np
import torch

EXT_NDARRAY, EXT_NPSCALAR = 1, 3
CHUNKED = "__msgpack_chunked_array__"


class MsgpackError(ValueError):
    pass


def _ext_array(data: bytes):
    shape, name, buf = unpackb(data)
    name = name.decode() if isinstance(name, bytes) else name
    if name == "bfloat16":
        bits = np.frombuffer(buf, dtype="<u2").reshape(shape)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return np.frombuffer(buf, dtype=np.dtype(name).newbyteorder("<")).reshape(shape).astype(
        np.dtype(name))


def _ext(code: int, data: bytes):
    if code == EXT_NDARRAY:
        return _ext_array(data)
    if code == EXT_NPSCALAR:
        return _ext_array(data)[()]
    raise MsgpackError(f"msgpack ext type {code} is not a flax array (1) or scalar (3)")


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise MsgpackError("msgpack data ends early")
        out = self.data[self.pos:self.pos + n].tobytes()
        self.pos += n
        return out

    def num(self, fmt: str):
        return struct.unpack(">" + fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.take(b & 0x1F).decode()
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if b in _SIZED:
            kind, fmt = _SIZED[b]
            n = self.num(fmt)
            if kind == "bin":
                return self.take(n)
            if kind == "str":
                return self.take(n).decode()
            if kind == "array":
                return self.array(n)
            if kind == "map":
                return self.map(n)
            code = self.num("b")  # ext
            return _ext(code, self.take(n))
        if b in _FIXEXT:
            code = self.num("b")
            return _ext(code, self.take(_FIXEXT[b]))
        if b in _NUMBERS:
            return self.num(_NUMBERS[b])
        raise MsgpackError(f"byte 0x{b:02x} at offset {self.pos - 1} starts no msgpack value")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out


_SIZED = {0xC4: ("bin", "B"), 0xC5: ("bin", "H"), 0xC6: ("bin", "I"),
          0xC7: ("ext", "B"), 0xC8: ("ext", "H"), 0xC9: ("ext", "I"),
          0xD9: ("str", "B"), 0xDA: ("str", "H"), 0xDB: ("str", "I"),
          0xDC: ("array", "H"), 0xDD: ("array", "I"),
          0xDE: ("map", "H"), 0xDF: ("map", "I")}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
_NUMBERS = {0xCA: "f", 0xCB: "d", 0xCC: "B", 0xCD: "H", 0xCE: "I", 0xCF: "Q",
            0xD0: "b", 0xD1: "h", 0xD2: "i", 0xD3: "q"}


def unpackb(data: bytes) -> Any:
    """One msgpack value from `data`, which it must fill exactly."""
    r = _Reader(data)
    out = r.value()
    if r.pos != len(r.data):
        raise MsgpackError(f"{len(r.data) - r.pos} bytes after the msgpack value")
    return out


def _indexed(d: dict) -> Tuple:
    return tuple(d[str(i)] for i in range(len(d)))


def _unchunk(tree: Any) -> Any:
    if isinstance(tree, dict):
        if CHUNKED in tree:
            chunks = _indexed(tree["chunks"])
            flat = (torch.cat(chunks) if isinstance(chunks[0], torch.Tensor)
                    else np.concatenate(chunks))
            return flat.reshape(_indexed(tree["shape"]))
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def msgpack_restore(data: bytes) -> Any:
    """The tree flax's `serialization.msgpack_restore` gives for `data`."""
    return _unchunk(unpackb(data))


def load_params_msgpack(path: str) -> dict:
    """A flax `.msgpack` checkpoint file as its nested dict of arrays."""
    with open(path, "rb") as f:
        tree = msgpack_restore(f.read())
    if not isinstance(tree, dict):
        raise MsgpackError(f"{path}: the top level is a {type(tree).__name__}, not a map")
    return tree
