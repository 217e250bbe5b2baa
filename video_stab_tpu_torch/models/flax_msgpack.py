"""A reader of flax's msgpack checkpoints (``flax.serialization.to_bytes``),
so the port loads the JAX package's weight files without msgpack or flax.

It decodes the msgpack types such a file holds: maps, arrays, str, bin,
nil, booleans, ints and floats, and flax's ext type 1 (an ndarray: the
msgpack triple shape, dtype name, C-order buffer). bfloat16 arrays come
back as float32 (exact).
"""

from __future__ import annotations

import struct
from typing import Any

import numpy as np

_EXT_NDARRAY = 1


class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def take(self, n: int) -> bytes:
        out = self.data[self.pos:self.pos + n]
        if len(out) != n:
            raise ValueError("msgpack: truncated data")
        self.pos += n
        return out

    def unpack(self, fmt: str) -> Any:
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
            return self.take(b & 0x1F).decode("utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {0xC4: ("bin", "B"), 0xC5: ("bin", "H"), 0xC6: ("bin", "I"),
                 0xC7: ("ext", "B"), 0xC8: ("ext", "H"), 0xC9: ("ext", "I"),
                 0xD9: ("str", "B"), 0xDA: ("str", "H"), 0xDB: ("str", "I"),
                 0xDC: ("array", "H"), 0xDD: ("array", "I"),
                 0xDE: ("map", "H"), 0xDF: ("map", "I")}
        if b in sized:
            kind, fmt = sized[b]
            n = self.unpack(fmt)
            if kind == "bin":
                return self.take(n)
            if kind == "str":
                return self.take(n).decode("utf-8")
            if kind == "array":
                return self.array(n)
            if kind == "map":
                return self.map(n)
            return self.ext(self.unpack("b"), n)
        numbers = {0xCA: "f", 0xCB: "d", 0xCC: "B", 0xCD: "H", 0xCE: "I",
                   0xCF: "Q", 0xD0: "b", 0xD1: "h", 0xD2: "i", 0xD3: "q"}
        if b in numbers:
            return self.unpack(numbers[b])
        if 0xD4 <= b <= 0xD8:                      # fixext 1, 2, 4, 8, 16
            return self.ext(self.unpack("b"), 1 << (b - 0xD4))
        raise ValueError(f"msgpack: unsupported type byte 0x{b:02x}")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out

    def ext(self, code: int, n: int) -> Any:
        payload = self.take(n)
        if code != _EXT_NDARRAY:
            raise ValueError(f"msgpack: unsupported ext type {code}")
        return _ndarray(payload)


def _ndarray(payload: bytes) -> np.ndarray:
    shape, dtype_name, buffer = loads(payload)
    name = dtype_name.decode() if isinstance(dtype_name, bytes) \
        else dtype_name
    shape = tuple(int(d) for d in shape)
    if name == "bfloat16":
        bits = np.frombuffer(buffer, dtype=np.uint16).astype(np.uint32)
        return (bits << 16).view(np.float32).reshape(shape)
    return np.frombuffer(buffer, dtype=np.dtype(name)).reshape(shape).copy()


def loads(data: bytes) -> Any:
    """Decode one msgpack value from ``data``."""
    reader = _Reader(data)
    out = reader.value()
    if reader.pos != len(data):
        raise ValueError("msgpack: trailing bytes")
    return out


def load(path: str) -> Any:
    """The tree of a flax msgpack file: dicts of numpy arrays."""
    with open(path, "rb") as f:
        return loads(f.read())
