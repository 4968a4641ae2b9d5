"""A decoder of flax's msgpack format, without the ``msgpack`` package.

The JAX package writes its weights with ``flax.serialization.to_bytes``
(``<name>.params.msgpack``, ``<name>.int8.msgpack``). That is msgpack
with one extension: an ndarray is ext type 1 whose payload is itself
msgpack, the array ``(shape, dtype name, C-order bytes)``.

``unpackb`` covers what such a variables tree holds: maps, strings,
integers, floats, nil, booleans and the ndarray extension (whose payload
also holds an array and a bin). Anything else raises ``ValueError`` by
name: flax's scalar and complex extensions, bin and array values in the
tree, bfloat16 and object dtypes, and flax's chunked form of a large
array (a map with ``__msgpack_chunked_array__``). flax chunks only
leaves above 2^30 bytes; no leaf of the models here comes near that, and
no export of the JAX package met the form.
"""

from __future__ import annotations

import struct

import numpy as np

__all__ = ["unpackb", "read_msgpack"]

_NDARRAY = 1
_EXT_NAMES = {2: "complex scalar", 3: "numpy scalar"}


class _Reader:
    def __init__(self, data, in_ndarray=False):
        self.data = memoryview(data)
        self.pos = 0
        self.in_ndarray = in_ndarray

    def take(self, n):
        if self.pos + n > len(self.data):
            raise ValueError("msgpack data ends inside a value")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self):
        b = self.unpack(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
                 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in sized:
            return self.unpack(sized[b])
        lengths = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
        if b in lengths:
            return self.str(self.unpack(lengths[b]))
        if b in (0xDC, 0xDD):
            return self.array(self.unpack(">H" if b == 0xDC else ">I"))
        if b in (0xDE, 0xDF):
            return self.map(self.unpack(">H" if b == 0xDE else ">I"))
        if b in (0xC4, 0xC5, 0xC6):
            if not self.in_ndarray:
                raise ValueError("msgpack bin value in the tree: not a "
                                 "flax variables tree")
            return bytes(self.take(self.unpack(">" + "BHI"[b - 0xC4])))
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self.ext(fixext[b])
        if b in (0xC7, 0xC8, 0xC9):
            return self.ext(self.unpack(">" + "BHI"[b - 0xC7]))
        raise ValueError(f"msgpack type byte 0x{b:02x} is not valid")

    def str(self, n):
        return bytes(self.take(n)).decode("utf-8")

    def array(self, n):
        if not self.in_ndarray:
            raise ValueError("msgpack array value in the tree: not a flax "
                             "variables tree (flax stores lists as maps)")
        return [self.value() for _ in range(n)]

    def map(self, n):
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        if "__msgpack_chunked_array__" in out:
            raise ValueError("flax's chunked large-array form "
                             "(__msgpack_chunked_array__) is not supported")
        return out

    def ext(self, n):
        code = self.unpack(">b")
        payload = self.take(n)
        if code != _NDARRAY:
            name = _EXT_NAMES.get(code, f"ext type {code}")
            raise ValueError(f"msgpack {name} extension is not supported")
        return _ndarray(payload)


def _ndarray(payload):
    """flax's ndarray payload: msgpack (shape, dtype name, bytes)."""
    inner = _Reader(payload, in_ndarray=True)
    shape, dtype_name, buffer = inner.value()
    if isinstance(dtype_name, str):
        dtype_name = dtype_name.encode()
    name = dtype_name.decode("ascii")
    if name == "bfloat16":
        raise ValueError("bfloat16 ndarray leaves are not supported")
    dtype = np.dtype(name)
    if dtype.hasobject or dtype.fields is not None:
        raise ValueError(f"ndarray dtype {name} is not supported")
    return np.frombuffer(buffer, dtype=dtype).reshape(shape).copy()


def unpackb(data):
    """flax msgpack bytes -> nested dicts of numpy arrays and Python
    scalars, as ``flax.serialization.msgpack_restore`` gives them."""
    reader = _Reader(data)
    out = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError(f"{len(reader.data) - reader.pos} bytes after the "
                         f"msgpack value")
    return out


def read_msgpack(path):
    """``unpackb`` of a file's bytes."""
    with open(path, "rb") as f:
        return unpackb(f.read())
