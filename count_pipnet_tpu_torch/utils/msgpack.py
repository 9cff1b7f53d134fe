"""A msgpack decoder for the JAX package's checkpoint files, in plain Python.

The JAX package writes its checkpoints with
``flax.serialization.msgpack_serialize`` (count_pipnet_tpu/utils/
checkpoint.py); :func:`unpackb` reads them back as
``flax.serialization.msgpack_restore`` does, without the ``msgpack``
package:

* maps (str keys), arrays (as lists), str, bin, ints, floats, nil, bools;
* ext 1, an ndarray: a nested msgpack of (shape, dtype name, C-order
  bytes), returned as a CPU tensor (``bfloat16`` as ``torch.bfloat16``);
* ext 3, a numpy scalar in the same encoding, returned as a 0-d tensor;
* flax's chunked form of an array over ``MAX_CHUNK_SIZE`` bytes (a map
  with ``__msgpack_chunked_array__``, its ``shape`` and ``chunks`` as maps
  keyed "0", "1", ...), joined back into one tensor.

Anything else (another ext type, a map key that is not a str, a format
byte msgpack does not define) raises ``ValueError`` naming it. It decodes
only: the port writes its own checkpoints with ``torch.save``.
"""

import struct

import numpy as np
import torch

__all__ = ["unpackb"]

# flax.serialization._MsgpackExtType
_EXT_NAMES = {1: "ndarray", 2: "native_complex", 3: "npscalar"}

# dtype names flax writes (``ndarray.dtype.name``) -> numpy dtypes; numpy
# has no bfloat16, which is read as uint16 and viewed as torch.bfloat16
_DTYPES = {name: np.dtype(name) for name in (
    "float16", "float32", "float64", "int8", "int16", "int32", "int64",
    "uint8", "bool")}


class _Reader:
    """One pass over a msgpack buffer."""

    def __init__(self, data):
        self.buf = memoryview(data)
        self.pos = 0

    def take(self, n):
        if self.pos + n > len(self.buf):
            raise ValueError("msgpack: truncated data")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt):
        size = struct.calcsize(fmt)
        return struct.unpack(fmt, self.take(size))[0]

    def read(self):
        b = self.take(1)[0]
        if b <= 0x7f:
            return b
        if b >= 0xe0:
            return b - 0x100
        if 0x80 <= b <= 0x8f:
            return self.map(b & 0x0f)
        if 0x90 <= b <= 0x9f:
            return self.array(b & 0x0f)
        if 0xa0 <= b <= 0xbf:
            return self.str(b & 0x1f)
        op = _OPS.get(b)
        if op is None:
            raise ValueError(f"msgpack: format byte 0x{b:02x} is not "
                             "defined")
        return op(self)

    def map(self, n):
        out = {}
        for _ in range(n):
            k = self.read()
            if not isinstance(k, str):
                raise ValueError(f"msgpack: map key {k!r} is not a str")
            out[k] = self.read()
        return out

    def array(self, n):
        return [self.read() for _ in range(n)]

    def str(self, n):
        return str(self.take(n), "utf-8")

    def ext(self, n):
        code = self.unpack(">b")
        return _ext(code, self.take(n))


def _ndarray(data):
    """Decode flax's nested (shape, dtype name, bytes) encoding; the bytes
    are viewed in place and copied once, into the tensor."""
    r = _Reader(data)
    if r.take(1)[0] != 0x93:
        raise ValueError("msgpack: an ndarray is not a (shape, dtype, "
                         "bytes) triple")
    shape, name = r.read(), r.read()
    b = r.take(1)[0]
    if b not in (0xc4, 0xc5, 0xc6):
        raise ValueError("msgpack: an ndarray's data is not bin")
    raw = r.take(r.unpack({0xc4: ">B", 0xc5: ">H", 0xc6: ">I"}[b]))
    if name == "bfloat16":
        a = np.frombuffer(raw, dtype=np.uint16).copy()
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    elif name in _DTYPES:
        t = torch.from_numpy(np.frombuffer(raw, dtype=_DTYPES[name]).copy())
    else:
        raise ValueError(f"msgpack: ndarray dtype {name!r} is not supported")
    return t.reshape(tuple(shape))


def _ext(code, data):
    if code == 1:
        return _ndarray(data)
    if code == 3:
        return _ndarray(data).reshape(())
    name = _EXT_NAMES.get(code, "unknown")
    raise ValueError(f"msgpack: ext type {code} ({name}) is not supported")


def _fixext(n):
    return lambda r: r.ext(n)


_OPS = {
    0xc0: lambda r: None,
    0xc2: lambda r: False,
    0xc3: lambda r: True,
    0xc4: lambda r: bytes(r.take(r.unpack(">B"))),
    0xc5: lambda r: bytes(r.take(r.unpack(">H"))),
    0xc6: lambda r: bytes(r.take(r.unpack(">I"))),
    0xc7: lambda r: r.ext(r.unpack(">B")),
    0xc8: lambda r: r.ext(r.unpack(">H")),
    0xc9: lambda r: r.ext(r.unpack(">I")),
    0xca: lambda r: r.unpack(">f"),
    0xcb: lambda r: r.unpack(">d"),
    0xcc: lambda r: r.unpack(">B"),
    0xcd: lambda r: r.unpack(">H"),
    0xce: lambda r: r.unpack(">I"),
    0xcf: lambda r: r.unpack(">Q"),
    0xd0: lambda r: r.unpack(">b"),
    0xd1: lambda r: r.unpack(">h"),
    0xd2: lambda r: r.unpack(">i"),
    0xd3: lambda r: r.unpack(">q"),
    0xd4: _fixext(1),
    0xd5: _fixext(2),
    0xd6: _fixext(4),
    0xd7: _fixext(8),
    0xd8: _fixext(16),
    0xd9: lambda r: r.str(r.unpack(">B")),
    0xda: lambda r: r.str(r.unpack(">H")),
    0xdb: lambda r: r.str(r.unpack(">I")),
    0xdc: lambda r: r.array(r.unpack(">H")),
    0xdd: lambda r: r.array(r.unpack(">I")),
    0xde: lambda r: r.map(r.unpack(">H")),
    0xdf: lambda r: r.map(r.unpack(">I")),
}


def _unchunk(tree):
    """flax's _unchunk_array_leaves_in_place: chunked maps -> tensors."""
    if not isinstance(tree, dict):
        return tree
    if "__msgpack_chunked_array__" in tree:
        shape = [tree["shape"][str(i)] for i in range(len(tree["shape"]))]
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return torch.cat([c.reshape(-1) for c in chunks]).reshape(
            tuple(shape))
    return {k: _unchunk(v) for k, v in tree.items()}


def unpackb(data):
    """The object one msgpack buffer encodes (see the module docstring)."""
    r = _Reader(data)
    out = r.read()
    if r.pos != len(r.buf):
        raise ValueError(f"msgpack: {len(r.buf) - r.pos} bytes past the "
                         "end of the object")
    return _unchunk(out)
