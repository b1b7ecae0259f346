"""A msgpack decoder for the JAX package's checkpoint files.

The JAX package writes each checkpoint part with flax's
`serialization.to_bytes` (ofb_tpu/core/checkpoint.py): msgpack over a
state dict, arrays as msgpack extension 1, whose payload is itself msgpack
`(shape, dtype name, C-order bytes)`. This module reads that format with
the standard library and numpy only:

  * every format code flax writes: nil, bool, ints and floats of every
    width, str, bin, array, map and ext;
  * ext 1 becomes a numpy array, except `bfloat16`, which numpy lacks: its
    bytes are read as uint16 and viewed as a `torch.bfloat16` tensor;
  * ext 2 (a complex scalar) and ext 3 (a numpy scalar) raise, naming the
    code: no checkpoint of the JAX package holds them;
  * arrays flax split into chunks (`__msgpack_chunked_array__`, above
    2**30 bytes) are joined again.

`destatedict` turns maps whose keys are all decimal strings back into
lists, as the JAX package's `load_checkpoint_raw` does. There is no
encoder: the JAX package never reads the port's checkpoints.
"""

from __future__ import annotations

import struct
from typing import Any, Dict

import numpy as np
import torch

EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3
_EXT_NAMES = {EXT_COMPLEX: "a complex scalar (flax ext code 2)",
              EXT_NPSCALAR: "a numpy scalar (flax ext code 3)"}
_CHUNKED = "__msgpack_chunked_array__"

# fixed-width codes: (struct format, size)
_FIXED = {0xca: (">f", 4), 0xcb: (">d", 8),
          0xcc: (">B", 1), 0xcd: (">H", 2), 0xce: (">I", 4), 0xcf: (">Q", 8),
          0xd0: (">b", 1), 0xd1: (">h", 2), 0xd2: (">i", 4), 0xd3: (">q", 8)}
# codes with a length prefix: (kind, struct format of the length, size)
_SIZED = {0xc4: ("bin", ">B", 1), 0xc5: ("bin", ">H", 2),
          0xc6: ("bin", ">I", 4), 0xc7: ("ext", ">B", 1),
          0xc8: ("ext", ">H", 2), 0xc9: ("ext", ">I", 4),
          0xd9: ("str", ">B", 1), 0xda: ("str", ">H", 2),
          0xdb: ("str", ">I", 4), 0xdc: ("array", ">H", 2),
          0xdd: ("array", ">I", 4), 0xde: ("map", ">H", 2),
          0xdf: ("map", ">I", 4)}
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}


class MsgpackError(ValueError):
    """The bytes are not the msgpack the JAX package writes."""


class _Reader:
    def __init__(self, data, raw: bool):
        self.buf = memoryview(data)
        self.pos = 0
        self.raw = raw              # str as bytes (flax's array payloads)

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.buf):
            raise MsgpackError(f"truncated msgpack: {n} bytes wanted at "
                               f"offset {self.pos} of {len(self.buf)}")
        out = self.buf[self.pos:end]
        self.pos = end
        return out

    def unpack(self, fmt: str, n: int):
        return struct.unpack(fmt, self.take(n))[0]

    def value(self) -> Any:
        code = self.take(1)[0]
        if code <= 0x7f:
            return code
        if code >= 0xe0:
            return code - 0x100
        if 0x80 <= code <= 0x8f:
            return self.map(code & 0x0f)
        if 0x90 <= code <= 0x9f:
            return [self.value() for _ in range(code & 0x0f)]
        if 0xa0 <= code <= 0xbf:
            return self.str(code & 0x1f)
        if code == 0xc0:
            return None
        if code in (0xc2, 0xc3):
            return code == 0xc3
        if code in _FIXED:
            return self.unpack(*_FIXED[code])
        if code in _FIXEXT:
            return self.ext(_FIXEXT[code])
        if code in _SIZED:
            kind, fmt, size = _SIZED[code]
            n = self.unpack(fmt, size)
            if kind == "bin":
                return bytes(self.take(n))
            if kind == "str":
                return self.str(n)
            if kind == "array":
                return [self.value() for _ in range(n)]
            if kind == "map":
                return self.map(n)
            return self.ext(n)
        raise MsgpackError(f"msgpack format code {code:#04x} at offset "
                           f"{self.pos - 1} is not one flax writes")

    def str(self, n: int):
        b = bytes(self.take(n))
        return b if self.raw else b.decode("utf-8")

    def map(self, n: int) -> Dict[Any, Any]:
        out = {}
        for _ in range(n):
            k = self.value()
            if not isinstance(k, (str, bytes)):
                raise MsgpackError(f"map key {k!r} is not a string")
            out[k] = self.value()
        return out

    def ext(self, n: int):
        code = self.unpack(">b", 1)
        payload = self.take(n)
        if code == EXT_NDARRAY:
            return _ndarray(payload)
        what = _EXT_NAMES.get(code, f"msgpack ext code {code}")
        raise MsgpackError(f"{what}: the port reads only flax's arrays "
                           f"(ext code {EXT_NDARRAY})")


def _ndarray(payload: memoryview):
    """flax's array payload -> numpy array (torch.bfloat16 tensor for
    bfloat16)."""
    r = _Reader(payload, raw=True)
    shape, name, data = r.value()
    if r.pos != len(payload):
        raise MsgpackError("trailing bytes in an array payload")
    name = name.decode("ascii")
    dtype = np.dtype(np.uint16) if name == "bfloat16" else np.dtype(name)
    arr = np.frombuffer(data, dtype=dtype).reshape(shape).copy()
    if name == "bfloat16":
        return torch.from_numpy(arr).view(torch.bfloat16)
    return arr


def _unchunk(node):
    """Join flax's chunked array leaves, as `msgpack_restore` does."""
    if isinstance(node, dict):
        if _CHUNKED in node:
            shape = tuple(node["shape"][str(i)]
                          for i in range(len(node["shape"])))
            chunks = [node["chunks"][str(i)]
                      for i in range(len(node["chunks"]))]
            if isinstance(chunks[0], torch.Tensor):
                return torch.cat(chunks).reshape(shape)
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in node.items()}
    return node


def unpackb(data) -> Any:
    """The object of one msgpack document written by flax's `to_bytes` or
    `msgpack_serialize`, with flax's array leaves decoded."""
    r = _Reader(data, raw=False)
    out = r.value()
    if r.pos != len(r.buf):
        raise MsgpackError(f"{len(r.buf) - r.pos} bytes after the msgpack "
                           "document")
    return _unchunk(out)


def destatedict(node):
    """Invert flax's state-dict encoding of sequences: maps whose keys are
    all decimal strings become lists, ordered by index."""
    if isinstance(node, dict):
        if node and all(isinstance(k, str) and k.isdigit() for k in node):
            return [destatedict(node[str(i)]) for i in range(len(node))]
        return {k: destatedict(v) for k, v in node.items()}
    return node


def read_tree(path: str):
    """A JAX checkpoint part file as a tree of dicts, lists and arrays."""
    with open(path, "rb") as f:
        return destatedict(unpackb(f.read()))
