"""A pure-Python reader of satpu's checkpoint files (flax msgpack).

satpu writes a checkpoint as ``flax.serialization.msgpack_serialize({
"meta_json": ..., "state": ...})`` (``satpu/utils/checkpoint.py``). This
module reads those bytes without ``msgpack`` or ``flax``:

- msgpack's formats in all their widths: nil, bool, the fixed, 8-, 16-,
  32- and 64-bit integers, float32 / float64, str and bin (fix / 8 / 16 /
  32), arrays and maps (fix / 16 / 32) and the ext types (fixext 1-16,
  ext 8 / 16 / 32); maps come back as dicts, arrays as lists;
- flax's ext types: code 1, an ndarray (a nested msgpack ``(shape, dtype
  name, C-order bytes)``), code 2, a Python complex (a nested ``(real,
  imag)``), code 3, a numpy scalar (an ndarray of shape ``()``);
- flax's chunked arrays (a dict ``{"__msgpack_chunked_array__": True,
  "shape": {"0": ...}, "chunks": {"0": ..., "1": ...}}`` for an array over
  ``MAX_CHUNK_SIZE`` bytes; flax/serialization.py ``_chunk``), joined back
  where flax joins them: as dict values, or as the whole tree.

Arrays come back as read-only numpy arrays over the file's bytes, but for
bfloat16, which numpy lacks: those become ``torch.bfloat16`` tensors (the
bytes viewed as int16).
"""
from __future__ import annotations

import json
import struct
from typing import Any, Dict, Tuple

import numpy as np
import torch

EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3
CHUNKED = "__msgpack_chunked_array__"


class ExtType:
    """An ext value of a code flax does not define: (code, data)."""

    def __init__(self, code: int, data: bytes):
        self.code, self.data = code, data

    def __eq__(self, other) -> bool:
        return isinstance(other, ExtType) and (self.code, self.data) == (other.code, other.data)

    def __repr__(self) -> str:
        return f"ExtType({self.code}, {bytes(self.data)!r})"


class _Reader:
    """msgpack decoding of one buffer; ``raw`` leaves str values as bytes
    and bin values as views of the buffer (flax reads an ndarray's inner
    tuple so)."""

    def __init__(self, buf: memoryview, raw: bool = False):
        self.buf, self.pos, self.raw = buf, 0, raw

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError(f"truncated msgpack data: {n} bytes wanted at offset {self.pos}")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        (value,) = struct.unpack_from(fmt, self.take(struct.calcsize(fmt)))
        return value

    def bin_(self, n: int):
        data = self.take(n)
        return data if self.raw else bytes(data)

    def str_(self, n: int):
        data = self.take(n)
        return bytes(data) if self.raw else str(data, "utf-8")

    def array(self, n: int) -> list:
        return [self.read() for _ in range(n)]

    def map_(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out

    def ext(self, n: int):
        code = self.unpack(">b")
        return _ext(code, self.take(n))

    def read(self) -> Any:
        b = self.unpack(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map_(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.str_(b & 0x1F)
        if b in _FIXED:
            return _FIXED[b]
        if b in _NUMBERS:
            return self.unpack(_NUMBERS[b])
        if b in _SIZED:
            kind, fmt = _SIZED[b]
            return getattr(self, kind)(self.unpack(fmt))
        if b in _FIXEXT:
            return self.ext(_FIXEXT[b])
        raise ValueError(f"unknown msgpack type byte 0x{b:02x} at offset {self.pos - 1}")


_FIXED = {0xC0: None, 0xC2: False, 0xC3: True}
_NUMBERS = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
            0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
_SIZED = {0xC4: ("bin_", ">B"), 0xC5: ("bin_", ">H"), 0xC6: ("bin_", ">I"),
          0xC7: ("ext", ">B"), 0xC8: ("ext", ">H"), 0xC9: ("ext", ">I"),
          0xD9: ("str_", ">B"), 0xDA: ("str_", ">H"), 0xDB: ("str_", ">I"),
          0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
          0xDE: ("map_", ">H"), 0xDF: ("map_", ">I")}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}


def _whole(data: memoryview, raw: bool = False) -> Any:
    r = _Reader(data, raw)
    out = r.read()
    if r.pos != len(data):
        raise ValueError(f"{len(data) - r.pos} trailing bytes after a msgpack value")
    return out


def _ndarray(data: memoryview):
    """flax's ndarray ext payload -> numpy array (torch tensor for bf16)."""
    shape, name, buf = _whole(data, raw=True)
    name = name.decode()
    if name == "bfloat16":
        flat = torch.frombuffer(bytearray(buf), dtype=torch.int16) if len(buf) else \
            torch.zeros(0, dtype=torch.int16)
        return flat.view(torch.bfloat16).reshape(shape)
    return np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape)


def _ext(code: int, data: memoryview):
    if code == EXT_NDARRAY:
        return _ndarray(data)
    if code == EXT_COMPLEX:
        real, imag = _whole(data)
        return complex(real, imag)
    if code == EXT_NPSCALAR:
        a = _ndarray(data)
        return a if isinstance(a, torch.Tensor) else a[()]
    return ExtType(code, bytes(data))


def _unchunk(d: Dict[str, Any]):
    shape = tuple(d["shape"][str(i)] for i in range(len(d["shape"])))
    chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
    if isinstance(chunks[0], torch.Tensor):
        return torch.cat(chunks).reshape(shape)
    return np.concatenate(chunks).reshape(shape)


def _unchunk_tree(d):
    """flax's ``_unchunk_array_leaves_in_place``: a chunked array as the
    whole tree or as a dict's value, at any depth of dicts."""
    if isinstance(d, dict):
        if CHUNKED in d:
            return _unchunk(d)
        for k, v in d.items():
            if isinstance(v, dict):
                d[k] = _unchunk(v) if CHUNKED in v else _unchunk_tree(v)
    return d


def msgpack_restore(data: bytes) -> Any:
    """``flax.serialization.msgpack_restore`` of ``data``."""
    return _unchunk_tree(_whole(memoryview(data)))


def is_satpu_checkpoint(path: str) -> bool:
    """True unless the file is a zip ("PK"), as a ``torch.save`` file is;
    satpu's start with a msgpack map."""
    with open(path, "rb") as f:
        return f.read(2) != b"PK"


def load_satpu_checkpoint(path: str) -> Tuple[Dict[str, Any], Any]:
    """satpu's ``load_checkpoint``: -> (meta, state tree of arrays)."""
    with open(path, "rb") as f:
        payload = msgpack_restore(f.read())
    return json.loads(payload["meta_json"]), payload["state"]
