"""Kaldi ark/scp binary IO in pure numpy (no kaldiio dependency).

A copy of ``satpu.utils.scp_io`` (numpy only).

Replaces the reference's utils/scp_io.py (which wraps kaldiio) and the C++
matrix readers/writers in csrc/matrix.cc. Supports:

- binary float/double matrices ('FM', 'DM') and vectors ('FV', 'DV'),
- appendable ark files with scp index lines ``utt path:offset``,
- 'NPY' records (npz-compressed arbitrary arrays inside an ark), mirroring
  the reference's extension for caching non-matrix features
  (utils/scp_io.py:320-411).
"""
from __future__ import annotations

import io
import os
import struct
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

_BIN_HDR = b"\0B"


def _write_token(f, token: str) -> None:
    f.write(token.encode() + b" ")


def _read_token(f) -> str:
    tok = b""
    while True:
        c = f.read(1)
        if not c or c == b" ":
            break
        tok += c
    return tok.decode()


def _write_int32(f, v: int) -> None:
    f.write(b"\x04" + struct.pack("<i", v))


def _read_int32(f) -> int:
    size = f.read(1)
    assert size == b"\x04", f"unexpected int size byte {size!r}"
    return struct.unpack("<i", f.read(4))[0]


def write_mat(f, mat: np.ndarray, key: Optional[str] = None) -> int:
    """Write one kaldi binary matrix/vector record; returns the data offset
    (the position of the binary header, for the scp index)."""
    if key is not None:
        f.write(key.encode() + b" ")
    offset = f.tell()
    f.write(_BIN_HDR)
    mat = np.asarray(mat)
    if mat.dtype == np.float64:
        dtype_tok = "DM" if mat.ndim == 2 else "DV"
        out_dtype = "<f8"
    else:
        dtype_tok = "FM" if mat.ndim == 2 else "FV"
        out_dtype = "<f4"
        mat = mat.astype(np.float32, copy=False)
    _write_token(f, dtype_tok)
    if mat.ndim == 2:
        _write_int32(f, mat.shape[0])
        _write_int32(f, mat.shape[1])
    else:
        _write_int32(f, mat.shape[0])
    f.write(np.ascontiguousarray(mat).astype(out_dtype, copy=False).tobytes())
    return offset


def write_npy(f, arr: np.ndarray, key: Optional[str] = None) -> int:
    """Write an arbitrary ndarray as an 'NPY' ark record."""
    if key is not None:
        f.write(key.encode() + b" ")
    offset = f.tell()
    f.write(_BIN_HDR)
    _write_token(f, "NPY")
    buf = io.BytesIO()
    np.save(buf, np.asarray(arr), allow_pickle=False)
    payload = buf.getvalue()
    _write_int32(f, len(payload))
    f.write(payload)
    return offset


def read_mat_from(f) -> np.ndarray:
    """Read one record at the current position (positioned at the binary header)."""
    hdr = f.read(2)
    assert hdr == _BIN_HDR, f"expected binary kaldi header, got {hdr!r}"
    tok = _read_token(f)
    if tok == "NPY":
        n = _read_int32(f)
        return np.load(io.BytesIO(f.read(n)), allow_pickle=False)
    if tok in ("FM", "DM"):
        rows = _read_int32(f)
        cols = _read_int32(f)
        dt = "<f4" if tok == "FM" else "<f8"
        data = np.frombuffer(f.read(rows * cols * int(dt[-1])), dtype=dt)
        return data.reshape(rows, cols).copy()
    if tok in ("FV", "DV"):
        n = _read_int32(f)
        dt = "<f4" if tok == "FV" else "<f8"
        return np.frombuffer(f.read(n * int(dt[-1])), dtype=dt).copy()
    if tok == "CM":
        return _read_compressed_matrix(f)
    raise ValueError(f"unsupported kaldi record type {tok!r}")


def _read_compressed_matrix(f) -> np.ndarray:
    """Kaldi CompressedMatrix (format 1) -> float32 matrix."""
    min_value, rang = struct.unpack("<ff", f.read(8))
    rows, cols = struct.unpack("<ii", f.read(8))
    pc = np.frombuffer(f.read(8 * cols), dtype="<u2").reshape(cols, 4).astype(np.float32)
    pc = min_value + pc * (rang / 65535.0)
    data = np.frombuffer(f.read(rows * cols), dtype=np.uint8).reshape(cols, rows).astype(np.float32)
    p0, p25, p75, p100 = pc[:, 0:1], pc[:, 1:2], pc[:, 2:3], pc[:, 3:4]
    out = np.where(
        data <= 64,
        p0 + (p25 - p0) * (data / 64.0),
        np.where(
            data <= 192,
            p25 + (p75 - p25) * ((data - 64.0) / 128.0),
            p75 + (p100 - p75) * ((data - 192.0) / 63.0),
        ),
    )
    return out.T.copy()


def read_mat(rxspecifier: str) -> np.ndarray:
    """Read a matrix given ``path:offset`` (scp value) or a plain ark path."""
    if ":" in rxspecifier and rxspecifier.rsplit(":", 1)[1].isdigit():
        path, off = rxspecifier.rsplit(":", 1)
        with open(path, "rb") as f:
            f.seek(int(off))
            return read_mat_from(f)
    with open(rxspecifier, "rb") as f:
        # skip key
        while f.read(1) not in (b" ", b""):
            pass
        return read_mat_from(f)


def read_ark(ark_path: str) -> Iterator[Tuple[str, np.ndarray]]:
    """Iterate (key, array) over an ark file."""
    with open(ark_path, "rb") as f:
        while True:
            key = b""
            c = f.read(1)
            if not c:
                return
            while c != b" ":
                key += c
                c = f.read(1)
                if not c:
                    return
            yield key.decode(), read_mat_from(f)


class FileWriter:
    """Appendable ark+scp writer: ``FileWriter("file.ark", "file.scp")``.

    Mirrors the reference Writer (utils/scp_io.py) including append mode for
    worker-sharded feature caches.
    """

    def __init__(self, ark_path: str, scp_path: Optional[str] = None, append: bool = False):
        mode = "ab" if append else "wb"
        os.makedirs(os.path.dirname(os.path.abspath(ark_path)), exist_ok=True)
        self.ark_path = os.path.abspath(ark_path)
        self.f = open(self.ark_path, mode)
        self.scp_path = scp_path
        self.scp_f = open(scp_path, "a" if append else "w") if scp_path else None

    def __setitem__(self, key: str, value: np.ndarray) -> None:
        self.write(key, value)

    def write(self, key: str, value: np.ndarray) -> None:
        value = np.asarray(value)
        if value.ndim in (1, 2) and value.dtype in (np.float32, np.float64):
            offset = write_mat(self.f, value, key=key)
        else:
            offset = write_npy(self.f, value, key=key)
        if self.scp_f:
            self.scp_f.write(f"{key} {self.ark_path}:{offset}\n")

    def flush(self) -> None:
        self.f.flush()
        if self.scp_f:
            self.scp_f.flush()

    def close(self) -> None:
        self.f.close()
        if self.scp_f:
            self.scp_f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class FileReader:
    """Lazy scp-indexed reader: ``reader[utt]`` -> ndarray."""

    def __init__(self, scp_path: str):
        self.index: Dict[str, str] = {}
        with open(scp_path) as f:
            for line in f:
                parts = line.strip().split(None, 1)
                if len(parts) == 2:
                    self.index[parts[0]] = parts[1]

    def __contains__(self, key: str) -> bool:
        return key in self.index

    def __getitem__(self, key: str) -> np.ndarray:
        return read_mat(self.index[key])

    def keys(self):
        return self.index.keys()

    def __len__(self) -> int:
        return len(self.index)


def merge_scps(scp_paths, out_path: str) -> None:
    """Concatenate per-worker scp shards (reference merge_cache)."""
    with open(out_path, "w") as out:
        for p in scp_paths:
            if os.path.exists(p):
                with open(p) as f:
                    out.write(f.read())
