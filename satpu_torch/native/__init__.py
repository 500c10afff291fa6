"""Native (C++) runtime components with ctypes bindings (a copy of
``satpu.native``; ``decoder.cc`` is satpu's source unchanged).

- ``decode``: beam Viterbi decoder (decoder.cc), the host-side companion to
  the loglikes the card computes. Built on demand with g++ (no pybind11
  dependency) into ``build/satpu_torch/libsatpu_decoder-<hash>.so`` at the
  repository root (the hash covers the source and the flags); callers fall
  back to the pure-python decoder when no toolchain is present.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Dict, Optional

import numpy as np

from ..utils.cuda_build import BUILD_DIR

_LIB = None
_BUILD_FAILED = False
_calls_lock = threading.Lock()
SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "decoder.cc")
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")


def _lib_path() -> str:
    with open(SRC, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(GXX_FLAGS).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"libsatpu_decoder-{digest}.so")


def build(force: bool = False) -> Optional[str]:
    """Compile decoder.cc -> build/satpu_torch/libsatpu_decoder-<hash>.so
    (cached); None when no C++ toolchain can build it."""
    global _BUILD_FAILED
    out = _lib_path()
    if os.path.exists(out) and not force:
        return out
    # compile to a per-process temp path, then atomically rename: concurrent
    # builders (pytest-xdist workers) must never CDLL a half-written .so
    tmp = f"{out}.{os.getpid()}.tmp"
    try:
        os.makedirs(BUILD_DIR, exist_ok=True)
        subprocess.run(["g++", *GXX_FLAGS, SRC, "-o", tmp], check=True, capture_output=True)
        os.replace(tmp, out)
        return out
    except (OSError, subprocess.CalledProcessError):
        _BUILD_FAILED = True
        return None
    finally:
        if os.path.exists(tmp):
            try:
                os.remove(tmp)
            except OSError:
                pass


def _load():
    global _LIB
    if _LIB is not None or _BUILD_FAILED:
        return _LIB
    path = build()
    if path is None:
        return None
    lib = ctypes.CDLL(path)
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    lib.satpu_decode.restype = ctypes.c_int
    lib.satpu_decode.argtypes = [
        ctypes.c_int32, i32p, i32p, i32p, i32p, f32p, f32p, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, f32p, ctypes.c_float, ctypes.c_float,
        ctypes.c_int32, i32p, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32), i32p, ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_float),
    ]
    lib.satpu_decode_lattice.restype = ctypes.c_int
    lib.satpu_decode_lattice.argtypes = [
        ctypes.c_int32, i32p, i32p, i32p, i32p, f32p, f32p, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, f32p, ctypes.c_float, ctypes.c_float,
        ctypes.c_float, ctypes.c_int32,
        i32p, i32p, i32p, i32p, f32p, f32p, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32),
        i32p, f32p, ctypes.c_int32, ctypes.POINTER(ctypes.c_int32),
    ]
    _LIB = lib
    return _LIB


def available() -> bool:
    return _load() is not None


class NativeGraph:
    """CSR arc arrays of an Fst prepared for the native decoder."""

    def __init__(self, fst):
        n = fst.num_states
        counts = np.zeros(n + 1, np.int32)
        srcs, dsts, ils, ols, ws = [], [], [], [], []
        for s, arcs in enumerate(fst.arcs):
            counts[s + 1] = len(arcs)
            for a in arcs:
                dsts.append(a.nextstate)
                ils.append(a.ilabel)
                ols.append(a.olabel)
                ws.append(a.weight)
        self.row_start = np.cumsum(counts).astype(np.int32)
        self.dst = np.asarray(dsts, np.int32)
        self.ilabel = np.asarray(ils, np.int32)
        self.olabel = np.asarray(ols, np.int32)
        self.weight = np.asarray(ws, np.float32)
        self.final = np.asarray(
            [w if w != float("inf") else np.inf for w in fst.finals], np.float32)
        self.num_states = n
        self.start = fst.start


def decode(graph: NativeGraph, loglikes: np.ndarray, acoustic_scale: float = 1.0,
            beam: float = 16.0, max_active: int = 7000):
    """Native best-path decode; returns (words, alignment, cost) or None if
    the native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    ll = np.ascontiguousarray(loglikes, np.float32)
    T, P = ll.shape
    max_out = T + 8
    out_words = np.zeros(max_out, np.int32)
    out_align = np.zeros(max(T, 1), np.int32)
    nwords = ctypes.c_int32(0)
    nalign = ctypes.c_int32(0)
    cost = ctypes.c_float(0.0)
    rc = lib.satpu_decode(
        graph.num_states, graph.row_start, graph.dst, graph.ilabel, graph.olabel,
        graph.weight, graph.final, graph.start, T, P, ll,
        ctypes.c_float(acoustic_scale), ctypes.c_float(beam), max_active,
        out_words, max_out, ctypes.byref(nwords), out_align, ctypes.byref(nalign),
        ctypes.byref(cost))
    if rc != 0:
        return [], [], float("inf")
    return (out_words[: nwords.value].tolist(), out_align[: nalign.value].tolist(),
            float(cost.value))


def decode_lattice(graph: NativeGraph, loglikes: np.ndarray,
                   acoustic_scale: float = 1.0, beam: float = 16.0,
                   lattice_beam: float = 8.0, max_active: int = 7000):
    """Native lattice decode -> satpu_torch.chain.lattice.Lattice (or None when the
    native library is unavailable). Mirrors the reference's
    MappedLatticeFasterRecognizer lattice output (csrc/decoder.cc:96-153)."""
    lib = _load()
    if lib is None:
        return None
    from ..chain.lattice import Lattice

    with _calls_lock:
        decode_lattice.calls += 1

    ll = np.ascontiguousarray(loglikes, np.float32)
    T, P = ll.shape
    arc_cap, node_cap = 1 << 18, 1 << 16
    for _ in range(4):
        arc_from = np.zeros(arc_cap, np.int32)
        arc_to = np.zeros(arc_cap, np.int32)
        arc_word = np.zeros(arc_cap, np.int32)
        arc_pdf = np.zeros(arc_cap, np.int32)
        arc_graph = np.zeros(arc_cap, np.float32)
        arc_acoustic = np.zeros(arc_cap, np.float32)
        node_time = np.zeros(node_cap, np.int32)
        node_final = np.zeros(node_cap, np.float32)
        narcs = ctypes.c_int32(0)
        nnodes = ctypes.c_int32(0)
        rc = lib.satpu_decode_lattice(
            graph.num_states, graph.row_start, graph.dst, graph.ilabel,
            graph.olabel, graph.weight, graph.final, graph.start, T, P, ll,
            ctypes.c_float(acoustic_scale), ctypes.c_float(beam),
            ctypes.c_float(lattice_beam), max_active,
            arc_from, arc_to, arc_word, arc_pdf, arc_graph, arc_acoustic,
            arc_cap, ctypes.byref(narcs),
            node_time, node_final, node_cap, ctypes.byref(nnodes))
        if rc == 2:
            arc_cap *= 4
            node_cap *= 4
            continue
        if rc == 1:
            return Lattice.empty()
        na, nn = narcs.value, nnodes.value
        return Lattice(
            arc_from=arc_from[:na].copy(), arc_to=arc_to[:na].copy(),
            arc_word=arc_word[:na].copy(), arc_pdf=arc_pdf[:na].copy(),
            arc_graph=arc_graph[:na].copy(), arc_acoustic=arc_acoustic[:na].copy(),
            node_time=node_time[:nn].copy(), node_final=node_final[:nn].copy())
    raise MemoryError("lattice capacity still exceeded after growth")


# native lattice decodes made in this process (callers may reset it to 0)
decode_lattice.calls = 0
