"""Build the CUDA sources under ``satpu_torch/csrc`` with nvcc and load them.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on first
use into ``build/satpu_torch/lib<name>-<hash>.so`` at the repository root
(the hash covers the source and the flags, so an edited source rebuilds),
then loaded with ``ctypes``. Nothing is compiled when a module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Tuple

CSRC_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(CSRC_DIR)), "build", "satpu_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels of satpu_torch need the "
                       "CUDA toolkit (set CUDA_HOME or put nvcc on PATH)")


def build(name: str, force: bool = False) -> Tuple[str, str]:
    """Compile ``csrc/<name>.cu``; returns (library path, compiler output —
    empty when an up-to-date library was already there)."""
    src = os.path.join(CSRC_DIR, name + ".cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")
    if os.path.exists(out) and not force:
        return out, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    # compile to a per-process name, then rename: concurrent builders never
    # load a half-written library
    tmp = f"{out}.{os.getpid()}.tmp"
    try:
        proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", tmp, src],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out, proc.stdout + proc.stderr


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(build(name)[0])
        return _libs[name]
