"""The boundary between the port and its CUDA kernels: build, load, place
and launch.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on first
use into ``build/satpu_torch/lib<name>-<hash>.so`` at the repository root
(the hash covers the source and the flags, so an edited source rebuilds),
then loaded with ``ctypes``, its entry points typed from ``SIGNATURES``.
Nothing is compiled when a module is imported.

A kernel's entry point (``ops/yaapt.py``: K1, K4; ``chain/den_fb.py``: K2f,
K2b; ``chain/num_fb.py``: K3f, K3b) first takes its tensors' device from
``device_of``, runs its plain version on the CPU, and on CUDA passes its
arguments to ``launch``, which runs the C entry point on that device's
current stream and counts the launch.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Tuple

import torch

from .trace import count

CSRC_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(CSRC_DIR)), "build", "satpu_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
SMEM_LIMIT = 232448  # bytes of shared memory a Hopper block may opt in to

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# each library's C entry points, {symbol: (restype, argtypes)}; a launching
# one takes the stream last and returns a CUDA error code, 0 on success
SIGNATURES = {
    "shc": {
        "satpu_shc_band": (_I, [_P, _P] + [_I] * 6 + [_P]),
        "satpu_shc_fixed": (_I, [_I, _I]),
        "satpu_shc_layout": (_I, [_I] * 3 + [ctypes.POINTER(_I)]),
    },
    "viterbi": {
        "satpu_viterbi_path": (_I, [_P] + [_L] * 3 + [_P] + [_L] * 4 + [_P] * 2 + [_I] * 3
                               + [_P]),
        "satpu_viterbi_scratch_bytes": (_L, [_I, _I]),
    },
    "den_fb": {
        "satpu_den_max_states": (_I, []),
        "satpu_den_smem_bytes": (_L, [_I] * 4),
        "satpu_den_fwd": (_I, [_P] * 7 + [_F, _P] + [_I] * 5 + [_P]),
        "satpu_den_bwd": (_I, [_P] * 12 + [_F, _P, _P] + [_I] * 5 + [_P]),
    },
    "num_fb": {
        "satpu_num_smem_bytes": (_L, [_I] * 3),
        "satpu_num_fwd": (_I, [_P] * 11 + [_I] * 5 + [_P]),
        "satpu_num_bwd": (_I, [_P] * 15 + [_I] * 5 + [_P]),
    },
}

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
    """The loaded library of ``csrc/<name>.cu``, built on first use, its
    entry points typed from ``SIGNATURES[name]``."""
    lib = _libs.get(name)
    if lib is None:
        with _lock:
            if name not in _libs:
                lib = ctypes.CDLL(build(name)[0])
                for symbol, (restype, argtypes) in SIGNATURES[name].items():
                    fn = getattr(lib, symbol)
                    fn.restype, fn.argtypes = restype, argtypes
                _libs[name] = lib
            lib = _libs[name]
    return lib


def device_of(name: str, *tensors: torch.Tensor) -> torch.device:
    """The common device of a kernel entry point's ``tensors``; ValueError
    when they are on different devices, or on one that is neither cpu nor
    cuda."""
    dev = tensors[0].device
    for x in tensors[1:]:
        if x.device != dev:
            raise ValueError(f"{name}'s inputs are on {dev} and {x.device}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cpu or cuda, not {dev}")
    return dev


def launch(fn, *args, device: torch.device, counter: str) -> None:
    """Call the C entry point ``fn`` with ``args`` and the current stream of
    ``device``, with ``device`` current (the entry point launches on the
    current device, whichever card the caller has current); RuntimeError
    naming ``fn`` on a CUDA error, else one more in the counter
    ``counter``."""
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: CUDA error {err}")
    count(counter)
