"""Signal-processing ops: kaldi fbank, CMVN, YAAPT F0."""
from __future__ import annotations

import functools
from typing import Callable

import numpy as np
import torch


def device_array(maker: Callable[..., np.ndarray], args: tuple,
                 device: torch.device) -> torch.Tensor:
    """``maker(*args)`` (a host-side numpy constant) as a tensor on ``device``,
    uploaded once: a pageable host-to-device copy per call would wait for the
    device's queue to drain. While ``torch.export`` (or the compiler) traces,
    the constant is made anew and not cached: a tensor made under tracing
    is the tracer's, and later eager calls must not read it."""
    if torch.compiler.is_compiling():
        return _upload(maker, args, device)
    return _cached_upload(maker, args, device)


def _upload(maker, args, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(maker(*args))).to(device)


_cached_upload = functools.lru_cache(maxsize=None)(_upload)


_CMVN_EXPORTS = ("global_cmvn", "utt_cmvn", "utt_cmvn_keep_zeros")


def __getattr__(name: str):
    """``global_cmvn``, ``utt_cmvn`` and ``utt_cmvn_keep_zeros`` of
    ``ops.cmvn``, imported at first use: a process that loads only
    ``ops.yaapt`` (to run an exported program) imports nothing more."""
    if name in _CMVN_EXPORTS:
        from . import cmvn

        return getattr(cmvn, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
