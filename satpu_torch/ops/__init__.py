"""Signal-processing ops: kaldi fbank, CMVN, YAAPT F0."""
from __future__ import annotations

import functools
from typing import Callable

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def device_array(maker: Callable[..., np.ndarray], args: tuple,
                 device: torch.device) -> torch.Tensor:
    """``maker(*args)`` (a host-side numpy constant) as a tensor on ``device``,
    uploaded once: a pageable host-to-device copy per call would wait for the
    device's queue to drain."""
    return torch.from_numpy(np.ascontiguousarray(maker(*args))).to(device)
