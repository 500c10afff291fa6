"""Helpers the copied modules take from the port's package roots."""
from __future__ import annotations

import functools
from typing import Callable

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def device_array(maker: Callable[..., np.ndarray], args: tuple,
                 device: torch.device) -> torch.Tensor:
    """``maker(*args)`` (a host-side numpy constant) as a tensor on ``device``,
    uploaded once."""
    return torch.from_numpy(np.ascontiguousarray(maker(*args))).to(device)


def resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available")
    return dev
