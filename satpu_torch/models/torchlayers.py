"""satpu's per-layer bf16 training policy, the counterpart of
``satpu.models.torchlayers`` ``autocast`` / ``_autocast_pair``, and the
conv, linear and layer-norm layers that follow it.

Inside ``autocast(torch.bfloat16)`` every ``Conv1d``, ``Conv2d`` and
``Linear`` of this module casts its input, weight and bias to bf16, so it
returns bf16; the parameters stay f32 master copies (the cast is inside
the graph, so their gradients come back f32). ``LayerNorm`` and every
batch norm (``sidekit.nn.BatchNorm``, the TDNN-F's ``BatchNormStats``)
compute and return f32, and the attention softmax of ``models.wav2vec2``
runs in f32 and is cast back to its logits' dtype. Everything else keeps
its input's dtype, with torch's type promotion (bf16 + f32 is f32, as in
JAX). This is a cast per layer, not ``torch.autocast``: the two differ in
what they return (``torch.autocast`` leaves a linear's bias add in bf16
and keeps layer norm's output in its input's dtype only sometimes), and
satpu's outputs are the reference.

The layers' init is satpu's: weight and bias uniform in +-sqrt(3 / fan_in),
from an optional generator (``infer_helper.init_weights``).
"""
from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

_AUTOCAST: contextvars.ContextVar = contextvars.ContextVar("satpu_torch_autocast",
                                                           default=None)


@contextlib.contextmanager
def autocast(dtype: Optional[torch.dtype]):
    """Run the policy's conv and linear layers in ``dtype`` (None: as is)."""
    token = _AUTOCAST.set(dtype)
    try:
        yield
    finally:
        _AUTOCAST.reset(token)


class _SatpuInit:
    """satpu's init for a torch conv or linear layer and the ``autocast``
    policy's casts."""

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        bound = math.sqrt(3.0 / self.weight[0].numel())
        for t in (self.weight, self.bias):
            if t is not None:
                t.copy_((torch.rand(t.shape, generator=generator) * 2 - 1) * bound)

    def _cast(self, x: torch.Tensor):
        """(x, weight, bias) in the policy's compute dtype."""
        dt = _AUTOCAST.get()
        if dt is None or not x.is_floating_point():
            return x, self.weight, self.bias
        return (x.to(dt), self.weight.to(dt),
                None if self.bias is None else self.bias.to(dt))


class Conv1d(_SatpuInit, nn.Conv1d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, w, b = self._cast(x)
        if x.dtype == torch.bfloat16 and self.groups > 1 and x.device.type == "cpu":
            # PyTorch's CPU bf16 grouped conv1d returns wrong values at small
            # widths (tests/test_torch_wav2vec2.py pins it): the same
            # arithmetic in f32 on the bf16 values, rounded to bf16
            return self._conv_forward(x.float(), w.float(),
                                      None if b is None else b.float()).to(torch.bfloat16)
        return self._conv_forward(x, w, b)


class Conv2d(_SatpuInit, nn.Conv2d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(*self._cast(x))


class Linear(_SatpuInit, nn.Linear):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(*self._cast(x))


class LayerNorm(nn.Module):
    """Layer norm over the last dim with the biased variance, computed in
    f32 whatever the input's dtype (the result is f32, or the parameters'
    dtype where that is wider)."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.weight.fill_(1.0)
        self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(torch.promote_types(x.dtype, torch.float32))
        mean = x.mean(dim=-1, keepdim=True)
        var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
        return (x - mean) / torch.sqrt(var + self.eps) * self.weight + self.bias
