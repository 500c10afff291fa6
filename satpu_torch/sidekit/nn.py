"""ASV building blocks (port of ``satpu.sidekit.nn``), channels-first.

1D blocks take [B, C, T]; 2D blocks take NCHW with H the mel axis and W
time. Parameter names follow the reference's torch modules
(``nn.Sequential`` / ``ModuleList`` children ``fc.0``, ``shortcut.1``,
``convs.3``, ``block.2``), so satpu's flax scopes ``<name>_<i>`` map onto
them one to one (``models.convert.from_satpu_xvector``).

Batch norm follows the module's mode: batch statistics in training (and
an update of the running ones), the running statistics in eval.

``autocast(torch.bfloat16)`` is satpu's mixed-precision policy
(``models.torchlayers``, where ``Conv1d``, ``Conv2d``, ``Linear`` and
``autocast`` live): inside it every conv and linear casts its input,
weight and bias to bf16, and batch norm computes and returns f32.
Everything else (pooling arithmetic, the ArcMargin product, losses) keeps
its input's dtype.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..models.torchlayers import Conv1d, Conv2d, Linear, autocast  # noqa: F401
from ..parallel import mesh


class BatchNorm(nn.Module):
    """Affine batch norm over dim 1 of [B, C, ...] in its parameters' dtype
    (f32 unless the module was cast), whatever the input's
    (``satpu.models.torchlayers.BatchNorm``). In training it
    normalizes with the biased variance over every other dim and moves the
    running statistics (buffers ``running_mean`` / ``running_var``) by 0.1
    towards the batch mean and the unbiased variance; in eval it reads
    them."""

    momentum = 0.1

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.weight.fill_(1.0)
        self.bias.zero_()
        self.running_mean.zero_()
        self.running_var.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.weight.dtype)
        if self.training and mesh.active():
            return self._global_batch_norm(x)
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                            training=self.training, momentum=self.momentum, eps=self.eps)

    def _global_batch_norm(self, x: torch.Tensor) -> torch.Tensor:
        """Training under a process group (``parallel.mesh``): the moments
        of the global batch in two passes, as ``jnp.var`` takes them (the
        mean from the sums of x and the count over the ranks, then the
        biased variance from the sums of the centred squares; both sums
        differentiable). One pass of E[x^2] - E[x]^2 cancels catastrophically
        when |mean| >> std; the first pass sums in f64, so that the mean's
        error is its own rounding (at |mean|/std = 1e4 an f32 sum's error
        put the output 4x further from f64 than ``F.batch_norm``'s). The
        running variance moves towards the unbiased variance of the global
        count."""
        C = x.shape[1]
        dims = [0] + list(range(2, x.ndim))
        shape = (1, C) + (1,) * (x.ndim - 2)
        s = mesh.global_sum(torch.cat([x.sum(dim=dims, dtype=torch.float64),
                                       x.new_full((1,), x.numel() // C, dtype=torch.float64)]))
        mean, n = (s[:C] / s[-1]).to(x.dtype), s[-1].to(x.dtype)
        xc = x - mean.reshape(shape)
        var = mesh.global_sum((xc * xc).sum(dim=dims)) / n
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1 - m).add_(m * mean)
            self.running_var.mul_(1 - m).add_(m * var * n / (n - 1))
        return (xc * torch.rsqrt(var + self.eps).reshape(shape) * self.weight.reshape(shape)
                + self.bias.reshape(shape))


class SELayer(nn.Module):
    """Squeeze-excitation over NCHW (sidekit/nn.py:12-32)."""

    def __init__(self, channel: int, reduction: int = 16):
        super().__init__()
        self.fc = nn.Sequential(Linear(channel, channel // reduction, bias=False), nn.ReLU(),
                                Linear(channel // reduction, channel, bias=False), nn.Sigmoid())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.fc(x.mean(dim=(2, 3)))[:, :, None, None]


class ResNetBasicBlock(nn.Module):
    """SE-ResNet basic block (sidekit/nn.py:35-68). NCHW."""

    def __init__(self, in_planes: int, planes: int,
                 stride: Union[int, Tuple[int, int]] = (1, 1)):
        super().__init__()
        st = tuple(stride) if isinstance(stride, (tuple, list)) else (stride, stride)
        self.conv1 = Conv2d(in_planes, planes, 3, st, 1, bias=False)
        self.bn1 = BatchNorm(planes)
        self.conv2 = Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm(planes)
        self.se = SELayer(planes)
        self.shortcut = nn.Sequential()
        if st != (1, 1) or in_planes != planes:
            self.shortcut = nn.Sequential(Conv2d(in_planes, planes, 1, st, 0, bias=False),
                                          BatchNorm(planes))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.relu(self.bn1(self.conv1(x)))
        out = self.se(self.bn2(self.conv2(out)))
        return torch.relu(out + self.shortcut(x))


class Conv1dReluBn(nn.Module):
    """conv -> relu -> BN (sidekit/nn.py:114-123). [B, C, T]."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 1,
                 stride: int = 1, padding: int = 0, dilation: int = 1):
        super().__init__()
        self.conv = Conv1d(in_channels, out_channels, kernel_size, stride, padding, dilation,
                           bias=False)
        self.bn = BatchNorm(out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bn(torch.relu(self.conv(x)))


class Res2Conv1dReluBn(nn.Module):
    """Res2Net-style grouped temporal convs (sidekit/nn.py:75-110). [B, C, T].

    Split i >= 1 adds its input slice to split i-1's *output* before its
    conv; the last slice passes through untouched."""

    def __init__(self, channels: int, kernel_size: int = 1, stride: int = 1,
                 padding: int = 0, dilation: int = 1, scale: int = 4):
        super().__init__()
        self.scale = scale
        self.width = channels // scale
        self.nums = scale if scale == 1 else scale - 1
        self.convs = nn.ModuleList(
            Conv1d(self.width, self.width, kernel_size, stride, padding, dilation, bias=False)
            for _ in range(self.nums))
        self.bns = nn.ModuleList(BatchNorm(self.width) for _ in range(self.nums))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        spx = torch.split(x, self.width, dim=1)
        out = []
        sp = spx[0]
        for i, (conv, bn) in enumerate(zip(self.convs, self.bns)):
            if i >= 1:
                sp = sp + spx[i]
            sp = bn(torch.relu(conv(sp)))
            out.append(sp)
        if self.scale != 1:
            out.append(spx[self.nums])
        return torch.cat(out, dim=1)


class SEConnect(nn.Module):
    """1D squeeze-excitation (sidekit/nn.py:127-141). [B, C, T]."""

    def __init__(self, channels: int, s: int = 2):
        super().__init__()
        self.linear1 = Linear(channels, channels // s)
        self.linear2 = Linear(channels // s, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.relu(self.linear1(x.mean(dim=2)))
        return x * torch.sigmoid(self.linear2(out))[:, :, None]


class SERes2Block(nn.Module):
    """SE-Res2Block (sidekit/nn.py:145-154); residual added by the caller."""

    def __init__(self, channels: int, kernel_size: int, stride: int, padding: int,
                 dilation: int, scale: int):
        super().__init__()
        self.block = nn.Sequential(
            Conv1dReluBn(channels, channels, 1, 1, 0),
            Res2Conv1dReluBn(channels, kernel_size, stride, padding, dilation, scale),
            Conv1dReluBn(channels, channels, 1, 1, 0),
            SEConnect(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.block(x)
