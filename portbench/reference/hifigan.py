"""Frozen copy of ``satpu_torch/models/hifigan.py`` for the benchmark's plain reference.

The discriminators, losses, F0 transformations and the bf16 stage floor
(``bf16_min_channels``) are gone; imports rewritten. The convs'
operands and results, and the residual sums, pass through
``precision.operand``: the values the serving policy holds in bfloat16.

The original docstring follows.

HiFi-GAN generator, discriminators, GAN losses and F0 transforms (port
of ``satpu.models.hifigan``).

Weight norm is an explicit (weight_g, weight_v) pair of plain parameters in
torch layout (conv [out, in, k], conv-transpose [in, out, k], conv2d [out,
in, kh, kw]), so satpu variables load by name. The weight is materialized in
f32 and cast to the compute dtype afterwards. The transposed convs are plain
``F.conv_transpose1d``. Activations are NCW; the discriminators run NCHW
with time on H (``[B, C, T/p, p]``, satpu's NHWC ``[B, T/p, p, C]``).

Spectral norm (the first MSD scale) is satpu's, not
``torch.nn.utils.spectral_norm``: one power iteration from the stored
(u, v) in the discriminator step, with the gradient flowing through it, and
the stored (u, v) as constants otherwise (``SNConv``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .precision import operand

LRELU_SLOPE = 0.1


def _get_padding(kernel_size: int, dilation: int = 1) -> int:
    return (kernel_size * dilation - dilation) // 2


def _weight_norm(v: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """w = g * v / ||v||, norm over all dims but 0 (torch weight_norm dim=0)."""
    norm = torch.sqrt((v ** 2).sum(dim=tuple(range(1, v.ndim)), keepdim=True))
    return g * v / norm


def _widen(x: torch.Tensor) -> torch.Tensor:
    """A bf16 activation back in f32 (f32 and f64 stay as they are)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def _init_weight_norm(v: nn.Parameter, g: nn.Parameter,
                      generator: Optional[torch.Generator]) -> None:
    """v ~ N(0, 0.01); g the norm of a second draw, as satpu initializes."""
    v.copy_(torch.randn(v.shape, generator=generator) * 0.01)
    fresh = torch.randn(v.shape, generator=generator) * 0.01
    g.copy_(torch.sqrt((fresh ** 2).sum(dim=tuple(range(1, v.ndim)), keepdim=True)))


class WNConv1d(nn.Module):
    """Weight-normed Conv1d; weight_v [out, in, k], weight_g [out, 1, 1].
    ``dtype`` is the compute dtype (None = the parameters')."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 padding: int = 0, dilation: int = 1, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.padding, self.dilation = padding, dilation
        self.dtype = dtype
        self.weight_v = nn.Parameter(torch.empty(out_channels, in_channels, kernel_size))
        self.weight_g = nn.Parameter(torch.empty(out_channels, 1, 1))
        self.bias = nn.Parameter(torch.empty(out_channels))
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        _init_weight_norm(self.weight_v, self.weight_g, generator)
        bound = 1.0 / np.sqrt(self.weight_v.shape[1] * self.weight_v.shape[2])
        self.bias.copy_(torch.rand(self.bias.shape, generator=generator) * 2 * bound)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = _weight_norm(self.weight_v, self.weight_g)  # in f32, cast after
        dt = self.dtype or w.dtype
        return operand(F.conv1d(operand(x.to(dt)), operand(w.to(dt)), self.bias.to(dt), padding=self.padding,
                        dilation=self.dilation))


class WNConvTranspose1d(nn.Module):
    """Weight-normed ConvTranspose1d; weight_v [in, out, k], weight_g [in, 1, 1]."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, stride: int,
                 padding: int = 0, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.dtype = dtype
        self.weight_v = nn.Parameter(torch.empty(in_channels, out_channels, kernel_size))
        self.weight_g = nn.Parameter(torch.empty(in_channels, 1, 1))
        self.bias = nn.Parameter(torch.empty(out_channels))
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        _init_weight_norm(self.weight_v, self.weight_g, generator)
        self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = _weight_norm(self.weight_v, self.weight_g)
        dt = self.dtype or w.dtype
        return operand(F.conv_transpose1d(operand(x.to(dt)), operand(w.to(dt)), self.bias.to(dt), stride=self.stride,
                                  padding=self.padding))


class ResBlock1(nn.Module):
    """MRF residual block: 3 dilated + 3 plain convs."""

    def __init__(self, channels: int, kernel_size: int = 3,
                 dilation: Tuple[int, ...] = (1, 3, 5), dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.convs1 = nn.ModuleList(
            WNConv1d(channels, channels, kernel_size, dilation=d,
                     padding=_get_padding(kernel_size, d), dtype=dtype) for d in dilation)
        self.convs2 = nn.ModuleList(
            WNConv1d(channels, channels, kernel_size, dilation=1,
                     padding=_get_padding(kernel_size, 1), dtype=dtype) for _ in dilation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for c1, c2 in zip(self.convs1, self.convs2):
            xt = c2(F.leaky_relu(c1(F.leaky_relu(x, LRELU_SLOPE)), LRELU_SLOPE))
            x = operand(xt + x)
        return x


class ResBlock2(nn.Module):
    def __init__(self, channels: int, kernel_size: int = 3, dilation: Tuple[int, ...] = (1, 3),
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.convs = nn.ModuleList(
            WNConv1d(channels, channels, kernel_size, dilation=d,
                     padding=_get_padding(kernel_size, d), dtype=dtype) for d in dilation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for c in self.convs:
            x = c(F.leaky_relu(x, LRELU_SLOPE)) + x
        return x


@dataclasses.dataclass(frozen=True)
class CoreHifiGanConfig:
    input_dim: int = 256 + 1
    upsample_rates: Tuple[int, ...] = (5, 4, 4, 2, 2)
    upsample_kernel_sizes: Tuple[int, ...] = (11, 8, 8, 4, 4)
    upsample_initial_channel: int = 512
    resblock_kernel_sizes: Tuple[int, ...] = (3, 7, 11)
    resblock_dilation_sizes: Tuple[Tuple[int, ...], ...] = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
    istft_out: bool = False
    istft_n_fft: int = 16
    # "float32" | "bfloat16": conv compute dtype (parameters and the final
    # tanh stay f32)
    compute_dtype: str = "float32"


class CoreHifiGan(nn.Module):
    """HiFi-GAN generator core: [B, C_in, T] -> waveform [B, 1, T*prod(rates)]
    (or (spec, phase) [B, n, T_out] each for the iSTFT head)."""

    def __init__(self, cfg: CoreHifiGanConfig):
        super().__init__()
        self.cfg = c = cfg
        dt = torch.bfloat16 if c.compute_dtype == "bfloat16" else None
        self.num_kernels = len(c.resblock_kernel_sizes)
        self.conv_pre = WNConv1d(c.input_dim, c.upsample_initial_channel, 7, padding=3, dtype=dt)
        ups, resblocks = [], []
        for i, (u, k) in enumerate(zip(c.upsample_rates, c.upsample_kernel_sizes)):
            ch_in = c.upsample_initial_channel // (2 ** i)
            ch = c.upsample_initial_channel // (2 ** (i + 1))
            ups.append(WNConvTranspose1d(ch_in, ch, k, u, padding=(k - u) // 2, dtype=dt))
            resblocks.extend(ResBlock1(ch, rk, tuple(rd), dtype=dt)
                             for rk, rd in zip(c.resblock_kernel_sizes,
                                               c.resblock_dilation_sizes))
        self.ups = nn.ModuleList(ups)
        self.resblocks = nn.ModuleList(resblocks)
        out_ch = (c.istft_n_fft + 2) if c.istft_out else 1
        ch = c.upsample_initial_channel // (2 ** len(c.upsample_rates))
        self.conv_post = WNConv1d(ch, out_ch, 7, padding=3, dtype=dt)

    def forward(self, x: torch.Tensor):
        c = self.cfg
        x = self.conv_pre(x)
        for i, up in enumerate(self.ups):
            x = up(F.leaky_relu(x, LRELU_SLOPE))
            rbs = self.resblocks[i * self.num_kernels:(i + 1) * self.num_kernels]
            xs = torch.zeros_like(x)
            for rb in rbs:
                xs = operand(xs + rb(x))
            x = operand(xs / self.num_kernels)
        x = F.leaky_relu(x)  # default slope 0.01
        x = F.pad(x, (1, 0), mode="reflect")
        x = _widen(self.conv_post(x))
        if c.istft_out:
            n = c.istft_n_fft // 2 + 1
            return torch.exp(x[:, :n]), torch.sin(x[:, n:])
        return torch.tanh(x)

