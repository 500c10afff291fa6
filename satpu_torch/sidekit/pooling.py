"""Statistics pooling layers (port of ``satpu.sidekit.pooling``),
channels-first.

Inputs are [B, C, T] (1D trunks) or [B, C, F, T] (ResNets, flattened to
[B, C*F, T]: channel-major, then frequency, the reference's own order).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from .nn import BatchNorm, Conv1d


def _flatten_resnet(x: torch.Tensor) -> torch.Tensor:
    """[B, C, F, T] -> [B, C*F, T]; [B, C, T] unchanged."""
    if x.dim() == 4:
        B, C, F_, T = x.shape
        x = x.reshape(B, C * F_, T)
    return x


class MeanStdPooling(nn.Module):
    """Mean + (unbiased) std over time (pooling.py:11-37)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _flatten_resnet(x)
        return torch.cat([x.mean(dim=2), x.std(dim=2, correction=1)], dim=1)


class AttentiveStatsPool(nn.Module):
    """ECAPA attentive stats pooling (pooling.py:141-155). [B, C, T]."""

    def __init__(self, in_dim: int, bottleneck_dim: int):
        super().__init__()
        self.linear1 = Conv1d(in_dim, bottleneck_dim, 1)
        self.linear2 = Conv1d(bottleneck_dim, in_dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        alpha = torch.softmax(self.linear2(torch.tanh(self.linear1(x))), dim=2)
        mean = torch.sum(alpha * x, dim=2)
        residuals = torch.sum(alpha * x ** 2, dim=2) - mean ** 2
        std = torch.sqrt(torch.clamp(residuals, min=1e-9))
        return torch.cat([mean, std], dim=1)


class AttentivePooling(nn.Module):
    """Attentive mean+std pooling with optional global context
    (pooling.py:90-138): the context is the utterance's mean and unbiased
    std, appended to every frame."""

    def __init__(self, num_channels: int, num_freqs: int = 10, attention_channels: int = 128,
                 global_context: bool = False):
        super().__init__()
        self.global_context = global_context
        cf = num_channels * num_freqs
        in_dim = cf * 3 if global_context else cf
        self.attention = nn.Sequential(
            Conv1d(in_dim, attention_channels, 1), nn.ReLU(), BatchNorm(attention_channels),
            nn.Tanh(), Conv1d(attention_channels, cf, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _flatten_resnet(x)  # [B, C*F, T]
        if self.global_context:
            T = x.shape[2]
            mean = x.mean(dim=2, keepdim=True).expand(-1, -1, T)
            std = x.std(dim=2, correction=1, keepdim=True).expand(-1, -1, T)
            inp = torch.cat([x, mean, std], dim=1)
        else:
            inp = x
        w = torch.softmax(self.attention(inp), dim=2)
        mu = torch.sum(x * w, dim=2)
        rh = torch.sqrt(torch.clamp(torch.sum(x ** 2 * w, dim=2) - mu ** 2, min=1e-9))
        return torch.cat([mu, rh], dim=1)


class _GRU(nn.GRU):
    """nn.GRU with satpu's flax ``GRUCell`` semantics: the state's reset and
    update gates have no bias, so those entries of each ``bias_hh`` stay zero
    (their gradient is masked). The init (torch's: uniform in
    +-1/sqrt(hidden)) draws from an optional generator, as
    ``infer_helper.init_weights`` passes one."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        for name, p in self.named_parameters():
            if name.startswith("bias_hh"):
                p.register_hook(self._mask_gates)

    def _mask_gates(self, grad: torch.Tensor) -> torch.Tensor:
        return torch.cat([torch.zeros_like(grad[:2 * self.hidden_size]),
                          grad[2 * self.hidden_size:]])

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        bound = 1.0 / math.sqrt(self.hidden_size)
        for name, w in self.named_parameters():
            w.copy_((torch.rand(w.shape, generator=generator) * 2 - 1) * bound)
            if name.startswith("bias_hh"):
                w[:2 * self.hidden_size] = 0.0


class GruPooling(nn.Module):
    """GRU pooling (pooling.py:158-190): batch norm, leaky ReLU (0.3), a
    stack of GRUs over time, the last frame's state. [B, C, T] ->
    [B, gru_node]. satpu's flax ``GRUCell`` is torch's GRU with no hidden
    bias on the reset and update gates (``bias_hh`` = [0, 0, b_hn])."""

    def __init__(self, input_size: int, gru_node: int, nb_gru_layer: int):
        super().__init__()
        self.bn_before_gru = BatchNorm(input_size)
        self.gru = _GRU(input_size, gru_node, num_layers=nb_gru_layer, batch_first=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.leaky_relu(self.bn_before_gru(x), negative_slope=0.3)
        return self.gru(x.transpose(1, 2))[0][:, -1, :]


class ChannelWiseCorrPooling(nn.Module):
    """Channel-wise correlation pooling (pooling.py:40-88): a 1x1 projection
    C -> C' per group of ``merge_freqs_count`` frequencies, each projected
    map normalized over its locations (time x merged frequencies), and the
    lower-triangular channel correlations of each group. [B, C, F, T] ->
    [B, groups * C' * (C' - 1) / 2]. In training whole channels are dropped
    with probability ``channels_dropout`` (the survivors scaled up), from
    the caller's ``generator``."""

    def __init__(self, in_channels: int = 256, out_channels: int = 64, in_freqs: int = 10,
                 channels_dropout: float = 0.25, merge_freqs_count: int = 2):
        super().__init__()
        if in_freqs % merge_freqs_count:
            raise ValueError(f"in_freqs {in_freqs} is not a multiple of {merge_freqs_count}")
        self.groups = in_freqs // merge_freqs_count
        self.out_channels, self.merge = out_channels, merge_freqs_count
        self.channels_dropout = channels_dropout
        self.proj = nn.Parameter(torch.empty(self.groups, in_channels, out_channels))
        self.proj_bias = nn.Parameter(torch.zeros(self.groups, out_channels))
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """satpu's init: lecun-normal projection (truncated at 2 sigma, as
        flax's), zero bias."""
        std = math.sqrt(1.0 / self.proj.shape[1]) / 0.87962566103423978
        w = torch.empty(self.proj.shape)
        nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=generator)
        self.proj.copy_(w)
        self.proj_bias.zero_()

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        B, C, F_, T = x.shape
        if self.training and self.channels_dropout > 0:
            keep = torch.rand(C, generator=generator, device=x.device) >= self.channels_dropout
            x = x * keep.to(x.dtype)[None, :, None, None] / (1.0 - self.channels_dropout)
        # [B, C, F, T] -> [B, T, f, groups, C]: frequency index = group * f + j
        x = x.permute(0, 3, 2, 1).reshape(B, T, self.groups, self.merge, C).transpose(2, 3)
        y = torch.einsum("btfgc,gco->btfgo", x, self.proj) + self.proj_bias
        y = y.permute(0, 3, 4, 1, 2).reshape(B, self.groups, self.out_channels, -1)
        y = y - y.mean(dim=-1, keepdim=True)
        y = y / (y.std(dim=-1, correction=0, keepdim=True) + 1e-5)
        corr = torch.einsum("abci,abdi->abcd", y, y)  # [B, groups, C', C']
        i, j = torch.tril_indices(self.out_channels, self.out_channels, -1, device=x.device)
        return corr[:, :, i, j].reshape(B, -1) / (T * F_ / self.groups)
