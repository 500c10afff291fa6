"""Statistics pooling layers (port of ``satpu.sidekit.pooling``),
channels-first.

Inputs are [B, C, T] (1D trunks) or [B, C, F, T] (ResNets, flattened to
[B, C*F, T]: channel-major, then frequency, the reference's own order).
"""
from __future__ import annotations

import torch
import torch.nn as nn

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
