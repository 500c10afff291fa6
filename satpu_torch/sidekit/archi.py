"""ASV backbone architectures (port of ``satpu.sidekit.archi``).

Inputs are mel features [B, n_mels, T]; the ResNets view them as one-channel
NCHW images [B, 1, n_mels, T] (the reference's own layout) and return
[B, C, F', T'].
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from .nn import BatchNorm, Conv1d, Conv1dReluBn, Conv2d, ResNetBasicBlock, SERes2Block


def _stage(in_planes: int, planes: int, num_blocks: int, stride) -> nn.Sequential:
    blocks = [ResNetBasicBlock(in_planes, planes, stride)]
    blocks += [ResNetBasicBlock(planes, planes, (1, 1)) for _ in range(num_blocks - 1)]
    return nn.Sequential(*blocks)


class _ResNetTrunk(nn.Module):
    """conv1 -> bn1 -> relu -> stages ``layer1..layerN``."""

    def __init__(self, conv1: Conv2d, planes: Sequence[int], strides, num_blocks: Sequence[int]):
        super().__init__()
        self.conv1 = conv1
        self.bn1 = BatchNorm(conv1.out_channels)
        inp = conv1.out_channels
        for i, (p, st, n) in enumerate(zip(planes, strides, num_blocks)):
            self.add_module(f"layer{i + 1}", _stage(inp, p, n, st))
            inp = p
        self.num_stages = len(planes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.bn1(self.conv1(x.unsqueeze(1))))
        for i in range(self.num_stages):
            x = getattr(self, f"layer{i + 1}")(x)
        return x


class PreResNet34(_ResNetTrunk):
    """archi.py:34-78. [B, F, T] -> [B, 256, F', T']."""

    def __init__(self, num_blocks: Sequence[int] = (3, 1, 3, 1, 5, 1, 2)):
        nblocks = list(num_blocks)[:6] + [num_blocks[5]]
        super().__init__(Conv2d(1, 128, 3, 1, 1, bias=False),
                         [128, 128, 128, 256, 256, 256, 256],
                         [(1, 1), (2, 2), (1, 1), (2, 2), (1, 1), (2, 2), (1, 1)], nblocks)


class PreHalfResNet34(_ResNetTrunk):
    """archi.py:81-119. [B, F, T] -> [B, 256, F/8, T/8]."""

    def __init__(self, num_blocks: Sequence[int] = (3, 4, 6, 3)):
        super().__init__(Conv2d(1, 32, 3, 1, 1, bias=False), [32, 64, 128, 256],
                         [(1, 1), (2, 2), (2, 2), (2, 2)], num_blocks)


class PreFastResNet34(_ResNetTrunk):
    """archi.py:122-159. [B, F, T] -> [B, 128, F', T']."""

    def __init__(self, num_blocks: Sequence[int] = (3, 4, 6, 3)):
        super().__init__(Conv2d(1, 16, 7, (1, 2), 3, bias=False), [16, 32, 64, 128],
                         [(1, 1), (2, 2), (2, 2), (1, 1)], num_blocks)


class PreEcapaTDNN(nn.Module):
    """ECAPA-TDNN trunk (archi.py:163-189). [B, F, T] -> [B, 3*C, T]."""

    def __init__(self, in_feature: int = 80, channels: int = 512):
        super().__init__()
        c = channels
        self.layer1 = Conv1dReluBn(in_feature, c, 5, padding=2)
        self.layer2 = SERes2Block(c, 3, 1, 2, 2, 8)
        self.layer3 = SERes2Block(c, 3, 1, 3, 3, 8)
        self.layer4 = SERes2Block(c, 3, 1, 4, 4, 8)
        self.conv = Conv1d(c * 3, c * 3, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out1 = self.layer1(x)
        out2 = self.layer2(out1) + out1
        out3 = self.layer3(out1 + out2) + out1 + out2
        out4 = self.layer4(out1 + out2 + out3) + out1 + out2 + out3
        return torch.relu(self.conv(torch.cat([out2, out3, out4], dim=1)))
