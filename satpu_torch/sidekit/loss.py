"""ASV heads (port of ``satpu.sidekit.loss``): ``ArcMarginProduct`` only.

It returns (loss, logits) like the reference; the loss is NaN without a
target (x-vector extraction). The other training heads come with ASV
training (ROADMAP item 14).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F


def normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """x / max(||x||, eps) along ``dim``."""
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=dim, keepdim=True), min=eps)


class ArcMarginProduct(nn.Module):
    """Additive angular margin softmax (loss.py:30-95); ``m`` may be given at
    call time (fine-tuning raises the margin)."""

    def __init__(self, in_features: int, out_features: int, s: float = 30.0,
                 m: float = 0.50, easy_margin: bool = False):
        super().__init__()
        self.out_features = out_features
        self.s, self.m, self.easy_margin = s, m, easy_margin
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Xavier-uniform, as satpu initializes it."""
        bound = math.sqrt(6.0 / sum(self.weight.shape))
        self.weight.copy_((torch.rand(self.weight.shape, generator=generator) * 2 - 1) * bound)

    def forward(self, x: torch.Tensor, target: Optional[torch.Tensor] = None,
                m: Optional[float] = None):
        m = self.m if m is None else m
        cosine = normalize(x) @ normalize(self.weight).T
        if target is None:
            return torch.tensor(float("nan"), device=x.device), cosine * self.s
        cos_m, sin_m = math.cos(m), math.sin(m)
        th = math.cos(math.pi - m)
        mm = math.sin(math.pi - m) * m
        sine = torch.sqrt(torch.clamp(1.0 - cosine ** 2, 0.0, 1.0))
        phi = cosine * cos_m - sine * sin_m
        if self.easy_margin:
            phi = torch.where(cosine > 0, phi, cosine)
        else:
            phi = torch.where(cosine - th > 0, phi, cosine - mm)
        one_hot = F.one_hot(target.long(), self.out_features).to(cosine.dtype)
        output = (one_hot * phi + (1.0 - one_hot) * cosine) * self.s
        return F.cross_entropy(output, target.long()), cosine * self.s
