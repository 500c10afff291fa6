"""ASV training heads (port of ``satpu.sidekit.loss``; reference
satools/satools/sidekit/loss.py).

Each head returns (loss, logits) like the reference; the loss is NaN
without a target (x-vector extraction). The prototypical heads
(``SoftmaxAngularProto``, ``AngularProximityMagnet``, ``CircleProto``) read
the batch as pairs [spk0_a, spk0_b, spk1_a, spk1_b, ...].
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from .nn import Linear


def normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """x / max(||x||, eps) along ``dim``."""
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=dim, keepdim=True), min=eps)


def cross_entropy(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean negative log-softmax at the targets."""
    return F.cross_entropy(logits, target.long())


def _nan(x: torch.Tensor) -> torch.Tensor:
    return torch.tensor(float("nan"), device=x.device)


def _xavier(shape, generator: Optional[torch.Generator]) -> torch.Tensor:
    """Xavier-uniform (flax's ``xavier_uniform`` on a 2-D [out, in] weight)."""
    bound = math.sqrt(6.0 / sum(shape))
    return (torch.rand(shape, generator=generator) * 2 - 1) * bound


def _pairs(x: torch.Tensor):
    """(positives x[0::2], anchors x[1::2]) of a pair-ordered batch."""
    xp = x.reshape(-1, 2, x.shape[-1])
    return xp[:, 0, :], xp[:, 1:, :].mean(dim=1)


def _circle(pos: torch.Tensor, neg: torch.Tensor, s: float, m: float) -> torch.Tensor:
    """Circle loss of positive [B, P] and negative [B, N] similarities, the
    weights alpha taken without gradient (Sun et al., CVPR 2020)."""
    alpha_p = torch.clamp(-pos.detach() + 1 + m, min=0.0)
    alpha_n = torch.clamp(neg.detach() + m, min=0.0)
    return torch.mean(F.softplus(torch.logsumexp(s * (-alpha_p * (pos - (1 - m))), dim=-1)
                                 + torch.logsumexp(s * (alpha_n * (neg - m)), dim=-1)))


def _split_target(cosine: torch.Tensor, target: torch.Tensor):
    """(the target's column [B, 1], the other columns [B, N - 1])."""
    one_hot = F.one_hot(target.long(), cosine.shape[1]).bool()
    pos = cosine.gather(1, target.long()[:, None])
    return pos, cosine[~one_hot].reshape(cosine.shape[0], cosine.shape[1] - 1)


class CCELoss(nn.Module):
    """Plain cross-entropy over a linear head (loss.py:16-27)."""

    def __init__(self, emb_dim: int, spk_count: int):
        super().__init__()
        self.module = Linear(emb_dim, spk_count)

    def forward(self, x: torch.Tensor, target: Optional[torch.Tensor] = None):
        logits = self.module(x)
        if target is None:
            return _nan(x), logits
        return cross_entropy(logits, target), logits


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
        self.weight.copy_(_xavier(self.weight.shape, generator))

    def forward(self, x: torch.Tensor, target: Optional[torch.Tensor] = None,
                m: Optional[float] = None):
        m = self.m if m is None else m
        cosine = normalize(x) @ normalize(self.weight).T
        if target is None:
            return _nan(x), cosine * self.s
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
        return cross_entropy(output, target), cosine * self.s


class SoftmaxAngularProto(nn.Module):
    """Angular prototypical loss plus cross-entropy over a linear head
    (loss.py:98-143)."""

    def __init__(self, spk_count: int, emb_dim: int = 256, init_w: float = 10.0,
                 init_b: float = -5.0):
        super().__init__()
        self.init_w, self.init_b = init_w, init_b
        self.w = nn.Parameter(torch.tensor(init_w))
        self.b = nn.Parameter(torch.tensor(init_b))
        self.cce_backend_linear8 = Linear(emb_dim, spk_count)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.w.fill_(self.init_w)
        self.b.fill_(self.init_b)

    def forward(self, x: torch.Tensor, target: Optional[torch.Tensor] = None):
        cce_pred = self.cce_backend_linear8(x)
        if target is None:
            return _nan(x), cce_pred
        positive, anchor = _pairs(x)
        cos = (normalize(positive) @ normalize(anchor).T) * self.w + self.b
        labels = torch.arange(cos.shape[0], device=x.device)
        return cross_entropy(cos, labels) + cross_entropy(cce_pred, target), cce_pred


class CircleMargin(nn.Module):
    """Circle loss against ``k`` prototypes a speaker (loss.py:199-250)."""

    def __init__(self, emb_dim: int, speaker_count: int, s: float = 64.0, m: float = 0.35,
                 k: int = 1):
        super().__init__()
        self.s, self.m, self.k = s, m, k
        self.weight = nn.Parameter(_xavier((speaker_count * k, emb_dim), None))

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.weight.copy_(_xavier(self.weight.shape, generator))

    def forward(self, x: torch.Tensor, target: Optional[torch.Tensor] = None):
        cosine = normalize(x) @ normalize(self.weight).T
        cosine = cosine.reshape(cosine.shape[0], -1, self.k).amax(dim=-1)
        if target is None:
            return _nan(x), cosine * self.s
        return _circle(*_split_target(cosine, target), self.s, self.m), cosine * self.s


class AngularProximityMagnet(nn.Module):
    """Angular proximity plus magnet binary cross-entropy (loss.py:146-196)."""

    def __init__(self, spk_count: int, emb_dim: int = 256, init_w: float = 10.0,
                 init_b: float = -5.0):
        super().__init__()
        self.init_w, self.init_b = init_w, init_b
        self.w = nn.Parameter(torch.tensor(init_w))
        self.b1 = nn.Parameter(torch.tensor(init_b))
        self.b2 = nn.Parameter(torch.tensor(5.54))
        self.cce_backend_linear8 = Linear(emb_dim, spk_count)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.w.fill_(self.init_w)
        self.b1.fill_(self.init_b)
        self.b2.fill_(5.54)

    def forward(self, x: torch.Tensor, target: Optional[torch.Tensor] = None):
        cce_pred = self.cce_backend_linear8(x)
        if target is None:
            return _nan(x), cce_pred
        positive, anchor = _pairs(x)
        n = positive.shape[0]
        ap = (normalize(positive) @ normalize(anchor).T) * self.w + self.b1
        cos = positive @ anchor.T + self.b2 + math.log(1 / n / (1 - 1 / n))
        labels = torch.arange(n, device=x.device)
        mask = (labels[:, None] == labels[None, :]).to(cos.dtype)
        bce = torch.mean(torch.clamp(cos, min=0) - cos * mask
                         + torch.log1p(torch.exp(-cos.abs())))
        return cross_entropy(ap, labels) + bce, cce_pred


class CircleProto(nn.Module):
    """Circle loss against speaker prototypes plus the circle loss of the
    pairs' similarities (loss.py:250-320)."""

    def __init__(self, emb_dim: int, speaker_count: int, s: float = 64.0, m: float = 0.40):
        super().__init__()
        self.s, self.m = s, m
        self.weight = nn.Parameter(_xavier((speaker_count, emb_dim), None))

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.weight.copy_(_xavier(self.weight.shape, generator))

    def forward(self, x: torch.Tensor, target: Optional[torch.Tensor] = None):
        cosine = normalize(x) @ normalize(self.weight).T
        if target is None:
            return _nan(x), cosine * self.s
        loss = _circle(*_split_target(cosine, target), self.s, self.m)
        positive, anchor = _pairs(x)
        sim = normalize(positive) @ normalize(anchor).T
        n = sim.shape[0]
        eye = torch.eye(n, dtype=torch.bool, device=x.device)
        loss = loss + _circle(sim[eye][:, None], sim[~eye].reshape(n, n - 1), self.s, self.m)
        return loss, cosine * self.s
