"""Cepstral mean/variance normalization (port of ``satpu.ops.cmvn``).

- ``utt_cmvn``: per-utterance mean(/var) normalization over time, with an
  optional ``lengths`` mask so a padded batch gives the same valid frames as
  unpadded utterances.
- ``utt_cmvn_keep_zeros``: the F0 variant; exact zeros (unvoiced frames) are
  excluded from the statistics and stay zero.
- ``SpeakerCMVN``: per-speaker F0 statistics over a training set (numpy),
  the ``f0_norm = speaker`` flow of ``train_vc`` and of serving.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def _time_mask(x: torch.Tensor, lengths: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    if lengths is None:
        return None
    t = torch.arange(x.shape[1], device=x.device)
    mask = t[None, :] < lengths.to(x.device)[:, None]
    while mask.ndim < x.ndim:
        mask = mask[..., None]
    return mask.to(x.dtype)


def utt_cmvn(x: torch.Tensor, var_norm: bool = False,
             lengths: Optional[torch.Tensor] = None, eps: float = 1e-6) -> torch.Tensor:
    """Per-utterance CMVN over the time axis.

    x: [B, T, C] (or [B, T], or [T]); lengths: optional [B] valid frame
    counts. The variance is unbiased, like torch.var.
    """
    squeeze = x.ndim == 1
    if squeeze:
        x = x[None, :]
    mask = _time_mask(x, lengths)
    if mask is None:
        mean = x.mean(dim=1, keepdim=True)
        if var_norm:
            var = x.var(dim=1, keepdim=True, unbiased=True)
    else:
        denom = torch.clamp(mask.sum(dim=1, keepdim=True), min=1.0)
        mean = (x * mask).sum(dim=1, keepdim=True) / denom
        if var_norm:
            var = (((x - mean) * mask) ** 2).sum(dim=1, keepdim=True) / torch.clamp(
                denom - 1.0, min=1.0)
    out = x - mean
    if var_norm:
        out = out / torch.sqrt(var + eps)
    if mask is not None:
        out = out * mask
    return out[0] if squeeze else out


def utt_cmvn_keep_zeros(x: torch.Tensor, var_norm: bool = True,
                        eps: float = 1e-6) -> torch.Tensor:
    """Masked CMVN: statistics over the nonzero entries of each utterance;
    zeros pass through as zeros. x: [B, T] (or [T])."""
    squeeze = x.ndim == 1
    if squeeze:
        x = x[None, :]
    voiced = (x != 0).to(x.dtype)
    dims = tuple(range(1, x.ndim))
    n = torch.clamp(voiced.sum(dim=dims, keepdim=True), min=1.0)
    mean = (x * voiced).sum(dim=dims, keepdim=True) / n
    out = (x - mean) * voiced
    if var_norm:
        var = ((out * voiced) ** 2).sum(dim=dims, keepdim=True) / torch.clamp(n - 1.0, min=1.0)
        out = out / torch.sqrt(var + eps)
    out = out * voiced
    return out[0] if squeeze else out


class SpeakerCMVN:
    """Per-speaker global mean/variance normalization over nonzero values
    (numpy, on the host). The statistics are a plain dict that rides a
    checkpoint's metadata (``to_meta`` / ``from_meta``); with
    ``pass_through`` an unseen speaker's features come back unchanged."""

    def __init__(self, keep_zeros: bool = True,
                 pass_through_if_not_computed: bool = False):
        self.keep_zeros = keep_zeros
        self.pass_through = pass_through_if_not_computed
        self.stats: dict = {}

    def accumulate(self, features, speaker_id: str) -> None:
        f = np.asarray(features)
        vals = f[f != 0] if self.keep_zeros else f.reshape(-1)
        st = self.stats.setdefault(speaker_id, {"sum": 0.0, "sum_sq": 0.0, "n": 0})
        st["sum"] += float(vals.sum())
        st["sum_sq"] += float((vals ** 2).sum())
        st["n"] += int(vals.size)

    def mean_std(self, speaker_id: str):
        st = self.stats[speaker_id]
        if st["n"] == 0:
            raise ValueError(f"no data accumulated for speaker {speaker_id}")
        mean = st["sum"] / st["n"]
        var = st["sum_sq"] / st["n"] - mean ** 2
        return mean, float(np.sqrt(var + 1e-6))

    def __call__(self, features, speaker_id: str):
        if speaker_id not in self.stats:
            if self.pass_through:
                return features
            raise KeyError(f"stats for speaker {speaker_id} not computed")
        mean, std = self.mean_std(speaker_id)
        f = np.asarray(features, dtype=np.float32).copy()
        if self.keep_zeros:
            nz = f != 0
            f[nz] = (f[nz] - mean) / std
            return f
        return (f - mean) / std

    def to_meta(self) -> dict:
        return {"keep_zeros": self.keep_zeros, "stats": self.stats}

    @classmethod
    def from_meta(cls, meta: dict) -> "SpeakerCMVN":
        out = cls(keep_zeros=meta.get("keep_zeros", True))
        out.stats = dict(meta.get("stats", {}))
        return out
