"""Frozen copy of ``satpu_torch/ops/cmvn.py`` for the benchmark's plain reference.

Only the utterance CMVN functions are kept.

The original docstring follows.

Cepstral mean/variance normalization (port of ``satpu.ops.cmvn``).

- ``utt_cmvn``: per-utterance mean(/var) normalization over time, with an
  optional ``lengths`` mask so a padded batch gives the same valid frames as
  unpadded utterances.
- ``utt_cmvn_keep_zeros``: the F0 variant; exact zeros (unvoiced frames) are
  excluded from the statistics and stay zero.
- ``global_cmvn``: apply a kaldi (2, dim+1) global statistics matrix.
- ``AdaptivePCMN``: adaptive parametric cepstral mean normalization
  (Kalinli et al., ICASSP 2019), the paper's behaviour as satpu's.
- ``SpeakerCMVN``: per-speaker F0 statistics over a training set (numpy),
  the ``f0_norm = speaker`` flow of ``train_vc`` and of serving.
- ``CMVN``: kaldi per-speaker statistics applied to numpy arrays or to
  tensors on any device, with ``utt2spk`` routing, the averaged
  ``generic-spk`` fallback and ``reverse``; ``from_ark`` reads them.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


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


