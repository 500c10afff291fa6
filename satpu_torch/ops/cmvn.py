"""Cepstral mean/variance normalization (port of ``satpu.ops.cmvn``).

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
import torch.nn as nn
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


def global_cmvn(x: torch.Tensor, stats, var_norm: bool = False) -> torch.Tensor:
    """Apply kaldi global CMVN stats (2 x (dim+1): sums with the frame count
    last, sums of squares) to ``x`` [..., dim], in ``x``'s dtype."""
    stats = torch.as_tensor(stats, dtype=x.dtype, device=x.device)
    count = stats[0, -1]
    mean = stats[0, :-1] / count
    out = x - mean
    if var_norm:
        var = stats[1, :-1] / count - mean ** 2
        out = out / torch.sqrt(torch.clamp(var, min=1e-10))
    return out


class AdaptivePCMN(nn.Module):
    """Adaptive parametric cepstral mean normalization: per-dimension context
    convolutions over [left_context, right_context] (replicate-padded in
    time) predict beta, alpha and mu_n, and the output is
    ``(beta + 1) x - alpha mu_n``. The three are one depthwise ``conv1d``
    with three outputs a dimension. Parameters as satpu's: ``beta_w``,
    ``alpha_w``, ``mu_n_0_w`` [D, ctx] and a ``bias`` [D] shared by the
    three (``models.convert.from_satpu_pcmn`` carries satpu's across).
    satpu's, and this, is the paper's behaviour: the reference's forward
    returns its input."""

    def __init__(self, input_dim: int, left_context: int = -10, right_context: int = 10):
        super().__init__()
        if not (left_context < 0 < right_context):
            raise ValueError(f"context [{left_context}, {right_context}] must straddle 0")
        self.input_dim, self.left, self.right = input_dim, left_context, right_context
        self.tot_context = right_context - left_context + 1
        shape = (input_dim, self.tot_context)
        self.beta_w = nn.Parameter(torch.empty(shape))
        self.alpha_w = nn.Parameter(torch.empty(shape))
        self.mu_n_0_w = nn.Parameter(torch.empty(shape))
        self.bias = nn.Parameter(torch.empty(input_dim))
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Weights ~ N(0, 0.01^2), bias 0, as satpu's ``init``."""
        for w in (self.beta_w, self.alpha_w, self.mu_n_0_w):
            w.copy_(torch.randn(w.shape, generator=generator) * 0.01)
        self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: [B, T, D] -> [B, T, D]; T at least the context."""
        B, T, D = x.shape
        if D != self.input_dim or T < self.tot_context:
            raise ValueError(f"input [{B}, {T}, {D}]: needs D = {self.input_dim} and T >= "
                             f"{self.tot_context}")
        xt = x.transpose(1, 2)
        xp = F.pad(xt, (-self.left, self.right), mode="replicate")
        w = torch.stack([self.beta_w, self.alpha_w, self.mu_n_0_w], dim=1)  # [D, 3, ctx]
        y = F.conv1d(xp, w.reshape(3 * D, 1, self.tot_context).to(x.dtype),
                     self.bias.repeat_interleave(3).to(x.dtype), groups=D)
        beta, alpha, mu_n0 = y.reshape(B, D, 3, T).unbind(2)
        return ((beta + 1.0) * xt - alpha * mu_n0).transpose(1, 2)


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


class CMVN:
    """Kaldi-statistics CMVN. ``stats`` maps a key to a kaldi (2, dim+1)
    matrix (row 0 the feature sums with the frame count last, row 1 the
    sums of squares); keys are speakers (``utt2spk`` routes utterances to
    them) or, for a bare matrix, ``None``. The ``generic-spk`` entry, the
    average of every key's bias and scale, serves an utterance whose
    speaker has none. ``__call__`` takes a numpy array or a tensor on any
    device, and ``reverse`` undoes the normalization."""

    def __init__(self, stats, norm_means: bool = True, norm_vars: bool = False,
                 utt2spk: Optional[dict] = None, reverse: bool = False,
                 std_floor: float = 1e-20):
        if not isinstance(stats, dict):
            stats = {None: np.asarray(stats)}
        self.norm_means, self.norm_vars, self.reverse = norm_means, norm_vars, reverse
        self.utt2spk = utt2spk
        self.bias: dict = {}
        self.scale: dict = {}
        for spk, st in stats.items():
            st = np.asarray(st)
            if st.shape[0] != 2:
                raise ValueError(f"stats of {spk!r}: shape {st.shape}, not (2, dim+1)")
            count = float(np.ravel(st[0, -1])[0])
            mean = st[0, :-1] / count
            var = st[1, :-1] / count - mean * mean
            std = np.maximum(np.sqrt(np.maximum(var, 0.0)), std_floor)
            self.bias[spk] = (-mean).astype(np.float32)
            self.scale[spk] = (1.0 / std).astype(np.float32)
        biases, scales = list(self.bias.values()), list(self.scale.values())
        self.bias["generic-spk"] = sum(biases[1:], biases[0]) / len(stats)
        self.scale["generic-spk"] = sum(scales[1:], scales[0]) / len(stats)

    def __call__(self, x, uttid=None):
        if self.utt2spk is not None and uttid != "generic-spk":
            spk = self.utt2spk[uttid]
        else:
            spk = uttid if uttid in self.bias else None
            if spk not in self.bias:
                spk = "generic-spk"
        b, s = self.bias[spk], self.scale[spk]
        if isinstance(x, torch.Tensor):
            b, s = torch.from_numpy(b).to(x.device), torch.from_numpy(s).to(x.device)
        if not self.reverse:
            if self.norm_means:
                x = x + b
            if self.norm_vars:
                x = x * s
        else:
            if self.norm_vars:
                x = x / s
            if self.norm_means:
                x = x - b
        return x

    @classmethod
    def from_ark(cls, path: str, **kw) -> "CMVN":
        """Per-speaker stats from a kaldi ark (or scp) of (2, dim+1) matrices."""
        from ..utils import scp_io

        if path.endswith(".scp"):
            r = scp_io.FileReader(path)
            stats = {k: r[k] for k in r.keys()}
        else:
            stats = dict(scp_io.read_ark(path))
        return cls(stats, **kw)
