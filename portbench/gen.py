"""The one traffic generator: it reads a mix's parameters (a
``traffic/<mix>.json``) and makes the cell's inputs from ``--seed``.

Lengths are the same set for every seed: the quantiles of a log-normal
with the mix's spread, cut to the corpus's published shortest and longest
utterance and scaled to its published mean, so a seed changes what is said
(pitch, glide, noise, targets, transcripts, order) and never how much work
there is.
"""
from __future__ import annotations

import math
from statistics import NormalDist
from typing import Dict, List

import numpy as np

SR = 16000


def corpus_lengths(spec: Dict, count: int) -> np.ndarray:
    """``count`` lengths in samples, ascending: the quantiles (i + 1/2) /
    count of a log-normal of log-spread ``spec["sigma"]`` within
    [``min_s``, ``max_s``], its median set so that the mean is ``mean_s``."""
    lo, hi, mean, sigma = spec["min_s"], spec["max_s"], spec["mean_s"], spec["sigma"]
    z = np.array([NormalDist().inv_cdf((i + 0.5) / count) for i in range(count)])

    def mean_at(mu: float) -> float:
        return float(np.clip(np.exp(mu + sigma * z), lo, hi).mean())

    a, b = math.log(lo), math.log(hi)
    for _ in range(100):  # bisection on the median's log
        mid = (a + b) / 2
        a, b = (mid, b) if mean_at(mid) < mean else (a, mid)
    seconds = np.clip(np.exp((a + b) / 2 + sigma * z), lo, hi)
    return np.round(seconds * SR).astype(np.int64)


def snap_lengths(lengths: np.ndarray, allowed: List[int]) -> np.ndarray:
    """Each length moved to the nearest allowed one, as the recipe's speed
    perturbation moves every utterance onto its ladder of lengths."""
    ladder = np.asarray(allowed)
    return ladder[np.abs(lengths[:, None] - ladder[None, :]).argmin(1)]


def whole_batches(lengths: np.ndarray, batch: int) -> np.ndarray:
    """The same number of lengths, with each distinct length's count a
    multiple of ``batch`` (largest remainders first), so that every batch
    of exact-length buckets is full."""
    values, counts = np.unique(lengths, return_counts=True)
    total = len(lengths) // batch
    share = counts / counts.sum() * total
    whole = np.floor(share).astype(int)
    for i in np.argsort(-(share - whole), kind="stable")[:total - whole.sum()]:
        whole[i] += 1
    return np.repeat(values, whole * batch)


def voiced(torch, lengths, pad_to: int, f0_hz, phase, gen, device):
    """Voiced utterances [len(lengths), pad_to] on ``device``, zero past each
    length: four harmonics whose F0 glides +-5% at 0.5 Hz around each
    utterance's ``f0_hz``, faded in and out over 20 ms, with 0.25 s of a
    -54 dB noise floor at each end (the repository's synthetic speech)."""
    n = len(lengths)
    t = torch.arange(pad_to, device=device, dtype=torch.float64) / SR
    f0 = torch.as_tensor(f0_hz, device=device, dtype=torch.float64)[:, None]
    ph0 = torch.as_tensor(phase, device=device, dtype=torch.float64)[:, None]
    track = f0 * (1 + 0.05 * torch.sin(2 * math.pi * 0.5 * t[None, :] + ph0))
    theta = 2 * math.pi * torch.cumsum(track, dim=1) / SR
    s = sum(a * torch.sin(h * theta) for h, a in ((1, 1.0), (2, 0.55), (3, 0.35), (4, 0.18)))
    dur = torch.as_tensor(np.asarray(lengths), device=device, dtype=torch.float64)[:, None] / SR
    ramp = torch.clamp(torch.minimum(t - 0.25, dur - 0.25 - t) / 0.02, 0, 1)
    noise = torch.randn((n, pad_to), generator=gen, device=device, dtype=torch.float32)
    x = (0.3 * s * ramp).float() + noise * 0.002
    return torch.where(t[None, :] < dur, x, torch.zeros_like(x))


def speakers(rng: np.random.Generator, spec: Dict, count: int):
    """Per-utterance (F0 Hz, glide phase) drawn from the mix's F0 range."""
    lo, hi = spec["f0_hz"]
    return rng.uniform(lo, hi, count), rng.uniform(0, 2 * math.pi, count)


def bucket_for(length: int, buckets: List[int]) -> int:
    """The padded length of a batch whose longest utterance has ``length``
    samples: the first bucket that holds it, else a multiple of the last
    (the serving CLI's ladder)."""
    for b in buckets:
        if length <= b:
            return b
    top = buckets[-1]
    return -(-length // top) * top


def random_phone_walk(trans: np.ndarray, length: int, rng: np.random.Generator) -> List[int]:
    """``length`` phones drawn from the bigram ``trans`` (row 0 = start), by
    inverting each row's cumulative sum: the reference's ``rng.choice``
    walk, one array search a phone."""
    seq, prev = [], 0
    cum = np.cumsum(trans, axis=1)
    for u in rng.random(length):
        prev = min(int(np.searchsorted(cum[prev], u * cum[prev, -1], side="right")),
                   trans.shape[0] - 1)
        seq.append(prev)
    return seq
