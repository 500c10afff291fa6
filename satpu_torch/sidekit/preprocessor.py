"""ASV acoustic frontends (port of ``satpu.sidekit.preprocessor``).

``mel_spec_frontend``: pre-emphasis (reflect-padded) -> torchaudio-style
MelSpectrogram (center=True reflect, periodic Hann window, power 2, HTK mel
scale without norm, 90-7600 Hz) -> log(+1e-6) -> InstanceNorm CMVN.
``mfcc_frontend``: the same spectrum -> natural-log mels -> orthonormal
DCT-II -> InstanceNorm. The power spectrum is ``torch.stft``'s; satpu's
banded-DFT matmuls are a TPU workaround with the same output.

Functions on tensors; output layout [B, n, frames] (channels-first). The
train-time SpecAugment masking comes with ASV training (ROADMAP item 14).
"""
from __future__ import annotations

import functools

import numpy as np
import torch


def _hz_to_mel_htk(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, dtype=np.float64) / 700.0)


def _mel_to_hz_htk(m):
    return 700.0 * (10.0 ** (np.asarray(m, dtype=np.float64) / 2595.0) - 1.0)


@functools.lru_cache(maxsize=None)
def torchaudio_mel_fbanks(n_freqs: int, f_min: float, f_max: float, n_mels: int,
                          sample_rate: int) -> np.ndarray:
    """torchaudio.functional.melscale_fbanks(norm=None, mel_scale='htk');
    shape [n_freqs, n_mels]."""
    all_freqs = np.linspace(0, sample_rate // 2, n_freqs)
    m_pts = np.linspace(_hz_to_mel_htk(f_min), _hz_to_mel_htk(f_max), n_mels + 2)
    f_pts = _mel_to_hz_htk(m_pts)
    f_diff = np.diff(f_pts)
    slopes = f_pts[None, :] - all_freqs[:, None]  # [freq, n_mels+2]
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    fb = np.maximum(0.0, np.minimum(down, up))
    return fb.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _dct2_matrix(n_mfcc: int, n_mels: int) -> np.ndarray:
    """Orthonormal DCT-II basis (torchaudio.functional.create_dct 'ortho'),
    [n_mfcc, n_mels]."""
    n = np.arange(n_mels)
    k = np.arange(n_mfcc)[:, None]
    dct = np.cos(np.pi / n_mels * (n + 0.5) * k)
    dct[0] *= 1.0 / np.sqrt(2.0)
    dct *= np.sqrt(2.0 / n_mels)
    return dct.astype(np.float32)


def pre_emphasis(x: torch.Tensor, coef: float = 0.97) -> torch.Tensor:
    """y[t] = x[t] - coef * x[t-1]; the sample before x[0] is x[1] (reflect
    pad 1 at the left)."""
    prev = torch.cat([x[:, 1:2], x[:, :-1]], dim=1)
    return x - coef * prev


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """torch InstanceNorm1d (affine=False) on [B, C, T]: per (B, C) over T,
    biased variance."""
    mean = x.mean(dim=2, keepdim=True)
    var = x.var(dim=2, correction=0, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps)


def _log_mel(x: torch.Tensor, n_fft: int, hop_length: int, win_length: int, n_mels: int,
             sample_rate: int, f_min: float, f_max: float, pre_emph: float) -> torch.Tensor:
    """[B, T] audio -> log mel power [B, n_mels, frames]."""
    if x.dim() == 1:
        x = x[None, :]
    y = pre_emphasis(x, pre_emph)
    window = torch.hann_window(win_length, periodic=True, dtype=y.dtype, device=y.device)
    spec = torch.stft(y, n_fft, hop_length=hop_length, win_length=win_length, window=window,
                      center=True, pad_mode="reflect", return_complex=True)
    mag2 = spec.real ** 2 + spec.imag ** 2  # [B, n_fft // 2 + 1, frames]
    fb = torch.from_numpy(torchaudio_mel_fbanks(n_fft // 2 + 1, f_min, f_max, n_mels,
                                                sample_rate)).to(y.device)
    mel = torch.einsum("bft,fm->bmt", mag2, fb)
    return torch.log(mel + 1e-6)


def mel_spec_frontend(x: torch.Tensor, n_fft: int = 1024, hop_length: int = 160,
                      win_length: int = 400, n_mels: int = 80, sample_rate: int = 16000,
                      f_min: float = 90.0, f_max: float = 7600.0,
                      pre_emph: float = 0.97) -> torch.Tensor:
    """[B, T] audio -> [B, n_mels, frames] log-mel, InstanceNorm-CMVN'd."""
    return instance_norm(_log_mel(x, n_fft, hop_length, win_length, n_mels, sample_rate,
                                  f_min, f_max, pre_emph))


def mfcc_frontend(x: torch.Tensor, n_fft: int = 2048, hop_length: int = 512,
                  win_length: int = 1024, n_mels: int = 100, n_mfcc: int = 80,
                  sample_rate: int = 16000, f_min: float = 133.333,
                  f_max: float = 6855.4976, pre_emph: float = 0.97) -> torch.Tensor:
    """MfccFrontEnd (reference sidekit/preprocessor.py:13-78): [B, T] ->
    [B, n_mfcc, frames]."""
    logmel = _log_mel(x, n_fft, hop_length, win_length, n_mels, sample_rate, f_min, f_max,
                      pre_emph)
    dct = torch.from_numpy(_dct2_matrix(n_mfcc, n_mels)).to(logmel.device)
    return instance_norm(torch.einsum("bmt,cm->bct", logmel, dct))
