"""HiFi-GAN style log-mel spectrogram (port of ``satpu.ops.mel``).

A librosa-compatible slaney mel basis (numpy, copied from satpu) over a
``torch.stft`` magnitude with the HiFi-GAN conventions: reflect pad of
(n_fft - hop) / 2 on each side with ``center=False``, a periodic Hann
window zero-padded to n_fft when win_size < n_fft, sqrt(|X|^2 + 1e-9),
and log(clip(mel, 1e-5)). The GAN's mel L1 loss and validation error.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def _hz_to_mel_slaney(f):
    f = np.asarray(f, dtype=np.float64)
    f_sp = 200.0 / 3
    mels = f / f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    safe = np.maximum(f, 1e-12)
    return np.where(f >= min_log_hz, min_log_mel + np.log(safe / min_log_hz) / logstep, mels)


def _mel_to_hz_slaney(m):
    m = np.asarray(m, dtype=np.float64)
    f_sp = 200.0 / 3
    freqs = f_sp * m
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)), freqs)


@functools.lru_cache(maxsize=None)
def librosa_mel_basis(sr: int, n_fft: int, n_mels: int, fmin: float, fmax: float) -> np.ndarray:
    """librosa.filters.mel(htk=False, norm='slaney') reimplementation;
    shape [n_mels, n_fft//2 + 1]."""
    if fmax is None or fmax <= 0:
        fmax = sr / 2.0
    fftfreqs = np.linspace(0, sr / 2.0, n_fft // 2 + 1)
    mel_pts = np.linspace(_hz_to_mel_slaney(fmin), _hz_to_mel_slaney(fmax), n_mels + 2)
    mel_f = _mel_to_hz_slaney(mel_pts)
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    enorm = 2.0 / (mel_f[2 : n_mels + 2] - mel_f[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)


def _window(n_fft: int, win_size: int, like: torch.Tensor) -> torch.Tensor:
    """Periodic Hann of win_size, zero-padded (centred) to n_fft."""
    window = torch.hann_window(win_size, periodic=True, dtype=like.dtype, device=like.device)
    if win_size < n_fft:
        lpad = (n_fft - win_size) // 2
        window = F.pad(window, (lpad, n_fft - win_size - lpad))
    return window


def stft_magnitude(y: torch.Tensor, n_fft: int, hop_size: int, win_size: int) -> torch.Tensor:
    """[B, T] -> [B, n_fft//2+1, frames] magnitude with HiFi-GAN padding."""
    pad = (n_fft - hop_size) // 2
    y = F.pad(y[:, None, :], (pad, pad), mode="reflect")[:, 0]
    # torch.stft's frames are an as_strided view, whose backward adds the
    # overlaps with atomics on the card (a varying order); unfold's does not
    spec = torch.fft.rfft(y.unfold(-1, n_fft, hop_size) * _window(n_fft, win_size, y))
    return torch.sqrt(spec.real ** 2 + spec.imag ** 2 + 1e-9).transpose(1, 2)


def mel_spectrogram(y: torch.Tensor, n_fft: int = 1024, num_mels: int = 80,
                    sampling_rate: int = 16000, hop_size: int = 256,
                    win_size: int = 1024, fmin: float = 0.0,
                    fmax: float = 8000.0) -> torch.Tensor:
    """[B, T] audio in [-1, 1] -> [B, num_mels, frames] log-mel, in f32
    (f64 for f64 audio)."""
    if y.ndim == 1:
        y = y[None, :]
    if y.dtype != torch.float64:
        y = y.to(torch.float32)
    mag = stft_magnitude(y, n_fft, hop_size, win_size)
    basis = torch.from_numpy(librosa_mel_basis(sampling_rate, n_fft, num_mels, fmin, fmax))
    mel = torch.matmul(basis.to(mag), mag)
    return torch.log(torch.clamp(mel, min=1e-5))
