"""Frozen copy of ``satpu_torch/ops/fbank.py`` for the benchmark's plain reference.

Imports rewritten.

The original docstring follows.

Batched kaldi log-mel filterbank, as the BN front end uses it (port of
``satpu.ops.fbank``).

Kaldi's compute-fbank-feats with its defaults (25 ms povey window every
10 ms, DC removal, pre-emphasis 0.97, 512-point power spectrum, log floor
1e-6) and no dither: framing with kaldi edge handling, ``torch.fft.rfft``
power spectrum and the kaldi mel banks (built host-side in numpy, VTLN
included). Input is scaled like kaldi wavs ([-32768, 32768]); model code
multiplies [-1, 1] audio by 32768.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .common import device_array

LOG_EPS = 1e-6  # log floor of the reference fbank
PREEMPHASIS = 0.97


def _next_power_of_2(x: int) -> int:
    return 1 if x == 0 else 2 ** (int(x - 1).bit_length())


def num_frames(num_samples: int, window_shift: int = 160, window_size: int = 400,
               snip_edges: bool = False) -> int:
    """Kaldi's frame count of ``num_samples`` samples (kaldifeature.py:58-77)."""
    if snip_edges:
        return 0 if num_samples < window_size else 1 + (num_samples - window_size) // window_shift
    return (num_samples + window_shift // 2) // window_shift


def _povey_window(window_size: int) -> np.ndarray:
    n = np.arange(window_size, dtype=np.float64)
    return ((0.5 - 0.5 * np.cos(2 * np.pi * n / (window_size - 1))) ** 0.85).astype(np.float32)


def _mel_scale(freq):
    return 1127.0 * np.log(1.0 + freq / 700.0)


def _inverse_mel_scale(mel):
    return 700.0 * (np.exp(mel / 1127.0) - 1.0)


def _vtln_warp_freq(vtln_low: float, vtln_high: float, low_freq: float, high_freq: float,
                    warp: float, freq: np.ndarray) -> np.ndarray:
    l = vtln_low * max(1.0, warp)
    h = vtln_high * min(1.0, warp)
    scale = 1.0 / warp
    Fl, Fh = scale * l, scale * h
    scale_left = (Fl - low_freq) / (l - low_freq)
    scale_right = (high_freq - Fh) / (high_freq - h)
    res = np.where(freq >= h, high_freq + scale_right * (freq - high_freq), freq)
    res = np.where(freq < h, scale * freq, res)
    res = np.where(freq < l, low_freq + scale_left * (freq - low_freq), res)
    res = np.where((freq < low_freq) | (freq > high_freq), freq, res)
    return res


@functools.lru_cache(maxsize=None)
def mel_banks(num_bins: int, window_length_padded: int, sample_freq: float,
              low_freq: float = 20.0, high_freq: float = 0.0,
              vtln_low: float = 100.0, vtln_high: float = -500.0,
              vtln_warp: float = 1.0) -> np.ndarray:
    """Kaldi triangular mel bank [num_bins, n_fft//2 + 1] (last column zero)."""
    nyquist = 0.5 * sample_freq
    if high_freq <= 0.0:
        high_freq += nyquist
    if vtln_high < 0.0:
        vtln_high += nyquist
    num_fft_bins = window_length_padded // 2
    fft_bin_width = sample_freq / window_length_padded
    mel_low = _mel_scale(low_freq)
    mel_high = _mel_scale(high_freq)
    mel_delta = (mel_high - mel_low) / (num_bins + 1)

    b = np.arange(num_bins, dtype=np.float64)[:, None]
    left_mel = mel_low + b * mel_delta
    center_mel = mel_low + (b + 1.0) * mel_delta
    right_mel = mel_low + (b + 2.0) * mel_delta
    if vtln_warp != 1.0:
        def warp_mel(mel):
            return _mel_scale(
                _vtln_warp_freq(vtln_low, vtln_high, low_freq, high_freq, vtln_warp,
                                _inverse_mel_scale(mel)))
        left_mel, center_mel, right_mel = warp_mel(left_mel), warp_mel(center_mel), warp_mel(right_mel)

    mel = _mel_scale(fft_bin_width * np.arange(num_fft_bins, dtype=np.float64))[None, :]
    up_slope = (mel - left_mel) / (center_mel - left_mel)
    down_slope = (right_mel - mel) / (right_mel - center_mel)
    if vtln_warp == 1.0:
        bank = np.maximum(0.0, np.minimum(up_slope, down_slope))
    else:
        bank = np.zeros_like(up_slope)
        up_idx = (mel > left_mel) & (mel <= center_mel)
        down_idx = (mel > center_mel) & (mel < right_mel)
        bank[up_idx] = up_slope[up_idx]
        bank[down_idx] = down_slope[down_idx]
    bank = np.concatenate([bank, np.zeros((num_bins, 1))], axis=1)
    return bank.astype(np.float32)


def frame_signal(x: torch.Tensor, window_size: int, window_shift: int,
                 snip_edges: bool) -> torch.Tensor:
    """[B, T] -> [B, m, window_size] frames, kaldi edge handling.

    With snip_edges=False the signal is padded left with its first
    ``window_size//2 - window_shift//2`` samples reversed and right with the
    whole reversed signal."""
    T = x.shape[-1]
    if snip_edges:
        m = 1 + (T - window_size) // window_shift
        padded = x
    else:
        m = (T + window_shift // 2) // window_shift
        pad = window_size // 2 - window_shift // 2
        padded = torch.cat([x[:, :pad].flip(-1), x, x.flip(-1)], dim=1)
    return padded.unfold(-1, window_size, window_shift)[:, :m]


def fbank(waveform: torch.Tensor, num_mel_bins: int = 23, snip_edges: bool = True,
          sample_frequency: float = 16000.0) -> torch.Tensor:
    """[B, T] (or [T]) -> [B, m, num_mel_bins] log-mel energies, on the
    device of ``waveform``."""
    if waveform.ndim == 1:
        waveform = waveform[None, :]
    window_shift = int(sample_frequency * 0.010)
    window_size = int(sample_frequency * 0.025)
    n_fft = _next_power_of_2(window_size)

    frames = frame_signal(waveform.to(torch.float32), window_size, window_shift, snip_edges)
    frames = frames - frames.mean(dim=-1, keepdim=True)
    # kaldi pre-emphasizes the first sample against itself
    prev = torch.cat([frames[..., :1], frames[..., :-1]], dim=-1)
    frames = (frames - PREEMPHASIS * prev) * device_array(_povey_window, (window_size,),
                                                          frames.device)
    spec = torch.fft.rfft(frames, n=n_fft)
    power = spec.real ** 2 + spec.imag ** 2
    bank = device_array(mel_banks, (num_mel_bins, n_fft, sample_frequency), power.device)
    return torch.log(torch.clamp(torch.matmul(power, bank.T), min=LOG_EPS))
