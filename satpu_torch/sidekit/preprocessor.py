"""ASV acoustic frontends (port of ``satpu.sidekit.preprocessor``).

``mel_spec_frontend``: pre-emphasis (reflect-padded) -> torchaudio-style
MelSpectrogram (center=True reflect, periodic Hann window, power 2, HTK mel
scale without norm, 90-7600 Hz) -> log(+1e-6) -> InstanceNorm CMVN.
``mfcc_frontend``: the same spectrum -> natural-log mels -> orthonormal
DCT-II -> InstanceNorm. The power spectrum is ``torch.stft``'s; satpu's
banded-DFT matmuls are a TPU workaround with the same output.

Functions on tensors; output layout [B, n, frames] (channels-first).
``draw_spec_masks`` / ``apply_spec_masks`` are the train-time time and
frequency masking (satpu's ``spec_masking``, split into its draws and its
application).
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from ..ops import device_array


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
    fb = device_array(torchaudio_mel_fbanks, (n_fft // 2 + 1, f_min, f_max, n_mels,
                                              sample_rate), y.device).to(y.dtype)
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
    dct = device_array(_dct2_matrix, (n_mfcc, n_mels), logmel.device).to(logmel.dtype)
    return instance_norm(torch.einsum("bmt,cm->bct", logmel, dct))


def draw_spec_masks(B: int, T: int, F: int, generator: Optional[torch.Generator] = None,
                    time_mask_param: int = 5, freq_mask_param: int = 10
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-utterance (f_len, f_start, t_len, t_start), each [B] int64 on the
    generator's device, as satpu's ``spec_masking`` draws them
    (preprocessor.py:216-218,232-235): f_len in [0, freq_mask_param], f_start
    in [0, max(F - f_len, 1)), t_len in [0, time_mask_param], t_start in
    [0, max(T - t_len, 1))."""
    device = generator.device if generator is not None else None

    def below(high: torch.Tensor) -> torch.Tensor:
        u = torch.rand(B, generator=generator, device=device, dtype=torch.float64)
        return (u * high).long()

    f_len = torch.randint(0, freq_mask_param + 1, (B,), generator=generator, device=device)
    f_start = below(torch.clamp(F - f_len, min=1))
    t_len = torch.randint(0, time_mask_param + 1, (B,), generator=generator, device=device)
    t_start = below(torch.clamp(T - t_len, min=1))
    return f_len, f_start, t_len, t_start


def apply_spec_masks(x: torch.Tensor, masks) -> torch.Tensor:
    """Zero each utterance's frequency band [f_start, f_start + f_len) and
    time band [t_start, t_start + t_len) of [B, F, T] features."""
    f_len, f_start, t_len, t_start = (m.to(x.device)[:, None] for m in masks)
    f = torch.arange(x.shape[1], device=x.device)[None, :]
    t = torch.arange(x.shape[2], device=x.device)[None, :]
    f_mask = (f >= f_start) & (f < f_start + f_len)  # [B, F]
    t_mask = (t >= t_start) & (t < t_start + t_len)  # [B, T]
    return x.masked_fill(f_mask[:, :, None] | t_mask[:, None, :], 0.0)
