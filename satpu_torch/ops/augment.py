"""Data augmentation (port of ``satpu.ops.augment``; reference
satools/satools/augmentation.py).

Waveform augmentations run on the host in the data pipeline, in numpy:
``data_augmentation`` applies ``aug_number`` transforms picked from the
pipeline (none | add_reverb | add_noise | phone_filtering | codec |
speed_perturb) with MUSAN-style SNR ranges and noise / RIR databases, drawing
from the caller's ``random.Random`` in satpu's order, so that the same seed
gives the same audio. ``load_augmentation`` parses a CLI's ``augmentation``
option. The phone filter is a 4th-order Butterworth low-pass (scipy) and a
mu-law round trip; the codecs are mu-law / a-law quantization round trips.

``spec_augment`` (Snowdar style) masks a [B, F, T] feature batch on its
device, from an explicit ``torch.Generator``.
"""
from __future__ import annotations

import json
import os
import random
import re
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils import kaldi_data

AUGMENTATIONS = ("none", "add_reverb", "add_noise", "phone_filtering", "codec", "speed_perturb")


def fuse_speech_noise(speech: np.ndarray, noise: np.ndarray, snr_db: float,
                      np_rng=None) -> np.ndarray:
    """(scale * speech + noise) / 2 at ``snr_db`` (augmentation.py:20-30); a
    silent ``speech`` first gets 1e-2 white noise from ``np_rng`` (numpy's
    global generator when None)."""
    speech_power = np.linalg.norm(speech)
    if speech_power == 0:
        randn = (np_rng or np.random).randn
        speech = speech + 1e-2 * randn(*speech.shape).astype(speech.dtype)
        speech_power = np.linalg.norm(speech)
    noise_power = np.linalg.norm(noise)
    snr = 10 ** (snr_db / 20)
    scale = snr * noise_power / speech_power
    return (scale * speech + noise) / 2


def load_noise_seg(noise_path: str, shape: Tuple[int, int], sample_rate: int,
                   rng: random.Random) -> np.ndarray:
    """A random segment of a noise file as [1, shape[1]], tiled when the file
    is shorter."""
    noise = kaldi_data.load_wav_from_scp(noise_path)[0][0]
    need = shape[1]
    if len(noise) >= need:
        start = rng.randrange(0, len(noise) - need + 1)
        seg = noise[start:start + need]
    else:
        seg = np.tile(noise, int(np.ceil(need / len(noise))))[:need]
    return seg[None, :].astype(np.float32)


def _mu_law(x: np.ndarray, mu: float = 255.0) -> np.ndarray:
    y = np.sign(x) * np.log1p(mu * np.abs(x)) / np.log1p(mu)
    q = np.round((y + 1) / 2 * mu) / mu * 2 - 1
    return np.sign(q) * (np.expm1(np.abs(q) * np.log1p(mu))) / mu


def _a_law(x: np.ndarray, A: float = 87.6) -> np.ndarray:
    absx = np.abs(x)
    y = np.where(absx < 1 / A, A * absx / (1 + np.log(A)),
                 (1 + np.log(A * np.clip(absx, 1 / A, None))) / (1 + np.log(A)))
    y = np.sign(x) * y
    q = np.round((y + 1) / 2 * 255) / 255 * 2 - 1
    absq = np.abs(q)
    inv = np.where(absq < 1 / (1 + np.log(A)), absq * (1 + np.log(A)) / A,
                   np.exp(absq * (1 + np.log(A)) - 1) / A)
    return np.sign(q) * inv


def _lowpass_np(x: np.ndarray, fs: int, cutoff: float, order: int = 4) -> np.ndarray:
    from scipy import signal as sps

    sos = sps.butter(order, cutoff / (fs / 2), btype="low", output="sos")
    return sps.sosfilt(sos, x, axis=-1).astype(np.float32)


def speed_perturb(x: np.ndarray, factor: float) -> np.ndarray:
    """Speed perturbation by linear-interpolation resampling (0.9-1.1)."""
    n = x.shape[-1]
    idx = np.linspace(0, n - 1, int(round(n / factor)))
    lo = np.floor(idx).astype(int)
    hi = np.minimum(lo + 1, n - 1)
    frac = (idx - lo).astype(np.float32)
    return (x[..., lo] * (1 - frac) + x[..., hi] * frac).astype(np.float32)


def data_augmentation(speech: np.ndarray, transform_dict: Dict, sample_rate: int = 16000,
                      noise_db: Optional[Dict[str, Sequence[str]]] = None,
                      rir_db: Optional[Sequence[str]] = None,
                      rng: Optional[random.Random] = None, np_rng=None) -> np.ndarray:
    """``aug_number`` transforms picked at random from ``transform_dict
    ["pipeline"]``, applied to [C, N] (or [N]) audio.

    noise_db: {"speech" | "music" | "noise": [wav paths]}; rir_db: [RIR wav
    paths]. Every random choice comes from ``rng`` (the ``random`` module
    when None) in satpu's order; ``np_rng`` only dithers silent speech
    before noise is added (``fuse_speech_noise``)."""
    rng = rng or random
    if speech.ndim == 1:
        speech = speech[None, :]
    pipeline = transform_dict["pipeline"]
    k = transform_dict.get("aug_number", 1)
    augmentations = [pipeline[i] for i in rng.sample(range(len(pipeline)), k=k)]
    for a in augmentations:
        if a not in AUGMENTATIONS:
            raise ValueError(f"{a} is not a valid augmentation, allowed: {list(AUGMENTATIONS)}")

    if "add_reverb" in augmentations and rir_db:
        rir, rir_fs = kaldi_data.load_wav_from_scp(rir_db[rng.randrange(len(rir_db))])
        if rir_fs != sample_rate:
            raise ValueError(f"RIR at {rir_fs} Hz, audio at {sample_rate} Hz")
        full = np.stack([np.convolve(speech[c], rir[0], mode="full")
                         for c in range(speech.shape[0])])
        speech = full[:, :speech.shape[1]].astype(np.float32)

    if "add_noise" in augmentations and noise_db:
        babble = str(transform_dict.get("add_noise", {}).get("babble_noise", "true")
                     ).lower() == "true"
        noise_idx = rng.randrange(0, 4) if babble else rng.randrange(1, 3)
        noise = np.zeros_like(speech)
        if noise_idx == 0 and noise_db.get("speech"):
            snr_db = rng.randint(13, 20)
            pick = rng.randint(3, 7)
            pool = noise_db["speech"]
            paths = [pool[i] for i in rng.sample(range(len(pool)), k=min(pick, len(pool)))]
            for p in paths:
                noise += load_noise_seg(p, speech.shape, sample_rate, rng)
            noise /= max(len(paths), 1)
        elif noise_idx == 1 and noise_db.get("music"):
            snr_db = rng.randint(5, 15)
            noise += load_noise_seg(noise_db["music"][rng.randrange(len(noise_db["music"]))],
                                    speech.shape, sample_rate, rng)
        elif noise_db.get("noise"):
            snr_db = rng.randint(0, 15)
            noise += load_noise_seg(noise_db["noise"][rng.randrange(len(noise_db["noise"]))],
                                    speech.shape, sample_rate, rng)
        else:
            snr_db = None
        if snr_db is not None and np.any(noise):
            speech = fuse_speech_noise(speech, noise, snr_db, np_rng).astype(np.float32)

    if "phone_filtering" in augmentations:
        # sox lowpass 3400 + compand approximation (augmentation.py:141-151)
        speech = _mu_law(_lowpass_np(speech, sample_rate, 3400.0)).astype(np.float32)

    if "codec" in augmentations:
        codec = rng.choice(["mulaw", "alaw"])
        speech = (_mu_law(speech) if codec == "mulaw" else _a_law(speech)).astype(np.float32)

    if "speed_perturb" in augmentations:
        speech = speed_perturb(speech, rng.uniform(0.9, 1.1))

    return speech


def load_augmentation(value: str):
    """A CLI's ``augmentation`` option -> (transform_dict, noise_db, rir_db),
    or (None, None, None) when empty.

    ``value`` is inline lenient JSON (``//`` comments and trailing commas
    allowed) or the path of a .json file holding it. ``add_noise.noise_db_csv``
    and ``add_reverb.rir_db_csv`` name csv files whose sibling ``.json``
    databases are loaded."""
    if not value:
        return None, None, None
    text = value
    if not value.lstrip().startswith("{"):
        with open(value) as f:
            text = f.read()
    text = re.sub(r"//[^\n]*", "", text)
    text = re.sub(r",\s*([}\]])", r"\1", text)
    cfg = json.loads(text)
    noise_db = rir_db = None
    ncsv = cfg.get("add_noise", {}).get("noise_db_csv", "")
    if ncsv:
        with open(os.path.splitext(ncsv)[0] + ".json") as f:
            noise_db = json.load(f)
    rcsv = cfg.get("add_reverb", {}).get("rir_db_csv", "")
    if rcsv:
        with open(os.path.splitext(rcsv)[0] + ".json") as f:
            rir_db = json.load(f)
    return cfg, noise_db, rir_db


def spec_augment(x: torch.Tensor, generator: torch.Generator, frequency: float = 0.2,
                 frame: float = 0.2, rows: int = 1, cols: int = 1, random_rows: bool = False,
                 random_cols: bool = False) -> torch.Tensor:
    """Snowdar-style SpecAugment (augmentation.py:248-334) on [B, F, T]: one
    mask shared by the batch. Up to ``rows`` frequency bands of at most
    F * ``frequency`` bins are zeroed, each rescaling what survives by
    F / (F - f); up to ``cols`` time bands of at most T * ``frame`` frames.
    With ``random_rows`` / ``random_cols`` the band count is drawn too. The
    draws come from ``generator`` in satpu's order."""
    B, F, T = x.shape
    max_f, max_t = int(F * frequency), int(T * frame)

    def draw(lo: int, hi: int) -> int:
        return int(torch.randint(lo, hi, (), generator=generator, device=generator.device))

    n_rows = draw(1, rows + 1) if random_rows else rows
    n_cols = draw(1, cols + 1) if random_cols else cols
    for i in range(rows):
        f = draw(0, max_f + 1)
        f0 = draw(0, F - f + 1)
        if i < n_rows:
            x = x.clone()
            x[:, f0:f0 + f, :] = 0.0
            x = x * (F / max(F - f, 1))
    for i in range(cols):
        t = draw(0, max_t + 1)
        t0 = draw(0, T - t + 1)
        if i < n_cols:
            x = x.clone()
            x[:, :, t0:t0 + t] = 0.0
    return x
