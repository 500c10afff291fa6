"""Audio preprocessing for VC data prep (reference
egs/vc/libritts/local/preprocess.py): resample to 16 kHz, optional
silence trim, optional pad to a multiple of 1280 samples (the HiFi-GAN
hop LCM, so BN/F0 frames align exactly), writing a new kaldi-style dir.

Usage:
    python -m satpu_torch.bin.preprocess_audio --data-dir data/libritts_24k \
        --out-dir data/libritts_16k --trim true --pad true
"""
from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import sys

import numpy as np

from ..utils import config as cfg
from ..utils import kaldi_data


@dataclasses.dataclass
class PreprocessOpts(cfg.Opts):
    data_dir: str = ""
    out_dir: str = ""
    sample_rate: int = 16000
    # librosa.effects.trim analog: strip leading/trailing frames more than
    # top_db below the utterance peak (preprocess.py:19-20, top_db=20)
    trim: bool = False
    top_db: float = 20.0
    # zero-pad to a multiple of pad_multiple samples (preprocess.py:22-30)
    pad: bool = False
    pad_multiple: int = 1280


def resample(x: np.ndarray, rate: int, target: int) -> np.ndarray:
    """Polyphase resampling (reference uses resampy; scipy's kaiser-windowed
    polyphase is the standard equivalent)."""
    if rate == target:
        return x
    from math import gcd

    from scipy.signal import resample_poly

    g = gcd(rate, target)
    return resample_poly(x, target // g, rate // g).astype(np.float32)


def trim_silence(x: np.ndarray, top_db: float = 20.0,
                 frame: int = 2048, hop: int = 512) -> np.ndarray:
    """librosa.effects.trim(x, top_db) semantics: keep the span of frames
    whose RMS power is within top_db of the max frame power."""
    if len(x) < frame:
        return x
    n = 1 + (len(x) - frame) // hop
    idx = np.arange(frame)[None, :] + hop * np.arange(n)[:, None]
    rms = np.sqrt(np.mean(x[idx] ** 2, axis=1) + 1e-12)
    db = 20.0 * np.log10(rms / (rms.max() + 1e-12) + 1e-12)
    keep = np.nonzero(db > -top_db)[0]
    if len(keep) == 0:
        return x
    start = keep[0] * hop
    end = min(keep[-1] * hop + frame, len(x))
    return x[start:end]


def pad_to_multiple(x: np.ndarray, multiple: int) -> np.ndarray:
    rem = len(x) % multiple
    if rem:
        x = np.pad(x, (0, multiple - rem))
    return x


def preprocess_dir(data_dir: str, out_dir: str, sample_rate: int = 16000,
                   trim: bool = False, top_db: float = 20.0,
                   pad: bool = False, pad_multiple: int = 1280) -> str:
    utt2wav = kaldi_data.read_wav_scp(os.path.join(data_dir, "wav.scp"))
    os.makedirs(os.path.join(out_dir, "wavs"), exist_ok=True)
    kaldi_data.copy_data_dir(data_dir, out_dir)
    new_scp = {}
    for utt, spec in utt2wav.items():
        wav, rate = kaldi_data.load_wav_from_scp(spec)
        x = wav[0].astype(np.float32)
        x = resample(x, rate, sample_rate)
        if trim:
            x = trim_silence(x, top_db)
        if pad:
            x = pad_to_multiple(x, pad_multiple)
        p = os.path.join(out_dir, "wavs", f"{utt}.wav")
        kaldi_data.write_wav(p, x, sample_rate)
        new_scp[utt] = p
    kaldi_data.write_keyed_text(new_scp, os.path.join(out_dir, "wav.scp"))
    logging.info("preprocessed %d utterances -> %s", len(new_scp), out_dir)
    return out_dir


def main(argv=None):
    logging.basicConfig(level=logging.INFO, format="satpu_torch %(levelname)s: %(message)s")
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--config", default="")
    args, rest = parser.parse_known_args(argv)
    opts = PreprocessOpts()
    if args.config:
        ini = cfg.load_ini(args.config)
        if "preprocess" in ini:
            opts.load_from_config(ini["preprocess"])
    opts.load_from_args(rest)
    if not opts.data_dir or not opts.out_dir:
        print("need --data-dir and --out-dir", file=sys.stderr)
        return 2
    preprocess_dir(opts.data_dir, opts.out_dir, sample_rate=opts.sample_rate,
                   trim=opts.trim, top_db=opts.top_db, pad=opts.pad,
                   pad_multiple=opts.pad_multiple)
    return 0


if __name__ == "__main__":
    sys.exit(main())
