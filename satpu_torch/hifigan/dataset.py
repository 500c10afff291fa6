"""HiFi-GAN training data (a numpy copy of ``satpu.hifigan.dataset``).

Aligned (audio, bn, f0, spk) segment batches for the GAN step:

- per-utterance features of the frozen extractor (bottleneck features and
  YAAPT F0, computed on the card by the caller's functions) are computed
  once and memoized in scp caches (``utils.feature_cache``),
- ``sample_interval``: a random crop aligned across streams of different
  rates, on the LCM of their hops,
- the ground-truth audio is peak-normalized to 0.95.
"""
from __future__ import annotations

import inspect
import logging
import os
import random
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from ..utils import kaldi_data
from ..utils.feature_cache import FeatureCache

# padded-length ladder for feature extraction (the anonymize pipeline's
# DEFAULT_BUCKETS): one padded shape per bucket, not per utterance length
FEATURE_BUCKETS = (16000, 32000, 48000, 64000, 96000, 128000, 160000, 240000, 320000)


def _bucket_pad(audio: np.ndarray, buckets: Sequence[int]) -> np.ndarray:
    T = len(audio)
    top = buckets[-1]
    b = next((x for x in buckets if T <= x), ((T + top - 1) // top) * top)
    out = np.zeros((1, b), np.float32)
    out[0, :T] = audio
    return out


def normalize_audio(x: np.ndarray, level: float = 0.95) -> np.ndarray:
    """librosa.util.normalize(x) * level: peak normalization."""
    peak = np.max(np.abs(x))
    return (x / peak * level).astype(np.float32) if peak > 0 else x.astype(np.float32)


def sample_interval(seqs: List[np.ndarray], seq_len: int,
                    max_len: Optional[int] = None,
                    rng: Optional[random.Random] = None) -> Tuple[List[np.ndarray], List[Tuple[int, int]]]:
    """Aligned random interval over sequences with different rates. seq_len
    is in samples of the LONGEST sequence."""
    rng = rng or random
    seq_shape = [v.shape[-1] for v in seqs]
    N = max(seq_shape)
    argmax_set = {i for i, v in enumerate(seq_shape) if v == N}
    hops = np.array([N // v for v in seq_shape])
    others = [s for i, s in enumerate(seq_shape) if i not in argmax_set]
    if others:
        N2 = max(others)
        hops2 = np.array([N2 // s for s in others])
        # snap the other hops to multiples of 4 * hops2
        filtered = np.around(hops[[i for i in range(len(hops)) if i not in argmax_set]]
                             / (hops2 * 4)) * (hops2 * 4)
        j = 0
        for i in range(len(hops)):
            if i not in argmax_set:
                hops[i] = max(int(filtered[j]), 1)
                j += 1
    lcm = np.lcm.reduce(hops)

    interval_end = (max_len if max_len is not None else N) // lcm - seq_len // lcm
    if max_len is not None and max_len < seq_len:
        start_step = 0
        seqs = [np.pad(v, [(0, 0)] * (v.ndim - 1) + [(0, max(0, seq_len - v.shape[-1]))])
                for v in seqs]
    else:
        start_step = rng.randint(0, max(int(interval_end), 0))

    new_seqs, intervals = [], []
    for i, v in enumerate(seqs):
        start = start_step * (lcm // hops[i])
        end = (start_step + seq_len // lcm) * (lcm // hops[i])
        new_seqs.append(v[..., start:end])
        intervals.append((int(start), int(end)))
    return new_seqs, intervals


@dataclass
class VcUtterance:
    utt: str
    wavspec: str
    spk: str


def _takes_len(fn) -> bool:
    try:
        return fn is not None and len(inspect.signature(fn).parameters) >= 2
    except (TypeError, ValueError):
        return False


class HifiGanDataset:
    """Training set over a kaldi dir with cached BN/F0 features.

    bn_fn(wav [1, T]) -> [C, T_bn]; f0_fn(wav [1, T]) -> [T_f0]. The
    two-argument forms ``fn(wav [1, T_bucket], lengths [1])`` get the audio
    padded to ``FEATURE_BUCKETS`` and their output is cropped to the
    utterance's frame count. ``f0_norm_fn(f0, speaker) -> f0`` normalizes on
    the host (``f0_norm = speaker``); None leaves it to the model.
    """

    def __init__(self, data_dir: str, speakers: Optional[List[str]] = None,
                 bn_fn: Optional[Callable] = None, f0_fn: Optional[Callable] = None,
                 cache_dir: Optional[str] = None, segment_size: int = 16640,
                 min_len: int = 17000, seed: int = 0, worker_name: str = "w0",
                 f0_norm_fn: Optional[Callable] = None,
                 cache_signature: str = ""):
        self.f0_norm_fn = f0_norm_fn
        self.segment_size = segment_size
        self.rng = random.Random(seed)
        utt2wav = kaldi_data.read_wav_scp(os.path.join(data_dir, "wav.scp"))
        utt2spk = kaldi_data.read_keyed_text(os.path.join(data_dir, "utt2spk"))
        self.speakers = speakers or sorted(set(utt2spk.values()))
        self.spk_index = {s: i for i, s in enumerate(self.speakers)}
        self.utts = [VcUtterance(u, w, utt2spk[u]) for u, w in utt2wav.items()
                     if u in utt2spk]
        self.bn_fn = bn_fn
        self.f0_fn = f0_fn
        self._bn_takes_len = _takes_len(bn_fn)
        self._f0_takes_len = _takes_len(f0_fn)
        cache_dir = cache_dir or os.path.join(data_dir, "feature_cache")
        self.bn_cache = FeatureCache(cache_dir, "get_bn", worker_name,
                                     enabled=bn_fn is not None,
                                     signature=cache_signature)
        self.f0_cache = FeatureCache(cache_dir, "get_f0", worker_name,
                                     enabled=f0_fn is not None)
        # drop utterances shorter than a training segment: they would give
        # ragged crops
        self.min_len = min_len
        if min_len > 0:
            utt2len_path = os.path.join(data_dir, "utt2len")
            if os.path.exists(utt2len_path):
                utt2len = kaldi_data.read_utt2len_file(utt2len_path)
            else:
                utt2len = kaldi_data.gen_utt2len(
                    os.path.join(data_dir, "wav.scp"), utt2len_path)
            before = len(self.utts)
            self.utts = [u for u in self.utts if utt2len.get(u.utt, 0) >= min_len]
            if len(self.utts) < before:
                logging.info("HifiGanDataset: filtered %d/%d utts shorter than "
                             "%d samples", before - len(self.utts), before, min_len)

    def __len__(self) -> int:
        return len(self.utts)

    def features(self, i: int):
        u = self.utts[i]
        wav, rate = kaldi_data.load_wav_from_scp(u.wavspec)
        audio = normalize_audio(wav[0])
        bn = self.bn_cache.get_or_compute(u.utt, lambda: self._compute_bn(audio))
        f0 = np.asarray(self.f0_cache.get_or_compute(
            u.utt, lambda: self._compute_f0(audio))).reshape(-1)
        if self.f0_norm_fn is not None:
            f0 = np.asarray(self.f0_norm_fn(f0, u.spk)).reshape(-1)
        return audio, np.asarray(bn), f0, self.spk_index[u.spk]

    def _compute_bn(self, audio: np.ndarray):
        """BN of the bucket-padded copy, cropped to the utterance's frames
        (the extractor masks by length, so they equal a per-length run's)."""
        from ..models.asrbn import bn_num_frames

        T = len(audio)
        if self._bn_takes_len:
            out = self.bn_fn(_bucket_pad(audio, FEATURE_BUCKETS),
                             np.asarray([T], np.int32))
            return np.asarray(out)[..., : bn_num_frames(T)]
        return self.bn_fn(audio[None, :])

    def _compute_f0(self, audio: np.ndarray):
        from ..models.asrbn import f0_num_frames

        T = len(audio)
        if self._f0_takes_len:
            out = self.f0_fn(_bucket_pad(audio, FEATURE_BUCKETS),
                             np.asarray([T], np.int32))
            return np.asarray(out).reshape(-1)[: f0_num_frames(T)]
        return self.f0_fn(audio[None, :])

    def __getitem__(self, i: int):
        """One aligned random segment: (audio [T], bn [C, T_bn], f0 [T_f0], spk)."""
        audio, bn, f0, spk = self.features(i)
        (audio_s, bn_s, f0_s), _ = sample_interval(
            [audio, bn, f0], self.segment_size, rng=self.rng)
        return audio_s, bn_s, f0_s, spk

    def batches(self, batch_size: int, shuffle: bool = True, epoch: int = 0,
                process_index: int = 0, process_count: int = 1):
        """Batches of ``batch_size`` segments: every process shuffles alike
        (seed 1234 + epoch) and takes an interleaved slice; the tail wraps
        around so every utterance is seen each epoch."""
        order = list(range(len(self)))
        if shuffle:
            random.Random(1234 + epoch).shuffle(order)
        if process_count > 1:
            order = order[process_index::process_count]
        if len(order) % batch_size and len(order) >= batch_size:
            order += order[: batch_size - len(order) % batch_size]
        for i in range(0, len(order) - batch_size + 1, batch_size):
            items = [self[j] for j in order[i : i + batch_size]]
            audio = np.stack([a for a, _, _, _ in items])
            bn = np.stack([b for _, b, _, _ in items])
            f0 = np.stack([f for _, _, f, _ in items])
            spk = np.zeros((batch_size, len(self.speakers)), np.float32)
            for k, (_, _, _, s) in enumerate(items):
                spk[k, s] = 1.0
            yield {"audio": audio.astype(np.float32), "bn": bn.astype(np.float32),
                   "f0": f0.astype(np.float32), "spk": spk}

    def fake_epoch(self, progress_cb=None) -> None:
        """Fill the feature caches over the whole set."""
        for i in range(len(self)):
            self.features(i)
            if progress_cb:
                progress_cb(i + 1, len(self))
