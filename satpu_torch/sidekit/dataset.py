"""ASV training data (port of ``satpu.sidekit.dataset``; reference
satools/satools/sidekit/dataset.py), numpy on the host.

- ``SideSampler``: speaker-balanced sampling. For each of
  ``samples_per_speaker`` rounds the speakers are shuffled and each gives
  ``examples_per_speaker`` of its chunks, from numpy's generator seeded with
  ``seed + epoch``; ranks take interleaved slices (dataset.py:21-147).
- ``SideSet``: a grid of fixed-duration chunks over a kaldi data dir. A
  chunk is read at its offset, moved by a random shift of up to a quarter
  of its duration, padded, dithered with 1e-5 white noise, and augmented,
  its length repaired after speed perturbation (dataset.py:150-329).
  ``batches`` yields (wav [B, T] float32, speaker [B] int32) in the
  sampler's order.

The random draws are satpu's, in satpu's order: the shift and augmentation
from the set's ``random.Random(seed)``, the dither from its
``np.random.RandomState`` (satpu draws it from numpy's global generator; a
test that seeds that generator with the same seed gets the same stream).
Validation reads ``side[i]`` too, so it moves both streams.
"""
from __future__ import annotations

import os
import random
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from ..ops.augment import data_augmentation
from ..utils import kaldi_data


class SideSampler:
    """Speaker-balanced sampler over chunks labelled by speaker index."""

    def __init__(self, data_source: np.ndarray, spk_count: int, examples_per_speaker: int,
                 samples_per_speaker: int, batch_size: int, seed: int = 0,
                 rank: int = 0, num_process: int = 1, num_replicas: int = 1):
        """data_source: [N] speaker index of each chunk."""
        self.labels_to_indices: Dict[int, List[int]] = {}
        for idx, spk in enumerate(np.asarray(data_source)):
            self.labels_to_indices.setdefault(int(spk), []).append(idx)
        self.spk_count = spk_count
        self.examples_per_speaker = examples_per_speaker
        self.samples_per_speaker = samples_per_speaker
        self.epoch = 0
        self.seed = seed
        self.rank, self.num_process = rank, num_process
        if batch_size % examples_per_speaker:
            raise ValueError(f"batch size {batch_size} is not a multiple of "
                             f"examples_per_speaker {examples_per_speaker}")
        if (samples_per_speaker * spk_count * examples_per_speaker) % num_process:
            raise ValueError("the epoch's chunks do not split evenly over the processes")
        self.batch_size = batch_size // (examples_per_speaker * num_replicas)

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __iter__(self) -> Iterator[int]:
        g = np.random.default_rng(self.seed + self.epoch)
        indices = []
        speakers = np.arange(self.spk_count)
        for _ in range(self.samples_per_speaker):
            g.shuffle(speakers)
            for spk in speakers:
                pool = self.labels_to_indices[int(spk)]
                picks = g.choice(len(pool), size=self.examples_per_speaker,
                                 replace=len(pool) < self.examples_per_speaker)
                indices += [pool[int(p)] for p in picks]
        return iter(indices[self.rank::self.num_process])

    def __len__(self) -> int:
        return (self.samples_per_speaker * self.spk_count * self.examples_per_speaker
                ) // self.num_process


@dataclass
class Chunk:
    utt: str
    wavspec: str
    spk_idx: int
    offset: int  # samples
    duration: int  # samples


class SideSet:
    """Chunk index over a kaldi data dir (wav.scp, utt2spk, utt2dur)."""

    def __init__(self, utt2wav: Dict[str, str], utt2spk: Dict[str, str],
                 utt2dur: Dict[str, float], speakers: Optional[List[str]] = None,
                 duration: float = 3.0, overlap: float = 0.0, sample_rate: int = 16000,
                 chunk_per_segment: int = -1, random_shift: bool = True,
                 transform_pipeline: Optional[Dict] = None,
                 noise_db=None, rir_db=None, seed: int = 1234):
        self.sample_rate = sample_rate
        self.duration_samples = int(duration * sample_rate)
        self.transform_pipeline = transform_pipeline
        self.noise_db, self.rir_db = noise_db, rir_db
        self.random_shift = random_shift
        self.rng = random.Random(seed)
        self.np_rng = np.random.RandomState(seed)
        self.speakers = speakers or sorted(set(utt2spk.values()))
        spk_index = {s: i for i, s in enumerate(self.speakers)}
        shift = duration - overlap
        self.chunks: List[Chunk] = []
        for utt, wavspec in utt2wav.items():
            dur = utt2dur.get(utt, 0.0)
            n_chunks = int((dur - duration) / shift) + 1 if dur >= duration else 0
            if chunk_per_segment > 0:
                n_chunks = min(n_chunks, chunk_per_segment)
            self.chunks += [Chunk(utt=utt, wavspec=wavspec, spk_idx=spk_index[utt2spk[utt]],
                                  offset=int(c * shift * sample_rate),
                                  duration=self.duration_samples) for c in range(n_chunks)]

    @classmethod
    def from_data_dir(cls, data_dir: str, **kw) -> "SideSet":
        """From ``data_dir``'s wav.scp and utt2spk, and its utt2dur (written
        first when missing)."""
        utt2wav = kaldi_data.read_wav_scp(os.path.join(data_dir, "wav.scp"))
        utt2spk = kaldi_data.read_keyed_text(os.path.join(data_dir, "utt2spk"))
        return cls(utt2wav, utt2spk, kaldi_data.get_utt2dur(data_dir), **kw)

    @property
    def chunk_speakers(self) -> np.ndarray:
        return np.asarray([c.spk_idx for c in self.chunks], dtype=np.int32)

    def __len__(self) -> int:
        return len(self.chunks)

    def __getitem__(self, i: int) -> Tuple[np.ndarray, int]:
        c = self.chunks[i]
        offset = c.offset
        if self.random_shift:
            jitter = self.rng.randint(-self.duration_samples // 4, self.duration_samples // 4)
            offset = max(0, offset + jitter)
        x = kaldi_data.load_wav_from_scp(c.wavspec, frame_offset=offset,
                                         num_frames=c.duration)[0][0]
        if len(x) < c.duration:
            x = np.pad(x, (0, c.duration - len(x)))
        x = x + 1e-5 * self.np_rng.randn(len(x)).astype(np.float32)
        if self.transform_pipeline:
            x = data_augmentation(x[None, :], self.transform_pipeline, self.sample_rate,
                                  self.noise_db, self.rir_db, rng=self.rng,
                                  np_rng=self.np_rng)[0]
            if len(x) != c.duration:  # speed perturbation changes the length
                x = x[:c.duration] if len(x) >= c.duration else np.pad(
                    x, (0, c.duration - len(x)))
        return x.astype(np.float32), c.spk_idx

    def batches(self, sampler: SideSampler, batch_size: int):
        """(wav [B, T] float32, speaker [B] int32) batches in the sampler's
        order; a last partial batch is dropped."""
        idxs = list(iter(sampler))
        for i in range(0, len(idxs) - batch_size + 1, batch_size):
            wavs, spks = zip(*(self[j] for j in idxs[i:i + batch_size]))
            yield np.stack(wavs), np.asarray(spks, dtype=np.int32)
