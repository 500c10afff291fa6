"""LF-MMI egs: utterances with numerator supervisions, batched by exact
output length (port of ``satpu.chain.dataset``).

- ``EgsInfo`` / ``EgsDataset``: wav.scp + per-utterance numerator FSTs (an
  fst scp into kaldi-style arks of OpenFst binaries) + utt2len; each
  supervision is composed with ``normalization.fst`` when given, made
  epsilon-free and cached as arc arrays;
- ``BucketBatchSampler``: every batch holds utterances with the same number
  of output frames, shuffled with numpy's generator seeded from
  ``seed + epoch`` (the same batches in the same order as satpu's);
- ``fst_min_path_length``: utterances whose supervision needs more frames
  than the network emits are dropped.

Waveform augmentation (``transform_pipeline``) and transition-id graphs
(``trans_mdl``) are not ported yet (ROADMAP Queue 1, items 13 and 11).
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional

import numpy as np

from ..utils import kaldi_data
from .fst import (Fst, GraphArrays, fst_compose_acceptor, fst_rmepsilon, fst_to_arrays,
                  pad_graph_arrays, read_fst_kaldi)


def fst_min_path_length(fst: Fst) -> int:
    """Fewest emitting arcs on a path from the start to a final state."""
    INF = 1 << 30
    dist = [INF] * fst.num_states
    dist[fst.start] = 0
    q = deque([fst.start])
    while q:
        s = q.popleft()
        for a in fst.arcs[s]:
            nd = dist[s] + (1 if a.ilabel > 0 else 0)
            if nd < dist[a.nextstate]:
                dist[a.nextstate] = nd
                q.append(a.nextstate)
    best = INF
    for s, w in enumerate(fst.finals):
        if w != float("inf"):
            best = min(best, dist[s])
    return best


@dataclass
class EgsInfo:
    utt: str
    wavspec: str
    fst_rx: str  # "path:offset" into the fst ark, or a plain file
    num_samples: int

    def load_fst(self) -> Fst:
        if ":" in self.fst_rx and self.fst_rx.rsplit(":", 1)[1].isdigit():
            path, off = self.fst_rx.rsplit(":", 1)
            with open(path, "rb") as f:
                f.seek(int(off))
                return read_fst_kaldi(f)
        with open(self.fst_rx, "rb") as f:
            return read_fst_kaldi(f)


class EgsDataset:
    """Numerator-supervised utterances grouped by exact output length."""

    def __init__(self, wav_scp: str, fst_scp: str, utt2len: str,
                 frame_subsampling: int = 3, samples_per_frame: int = 160,
                 transform_pipeline: Optional[Dict] = None,
                 normalization_fst: Optional[str] = None,
                 trans_mdl: Optional[str] = None):
        if transform_pipeline:
            raise NotImplementedError(
                "waveform augmentation (ops/augment.py) is not ported yet: ROADMAP Queue 1,"
                " item 13")
        if trans_mdl:
            raise NotImplementedError(
                "transition-id graphs (chain/hmm.py trans_mdl) are not ported yet: ROADMAP"
                " Queue 1, item 11")
        self.samples_per_frame = samples_per_frame
        self.frame_subsampling = frame_subsampling
        self.normalization_fst = Fst.read(normalization_fst) if normalization_fst else None
        self._supervision_cache: Dict[int, GraphArrays] = {}
        utt2wav = kaldi_data.read_wav_scp(wav_scp)
        utt2fst = kaldi_data.read_wav_scp(fst_scp)
        u2l = kaldi_data.read_utt2len_file(utt2len)
        self.egs: List[EgsInfo] = [EgsInfo(utt, spec, utt2fst[utt], u2l[utt])
                                   for utt, spec in utt2wav.items()
                                   if utt in utt2fst and utt in u2l]

    def output_frames(self, num_samples: int) -> int:
        """Network output frames for ``num_samples`` (fbank frames with
        snip_edges=False, then the /2 and /1.5 subsampling)."""
        feats = (num_samples + 80) // 160
        return max((feats - 2) // self.frame_subsampling, 0)

    def filter_min_path(self) -> int:
        """Drop utterances whose numerator FST cannot fit their frame count;
        returns how many were dropped."""
        keep = [e for e in self.egs
                if fst_min_path_length(e.load_fst()) <= self.output_frames(e.num_samples)]
        removed = len(self.egs) - len(keep)
        self.egs = keep
        self._supervision_cache.clear()  # indices changed
        return removed

    def __len__(self) -> int:
        return len(self.egs)

    def supervision_arrays(self, index: int) -> GraphArrays:
        """Normalized, epsilon-free supervision arrays of one utterance,
        memoized (composition and epsilon removal are per-utterance work)."""
        cached = self._supervision_cache.get(index)
        if cached is not None:
            return cached
        e = self.egs[index]
        g = e.load_fst()
        if self.normalization_fst is not None:
            g = fst_compose_acceptor(g, self.normalization_fst)
            if g.num_states == 0:
                raise ValueError(f"supervision for {e.utt} is empty after composing with "
                                 "normalization.fst (label mismatch?)")
        # the forward treats every arc as emitting: strip epsilon arcs
        arrays = fst_to_arrays(fst_rmepsilon(g))
        self._supervision_cache[index] = arrays
        return arrays

    def load_batch(self, indices: List[int]):
        """-> (wav [B, T] float32, padded graph arrays, num_frames [B], utts)."""
        egs = [self.egs[i] for i in indices]
        T = max(e.num_samples for e in egs)
        wavs = np.zeros((len(egs), T), np.float32)
        for j, e in enumerate(egs):
            x = kaldi_data.load_wav_from_scp(e.wavspec)[0][0][:T]
            wavs[j, :len(x)] = x
        frames = np.asarray([self.output_frames(e.num_samples) for e in egs], np.int32)
        graphs = pad_graph_arrays([self.supervision_arrays(i) for i in indices])
        return wavs, graphs, frames, [e.utt for e in egs]


class BucketBatchSampler:
    """Exact-length bucketing: every batch holds utterances with identical
    output frame counts (or num_samples // 199 with ``allow_some_padding``)."""

    def __init__(self, dataset: EgsDataset, batch_size: int,
                 allow_some_padding: bool = False, seed: int = 0):
        self.batch_size = batch_size
        self.seed = seed
        self.epoch = 0
        self.buckets: Dict[int, List[int]] = {}
        for i, e in enumerate(dataset.egs):
            key = (e.num_samples // 199 if allow_some_padding
                   else dataset.output_frames(e.num_samples))
            self.buckets.setdefault(key, []).append(i)

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __iter__(self) -> Iterator[List[int]]:
        rng = np.random.default_rng(self.seed + self.epoch)
        batches = []
        for key in sorted(self.buckets):
            idxs = list(self.buckets[key])
            rng.shuffle(idxs)
            batches += [idxs[i:i + self.batch_size]
                        for i in range(0, len(idxs), self.batch_size)]
        for i in rng.permutation(len(batches)):
            yield batches[int(i)]

    def __len__(self) -> int:
        return sum((len(v) + self.batch_size - 1) // self.batch_size
                   for v in self.buckets.values())
