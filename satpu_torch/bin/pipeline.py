"""Anonymization pipeline over a kaldi-style data dir (port of
``satpu.bin.pipeline``).

Utterances are sorted by length and grouped into batches padded to a
bucket ladder of lengths; each batch runs ``get_f0`` then ``convert`` on the
model's device. One batch stays in flight: its output is copied to pinned
host memory asynchronously while the next batch is enqueued, and a writer
thread pool writes the wavs once the copy has landed.

With several ``devices`` (``anonymize --serve-mesh``, satpu's serving mesh)
the model is replicated once per device and each batch is cut into one
contiguous block per device; every block runs ``get_f0`` and ``convert`` on
its device, and the outputs are gathered in order. A random F0
transformation draws each block's noise from its device's own generator.

Target-selection algorithms: constant | none | bad_for_evaluation |
random_per_utt | random_per_spk_uniq | random_per_spk.
"""
from __future__ import annotations

import copy
import dataclasses
import logging
import os
import random
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..parallel import mesh
from ..utils import kaldi_data

DEFAULT_BUCKETS = (16000, 32000, 48000, 64000, 96000, 128000, 160000, 240000, 320000)


def select_targets(utids: Sequence[str], algorithm: str, possible_targets: List[str],
                   source_utt2spk: Dict[str, str], state: Dict[str, object],
                   constant_spkid: str = "", rng: Optional[random.Random] = None) -> List[str]:
    """One batch of target speaker ids."""
    rng = rng or random
    out_spk2target = state.setdefault("out_spk2target", {})
    targets: List[str] = []
    if algorithm == "constant":
        targets = [constant_spkid] * len(utids)
    elif algorithm == "none":
        # no target: resynthesize each utterance as its own source speaker
        targets = [source_utt2spk[ut] for ut in utids]
    elif algorithm == "bad_for_evaluation":
        for ut in utids:
            spk = source_utt2spk[ut]
            if spk not in out_spk2target:
                out_spk2target[spk] = rng.sample(possible_targets, 2)
            targets.append(rng.choice(out_spk2target[spk]))
    elif algorithm == "random_per_utt":
        targets = [rng.choice(possible_targets) for _ in utids]
    elif algorithm == "random_per_spk_uniq":
        remaining = state.setdefault("remaining_targets", list(possible_targets))
        for ut in utids:
            spk = source_utt2spk[ut]
            if spk not in out_spk2target:
                choice = rng.choice(remaining)
                out_spk2target[spk] = choice
                remaining.remove(choice)
            targets.append(out_spk2target[spk])
    elif algorithm == "random_per_spk":
        for ut in utids:
            spk = source_utt2spk[ut]
            if spk not in out_spk2target:
                out_spk2target[spk] = rng.choice(possible_targets)
            targets.append(out_spk2target[spk])
    else:
        raise ValueError(f"{algorithm} not implemented")
    return targets


def bucket_for(length: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if length <= b:
            return b
    # longer than the largest bucket: round up to a multiple of it
    top = buckets[-1]
    return ((length + top - 1) // top) * top


def _start_host_copy(out: torch.Tensor):
    """(host tensor, event to wait on or None): an async device->host copy
    into pinned memory for a CUDA tensor."""
    if out.device.type != "cuda":
        return out, None
    host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
    host.copy_(out, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return host, done


def process_data(model, speakers: List[str], data_dir: str, results_dir: str,
                 target_selection_algorithm: str = "constant",
                 target_constant_spkid: str = "", batch_size: int = 32,
                 buckets: Sequence[int] = DEFAULT_BUCKETS, f0_transformation: str = "",
                 seed: int = 0, new_datadir_suffix: str = "_anon",
                 num_shards: int = 1, shard: int = 0, f0_speaker_stats: Optional[dict] = None,
                 devices: Optional[Sequence] = None, progress_cb=None) -> str:
    """Anonymize every utterance of ``data_dir``; returns the new data dir.

    model: AnonymizationNet on its serving device; speakers: ordered target
    speaker list (index = one-hot id). With ``num_shards > 1`` only every
    num_shards-th utterance (offset ``shard``) is processed and a partial
    ``wav_shard{k}.scp`` is written; the full ``wav.scp`` is merged once all
    shards are present.

    A model with ``f0_norm == "none"`` takes normalized F0: with
    ``f0_speaker_stats`` (a ``SpeakerCMVN.to_meta()`` from the checkpoint)
    each utterance's F0 is normalized on the host by its source speaker's
    statistics, and a speaker without them passes through. Without the
    statistics such a model is refused (raw F0 in Hz is not its input).

    ``devices`` (the model's device when None): with more than one, each
    batch is split over them (``batch_size`` must be a multiple of their
    count), one replica of the model on each.
    """
    f0_cmvn = None
    if model.cfg.f0_norm == "none":
        from ..ops.cmvn import SpeakerCMVN

        if not f0_speaker_stats:
            raise ValueError("the model takes speaker-normalized F0 (f0_norm='none') and its "
                             "checkpoint holds no f0_speaker_stats")

        f0_cmvn = SpeakerCMVN.from_meta(f0_speaker_stats)
        f0_cmvn.pass_through = True
    device = next(model.parameters()).device
    devices = [torch.device(d) for d in devices] if devices else [device]
    if len(devices) > 1 and batch_size % len(devices):
        raise ValueError(f"serve_mesh needs batch_size ({batch_size}) divisible by the device "
                         f"count ({len(devices)})")
    rng = random.Random(seed)
    out_dir = data_dir.rstrip("/") + new_datadir_suffix
    kaldi_data.copy_data_dir(data_dir, out_dir)
    os.makedirs(results_dir, exist_ok=True)

    if f0_transformation and f0_transformation != model.cfg.f0_transformation:
        # the transformation is read from the config: a shallow copy shares
        # the weights
        model = copy.copy(model)
        model.cfg = dataclasses.replace(model.cfg, f0_transformation=f0_transformation)

    utt2wav = kaldi_data.read_wav_scp(os.path.join(data_dir, "wav.scp"))
    utt2spk_path = os.path.join(data_dir, "utt2spk")
    source_utt2spk = (kaldi_data.read_keyed_text(utt2spk_path)
                      if os.path.exists(utt2spk_path) else {u: u for u in utt2wav})
    spk_index = {s: i for i, s in enumerate(speakers)}
    state: Dict[str, object] = {}

    all_utts = sorted(utt2wav)
    my_utts = all_utts[shard::num_shards] if num_shards > 1 else all_utts
    entries = []
    for utt in my_utts:
        wav, rate = kaldi_data.load_wav_from_scp(utt2wav[utt])
        entries.append((utt, wav[0], rate))
    entries.sort(key=lambda e: len(e[1]))

    # one replica and one generator per device, the generators seeded alike;
    # the first replica is ``model`` when it sits on the first device
    replicas = [model if d == device else copy.deepcopy(model).to(d) for d in devices]
    if len(devices) > 1:
        logging.info("serve_mesh: batches split over %d devices", len(devices))
    generators = [torch.Generator(device=d).manual_seed(seed) for d in devices]
    new_wav_scp: Dict[str, str] = {}

    def write_batch(utids, host, done, lens, rate):
        if done is not None:
            done.synchronize()
        wavs = host.numpy()
        for u, w, n in zip(utids, wavs, lens):
            out = os.path.join(results_dir, f"{u}.wav")
            kaldi_data.write_wav(out, np.asarray(w[:n], dtype=np.float32), rate)
            new_wav_scp[u] = out

    pending = []
    in_flight = None
    done_count = 0
    with ThreadPoolExecutor(max_workers=4) as writer, torch.inference_mode():
        for i in range(0, len(entries), batch_size):
            batch = entries[i:i + batch_size]
            utids = [e[0] for e in batch]
            rate = batch[0][2]
            bucket = bucket_for(max(len(e[1]) for e in batch), buckets)
            # the batch dim is always padded to batch_size
            wav_batch = np.zeros((batch_size, bucket), np.float32)
            lens = []
            for j, (_, w, _) in enumerate(batch):
                wav_batch[j, :len(w)] = w
                lens.append(len(w))
            targets = select_targets(utids, target_selection_algorithm, list(speakers),
                                     source_utt2spk, state, target_constant_spkid, rng)
            try:
                tids_list = [spk_index[t] for t in targets]
            except KeyError as e:
                raise KeyError(
                    f"target speaker {e} is not in the model's speaker list "
                    f"(algorithm={target_selection_algorithm!r}); with 'none' every "
                    "source speaker must be a training speaker of the model") from None
            tids = np.zeros((batch_size,), np.int64)
            tids[:len(batch)] = tids_list

            wavs, tid_blocks = (mesh.split_rows(torch.from_numpy(a), devices) for a in (wav_batch, tids))
            f0s = [m.get_f0(w) for m, w in zip(replicas, wavs)]
            if f0_cmvn is not None:
                f0_host = torch.cat([f.cpu() for f in f0s]).numpy()
                for j, ut in enumerate(utids):
                    f0_host[j] = f0_cmvn(f0_host[j], source_utt2spk.get(ut, ut))
                f0s = mesh.split_rows(torch.from_numpy(f0_host), devices)
            blocks = []
            for k, (m, w, f, t, g) in enumerate(zip(replicas, wavs, f0s, tid_blocks,
                                                    generators)):
                # a replica draws its rows of the batch's F0 noise (awgn)
                with mesh.row_block(k, len(wavs)):
                    blocks.append(m.convert(w, f, t, generator=g))
            out = mesh.gather_rows(blocks, devices[0])
            host, done = _start_host_copy(out[:len(batch)])
            # write the PREVIOUS batch while the device converts this one
            if in_flight is not None:
                pending.append(writer.submit(write_batch, *in_flight))
            in_flight = (utids, host, done, lens, rate)
            done_count += len(batch)
            if progress_cb:
                progress_cb(done_count, len(entries))
        if in_flight is not None:
            pending.append(writer.submit(write_batch, *in_flight))
        for p in pending:
            p.result()

    if num_shards > 1:
        kaldi_data.write_keyed_text(new_wav_scp, os.path.join(out_dir, f"wav_shard{shard}.scp"))
        parts = [os.path.join(out_dir, f"wav_shard{k}.scp") for k in range(num_shards)]
        if all(os.path.exists(p) for p in parts):
            merged: Dict[str, str] = {}
            for p in parts:
                merged.update(kaldi_data.read_keyed_text(p))
            kaldi_data.write_keyed_text(dict(sorted(merged.items())),
                                        os.path.join(out_dir, "wav.scp"))
            logging.info("merged %d shards -> %s/wav.scp", num_shards, out_dir)
    else:
        kaldi_data.write_keyed_text(new_wav_scp, os.path.join(out_dir, "wav.scp"))
    logging.info("anonymized %d utterances -> %s", len(new_wav_scp), out_dir)
    return out_dir
