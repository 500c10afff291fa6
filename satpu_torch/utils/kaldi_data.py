"""Kaldi-style data-directory IO, dependency-free (a copy of
``satpu.utils.kaldi_data``; WAV files are written as PCM16 only).

wav.scp (including piped ``cmd |`` entries, and offset reads), two-column
tables, utt2len / utt2dur (computed and written when missing), RIFF WAV
decoding (PCM8/16/24/32, float32/64) and PCM16 encoding, the subset /
combine of whole data dirs (kaldi's subset_data_dir.sh / combine_data.sh),
scp shards (``split_scp``) and the ``WavScpDataset`` of lazily loaded
``WavInfo`` records.
"""
from __future__ import annotations

import os
import struct
import subprocess
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from .config import split_dict as split_scp  # noqa: F401  n contiguous shards of an scp


def parse_wav_bytes(data: bytes) -> Tuple[np.ndarray, int]:
    """RIFF/WAVE bytes -> (float32 samples [C, N] scaled to [-1, 1], rate)."""
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError("not a RIFF/WAVE stream")
    pos = 12
    fmt = None
    payload = None
    n = len(data)
    while pos + 8 <= n:
        chunk_id = data[pos:pos + 4]
        (chunk_sz,) = struct.unpack("<I", data[pos + 4:pos + 8])
        body = data[pos + 8:pos + 8 + chunk_sz]
        if chunk_id == b"fmt ":
            fmt = struct.unpack("<HHIIHH", body[:16])
        elif chunk_id == b"data":
            payload = body
            # piped wavs sometimes declare a 0 or -1 data size; take the rest
            if chunk_sz in (0, 0xFFFFFFFF) or len(body) < chunk_sz:
                payload = data[pos + 8:]
        pos += 8 + chunk_sz + (chunk_sz & 1)
        if fmt is not None and payload is not None:
            break
    if fmt is None or payload is None:
        raise ValueError("WAVE stream missing fmt/data chunk")
    audio_format, channels, rate, _, _, bits = fmt
    if audio_format == 0xFFFE:  # WAVE_FORMAT_EXTENSIBLE
        audio_format = 1 if bits in (8, 16, 24, 32) else 3
    if audio_format == 1:  # PCM
        if bits == 16:
            x = np.frombuffer(payload, dtype="<i2").astype(np.float32) / 32768.0
        elif bits == 32:
            x = np.frombuffer(payload, dtype="<i4").astype(np.float32) / 2147483648.0
        elif bits == 8:
            x = (np.frombuffer(payload, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
        elif bits == 24:
            b = np.frombuffer(payload, dtype=np.uint8).reshape(-1, 3)
            x = (b[:, 0].astype(np.int32) | (b[:, 1].astype(np.int32) << 8)
                 | (b[:, 2].astype(np.int32) << 16))
            x = (x - ((x & 0x800000) << 1)).astype(np.float32) / 8388608.0
        else:
            raise ValueError(f"unsupported PCM bit depth {bits}")
    elif audio_format == 3:  # IEEE float
        x = np.frombuffer(payload, dtype="<f4" if bits == 32 else "<f8").astype(np.float32)
    else:
        raise ValueError(f"unsupported WAVE format tag {audio_format}")
    if channels > 1:
        x = x[:(len(x) // channels) * channels].reshape(-1, channels).T
    else:
        x = x.reshape(1, -1)
    return np.ascontiguousarray(x), rate


def wav_bytes(samples: np.ndarray, rate: int) -> bytes:
    """Mono/multichannel float32 [-1, 1] samples -> PCM16 RIFF/WAV bytes."""
    x = np.asarray(samples)
    if x.ndim == 1:
        x = x[None, :]
    channels, _ = x.shape
    pcm = np.clip(x.T.reshape(-1) * 32768.0, -32768, 32767).astype("<i2").tobytes()
    bits, fmt_tag = 16, 1
    byte_rate = rate * channels * bits // 8
    block_align = channels * bits // 8
    head = (b"RIFF" + struct.pack("<I", 36 + len(pcm)) + b"WAVE" + b"fmt "
            + struct.pack("<IHHIIHH", 16, fmt_tag, channels, rate, byte_rate,
                          block_align, bits)
            + b"data" + struct.pack("<I", len(pcm)))
    return head + pcm


def write_wav(path: str, samples: np.ndarray, rate: int) -> None:
    """Write float32 [-1, 1] samples as a PCM16 WAV file."""
    with open(path, "wb") as f:
        f.write(wav_bytes(samples, rate))


def load_wav_from_scp(entry: str, frame_offset: int = 0,
                      num_frames: int = -1) -> Tuple[np.ndarray, int]:
    """Audio of a wav.scp entry (plain path or piped command ending in ``|``)
    -> (float32 [C, N], sample rate); with ``frame_offset`` / ``num_frames``
    (-1: to the end) only those samples."""
    entry = entry.strip()
    if entry.endswith("|"):
        data = subprocess.run(entry[:-1], shell=True, check=True,
                              stdout=subprocess.PIPE).stdout
        wav, rate = parse_wav_bytes(data)
    else:
        with open(entry, "rb") as f:
            wav, rate = parse_wav_bytes(f.read())
    if frame_offset or num_frames >= 0:
        end = frame_offset + num_frames if num_frames >= 0 else wav.shape[1]
        wav = wav[:, frame_offset:end]
    return wav, rate


def read_wav_scp(wav_scp: str) -> Dict[str, str]:
    """wav.scp -> {utt: command_or_path}."""
    utt2wav: Dict[str, str] = {}
    with open(wav_scp) as f:
        for line in f:
            parts = line.strip().split()
            if parts:
                utt2wav[parts[0]] = " ".join(parts[1:])
    return utt2wav


def read_keyed_text(path: str) -> Dict[str, str]:
    """Generic two-column kaldi table (utt2spk, text, utt2dur, ...)."""
    out: Dict[str, str] = {}
    with open(path) as f:
        for line in f:
            parts = line.strip().split(None, 1)
            if parts:
                out[parts[0]] = parts[1] if len(parts) > 1 else ""
    return out


def read_utt2len_file(path: str) -> Dict[str, int]:
    """utt2len -> {utt: number of samples}."""
    return {k: int(float(v)) for k, v in read_keyed_text(path).items()}


def gen_utt2len(wav_scp_path: str, out_path: Optional[str] = None) -> Dict[str, int]:
    """Number of samples per utterance; written as utt2len when ``out_path``."""
    utt2len = {}
    for utt, entry in read_wav_scp(wav_scp_path).items():
        utt2len[utt] = load_wav_from_scp(entry)[0].shape[1]
    if out_path:
        write_keyed_text({k: str(v) for k, v in utt2len.items()}, out_path)
    return utt2len


def get_utt2dur(data_dir: str) -> Dict[str, float]:
    """Seconds per utterance from ``<data_dir>/utt2dur``; computed from
    wav.scp and written there when the file is missing."""
    path = os.path.join(data_dir, "utt2dur")
    if os.path.exists(path):
        return {k: float(v) for k, v in read_keyed_text(path).items()}
    utt2dur = {}
    for utt, entry in read_wav_scp(os.path.join(data_dir, "wav.scp")).items():
        wav, rate = load_wav_from_scp(entry)
        utt2dur[utt] = wav.shape[1] / rate
    write_keyed_text({k: f"{v:.6f}" for k, v in utt2dur.items()}, path)
    return utt2dur


def write_keyed_text(table: Dict[str, str], path: str) -> None:
    with open(path, "w") as f:
        for k in sorted(table):
            f.write(f"{k} {table[k]}\n")


def copy_data_dir(src: str, dest: str) -> None:
    """Copy the standard kaldi tables of a data dir (not the audio)."""
    os.makedirs(dest, exist_ok=True)
    for name in ("wav.scp", "utt2spk", "spk2utt", "text", "utt2dur", "utt2len", "spk2gender"):
        p = os.path.join(src, name)
        if os.path.exists(p):
            with open(p) as fi, open(os.path.join(dest, name), "w") as fo:
                fo.write(fi.read())


def spk2utt_from_utt2spk(utt2spk: Dict[str, str]) -> Dict[str, List[str]]:
    spk2utt: Dict[str, List[str]] = {}
    for utt, spk in utt2spk.items():
        spk2utt.setdefault(spk, []).append(utt)
    return spk2utt


def filter_scp(keep_keys, scp: Dict[str, str]) -> Dict[str, str]:
    keep = set(keep_keys)
    return {k: v for k, v in scp.items() if k in keep}


_UTT_TABLES = ("wav.scp", "utt2spk", "text", "utt2dur", "utt2len")


def subset_data_dir(src: str, utt_keep, dest: str) -> None:
    """Kaldi ``utils/subset_data_dir.sh --utt-list``: keep only ``utt_keep``
    rows of every per-utterance table, regenerate spk2gender/spk2utt for the
    surviving speakers (reference egs/anon/vctk/local/data_prep_vpc.sh:36-62
    builds the VPC enroll/trial subsets this way)."""
    keep = set(utt_keep)
    os.makedirs(dest, exist_ok=True)
    spks = set()
    for name in _UTT_TABLES:
        p = os.path.join(src, name)
        if not os.path.exists(p):
            continue
        table = filter_scp(keep, read_keyed_text(p))
        write_keyed_text(table, os.path.join(dest, name))
        if name == "utt2spk":
            spks = set(table.values())
            write_keyed_text(
                {s: " ".join(us) for s, us in
                 sorted(spk2utt_from_utt2spk(table).items())},
                os.path.join(dest, "spk2utt"))
    g = os.path.join(src, "spk2gender")
    if os.path.exists(g) and spks:
        write_keyed_text(filter_scp(spks, read_keyed_text(g)),
                         os.path.join(dest, "spk2gender"))


def combine_data_dirs(dest: str, srcs) -> None:
    """Kaldi ``utils/combine_data.sh``: concatenate the per-utterance tables
    of ``srcs`` (first occurrence wins on duplicate utts), regenerate
    spk2utt/spk2gender."""
    os.makedirs(dest, exist_ok=True)
    for name in _UTT_TABLES + ("spk2gender",):
        merged: Dict[str, str] = {}
        found = False
        for src in srcs:
            p = os.path.join(src, name)
            if os.path.exists(p):
                found = True
                for k, v in read_keyed_text(p).items():
                    merged.setdefault(k, v)
        if found:
            write_keyed_text(dict(sorted(merged.items())),
                             os.path.join(dest, name))
        if name == "utt2spk" and found:
            write_keyed_text(
                {s: " ".join(us) for s, us in
                 sorted(spk2utt_from_utt2spk(merged).items())},
                os.path.join(dest, "spk2utt"))


# ---------------------------------------------------------------------------
# WavScp dataset (reference utils/wav_scp_dataset.py)
# ---------------------------------------------------------------------------


@dataclass
class WavInfo:
    """One utterance: name + wav.scp entry, audio loaded lazily."""

    name: str
    filename: str
    wav: Optional[np.ndarray] = field(default=None, repr=False)
    sample_rate: int = 16000

    def load(self) -> np.ndarray:
        if self.wav is None:
            self.wav, self.sample_rate = load_wav_from_scp(self.filename)
        return self.wav


class WavScpDataset:
    """Iterates WavInfo records over a wav.scp."""

    def __init__(self, utt2wav: Dict[str, str]):
        self.utt2wav = utt2wav
        self.utts = list(utt2wav.keys())

    @classmethod
    def from_wav_scpfile(cls, wav_scp: str) -> "WavScpDataset":
        return cls(read_wav_scp(wav_scp))

    def __len__(self) -> int:
        return len(self.utts)

    def __getitem__(self, i: int) -> WavInfo:
        utt = self.utts[i]
        info = WavInfo(name=utt, filename=self.utt2wav[utt])
        info.load()
        return info

    def __iter__(self) -> Iterator[WavInfo]:
        for i in range(len(self)):
            yield self[i]


def parse_wavinfo_wav(wavinfo) -> np.ndarray:
    """Accept WavInfo or raw array, return [C, N] float32 audio."""
    if isinstance(wavinfo, WavInfo):
        return wavinfo.load()
    x = np.asarray(wavinfo, dtype=np.float32)
    return x[None, :] if x.ndim == 1 else x
