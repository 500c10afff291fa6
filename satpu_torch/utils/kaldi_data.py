"""Kaldi-style data-directory IO, dependency-free (the part of
``satpu.utils.kaldi_data`` that serving needs).

wav.scp (including piped ``cmd |`` entries), two-column tables, RIFF WAV
decoding (PCM8/16/24/32, float32/64) and PCM16 encoding.
"""
from __future__ import annotations

import os
import struct
import subprocess
from typing import Dict, Tuple

import numpy as np


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


def load_wav_from_scp(entry: str) -> Tuple[np.ndarray, int]:
    """Audio of a wav.scp entry (plain path or piped command ending in ``|``)
    -> (float32 [C, N], sample rate)."""
    entry = entry.strip()
    if entry.endswith("|"):
        data = subprocess.run(entry[:-1], shell=True, check=True,
                              stdout=subprocess.PIPE).stdout
        wav, rate = parse_wav_bytes(data)
    else:
        with open(entry, "rb") as f:
            wav, rate = parse_wav_bytes(f.read())
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
