"""Augmentation database preparation — the reference's
egs/share/dataprep_aug.py without the download stage (this environment has no
egress; point it at already-downloaded MUSAN / RIRS_NOISES trees).

Produces:
- ``--make-csv-augment-noise``: sidekit-style musan csv
  (database,type,file_id,start,duration) + the satpu noise_db JSON
  ({"speech"|"music"|"noise": [wav paths]}) consumed by
  satpu_torch.ops.augment.data_augmentation;
- ``--make-csv-augment-reverb``: RIR csv (channel,database,file_id,type) +
  the rir_db JSON ([wav paths]);
- ``--split-musan``: 5-second split copies (dataprep_aug.py:185-198) so noise
  segments load with bounded IO.

Usage:
  python -m satpu_torch.bin.prepare_aug --from data/musan --make-csv-augment-noise \\
      --out-csv data/musan.csv
"""
from __future__ import annotations

import argparse
import csv
import json
import logging
import os
import sys

from ..utils import kaldi_data


def walk_wavs(root: str):
    for dirpath, _, files in os.walk(root):
        for f in sorted(files):
            if f.endswith(".wav"):
                yield os.path.join(dirpath, f)


def dataset_of(path: str, root: str) -> str:
    rel = os.path.relpath(path, root)
    return rel.split(os.sep)[0]


def make_noise_csv(root: str, out_csv: str) -> dict:
    os.makedirs(os.path.dirname(os.path.abspath(out_csv)), exist_ok=True)
    db = {}
    with open(out_csv, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["database", "type", "file_id", "start", "duration"])
        for p in walk_wavs(root):
            kind = dataset_of(p, root)
            wav, rate = kaldi_data.load_wav_from_scp(p)
            dur = wav.shape[1] / rate
            w.writerow(["musan", kind, os.path.splitext(os.path.abspath(p))[0],
                        0.0, f"{dur:.3f}"])
            db.setdefault(kind, []).append(os.path.abspath(p))
    with open(os.path.splitext(out_csv)[0] + ".json", "w") as f:
        json.dump(db, f, indent=1)
    return db


def make_reverb_csv(root: str, out_csv: str) -> list:
    os.makedirs(os.path.dirname(os.path.abspath(out_csv)), exist_ok=True)
    paths = []
    with open(out_csv, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["channel", "database", "file_id", "type"])
        for p in walk_wavs(root):
            w.writerow([1.0, "REVERB",
                        os.path.splitext(os.path.abspath(p))[0],
                        dataset_of(p, root)])
            paths.append(os.path.abspath(p))
    with open(os.path.splitext(out_csv)[0] + ".json", "w") as f:
        json.dump(paths, f, indent=1)
    return paths


def split_musan(root: str, out_root: str, seg_sec: float = 5.0) -> int:
    """5-second segment copies (dataprep_aug.py:185-198)."""
    import numpy as np

    n = 0
    for p in walk_wavs(root):
        wav, rate = kaldi_data.load_wav_from_scp(p)
        x = wav[0]
        seg = int(rate * seg_sec)
        rel = os.path.splitext(os.path.relpath(p, root))[0]
        outdir = os.path.join(out_root, rel)
        os.makedirs(outdir, exist_ok=True)
        for st in range(0, max(len(x) - seg, 0) or (1 if len(x) else 0), seg):
            kaldi_data.write_wav(os.path.join(outdir, f"{st // rate:05d}.wav"),
                                 x[st : st + seg].astype(np.float32), rate)
            n += 1
    return n


def main(argv=None):
    logging.basicConfig(level=logging.INFO, format="satpu_torch %(levelname)s: %(message)s")
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--from", dest="root", required=True)
    p.add_argument("--out-csv", default="list/list.csv")
    p.add_argument("--make-csv-augment-noise", action="store_true")
    p.add_argument("--make-csv-augment-reverb", action="store_true")
    p.add_argument("--split-musan", default="", help="output dir for 5s splits")
    args = p.parse_args(argv)
    if args.split_musan:
        n = split_musan(args.root, args.split_musan)
        logging.info("wrote %d segments under %s", n, args.split_musan)
    if args.make_csv_augment_noise:
        db = make_noise_csv(args.root, args.out_csv)
        logging.info("noise db: %s", {k: len(v) for k, v in db.items()})
    if args.make_csv_augment_reverb:
        paths = make_reverb_csv(args.root, args.out_csv)
        logging.info("rir db: %d files", len(paths))
    return 0


if __name__ == "__main__":
    sys.exit(main())
