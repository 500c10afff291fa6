"""Synthetic noise and RIR databases for the augmentation tests: a few
speech / music / noise wavs and two room impulse responses, made from a
seed, with the databases as ``ops.augment.load_augmentation`` reads them
(the .json beside each named csv)."""
import json
import os

import numpy as np

PIPELINE = ["none", "add_reverb", "add_noise", "phone_filtering", "codec", "speed_perturb"]


def write_aug_dbs(root: str, seed: int = 0, fs: int = 16000) -> dict:
    """Write the wavs and databases under ``root``; returns {"noise_db",
    "rir_db", "noise_csv", "rir_csv", "inline"} where ``inline`` is a lenient
    JSON ``augmentation`` option over every pipeline key (trailing commas and
    a comment included)."""
    from satpu_torch.utils import kaldi_data

    r = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    t = np.arange(fs * 2) / fs
    noise_db = {"speech": [], "music": [], "noise": []}
    for kind, n in (("speech", 5), ("music", 2), ("noise", 3)):
        for k in range(n):
            seconds = 0.4 if k == 0 else 2.0  # one shorter than a crop: tiled
            m = int(seconds * fs)
            if kind == "music":
                x = 0.3 * np.sin(2 * np.pi * (220 + 110 * k) * t[:m])
            elif kind == "speech":
                x = 0.2 * np.sin(2 * np.pi * (120 + 30 * k) * t[:m]) * (1 + np.sin(2 * t[:m]))
            else:
                x = np.zeros(m)
            x = (x + r.standard_normal(m) * 0.05).astype(np.float32)
            p = os.path.join(root, f"{kind}{k}.wav")
            kaldi_data.write_wav(p, x, fs)
            noise_db[kind].append(p)
    rir_db = []
    for k in range(2):
        n = 800 + 400 * k
        h = r.standard_normal(n) * np.exp(-np.arange(n) / (120.0 + 80 * k))
        h[0] = 1.0
        p = os.path.join(root, f"rir{k}.wav")
        kaldi_data.write_wav(p, (0.5 * h / np.abs(h).max()).astype(np.float32), fs)
        rir_db.append(p)
    noise_csv, rir_csv = os.path.join(root, "musan.csv"), os.path.join(root, "reverb.csv")
    for csv, db in ((noise_csv, noise_db), (rir_csv, rir_db)):
        with open(os.path.splitext(csv)[0] + ".json", "w") as f:
            json.dump(db, f)
    inline = ('{"pipeline": ' + json.dumps(PIPELINE) + ', "aug_number": 2,  // two a crop\n'
              ' "add_noise": {"noise_db_csv": "' + noise_csv + '",},'
              ' "add_reverb": {"rir_db_csv": "' + rir_csv + '"},}')
    return {"noise_db": noise_db, "rir_db": rir_db, "noise_csv": noise_csv,
            "rir_csv": rir_csv, "inline": inline}
