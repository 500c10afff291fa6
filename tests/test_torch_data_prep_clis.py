"""The port's data-prep CLIs (numpy-only copies of satpu's
``bin/{preprocess_audio,prepare_vctk,prepare_aug}.py``) write satpu's bytes:
each CLI runs, satpu's and the port's, on its own copy of the same synthetic
kaldi dir (or MUSAN / RIR tree), and every file they write is compared byte
for byte, the output dirs' names swapped in the path tables."""
import os
import shutil

import numpy as np
import pytest


def _files(root):
    out = {}
    for d, _, fs in os.walk(root):
        for f in fs:
            p = os.path.join(d, f)
            out[os.path.relpath(p, root)] = open(p, "rb").read()
    return out


def _same(a_root, b_root, a_name, b_name):
    a, b = _files(a_root), _files(b_root)
    assert sorted(a) == sorted(b) and a
    for rel, data in a.items():
        assert b[rel] == data.replace(a_name.encode(), b_name.encode()), rel


def _wav_dir(root, rate, n=4, seconds=1.3):
    from satpu.utils import kaldi_data

    os.makedirs(root)
    rng = np.random.default_rng(0)
    wav_scp, utt2spk, text = {}, {}, {}
    for i in range(n):
        t = np.arange(int(seconds * rate)) / rate
        x = np.zeros_like(t)
        x[int(0.3 * rate):int(1.0 * rate)] = 0.3 * np.sin(2 * np.pi * (120 + 20 * i) * t[
            int(0.3 * rate):int(1.0 * rate)])
        x += rng.standard_normal(len(t)) * 1e-4
        utt = f"spk{i % 2}_{i:03d}"
        wav_scp[utt] = os.path.join(root, f"{utt}.wav")
        kaldi_data.write_wav(wav_scp[utt], x.astype(np.float32), rate)
        utt2spk[utt], text[utt] = f"spk{i % 2}", f"hello, world {i}!"
    kaldi_data.write_keyed_text(wav_scp, os.path.join(root, "wav.scp"))
    kaldi_data.write_keyed_text(utt2spk, os.path.join(root, "utt2spk"))
    kaldi_data.write_keyed_text(text, os.path.join(root, "text"))
    return root


@pytest.mark.parametrize("flags", [[], ["--trim", "true", "--pad", "true"]],
                         ids=["resample", "trim_pad"])
def test_preprocess_audio_writes_satpus_bytes(tmp_path, flags):
    from satpu.bin import preprocess_audio as J
    from satpu_torch.bin import preprocess_audio as P

    src = _wav_dir(str(tmp_path / "in24k"), 24000)
    for name, mod in (("satpu_out", J), ("port_out", P)):
        assert mod.main(["--data-dir", src, "--out-dir", str(tmp_path / name), *flags]) == 0
    _same(str(tmp_path / "satpu_out"), str(tmp_path / "port_out"), "satpu_out", "port_out")
    assert P.main(["--data-dir", src]) == 2


def test_prepare_vctk_writes_satpus_bytes(tmp_path):
    from satpu.bin import prepare_vctk as J
    from satpu_torch.bin import prepare_vctk as P
    from test_parity_cli import _vctk_like_download

    d = _vctk_like_download(tmp_path)
    for name, mod in (("satpu", J), ("port", P)):
        root = tmp_path / name
        root.mkdir()
        shutil.copytree(d, str(root / "vctk_test"))
        assert mod.main(["--data", str(root / "vctk_test")]) == 0
    _same(str(tmp_path / "satpu"), str(tmp_path / "port"), str(tmp_path / "satpu"),
          str(tmp_path / "port"))
    assert os.path.isdir(tmp_path / "port" / "vctk_test_trials_all")


def test_prepare_aug_writes_satpus_bytes(tmp_path):
    from satpu.bin import prepare_aug as J
    from satpu_torch.bin import prepare_aug as P
    from satpu.utils import kaldi_data

    musan = tmp_path / "musan"
    rng = np.random.default_rng(1)
    for kind, secs in (("music", 12.0), ("noise", 3.0), ("speech", 7.5)):
        (musan / kind).mkdir(parents=True)
        kaldi_data.write_wav(str(musan / kind / f"{kind}-0001.wav"),
                             (rng.standard_normal(int(secs * 8000)) * 0.1).astype(np.float32),
                             8000)
    for name, mod in (("satpu", J), ("port", P)):
        out = tmp_path / name
        out.mkdir()
        assert mod.main(["--from", str(musan), "--make-csv-augment-noise", "--out-csv",
                         str(out / "musan.csv"), "--split-musan", str(out / "split")]) == 0
        assert mod.main(["--from", str(musan), "--make-csv-augment-reverb", "--out-csv",
                         str(out / "rir.csv")]) == 0
    _same(str(tmp_path / "satpu"), str(tmp_path / "port"), str(tmp_path / "satpu"),
          str(tmp_path / "port"))
