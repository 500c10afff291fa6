"""satpu_torch anonymize CLI and pipeline on the CPU: the CLI's wavs equal
the port's direct convert, shards merge, target selection and buckets
behave like satpu's."""
import os
import random

import numpy as np
import pytest
import torch

from torch_parity import ANON_TINY, ASRBN_TINY, harmonic

SPEAKERS = ["spkA", "spkB", "spkC"]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    from satpu_torch import infer_helper
    from satpu_torch.utils import kaldi_data

    root = tmp_path_factory.mktemp("anon")
    build = {"asrbn": dict(ASRBN_TINY), **ANON_TINY}
    model = infer_helper.build_model("anonymizer_tdnnf_hifigan", device="cpu", seed=0, **build)
    ckpt = str(root / "anon.pt")
    infer_helper.save_model(ckpt, "anonymizer_tdnnf_hifigan", build, model.state_dict(),
                            extra_meta={"speakers": SPEAKERS})
    data = str(root / "data")
    os.makedirs(data)
    wav_scp, utt2spk, wavs = {}, {}, {}
    for i, (n, f0) in enumerate([(9000, 120.0), (12000, 180.0), (15500, 230.0)]):
        x, _ = harmonic(n, f0, seed=i)
        p = str(root / f"u{i}.wav")
        kaldi_data.write_wav(p, x, 16000)
        wavs[f"utt{i}"] = kaldi_data.load_wav_from_scp(p)[0][0]  # as the pipeline reads it
        wav_scp[f"utt{i}"], utt2spk[f"utt{i}"] = p, f"src{i % 2}"
    kaldi_data.write_keyed_text(wav_scp, os.path.join(data, "wav.scp"))
    kaldi_data.write_keyed_text(utt2spk, os.path.join(data, "utt2spk"))
    return root, ckpt, data, wavs


def test_cli_outputs_equal_direct_convert(setup):
    from satpu_torch import infer_helper
    from satpu_torch.bin.anonymize import main
    from satpu_torch.utils import kaldi_data

    root, ckpt, data, wavs = setup
    rc = main(["--checkpoint", ckpt, "--directory", data, "--device", "cpu",
               "--batch-size", "4", "--target-selection-algorithm", "constant",
               "--target-constant-spkid", "spkB", "--results-dir", str(root / "wavs")])
    assert rc == 0
    out_dir = data + "_anon"
    scp = kaldi_data.read_wav_scp(os.path.join(out_dir, "wav.scp"))
    assert sorted(scp) == sorted(wavs)
    assert os.path.exists(os.path.join(out_dir, "utt2spk"))

    # the same padded batch (bucket 16000, batch 4) through convert directly
    model, _ = infer_helper.load_model(ckpt, device="cpu",
                                       option_args=infer_helper.serving_option_args())
    utts = sorted(wavs, key=lambda u: len(wavs[u]))
    batch = np.zeros((4, 16000), np.float32)
    for j, u in enumerate(utts):
        batch[j, :len(wavs[u])] = wavs[u]
    with torch.no_grad():
        w = torch.from_numpy(batch)
        direct = model.convert(w, model.get_f0(w), torch.full((4,), 1)).numpy()
    for j, u in enumerate(utts):
        got, rate = kaldi_data.load_wav_from_scp(scp[u])
        assert rate == 16000 and got.shape == (1, len(wavs[u]))
        # the CLI writes PCM16: equal up to one quantization step
        want = np.clip(direct[j, :len(wavs[u])], -1.0, 1.0)
        assert np.abs(got[0] - want).max() <= 1.5 / 32768
        assert np.abs(got[0]).max() > 0


def test_cli_defaults_to_cuda(setup, monkeypatch, capsys):
    from satpu_torch.bin.anonymize import main

    _, ckpt, data, _ = setup
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--checkpoint", ckpt, "--directory", data])
    assert main(["--directory", data]) == 2  # no checkpoint


@pytest.mark.parametrize("flag", [("--serve-mesh", "true", "device count \\(2\\)")],
                         ids=["serve_mesh"])
def test_unported_serving_flags_raise(setup, flag, monkeypatch):
    """satpu splits each batch over the cards on this flag and refuses a
    batch size their count does not divide (satpu/bin/pipeline.py:156-159);
    so does the port (two cards faked here), before any output."""
    import satpu_torch
    from satpu_torch.bin.anonymize import AnonymizeOpts, main

    _, ckpt, data, _ = setup
    name, value, match = flag
    monkeypatch.setattr(satpu_torch, "resolve_device", lambda d: torch.device("cuda"))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(ValueError, match=match):
        main(["--checkpoint", ckpt, "--directory", data, name, value, "--batch-size", "3",
              "--new-datadir-suffix", "_refused"])
    assert not os.path.exists(data + "_refused")
    # one process on one device: the defaults run
    opts = AnonymizeOpts().load_from_args(["--num-procs", "1", "--serve-mesh", "false"])
    assert (opts.num_procs, opts.serve_mesh) == (1, False)


def test_sharded_runs_merge(setup):
    from satpu_torch import infer_helper
    from satpu_torch.bin.pipeline import process_data
    from satpu_torch.utils import kaldi_data

    root, ckpt, data, wavs = setup
    model, meta = infer_helper.load_model(ckpt, device="cpu")
    for shard in range(2):
        out_dir = process_data(model, meta["speakers"], data, str(root / "wavs_sh"),
                               target_selection_algorithm="random_per_utt", batch_size=2,
                               buckets=(8000, 16000), num_shards=2, shard=shard,
                               new_datadir_suffix="_anon_sh")
    assert sorted(kaldi_data.read_wav_scp(os.path.join(out_dir, "wav.scp"))) == sorted(wavs)


def test_speaker_f0_norm_is_refused(setup):
    from satpu_torch import infer_helper
    from satpu_torch.bin.pipeline import process_data

    root, _, data, _ = setup
    model = infer_helper.build_model("anonymizer_tdnnf_hifigan", device="cpu",
                                     asrbn=dict(ASRBN_TINY), f0_norm="none", **ANON_TINY)
    # a model that takes speaker-normalized F0 is served only with the
    # statistics (train_vc stores them in the checkpoint; see
    # test_torch_train_vc.py for the served path)
    with pytest.raises(ValueError, match="f0_speaker_stats"):
        process_data(model, SPEAKERS, data, str(root / "wavs_none"))


@pytest.mark.parametrize("algorithm", ["constant", "none", "bad_for_evaluation",
                                       "random_per_utt", "random_per_spk_uniq",
                                       "random_per_spk"])
def test_select_targets_matches_satpu(algorithm):
    from satpu.bin.pipeline import select_targets as jselect
    from satpu_torch.bin.pipeline import select_targets

    utids = [f"u{i}" for i in range(6)]
    utt2spk = {u: f"s{i % 3}" for i, u in enumerate(utids)}
    targets = ["a", "b", "c", "d", "s0", "s1", "s2"]
    got = select_targets(utids, algorithm, targets, utt2spk, {}, "b", random.Random(5))
    want = jselect(utids, algorithm, targets, utt2spk, {}, "b", random.Random(5))
    assert got == want
    with pytest.raises(ValueError):
        select_targets(utids, "bogus", targets, utt2spk, {})


@pytest.mark.parametrize("n,want", [(100, 200), (200, 200), (401, 800), (1201, 1600)])
def test_bucket_for(n, want):
    from satpu_torch.bin.pipeline import bucket_for

    assert bucket_for(n, (200, 400)) == want


def test_ini_config_and_flags(tmp_path, monkeypatch):
    from satpu_torch.bin.anonymize import AnonymizeOpts
    from satpu_torch.utils.config import load_ini

    ini = tmp_path / "anon.ini"
    ini.write_text("[var]\nroot = /data\n[anonymize]\ndirectory = ${:root}/dev  # comment\n"
                   "batch_size = 8\n")
    opts = AnonymizeOpts().load_from_config(load_ini(str(ini))["anonymize"])
    assert (opts.directory, opts.batch_size) == ("/data/dev", 8)
    opts.load_from_args(["--batch-size", "16", "--device", "cpu"])
    assert (opts.batch_size, opts.device) == (16, "cpu")
    monkeypatch.setenv("root", "/env")
    assert load_ini(str(ini))["anonymize"]["directory"] == "/env/dev"


@pytest.mark.parametrize("subtype", ["pcm16", "float32"])
def test_wav_codec_matches_satpu(subtype):
    """the port decodes what satpu encodes, and encodes PCM16 as satpu does."""
    from satpu.utils import kaldi_data as jkd
    from satpu_torch.utils import kaldi_data

    x = (np.random.default_rng(0).random((2, 100)) - 0.5).astype(np.float32)
    data = jkd.wav_bytes(x, 8000, subtype)
    back, rate = kaldi_data.parse_wav_bytes(data)
    want, _ = jkd.parse_wav_bytes(data)
    assert rate == 8000 and back.shape == x.shape
    np.testing.assert_array_equal(back, want)
    if subtype == "pcm16":
        assert kaldi_data.wav_bytes(x, 8000) == data
