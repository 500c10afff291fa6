"""The serving mesh of the port's anonymization pipeline on the CPU:
``process_data(devices=["cpu", "cpu"])`` (two replicas, each batch of 4
split into two contiguous blocks) against the unsharded run: every
utterance's waveform (before the PCM16 write) within 1e-6, and satpu's
convert on the same padded batch with the port's F0 at the convert parity
tolerance (rel 1e-4, f32); four replicas (a row each) within 1e-6 of the
unsharded run, with and without the random F0 transformation (each
replica draws its rows of the batch's noise); a batch size the device
count does not divide is refused; ``anonymize --serve-mesh true`` on one
device runs unsharded."""
import os

import numpy as np
import pytest
import torch

import jax

from torch_parity import ANON_TINY, ASRBN_TINY, harmonic, jax_variables_numpy, rel_err

SPEAKERS = ["spkA", "spkB", "spkC"]
LENGTHS = [(9000, 120.0), (12000, 180.0), (15500, 230.0), (16000, 150.0)]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    from satpu.models.anonymizer import AnonymizationNet as JNet
    from satpu.models.anonymizer import AnonymizerConfig as JCfg
    from satpu.models.asrbn import TDNNFNetConfig as JTC
    from satpu_torch.models.anonymizer import AnonymizationNet, AnonymizerConfig
    from satpu_torch.models.asrbn import TDNNFNetConfig
    from satpu_torch.models.convert import from_satpu_variables
    from satpu_torch.utils import kaldi_data

    root = tmp_path_factory.mktemp("mesh")
    data = str(root / "data")
    os.makedirs(data)
    wav_scp, utt2spk, wavs = {}, {}, {}
    for i, (n, f0) in enumerate(LENGTHS):
        x, _ = harmonic(n, f0, seed=i)
        p = str(root / f"u{i}.wav")
        kaldi_data.write_wav(p, x, 16000)
        wavs[f"utt{i}"] = kaldi_data.load_wav_from_scp(p)[0][0]
        wav_scp[f"utt{i}"], utt2spk[f"utt{i}"] = p, f"src{i % 2}"
    kaldi_data.write_keyed_text(wav_scp, os.path.join(data, "wav.scp"))
    kaldi_data.write_keyed_text(utt2spk, os.path.join(data, "utt2spk"))

    jnet = JNet(JCfg(asrbn=JTC(**ASRBN_TINY), **ANON_TINY))
    z = np.zeros((1, 16000), np.float32)
    variables = jax_variables_numpy(jnet.init(
        jax.random.PRNGKey(0), z, np.zeros((1, 50), np.float32), np.zeros((1,), np.int32),
        method=jnet.convert))
    net = AnonymizationNet(AnonymizerConfig(asrbn=TDNNFNetConfig(**ASRBN_TINY), **ANON_TINY))
    net.load_state_dict(from_satpu_variables(variables), strict=False)
    return root, data, wavs, net.eval(), jnet, variables


def _run(setup, monkeypatch, name, devices, batch_size=4, f0_transformation=""):
    """process_data's float waveforms by utterance."""
    from satpu_torch.bin import pipeline

    root, data, _, net, _, _ = setup
    written = {}
    write = pipeline.kaldi_data.write_wav

    def capture(path, x, rate):
        written[os.path.basename(path)[:-4]] = np.array(x)
        write(path, x, rate)

    monkeypatch.setattr(pipeline.kaldi_data, "write_wav", capture)
    pipeline.process_data(net, SPEAKERS, data, str(root / name), target_constant_spkid="spkB",
                          batch_size=batch_size, new_datadir_suffix=f"_{name}",
                          devices=devices, f0_transformation=f0_transformation)
    return written


def test_process_data_over_two_devices(setup, monkeypatch):
    root, data, wavs, net, jnet, variables = setup
    one = _run(setup, monkeypatch, "one", None)
    mesh = _run(setup, monkeypatch, "mesh", ["cpu", "cpu"])
    assert sorted(mesh) == sorted(wavs)
    for u in wavs:
        assert mesh[u].shape == (len(wavs[u]),)
        assert np.abs(mesh[u] - one[u]).max() <= 1e-6, u
    # satpu's convert on the same padded batch (bucket 16000, sorted by
    # length), given the port's F0
    utts = sorted(wavs, key=lambda u: len(wavs[u]))
    batch = np.zeros((4, 16000), np.float32)
    for j, u in enumerate(utts):
        batch[j, :len(wavs[u])] = wavs[u]
    with torch.no_grad():
        f0 = net.get_f0(torch.from_numpy(batch)).numpy()
    tid = np.full((4,), 1, np.int32)
    ref = np.asarray(jnet.apply(variables, batch, f0, tid, method=jnet.convert))
    for j, u in enumerate(utts):
        assert rel_err(mesh[u], ref[j, :len(wavs[u])]) <= 1e-4, u


@pytest.mark.parametrize("f0_transformation", ["", "awgn_10"])
def test_process_data_over_four_devices(setup, monkeypatch, f0_transformation):
    """A random tiny generator barely hears its F0 (the waveforms move by
    ~3e-8 under awgn), so the transformed F0 that the replicas feed their
    generators is compared too: the concatenated blocks are the unsharded
    batch's, noise included."""
    from satpu_torch.models import anonymizer

    wavs = setup[2]
    transformed = []
    transform = anonymizer.apply_f0_transformation

    def record(f0, spec, generator=None):
        out = transform(f0, spec, generator)
        transformed.append(out.clone())
        return out

    monkeypatch.setattr(anonymizer, "apply_f0_transformation", record)
    tag = f0_transformation or "plain"
    one = _run(setup, monkeypatch, f"one_{tag}", None, f0_transformation=f0_transformation)
    one_f0, transformed[:] = list(transformed), []
    mesh = _run(setup, monkeypatch, f"four_{tag}", ["cpu"] * 4,
                f0_transformation=f0_transformation)
    assert sorted(mesh) == sorted(wavs)
    for u in wavs:
        assert mesh[u].shape == (len(wavs[u]),)
        assert np.abs(mesh[u] - one[u]).max() <= 1e-6, u
    if f0_transformation:
        assert len(one_f0) == 1 and len(transformed) == 4
        assert torch.equal(torch.cat(transformed), one_f0[0])


def test_process_data_refuses_an_indivisible_batch(setup, monkeypatch):
    with pytest.raises(ValueError, match="divisible by the device count \\(2\\)"):
        _run(setup, monkeypatch, "odd", ["cpu", "cpu"], batch_size=3)


def test_cli_serve_mesh_on_one_device_runs_unsharded(setup, tmp_path):
    """satpu serves unsharded on one device (satpu/bin/pipeline.py:155)."""
    from satpu_torch import infer_helper
    from satpu_torch.bin.anonymize import main
    from satpu_torch.utils import kaldi_data

    root, data, wavs, net, _, _ = setup
    ckpt = str(tmp_path / "anon.pt")
    build = {"asrbn": dict(ASRBN_TINY), **ANON_TINY}
    infer_helper.save_model(ckpt, "anonymizer_tdnnf_hifigan", build, net.state_dict(),
                            extra_meta={"speakers": SPEAKERS})
    out = {}
    for flag in ("false", "true"):
        assert main(["--checkpoint", ckpt, "--directory", data, "--device", "cpu",
                     "--serve-mesh", flag, "--batch-size", "3", "--target-constant-spkid", "spkB",
                     "--new-datadir-suffix",
                     f"_cli_{flag}", "--results-dir", str(tmp_path / flag)]) == 0
        scp = kaldi_data.read_wav_scp(os.path.join(data + f"_cli_{flag}", "wav.scp"))
        out[flag] = {u: kaldi_data.load_wav_from_scp(p)[0] for u, p in scp.items()}
    assert sorted(out["true"]) == sorted(wavs)
    for u in wavs:
        assert np.array_equal(out["true"][u], out["false"][u])
