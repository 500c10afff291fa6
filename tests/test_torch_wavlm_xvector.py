"""The x-vector models with the WavLM frontend (``frontend="wavlm"``)
against satpu's on the CPU, and ``eval_anon`` with such a judge. A small
WavLM (large-style: layer-norm extractor with conv biases, pre-norm; hidden
32, 2 layers, 4 heads, 16-channel convs of total stride 320) feeds the
ECAPA (32 channels) or the half-ResNet (pooling over 32 // 8 = 4 bands),
16-d embeddings over 10 speakers, satpu's random weights with randomized
norms carried across by ``convert.from_satpu_xvector``.

- eval forward from wav: x-vectors max abs 1e-3 and cosine >= 0.9999,
  logits rel 1e-3 (as the mel frontends' in ``test_torch_sidekit.py``);
- the trunk's input width is WavLM's hidden size, the frontend has no
  SpecAugment, and it is trained (``train()`` changes nothing in it);
- the ``eval_anon`` CLI on a satpu checkpoint of this judge (its WavLM
  config as a dict in the build params) gives satpu's ``asv_test`` metrics
  on satpu's model within 1e-6 (the same EER), with the ArcMargin centres
  as the AS-norm cohort, and the same ranking of the trial scores.
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from torch_parity import bridged, rel_err, satpu_apply, satpu_init

WAVLM = dict(conv_dim=(16, 16, 16), conv_kernel=(10, 8, 4), conv_stride=(5, 8, 8),
             hidden_size=32, num_hidden_layers=2, num_attention_heads=4, intermediate_size=64,
             num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4, num_buckets=32,
             max_bucket_distance=50, feat_extract_norm="layer", conv_bias=True)
XV = dict(num_speakers=10, channels=32, embedding_size=16, frontend="wavlm")


def satpu_wavlm_xvector(arch, seed=0):
    """(satpu model, its randomized numpy variables, the port's model with
    them, the port's build params)."""
    from satpu.models.wavlm import WavLMConfig as JW
    from satpu.sidekit.xvector import XVectorConfig as JCfg
    from satpu.sidekit.xvector import build_xvector as jbuild
    from satpu_torch.sidekit.xvector import XVectorConfig, build_xvector

    jm = jbuild(JCfg(arch=arch, wavlm=JW(**WAVLM), **XV))
    v = satpu_init(jm, np.zeros((1, 8000), np.float32), train=False, seed=seed)
    params = dict(XV, arch=arch, wavlm=dict(WAVLM))
    return jm, v, bridged(build_xvector(XVectorConfig(**params)), v), params


def _signals(n, T, seed):
    r = np.random.default_rng(seed)
    t = np.arange(T) / 16000
    return np.stack([(0.2 * np.sin(2 * np.pi * (110 + 40 * i) * t)
                      + 0.05 * r.standard_normal(T)).astype(np.float32) for i in range(n)])


@pytest.mark.parametrize("arch", ["ecapa", "resnet"])
def test_wavlm_xvector_from_wav_matches_satpu(arch):
    jm, v, pm, _ = satpu_wavlm_xvector(arch)
    wav = _signals(3, 12000, seed=7)
    (_, ref_logits), ref = satpu_apply(jm, v, wav, train=False)
    ref = np.asarray(ref)
    with torch.no_grad():
        (_, logits), out = pm(torch.from_numpy(wav))
    out = out.numpy()
    assert out.shape == ref.shape == (3, 16 if arch == "ecapa" else 256)  # ResNet: 256-d
    assert np.abs(out - ref).max() <= 1e-3, np.abs(out - ref).max()
    cos = (out * ref).sum(1) / np.linalg.norm(out, axis=1) / np.linalg.norm(ref, axis=1)
    assert cos.min() >= 0.9999, cos
    assert rel_err(logits.numpy(), ref_logits) <= 1e-3
    # the trunk takes WavLM's hidden size; no SpecAugment on this frontend
    first = pm.sequence_network.layer1 if arch == "ecapa" else None
    assert pm.in_feat == 32
    if first is not None:
        assert first.conv.weight.shape[1] == 32
    x = torch.from_numpy(wav)
    with torch.no_grad():
        feats_eval = pm.features(x)
        g = torch.Generator().manual_seed(0)
        feats_train = pm.train().features(x, generator=g)
    pm.eval()
    assert feats_eval.shape == (3, 32, 37)
    assert torch.equal(feats_eval, feats_train)
    assert pm.preprocessor.feature_weight.requires_grad


def test_eval_anon_with_a_wavlm_judge_gives_satpus_eer(tmp_path):
    from satpu import infer_helper as jhelper
    from satpu.sidekit.trainer import asv_test as jtest
    from satpu.sidekit.trainer import extract_xvectors as jextract
    from satpu_torch.bin import eval_anon
    from satpu_torch.sidekit import scoring
    from satpu_torch.sidekit.trainer import extract_xvectors
    from satpu_torch.utils import kaldi_data

    jm, v, pm, params = satpu_wavlm_xvector("ecapa", seed=4)
    ckpt = str(tmp_path / "asv.ckpt")
    jhelper.save_model(ckpt, "asv_xvector", params, v)  # satpu's msgpack file

    def write_dir(name, wavs, utt2spk):
        d = tmp_path / name
        os.makedirs(d)
        scp = {}
        for u, w in wavs.items():
            scp[u] = str(d / f"{u}.wav")
            kaldi_data.write_wav(scp[u], w, 16000)
        kaldi_data.write_keyed_text(scp, str(d / "wav.scp"))
        kaldi_data.write_keyed_text(utt2spk, str(d / "utt2spk"))
        return str(d)

    sig = _signals(9, 20000, seed=11)
    enroll = {f"s{s}-e{i}": sig[3 * s + i][:14000 + 2000 * i] for s in range(3) for i in range(2)}
    trial = {f"t{j}": sig[3 * j + 2][:12000 + 3000 * j] for j in range(3)}
    enroll_dir = write_dir("enroll", enroll, {u: u.split("-")[0] for u in enroll})
    data_dir = write_dir("data", trial, {u: u for u in trial})
    trials = [(f"s{s}", u, s == j) for j, u in enumerate(trial) for s in range(3)]
    with open(tmp_path / "trials", "w") as f:
        f.writelines(f"{s} {u} {'target' if t else 'nontarget'}\n" for s, u, t in trials)
    results = tmp_path / "results"
    assert eval_anon.main(["--device", "cpu", "--data", data_dir, "--asv-checkpoint", ckpt,
                           "--enroll-dir", enroll_dir, "--trials", str(tmp_path / "trials"),
                           "--xvector-mode", "chunked", "--results", str(results)]) == 0
    got = json.loads((results / "results.json").read_text())["asv"]

    # satpu on the wavs as the CLI reads them back (16-bit)
    def read(d):
        scp = kaldi_data.read_wav_scp(os.path.join(d, "wav.scp"))
        return {u: kaldi_data.load_wav_from_scp(p)[0][0] for u, p in sorted(scp.items())}

    trial = read(data_dir)
    spk_wavs = {}
    for u, x in read(enroll_dir).items():
        spk_wavs.setdefault(u.split("-")[0], []).append(x)
    w = np.asarray(v["params"]["after_speaker_embedding"]["weight"])
    cohort = w / np.maximum(np.linalg.norm(w, axis=1, keepdims=True), 1e-12)
    ref = jtest(jm, v, spk_wavs, trials, trial, cohort_xv=cohort, xvector_mode="chunked")
    assert sorted(got) == sorted(ref) and "asnorm_eer" in got
    assert got["eer"] == ref["eer"]
    for k in ref:
        assert abs(got[k] - ref[k]) <= 1e-6, (k, got[k], ref[k])

    def scores(extract):
        spk = {s: extract(ws).mean(0) for s, ws in spk_wavs.items()}
        utt = dict(zip(trial, extract(list(trial.values()))))
        return scoring.cosine_scoring(np.stack([spk[s] for s, _, _ in trials]),
                                      np.stack([utt[u] for _, u, _ in trials]))

    s_port = scores(lambda ws: extract_xvectors(pm, ws, mode="chunked"))
    s_ref = scores(lambda ws: jextract(jm, v, ws, mode="chunked"))
    assert len(np.unique(s_ref)) == len(trials)  # no ties: the ranking is a test
    np.testing.assert_array_equal(np.argsort(s_port), np.argsort(s_ref))


def test_wavlm_config_forms():
    """``wavlm`` may be None (WavLM-large), a ``WavLMConfig`` or its dict."""
    from satpu_torch.models.wavlm import WavLMConfig
    from satpu_torch.sidekit.xvector import XVectorConfig, wavlm_config

    small = WavLMConfig(**WAVLM)
    assert wavlm_config(None) == WavLMConfig.large()
    assert wavlm_config(small) is small
    d = json.loads(json.dumps(dataclasses.asdict(small)))  # a checkpoint's build params
    assert wavlm_config(d) == small
    assert XVectorConfig(frontend="wavlm").wavlm is None
