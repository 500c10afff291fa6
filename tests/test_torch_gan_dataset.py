"""The port's GAN data pipeline against satpu's: ``sample_interval``,
``normalize_audio``, ``HifiGanDataset.batches`` (order, wrap-around,
one-hot) and ``FeatureCache`` round trips bit-exact; ``features`` with tiny
frozen extractors (the same weights carried across) at bn rel <= 1e-4 and F0
voicing agreement >= 99%; ``SpeakerCMVN`` exact."""
import os
import random

import numpy as np
import pytest
import torch

from torch_parity import ASRBN_TINY, harmonic, rel_err


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread: the tier-1 run shares the host's cores among its
    workers, and oversubscribed CPU convs slow down many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _seqs(rng, T):
    from satpu_torch.models.asrbn import bn_num_frames, f0_num_frames

    return [rng.standard_normal(T).astype(np.float32),
            rng.standard_normal((4, bn_num_frames(T))).astype(np.float32),
            rng.standard_normal(f0_num_frames(T)).astype(np.float32)]


@pytest.mark.parametrize("T", [17000, 19200, 33333, 48000])
def test_sample_interval_matches_satpu(T):
    from satpu.hifigan.dataset import sample_interval as jsample
    from satpu_torch.hifigan.dataset import sample_interval

    seqs = _seqs(np.random.default_rng(T), T)
    for seed in range(20):
        for seg in (16320, 3200):
            a, ia = sample_interval(seqs, seg, rng=random.Random(seed))
            b, ib = jsample(seqs, seg, rng=random.Random(seed))
            assert ia == ib
            assert all(np.array_equal(x, y) for x, y in zip(a, b))
    # max_len shorter than a segment: zero padding, start 0
    a, ia = sample_interval(seqs, T + 640, max_len=T)
    b, ib = jsample(seqs, T + 640, max_len=T)
    assert ia == ib and all(np.array_equal(x, y) for x, y in zip(a, b))


def test_normalize_audio_matches_satpu():
    from satpu.hifigan.dataset import normalize_audio as jnorm
    from satpu_torch.hifigan.dataset import normalize_audio

    x = np.random.default_rng(0).standard_normal(5000).astype(np.float32) * 0.2
    assert np.array_equal(normalize_audio(x), jnorm(x))
    z = np.zeros(10, np.float32)
    assert np.array_equal(normalize_audio(z), jnorm(z))


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    """7 utterances of 3 speakers (one shorter than the min length)."""
    from satpu_torch.utils import kaldi_data

    root = tmp_path_factory.mktemp("vcdata")
    d = str(root / "data")
    os.makedirs(d)
    wav_scp, utt2spk = {}, {}
    # multiples of 320 samples: a crop of a longer BN/F0 track (e.g. 18000
    # samples: 57 frames, 18240 samples) can run past the audio, in satpu too
    lens = [19200, 17600, 20800, 19200, 16000, 24000, 22400]
    for i, n in enumerate(lens):
        x, _ = harmonic(n, 110.0 + 20 * i, seed=i)
        utt = f"s{i % 3}-u{i}"
        p = str(root / f"{utt}.wav")
        kaldi_data.write_wav(p, x, 16000)
        wav_scp[utt], utt2spk[utt] = p, f"s{i % 3}"
    kaldi_data.write_keyed_text(wav_scp, os.path.join(d, "wav.scp"))
    kaldi_data.write_keyed_text(utt2spk, os.path.join(d, "utt2spk"))
    return root, d


def _toy_bn(wav, lengths):
    """A deterministic two-argument 'extractor' of 4 channels at 320 hops."""
    from satpu_torch.models.asrbn import bn_num_frames

    n = bn_num_frames(wav.shape[1])
    frames = np.resize(wav[0], (n, 1))[:, 0]
    return np.stack([frames * k for k in range(1, 5)]).astype(np.float32)


def _toy_f0(wav, lengths):
    from satpu_torch.models.asrbn import f0_num_frames

    n = f0_num_frames(wav.shape[1])
    return (np.abs(np.resize(wav[0], n)) * 300).astype(np.float32)


def test_batches_match_satpu(data_dir):
    from satpu.hifigan.dataset import HifiGanDataset as JDs
    from satpu_torch.hifigan.dataset import HifiGanDataset

    root, d = data_dir
    kw = dict(bn_fn=_toy_bn, f0_fn=_toy_f0, segment_size=16320, seed=3)
    port = HifiGanDataset(d, cache_dir=str(root / "c_port"), **kw)
    ref = JDs(d, cache_dir=str(root / "c_satpu"), **kw)
    assert [u.utt for u in port.utts] == [u.utt for u in ref.utts] and len(port) == 6
    for epoch in (0, 1):
        for shuffle in (True, False):
            got = list(port.batches(4, shuffle=shuffle, epoch=epoch))
            want = list(ref.batches(4, shuffle=shuffle, epoch=epoch))
            assert len(got) == len(want) == 2  # 6 utterances, the tail wrapped
            for a, b in zip(got, want):
                assert set(a) == set(b) == {"audio", "bn", "f0", "spk"}
                for k in a:
                    assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
                assert (a["spk"].sum(1) == 1).all()
    # the data-parallel slice
    a = list(port.batches(2, epoch=2, process_index=1, process_count=2))
    b = list(ref.batches(2, epoch=2, process_index=1, process_count=2))
    assert all(np.array_equal(x[k], y[k]) for x, y in zip(a, b) for k in x)


def test_feature_cache_round_trips(tmp_path):
    from satpu.utils.feature_cache import FeatureCache as JCache
    from satpu_torch.utils.feature_cache import FeatureCache

    r = np.random.default_rng(1)
    vals = {"a": r.standard_normal((4, 7)).astype(np.float32),
            "b": r.standard_normal(9).astype(np.float32)}
    for writer, reader in ((FeatureCache, JCache), (JCache, FeatureCache)):
        d = str(tmp_path / writer.__module__.split(".")[0])
        w = writer(d, "get_bn", "w0", signature="ckpt|cfg")
        for k, v in vals.items():
            assert np.array_equal(w.get_or_compute(k, lambda v=v: v), v)
        back = reader(d, "get_bn", "w0", signature="ckpt|cfg")
        for k, v in vals.items():
            assert np.array_equal(back.get(k), v)
        assert back.get("c") is None
        # another signature is another file
        assert reader(d, "get_bn", "w0", signature="other").get("a") is None
    # the same shard names (the signature's hash) on both sides
    assert sorted(os.listdir(tmp_path / "satpu_torch")) == sorted(os.listdir(tmp_path / "satpu"))
    merged = FeatureCache.merge_shards(str(tmp_path / "satpu_torch"), "get_bn")
    assert os.path.basename(merged) == "get_bn.merged.scp"


def test_features_with_tiny_extractors(data_dir):
    """Bucket-padded extraction cropped to each utterance, on both sides."""
    import jax
    import torch

    from satpu.hifigan.dataset import HifiGanDataset as JDs
    from satpu.models.anonymizer import AnonymizationNet as JAnon
    from satpu.models.asrbn import TDNNFNet as JNet
    from satpu.models.asrbn import TDNNFNetConfig as JCfg
    from satpu_torch.hifigan.dataset import HifiGanDataset
    from satpu_torch.models.anonymizer import AnonymizationNet
    from satpu_torch.models.asrbn import TDNNFNet, TDNNFNetConfig
    from satpu_torch.models.convert import from_satpu_variables
    from torch_parity import jax_variables_numpy

    root, d = data_dir
    jnet = JNet(JCfg(**ASRBN_TINY))
    jv = jax_variables_numpy(jax.jit(lambda k, w: jnet.init(k, w, method=jnet.extract_bn))(
        jax.random.PRNGKey(0), np.zeros((1, 16000), np.float32)))
    net = TDNNFNet(TDNNFNetConfig(**ASRBN_TINY))
    sd = net.state_dict()
    sd.update(from_satpu_variables(jv))
    net.load_state_dict(sd)
    net.eval()
    jbn = jax.jit(lambda w, n: jnet.apply(jv, w, lengths=n, method=jnet.extract_bn))
    jf0 = jax.jit(JAnon.get_f0)

    def satpu_bn(wav, lengths):
        return np.asarray(jbn(wav, lengths))[0].T

    def satpu_f0(wav, lengths):
        return np.asarray(jf0(wav))[0]

    def port_bn(wav, lengths):
        with torch.no_grad():
            return net.extract_bn(torch.from_numpy(wav), torch.from_numpy(lengths))[0].T.numpy()

    def port_f0(wav, lengths):
        return AnonymizationNet.get_f0(torch.from_numpy(wav))[0].numpy()

    port = HifiGanDataset(d, bn_fn=port_bn, f0_fn=port_f0, cache_dir=str(root / "f_port"))
    ref = JDs(d, bn_fn=satpu_bn, f0_fn=satpu_f0, cache_dir=str(root / "f_satpu"))
    voiced_same = total = 0
    for i in range(len(port)):
        a, b = port.features(i), ref.features(i)
        assert np.array_equal(a[0], b[0]) and a[3] == b[3]
        assert a[1].shape == b[1].shape and a[2].shape == b[2].shape
        assert rel_err(a[1], b[1]) <= 1e-4
        voiced_same += int(((a[2] > 0) == (b[2] > 0)).sum())
        total += a[2].size
    assert voiced_same / total >= 0.99
    # the second pass reads the cache
    port.bn_fn = port.f0_fn = None
    assert np.array_equal(port.features(0)[1], HifiGanDataset(
        d, bn_fn=port_bn, f0_fn=port_f0, cache_dir=str(root / "f_port")).features(0)[1])


def test_speaker_cmvn_matches_satpu():
    from satpu.ops.cmvn import SpeakerCMVN as JCmvn
    from satpu_torch.ops.cmvn import SpeakerCMVN

    r = np.random.default_rng(2)
    feats = []
    for i in range(6):
        f = (r.uniform(80, 250, 50)).astype(np.float32)
        f[r.random(50) < 0.3] = 0.0
        feats.append((f, f"spk{i % 2}"))
    for keep_zeros in (True, False):
        a, b = SpeakerCMVN(keep_zeros), JCmvn(keep_zeros)
        for f, s in feats:
            a.accumulate(f, s)
            b.accumulate(f, s)
        assert a.stats == b.stats and a.mean_std("spk0") == b.mean_std("spk0")
        for f, s in feats:
            assert np.array_equal(a(f, s), b(f, s))
        with pytest.raises(KeyError):
            a(feats[0][0], "unseen")
        c = SpeakerCMVN.from_meta(b.to_meta())
        c.pass_through = True
        assert c(feats[0][0], "unseen") is feats[0][0]
        assert np.array_equal(c(*feats[1]), b(*feats[1]))
