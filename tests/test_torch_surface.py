"""The rest of satpu's public surface in the port, against satpu on the CPU:
the reference sidekit importer (``convert_sidekit``), kaldi-statistics
CMVN (``global_cmvn``, ``CMVN``) and ``AdaptivePCMN``, the host utilities
(``split_scp``, ``WavScpDataset``, the one-value parameter files,
``split_dict``, kaldi's ``num_frames``), ``load_weight=False`` and the two
option fields ``CoreHifiGanConfig.bf16_min_channels`` and ``train_asr
--train-stage``."""
import dataclasses
import re

import numpy as np
import pytest
import torch

import jax

from torch_parity import ANON_TINY, ASRBN_TINY, XV_TINY, jax_variables_numpy, rel_err

# ---- convert_sidekit -------------------------------------------------------------

XV_SMALL = {"ecapa": dict(XV_TINY, channels=64), "resnet": dict(XV_TINY)}


def reference_name(key: str, arch: str) -> str:
    """A port x-vector key -> the reference sidekit's: the
    ``before_speaker_embedding`` Sequential, and ECAPA's ``layer<k>.<i>``
    (the port's ``layer<k>.block.<i>``)."""
    key = re.sub(r"\bbefore_speaker_embedding_([a-z0-9_]+?)\.", r"before_speaker_embedding.\1.",
                 key)
    if arch == "ecapa":
        key = re.sub(r"\b(layer[234])\.block\.(\d+)\.", r"\1.\2.", key)
    return key


def _reference_state_dict(arch: str):
    """A reference-named state_dict of random arrays at the port model's
    shapes, with the buffers the importer drops: num_batches_tracked, the
    preprocessor's and spec_augment's. Weights are N(0, 1/fan_in) (a
    trained net's scale; larger ones make the 34-layer ResNet amplify f32
    rounding), vectors N(0, 0.1), batch norms' scales and running
    variances about 1."""
    from satpu_torch.sidekit.xvector import XVectorConfig, build_xvector

    r = np.random.default_rng(11)
    sd = {}
    for k, v in build_xvector(XVectorConfig(arch=arch, **XV_SMALL[arch])).state_dict().items():
        shape = tuple(v.shape)
        fan_in = int(np.prod(shape[1:])) if len(shape) > 1 else 100
        a = r.standard_normal(shape) / np.sqrt(fan_in)
        if k.endswith("running_var"):
            a = r.uniform(0.5, 2.0, shape)
        elif k.endswith(("bn.weight", "bn1.weight", "bn2.weight", "bn_be.weight")) or re.search(
                r"bns\.\d+\.weight$", k):
            a = 1.0 + a
        sd[reference_name(k, arch)] = torch.from_numpy(a.astype(np.float32))
        if k.endswith("running_var"):
            sd[reference_name(k, arch)[:-len("running_var")] + "num_batches_tracked"] = \
                torch.tensor(7)
    sd["preprocessor.melkwargs.window"] = torch.ones(400)
    sd["spec_augment.freq_mask"] = torch.zeros(3)
    return sd


@pytest.mark.parametrize("arch", ["ecapa", "resnet"])
def test_convert_sidekit_is_satpus_through_the_bridge(arch, monkeypatch):
    """convert_sidekit(sd) equals from_satpu_xvector(satpu's
    convert_sidekit(sd)) key for key, bitwise; the port model loaded from
    it and satpu's model on satpu's conversion give x-vectors within rel
    1e-5 (f32, eval) on the same features."""
    import satpu.sidekit.xvector as JX
    from satpu.models.convert import convert_sidekit as satpu_convert
    from satpu_torch.models.convert import convert_sidekit, from_satpu_xvector
    from satpu_torch.sidekit.xvector import XVectorConfig, build_xvector, normalize

    sd = _reference_state_dict(arch)
    got = convert_sidekit(sd, arch=arch)
    want = from_satpu_xvector(satpu_convert(sd, arch=arch))
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k

    model = build_xvector(XVectorConfig(arch=arch, **XV_SMALL[arch]))
    model.load_state_dict(got)  # strict: every tensor, nothing more
    feats = np.random.default_rng(12).standard_normal((3, 40, XV_TINY["n_mels"])).astype(
        np.float32)
    with torch.no_grad():
        out = normalize(model.eval().embed(torch.from_numpy(
            np.ascontiguousarray(feats.transpose(0, 2, 1)))), dim=1).numpy()
    monkeypatch.setattr(JX, "_apply_frontend", lambda module, c, x, train: x)
    jm = JX.build_xvector(JX.XVectorConfig(arch=arch, **XV_SMALL[arch]))
    _, ref = jax.jit(lambda v, x: jm.apply(v, x, train=False))(satpu_convert(sd, arch=arch),
                                                                feats)
    assert rel_err(out, ref) <= 1e-5, rel_err(out, ref)


# ---- kaldi-statistics CMVN, AdaptivePCMN -------------------------------------------------


def _kaldi_stats(dim=5, spks=("A", "B"), seed=0):
    """Per-speaker kaldi (2, dim+1) stats of features with other scales and
    a common offset (satpu's tests/test_cmvn_mel.py case), and the features."""
    rng = np.random.default_rng(seed)
    stats, feats = {}, {}
    for i, spk in enumerate(spks):
        x = rng.standard_normal((100, dim)) * (2.0 if i % 2 == 0 else 0.5) + 3.0
        st = np.zeros((2, dim + 1))
        st[0, :-1], st[0, -1], st[1, :-1] = x.sum(0), len(x), (x ** 2).sum(0)
        stats[spk], feats[spk] = st, x
    return stats, feats


@pytest.mark.parametrize("var_norm", [False, True])
def test_global_cmvn_matches_satpu(var_norm):
    """rel 1e-6 against satpu's on the same kaldi stats; exported from
    satpu_torch.ops as from satpu.ops."""
    from satpu.ops import global_cmvn as jglobal
    from satpu_torch.ops import global_cmvn

    stats, _ = _kaldi_stats(dim=12)
    x = np.random.default_rng(1).standard_normal((2, 30, 12)).astype(np.float32) * 2 + 3
    out = global_cmvn(torch.from_numpy(x), stats["A"], var_norm=var_norm)
    ref = np.asarray(jglobal(x, stats["A"], var_norm=var_norm))
    assert out.dtype == torch.float32 and out.shape == ref.shape
    assert rel_err(out.numpy(), ref) <= 1e-6, rel_err(out.numpy(), ref)


def test_cmvn_class_matches_satpu():
    """Kaldi-stats CMVN: per-speaker routing, the generic-spk fallback and
    reverse, on numpy arrays and on tensors, rel 1e-6 of satpu's; satpu's
    own checks (zero mean, unit std, reverse undoes forward)."""
    from satpu.ops.cmvn import CMVN as JCMVN
    from satpu_torch.ops.cmvn import CMVN

    stats, feats = _kaldi_stats(spks=("A", "B", "C"))
    utt2spk = {"u1": "A", "u2": "B", "u3": "C"}
    cases = [({"utt2spk": utt2spk}, "u1"), ({"utt2spk": utt2spk}, "u2"),
             ({"utt2spk": utt2spk}, "generic-spk"), ({}, "A"), ({}, "unknown-utt"),
             ({"norm_vars": False}, "C")]
    for kw, utt in cases:
        for reverse in (False, True):
            args = {"norm_means": True, "norm_vars": True, "reverse": reverse, **kw}
            mine, ref = CMVN(stats, **args), JCMVN(stats, **args)
            for x in (feats["A"], feats["A"].astype(np.float32)):
                want = ref(x, utt)
                got = mine(x, utt)
                assert isinstance(got, np.ndarray) and got.dtype == want.dtype
                assert rel_err(got, want) <= 1e-6, (kw, utt, reverse)
                t = mine(torch.from_numpy(x), utt)
                assert t.dtype == torch.from_numpy(want).dtype
                assert rel_err(t.numpy(), want) <= 1e-6, (kw, utt, reverse)
    for k in ("A", "B", "C", "generic-spk"):
        m, j = CMVN(stats), JCMVN(stats)
        np.testing.assert_array_equal(m.bias[k], j.bias[k])
        np.testing.assert_array_equal(m.scale[k], j.scale[k])
    c = CMVN(stats, norm_means=True, norm_vars=True, utt2spk=utt2spk)
    y = c(feats["A"], "u1")
    np.testing.assert_allclose(y.mean(0), 0.0, atol=1e-6)
    np.testing.assert_allclose(y.std(0), 1.0, atol=1e-2)
    back = CMVN(stats, norm_means=True, norm_vars=True, utt2spk=utt2spk, reverse=True)(y, "u1")
    np.testing.assert_allclose(back, feats["A"], atol=1e-5)
    single = CMVN(stats["B"], norm_vars=True)  # a bare matrix: the global key
    assert rel_err(single(feats["B"]), JCMVN(stats["B"], norm_vars=True)(feats["B"])) <= 1e-6


def test_cmvn_from_ark_is_the_dict_form(tmp_path):
    """from_ark of a written ark, and of its scp, equals the dict form."""
    from satpu_torch.ops.cmvn import CMVN
    from satpu_torch.utils import scp_io

    stats, feats = _kaldi_stats(spks=("A", "B"))
    ark, scp = str(tmp_path / "cmvn.ark"), str(tmp_path / "cmvn.scp")
    with scp_io.FileWriter(ark, scp) as w:
        for k, v in stats.items():
            w[k] = v
    want = CMVN(stats, norm_vars=True)
    for path in (ark, scp):
        got = CMVN.from_ark(path, norm_vars=True)
        assert sorted(got.bias, key=str) == sorted(want.bias, key=str)
        for k in want.bias:
            np.testing.assert_allclose(got.bias[k], want.bias[k], rtol=1e-6, atol=0)
            np.testing.assert_allclose(got.scale[k], want.scale[k], rtol=1e-6, atol=0)
        np.testing.assert_allclose(got(feats["B"], "B"), want(feats["B"], "B"), rtol=1e-6)


def test_adaptive_pcmn_matches_satpu():
    """satpu's init params carried across (from_satpu_pcmn): rel 1e-5;
    all-zero params are the identity, as satpu's tests/test_zoo_tail.py
    checks; a too-short input is refused."""
    from satpu.ops.cmvn import AdaptivePCMN as JPCMN
    from satpu_torch.models.convert import from_satpu_pcmn
    from satpu_torch.ops.cmvn import AdaptivePCMN

    B, T, D = 2, 40, 12
    jp = JPCMN(D, left_context=-5, right_context=5)
    params = jax_variables_numpy(jp.init(jax.random.PRNGKey(0)))
    params["bias"] = np.random.default_rng(2).normal(0, 0.01, D).astype(np.float32)
    x = np.random.default_rng(3).standard_normal((B, T, D)).astype(np.float32)
    ref = np.asarray(jp.apply(params, x))
    mod = AdaptivePCMN(D, left_context=-5, right_context=5)
    mod.load_state_dict(from_satpu_pcmn(params))
    with torch.no_grad():
        out = mod(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape and rel_err(out, ref) <= 1e-5, rel_err(out, ref)
    with torch.no_grad():
        for p in mod.parameters():
            p.zero_()
        np.testing.assert_allclose(mod(torch.from_numpy(x)).numpy(), x, rtol=0, atol=1e-6)
    with pytest.raises(ValueError):
        mod(torch.zeros(1, 10, D))


# ---- host utilities --------------------------------------------------------------


@pytest.mark.parametrize("n_items", [0, 1, 10, 11])
def test_split_scp_and_split_dict_are_satpus(n_items):
    from satpu.utils import config as jcfg
    from satpu.utils import kaldi_data as jk
    from satpu_torch.utils import config, kaldi_data, split_dict

    d = {f"u{i}": f"/w/{i}.wav" for i in range(n_items)}
    for n in (1, 2, 3, 5):
        assert kaldi_data.split_scp(d, n) == jk.split_scp(d, n)
        assert split_dict(d, n) == config.split_dict(d, n) == jcfg.split_dict(d, n)
    # satpu's tests/test_utils.py case
    shards = split_dict({f"u{i}": i for i in range(10)}, 3)
    assert len(shards) == 3 and sum(len(s) for s in shards) == 10
    assert {k: v for s in shards for k, v in s.items()} == {f"u{i}": i for i in range(10)}


def test_single_param_files_are_satpus(tmp_path):
    from satpu.utils import config as jcfg
    from satpu_torch.utils import config

    for value, typename in ((3280, int), (0.25, float), ("tdnnf", str)):
        mine, ref = str(tmp_path / "mine"), str(tmp_path / "ref")
        config.write_single_param_file(value, mine)
        jcfg.write_single_param_file(value, ref)
        assert open(mine).read() == open(ref).read()
        assert (config.read_single_param_file(ref, typename)
                == jcfg.read_single_param_file(ref, typename) == value)


def test_wav_scp_dataset_is_satpus(tmp_path):
    """A written wav.scp through WavScpDataset: the same names, samples
    (exactly), rates; parse_wavinfo_wav of a WavInfo and of raw arrays."""
    from satpu.utils import kaldi_data as jk
    from satpu_torch.utils import WavInfo, WavScpDataset, kaldi_data, parse_wavinfo_wav

    rng = np.random.default_rng(5)
    scp = {}
    for i, n in enumerate((800, 1601, 3200)):
        p = str(tmp_path / f"u{i}.wav")
        kaldi_data.write_wav(p, (rng.standard_normal(n) * 0.2).astype(np.float32), 16000)
        scp[f"u{i}"] = p
    kaldi_data.write_keyed_text(scp, str(tmp_path / "wav.scp"))
    mine = WavScpDataset.from_wav_scpfile(str(tmp_path / "wav.scp"))
    ref = jk.WavScpDataset.from_wav_scpfile(str(tmp_path / "wav.scp"))
    assert len(mine) == len(ref) == 3
    for a, b in zip(mine, ref):
        assert a.name == b.name and a.filename == b.filename
        assert a.sample_rate == b.sample_rate == 16000
        np.testing.assert_array_equal(a.wav, b.wav)
        np.testing.assert_array_equal(parse_wavinfo_wav(a), jk.parse_wavinfo_wav(b))
    lazy = WavInfo(name="u1", filename=scp["u1"])
    assert lazy.wav is None
    np.testing.assert_array_equal(parse_wavinfo_wav(lazy), mine[1].wav)
    for raw in (rng.standard_normal(50), rng.standard_normal((2, 50))):
        got, want = parse_wavinfo_wav(raw), jk.parse_wavinfo_wav(raw)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("snip_edges", [False, True])
def test_num_frames_is_satpus(snip_edges):
    """kaldi's frame count over 0-2000 samples; the BN front's count is
    its snip_edges=False case."""
    from satpu.ops.fbank import num_frames as jnum
    from satpu_torch.models.asrbn import fbank_num_frames
    from satpu_torch.ops.fbank import num_frames

    for n in range(2001):
        assert num_frames(n, snip_edges=snip_edges) == jnum(n, snip_edges=snip_edges), n
        assert num_frames(n, 100, 256, snip_edges) == jnum(n, 100, 256, snip_edges), n
        if not snip_edges:
            assert fbank_num_frames(n) == num_frames(n)


# ---- load_weight=False -----------------------------------------------------------


@pytest.mark.parametrize("via", ["load_model", "hub.load"])
def test_load_weight_false_builds_without_the_files_weights(via, tmp_path):
    """The model of a checkpoint's meta and option args, with build_model's
    seeded init and not the file's weights."""
    from satpu_torch import hub, infer_helper

    params = dict(ANON_TINY, asrbn=dict(ASRBN_TINY))
    trained = infer_helper.build_model("anonymizer_tdnnf_hifigan", device="cpu", seed=3,
                                       **params)
    path = str(tmp_path / "anon.pt")
    infer_helper.save_model(path, "anonymizer_tdnnf_hifigan", params, trained.state_dict())
    opts = {"compute_dtype": "bfloat16"}
    if via == "load_model":
        loaded, meta = infer_helper.load_model(path, option_args=opts, device="cpu")
        built, meta2 = infer_helper.load_model(path, option_args=opts, device="cpu",
                                               load_weight=False)
    else:
        loaded, meta = hub.load(path + "+compute-dtype=bfloat16", device="cpu")
        built, meta2 = hub.load(path + "+compute-dtype=bfloat16", device="cpu",
                                load_weight=False)
    assert meta2 == meta and built.cfg == loaded.cfg
    assert built.cfg.compute_dtype == "bfloat16"  # the option args apply
    init = infer_helper.build_model("anonymizer_tdnnf_hifigan", device="cpu",
                                    **dict(params, **opts)).state_dict()
    file_sd = trained.state_dict()
    got = built.state_dict()
    assert sorted(got) == sorted(init)
    assert all(torch.equal(got[k], init[k]) for k in init)
    assert not all(torch.equal(got[k], file_sd[k]) for k in file_sd)
    assert all(torch.equal(v, file_sd[k]) for k, v in loaded.state_dict().items())
    assert next(built.parameters()).device.type == "cpu" and not built.training


# ---- the two option fields -------------------------------------------------------


def test_bf16_min_channels_matches_satpu():
    """A bf16 generator with bf16_min_channels between its two stage widths
    (16 and 8): within bf16's 2e-2 of satpu's, and the narrow stage's
    activations f32 while the wide stage's are bf16."""
    from satpu.models.hifigan import CoreHifiGan as JGen
    from satpu.models.hifigan import CoreHifiGanConfig as JCfg
    from satpu_torch.models.convert import from_satpu_variables
    from satpu_torch.models.hifigan import CoreHifiGan, CoreHifiGanConfig

    small = dict(input_dim=20, upsample_rates=(4, 4), upsample_kernel_sizes=(8, 8),
                 upsample_initial_channel=32, compute_dtype="bfloat16", bf16_min_channels=12)
    x = np.random.default_rng(0).standard_normal((2, 30, 20)).astype(np.float32)
    jgen = JGen(JCfg(**small))
    variables = jax_variables_numpy(jax.jit(jgen.init)(jax.random.PRNGKey(0), x))
    ref = np.asarray(jax.jit(jgen.apply)(variables, x))[..., 0]
    gen = CoreHifiGan(CoreHifiGanConfig(**small)).eval()
    gen.load_state_dict(from_satpu_variables(variables))
    seen = {}
    hooks = [m.register_forward_hook(lambda m, i, o, name=name: seen.update({name: o.dtype}))
             for name, m in gen.named_modules()
             if name in ("conv_pre", "ups.0", "resblocks.0", "ups.1", "resblocks.3")]
    with torch.no_grad():
        out = gen(torch.from_numpy(x).transpose(1, 2))[:, 0].numpy()
    for h in hooks:
        h.remove()
    assert seen == {"conv_pre": torch.bfloat16, "ups.0": torch.bfloat16,
                    "resblocks.0": torch.bfloat16, "ups.1": torch.float32,
                    "resblocks.3": torch.float32}
    assert out.shape == ref.shape and rel_err(out, ref) <= 2e-2, rel_err(out, ref)
    assert dataclasses.asdict(CoreHifiGanConfig()) == dataclasses.asdict(JCfg())


def test_train_asr_takes_satpus_options():
    """Every satpu TrainAsrOpts field with its default (``train_stage`` "0"
    included, accepted and ignored as in satpu); ``--train-stage 0`` parses."""
    from satpu.bin.train_asr import TrainAsrOpts as JOpts
    from satpu_torch.bin.train_asr import TrainAsrOpts

    mine = {f.name: f.default for f in dataclasses.fields(TrainAsrOpts)}
    for f in dataclasses.fields(JOpts):
        assert f.name in mine and mine[f.name] == f.default, f.name
    opts = TrainAsrOpts().load_from_args(["--train-stage", "0", "--num-epochs", "2"])
    assert opts.train_stage == "0" and opts.num_epochs == 2
    assert TrainAsrOpts().load_from_config({"train_stage": "3"}).train_stage == "3"
