"""The port's ``eval_anon`` CLI end to end on the CPU (``--device cpu``): a
decoding graph from the port's ``make_decode_graph``, a tiny
``asrbn_tdnnf`` and a tiny ``asv_xvector`` checkpoint carrying satpu's
weights (randomized batch norms) across the bridge, 3 utterances, an ARPA
LM, both rescore modes and both x-vector modes. ``results.json`` holds
the reference word count and the ASV metrics; the dumped loglikes match
satpu's network (rel 1e-4) and the hyps in ``hyp.ctm`` are exactly what
satpu's native lattice decode and rescoring make of those loglikes. A tiny
``asrbn_tdnnf_wav2vec2`` serves as the ASR model too."""
import dataclasses
import json
import os
import random

import numpy as np
import pytest
import torch

from torch_parity import XV_TINY, rel_err, satpu_apply, satpu_init, satpu_xvector

TEXTS = {"u0": "ab ba", "u1": "ba ab", "u2": "ab ab ba"}
# --nbest, --lattice-beam: the python N-best search pops up to 200,000
# partial paths when a random net's lattice holds fewer distinct word
# sequences than asked for
NBEST, LATTICE_BEAM = 2, 4.0
ASR_TINY = dict(hidden_dim=16, bottleneck_dim=8, prefinal_bottleneck_dim=8, p_dropout=0.0)


def _wav(n, seed):
    r = np.random.default_rng(seed)
    t = np.arange(n) / 16000
    return (r.standard_normal(n) * 0.1 + 0.2 * np.sin(2 * np.pi * (110 + 25 * seed) * t)
            ).astype(np.float32)


def _data_dir(path, wavs, utt2spk=None, text=None):
    from satpu_torch.utils import kaldi_data

    os.makedirs(path)
    scp = {}
    for utt, w in wavs.items():
        scp[utt] = os.path.join(path, f"{utt}.wav")
        kaldi_data.write_wav(scp[utt], w, 16000)
    kaldi_data.write_keyed_text(scp, os.path.join(path, "wav.scp"))
    for name, table in (("utt2spk", utt2spk), ("text", text)):
        if table:
            kaldi_data.write_keyed_text(table, os.path.join(path, name))
    return str(path)


@pytest.fixture(scope="module")
def fx(tmp_path_factory):
    """Paths of the graph, words.txt, both checkpoints, the data, enrolment
    and trials, the ARPA LM; satpu's ASR network and variables."""
    from satpu.models.asrbn import TDNNFNet as JNet
    from satpu.models.asrbn import TDNNFNetConfig as JCfg
    from satpu_torch import infer_helper
    from satpu_torch.chain import prep
    from satpu_torch.models.asrbn import TDNNFNetConfig
    from satpu_torch.models.convert import from_satpu_variables

    d = tmp_path_factory.mktemp("eval")
    out = {}
    texts = [t.split() for t in TEXTS.values()]
    lex = prep.Lexicon.grapheme([w for t in texts for w in t])
    phones = lex.phones()
    phone_id = {p: i + 1 for i, p in enumerate(phones)}
    seqs = [[phone_id[p] for p in prep.text_to_phones(t, lex, 0.0, random.Random(0))]
            for t in texts]
    tree = prep.BiphoneTree.build(seqs, phones)
    vocab, _, trans, final = prep.estimate_word_bigram(texts)
    graph, table = prep.make_decode_graph(tree, lex, phone_id, vocab, trans, final)
    out["graph"], out["words"] = str(d / "HCLG.fst"), str(d / "words.txt")
    graph.write(out["graph"])
    with open(out["words"], "w") as f:
        f.write("<eps> 0\n" + "".join(f"{w} {i}\n" for i, w in sorted(table.items())))
    out["table"] = table

    cfg = dict(ASR_TINY, output_dim=tree.num_pdfs)
    jnet = JNet(JCfg(**cfg))
    v = satpu_init(jnet, np.zeros((1, 8000), np.float32), seed=1)
    out["asr"] = str(d / "asr.pt")
    infer_helper.save_model(out["asr"], "asrbn_tdnnf",
                            dataclasses.asdict(TDNNFNetConfig(**cfg)), from_satpu_variables(v))
    out["jnet"], out["jvars"] = jnet, v

    _, _, pm = satpu_xvector(seed=2, **XV_TINY)
    out["asv"] = str(d / "asv.pt")
    infer_helper.save_model(out["asv"], "asv_xvector", dict(XV_TINY), pm.state_dict())

    wavs = {u: _wav(9000 + 2500 * i, i) for i, u in enumerate(TEXTS)}
    out["wavs"] = wavs
    out["data"] = _data_dir(d / "data", wavs, {u: "x" for u in TEXTS}, TEXTS)
    enroll = {f"s{s}-{i}": _wav(14000 + 3000 * i, 10 + 2 * s + i) for s in range(2)
              for i in range(2)}
    out["enroll"] = _data_dir(d / "enroll", enroll, {u: u.split("-")[0] for u in enroll})
    out["trials"] = str(d / "trials")
    with open(out["trials"], "w") as f:
        for i, u in enumerate(TEXTS):
            for s in range(2):
                f.write(f"s{s} {u} {'target' if i % 2 == s else 'nontarget'}\n")
    with open(d / "lm.arpa", "w") as f:
        f.write("\\data\\\nngram 1=6\n\n\\1-grams:\n-99 <s>\n-0.8 </s>\n-2.0 <unk>\n"
                "-1.1 ab\n-0.7 ba\n-1.9 abb\n\n\\end\\\n")
    out["arpa"] = str(d / "lm.arpa")
    return out


def _satpu_ctm(fx, lls, mode):
    """satpu's native lattice decode + rescoring of the given loglikes, as
    CTM lines in the CLI's order."""
    from satpu import native
    from satpu.chain.fst import Fst
    from satpu.chain.lattice import ArpaLM, nbest, rescore_lattice, rescore_nbest, to_ctm

    ng, lm, table = native.NativeGraph(Fst.read(fx["graph"])), ArpaLM(fx["arpa"]), fx["table"]
    lines = []
    for utt in sorted(lls):
        lat = native.decode_lattice(ng, lls[utt], beam=16.0, lattice_beam=LATTICE_BEAM,
                                    max_active=7000)
        if mode == "exact":
            hyp = rescore_lattice(lat, table, lm)
        else:
            hyp = (rescore_nbest(nbest(lat, NBEST), table, lm) or [None])[0]
        if hyp:
            lines += to_ctm(hyp, table, utt=utt)
    return lines


@pytest.mark.parametrize("rescore_mode,xvector_mode,cohort_dir",
                         [("exact", "chunked", False), ("nbest", "full", True)])
def test_eval_anon_cli_on_cpu(fx, tmp_path, rescore_mode, xvector_mode, cohort_dir):
    from satpu.utils.scp_io import read_ark
    from satpu_torch import native
    from satpu_torch.bin import eval_anon
    from satpu_torch.models.asrbn import output_num_frames

    results = tmp_path / "results"
    ark = tmp_path / "ll.ark"
    native.decode_lattice.calls = 0
    rc = eval_anon.main([
        "--device", "cpu", "--data", fx["data"], "--asr-checkpoint", fx["asr"],
        "--decode-graph", fx["graph"], "--words-txt", fx["words"],
        "--rescore-lm", fx["arpa"], "--rescore-mode", rescore_mode,
        "--nbest", str(NBEST), "--lattice-beam", str(LATTICE_BEAM), "--batch-size", "2",
        "--write-ctm", "true", "--dump-loglikes", str(ark),
        "--asv-checkpoint", fx["asv"], "--enroll-dir", fx["enroll"], "--trials", fx["trials"],
        "--xvector-mode", xvector_mode, "--results", str(results)]
        + (["--cohort-dir", fx["enroll"]] if cohort_dir else []))
    assert rc == 0
    assert native.decode_lattice.calls == len(TEXTS)
    res = json.loads((results / "results.json").read_text())
    asr, asv = res["asr"], res["asv"]
    assert asr["words"] == 7 and np.isfinite(asr["wer"]) and asr["errors"] >= 0
    assert {"eer", "eer_ci_lower", "eer_ci_upper", "rocch_eer", "linkability", "cllr",
            "min_cllr", "asnorm_eer", "asnorm_linkability", "asnorm_min_cllr"} <= set(asv)
    assert all(np.isfinite(x) for x in asv.values()) and 0 <= asv["eer"] <= 100
    assert (results / "metric.json").exists() and (tmp_path / "ll.scp").exists()

    # the dumped loglikes are satpu's network on the same padded batch (rel 1e-4)
    lls = dict(read_ark(str(ark)))
    assert sorted(lls) == sorted(TEXTS)
    wav = np.zeros((len(TEXTS), 16000), np.float32)
    for j, w in enumerate(fx["wavs"].values()):
        wav[j, :len(w)] = w
    lens = np.array([len(w) for w in fx["wavs"].values()], np.int32)
    ref, _ = satpu_apply(fx["jnet"], fx["jvars"], wav, train=False, lengths=lens)
    for j, (utt, w) in enumerate(fx["wavs"].items()):
        n = output_num_frames(len(w))
        assert lls[utt].shape == (n, ref.shape[2])
        assert rel_err(lls[utt], np.asarray(ref)[j, :n]) <= 1e-4

    # the hyps are satpu's decode of the very loglikes the port dumped
    ctm = (results / "hyp.ctm").read_text().split("\n")
    assert [x for x in ctm if x] == _satpu_ctm(fx, lls, rescore_mode)


def test_eval_anon_refuses_serve_mesh(tmp_path, monkeypatch):
    """Over several cards a batch size their count does not divide is
    refused, as satpu refuses it (satpu/bin/eval_anon.py:107-111), before
    any output; the serving mesh's devices are every local card."""
    from satpu_torch.bin import eval_anon
    from satpu_torch.parallel.mesh import serve_devices

    monkeypatch.setattr(eval_anon, "resolve_device", lambda d: torch.device("cuda"))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(ValueError, match="divisible by the device count \\(2\\)"):
        eval_anon.main(["--serve-mesh", "true", "--batch-size", "3",
                        "--results", str(tmp_path / "r")])
    assert not (tmp_path / "r").exists()
    assert serve_devices("cuda") == [torch.device("cuda", 0), torch.device("cuda", 1)]
    assert serve_devices("cpu") == [torch.device("cpu")]


def test_eval_anon_serve_mesh_on_one_device_runs_unsharded(tmp_path):
    """satpu runs unsharded on one device (satpu/bin/eval_anon.py:106)."""
    from satpu_torch.bin import eval_anon

    assert eval_anon.main(["--device", "cpu", "--serve-mesh", "true",
                           "--results", str(tmp_path / "r")]) == 0
    assert json.loads((tmp_path / "r" / "results.json").read_text()) == {}


def test_eval_anon_with_a_wav2vec2_asr_model(fx, tmp_path):
    """The ASR model may be a wav2vec2 extractor (``asrbn_tdnnf_wav2vec2``),
    as in satpu: the CLI gives it no lengths, and its dumped loglikes are
    satpu's wav2vec2 net on the same padded batch (rel 1e-4), cut to the
    fbank net's frame count as satpu's eval_anon cuts them."""
    from satpu.models.asrbn import Wav2Vec2TDNNFNet as JNet
    from satpu.models.asrbn import wav2vec2_tdnnf_config as jcfg
    from satpu.models.wav2vec2 import Wav2Vec2Config as JW
    from satpu.utils.scp_io import read_ark
    from satpu_torch import infer_helper
    from satpu_torch.bin import eval_anon
    from satpu_torch.models.asrbn import output_num_frames, wav2vec2_tdnnf_config
    from satpu_torch.models.convert import from_satpu_variables

    w2v = dict(conv_dim=(16, 16, 16), conv_kernel=(10, 8, 4), conv_stride=(5, 8, 8),
               hidden_size=16, num_hidden_layers=1, num_attention_heads=2, intermediate_size=32,
               num_conv_pos_embeddings=8, num_conv_pos_embedding_groups=2)
    cfg = dataclasses.replace(jcfg(fx["jnet"].cfg.output_dim), **ASR_TINY)
    jnet = JNet(cfg, JW(**w2v))
    v = satpu_init(jnet, np.zeros((1, 8000), np.float32), seed=3)
    path = str(tmp_path / "w2v2.pt")
    params = dict(dataclasses.asdict(dataclasses.replace(
        wav2vec2_tdnnf_config(cfg.output_dim), **ASR_TINY)), wav2vec2=w2v)
    infer_helper.save_model(path, "asrbn_tdnnf_wav2vec2", params, from_satpu_variables(v))
    ark = tmp_path / "ll.ark"
    rc = eval_anon.main(["--device", "cpu", "--data", fx["data"], "--asr-checkpoint", path,
                         "--decode-graph", fx["graph"], "--words-txt", fx["words"],
                         "--nbest", str(NBEST), "--lattice-beam", str(LATTICE_BEAM),
                         "--batch-size", "3", "--dump-loglikes", str(ark),
                         "--results", str(tmp_path / "r")])
    assert rc == 0
    res = json.loads((tmp_path / "r" / "results.json").read_text())
    assert res["asr"]["words"] == 7 and np.isfinite(res["asr"]["wer"])
    lls = dict(read_ark(str(ark)))
    wav = np.zeros((len(TEXTS), 16000), np.float32)
    for j, w in enumerate(fx["wavs"].values()):
        wav[j, :len(w)] = w
    ref, _ = satpu_apply(jnet, v, wav, train=False)
    for j, (utt, w) in enumerate(fx["wavs"].items()):
        n = output_num_frames(len(w))
        assert lls[utt].shape == (n, ref.shape[2])
        assert rel_err(lls[utt], np.asarray(ref)[j, :n]) <= 1e-4


def test_eval_anon_serve_mesh_splits_loglike_batches(fx, tmp_path):
    """The serving mesh over two CPU "devices": each batch of 2 split into
    blocks of 1 (the tail batch's one row on the first device alone); the
    dumped loglikes within 1e-6 of the unsharded run's and satpu's network
    on the same padded batch at rel 1e-4."""
    from satpu.utils.scp_io import read_ark
    from satpu_torch.bin import eval_anon
    from satpu_torch.models.asrbn import output_num_frames

    lls = {}
    for name, devices in (("one", None), ("mesh", ["cpu", "cpu"])):
        ark = tmp_path / f"{name}.ark"
        opts = eval_anon.EvalOpts().load_from_args([
            "--device", "cpu", "--data", fx["data"], "--asr-checkpoint", fx["asr"],
            "--decode-graph", fx["graph"], "--words-txt", fx["words"], "--nbest", str(NBEST),
            "--lattice-beam", str(LATTICE_BEAM), "--batch-size", "2", "--dump-loglikes",
            str(ark), "--results", str(tmp_path / name)])
        os.makedirs(opts.results)
        res = eval_anon.evaluate_asr(opts, devices)
        assert res["words"] == 7
        lls[name] = dict(read_ark(str(ark)))
    assert sorted(lls["mesh"]) == sorted(TEXTS)
    wav = np.zeros((len(TEXTS), 16000), np.float32)
    for j, w in enumerate(fx["wavs"].values()):
        wav[j, :len(w)] = w
    lens = np.array([len(w) for w in fx["wavs"].values()], np.int32)
    ref, _ = satpu_apply(fx["jnet"], fx["jvars"], wav, train=False, lengths=lens)
    for j, (utt, w) in enumerate(fx["wavs"].items()):
        got = lls["mesh"][utt]
        assert np.abs(got - lls["one"][utt]).max() <= 1e-6
        assert rel_err(got, np.asarray(ref)[j, :output_num_frames(len(w))]) <= 1e-4
