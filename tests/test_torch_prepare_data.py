"""Chain data preparation in the port against satpu's, byte for byte, on a
synthetic kaldi data dir (voiced utterances of 2-4 s over a small word
list, wav.scp / text / utt2spk):

- ``prepare_chain_data`` with speed perturbation and a grapheme lexicon,
  and without perturbation with a lexicon file: every file both write
  (den.fst, normalization.fst, tree.json, phones.txt, num_pdfs, the
  numerator arks and scps, the perturbed wavs, wav.scp, utt2spk, text,
  utt2len, allowed_lengths.txt, HCLG.fst, words.txt) has the same bytes,
  with the output directory's own path replaced in the text files that
  name it;
- the ``prepare_data`` CLI from an ini's ``[prepare_data]`` section, and
  its refusal without ``--data-dir`` / ``--out-dir``;
- ``phone_lm_fst``, ``make_normalization_fst``, ``allowed_sample_lengths``
  and ``_resample_linear``;
- ``chain.hmm``: a kaldi TransitionModel (chain topology) written by the
  port has satpu's bytes, reads back in both, and maps every transition id
  to satpu's pdf; ``relabel_fst_to_pdfs`` gives satpu's graph.
"""
import os

import numpy as np
import pytest

WORDS = ["alpha", "bravo", "charlie", "delta", "echo", "fox", "golf", "hotel"]


def write_data_dir(root: str, n_utts: int = 12, seed: int = 0) -> str:
    """A kaldi data dir of voiced utterances (2-4 s, 16 kHz) whose text is
    3-6 words of ``WORDS``, 3 speakers."""
    from satpu_torch.utils import kaldi_data

    rng = np.random.default_rng(seed)
    d = os.path.join(root, "data")
    os.makedirs(d, exist_ok=True)
    wav_scp, text, utt2spk = {}, {}, {}
    for i in range(n_utts):
        utt = f"s{i % 3}-u{i:03d}"
        n = int(16000 * rng.uniform(2.0, 4.0))
        t = np.arange(n) / 16000
        f0 = 100 + 15 * i
        x = sum(a * np.sin(2 * np.pi * h * f0 * t) for h, a in ((1, 0.3), (2, 0.15), (3, 0.08)))
        x = (x * (1 + 0.5 * np.sin(2 * np.pi * 3 * t)) + rng.standard_normal(n) * 0.003)
        path = os.path.join(d, f"{utt}.wav")
        kaldi_data.write_wav(path, x.astype(np.float32), 16000)
        wav_scp[utt] = path
        text[utt] = " ".join(rng.choice(WORDS, int(rng.integers(3, 7))))
        utt2spk[utt] = f"s{i % 3}"
    kaldi_data.write_keyed_text(wav_scp, os.path.join(d, "wav.scp"))
    kaldi_data.write_keyed_text(text, os.path.join(d, "text"))
    kaldi_data.write_keyed_text(utt2spk, os.path.join(d, "utt2spk"))
    return d


def write_lexicon(path: str) -> str:
    with open(path, "w") as f:
        for w in WORDS:
            f.write(f"{w} {' '.join(w[:3].upper())}\n")
        f.write("<unk> SPN\n")
    return path


def _files(root: str):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            p = os.path.join(d, n)
            out[os.path.relpath(p, root)] = p
    return out


def assert_same_tree(ours: str, theirs: str) -> int:
    """Every file under both dirs: the same bytes, with each dir's own
    absolute path replaced in the files that name it. Returns the count."""
    a, b = _files(ours), _files(theirs)
    assert set(a) == set(b), set(a) ^ set(b)
    for rel in sorted(a):
        x, y = open(a[rel], "rb").read(), open(b[rel], "rb").read()
        x = x.replace(os.path.abspath(ours).encode(), b"<OUT>")
        y = y.replace(os.path.abspath(theirs).encode(), b"<OUT>")
        assert x == y, rel
    return len(a)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("prep"))
    return root, write_data_dir(root)


@pytest.mark.parametrize("perturb,lexicon", [(True, False), (False, True)],
                         ids=["speed_perturb_grapheme", "lexicon_no_perturb"])
def test_prepare_chain_data_matches_satpu_bytes(data_dir, perturb, lexicon):
    from satpu.chain.prep import prepare_chain_data as jprep
    from satpu_torch.chain.prep import prepare_chain_data

    root, data = data_dir
    tag = f"{perturb}_{lexicon}"
    lex = write_lexicon(os.path.join(root, "lexicon.txt")) if lexicon else None
    ours, theirs = os.path.join(root, "port_" + tag), os.path.join(root, "satpu_" + tag)
    kw = dict(lexicon_path=lex, speed_perturb=perturb, num_lengths=6, valid_fraction=0.2,
              seed=3)
    out, ref = prepare_chain_data(data, ours, **kw), jprep(data, theirs, **kw)
    assert out["num_pdfs"] == ref["num_pdfs"] and out["num_phones"] == ref["num_phones"]
    n = assert_same_tree(ours, theirs)
    names = set(_files(ours))
    want = {"den.fst", "normalization.fst", "tree.json", "phones.txt", "num_pdfs",
            "fst_train.ark", "fst_train.scp", "fst_valid.ark", "fst_valid.scp", "HCLG.fst",
            "words.txt", "egs/wav.scp", "egs/utt2len", "egs/text", "egs/utt2spk"}
    assert want <= names, want - names
    if perturb:
        assert "egs/allowed_lengths.txt" in names
        assert sum(1 for f in names if f.startswith("egs/wavs/sp0.9-")) > 0
    assert n >= len(want)


def test_prepare_data_cli_matches_satpus(data_dir):
    from satpu.bin import prepare_data as jcli
    from satpu_torch.bin import prepare_data

    root, data = data_dir
    ini = os.path.join(root, "prep.ini")
    with open(ini, "w") as f:
        f.write(f"[var]\ndata = {data}\n\n[prepare_data]\ndata_dir = ${{:data}}\n"
                "num_lengths = 4\nbiphone = true\nspeed_perturb = true\n"
                "between_silprob = 0.2\nvalid_fraction = 0.1\n")
    ours, theirs = os.path.join(root, "cli_port"), os.path.join(root, "cli_satpu")
    assert prepare_data.main(["--config", ini, "--out-dir", ours, "--seed", "5"]) == 0
    assert jcli.main(["--config", ini, "--out-dir", theirs, "--seed", "5"]) == 0
    assert_same_tree(ours, theirs)
    with open(os.path.join(ours, "egs", "allowed_lengths.txt")) as f:
        assert len(f.read().split()) <= 4
    assert prepare_data.main(["--out-dir", ours]) == 2


def test_graph_and_length_helpers_match_satpu():
    import io

    from satpu.chain import prep as J
    from satpu_torch.chain import prep as T

    rng = np.random.default_rng(1)
    seqs = [list(rng.integers(1, 7, int(rng.integers(3, 9)))) for _ in range(30)]
    init, trans, final = T.estimate_phone_bigram(seqs, 6)

    def fst_bytes(fst):
        buf = io.BytesIO()
        fst.write_binary(buf)
        return buf.getvalue()

    assert fst_bytes(T.phone_lm_fst(init, trans, final)) == fst_bytes(
        J.phone_lm_fst(init, trans, final))
    tree = T.BiphoneTree.build(seqs, [f"p{i}" for i in range(1, 7)])
    jtree = J.BiphoneTree.build(seqs, [f"p{i}" for i in range(1, 7)])
    den, jden = T.make_den_fst(trans, final, tree), J.make_den_fst(trans, final, jtree)
    assert fst_bytes(den) == fst_bytes(jden)
    assert fst_bytes(T.make_normalization_fst(den)) == fst_bytes(J.make_normalization_fst(jden))
    lengths = list(rng.integers(16000, 80000, 50))
    assert T.allowed_sample_lengths(lengths, 12) == J.allowed_sample_lengths(lengths, 12)
    x = rng.standard_normal((1, 3001)).astype(np.float32)
    for n in (2700, 3001, 3300):
        np.testing.assert_array_equal(T._resample_linear(x, n), J._resample_linear(x, n))


def write_chain_transition_model(path: str, num_pdfs: int):
    """A kaldi TransitionModel whose transition ids cover pdfs 0..num_pdfs-1
    (chain topology: tuple k has forward pdf 2k, self-loop pdf 2k+1), written
    through the port's ``chain.hmm``. Returns (model, {pdf: transition id})."""
    from satpu_torch.chain.hmm import TransitionModel, chain_topology

    topo = chain_topology([1])
    tm = TransitionModel(topo, [(1, 0, 2 * k, 2 * k + 1) for k in range(num_pdfs // 2)])
    with open(path, "wb") as f:
        tm.write(f)
    tid_of = {}
    for tid, pdf in tm.pdf_map().items():
        tid_of.setdefault(pdf, tid)
    return tm, tid_of


def test_transition_model_matches_satpu(tmp_path):
    from satpu.chain import hmm as J
    from satpu.chain.fst import Fst as JFst
    from satpu_torch.chain import hmm as T
    from satpu_torch.chain.prep import numerator_fst, random_bigram_den, random_phone_walk

    path = str(tmp_path / "0.trans_mdl")
    tm, tid_of = write_chain_transition_model(path, 40)
    jtm = J.TransitionModel(J.chain_topology([1]), [(1, 0, 2 * k, 2 * k + 1) for k in range(20)])
    jpath = str(tmp_path / "j.trans_mdl")
    with open(jpath, "wb") as f:
        jtm.write(f)
    assert open(path, "rb").read() == open(jpath, "rb").read()
    back, jback = T.read_transition_model(path), J.read_transition_model(path)
    assert back.pdf_map() == jback.pdf_map() == tm.pdf_map()
    assert back.num_pdfs == jback.num_pdfs == 40 and sorted(tid_of) == list(range(40))
    # a numerator over transition ids relabels to satpu's pdf+1 graph
    fst, tree, trans = random_bigram_den(5, 3, seed=2)
    num = numerator_fst(random_phone_walk(trans, 6, np.random.default_rng(0)), tree)
    for arcs in num.arcs:
        for a in arcs:
            if a.ilabel > 0:
                a.ilabel = a.olabel = tid_of[a.ilabel - 1]
    text = num.to_text()
    got = T.relabel_fst_to_pdfs(num, back)
    ref = J.relabel_fst_to_pdfs(JFst.from_text(text), jback)
    assert got.to_text() == ref.to_text()
