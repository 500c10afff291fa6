"""satpu_torch's decoding stack against satpu's on the CPU. Every module
here is a copy, so each must give satpu's outputs exactly: WER scoring,
the decoding graph of ``make_decode_graph`` on a toy lexicon (the same
arcs, weights and word table), the native decoder (the same words, cost
within 1e-5, the same lattice arrays), the python best-path decoder,
N-best, both ARPA rescorings, CTM lines and the loglike ark writer."""
import os
import random

import numpy as np
import pytest

TEXTS = ("ab ba", "ba ab", "ab ab ba", "abb ba a")


def _graph(prep):
    """(decode graph, word table, pdf count) over a grapheme lexicon, with
    optional silence between words."""
    texts = [t.split() for t in TEXTS]
    lex = prep.Lexicon.grapheme([w for t in texts for w in t])
    phones = lex.phones()
    phone_id = {p: i + 1 for i, p in enumerate(phones)}
    seqs = [[phone_id[p] for p in prep.text_to_phones(t, lex, 0.3, random.Random(0))]
            for t in texts]
    tree = prep.BiphoneTree.build(seqs, phones)
    vocab, _, trans, final = prep.estimate_word_bigram(texts)
    graph, table = prep.make_decode_graph(tree, lex, phone_id, vocab, trans, final)
    return graph, table, tree.num_pdfs


def _arcs(g):
    return g.start, list(g.finals), [[(a.ilabel, a.olabel, a.weight, a.nextstate) for a in arcs]
                                     for arcs in g.arcs]


@pytest.fixture(scope="module")
def graphs():
    from satpu.chain import prep as J
    from satpu_torch.chain import prep as P

    return _graph(J), _graph(P)


def _loglikes(P, T=40, seed=0):
    return (np.random.default_rng(seed).standard_normal((T, P)) * 2.0).astype(np.float32)


def _write_arpa(path, words):
    r = np.random.default_rng(1)
    with open(path, "w") as f:
        f.write(f"\\data\\\nngram 1={len(words) + 3}\nngram 2={len(words) ** 2}\n\n\\1-grams:\n")
        f.write("-99 <s> -0.3\n-0.8 </s>\n-2.0 <unk>\n")
        for w in words:
            f.write(f"{r.uniform(-2, -0.5):.3f} {w} {r.uniform(-0.6, -0.1):.3f}\n")
        f.write("\n\\2-grams:\n")
        for a in words:
            for b in words:
                f.write(f"{r.uniform(-1.5, -0.1):.3f} {a} {b}\n")
        f.write("\n\\end\\\n")
    return str(path)


def test_wer_is_satpus():
    from satpu.utils import wer as J
    from satpu_torch.utils import wer as P

    refs = {"u1": "the cat sat on the mat", "u2": "a b c", "u3": "d e", "u4": ""}
    hyps = {"u1": "the cat sit on mat", "u2": "a x b c", "u3": "", "u4": "extra"}
    for u in refs:
        assert vars(P.compute_wer(refs[u], hyps[u])) == vars(J.compute_wer(refs[u], hyps[u]))
    out, ref = P.corpus_wer(refs, hyps), J.corpus_wer(refs, hyps)
    assert vars(out) == vars(ref)
    assert P.html_diff(out, "t") == J.html_diff(ref, "t")


def test_decode_graph_is_satpus(graphs):
    (jg, jtable, jpdfs), (pg, ptable, ppdfs) = graphs
    assert ptable == jtable and ppdfs == jpdfs
    assert pg.num_arcs > 20
    assert _arcs(pg) == _arcs(jg)


def test_native_library_builds_under_build_dir():
    from satpu_torch import native

    assert native.available()
    path = native.build()
    assert os.path.dirname(path) == native.BUILD_DIR
    assert os.path.basename(path).startswith("libsatpu_decoder-") and os.path.exists(path)


@pytest.mark.parametrize("seed", [0, 1])
def test_native_decode_is_satpus(graphs, seed):
    """native.decode and native.decode_lattice on the same loglikes: the same
    words and alignment, cost within 1e-5, the same lattice arrays."""
    from satpu import native as J
    from satpu_torch import native as P

    (jg, _, pdfs), (pg, _, _) = graphs
    ll = _loglikes(pdfs, seed=seed)
    jng, png = J.NativeGraph(jg), P.NativeGraph(pg)
    jw, ja, jc = J.decode(jng, ll)
    pw, pa, pc = P.decode(png, ll)
    assert (pw, pa) == (jw, ja) and abs(pc - jc) <= 1e-5
    calls = P.decode_lattice.calls
    jl = J.decode_lattice(jng, ll, beam=16.0, lattice_beam=8.0)
    pl = P.decode_lattice(png, ll, beam=16.0, lattice_beam=8.0)
    assert P.decode_lattice.calls == calls + 1
    assert pl.num_arcs > len(pw)
    for k in ("arc_from", "arc_to", "arc_word", "arc_pdf", "arc_graph", "arc_acoustic",
              "node_time", "node_final"):
        np.testing.assert_array_equal(getattr(pl, k), getattr(jl, k), err_msg=k)


def test_best_path_decode_is_satpus(graphs):
    from satpu.chain.decoder import best_path_decode as jdecode
    from satpu_torch.chain.decoder import best_path_decode

    (jg, table, pdfs), (pg, _, _) = graphs
    ll = _loglikes(pdfs, T=25, seed=2)
    assert vars(best_path_decode(ll, pg, word_table=table)) == vars(jdecode(ll, jg,
                                                                            word_table=table))


@pytest.mark.parametrize("old_lm", [False, True])
def test_nbest_and_rescoring_are_satpus(graphs, tmp_path, old_lm):
    """nbest, best_path, rescore_nbest, rescore_lattice and to_ctm on each
    side's own lattice of the same loglikes."""
    from satpu import native as JN
    from satpu.chain import lattice as J
    from satpu_torch import native as PN
    from satpu_torch.chain import lattice as P

    (jg, table, pdfs), (pg, _, _) = graphs
    ll = _loglikes(pdfs, seed=3)
    jl = JN.decode_lattice(JN.NativeGraph(jg), ll, lattice_beam=8.0)
    pl = PN.decode_lattice(PN.NativeGraph(pg), ll, lattice_beam=8.0)
    words = sorted(set(table.values()))
    new = _write_arpa(tmp_path / "new.arpa", words)
    old = _write_arpa(tmp_path / "old.arpa", words[::-1]) if old_lm else None
    jnew, pnew = J.ArpaLM(new), P.ArpaLM(new)
    jold, pold = (J.ArpaLM(old), P.ArpaLM(old)) if old else (None, None)

    assert len(P.nbest(pl, 10)) > 1
    assert P.nbest(pl, 10) == J.nbest(jl, 10)
    assert P.best_path(pl) == J.best_path(jl)
    assert (P.rescore_nbest(P.nbest(pl, 10), table, pnew, old_lm=pold, lm_scale=2.0)
            == J.rescore_nbest(J.nbest(jl, 10), table, jnew, old_lm=jold, lm_scale=2.0))
    hyp = P.rescore_lattice(pl, table, pnew, old_lm=pold, lm_scale=2.0)
    assert hyp == J.rescore_lattice(jl, table, jnew, old_lm=jold, lm_scale=2.0)
    assert P.to_ctm(hyp, table, utt="u") == J.to_ctm(hyp, table, utt="u")


def test_kaldi_wrappers_are_satpus(graphs, tmp_path):
    from satpu.chain import decoder as J
    from satpu.chain.lattice import ArpaLM as JLM
    from satpu_torch.chain import decoder as P
    from satpu_torch.chain.lattice import ArpaLM as PLM

    (jg, table, pdfs), (pg, _, _) = graphs
    ll = _loglikes(pdfs, seed=4)
    jo, po = J.kaldi_decode(ll, jg, word_table=table), P.kaldi_decode(ll, pg, word_table=table)
    assert {k: v for k, v in po.items() if k != "lattice"} == {
        k: v for k, v in jo.items() if k != "lattice"}
    arpa = _write_arpa(tmp_path / "lm.arpa", sorted(set(table.values())))
    for mode in ("exact", "nbest"):
        assert (P.kaldi_lm_rescoring(po["lattice"], PLM(arpa), table, mode=mode)
                == J.kaldi_lm_rescoring(jo["lattice"], JLM(arpa), table, mode=mode))
    words_txt = tmp_path / "words.txt"
    words_txt.write_text("<eps> 0\n" + "".join(f"{w} {i}\n" for i, w in sorted(table.items())))
    assert (P.read_words_txt(str(words_txt)) == J.read_words_txt(str(words_txt))
            == {0: "<eps>", **table})


def test_loglike_ark_is_satpus(tmp_path):
    """the ark writer that --dump-loglikes uses writes satpu's bytes."""
    from satpu.utils import scp_io as J
    from satpu_torch.utils import scp_io as P

    mats = {f"u{i}": _loglikes(7, T=5 + i, seed=i) for i in range(3)}
    for mod, name in ((J, "j"), (P, "p")):
        with mod.FileWriter(str(tmp_path / f"{name}.ark"), str(tmp_path / f"{name}.scp")) as w:
            for k, m in mats.items():
                w.write(k, m)
    assert (tmp_path / "p.ark").read_bytes() == (tmp_path / "j.ark").read_bytes()
    back = dict(P.read_ark(str(tmp_path / "p.ark")))
    assert sorted(back) == sorted(mats)
    for k in mats:
        np.testing.assert_array_equal(back[k], mats[k])
