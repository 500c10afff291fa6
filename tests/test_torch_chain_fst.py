"""satpu_torch chain graph code (numpy copies of satpu's) against satpu:
FST binary and kaldi-ark I/O both ways, arc arrays and padding, epsilon
removal, acceptor composition, minimum path length, the biphone tree, den
and numerator graphs, and the den graph's power-iterated initial probs and
factored form. Graph code is exact (integers and copied floats); the float
steps are compared at rel 1e-6."""
import io

import numpy as np
import pytest

from satpu.chain import fst as jfst
from satpu.chain import objf as jobjf
from satpu.chain import prep as jprep
from satpu.chain.dataset import fst_min_path_length as j_min_path
from satpu_torch.chain import fst as tfst
from satpu_torch.chain import objf as tobjf
from satpu_torch.chain import prep as tprep
from satpu_torch.chain.dataset import fst_min_path_length
from torch_parity import rel_err


def _arcs(f):
    """Start, finals and arcs, weights as f32 (the binary format's type)."""
    return (f.start, [np.float32(w) for w in f.finals],
            [[(a.ilabel, a.olabel, np.float32(a.weight), a.nextstate) for a in arcs]
             for arcs in f.arcs])


def _cross(f, dst_mod):
    """An FST of one implementation re-read by the other (binary)."""
    buf = io.BytesIO()
    f.write_binary(buf)
    buf.seek(0)
    return dst_mod.Fst.read_binary(buf)


def _bigram(seed=0, P=5):
    rng = np.random.default_rng(seed)
    seqs = [rng.integers(1, P + 1, 12).tolist() for _ in range(8)]
    trans = np.full((P + 1, P + 1), 1e-8)
    for seq in seqs:
        prev = 0
        for p in seq:
            trans[prev, p] += 1.0
            prev = p
    trans /= trans.sum(axis=1, keepdims=True)
    return seqs, [f"p{i}" for i in range(1, P + 1)], trans, np.full(P + 1, 0.2)


@pytest.fixture(scope="module")
def graphs():
    seqs, phones, trans, final = _bigram()
    jtree = jprep.BiphoneTree.build(seqs, phones)
    ttree = tprep.BiphoneTree.build(seqs, phones)
    return {"seqs": seqs, "trans": trans, "final": final, "jtree": jtree, "ttree": ttree,
            "jden": jprep.make_den_fst(trans, final, jtree),
            "tden": tprep.make_den_fst(trans, final, ttree),
            "jnum": jprep.numerator_fst(seqs[0][:6], jtree, optional_sil=1),
            "tnum": tprep.numerator_fst(seqs[0][:6], ttree, optional_sil=1)}


def test_biphone_tree_den_and_numerator_graphs_are_identical(graphs):
    g = graphs
    assert g["ttree"].leaf_of == g["jtree"].leaf_of
    assert g["ttree"].num_pdfs == g["jtree"].num_pdfs
    assert tprep.BiphoneTree.from_json(g["jtree"].to_json()).leaf_of == g["jtree"].leaf_of
    assert _arcs(g["tden"]) == _arcs(g["jden"])
    assert _arcs(g["tnum"]) == _arcs(g["jnum"])
    for seq in g["seqs"][1:4]:
        assert (_arcs(tprep.numerator_fst(seq, g["ttree"]))
                == _arcs(jprep.numerator_fst(seq, g["jtree"])))


@pytest.mark.parametrize("name", ["den", "num"])
def test_binary_fsts_cross_read_both_ways(graphs, name):
    j, t = graphs["j" + name], graphs["t" + name]
    assert _arcs(_cross(j, tfst)) == _arcs(j)
    assert _arcs(_cross(t, jfst)) == _arcs(t)


def test_kaldi_ark_cross_read(graphs, tmp_path):
    """write_fst_ark of each side, read back through the other's reader."""
    fsts = {"a": graphs["tnum"], "b": graphs["tden"]}
    tprep.write_fst_ark(fsts, str(tmp_path / "t.ark"), str(tmp_path / "t.scp"))
    jprep.write_fst_ark({"a": graphs["jnum"], "b": graphs["jden"]},
                        str(tmp_path / "j.ark"), str(tmp_path / "j.scp"))
    assert open(tmp_path / "t.ark", "rb").read() == open(tmp_path / "j.ark", "rb").read()
    for line in open(tmp_path / "t.scp"):
        utt, rx = line.split()
        path, off = rx.rsplit(":", 1)
        with open(path, "rb") as f:
            f.seek(int(off))
            got = jfst.read_fst_kaldi(f)
        assert _arcs(got) == _arcs(fsts[utt])


def test_arrays_padding_rmepsilon_compose_and_min_path(graphs):
    g = graphs
    # the same f32 normalization graph on both sides
    jnorm = _cross(jprep.make_normalization_fst(g["jden"]), jfst)
    tnorm = _cross(jnorm, tfst)
    jc = jfst.fst_compose_acceptor(g["jnum"], jnorm)
    tc = tfst.fst_compose_acceptor(g["tnum"], tnorm)
    assert _arcs(tc) == _arcs(jc)
    jr, tr = jfst.fst_rmepsilon(jc), tfst.fst_rmepsilon(tc)
    assert _arcs(tr) == _arcs(jr)
    assert fst_min_path_length(tr) == j_min_path(jr)
    assert fst_min_path_length(g["tnum"]) == j_min_path(g["jnum"])
    ja = [jfst.fst_to_arrays(f) for f in (jr, jfst.fst_rmepsilon(g["jnum"]), g["jden"])]
    ta = [tfst.fst_to_arrays(f) for f in (tr, tfst.fst_rmepsilon(g["tnum"]), g["tden"])]
    for a, b in zip(ta, ja):
        for k in ("arc_src", "arc_dst", "arc_pdf", "arc_logprob", "start_logprob",
                  "final_logprob"):
            np.testing.assert_array_equal(getattr(a, k), getattr(b, k), err_msg=k)
    jp, tp = jfst.pad_graph_arrays(ja[:2]), tfst.pad_graph_arrays(ta[:2])
    assert set(tp) == set(jp)
    for k in jp:
        np.testing.assert_array_equal(tp[k], jp[k], err_msg=k)


def test_den_graph_initial_probs_and_factored_form(graphs):
    """rel <= 1e-6 on the power-iterated initial probs and A; the factored
    pdf tables and self-loop weights are equal."""
    jd = jobjf.DenominatorGraph.from_fst(graphs["jden"], graphs["jtree"].num_pdfs)
    td = tobjf.DenominatorGraph.from_fst(graphs["tden"], graphs["ttree"].num_pdfs)
    assert td.factored is not None and jd.factored is not None
    assert rel_err(td.initial_probs, jd.initial_probs) <= 1e-6
    assert rel_err(td.factored.A_fwd, jd.factored.A_fwd) <= 1e-6
    for k in ("log_self", "pdf_fwd", "pdf_self"):
        np.testing.assert_array_equal(getattr(td.factored, k), getattr(jd.factored, k))
    # a graph whose incoming arcs carry two pdfs does not factor, on both sides
    text = "0 1 1 1 0.5\n0 1 2 2 0.7\n1 0 1 1 0.1\n1 0.0"
    assert tobjf.DenominatorGraph.from_fst(tfst.Fst.from_text(text), 2).factored is None
    assert jobjf.DenominatorGraph.from_fst(jfst.Fst.from_text(text), 2).factored is None


def test_random_bigram_den_matches_the_bench_construction():
    """prep.random_bigram_den is bench_mfu's recipe: at 164 phones x 9
    successors it gives 3280 pdfs, 1641 states and 16,564 arcs, and the
    same graph as satpu's make_den_fst on the same bigram."""
    tden, ttree, trans = tprep.random_bigram_den(164, 9, seed=0)
    assert (ttree.num_pdfs, tden.num_states, tden.num_arcs) == (3280, 1641, 16564)
    small, tree, trans = tprep.random_bigram_den(12, 3, seed=1)
    jtree = jprep.BiphoneTree.build([], tree.phones)
    jtree.leaf_of, jtree.num_leaves = dict(tree.leaf_of), tree.num_leaves
    assert _arcs(small) == _arcs(jprep.make_den_fst(trans, np.full(13, 0.05), jtree))
