"""The den forward-backward (kernels K2f/K2b) against satpu: the port's plain
version (``den_scan_plain``) against satpu's XLA factored recursion
(values rel <= 1e-5; gradients, which are posteriors in [0, 1], max abs
<= 1e-4) and against satpu's Pallas kernel in interpret mode (values rtol
1e-4, gradients rtol 1e-3 / atol 1e-4: satpu's own tolerances, since the
interpreter emulates its bf16x3 products). Cases: leak 0 and 1e-5, B=3 (not
a multiple of 8), S not a multiple of 128, and a graph with unreachable
states. ``den_sparse`` (the kernels' form of A) against the dense A. The
CUDA kernels against the plain version on the card.

jax is imported inside the tests that use it, so the card test also runs
where jax is absent: ``python -m pytest --noconftest -m gpu
tests/test_torch_den_fb.py``."""
import numpy as np
import pytest
import torch

from satpu_torch.chain import den_fb
from satpu_torch.chain.fst import Arc
from satpu_torch.chain.objf import DenominatorGraph
from satpu_torch.chain.prep import random_bigram_den
from satpu_torch.utils.trace import counters
from torch_parity import rel_err

B, T = 3, 7


def _launches():
    """(K2f, K2b) launches counted so far (``utils.trace``'s counters)."""
    c = counters()
    return c.get("k2f.launches", 0), c.get("k2b.launches", 0)


def _den(kind: str):
    """(den fst, num_pdfs): a 5-phone bigram den graph (S = 36, not a
    multiple of 128), the same with two states no arc enters, or a
    200-phone one with 25 successors a phone (130,200 arcs in A, more than
    16-bit pointers hold)."""
    if kind == "wide":
        fst, tree, _ = random_bigram_den(200, 25, seed=0)
        return fst, tree.num_pdfs
    fst, tree, _ = random_bigram_den(5, 3, seed=2)
    if kind == "unreachable":
        for pdf in (3, 7):  # a topology self-loop each, and a start arc's copy
            s = fst.add_state()
            fst.add_arc(s, Arc(pdf + 1, pdf + 1, 0.3, s))
            fst.add_arc(s, fst.arcs[fst.start][0])
            fst.set_final(s, 0.5)
    return fst, tree.num_pdfs


def _port(ll: np.ndarray, den: DenominatorGraph, leaky: float):
    """(value [B], d sum(value) / d ll) through den_scan_plain."""
    g = den.tensors("cpu")
    x = torch.from_numpy(ll).requires_grad_(True)
    lk = den_fb.leak_log(leaky)
    a0 = g["start"].expand(ll.shape[0], den.num_states).contiguous()
    alpha_T = den_fb.den_scan_plain(x.index_select(-1, g["pdf_fwd"]),
                                    x.index_select(-1, g["pdf_self"]), a0, g["A"],
                                    g["log_self"], g["log_init"], lk)
    v = den_fb.final_value(alpha_T, g["final"], g["log_init"], lk)
    v.sum().backward()
    return v.detach().numpy(), x.grad.numpy()


def _satpu(ll, fst_text, num_pdfs, leaky, pallas: bool, monkeypatch):
    import jax
    import jax.numpy as jnp

    from satpu.chain.fst import Fst
    from satpu.chain.objf import DenominatorGraph as JDen
    from satpu.chain.objf import den_forward

    jden = JDen.from_fst(Fst.from_text(fst_text), num_pdfs)
    assert jden.factored is not None
    monkeypatch.setenv("SATPU_PALLAS_FB", "1" if pallas else "0")
    f = lambda x: den_forward(x, jden, leaky, use_factored=True)
    x = jnp.asarray(ll)
    return np.asarray(f(x)), np.asarray(jax.grad(lambda x: jnp.sum(f(x)))(x))


@pytest.mark.parametrize("leaky", [0.0, 1e-5])
@pytest.mark.parametrize("kind", ["bigram", "unreachable"])
def test_den_scan_plain_matches_satpu(kind, leaky, monkeypatch):
    fst, P = _den(kind)
    den = DenominatorGraph.from_fst(fst, P)
    assert den.factored is not None and den.num_states % 128 != 0
    ll = (np.random.default_rng(3).standard_normal((B, T, P)) * 2).astype(np.float32)
    v, g = _port(ll, den, leaky)
    assert np.isfinite(v).all() and np.isfinite(g).all()
    # every frame's den posteriors sum to one
    np.testing.assert_allclose(g.sum(-1), 1.0, atol=1e-4)
    text = fst.to_text()
    v_x, g_x = _satpu(ll, text, P, leaky, False, monkeypatch)
    assert rel_err(v, v_x) <= 1e-5, rel_err(v, v_x)
    assert np.abs(g - g_x).max() <= 1e-4
    v_p, g_p = _satpu(ll, text, P, leaky, True, monkeypatch)
    np.testing.assert_allclose(v, v_p, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(g, g_p, rtol=1e-3, atol=1e-4)


def test_wrappers_run_the_plain_version_on_the_cpu():
    """On CPU tensors den_scan is den_scan_plain, and nothing is launched."""
    fst, P = _den("bigram")
    den = DenominatorGraph.from_fst(fst, P)
    ll = np.random.default_rng(4).standard_normal((B, T, P)).astype(np.float32)
    g = den.tensors("cpu")
    x = torch.from_numpy(ll)
    args = (x.index_select(-1, g["pdf_fwd"]), x.index_select(-1, g["pdf_self"]),
            g["start"].expand(B, den.num_states).contiguous(), g["A"], g["log_self"],
            g["log_init"], den_fb.leak_log(1e-5))
    n = _launches()
    assert torch.equal(den_fb.den_scan(*args), den_fb.den_scan_plain(*args))
    assert _launches() == n
    with pytest.raises(ValueError, match="graph tensors"):
        den_fb.den_fb_forward(args[0], args[1], args[2], args[3][:-1], *args[4:])
    with pytest.raises(TypeError, match="float32"):
        den_fb.den_fb_forward(args[0].double(), *args[1:])


def _dense(S: int, ptr, idx, val, by_source: bool) -> torch.Tensor:
    """A [S, S] rebuilt from one half of the sparse form."""
    rows = torch.repeat_interleave(torch.arange(S), torch.diff(ptr.long()))
    A = torch.zeros(S, S)
    ij = (rows, idx.long()) if by_source else (idx.long(), rows)
    A[ij] = val
    return A


def _gather_sum(x, ptr, idx, val):
    """out[:, s] = sum over the arcs p of row s of x[:, idx[p]] * val[p]."""
    rows = torch.repeat_interleave(torch.arange(x.shape[-1]), torch.diff(ptr.long()))
    return torch.zeros_like(x).index_add_(-1, rows, x[:, idx.long()] * val)


@pytest.mark.parametrize("kind", ["bigram", "unreachable", "wide"])
def test_den_sparse_round_trips_A(kind):
    """A's nonzeros by destination and by source give A back exactly; every
    row is in ascending order of the other state; sizes and types are the
    kernels' (int32 pointers, int16 states, f32 values)."""
    fst, P = _den(kind)
    den = DenominatorGraph.from_fst(fst, P)
    A = torch.from_numpy(den.factored.A_fwd)
    S, nnz = A.shape[0], int((A != 0).sum())
    sp = den_fb.den_sparse(A)
    assert [x.dtype for x in sp] == [torch.int32, torch.int16, torch.float32] * 2
    assert [x.numel() for x in sp] == [S + 1, nnz, nnz] * 2
    if kind == "wide":
        assert nnz > 65535
    if kind == "unreachable":  # states no arc enters: empty by-destination rows
        assert int((torch.diff(sp.in_ptr) == 0).sum()) >= 2
    assert torch.equal(_dense(S, *sp[:3], by_source=False), A)
    assert torch.equal(_dense(S, *sp[3:], by_source=True), A)
    for ptr, idx in ((sp.in_ptr, sp.in_src), (sp.out_ptr, sp.out_dst)):
        assert ptr[0] == 0 and ptr[-1] == nnz and bool((torch.diff(ptr) >= 0).all())
        rows = torch.repeat_interleave(torch.arange(S), torch.diff(ptr.long()))
        same_row = rows[1:] == rows[:-1]
        assert bool((torch.diff(idx.long())[same_row] > 0).all())
    assert torch.equal(den.tensors("cpu")["A_sparse"].out_val, sp.out_val)


@pytest.mark.parametrize("kind", ["bigram", "unreachable", "wide"])
def test_den_sparse_gather_sums_match_dense(kind):
    """The kernels' two products through the sparse form: by destination
    e @ A, by source d @ A^T, rel <= 1e-6 (f32, another order of the sums)."""
    fst, P = _den(kind)
    den = DenominatorGraph.from_fst(fst, P)
    A = torch.from_numpy(den.factored.A_fwd)
    sp = den_fb.den_sparse(A)
    rng = np.random.default_rng(5)
    e = torch.from_numpy(rng.uniform(0, 1, (B, A.shape[0])).astype(np.float32))
    d = torch.from_numpy(rng.standard_normal((B, A.shape[0])).astype(np.float32))
    assert rel_err(_gather_sum(e, *sp[:3]).numpy(), (e @ A).numpy()) <= 1e-6
    assert rel_err(_gather_sum(d, *sp[3:]).numpy(), (d @ A.T).numpy()) <= 1e-6


def test_den_scan_with_the_sparse_form_on_the_cpu_is_plain():
    """With A's sparse form passed, den_scan on CPU tensors still equals
    den_scan_plain (values and gradients) and launches nothing; the kernels'
    argument check refuses a missing or mismatched sparse form."""
    fst, P = _den("unreachable")
    den = DenominatorGraph.from_fst(fst, P)
    g = den.tensors("cpu")
    ll = np.random.default_rng(6).standard_normal((B, T, P)).astype(np.float32)
    lk = den_fb.leak_log(1e-5)
    a0 = g["start"].expand(B, den.num_states).contiguous()
    n = _launches()
    outs = []
    for scan, extra in ((den_fb.den_scan, (g["A_sparse"],)), (den_fb.den_scan_plain, ())):
        x = torch.from_numpy(ll).requires_grad_(True)
        alpha_T = scan(x.index_select(-1, g["pdf_fwd"]), x.index_select(-1, g["pdf_self"]), a0,
                       g["A"], g["log_self"], g["log_init"], lk, *extra)
        alpha_T.sum().backward()
        outs.append((alpha_T.detach(), x.grad))
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])
    assert _launches() == n
    S, cpu = den.num_states, torch.device("cpu")
    arcs, nnz = den_fb._arcs("k", g["A_sparse"], S, cpu, backward=False)
    assert len(arcs) == 3 and nnz == g["A_sparse"].in_src.numel()
    with pytest.raises(ValueError, match="sparse form"):
        den_fb._arcs("k", None, S, cpu, backward=True)
    with pytest.raises(ValueError, match="does not match"):
        den_fb._arcs("k", g["A_sparse"], S + 1, cpu, backward=True)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(3, 7, 5, 3, "shared"), (16, 99, 164, 9, "shared"),
                                   (1, 99, 164, 9, "shared"), (64, 99, 164, 9, "shared"),
                                   (4, 20, 400, 9, "global"), (2, 10, 200, 25, "global")])
def test_den_cuda_kernels_match_plain(shape):
    """K2f/K2b against the plain version on the card: values rel <= 1e-5,
    gradients max abs <= 1e-4, the same bits from two calls, and the arcs'
    placement taken; the small graph, the full-scale one at B = 1, 16, 64,
    the 4001-state one (its arcs do not fit shared memory), and a 5201-state
    one with 130,200 arcs and in-rows split across a warp."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the den kernels have no CPU mode")
    Bc, Tc, phones, succ, placement = shape
    fst, tree, _ = random_bigram_den(phones, succ, seed=0)
    den = DenominatorGraph.from_fst(fst, tree.num_pdfs)
    g = den.tensors("cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    ll = torch.randn((Bc, Tc, tree.num_pdfs), generator=gen, device="cuda") * 2
    llf, lls = ll.index_select(-1, g["pdf_fwd"]), ll.index_select(-1, g["pdf_self"])
    a0 = g["start"].expand(Bc, den.num_states).contiguous()
    graph = (g["A"], g["log_self"], g["log_init"])
    for leaky in (0.0, 1e-5):
        lk = den_fb.leak_log(leaky)
        outs = []
        for scan, extra in ((den_fb.den_scan, (g["A_sparse"],)), (den_fb.den_scan, (g["A_sparse"],)),
                            (den_fb.den_scan_plain, ())):
            x1, x2 = llf.clone().requires_grad_(True), lls.clone().requires_grad_(True)
            v = den_fb.final_value(scan(x1, x2, a0, *graph, lk, *extra), g["final"],
                                   g["log_init"], lk)
            v.sum().backward()
            outs.append((v.detach(), x1.grad, x2.grad))
        torch.cuda.synchronize()
        nnz = g["A_sparse"].in_src.numel()
        assert den_fb.placement(den.num_states, nnz, backward=False) == placement
        assert den_fb.placement(den.num_states, nnz, backward=True) == placement
        (v, gf, gs), again, (v_p, gf_p, gs_p) = outs
        assert all(torch.equal(a, b) for a, b in zip((v, gf, gs), again))
        assert ((v - v_p).abs().max() / v_p.abs().max()).item() <= 1e-5
        assert max((gf - gf_p).abs().max().item(), (gs - gs_p).abs().max().item()) <= 1e-4
    with pytest.raises(ValueError, match="sparse form"):
        den_fb.den_fb_forward(llf, lls, a0, *graph, lk)


@pytest.mark.gpu
def test_den_cuda_kernels_launch_on_their_tensors_card():
    """K2f/K2b on cuda:1 tensors while cuda:0 is current (a data-parallel
    rank's or ``train_asr --device cuda:1``'s steps), at the full-scale
    graph and B=16, T=99: the plain version's values (rel 1e-5) and
    gradients (1e-4 abs) on that card, two calls bitwise equal, one launch
    a call, and cuda:0 still current."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards: a launch on another card than the current one")
    fst, tree, _ = random_bigram_den(164, 9, seed=0)
    den = DenominatorGraph.from_fst(fst, tree.num_pdfs)
    dev = torch.device("cuda", 1)
    g = den.tensors(dev)
    ll = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (16, 99, tree.num_pdfs)).astype(np.float32) * 2).to(dev)
    llf, lls = ll.index_select(-1, g["pdf_fwd"]), ll.index_select(-1, g["pdf_self"])
    a0 = g["start"].expand(16, den.num_states).contiguous()
    graph = (g["A"], g["log_self"], g["log_init"])
    lk = den_fb.leak_log(1e-5)
    with torch.cuda.device(0):
        outs = []
        for scan, extra in ((den_fb.den_scan, (g["A_sparse"],)), (den_fb.den_scan, (g["A_sparse"],)),
                            (den_fb.den_scan_plain, ())):
            calls = _launches()
            x1, x2 = llf.clone().requires_grad_(True), lls.clone().requires_grad_(True)
            v = den_fb.final_value(scan(x1, x2, a0, *graph, lk, *extra), g["final"],
                                   g["log_init"], lk)
            v.sum().backward()
            outs.append((v.detach(), x1.grad, x2.grad))
            if extra:
                assert tuple(a - b for a, b in zip(_launches(), calls)) == (1, 1)
        torch.cuda.synchronize(dev)
        assert torch.cuda.current_device() == 0
    (v, gf, gs), again, (v_p, gf_p, gs_p) = outs
    assert v.device == dev and gf.device == dev
    assert all(torch.equal(a, b) for a, b in zip((v, gf, gs), again))
    assert ((v - v_p).abs().max() / v_p.abs().max()).item() <= 1e-5
    assert max((gf - gf_p).abs().max().item(), (gs - gs_p).abs().max().item()) <= 1e-4
