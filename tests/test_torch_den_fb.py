"""The den forward-backward (kernels K2f/K2b) against satpu: the port's plain
version (``den_scan_plain``) against satpu's XLA factored recursion
(values rel <= 1e-5; gradients, which are posteriors in [0, 1], max abs
<= 1e-4) and against satpu's Pallas kernel in interpret mode (values rtol
1e-4, gradients rtol 1e-3 / atol 1e-4: satpu's own tolerances, since the
interpreter emulates its bf16x3 products). Cases: leak 0 and 1e-5, B=3 (not
a multiple of 8), S not a multiple of 128, and a graph with unreachable
states. The CUDA kernels against the plain version on the card.

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
from torch_parity import rel_err

B, T = 3, 7


def _den(kind: str):
    """(den fst, num_pdfs): a 5-phone bigram den graph (S = 36, not a
    multiple of 128), or the same with two states no arc enters."""
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
    n_f, n_b = den_fb.den_fb_forward.launches, den_fb.den_fb_backward.launches
    assert torch.equal(den_fb.den_scan(*args), den_fb.den_scan_plain(*args))
    assert (den_fb.den_fb_forward.launches, den_fb.den_fb_backward.launches) == (n_f, n_b)
    with pytest.raises(ValueError, match="graph tensors"):
        den_fb.den_fb_forward(args[0], args[1], args[2], args[3][:-1], *args[4:])
    with pytest.raises(TypeError, match="float32"):
        den_fb.den_fb_forward(args[0].double(), *args[1:])


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(3, 7, 5, 3), (16, 99, 164, 9)])
def test_den_cuda_kernels_match_plain(shape):
    """K2f/K2b against the plain version on the card: values rel <= 1e-5,
    gradients max abs <= 1e-4; the small graph and the full-scale one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the den kernels have no CPU mode")
    Bc, Tc, phones, succ = shape
    fst, tree, _ = random_bigram_den(phones, succ, seed=0)
    den = DenominatorGraph.from_fst(fst, tree.num_pdfs)
    g = den.tensors("cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    ll = torch.randn((Bc, Tc, tree.num_pdfs), generator=gen, device="cuda") * 2
    llf, lls = ll.index_select(-1, g["pdf_fwd"]), ll.index_select(-1, g["pdf_self"])
    a0 = g["start"].expand(Bc, den.num_states).contiguous()
    for leaky in (0.0, 1e-5):
        lk = den_fb.leak_log(leaky)
        outs = []
        for scan in (den_fb.den_scan, den_fb.den_scan_plain):
            x1, x2 = llf.clone().requires_grad_(True), lls.clone().requires_grad_(True)
            v = den_fb.final_value(scan(x1, x2, a0, g["A"], g["log_self"], g["log_init"], lk),
                                   g["final"], g["log_init"], lk)
            v.sum().backward()
            outs.append((v.detach(), x1.grad, x2.grad))
        torch.cuda.synchronize()
        (v, gf, gs), (v_p, gf_p, gs_p) = outs
        assert ((v - v_p).abs().max() / v_p.abs().max()).item() <= 1e-5
        assert max((gf - gf_p).abs().max().item(), (gs - gs_p).abs().max().item()) <= 1e-4
