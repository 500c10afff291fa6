"""satpu_torch's chain objective against satpu at f32 on the CPU: the
numerator forward over padded graphs with num_frames < T, the den forward
through both branches (factored, per-arc), and chain_objf_and_grad's loss,
every metric and its gradients in chain_out and xent_out. Tolerance: rel
<= 1e-4 on values and gradients (the gradients are posterior differences of
order one)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from satpu_torch.chain import objf as tobjf
from satpu_torch.chain.fst import fst_rmepsilon, fst_to_arrays, pad_graph_arrays
from satpu_torch.chain.prep import numerator_fst, random_bigram_den, random_phone_walk
from torch_parity import rel_err

B, T = 3, 7
NUM_FRAMES = np.array([7, 5, 6], np.int32)


@pytest.fixture(scope="module")
def setup():
    from satpu.chain.fst import Fst as JFst
    from satpu.chain.objf import DenominatorGraph as JDen

    fst, tree, trans = random_bigram_den(5, 3, seed=5)
    P = tree.num_pdfs
    rng = np.random.default_rng(6)
    nums = [fst_to_arrays(fst_rmepsilon(numerator_fst(random_phone_walk(trans, n // 2, rng),
                                                      tree)))
            for n in NUM_FRAMES]
    graphs = pad_graph_arrays(nums)
    chain_out = (rng.standard_normal((B, T, P)) * 2).astype(np.float32)
    xent = rng.standard_normal((B, T, P)).astype(np.float32)
    xent_out = (xent - np.log(np.exp(xent).sum(-1, keepdims=True))).astype(np.float32)
    return {"P": P, "graphs": graphs, "chain_out": chain_out, "xent_out": xent_out,
            "tden": tobjf.DenominatorGraph.from_fst(fst, P),
            "jden": JDen.from_fst(JFst.from_text(fst.to_text()), P)}


def _t(x, grad=False):
    return torch.from_numpy(np.array(x)).requires_grad_(grad)


def test_num_forward_matches_satpu(setup):
    from satpu.chain.objf import num_forward as jnum

    s = setup
    jg = {k: jnp.asarray(v) for k, v in s["graphs"].items()}
    f = lambda x: jnum(x, jg, jnp.asarray(NUM_FRAMES))
    ref = np.asarray(f(jnp.asarray(s["chain_out"])))
    g_ref = np.asarray(jax.grad(lambda x: jnp.sum(f(x)))(jnp.asarray(s["chain_out"])))
    x = _t(s["chain_out"], True)
    out = tobjf.num_forward(x, tobjf.graphs_to_torch(s["graphs"], "cpu"),
                            torch.from_numpy(NUM_FRAMES))
    out.sum().backward()
    assert rel_err(out.detach().numpy(), ref) <= 1e-4
    assert rel_err(x.grad.numpy(), g_ref) <= 1e-4
    # frames past num_frames carry no numerator posterior
    assert x.grad[1, 5:].abs().max().item() == 0.0


@pytest.mark.parametrize("factored", [True, False])
def test_den_forward_matches_satpu(setup, factored, monkeypatch):
    from satpu.chain.objf import den_forward as jden

    monkeypatch.setenv("SATPU_PALLAS_FB", "0")
    s = setup
    f = lambda x: jden(x, s["jden"], 1e-5, use_factored=factored)
    ref = np.asarray(f(jnp.asarray(s["chain_out"])))
    g_ref = np.asarray(jax.grad(lambda x: jnp.sum(f(x)))(jnp.asarray(s["chain_out"])))
    x = _t(s["chain_out"], True)
    out = tobjf.den_forward(x, s["tden"], 1e-5, use_factored=factored)
    out.sum().backward()
    assert rel_err(out.detach().numpy(), ref) <= 1e-4
    assert rel_err(x.grad.numpy(), g_ref) <= 1e-4


def test_chain_objf_and_grad_matches_satpu(setup, monkeypatch):
    from satpu.chain.objf import chain_objf_and_grad as jobjf

    monkeypatch.setenv("SATPU_PALLAS_FB", "0")
    s = setup
    jg = {k: jnp.asarray(v) for k, v in s["graphs"].items()}

    def loss(co, xo):
        return jobjf(co, xo, jg, s["jden"], num_frames=jnp.asarray(NUM_FRAMES))

    (l_ref, m_ref), (gc_ref, gx_ref) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(s["chain_out"]), jnp.asarray(s["xent_out"]))
    co, xo = _t(s["chain_out"], True), _t(s["xent_out"], True)
    l, m = tobjf.chain_objf_and_grad(co, xo, tobjf.graphs_to_torch(s["graphs"], "cpu"),
                                     s["tden"], num_frames=torch.from_numpy(NUM_FRAMES))
    l.backward()
    assert set(m) == set(m_ref)
    assert rel_err(l.item(), float(l_ref)) <= 1e-4
    for k in m:
        assert rel_err(m[k].item(), float(m_ref[k])) <= 1e-4, k
    assert rel_err(co.grad.numpy(), np.asarray(gc_ref)) <= 1e-4
    assert rel_err(xo.grad.numpy(), np.asarray(gx_ref)) <= 1e-4
    diag = tobjf.compute_chain_objf(co.detach(), tobjf.graphs_to_torch(s["graphs"], "cpu"),
                                    s["tden"], torch.from_numpy(NUM_FRAMES))
    assert rel_err(diag.item(), float(m_ref["chain_objf"])) <= 1e-4
