"""satpu_torch's natural-gradient preconditioning against satpu at f32 on the
CPU, from the same states: the raw gradients and per-side statistics of the
NG affine's backward, and the batched per-step phase on an update step
(t = 0) and a plain one (t = 1) over three layers in two shape groups.
Tolerances: statistics and preconditioned gradients rel <= 1e-4; d and rho
rel <= 1e-4; W up to the sign of each row (eigenvectors have none), rel
<= 1e-4."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from satpu_torch.chain import ngsgd
from torch_parity import rel_err

N = 24
LAYERS = {"a": (10, 7), "b": (10, 7), "c": (6, 5)}  # name -> (D_in, D_out)


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(0)
    data = {}
    for name, (din, dout) in LAYERS.items():
        data[name] = {"x": rng.standard_normal((N, din)).astype(np.float32),
                      "w": (rng.standard_normal((dout, din)) * 0.3).astype(np.float32),
                      "b": (rng.standard_normal((1, dout)) * 0.1).astype(np.float32),
                      "g": rng.standard_normal((N, dout)).astype(np.float32)}
    return data


def _satpu(case, t):
    """satpu: raw grads + statistics from nat_affine's vjp, then the batched
    phase. Returns (states, raw grads, stats, preconditioned grads, new states)."""
    from satpu.chain.ngsgd import nat_affine, ng_init_arrays, precondition_gradients

    ng = {}
    for i, (name, (din, dout)) in enumerate(LAYERS.items()):
        si, so = ng_init_arrays(din + 1), ng_init_arrays(dout)
        # distinct, non-trivial states per layer
        ng[name] = {"in": dict(si, t=jnp.asarray(t), d=si["d"] * (1 + i), rho=si["rho"] * 0.5),
                    "out": dict(so, t=jnp.asarray(t), d=so["d"] * (2 + i))}
    params = {n: {"weight": jnp.asarray(c["w"]), "bias": jnp.asarray(c["b"])}
              for n, c in case.items()}

    def loss(params, ng):
        return sum(jnp.sum(nat_affine(jnp.asarray(c["x"]), params[n]["weight"],
                                      params[n]["bias"], ng[n]["in"], ng[n]["out"])
                           * jnp.asarray(c["g"])) for n, c in case.items())

    grads, stats = jax.grad(loss, argnums=(0, 1))(params, ng)
    pre, new = precondition_gradients(grads, ng, stats)
    np_ = lambda tree: jax.tree_util.tree_map(np.asarray, tree)
    return np_(ng), np_(grads), np_(stats), np_(pre), np_(new)


def _port_slots(ng):
    return {n: ngsgd.NGSlot(*({k: torch.from_numpy(np.array(ng[n][s][k]))
                               for k in ("W", "d", "rho", "t")} for s in ("in", "out")))
            for n in LAYERS}


def _port_backward(case, slots):
    """Raw grads through NatAffine; fills slots[n].stats."""
    grads = {}
    for n, c in case.items():
        x = torch.from_numpy(c["x"])
        w = torch.from_numpy(c["w"]).requires_grad_(True)
        b = torch.from_numpy(c["b"][0]).requires_grad_(True)
        (ngsgd.nat_affine(x, w, b, slots[n]) * torch.from_numpy(c["g"])).sum().backward()
        grads[n] = (w.grad, b.grad)
    return grads


def test_raw_grads_and_side_statistics_match_satpu(case):
    ng, grads, stats, _, _ = _satpu(case, 0.0)
    slots = _port_slots(ng)
    raw = _port_backward(case, slots)
    for n in LAYERS:
        assert rel_err(raw[n][0].numpy(), grads[n]["weight"]) <= 1e-5
        assert rel_err(raw[n][1].numpy(), grads[n]["bias"][0]) <= 1e-5
        for side in ("in", "out"):
            got, ref = slots[n].stats[side], stats[n][side]
            assert rel_err(got["J"].numpy(), ref["W"]) <= 1e-4, (n, side)
            assert rel_err(got["n"].item(), ref["rho"]) <= 1e-4
            assert got["N"].item() == float(ref["nrows"]) == N


def _row_sign_aligned(W, ref):
    s = np.sign(np.sum(W * ref, axis=-1, keepdims=True))
    return W * np.where(s == 0, 1, s)


@pytest.mark.parametrize("t", [0.0, 1.0], ids=["update_step", "plain_step"])
def test_precondition_gradients_matches_satpu(case, t):
    ng, _, _, pre, new = _satpu(case, t)
    slots = _port_slots(ng)
    raw = _port_backward(case, slots)
    out = ngsgd.precondition_gradients(slots, {n: raw[n][0] for n in LAYERS},
                                       {n: raw[n][1] for n in LAYERS})
    for n in LAYERS:
        assert rel_err(out[n][0].numpy(), pre[n]["weight"]) <= 1e-4, n
        assert rel_err(out[n][1].numpy(), pre[n]["bias"][0]) <= 1e-4, n
        for side in ("in", "out"):
            got, ref = slots[n].state[side], new[n][side]
            assert got["t"].item() == float(ref["t"]) == t + 1.0
            assert rel_err(got["d"].numpy(), ref["d"]) <= 1e-4
            assert rel_err(got["rho"].item(), ref["rho"]) <= 1e-4
            W = _row_sign_aligned(got["W"].numpy(), ref["W"])
            assert rel_err(W, ref["W"]) <= 1e-4, (n, side)
        assert slots[n].stats is None


def test_precondition_directions_matches_satpu():
    """The per-layer reference path (kept for tests) on an update step."""
    from satpu.chain.ngsgd import ng_init, precondition_directions as jpd

    X = np.random.default_rng(1).standard_normal((30, 9)).astype(np.float32)
    js = ng_init(9)
    ts = {"W": torch.from_numpy(np.array(js.W)), "d": torch.from_numpy(np.array(js.d)),
          "rho": torch.tensor(float(js.rho)), "t": torch.tensor(0.0)}
    js2, Xh_ref, g_ref = jpd(js, jnp.asarray(X))
    ts2, Xh, g = ngsgd.precondition_directions(ts, torch.from_numpy(X))
    assert rel_err(Xh.numpy(), np.asarray(Xh_ref)) <= 1e-4
    assert rel_err(g.item(), float(g_ref)) <= 1e-4
    assert rel_err(ts2["d"].numpy(), np.asarray(js2.d)) <= 1e-4
    assert rel_err(_row_sign_aligned(ts2["W"].numpy(), np.asarray(js2.W)),
                   np.asarray(js2.W)) <= 1e-4
