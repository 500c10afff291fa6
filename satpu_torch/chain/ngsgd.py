"""Online natural-gradient preconditioning, NG-SGD (port of ``satpu.chain.ngsgd``).

Kaldi's ``OnlineNaturalGradient`` (Povey, Zhang & Khudanpur, ICLR 2015
workshop): each side of an affine layer (its input rows with a bias column
appended, and its output gradients) keeps a rank-R estimate of its Fisher
matrix, ``F = W^T diag(d) W + rho (I - W^T W)`` with orthonormal rows W
[R, D], and a gradient is multiplied on both sides by ``(F + beta I)^-1``
(Woodbury) with a rescale gamma that preserves its norm. Defaults follow
Kaldi: alpha 4, 2000 samples of history, a subspace update every 4th step.

The work is split as in satpu:

- ``NatAffine`` (an ``autograd.Function``): the forward is ``x @ W.T + b``;
  the backward returns the RAW gradients and leaves each side's statistics
  ``J = W Z^T Z / N``, ``n = sum Z^2`` and ``N`` in the layer's ``NGSlot``;
- ``precondition_gradients``: once per step, every layer's gradient is
  preconditioned from its states and statistics, batched over layers of
  the same shape, and every state advances; every ``update_period``-th step
  runs the power-iteration update with one batched R x R ``eigh``.

A state is a dict ``{"W" [R, D], "d" [R], "rho" [], "t" []}`` of f32
tensors; ``t`` counts the steps taken.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

# (alpha, num_samples_history, update_period): Kaldi's defaults
NG_HYPER = (4.0, 2000.0, 4)

State = Dict[str, torch.Tensor]


def ng_init(dim: int, rank: Optional[int] = None,
            generator: Optional[torch.Generator] = None) -> State:
    """A fresh state for a side of width ``dim``: a random orthonormal basis
    of rank min(40, dim // 2), d = 0.1, rho = 0.1, t = 0 (on the CPU)."""
    if rank is None:
        rank = max(1, min(40, dim // 2))
    W = torch.linalg.qr(torch.randn((dim, rank), generator=generator))[0].T.contiguous()
    return {"W": W, "d": torch.full((rank,), 0.1), "rho": torch.tensor(0.1),
            "t": torch.tensor(0.0)}


def _precondition(X: torch.Tensor, state: State, alpha: float = NG_HYPER[0]
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """X [N, D] -> (gamma * X (F + beta I)^-1, gamma)."""
    W, d, rho = state["W"], state["d"], state["rho"]
    R, D = W.shape
    tr_F = d.sum() + rho * (D - R)
    beta = alpha * tr_F / D + 1e-20
    inv_rest = 1.0 / (rho + beta)
    X_hat = X * inv_rest + ((X @ W.T) * (1.0 / (d + beta) - inv_rest)) @ W
    gamma = torch.sqrt(torch.clamp((X * X).sum(), min=1e-20)
                       / torch.clamp((X_hat * X_hat).sum(), min=1e-20))
    return X_hat * gamma, gamma


def _power_update(W, d, rho, J, n, N, eta, Rt=None):
    """One power-iteration step of the Fisher eigenbasis from the projected
    statistic J = W Z^T Z / N, batched over leading dimensions.

    With F' = (1-eta) F + eta Z^T Z / N, W F' = (1-eta) diag(d) W + eta J
    exactly, so with Y = eta J + (1-eta) diag(d) W the update is
    W' = diag(lam^-1/2) U^T Y where (lam, U) = eigh(Y Y^T), an R x R
    matrix built from J J^T and Rt = J W^T alone; d' = sqrt(lam), and rho'
    keeps the trace (tr Z^T Z / N = n / N). Directions with lam ~ 0 get
    zero rows. W [..., R, D]; d [..., R]; rho, n, N, eta [...]."""
    R, D = W.shape[-2:]
    if Rt is None:
        Rt = J @ W.transpose(-1, -2)
    K = J @ J.transpose(-1, -2)
    e = eta[..., None, None]
    Z = (e ** 2 * K + (e * (1.0 - e)) * (d[..., :, None] * Rt + Rt * d[..., None, :])
         + torch.diag_embed(((1.0 - eta)[..., None] * d) ** 2))
    Z = 0.5 * (Z + Z.transpose(-1, -2))
    lam, U = torch.linalg.eigh(Z)  # ascending
    lam, U = lam.flip(-1), U.flip(-1)
    eps = torch.clamp(lam.amax(dim=-1, keepdim=True), min=1e-20) * 1e-10
    inv_sqrt = torch.where(lam > eps, 1.0 / torch.sqrt(torch.maximum(lam, eps)),
                           torch.zeros_like(lam))
    Y = e * J + (1.0 - e) * d[..., :, None] * W
    W_new = inv_sqrt[..., :, None] * (U.transpose(-1, -2) @ Y)
    d_new = torch.clamp(torch.sqrt(torch.clamp(lam, min=0.0)), min=1e-10)
    tr_F = (1.0 - eta) * (d.sum(-1) + rho * (D - R)) + eta * n / N
    rho_new = torch.clamp((tr_F - d_new.sum(-1)) / max(D - R, 1), min=1e-10)
    return W_new, d_new, rho_new


def _side_stats(Z: torch.Tensor, W: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Statistics of one side for one minibatch: J = W Z^T Z / N [R, D],
    n = sum Z^2, N = rows."""
    N = Z.shape[0]
    Zf = Z.to(W.dtype)
    return {"J": ((Zf @ W.T).T @ Zf) / N, "n": (Zf * Zf).sum(),
            "N": torch.tensor(float(N), dtype=W.dtype, device=Z.device)}


def precondition_directions(state: State, X: torch.Tensor,
                            hyper=NG_HYPER) -> Tuple[State, torch.Tensor, torch.Tensor]:
    """Kaldi's PreconditionDirections on rows X [N, D]: returns (new state,
    X_hat, gamma); the subspace update runs every ``update_period`` calls."""
    alpha, nsh, period = hyper
    X_hat, gamma = _precondition(X, state, alpha)
    new = dict(state)
    if int(state["t"].item()) % period == 0:
        st = _side_stats(X, state["W"])
        eta = torch.clamp(st["N"] / nsh, 1e-3, 0.9)
        new["W"], new["d"], new["rho"] = _power_update(
            state["W"], state["d"], state["rho"], st["J"], st["n"], st["N"], eta)
    new["t"] = state["t"] + 1.0
    return new, X_hat, gamma


class NGSlot:
    """The preconditioner states of one affine layer (``state["in"]`` for
    its input rows with the bias column, ``state["out"]`` for its output
    gradients) and the statistics its last backward left in ``stats``."""

    def __init__(self, state_in: State, state_out: State):
        self.state = {"in": state_in, "out": state_out}
        self.stats: Optional[Dict[str, Dict[str, torch.Tensor]]] = None


class NatAffine(torch.autograd.Function):
    """y = x2d @ weight.T + bias; the backward returns raw gradients and
    records the per-side NG statistics in ``slot.stats``."""

    @staticmethod
    def forward(ctx, x2d, weight, bias, slot: NGSlot):
        ctx.save_for_backward(x2d, weight)
        ctx.slot = slot
        return torch.addmm(bias, x2d, weight.T)

    @staticmethod
    def backward(ctx, g):
        x2d, weight = ctx.saved_tensors
        slot = ctx.slot
        N = x2d.shape[0]
        Z_in = torch.cat([x2d, torch.ones((N, 1), dtype=x2d.dtype, device=x2d.device)], 1)
        slot.stats = {"in": _side_stats(Z_in, slot.state["in"]["W"]),
                      "out": _side_stats(g, slot.state["out"]["W"])}
        return g @ weight, g.T @ x2d, g.sum(0), None


def nat_affine(x2d: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               slot: NGSlot) -> torch.Tensor:
    """x2d [N, D_in], weight [D_out, D_in], bias [D_out] -> [N, D_out]."""
    return NatAffine.apply(x2d, weight, bias, slot)


def _gamma_factors(W, d, rho, c, n, alpha):
    """Woodbury factors and the norm-preserving rescale of one side from its
    statistics: X_hat = gamma X S with S = inv_rest I + W^T diag(delta) W,
    gamma^2 = n / (inv_rest^2 n + sum((2 inv_rest delta + delta^2) c)), with
    c the column norms of X W^T. Batched over leading dimensions."""
    R, D = W.shape[-2:]
    tr_F = d.sum(-1) + rho * (D - R)
    beta = alpha * tr_F / D + 1e-20
    inv_rest = 1.0 / (rho + beta)
    delta = 1.0 / (d + beta[..., None]) - inv_rest[..., None]
    den = inv_rest ** 2 * n + ((2.0 * inv_rest[..., None] * delta + delta ** 2) * c).sum(-1)
    gamma = torch.sqrt(torch.clamp(n, min=1e-20) / torch.clamp(den, min=1e-20))
    return inv_rest, delta, gamma


def precondition_gradients(slots: Dict[str, NGSlot], weights: Dict[str, torch.Tensor],
                           biases: Dict[str, torch.Tensor], hyper=NG_HYPER
                           ) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
    """The per-step batched NG phase.

    slots: layer name -> NGSlot whose ``stats`` the backward just filled;
    weights / biases: layer name -> RAW gradient [D_out, D_in] / [D_out].
    Returns layer name -> (preconditioned weight grad, bias grad), and
    advances every slot's states in place. All states step in lockstep, so
    the first one's ``t`` decides whether this is an update step."""
    alpha, nsh, period = float(hyper[0]), float(hyper[1]), int(hyper[2])
    if not slots:
        return {}
    first = next(iter(slots.values()))
    do_update = int(first.state["in"]["t"].item()) % period == 0
    groups: Dict[Tuple, List[str]] = {}
    for name, slot in slots.items():
        if slot.stats is None:
            raise RuntimeError(f"NG layer {name} has no statistics: it took no backward")
        key = (tuple(slot.state["in"]["W"].shape), tuple(slot.state["out"]["W"].shape))
        groups.setdefault(key, []).append(name)
    out = {}
    for names in groups.values():
        g_full = torch.stack([torch.cat([weights[n], biases[n][:, None]], 1) for n in names])
        sides = {}
        for side in ("in", "out"):
            st = {k: torch.stack([slots[n].state[side][k] for n in names])
                  for k in ("W", "d", "rho", "t")}
            sx = {k: torch.stack([slots[n].stats[side][k] for n in names])
                  for k in ("J", "n", "N")}
            Rt = sx["J"] @ st["W"].transpose(-1, -2)
            c = sx["N"][:, None] * torch.diagonal(Rt, dim1=-2, dim2=-1)
            sides[side] = (st, sx, Rt, _gamma_factors(st["W"], st["d"], st["rho"], c,
                                                      sx["n"], alpha))
        (si, _, _, (inv_i, del_i, gam_i)) = sides["in"]
        (so, _, _, (inv_o, del_o, gam_o)) = sides["out"]
        Wi, Wo = si["W"], so["W"]
        M1 = (inv_i[:, None, None] * g_full
              + ((g_full @ Wi.transpose(-1, -2)) * del_i[:, None, :]) @ Wi)
        M2 = (inv_o[:, None, None] * M1
              + Wo.transpose(-1, -2) @ (del_o[:, :, None] * (Wo @ M1)))
        g_pre = M2 * ((gam_i * gam_o) ** 2)[:, None, None]
        for i, n in enumerate(names):
            out[n] = (g_pre[i, :, :-1], g_pre[i, :, -1])
        for side, (st, sx, Rt, _) in sides.items():
            if do_update:
                eta = torch.clamp(sx["N"] / nsh, 1e-3, 0.9)
                W_new, d_new, rho_new = _power_update(st["W"], st["d"], st["rho"], sx["J"],
                                                      sx["n"], sx["N"], eta, Rt=Rt)
            for i, n in enumerate(names):
                s = slots[n].state[side]
                if do_update:
                    s["W"], s["d"], s["rho"] = W_new[i], d_new[i], rho_new[i]
                s["t"] = s["t"] + 1.0
    for slot in slots.values():
        slot.stats = None
    return out
