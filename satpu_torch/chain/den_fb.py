"""LF-MMI denominator forward-backward over the destination-factored den
graph: kernels K2f (forward) and K2b (backward) and their plain versions
(port of ``satpu.chain.pallas_fb``).

For every batch row the forward takes T sequential steps over S states:

    leaked = logaddexp(alpha, log_leak + log_init + logsumexp(alpha))
    m      = max(leaked)
    alpha' = max(logaddexp(log(max(exp(leaked - m) @ A, 1e-30)) + m + llf_t,
                           leaked + log_self + lls_t), NEG_INF)

and stores every alpha; the backward is the exact VJP of that recursion in
reverse, recomputing each step from the stored alphas. ``log_leak`` below
``NEG_INF / 2`` switches the leak off (leaky_hmm_coefficient = 0).

On CUDA tensors ``den_fb_forward`` / ``den_fb_backward`` launch the kernels
of ``csrc/den_fb.cu`` (built on first use; one launch a call, one block per
batch row running all T frames) and count the calls in the counters
``k2f.launches`` and ``k2b.launches`` (``utils.trace``).
The kernels read A's nonzeros, ``den_sparse(A)``, which the caller passes
(``DenominatorGraph.tensors`` caches it as ``"A_sparse"``); they keep the
arcs in a block's shared memory when they fit and read them from device
memory otherwise (``placement``). On CPU tensors the wrappers run the
plain versions, the same formulas in PyTorch ops over the dense A.
``den_scan`` wraps both in a ``torch.autograd.Function`` (gradients flow
to llf and lls only: the graph tensors are constants) whose backward runs
in the span ``chain.den_backward``; ``den_scan_plain`` is the same function
through the plain versions on any device. The final value
``logsumexp(leak(alpha_T) + final)`` stays outside, in ``final_value``.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..utils import cuda_build
from ..utils.trace import span

NEG_INF = -1e30
TINY = 1e-30  # a normal f32: log(TINY) stays finite


def leak_log(leaky_hmm_coefficient: float) -> float:
    """log(leaky_hmm_coefficient), or 2 * NEG_INF (leak off) for 0."""
    return math.log(leaky_hmm_coefficient) if leaky_hmm_coefficient > 0 else 2 * NEG_INF


def _guard_exp(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """exp(x - y), 0 where y is the clamped log(0)."""
    safe = y > NEG_INF / 2
    return torch.where(safe, torch.exp(x - torch.where(safe, y, torch.zeros_like(y))),
                       torch.zeros_like(x))


def _nonzero_max(x: torch.Tensor) -> torch.Tensor:
    m = x.amax(dim=-1, keepdim=True)
    return torch.where(m > NEG_INF / 2, m, torch.zeros_like(m))


def rescaled_logsumexp_step(alpha, arc_score_t, src, dst):
    """One step over a graph given as arc lists (the plain numerator of
    ``num_fb`` and the per-arc den of ``objf.den_forward``): (alpha' [B, S],
    m [B, 1]) from alpha [B, S]. arc_score_t [B, E] holds w + ll_t[pdf] of
    every arc, src/dst [B, E] its states; m is the frame's rescale, held
    constant."""
    scores = alpha.gather(-1, src) + arc_score_t
    m = _nonzero_max(scores).detach()
    sums = torch.zeros_like(alpha).scatter_add(-1, dst, torch.exp(scores - m))
    # the floor is a normal f32 (log stays finite), and the clamp keeps the
    # next step free of -inf
    return torch.clamp(torch.log(torch.clamp(sums, min=TINY)) + m, min=NEG_INF), m


def _leak(alpha: torch.Tensor, log_init: torch.Tensor, log_leak: float):
    """(leaked, lse) with lse = logsumexp(alpha) over states."""
    m0 = _nonzero_max(alpha)
    lse = torch.log(torch.exp(alpha - m0).sum(dim=-1, keepdim=True)) + m0
    if log_leak < NEG_INF / 2:
        return alpha, lse
    return torch.logaddexp(alpha, log_leak + log_init + lse), lse


def _step(alpha, A, log_self, log_init, log_leak, llf_t, lls_t):
    """One forward step; returns alpha' and the internals the VJP needs."""
    leaked, lse = _leak(alpha, log_init, log_leak)
    m = _nonzero_max(leaked)
    e = torch.exp(leaked - m)  # leaked <= m: in [0, 1]
    sums = e @ A
    cross = torch.log(torch.clamp(sums, min=TINY)) + m + llf_t
    selfp = leaked + log_self + lls_t
    newa = torch.clamp(torch.logaddexp(cross, selfp), min=NEG_INF)
    return newa, (leaked, lse, e, sums, cross, selfp)


def den_fb_forward_plain(llf, lls, alpha0, A, log_self, log_init, log_leak: float):
    """Plain version of K2f: alphas [T + 1, B, S] (alphas[0] = alpha0)."""
    alphas = [alpha0]
    for t in range(llf.shape[1]):
        alphas.append(_step(alphas[-1], A, log_self, log_init, log_leak,
                            llf[:, t], lls[:, t])[0])
    return torch.stack(alphas)


def den_fb_backward_plain(g_final, alphas, llf, lls, A, log_self, log_init,
                          log_leak: float):
    """Plain version of K2b: (dllf, dlls) [B, T, S] from dL/d alpha_T."""
    dllf, dlls = torch.empty_like(llf), torch.empty_like(lls)
    g = g_final
    for t in range(llf.shape[1] - 1, -1, -1):
        alpha, newa = alphas[t], alphas[t + 1]
        _, (leaked, lse, e, sums, cross, selfp) = _step(
            alpha, A, log_self, log_init, log_leak, llf[:, t], lls[:, t])
        # the clamp max(lae, NEG_INF) passes gradient where it is inactive
        live = newa > NEG_INF
        zero = torch.zeros_like(g)
        w_cross = torch.where(live, g * _guard_exp(cross, newa), zero)
        w_self = torch.where(live, g * _guard_exp(selfp, newa), zero)
        dllf[:, t], dlls[:, t] = w_cross, w_self
        # cross = log(max(sums, tiny)) + m + llf, m held constant
        d_sums = torch.where(sums > TINY, w_cross / torch.clamp(sums, min=TINY), zero)
        g_leaked = e * (d_sums @ A.T) + w_self
        g = g_leaked * _guard_exp(alpha, leaked)
        if log_leak > NEG_INF / 2:
            k = log_leak + log_init
            d_lse = (g_leaked * _guard_exp(k + lse, leaked)).sum(dim=-1, keepdim=True)
            g = g + d_lse * _guard_exp(alpha, lse)
    return dllf, dlls


class DenSparse(NamedTuple):
    """A's nonzeros twice (``den_sparse``). By destination: the arcs into
    state j are ``in_ptr[j]:in_ptr[j + 1]`` of ``in_src`` / ``in_val``; by
    source: the arcs out of state i are ``out_ptr[i]:out_ptr[i + 1]`` of
    ``out_dst`` / ``out_val``. Each row runs in ascending order of the other
    state. Pointers int32 [S + 1], states int16 [nnz], values f32 [nnz]
    (A's entries exactly)."""

    in_ptr: torch.Tensor
    in_src: torch.Tensor
    in_val: torch.Tensor
    out_ptr: torch.Tensor
    out_dst: torch.Tensor
    out_val: torch.Tensor

    def to(self, device) -> "DenSparse":
        return DenSparse(*(x.to(device) for x in self))


_MAX_STATE = 32767  # states are int16


def den_sparse(A) -> DenSparse:
    """The sparse form of A [S, S] (numpy or torch), on the CPU."""
    a = np.asarray(A.detach().cpu() if torch.is_tensor(A) else A, np.float32)
    S = a.shape[0]
    if a.shape != (S, S) or S > _MAX_STATE:
        raise ValueError(f"den_sparse takes a square A of at most {_MAX_STATE} states,"
                         f" got {a.shape}")

    def rows(m):  # m's nonzeros row by row, columns ascending
        r, c = np.nonzero(m)
        ptr = np.zeros(S + 1, np.int32)
        ptr[1:] = np.cumsum(np.bincount(r, minlength=S))
        return (torch.from_numpy(ptr), torch.from_numpy(c.astype(np.int16)),
                torch.from_numpy(m[r, c]))

    return DenSparse(*rows(a.T), *rows(a))


def _check(name, **tensors):
    """The tensors' common device (``cuda_build.device_of``), after checking
    that each is float32."""
    dev = cuda_build.device_of(name, *tensors.values())
    for k, x in tensors.items():
        if x.dtype != torch.float32:
            raise TypeError(f"{name}: {k} must be float32, got {x.dtype}")
    return dev


def _shapes(llf, lls, A, log_self, log_init):
    if llf.ndim != 3 or lls.shape != llf.shape:
        raise ValueError(f"llf/lls must be equal [B, T, S], got {tuple(llf.shape)}"
                         f" and {tuple(lls.shape)}")
    B, T, S = llf.shape
    if A.shape != (S, S) or log_self.shape != (S,) or log_init.shape != (S,):
        raise ValueError(f"graph tensors do not match S={S}: A {tuple(A.shape)}, "
                         f"log_self {tuple(log_self.shape)}, log_init {tuple(log_init.shape)}")
    return B, T, S


def _arcs(name, sparse, S: int, dev, backward: bool):
    """The kernel's arc arrays from ``sparse`` (by destination; by source
    too for the backward) and nnz, after checking them."""
    if not isinstance(sparse, DenSparse):
        raise ValueError(f"{name} on {dev} needs A's sparse form: pass den_sparse(A)"
                         " (DenominatorGraph.tensors(device)['A_sparse'])")
    nnz = sparse.in_src.numel()
    for x, dtype, n in zip(sparse, (torch.int32, torch.int16, torch.float32) * 2,
                           (S + 1, nnz, nnz) * 2):
        if (x.device != dev or x.dtype != dtype or x.shape != (n,) or not x.is_contiguous()
                or x.data_ptr() % 16):
            raise ValueError(f"{name}: the sparse form does not match {S} states and {nnz}"
                             f" arcs on {dev} (got {x.dtype} {tuple(x.shape)} on {x.device})")
    return (sparse if backward else sparse[:3]), nnz


def den_fb_forward(llf, lls, alpha0, A, log_self, log_init, log_leak: float,
                   sparse: Optional[DenSparse] = None):
    """K2f: alphas [T + 1, B, S] of the den recursion.

    llf, lls [B, T, S] per-state emission scores (cross / self-loop arcs),
    alpha0 [B, S], A [S, S] prob-domain cross transitions, log_self and
    log_init [S]; all float32. On CUDA this launches ``satpu_den_fwd`` once
    over A's nonzeros ``sparse`` (required there; one count in
    ``k2f.launches``; the arcs' placement is ``placement``), on
    the CPU it runs ``den_fb_forward_plain``."""
    dev = _check("den_fb_forward", llf=llf, lls=lls, alpha0=alpha0, A=A,
                 log_self=log_self, log_init=log_init)
    B, T, S = _shapes(llf, lls, A, log_self, log_init)
    if alpha0.shape != (B, S):
        raise ValueError(f"alpha0 must be [B, S] = [{B}, {S}], got {tuple(alpha0.shape)}")
    if dev.type == "cpu":
        return den_fb_forward_plain(llf, lls, alpha0, A, log_self, log_init, log_leak)
    arcs, nnz = _arcs("den_fb_forward", sparse, S, dev, backward=False)
    shared = placement(S, nnz, backward=False) == "shared"
    alphas = torch.empty((T + 1, B, S), device=dev, dtype=torch.float32)
    alphas[0] = alpha0
    llf, lls = llf.contiguous(), lls.contiguous()
    log_self, log_init = log_self.contiguous(), log_init.contiguous()
    cuda_build.launch(cuda_build.load("den_fb").satpu_den_fwd, llf.data_ptr(), lls.data_ptr(),
                      *(x.data_ptr() for x in arcs), log_self.data_ptr(), log_init.data_ptr(),
                      log_leak, alphas.data_ptr(), B, T, S, nnz, shared, device=dev,
                      counter="k2f.launches")
    return alphas


def den_fb_backward(g_final, alphas, llf, lls, A, log_self, log_init, log_leak: float,
                    sparse: Optional[DenSparse] = None):
    """K2b: (dllf, dlls) [B, T, S] from g_final = dL/d alpha_T [B, S] and the
    forward's alphas. On CUDA this launches ``satpu_den_bwd`` once over A's
    nonzeros ``sparse`` (required there; one count in
    ``k2b.launches``; the arcs' placement is ``placement``), on
    the CPU it runs ``den_fb_backward_plain``."""
    dev = _check("den_fb_backward", g_final=g_final, alphas=alphas, llf=llf, lls=lls,
                 A=A, log_self=log_self, log_init=log_init)
    B, T, S = _shapes(llf, lls, A, log_self, log_init)
    if alphas.shape != (T + 1, B, S) or g_final.shape != (B, S):
        raise ValueError(f"alphas [T+1, B, S] / g_final [B, S] do not match llf"
                         f" {tuple(llf.shape)}")
    if dev.type == "cpu":
        return den_fb_backward_plain(g_final, alphas, llf, lls, A, log_self, log_init,
                                     log_leak)
    arcs, nnz = _arcs("den_fb_backward", sparse, S, dev, backward=True)
    shared = placement(S, nnz, backward=True) == "shared"
    dllf = torch.empty((B, T, S), device=dev, dtype=torch.float32)
    dlls = torch.empty_like(dllf)
    tensors = [x.contiguous() for x in (g_final, alphas, llf, lls)]
    rest = [x.contiguous() for x in (log_self, log_init)]
    cuda_build.launch(cuda_build.load("den_fb").satpu_den_bwd, *(x.data_ptr() for x in tensors),
                      *(x.data_ptr() for x in arcs), *(x.data_ptr() for x in rest), log_leak,
                      dllf.data_ptr(), dlls.data_ptr(), B, T, S, nnz, shared, device=dev,
                      counter="k2b.launches")
    return dllf, dlls


def placement(S: int, nnz: int, backward: bool) -> str:
    """Where K2f (K2b with ``backward``) keeps the arcs of a graph of S
    states and nnz nonzeros in A: "shared" when they fit a block's shared
    memory beside the row vectors, else "global" (read from device memory).
    Raises ValueError for a graph the kernels do not take. Needs the
    kernels' library, so the CUDA toolkit."""
    lib = cuda_build.load("den_fb")
    if S > lib.satpu_den_max_states():
        raise ValueError(f"den graph of {S} states and {nnz} arcs: the kernels take at"
                         f" most {lib.satpu_den_max_states()} states")
    need = lib.satpu_den_smem_bytes(S, nnz, backward, True)
    return "shared" if need <= cuda_build.SMEM_LIMIT else "global"


class _DenScan(torch.autograd.Function):
    """alpha_T of the den recursion; the backward runs the matching VJP."""

    @staticmethod
    def forward(ctx, llf, lls, alpha0, A, log_self, log_init, log_leak, forward, backward):
        alphas = forward(llf, lls, alpha0, A, log_self, log_init, log_leak)
        ctx.save_for_backward(alphas, llf, lls, A, log_self, log_init)
        ctx.log_leak, ctx.backward_fn = log_leak, backward
        return alphas[-1]

    @staticmethod
    def backward(ctx, g_final):
        with span("chain.den_backward"):
            alphas, llf, lls, A, log_self, log_init = ctx.saved_tensors
            dllf, dlls = ctx.backward_fn(g_final.contiguous(), alphas, llf, lls, A, log_self,
                                         log_init, ctx.log_leak)
        return dllf, dlls, None, None, None, None, None, None, None


def den_scan(llf, lls, alpha0, A, log_self, log_init, log_leak: float,
             sparse: Optional[DenSparse] = None) -> torch.Tensor:
    """alpha_T [B, S] through K2f, differentiable to llf/lls through K2b;
    ``sparse`` = den_sparse(A) is required on CUDA."""
    return _DenScan.apply(llf, lls, alpha0, A, log_self, log_init, log_leak,
                          functools.partial(den_fb_forward, sparse=sparse),
                          functools.partial(den_fb_backward, sparse=sparse))


def den_scan_plain(llf, lls, alpha0, A, log_self, log_init, log_leak: float) -> torch.Tensor:
    """``den_scan`` through the plain versions, on any device."""
    return _DenScan.apply(llf, lls, alpha0, A, log_self, log_init, log_leak,
                          den_fb_forward_plain, den_fb_backward_plain)


def final_value(alpha_T, final, log_init, log_leak: float) -> torch.Tensor:
    """logsumexp(max(leak(alpha_T) + final, NEG_INF)) per batch row [B]."""
    leaked, _ = _leak(alpha_T, log_init, log_leak)
    return torch.logsumexp(torch.clamp(leaked + final, min=NEG_INF), dim=-1)
