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
of ``csrc/den_fb.cu`` (built on first use) and count the calls in their
``launches``; on CPU tensors they run the plain versions, which are the same
formulas in PyTorch ops. ``den_scan`` wraps both in a
``torch.autograd.Function`` (gradients flow to llf and lls only: the graph
tensors are constants); ``den_scan_plain`` is the same function through the
plain versions on any device. The final value
``logsumexp(leak(alpha_T) + final)`` stays outside, in ``final_value``.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

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


def _check(name, **tensors):
    dev = None
    for k, x in tensors.items():
        if x.dtype != torch.float32:
            raise TypeError(f"{name}: {k} must be float32, got {x.dtype}")
        if dev is None:
            dev = x.device
        elif x.device != dev:
            raise ValueError(f"{name}: {k} is on {x.device}, not {dev}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cpu or cuda, not {dev}")
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


def den_fb_forward(llf, lls, alpha0, A, log_self, log_init, log_leak: float):
    """K2f: alphas [T + 1, B, S] of the den recursion.

    llf, lls [B, T, S] per-state emission scores (cross / self-loop arcs),
    alpha0 [B, S], A [S, S] prob-domain cross transitions, log_self and
    log_init [S]; all float32. On CUDA this launches ``satpu_den_fwd`` (T
    step kernels; one count in ``den_fb_forward.launches``), on the CPU it
    runs ``den_fb_forward_plain``."""
    dev = _check("den_fb_forward", llf=llf, lls=lls, alpha0=alpha0, A=A,
                 log_self=log_self, log_init=log_init)
    B, T, S = _shapes(llf, lls, A, log_self, log_init)
    if alpha0.shape != (B, S):
        raise ValueError(f"alpha0 must be [B, S] = [{B}, {S}], got {tuple(alpha0.shape)}")
    if dev.type == "cpu":
        return den_fb_forward_plain(llf, lls, alpha0, A, log_self, log_init, log_leak)
    lib = _lib(S)
    alphas = torch.empty((T + 1, B, S), device=dev, dtype=torch.float32)
    alphas[0] = alpha0
    llf, lls, A = llf.contiguous(), lls.contiguous(), A.contiguous()
    log_self, log_init = log_self.contiguous(), log_init.contiguous()
    err = lib.satpu_den_fwd(llf.data_ptr(), lls.data_ptr(), A.data_ptr(),
                            log_self.data_ptr(), log_init.data_ptr(), log_leak,
                            alphas.data_ptr(), B, T, S,
                            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"satpu_den_fwd launch failed: CUDA error {err}")
    den_fb_forward.launches += 1
    return alphas


den_fb_forward.launches = 0


def den_fb_backward(g_final, alphas, llf, lls, A, log_self, log_init, log_leak: float):
    """K2b: (dllf, dlls) [B, T, S] from g_final = dL/d alpha_T [B, S] and the
    forward's alphas. On CUDA this launches ``satpu_den_bwd`` (3 T kernels;
    one count in ``den_fb_backward.launches``), on the CPU it runs
    ``den_fb_backward_plain``."""
    dev = _check("den_fb_backward", g_final=g_final, alphas=alphas, llf=llf, lls=lls,
                 A=A, log_self=log_self, log_init=log_init)
    B, T, S = _shapes(llf, lls, A, log_self, log_init)
    if alphas.shape != (T + 1, B, S) or g_final.shape != (B, S):
        raise ValueError(f"alphas [T+1, B, S] / g_final [B, S] do not match llf"
                         f" {tuple(llf.shape)}")
    if dev.type == "cpu":
        return den_fb_backward_plain(g_final, alphas, llf, lls, A, log_self, log_init,
                                     log_leak)
    lib = _lib(S)
    dllf = torch.empty((B, T, S), device=dev, dtype=torch.float32)
    dlls = torch.empty_like(dllf)
    work = torch.empty(3 * B * S + 2 * B, device=dev, dtype=torch.float32)
    tensors = [x.contiguous() for x in (g_final, alphas, llf, lls, A, log_self, log_init)]
    err = lib.satpu_den_bwd(*(x.data_ptr() for x in tensors), log_leak, dllf.data_ptr(),
                            dlls.data_ptr(), work.data_ptr(), B, T, S,
                            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"satpu_den_bwd launch failed: CUDA error {err}")
    den_fb_backward.launches += 1
    return dllf, dlls


den_fb_backward.launches = 0

_SMEM_LIMIT = 232448  # bytes of shared memory a Hopper block may use


@functools.lru_cache(maxsize=None)
def _load():
    from ..utils import cuda_build

    lib = cuda_build.load("den_fb")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.satpu_den_smem_bytes.restype = ctypes.c_longlong
    lib.satpu_den_smem_bytes.argtypes = [i]
    lib.satpu_den_fwd.restype = i
    lib.satpu_den_fwd.argtypes = [p] * 5 + [f, p, i, i, i, p]
    lib.satpu_den_bwd.restype = i
    lib.satpu_den_bwd.argtypes = [p] * 7 + [f, p, p, p, i, i, i, p]
    return lib


def _lib(S: int):
    lib = _load()
    need = lib.satpu_den_smem_bytes(S)
    if need > _SMEM_LIMIT:
        raise ValueError(f"den graph of {S} states needs {need} bytes of shared memory"
                         f" per block; the kernels take at most {_SMEM_LIMIT}")
    return lib


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
        alphas, llf, lls, A, log_self, log_init = ctx.saved_tensors
        dllf, dlls = ctx.backward_fn(g_final.contiguous(), alphas, llf, lls, A, log_self,
                                     log_init, ctx.log_leak)
        return dllf, dlls, None, None, None, None, None, None, None


def den_scan(llf, lls, alpha0, A, log_self, log_init, log_leak: float) -> torch.Tensor:
    """alpha_T [B, S] through K2f, differentiable to llf/lls through K2b."""
    return _DenScan.apply(llf, lls, alpha0, A, log_self, log_init, log_leak,
                          den_fb_forward, den_fb_backward)


def den_scan_plain(llf, lls, alpha0, A, log_self, log_init, log_leak: float) -> torch.Tensor:
    """``den_scan`` through the plain versions, on any device."""
    return _DenScan.apply(llf, lls, alpha0, A, log_self, log_init, log_leak,
                          den_fb_forward_plain, den_fb_backward_plain)


def final_value(alpha_T, final, log_init, log_leak: float) -> torch.Tensor:
    """logsumexp(max(leak(alpha_T) + final, NEG_INF)) per batch row [B]."""
    leaked, _ = _leak(alpha_T, log_init, log_leak)
    return torch.logsumexp(torch.clamp(leaked + final, min=NEG_INF), dim=-1)
