"""LF-MMI numerator forward-backward: kernels K3f (forward) and K3b
(backward) and their plain versions.

The numerator is a log-semiring recursion over each utterance's
supervision graph, padded to common [B, E] arc tables
(``fst.pad_graph_arrays``). For every batch row the forward takes one step
a frame,

    score_e = alpha[src_e] + (ll_t[pdf_e] + w_e)
    m       = max_e score_e (0 where at or below NEG_INF / 2), held constant
    alpha'  = max(log(max(scatter_add_dst(exp(score - m)), TINY)) + m, NEG_INF)

with identity steps on frames t >= num_frames[b], and the row's value is
``logsumexp(max(alpha_T + final, NEG_INF))``. The backward gives the
posteriors d sum_b value[b] / d ll [B, T, P], exactly as autograd takes
them through that loop: zero through the TINY floor and the NEG_INF clamp
where they bind, on identity frames and on padding arcs.

On CUDA tensors ``num_fb_forward`` / ``num_fb_backward`` launch the kernels
of ``csrc/num_fb.cu`` (built on first use; one launch a call, one block a
batch row running all of its frames) and count the calls in the counters
``k3f.launches`` and ``k3b.launches`` (``utils.trace``); they read the arcs
grouped by destination, source and pdf (``num_arcs``). On CPU tensors they
run the plain versions, ``num_fb_forward_plain`` (the recursion) and
``num_fb_backward_plain`` (autograd through it). There is no fallback: a
CUDA tensor launches the kernel or raises.

``num_fb`` wraps both in ``_NumFB``, a ``torch.autograd.Function``: one
forward and, when a gradient or the posteriors are asked for, one backward
in the same call. It returns the value [B] and the posteriors, which serve
as the xent targets and, scaled by the value's gradient a row, as the
backward: the recursion runs once each way a training step.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from ..utils import cuda_build
from .den_fb import NEG_INF, rescaled_logsumexp_step

GRAPH_KEYS = ("arc_src", "arc_dst", "arc_pdf", "arc_logprob", "start_logprob",
              "final_logprob")


def _tables(graphs):
    return (graphs["arc_src"].long(), graphs["arc_dst"].long(), graphs["arc_pdf"].long(),
            graphs["arc_logprob"])


def num_fb_forward_plain(loglikes, graphs, num_frames=None):
    """Plain version of K3f: (value [B], alphas [B, T + 1, S], m [B, T]),
    alphas[:, 0] the clamped start, m 0 on identity frames. Differentiable
    in ``loglikes`` through the value."""
    src, dst, pdf, w = _tables(graphs)
    B, T, _ = loglikes.shape
    arc_scores = loglikes.gather(-1, pdf[:, None, :].expand(B, T, pdf.shape[-1])) + w[:, None, :]
    alpha = torch.clamp(graphs["start_logprob"], min=NEG_INF)
    alphas, ms = [alpha], []
    for t in range(T):
        new_alpha, m = rescaled_logsumexp_step(alpha, arc_scores[:, t], src, dst)
        if num_frames is not None:
            live = (t < num_frames)[:, None]
            new_alpha = torch.where(live, new_alpha, alpha)
            m = torch.where(live, m, torch.zeros_like(m))
        alpha = new_alpha
        alphas.append(alpha)
        ms.append(m)
    value = torch.logsumexp(torch.clamp(alpha + graphs["final_logprob"], min=NEG_INF), dim=-1)
    m = torch.cat(ms, -1) if ms else loglikes.new_zeros((B, 0))
    return value, torch.stack(alphas, 1), m


def num_fb_backward_plain(loglikes, graphs, num_frames=None):
    """Plain version of K3b: the posteriors d sum(value) / d loglikes
    [B, T, P], autograd's through ``num_fb_forward_plain`` (run again)."""
    with torch.enable_grad():
        ll = loglikes.detach().requires_grad_(True)
        value = num_fb_forward_plain(ll, graphs, num_frames)[0]
        posts, = torch.autograd.grad(value.sum(), ll, materialize_grads=True)
    return posts


class NumArcs(NamedTuple):
    """One batch's live arcs as the kernels read them (``num_arcs``): each
    [B, E] array holds the row's live arcs first (``in_ptr[:, S]`` of them),
    the pointers are [B, S + 1]; all int32 but ``w``.

    By destination (the order ``src``, ``pdf``, ``w`` are stored in): the
    arcs into state j are ``in_ptr[j]:in_ptr[j + 1]``. By source: the arcs
    out of state i are ``out_pos[out_ptr[i]:out_ptr[i + 1]]`` (positions by
    destination). By pdf: ``p_pos`` (positions by destination) and
    ``p_pdf``, each pdf's arcs consecutive. Every group keeps the original
    arc order."""

    src: torch.Tensor
    pdf: torch.Tensor
    w: torch.Tensor
    in_ptr: torch.Tensor
    out_ptr: torch.Tensor
    out_pos: torch.Tensor
    p_pos: torch.Tensor
    p_pdf: torch.Tensor


def num_arcs(graphs: Dict[str, torch.Tensor], num_pdfs: int) -> NumArcs:
    """Group a batch's live arcs (log-prob above NEG_INF / 2; the padding
    arcs are left out) by destination, source and pdf with stable sorts, on
    the graphs' device."""
    src, dst, pdf, w = _tables(graphs)
    B, E = src.shape
    S = graphs["start_logprob"].shape[-1]
    live = w > NEG_INF / 2

    def order(key, dead):  # (sorted keys, the arcs in that order): dead arcs last
        return torch.sort(torch.where(live, key, dead), dim=-1, stable=True)

    def ptr(keys):  # [B, S + 1]: the arcs with a key below j
        states = torch.arange(S + 1, device=src.device).expand(B, S + 1).contiguous()
        return torch.searchsorted(keys, states, out_int32=True)

    i32 = lambda x: x.to(torch.int32).contiguous()
    by_dst, perm = order(dst, S)
    position = torch.empty_like(perm).scatter_(
        -1, perm, torch.arange(E, device=src.device).expand(B, E))
    by_src, perm_src = order(src, S)
    by_pdf, perm_pdf = order(pdf, num_pdfs)
    return NumArcs(i32(src.gather(-1, perm)), i32(pdf.gather(-1, perm)),
                   w.gather(-1, perm).contiguous(), ptr(by_dst), ptr(by_src),
                   i32(position.gather(-1, perm_src)), i32(position.gather(-1, perm_pdf)),
                   i32(by_pdf))


def _check(loglikes, graphs, num_frames, *more):
    """(device, B, T, P, S, E) after checking devices (``cuda_build.device_of``
    over these tensors and ``more``), types and shapes."""
    tensors = [loglikes, *(graphs[k] for k in GRAPH_KEYS if k in graphs), *more]
    if num_frames is not None:
        tensors.append(num_frames)
    dev = cuda_build.device_of("numerator", *tensors)
    if loglikes.dtype != torch.float32:
        raise TypeError(f"numerator: loglikes must be float32, got {loglikes.dtype}")
    if loglikes.ndim != 3:
        raise ValueError(f"numerator: loglikes must be [B, T, P], got {tuple(loglikes.shape)}")
    B, T, P = loglikes.shape
    missing = [k for k in GRAPH_KEYS if k not in graphs]
    if missing:
        raise ValueError(f"numerator: the graphs lack {missing}")
    E = graphs["arc_src"].shape[-1]
    S = graphs["start_logprob"].shape[-1]
    for k in GRAPH_KEYS:
        x = graphs[k]
        want = (B, S) if k.endswith("_logprob") and k != "arc_logprob" else (B, E)
        floating = k.endswith("logprob")
        if floating and x.dtype != torch.float32 or not floating and (
                x.dtype.is_floating_point or x.dtype == torch.bool):
            raise TypeError(f"numerator: {k} must be {'float32' if floating else 'integer'},"
                            f" got {x.dtype}")
        if tuple(x.shape) != want:
            raise ValueError(f"numerator: {k} must be {list(want)}, got {tuple(x.shape)}")
    if E == 0 or S == 0:
        raise ValueError(f"numerator: graphs of {S} states and {E} arcs")
    if num_frames is not None and (tuple(num_frames.shape) != (B,)
                                   or num_frames.dtype.is_floating_point):
        raise ValueError(f"numerator: num_frames must be integer [{B}], got"
                         f" {num_frames.dtype} {tuple(num_frames.shape)}")
    return dev, B, T, P, S, E


def _frames(num_frames, B: int, T: int, dev) -> torch.Tensor:
    if num_frames is None:
        return torch.full((B,), T, dtype=torch.int32, device=dev)
    return num_frames.to(torch.int32).contiguous()


def num_fb_forward(loglikes, graphs, num_frames=None, arcs: Optional[NumArcs] = None):
    """K3f: (value [B], alphas [B, T + 1, S], m [B, T]) of the numerator
    recursion. loglikes [B, T, P] float32; ``graphs`` the padded arc tables
    (``GRAPH_KEYS``); num_frames [B] or None (every frame). On CUDA this
    launches ``satpu_num_fwd`` once over ``arcs`` (``num_arcs(graphs, P)``
    when not given; one count in ``k3f.launches``), on the CPU it runs
    ``num_fb_forward_plain``."""
    dev, B, T, P, S, E = _check(loglikes, graphs, num_frames)
    if dev.type == "cpu":
        return num_fb_forward_plain(loglikes, graphs, num_frames)
    lib = _lib(S, E)
    arcs = num_arcs(graphs, P) if arcs is None else arcs
    alphas = torch.empty((B, T + 1, S), device=dev, dtype=torch.float32)
    m = torch.empty((B, T), device=dev, dtype=torch.float32)
    value = torch.empty((B,), device=dev, dtype=torch.float32)
    ins = [loglikes.contiguous(), *arcs[:4], graphs["start_logprob"].contiguous(),
           graphs["final_logprob"].contiguous(), _frames(num_frames, B, T, dev)]
    cuda_build.launch(lib.satpu_num_fwd, *(x.data_ptr() for x in ins), alphas.data_ptr(),
                      m.data_ptr(), value.data_ptr(), B, T, P, S, E, device=dev,
                      counter="k3f.launches")
    return value, alphas, m


def num_fb_backward(loglikes, graphs, num_frames, alphas, m, value,
                    arcs: Optional[NumArcs] = None):
    """K3b: the posteriors d sum(value) / d loglikes [B, T, P] from the
    forward's alphas, m and value. On CUDA this launches ``satpu_num_bwd``
    once (one count in ``k3b.launches``) into a zero-filled buffer, on the
    CPU it runs ``num_fb_backward_plain`` (the plain forward again and its
    autograd)."""
    dev, B, T, P, S, E = _check(loglikes, graphs, num_frames, alphas, m, value)
    if (tuple(alphas.shape) != (B, T + 1, S) or tuple(m.shape) != (B, T)
            or tuple(value.shape) != (B,)):
        raise ValueError(f"numerator: alphas {tuple(alphas.shape)}, m {tuple(m.shape)}, value"
                         f" {tuple(value.shape)} do not match B={B}, T={T}, S={S}")
    if dev.type == "cpu":
        return num_fb_backward_plain(loglikes, graphs, num_frames)
    lib = _lib(S, E)
    arcs = num_arcs(graphs, P) if arcs is None else arcs
    posts = torch.zeros((B, T, P), device=dev, dtype=torch.float32)
    ins = [loglikes.contiguous(), *arcs, graphs["final_logprob"].contiguous(),
           _frames(num_frames, B, T, dev), alphas.contiguous(), m.contiguous(),
           value.contiguous()]
    cuda_build.launch(lib.satpu_num_bwd, *(x.data_ptr() for x in ins), posts.data_ptr(),
                      B, T, P, S, E, device=dev, counter="k3b.launches")
    return posts


def _lib(S: int, E: int):
    """The library, after checking that a row of S states and E arcs fits a
    block's shared memory in both kernels; ValueError otherwise."""
    lib = cuda_build.load("num_fb")
    need = max(lib.satpu_num_smem_bytes(S, E, 0), lib.satpu_num_smem_bytes(S, E, 1))
    if need > cuda_build.SMEM_LIMIT:
        raise ValueError(f"numerator graphs of {S} states and {E} arcs a row need {need} bytes"
                         f" of shared memory; the kernels take at most {cuda_build.SMEM_LIMIT}")
    return lib


class _NumFB(torch.autograd.Function):
    """The numerator's value [B] and, with ``posteriors`` (which ``num_fb``
    sets where a gradient is wanted), its posteriors [B, T, P], else None;
    the backward scales the posteriors by the value's gradient, with no
    second recursion."""

    @staticmethod
    def forward(ctx, loglikes, graphs, num_frames, posteriors):
        arcs = None
        if loglikes.is_cuda:
            _check(loglikes, graphs, num_frames)
            arcs = num_arcs(graphs, loglikes.shape[-1])
        value, alphas, m = num_fb_forward(loglikes, graphs, num_frames, arcs)
        posts = None
        if posteriors:
            posts = num_fb_backward(loglikes, graphs, num_frames, alphas, m, value, arcs)
            ctx.mark_non_differentiable(posts)
        ctx.save_for_backward(posts)
        return value, posts

    @staticmethod
    def backward(ctx, g_value, _):
        posts, = ctx.saved_tensors
        return g_value[:, None, None] * posts, None, None, None


def num_fb(loglikes: torch.Tensor, graphs: Dict[str, torch.Tensor],
           num_frames: Optional[torch.Tensor] = None, posteriors: bool = False
           ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(value [B], posteriors [B, T, P] or None) of the numerator graphs
    over ``loglikes``, differentiable in ``loglikes``. The posteriors (d
    sum(value) / d loglikes, constants) come when ``posteriors`` is set or a
    gradient is wanted: K3f and K3b once each on the card, K3f alone
    otherwise."""
    grad = torch.is_grad_enabled() and loglikes.requires_grad
    return _NumFB.apply(loglikes, graphs, num_frames, posteriors or grad)
