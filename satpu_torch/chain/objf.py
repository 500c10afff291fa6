"""LF-MMI ("chain") objective in PyTorch (port of ``satpu.chain.objf``).

A log-semiring forward recursion over FST arc tables,

  alpha_{t+1}[dst] = logsumexp_{arcs into dst}(alpha_t[src] + w + ll_t[pdf]),

with Kaldi's probability-domain rescale: each step subtracts its (detached)
max score before the per-destination sum, so mass more than ~87 nats below
the frame max flushes to zero, and alphas are clamped at the finite
``NEG_INF`` so no step ever sees -inf.

- numerator: per-utterance supervision graphs, padded to common [B, E] arc
  tables (``fst.pad_graph_arrays``); a step is a gather of the source alphas
  and a ``scatter_add`` into the destinations; frames past ``num_frames``
  are identity steps. ``num_fb`` runs it forward and backward (K3f / K3b on
  the card, one launch each a call; the plain per-frame loop on the CPU)
  and keeps the posteriors d num / d chain_out;
- denominator: one shared graph with leaky-HMM smoothing. Chain den graphs
  factor by destination (``DenFactored``): the step becomes one [S, S]
  product plus a self-loop term, run by the den forward-backward kernels of
  ``den_fb`` (K2f / K2b on the card, over A's nonzeros); other graphs take
  the per-arc recursion;
- ``chain_objf_and_grad``: (num - den) over frames, the l2 term on the
  chain output, and the xent regularizer with numerator posteriors as soft
  targets (computed once, for the targets and the loss's gradient alike).
  Gradients come from autograd (the numerator's backward scales its
  posteriors, the den scan's is K2b).
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..utils.trace import span
from .den_fb import (NEG_INF, den_scan, den_sparse, final_value, leak_log,
                     rescaled_logsumexp_step)
from .fst import Fst, GraphArrays, fst_to_arrays
from .num_fb import num_fb


def num_forward(loglikes: torch.Tensor, num_graphs: Dict[str, torch.Tensor],
                num_frames: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Batched numerator log-prob over padded per-utterance graphs: [B]
    (``num_fb.num_fb``: K3f, and K3b when a gradient is wanted, on the
    card)."""
    return num_fb(loglikes, num_graphs, num_frames)[0]


def graphs_to_torch(num_graphs: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """``pad_graph_arrays`` output -> tensors on ``device`` (indices int64)."""
    return {k: torch.as_tensor(np.asarray(v), device=device).to(
        torch.int64 if np.asarray(v).dtype.kind in "iu" else torch.float32)
        for k, v in num_graphs.items()}


class DenFactored(NamedTuple):
    """Destination-factored form of a den graph (see ``_try_factor_den``):
    every non-self-loop arc into a state carries that state's forward pdf and
    every self-loop its self-loop pdf, so a step is one dense [S, S] product
    plus a diagonal self-loop term."""

    A_fwd: np.ndarray     # [S, S] f32: sum of exp(w) over cross arcs src->dst
    log_self: np.ndarray  # [S] f32: log self-loop prob (NEG_INF if none)
    pdf_fwd: np.ndarray   # [S] int32: pdf of arcs entering the state (0 if none)
    pdf_self: np.ndarray  # [S] int32: pdf of the state's self-loop (0 if none)


class DenominatorGraph:
    """Shared denominator HMM as flat arrays + leaky-HMM initial probs
    (numpy); ``tensors(device)`` gives them as cached device tensors."""

    def __init__(self, arc_src, arc_dst, arc_pdf, arc_logprob, start_logprob,
                 final_logprob, initial_probs, num_pdfs: int,
                 factored: Optional[DenFactored] = None):
        self.arc_src, self.arc_dst, self.arc_pdf = arc_src, arc_dst, arc_pdf
        self.arc_logprob = arc_logprob
        self.start_logprob, self.final_logprob = start_logprob, final_logprob
        self.initial_probs = initial_probs
        self.num_pdfs = num_pdfs
        self.factored = factored
        self._tensors: Dict[str, Dict[str, object]] = {}

    @property
    def num_states(self) -> int:
        return int(self.start_logprob.shape[0])

    @classmethod
    def from_fst(cls, fst: Fst, num_pdfs: int, power_iters: int = 100) -> "DenominatorGraph":
        g = fst_to_arrays(fst)
        # kaldi estimates the HMM initial probs by running the transition
        # matrix ~100 steps from the start distribution (chain-den-graph.cc)
        S = g.num_states
        probs = np.exp(np.maximum(g.start_logprob, -60.0))
        probs /= probs.sum()
        trans = np.exp(g.arc_logprob)
        for _ in range(power_iters):
            nxt = np.zeros(S)
            np.add.at(nxt, g.arc_dst, probs[g.arc_src] * trans)
            s = nxt.sum()
            if s <= 0:
                break
            probs = nxt / s
        return cls(g.arc_src, g.arc_dst, g.arc_pdf, g.arc_logprob, g.start_logprob,
                   g.final_logprob, probs.astype(np.float32), num_pdfs,
                   factored=_try_factor_den(g))

    def tensors(self, device) -> Dict[str, object]:
        """The graph on ``device``: start/final/log_init [S], the per-arc
        tables, and (factored graphs) A [S, S], its nonzeros ``A_sparse``
        (``den_fb.DenSparse``), log_self, pdf_fwd, pdf_self."""
        key = str(torch.device(device))
        if key not in self._tensors:
            f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
            i64 = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=device)
            t = {"start": f32(np.maximum(self.start_logprob, NEG_INF)),
                 "final": f32(np.maximum(self.final_logprob, NEG_INF)),
                 "log_init": f32(np.log(np.maximum(self.initial_probs, 1e-20))),
                 "arc_src": i64(self.arc_src), "arc_dst": i64(self.arc_dst),
                 "arc_pdf": i64(np.maximum(self.arc_pdf, 0)),
                 "arc_logprob": f32(self.arc_logprob)}
            if self.factored is not None:
                f = self.factored
                t.update(A=f32(f.A_fwd), A_sparse=den_sparse(f.A_fwd).to(device),
                         log_self=f32(f.log_self),
                         pdf_fwd=i64(f.pdf_fwd), pdf_self=i64(f.pdf_self))
            self._tensors[key] = t
        return self._tensors[key]


def _try_factor_den(g: GraphArrays, max_dense: int = 32_000_000) -> Optional[DenFactored]:
    """Destination-factored den form, or None when the graph lacks the
    chain-topology property (pdf a function of (dst, is_self_loop)) or the
    dense [S, S] matrix would be too large."""
    S = g.num_states
    if S * S > max_dense or len(g.arc_src) == 0 or np.any(g.arc_pdf < 0):
        return None
    # 1. forward pdf per state from arcs src != dst (must be consistent)
    is_loop = g.arc_src == g.arc_dst
    pdf_fwd = np.full(S, -1, np.int64)
    dst, pdf = g.arc_dst[~is_loop], g.arc_pdf[~is_loop]
    pdf_fwd[dst] = pdf
    if np.any(pdf_fwd[dst] != pdf):
        return None
    # 2. loop arcs carrying the state's forward pdf are phone-LM
    #    self-transitions (a repeated phone): they belong on A's diagonal.
    #    The rest are topology self-loops, at most one per state.
    lm_loop = is_loop & (g.arc_pdf == pdf_fwd[g.arc_dst])
    topo_self = is_loop & ~lm_loop
    pdf_self = np.full(S, -1, np.int64)
    dst, pdf = g.arc_dst[topo_self], g.arc_pdf[topo_self]
    pdf_self[dst] = pdf
    if np.any(pdf_self[dst] != pdf):
        return None
    if np.any(np.bincount(g.arc_dst[topo_self], minlength=S) > 1):
        return None
    cross = ~is_loop | lm_loop
    A_fwd = np.zeros((S, S), np.float32)
    np.add.at(A_fwd, (g.arc_src[cross], g.arc_dst[cross]), np.exp(g.arc_logprob[cross]))
    log_self = np.full(S, NEG_INF, np.float32)
    log_self[g.arc_dst[topo_self]] = g.arc_logprob[topo_self]
    return DenFactored(A_fwd, log_self, np.maximum(pdf_fwd, 0).astype(np.int32),
                       np.maximum(pdf_self, 0).astype(np.int32))


def den_forward(loglikes: torch.Tensor, den: DenominatorGraph,
                leaky_hmm_coefficient: float = 1e-5) -> torch.Tensor:
    """Batched denominator log-prob. loglikes [B, T, P] -> [B].

    A factored graph (``den.factored``) takes the factored branch, any other
    the per-arc one. The factored branch gathers each state's emission
    scores for all frames (``loglikes[..., pdf_fwd]``,
    ``loglikes[..., pdf_self]``) and runs the recursion through
    ``den_fb.den_scan`` (kernels K2f/K2b on the card, the plain version on
    the CPU); the per-arc branch is plain torch."""
    g = den.tensors(loglikes.device)
    B = loglikes.shape[0]
    S = den.num_states
    log_init = g["log_init"]
    alpha0 = g["start"].expand(B, S).contiguous()
    if den.factored is not None:
        llf = loglikes.index_select(-1, g["pdf_fwd"])
        lls = loglikes.index_select(-1, g["pdf_self"])
        log_leak = leak_log(leaky_hmm_coefficient)
        alpha_T = den_scan(llf, lls, alpha0, g["A"], g["log_self"], log_init, log_leak,
                           g["A_sparse"])
        return final_value(alpha_T, g["final"], log_init, log_leak)

    def leak(alpha):
        if leaky_hmm_coefficient <= 0:
            return alpha
        tot = torch.logsumexp(alpha, dim=-1, keepdim=True)
        return torch.logaddexp(alpha, math.log(leaky_hmm_coefficient) + log_init + tot)

    T = loglikes.shape[1]
    E = g["arc_pdf"].shape[0]
    src, dst = g["arc_src"].expand(B, E), g["arc_dst"].expand(B, E)
    arc_scores = (loglikes.index_select(-1, g["arc_pdf"]) + g["arc_logprob"])  # [B, T, E]
    alpha = alpha0
    for t in range(T):
        alpha, _ = rescaled_logsumexp_step(leak(alpha), arc_scores[:, t], src, dst)
    return torch.logsumexp(torch.clamp(leak(alpha) + g["final"], min=NEG_INF), dim=-1)


def _total_frames(chain_out: torch.Tensor, num_frames: Optional[torch.Tensor]) -> torch.Tensor:
    if num_frames is None:
        return torch.tensor(float(chain_out.shape[0] * chain_out.shape[1]),
                            device=chain_out.device)
    return num_frames.sum().to(torch.float32)


def chain_objf_and_grad(chain_out: torch.Tensor, xent_out: Optional[torch.Tensor],
                        num_graphs: Dict[str, torch.Tensor], den: DenominatorGraph,
                        num_frames: Optional[torch.Tensor] = None,
                        leaky_hmm_coefficient: float = 1e-5,
                        l2_regularize: float = 1e-4,
                        xent_regularize: float = 0.025,
                        tot_frames: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Training loss (to minimize) and diagnostics: -(num - den) per frame,
    plus 0.5 * l2_regularize * |chain_out|^2 per frame, minus
    xent_regularize * the xent objective under the numerator posteriors
    (d num / d chain_out, held constant). Differentiable in chain_out and
    xent_out. Every term divides by ``tot_frames``, this batch's frame count
    unless given (the global batch's under data parallelism, where the loss
    and each diagnostic are this rank's share). The numerator's forward and
    backward (one ``num_fb`` call: its posteriors are both the xent targets
    and, scaled, the loss's gradient), the den forward and the xent product
    run in the spans ``chain.num_forward``, ``chain.den_forward`` and
    ``chain.xent_posteriors``."""
    if tot_frames is None:
        tot_frames = _total_frames(chain_out, num_frames)
    xent = xent_out is not None and xent_regularize > 0
    with span("chain.num_forward"):
        num_ll, posts = num_fb(chain_out, num_graphs, num_frames, posteriors=xent)
    with span("chain.den_forward"):
        den_ll = den_forward(chain_out, den, leaky_hmm_coefficient)
    objf = torch.sum(num_ll - den_ll)
    loss = -objf / tot_frames
    metrics = {"chain_objf": (objf / tot_frames).detach(),
               "num_logprob": (num_ll.sum() / tot_frames).detach(),
               "den_logprob": (den_ll.sum() / tot_frames).detach()}
    if l2_regularize > 0:
        l2 = torch.sum(chain_out ** 2) / tot_frames
        loss = loss + 0.5 * l2_regularize * l2
        metrics["l2"] = l2.detach()
    if xent:
        with span("chain.xent_posteriors"):
            xent_objf = torch.sum(posts * xent_out) / tot_frames
        loss = loss - xent_regularize * xent_objf
        metrics["xent_objf"] = xent_objf.detach()
    return loss, metrics


def compute_chain_objf(chain_out, num_graphs, den, num_frames=None,
                       leaky_hmm_coefficient: float = 1e-5) -> torch.Tensor:
    """Diagnostic objf without regularizers: (num - den) per frame."""
    num_ll = num_forward(chain_out, num_graphs, num_frames)
    den_ll = den_forward(chain_out, den, leaky_hmm_coefficient)
    return torch.sum(num_ll - den_ll) / _total_frames(chain_out, num_frames)
