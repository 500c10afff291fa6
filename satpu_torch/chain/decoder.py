"""Decoding: acoustic loglikes -> words (a numpy copy of ``satpu.chain.decoder``;
reference satools/satools/chain/decoder.py + csrc/decoder.cc
MappedLatticeFasterRecognizer).

A beam-pruned Viterbi best-path decoder over an HCLG-style FST (ilabels =
pdf-id + 1, olabels = word ids) in numpy, mirroring ``kaldi_decode``'s output
surface (text, word ids, alignment), plus thin wrappers with the reference's
python API names (chain/decoder.py:9-122) over the native lattice stack
(``satpu_torch.native.decode_lattice`` + ``satpu_torch.chain.lattice``).
"""
from __future__ import annotations

import heapq
import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .fst import Fst


@dataclass
class DecodeResult:
    words: List[int]
    text: str
    alignment: List[int]  # pdf per frame on the best path
    score: float


def _epsilon_closure(fst: Fst, state_costs: Dict[int, Tuple[float, tuple]]):
    """Expand epsilon (ilabel=0) arcs until fixpoint (for small graphs)."""
    heap = [(c, s) for s, (c, _) in state_costs.items()]
    heapq.heapify(heap)
    while heap:
        c, s = heapq.heappop(heap)
        if c > state_costs[s][0]:
            continue
        for a in fst.arcs[s]:
            if a.ilabel == 0:
                nc = c + a.weight
                hist = state_costs[s][1] + ((a.olabel,) if a.olabel else ())
                if a.nextstate not in state_costs or nc < state_costs[a.nextstate][0]:
                    state_costs[a.nextstate] = (nc, hist)
                    heapq.heappush(heap, (nc, a.nextstate))
    return state_costs


def best_path_decode(loglikes: np.ndarray, graph: Fst, acoustic_scale: float = 1.0,
                     beam: float = 16.0, max_active: int = 7000,
                     word_table: Optional[Dict[int, str]] = None) -> DecodeResult:
    """Viterbi over the decoding graph. loglikes: [T, P] (log-likelihoods,
    mapped: arc ilabel-1 indexes P)."""
    T = loglikes.shape[0]
    # tokens: state -> (cost, backpointer_index)
    # backpointers stored flat: (prev_bp, word, pdf)
    bps: List[Tuple[int, int, int]] = [(-1, 0, -1)]
    cur: Dict[int, Tuple[float, int]] = {graph.start: (0.0, 0)}
    # initial epsilon closure
    closure = {s: (c, ()) for s, (c, _) in cur.items()}
    closure = _epsilon_closure(graph, closure)
    cur = {}
    for s, (c, hist) in closure.items():
        bp = 0
        for w in hist:
            bps.append((bp, w, -1))
            bp = len(bps) - 1
        cur[s] = (c, bp)

    for t in range(T):
        ll = loglikes[t]
        nxt: Dict[int, Tuple[float, int]] = {}
        best_cost = math.inf
        for s, (c, bp) in cur.items():
            for a in graph.arcs[s]:
                if a.ilabel == 0:
                    continue
                nc = c + a.weight - acoustic_scale * float(ll[a.ilabel - 1])
                if nc < nxt.get(a.nextstate, (math.inf, 0))[0]:
                    bps.append((bp, a.olabel, a.ilabel - 1))
                    nxt[a.nextstate] = (nc, len(bps) - 1)
                    best_cost = min(best_cost, nc)
        # epsilon closure on next frame tokens
        eps = {s: (c, ()) for s, (c, _) in nxt.items()}
        eps = _epsilon_closure(graph, eps)
        merged: Dict[int, Tuple[float, int]] = {}
        for s, (c, hist) in eps.items():
            if s in nxt and not hist:
                merged[s] = nxt[s] if nxt[s][0] <= c else nxt[s]
                continue
            # find origin bp: closest original token with same cost path
            base_bp = nxt[s][1] if s in nxt else None
            if base_bp is None:
                # came through epsilon from some token; approximate with the
                # cheapest original token's bp (exact for olabel-carrying
                # epsilon paths via hist emission below)
                base_s = min(nxt, key=lambda q: nxt[q][0])
                base_bp = nxt[base_s][1]
            bp = base_bp
            for w in hist:
                bps.append((bp, w, -1))
                bp = len(bps) - 1
            if s not in merged or c < merged[s][0]:
                merged[s] = (c, bp)
        # beam + max_active pruning
        if merged:
            bc = min(c for c, _ in merged.values())
            pruned = {s: v for s, v in merged.items() if v[0] <= bc + beam}
            if len(pruned) > max_active:
                keep = sorted(pruned.items(), key=lambda kv: kv[1][0])[:max_active]
                pruned = dict(keep)
            cur = pruned
        else:
            cur = {}
        if not cur:
            break

    # final state selection
    best = None
    for s, (c, bp) in cur.items():
        fc = graph.finals[s]
        if fc != float("inf"):
            total = c + fc
            if best is None or total < best[0]:
                best = (total, bp)
    if best is None and cur:
        best = min(((c, bp) for c, bp in cur.values()), key=lambda x: x[0])
    if best is None:
        return DecodeResult([], "", [], math.inf)

    words: List[int] = []
    align: List[int] = []
    bp = best[1]
    while bp > 0:
        prev, w, pdf = bps[bp]
        if w:
            words.append(w)
        if pdf >= 0:
            align.append(pdf)
        bp = prev
    words.reverse()
    align.reverse()
    text = " ".join(word_table.get(w, str(w)) for w in words) if word_table else \
        " ".join(map(str, words))
    return DecodeResult(words, text, align, best[0])


def greedy_decode(loglikes: np.ndarray) -> List[int]:
    """Frame-wise argmax with duplicate collapse (diagnostic decode)."""
    ids = np.argmax(loglikes, axis=-1)
    out = []
    prev = -1
    for i in ids:
        if i != prev:
            out.append(int(i))
        prev = i
    return out


def read_words_txt(path: str) -> Dict[int, str]:
    """kaldi words.txt (word id) -> {id: word}."""
    table = {}
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) == 2:
                table[int(parts[1])] = parts[0]
    return table


# ---------------------------------------------------------------------------
# Reference-named API over the native lattice stack (chain/decoder.py:9-122)
# ---------------------------------------------------------------------------


def kaldi_decode(loglikes, graph, word_table: Optional[Dict[int, str]] = None,
                 acoustic_scale: float = 1.0, beam: float = 16.0,
                 lattice_beam: float = 8.0, max_active: int = 7000) -> Dict:
    """loglikes [T, P] + decode graph -> {text, words, alignment, lattice}
    (reference kaldi_decode). Uses the native lattice decoder when available,
    falling back to the python best-path decoder."""
    from .. import native
    from .lattice import best_path

    word_table = word_table or {}
    if native.available():
        ng = graph if isinstance(graph, native.NativeGraph) else native.NativeGraph(graph)
        lat = native.decode_lattice(ng, loglikes, acoustic_scale=acoustic_scale,
                                    beam=beam, lattice_beam=lattice_beam,
                                    max_active=max_active)
        hyp = best_path(lat)
        if hyp is None:
            return {"text": "", "words": [], "alignment": [], "lattice": lat}
        return {"text": " ".join(word_table.get(w, str(w)) for w in hyp["words"]),
                "words": hyp["words"], "alignment": [], "lattice": lat,
                "times": hyp["times"]}
    res = best_path_decode(np.asarray(loglikes), graph,
                           acoustic_scale=acoustic_scale,
                           word_table=word_table or None)
    return {"text": res.text, "words": res.words, "alignment": res.alignment,
            "lattice": None}


def kaldi_lm_rescoring(lattice, new_lm, word_table: Dict[int, str],
                       old_lm=None, lm_scale: float = 1.0, n: int = 100,
                       mode: str = "exact") -> Dict:
    """Big-LM rescoring of a decoded lattice (reference kaldi_lm_rescoring,
    chain/decoder.py:61-93: G removal + ConstArpa): returns the best rescored
    hypothesis dict (with 'text').

    mode="exact" composes the lattice with the ARPA model(s) — kaldi's exact
    LatticeLmrescoreConstArpa semantics; mode="nbest" is the faster
    unique-word-sequence N-best(n) approximation."""
    from .lattice import nbest, rescore_lattice, rescore_nbest

    if mode == "exact":
        hyp = rescore_lattice(lattice, word_table, new_lm, old_lm=old_lm,
                              lm_scale=lm_scale)
        return hyp if hyp else {"text": "", "words": []}
    hyps = rescore_nbest(nbest(lattice, n), word_table, new_lm, old_lm=old_lm,
                         lm_scale=lm_scale)
    return hyps[0] if hyps else {"text": "", "words": []}


def kaldi_get_align(hyp: Dict, word_table: Dict[int, str], utt: str = "utt",
                    frame_shift: float = 0.03) -> List[str]:
    """Word-aligned CTM lines for a decoded hypothesis (reference
    kaldi_get_align, chain/decoder.py:96-122)."""
    from .lattice import to_ctm

    return to_ctm(hyp, word_table, utt=utt, frame_shift=frame_shift)
