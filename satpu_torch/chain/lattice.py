"""Lattices, N-best extraction, ARPA LM rescoring, and CTM output.

A numpy copy of ``satpu.chain.lattice``: the host-side half of the decode
stack (the card computes loglikes, the native decoder in
``satpu_torch.native`` emits pruned token lattices). Replaces the
reference's kaldi-bound suite (csrc/decoder.cc: LatticeBestPath :280,
LatticeLmrescore :155, LatticeLmrescoreConstArpa :234,
LatticeAlignWordsLexicon :334, NbestToCTM :377; python API
satools/satools/chain/decoder.py:61-122) with a TPU-era design: exact
N-best over the pruned DAG + word-sequence LM rescoring, which subtracts the
decoding LM's score and adds the big LM's — the same G-removal + ConstArpa
composition result, computed per hypothesis instead of via FST composition.
"""
from __future__ import annotations

import gzip
import heapq
import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

LOG10 = math.log(10.0)


@dataclass
class Lattice:
    """Pruned token DAG: nodes carry frame times, arcs carry word labels and
    separate graph/acoustic costs (both -log)."""

    arc_from: np.ndarray
    arc_to: np.ndarray
    arc_word: np.ndarray
    arc_pdf: np.ndarray
    arc_graph: np.ndarray
    arc_acoustic: np.ndarray
    node_time: np.ndarray
    node_final: np.ndarray  # inf = not final

    @classmethod
    def empty(cls) -> "Lattice":
        z = np.zeros(0, np.int32)
        f = np.zeros(0, np.float32)
        return cls(z, z, z, z, f, f, z, f)

    @property
    def num_nodes(self) -> int:
        return len(self.node_time)

    @property
    def num_arcs(self) -> int:
        return len(self.arc_from)

    def out_arcs(self) -> List[List[int]]:
        outs: List[List[int]] = [[] for _ in range(self.num_nodes)]
        for i in range(self.num_arcs):
            outs[int(self.arc_from[i])].append(i)
        return outs

    def backward_costs(self) -> np.ndarray:
        """Best cost-to-final per node (for A* N-best): one exact reverse
        topological sweep. (A fixed small number of relaxation rounds left
        node 0 at +inf on lattices deeper than the round count — every
        utterance longer than a few frames — silently emptying the N-best.)"""
        bwd = np.where(np.isinf(self.node_final), np.inf, self.node_final)
        total = self.arc_graph + self.arc_acoustic
        indeg = np.zeros(self.num_nodes, np.int64)
        np.add.at(indeg, self.arc_to, 1)
        outs = self.out_arcs()
        stack = [i for i in range(self.num_nodes) if indeg[i] == 0]
        order = []
        while stack:
            u = stack.pop()
            order.append(u)
            for ai in outs[u]:
                v = int(self.arc_to[ai])
                indeg[v] -= 1
                if indeg[v] == 0:
                    stack.append(v)
        for u in reversed(order):
            for ai in outs[u]:
                c = bwd[int(self.arc_to[ai])] + total[ai]
                if c < bwd[u]:
                    bwd[u] = c
        return bwd


@dataclass(order=True)
class _Hyp:
    f: float
    cost: float = field(compare=False)
    node: int = field(compare=False)
    words: Tuple[int, ...] = field(compare=False)
    times: Tuple[int, ...] = field(compare=False)
    acoustic: float = field(compare=False)


def nbest(lat: Lattice, n: int = 100, max_pop: int = 200000) -> List[dict]:
    """Exact A* N-best unique-word-sequence paths over the lattice DAG.

    Returns dicts: words (ids), times (emission frames), cost (graph+acoustic
    under decode scaling), acoustic, graph.
    """
    if lat.num_nodes == 0:
        return []
    outs = lat.out_arcs()
    bwd = lat.backward_costs()
    if not np.isfinite(bwd[0]):
        return []
    results: List[dict] = []
    seen_seqs: set = set()
    heap: List[_Hyp] = [_Hyp(float(bwd[0]), 0.0, 0, (), (), 0.0)]
    pops = 0
    while heap and len(results) < n and pops < max_pop:
        h = heapq.heappop(heap)
        pops += 1
        fin = lat.node_final[h.node]
        if np.isfinite(fin):
            seq = h.words
            if seq not in seen_seqs:
                seen_seqs.add(seq)
                results.append({
                    "words": list(seq), "times": list(h.times),
                    "end_frame": int(lat.node_time[h.node]),
                    "cost": h.cost + float(fin),
                    "acoustic": h.acoustic, "graph": h.cost + float(fin) - h.acoustic,
                })
        for ai in outs[h.node]:
            to = int(lat.arc_to[ai])
            if not np.isfinite(bwd[to]):
                continue
            c = h.cost + float(lat.arc_graph[ai] + lat.arc_acoustic[ai])
            w = int(lat.arc_word[ai])
            words = h.words + (w,) if w != 0 else h.words
            times = h.times + (int(lat.node_time[h.node]),) if w != 0 else h.times
            heapq.heappush(heap, _Hyp(c + float(bwd[to]), c, to, words, times,
                                      h.acoustic + float(lat.arc_acoustic[ai])))
    return results


def best_path(lat: Lattice) -> Optional[dict]:
    r = nbest(lat, n=1)
    return r[0] if r else None


# ---------------------------------------------------------------------------
# ARPA language model
# ---------------------------------------------------------------------------


class ArpaLM:
    """Backoff n-gram LM from an ARPA file (.arpa or .arpa.gz) — the stand-in
    for kaldi's G.fst / ConstArpa inputs (we read the ARPA text they are built
    from). Scores are natural-log (converted from the file's log10)."""

    def __init__(self, path: str):
        self.logprob: Dict[Tuple[str, ...], float] = {}
        self.backoff: Dict[Tuple[str, ...], float] = {}
        self.order = 1
        op = gzip.open if path.endswith(".gz") else open
        with op(path, "rt", encoding="utf-8", errors="replace") as f:
            section = 0
            for line in f:
                line = line.strip()
                if not line:
                    continue
                if line.startswith("\\") and "-grams:" in line:
                    section = int(line[1: line.index("-")])
                    self.order = max(self.order, section)
                    continue
                if line.startswith("\\"):
                    section = 0
                    continue
                if section == 0:
                    continue
                parts = line.split()
                if len(parts) < section + 1:
                    continue
                lp = float(parts[0]) * LOG10
                ngram = tuple(parts[1 : 1 + section])
                self.logprob[ngram] = lp
                if len(parts) > section + 1:
                    try:
                        self.backoff[ngram] = float(parts[section + 1]) * LOG10
                    except ValueError:
                        pass

    def score_word(self, context: Tuple[str, ...], word: str) -> float:
        """log P(word | context) with backoff."""
        ctx = context[-(self.order - 1):] if self.order > 1 else ()
        bo = 0.0
        while True:
            ngram = ctx + (word,)
            if ngram in self.logprob:
                return bo + self.logprob[ngram]
            if not ctx:
                # unseen unigram: kaldi ConstArpaLm maps OOV words through the
                # LM's <unk> entry; without one, fall back to a large penalty
                # (and say so once — silent drift shifts rescoring on real
                # corpora with OOVs, round-1 weak #4)
                unk = self.logprob.get(("<unk>",), self.logprob.get(("<UNK>",)))
                if unk is None and not getattr(self, "_warned_oov", False):
                    self._warned_oov = True
                    import logging

                    logging.warning(
                        "ArpaLM has no <unk> unigram; OOV words (e.g. %r) "
                        "score a flat -20 penalty", word)
                return bo + (unk if unk is not None else -20.0)
            bo += self.backoff.get(ctx, 0.0)
            ctx = ctx[1:]

    def score_sequence(self, words: Sequence[str], bos: str = "<s>",
                       eos: str = "</s>") -> float:
        """Total log prob of the sentence incl. </s> (natural log)."""
        ctx: Tuple[str, ...] = (bos,)
        total = 0.0
        for w in words:
            total += self.score_word(ctx, w)
            ctx = (ctx + (w,))[-(self.order - 1):] if self.order > 1 else ()
        total += self.score_word(ctx, eos)
        return total


def rescore_nbest(hyps: List[dict], word_table: Dict[int, str],
                  new_lm: ArpaLM, old_lm: Optional[ArpaLM] = None,
                  lm_scale: float = 1.0) -> List[dict]:
    """LM rescoring of an N-best list: the reference's G-removal + big-LM
    composition (kaldi_lm_rescoring, chain/decoder.py:61-93) computed per
    hypothesis: new_cost = acoustic + (graph - lm_scale*old_lm) +
    lm_scale*new_lm. With ``old_lm=None`` the decode graph's LM cost stays in
    (pure additive rescoring). Returns hyps sorted by rescored cost, each
    with 'rescored' and 'text' fields added."""
    out = []
    for h in hyps:
        words = [word_table.get(w, str(w)) for w in h["words"]]
        cost = h["cost"]
        if old_lm is not None:
            cost += lm_scale * old_lm.score_sequence(words)  # remove (-log add)
        cost -= lm_scale * new_lm.score_sequence(words)  # note: score is logP
        out.append({**h, "rescored": cost, "text": " ".join(words)})
    out.sort(key=lambda d: d["rescored"])
    return out


def _topo_order(lat: Lattice) -> List[int]:
    """Kahn topological order of the lattice DAG."""
    indeg = np.zeros(lat.num_nodes, np.int64)
    np.add.at(indeg, lat.arc_to, 1)
    outs = lat.out_arcs()
    stack = [i for i in range(lat.num_nodes) if indeg[i] == 0]
    order = []
    while stack:
        u = stack.pop()
        order.append(u)
        for ai in outs[u]:
            v = int(lat.arc_to[ai])
            indeg[v] -= 1
            if indeg[v] == 0:
                stack.append(v)
    return order


def rescore_lattice(lat: Lattice, word_table: Dict[int, str], new_lm: ArpaLM,
                    old_lm: Optional[ArpaLM] = None, lm_scale: float = 1.0
                    ) -> Optional[dict]:
    """EXACT lattice LM rescoring by on-the-fly composition with the ARPA
    model(s) — the semantics of kaldi's G-removal + LatticeLmrescoreConstArpa
    (csrc/decoder.cc:155,234), where ``rescore_nbest`` is the unique-sequence
    N-best approximation (exact only when the N-best covers every word
    sequence in the lattice).

    DP over (lattice node, word context) states in topological order: word
    arcs extend the context and pay ``-lm_scale * (new - old)`` log-prob;
    final nodes additionally pay the </s> terms. Returns the best hypothesis
    as an nbest-style dict with 'rescored' and 'text', or None for an empty
    lattice.
    """
    if lat.num_nodes == 0:
        return None
    hist = max(new_lm.order, old_lm.order if old_lm else 1) - 1

    def arc_delta(ctx: Tuple[str, ...], word: str) -> float:
        d = -lm_scale * new_lm.score_word(ctx, word)
        if old_lm is not None:
            d += lm_scale * old_lm.score_word(ctx, word)
        return d

    outs = lat.out_arcs()
    order = _topo_order(lat)
    bos: Tuple[str, ...] = ("<s>",)
    # states[node]: {ctx: (cost, words, times)} — tuples shared structurally
    states: List[Dict[Tuple[str, ...], Tuple[float, tuple, tuple]]] = [
        {} for _ in range(lat.num_nodes)]
    states[0][bos[-hist:] if hist else ()] = (0.0, (), ())
    best = None
    for u in order:
        for ctx, (cost, words, times) in states[u].items():
            fin = lat.node_final[u]
            if np.isfinite(fin):
                total = cost + float(fin) + arc_delta(ctx, "</s>")
                if best is None or total < best[0]:
                    best = (total, words, times, u)
            for ai in outs[u]:
                v = int(lat.arc_to[ai])
                c = cost + float(lat.arc_graph[ai] + lat.arc_acoustic[ai])
                w = int(lat.arc_word[ai])
                if w == 0:
                    nctx, nwords, ntimes = ctx, words, times
                else:
                    word = word_table.get(w, str(w))
                    c += arc_delta(ctx, word)
                    nctx = ((ctx + (word,))[-hist:]) if hist else ()
                    nwords = words + (w,)
                    ntimes = times + (int(lat.node_time[u]),)
                cur = states[v].get(nctx)
                if cur is None or c < cur[0]:
                    states[v][nctx] = (c, nwords, ntimes)
    if best is None:
        return None
    total, words, times, node = best
    return {"words": list(words), "times": list(times),
            "end_frame": int(lat.node_time[node]), "rescored": total,
            "cost": total,
            "text": " ".join(word_table.get(w, str(w)) for w in words)}


def to_ctm(hyp: dict, word_table: Dict[int, str], utt: str = "utt",
           frame_shift: float = 0.03, channel: str = "1") -> List[str]:
    """Best path -> CTM lines (reference NbestToCTM, csrc/decoder.cc:377).

    Word start times come from the emission frames; durations span to the
    next word's start (last word ends at the final frame + 1).

    DOCUMENTED DIVERGENCE from the reference eval flow: kaldi runs
    LatticeAlignWordsLexicon (csrc/decoder.cc:334) first, which shifts word
    boundaries to lexicon-aligned phone edges before NbestToCTM. satpu's CTM
    uses the decoder's word-emission frames directly — start times can lag
    the lexicon-aligned ones by up to a word's leading silence/phone span.
    WER is unaffected (word identities and order are identical); only CTM
    timestamps differ."""
    words = hyp["words"]
    times = hyp["times"]
    last = hyp.get("end_frame", (times[-1] + 1) if times else 0)
    lines = []
    for i, (w, t) in enumerate(zip(words, times)):
        start = t * frame_shift
        end_frame = times[i + 1] if i + 1 < len(times) else last
        dur = max((end_frame - t) * frame_shift, frame_shift)
        lines.append(f"{utt} {channel} {start:.2f} {dur:.2f} {word_table.get(w, str(w))}")
    return lines
