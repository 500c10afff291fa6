"""Frozen copy of ``satpu_torch/chain/prep.py`` for the benchmark's plain reference.

Only the den graph of a random phone bigram, the numerator graphs, the fst
ark writer and the allowed lengths are kept.

The original docstring follows.

Chain graph construction and data preparation, numpy only (a copy of
``satpu.chain.prep`` with fixtures of its own for runs without a corpus).

- ``BiphoneTree``: flat-start biphone tree with kaldi's 1-state chain
  topology (each seen (left, phone) pair owns a forward and a self-loop pdf;
  unseen biphones share a per-phone fallback leaf);
- ``make_den_fst``: a bigram phone LM expanded through that topology into a
  pdf-level acceptor (kaldi chain-make-den-fst semantics);
- ``numerator_fst``: transcript phones -> supervision acceptor over pdf+1
  labels, with optional inter-phone silence;
- ``write_fst_ark``: kaldi-style ``utt \\0B<openfst>`` ark + offset scp, the
  format ``EgsDataset`` reads;
- ``random_bigram_den``: a pruned random phone bigram through
  ``make_den_fst``, the den graph of a given size for runs without a
  corpus (164 phones x 9 successors: 3280 pdfs, 1641 states), and
  ``write_random_chain_corpus``, a synthetic training set over it;
- ``Lexicon``, ``text_to_phones``, ``estimate_phone_bigram``,
  ``estimate_word_bigram`` and ``make_decode_graph``: the word-bigram
  decoding graph (HCLG equivalent) that evaluation decodes with;
- ``phone_lm_fst``: the bigram as an epsilon-free phone acceptor;
- ``make_normalization_fst``: the den graph with power-iterated initial
  probabilities and every state final (kaldi chain-make-den-fst's second
  output), which numerator supervisions are composed with;
- data preparation, numpy only: ``allowed_sample_lengths`` and
  ``perturb_speed_to_allowed_lengths`` (speed perturbation that snaps
  every utterance to one of a few allowed lengths, by linear resampling)
  and ``prepare_chain_data``, which turns a kaldi data dir (wav.scp, text,
  utt2spk [, lexicon]) into everything ``train_asr`` reads: the perturbed
  egs, numerator arks and scps, ``den.fst``, ``normalization.fst``,
  ``tree.json``, ``phones.txt``, ``num_pdfs``, and the ``HCLG.fst`` /
  ``words.txt`` that evaluation decodes with.

Every file it writes has satpu's bytes for the same inputs.
"""
from __future__ import annotations

import json
import math
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .fst import Arc, Fst, fst_connect


@dataclass
class BiphoneTree:
    """(left_phone, phone) -> pdf pair, kaldi chain topology (2 pdfs per
    leaf: forward + self-loop). Unseen biphones for phone p share the
    per-phone fallback leaf (left = 0)."""

    phones: List[str]  # 1-based names; phones[i] is id i+1
    leaf_of: Dict[Tuple[int, int], int] = field(default_factory=dict)
    num_leaves: int = 0

    @property
    def num_pdfs(self) -> int:
        return 2 * self.num_leaves

    @classmethod
    def build(cls, phone_seqs: Sequence[Sequence[int]], phones: List[str],
              biphone: bool = True) -> "BiphoneTree":
        tree = cls(phones=phones)
        P = len(phones)
        # fallback (monophone) leaves always exist
        for p in range(1, P + 1):
            tree.leaf_of[(0, p)] = tree.num_leaves
            tree.num_leaves += 1
        if biphone:
            seen = set()
            for seq in phone_seqs:
                prev = 0
                for p in seq:
                    if prev > 0:
                        seen.add((prev, p))
                    prev = p
            for key in sorted(seen):
                tree.leaf_of[key] = tree.num_leaves
                tree.num_leaves += 1
        return tree

    def leaf(self, left: int, phone: int) -> int:
        return self.leaf_of.get((left, phone), self.leaf_of[(0, phone)])

    def forward_pdf(self, left: int, phone: int) -> int:
        return 2 * self.leaf(left, phone)

    def selfloop_pdf(self, left: int, phone: int) -> int:
        return 2 * self.leaf(left, phone) + 1

    def to_json(self) -> str:
        return json.dumps({
            "phones": self.phones,
            "num_leaves": self.num_leaves,
            "leaf_of": {f"{l},{p}": v for (l, p), v in self.leaf_of.items()},
        })

    @classmethod
    def from_json(cls, s: str) -> "BiphoneTree":
        d = json.loads(s)
        t = cls(phones=d["phones"], num_leaves=d["num_leaves"])
        for k, v in d["leaf_of"].items():
            l, p = k.split(",")
            t.leaf_of[(int(l), int(p))] = v
        return t


def make_den_fst(trans, final, tree: BiphoneTree, prune_floor: float = 1e-6) -> Fst:
    """Expand the bigram phone LM ``trans`` [P+1, P+1] (row 0 = BOS) with
    final probs ``final`` [P+1] through the chain topology into a pdf-level
    acceptor (labels pdf+1).

    States: 0 = start (BOS), then one state per seen biphone (q, p) meaning
    "inside phone p with left context q" — its self-loop emits the self-loop
    pdf, its outgoing arcs emit the next phone's forward pdf with the LM
    weight."""
    P = len(tree.phones)
    fst = Fst()
    start = fst.add_state()
    fst.start = start
    state_of: Dict[Tuple[int, int], int] = {}

    def get_state(q: int, p: int) -> int:
        key = (q, p)
        if key not in state_of:
            s = fst.add_state()
            state_of[key] = s
            fst.add_arc(s, Arc(tree.selfloop_pdf(q, p) + 1,
                               tree.selfloop_pdf(q, p) + 1, 0.0, s))
            if final[p] > prune_floor:
                fst.set_final(s, -math.log(final[p]))
        return state_of[key]

    # BOS arcs
    stack: List[Tuple[int, int]] = []
    for p in range(1, P + 1):
        if trans[0, p] > prune_floor:
            s = get_state(0, p)
            fst.add_arc(start, Arc(tree.forward_pdf(0, p) + 1,
                                   tree.forward_pdf(0, p) + 1,
                                   -math.log(trans[0, p]), s))
            stack.append((0, p))
    done = set(stack)
    while stack:
        q, p = stack.pop()
        src = state_of[(q, p)]
        for r in range(1, P + 1):
            if trans[p, r] > prune_floor:
                key = (p, r)
                new = key not in state_of
                dst = get_state(p, r)
                fst.add_arc(src, Arc(tree.forward_pdf(p, r) + 1,
                                     tree.forward_pdf(p, r) + 1,
                                     -math.log(trans[p, r]), dst))
                if new and key not in done:
                    done.add(key)
                    stack.append(key)
    return fst


def numerator_fst(phone_ids: Sequence[int], tree: BiphoneTree,
                  optional_sil: Optional[int] = None) -> Fst:
    """Transcript phones -> e2e supervision acceptor over pdf+1 labels:
    each phone is (forward pdf, then self-loop pdf*) with its biphone
    context; optional silence may be inserted between phones when
    ``optional_sil`` is given.

    Because silence insertion changes the left context of the next phone,
    states are expanded over (position, left_phone)."""
    fst = Fst()
    bstate: Dict[Tuple[int, int], int] = {}

    def get_b(pos: int, left: int) -> int:
        key = (pos, left)
        if key not in bstate:
            bstate[key] = fst.add_state()
        return bstate[key]

    fst.start = get_b(0, 0)

    def add_phone(src: int, left: int, p: int, pos_next: int) -> None:
        """Emit phone p from boundary state src, landing at (pos_next, p)."""
        mid = fst.add_state()
        fpdf, spdf = tree.forward_pdf(left, p) + 1, tree.selfloop_pdf(left, p) + 1
        fst.add_arc(src, Arc(fpdf, fpdf, 0.0, mid))
        fst.add_arc(mid, Arc(spdf, spdf, 0.0, mid))
        dst = get_b(pos_next, p)
        fst.add_arc(mid, Arc(0, 0, 0.0, dst))

    n = len(phone_ids)
    seen: set = set()
    stack: List[Tuple[int, int]] = [(0, 0)]
    while stack:
        pos, left = stack.pop()
        if (pos, left) in seen:
            continue
        seen.add((pos, left))
        src = get_b(pos, left)
        if pos == n:
            fst.set_final(src, 0.0)
            continue
        p = phone_ids[pos]
        add_phone(src, left, p, pos + 1)
        if (pos + 1, p) not in seen:
            stack.append((pos + 1, p))
        if optional_sil is not None and p != optional_sil:
            # optionally take silence first, then the phone with SIL context
            add_phone(src, left, optional_sil, -pos - 1)  # unique sil landing
            sil_b = get_b(-pos - 1, optional_sil)
            add_phone(sil_b, optional_sil, p, pos + 1)
            if (pos + 1, p) not in seen:
                stack.append((pos + 1, p))
    return fst_connect(fst)


def write_fst_ark(fsts: Dict[str, Fst], ark_path: str, scp_path: str) -> None:
    """kaldi-style "utt \\0B<openfst binary>" ark with offset scp — the
    format fst_train.scp archives use (EgsInfo.load_fst reads it back)."""
    with open(ark_path, "wb") as ark, open(scp_path, "w") as scp:
        for utt, fst in fsts.items():
            ark.write(utt.encode() + b" ")
            offset = ark.tell()
            ark.write(b"\0B")
            fst.write_binary(ark)
            scp.write(f"{utt} {os.path.abspath(ark_path)}:{offset}\n")


def allowed_sample_lengths(lengths: Sequence[int], num_lengths: int = 12,
                           coverage: float = 0.05,
                           frame_subsampling: int = 3,
                           samples_per_frame: int = 160) -> List[int]:
    """Geometric ladder of sample counts covering the central mass of the
    length distribution (perturb_speed_to_allowed_lengths.py). Lengths are
    snapped to multiples of frame_subsampling*samples_per_frame so output
    frame counts are exact."""
    arr = np.sort(np.asarray(lengths))
    lo = float(arr[int(len(arr) * coverage)])
    hi = float(arr[min(int(len(arr) * (1 - coverage)), len(arr) - 1)])
    hi = max(hi, lo * 1.01)
    factor = (hi / lo) ** (1.0 / max(num_lengths - 1, 1))
    quantum = frame_subsampling * samples_per_frame
    out = []
    for i in range(num_lengths):
        L = int(round(lo * factor**i / quantum)) * quantum
        if not out or L > out[-1]:
            out.append(L)
    return out


def random_bigram_den(n_phones: int, succ_per_phone: int, seed: int = 0
                      ) -> Tuple[Fst, BiphoneTree, np.ndarray]:
    """A chain den graph from a random bigram phone LM: uniform first phone,
    ``succ_per_phone`` random successors per phone with weights in
    [0.5, 1.5], final prob 0.05, and a biphone tree with a leaf per seen
    pair (2 * n_phones * (1 + succ_per_phone) pdfs). Returns (den fst,
    tree, trans [P+1, P+1] with row 0 the start)."""
    rng = np.random.default_rng(seed)
    P = n_phones
    trans = np.zeros((P + 1, P + 1))
    trans[0, 1:] = 1.0 / P
    seqs = []
    for p in range(1, P + 1):
        succ = rng.choice(np.arange(1, P + 1), succ_per_phone, replace=False)
        trans[p, succ] = rng.uniform(0.5, 1.5, succ_per_phone)
        seqs.extend([[p, r] for r in succ])
    trans[1:] /= trans[1:].sum(axis=1, keepdims=True)
    tree = BiphoneTree.build(seqs, [f"p{i}" for i in range(1, P + 1)], biphone=True)
    return make_den_fst(trans, np.full(P + 1, 0.05), tree), tree, trans


def random_phone_walk(trans: np.ndarray, length: int, rng: np.random.Generator) -> List[int]:
    """``length`` phones drawn from the bigram ``trans`` (row 0 = start)."""
    seq, prev = [], 0
    for _ in range(length):
        prev = int(rng.choice(trans.shape[0], p=trans[prev]))
        seq.append(prev)
    return seq
