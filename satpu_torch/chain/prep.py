"""Chain graph construction, numpy only: the parts of ``satpu.chain.prep``
that build a denominator graph and matching numerator supervisions.

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
  decoding graph (HCLG equivalent) that evaluation decodes with.

Data preparation (speed perturbation, ``prepare_chain_data``) and
``phone_lm_fst`` are not ported yet.
"""
from __future__ import annotations

import json
import logging
import math
import os
import random
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..utils import kaldi_data
from .fst import Arc, Fst, fst_connect, fst_rmepsilon

SIL = "SIL"


# ---------------------------------------------------------------------------
# Lexicon / phones
# ---------------------------------------------------------------------------


@dataclass
class Lexicon:
    """word -> phone sequences; phone ids are 1-based (0 reserved)."""

    entries: Dict[str, List[List[str]]]
    sil: str = SIL

    @classmethod
    def load(cls, path: str) -> "Lexicon":
        entries: Dict[str, List[List[str]]] = {}
        with open(path) as f:
            for line in f:
                parts = line.split()
                if len(parts) >= 2:
                    entries.setdefault(parts[0], []).append(parts[1:])
        return cls(entries)

    @classmethod
    def grapheme(cls, words) -> "Lexicon":
        """Character lexicon for lexicon-free setups (each letter a phone)."""
        entries = {w: [list(w)] for w in sorted(set(words)) if w}
        return cls(entries)

    def phones(self) -> List[str]:
        out = {self.sil}
        for prons in self.entries.values():
            for p in prons:
                out.update(p)
        return sorted(out)

    def word_phones(self, word: str) -> Optional[List[str]]:
        prons = self.entries.get(word)
        return prons[0] if prons else None

    def unk_word(self) -> Optional[str]:
        """The lexicon's unknown-word entry, if any (kaldi oov.txt role)."""
        for cand in ("<unk>", "<UNK>", "<SPOKEN_NOISE>"):
            if cand in self.entries:
                return cand
        return None


def text_to_phones(words: Sequence[str], lexicon: Lexicon,
                   between_silprob: float = 0.1,
                   rng: Optional[random.Random] = None,
                   edge_sil: bool = True) -> List[str]:
    """Transcript -> phone sequence with sampled inter-word silence
    (steps/nnet3/chain/e2e/text_to_phones.py --between-silprob 0.1). OOV
    words map to the lexicon's unk entry when one exists (kaldi sym2int's
    --map-oov semantics); otherwise they are dropped with a warning."""
    rng = rng or random
    unk = lexicon.unk_word()
    seq: List[str] = [lexicon.sil] if edge_sil else []
    for i, w in enumerate(words):
        pron = lexicon.word_phones(w)
        if pron is None and unk is not None and w != unk:
            logging.info("OOV word %r mapped to %s", w, unk)
            pron = lexicon.word_phones(unk)
        if pron is None:
            logging.warning("OOV word %r dropped (no unk entry in lexicon)", w)
            continue
        if i > 0 and between_silprob > 0 and rng.random() < between_silprob:
            seq.append(lexicon.sil)
        seq.extend(pron)
    if edge_sil:
        seq.append(lexicon.sil)
    return seq


# ---------------------------------------------------------------------------
# Phone LM (epsilon-free interpolated bigram)
# ---------------------------------------------------------------------------


def estimate_phone_bigram(phone_seqs: Sequence[Sequence[int]], num_phones: int,
                          interp: float = 0.5) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Interpolated (absolute-discount-free, mixture) bigram over 1-based
    phone ids. Returns (P_init [P+1], P_trans [P+1, P+1], P_final [P+1]) in
    probability space; index 0 is BOS. Every probability is nonzero, so the
    resulting FST is epsilon-free — the TPU-friendly stand-in for kaldi's
    backoff 4-gram (chain-est-phone-lm)."""
    P = num_phones
    uni = np.ones(P + 1)  # add-1 smoothing over phones (index 1..P); 0 unused
    uni[0] = 0.0
    big = np.zeros((P + 1, P + 1))
    fin = np.zeros(P + 1)
    for seq in phone_seqs:
        prev = 0  # BOS
        for p in seq:
            uni[p] += 1
            big[prev, p] += 1
            prev = p
        fin[prev] += 1
    uni_p = uni / uni.sum()
    counts = big.sum(axis=1) + fin
    counts = np.maximum(counts, 1e-10)
    big_p = big / counts[:, None]
    fin_p = fin / counts
    # interpolate bigram with unigram; keep a floor on the final prob
    trans = interp * big_p + (1.0 - interp) * uni_p[None, :]
    final = interp * fin_p + (1.0 - interp) * 0.05
    # renormalize rows of [trans | final]
    z = trans.sum(axis=1) + final
    trans /= z[:, None]
    final /= z
    init = trans[0].copy()
    return init, trans, final


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


def write_random_chain_corpus(out_dir: str, n_utts: int, seconds: float, n_phones: int,
                              succ_per_phone: int, seed: int = 0,
                              n_valid: int = 0) -> Dict[str, object]:
    """A synthetic chain training set in ``out_dir``: ``data/`` (wav.scp and
    utt2len of ``n_utts`` noise utterances of ``seconds``), ``den.fst``
    from ``random_bigram_den``, and ``fsts.ark``/``fst.scp`` with one
    numerator per utterance for a random phone walk of a third of its
    output frames; with ``n_valid`` > 0 a held-out set the same way in
    ``valid/`` and ``valid_fsts.ark``/``valid_fst.scp``. Returns the paths
    (``data``, ``fst_scp``, ``den_fst``, and ``valid``, ``valid_fst_scp``
    with a held-out set) and ``num_pdfs``."""
    rng = np.random.default_rng(seed)
    den, tree, trans = random_bigram_den(n_phones, succ_per_phone, seed)
    n = int(seconds * 16000)
    frames = ((n + 80) // 160 - 2) // 3  # the TDNN-F's output frames

    def write_set(name: str, prefix: str, count: int) -> Tuple[str, str]:
        data = os.path.join(out_dir, name)
        os.makedirs(data, exist_ok=True)
        wav_scp, u2l, nums = {}, {}, {}
        for i in range(count):
            utt = f"{name}{i:04d}"
            path = os.path.join(data, f"{utt}.wav")
            kaldi_data.write_wav(path, (rng.standard_normal(n) * 0.1).astype(np.float32), 16000)
            wav_scp[utt], u2l[utt] = path, str(n)
            nums[utt] = numerator_fst(random_phone_walk(trans, max(frames // 3, 1), rng), tree)
        kaldi_data.write_keyed_text(wav_scp, os.path.join(data, "wav.scp"))
        kaldi_data.write_keyed_text(u2l, os.path.join(data, "utt2len"))
        fst_scp = os.path.join(out_dir, f"{prefix}fst.scp")
        write_fst_ark(nums, os.path.join(out_dir, f"{prefix}fsts.ark"), fst_scp)
        return data, fst_scp

    out: Dict[str, object] = {"num_pdfs": tree.num_pdfs,
                              "den_fst": os.path.join(out_dir, "den.fst")}
    out["data"], out["fst_scp"] = write_set("data", "", n_utts)
    if n_valid > 0:
        out["valid"], out["valid_fst_scp"] = write_set("valid", "valid_", n_valid)
    den.write(out["den_fst"])
    return out


# ---------------------------------------------------------------------------
# Decoding graph (HCLG equivalent, kaldi utils/mkgraph.sh without kaldi)
# ---------------------------------------------------------------------------


def estimate_word_bigram(texts: Sequence[Sequence[str]], interp: float = 0.5):
    """Interpolated word bigram: returns (words, init, trans, final) like
    estimate_phone_bigram but over a word vocabulary."""
    vocab = sorted({w for t in texts for w in t})
    word_id = {w: i + 1 for i, w in enumerate(vocab)}
    seqs = [[word_id[w] for w in t] for t in texts]
    init, trans, final = estimate_phone_bigram(seqs, len(vocab), interp=interp)
    return vocab, init, trans, final


def make_decode_graph(tree: BiphoneTree, lexicon: Lexicon,
                      phone_id: Dict[str, int], vocab: List[str],
                      trans: np.ndarray, final: np.ndarray,
                      optional_sil: bool = True,
                      prune_floor: float = 1e-4) -> Tuple[Fst, Dict[int, str]]:
    """Word-bigram decoding graph over pdf+1 input labels with word output
    labels — the HCLG the reference builds with kaldi mkgraph
    (prepare_data.sh stage 6). States are (lm_state, word, phone_pos,
    left_phone) expanded through the chain topology; optional silence may be
    taken between words. Suitable for small/medium vocabularies (the python
    expansion is explicit, not determinized-shared).

    Returns (graph, word_table {id: word}).
    """
    V = len(vocab)
    word_phones = {i + 1: [phone_id[p] for p in (lexicon.word_phones(vocab[i]) or [])]
                   for i in range(V)}
    word_phones = {w: ph for w, ph in word_phones.items() if ph}
    sil = phone_id.get(lexicon.sil)
    fst = Fst()
    # boundary state per (lm_state q, left_phone l): between words
    bstate: Dict[Tuple[int, int], int] = {}

    def get_b(q: int, l: int) -> int:
        key = (q, l)
        if key not in bstate:
            s = fst.add_state()
            bstate[key] = s
            if q > 0 and final[q] > prune_floor:
                fst.set_final(s, -math.log(final[q]))
        return bstate[key]

    fst.start = get_b(0, 0)
    todo = [(0, 0)]
    seen = {(0, 0)}
    while todo:
        q, l = todo.pop()
        src = get_b(q, l)
        # optional silence before the next word (self-transition on boundary)
        if optional_sil and sil is not None and l != sil:
            mid = fst.add_state()
            fp, sp = tree.forward_pdf(l, sil) + 1, tree.selfloop_pdf(l, sil) + 1
            fst.add_arc(src, Arc(fp, 0, 0.0, mid))
            fst.add_arc(mid, Arc(sp, 0, 0.0, mid))
            key = (q, sil)
            dst = get_b(q, sil)
            fst.add_arc(mid, Arc(0, 0, 0.0, dst))
            if key not in seen:
                seen.add(key)
                todo.append(key)
        for w, phones in word_phones.items():
            p_lm = trans[q, w]
            if p_lm <= prune_floor:
                continue
            cost = -math.log(p_lm)
            cur, left = src, l
            for pos, ph in enumerate(phones):
                mid = fst.add_state()
                fp, sp = tree.forward_pdf(left, ph) + 1, tree.selfloop_pdf(left, ph) + 1
                # word output + LM weight on the first arc of the word
                fst.add_arc(cur, Arc(fp, w if pos == 0 else 0,
                                     cost if pos == 0 else 0.0, mid))
                fst.add_arc(mid, Arc(sp, 0, 0.0, mid))
                if pos + 1 < len(phones):
                    nxt = fst.add_state()
                    fst.add_arc(mid, Arc(0, 0, 0.0, nxt))
                    cur, left = nxt, ph
                else:
                    key = (w, ph)
                    dst = get_b(w, ph)
                    fst.add_arc(mid, Arc(0, 0, 0.0, dst))
                    if key not in seen:
                        seen.add(key)
                        todo.append(key)
    graph = fst_connect(fst_rmepsilon(fst))
    return graph, {i + 1: w for i, w in enumerate(vocab)}
