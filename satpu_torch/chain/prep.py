"""Chain graph construction and data preparation, numpy only (a copy of
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


def phone_lm_fst(init: np.ndarray, trans: np.ndarray, final: np.ndarray,
                 prune_floor: float = 1e-6) -> Fst:
    """Bigram matrices -> epsilon-free acceptor over phone labels. State 0 =
    BOS, state p = "last phone was p"."""
    P = len(final) - 1
    fst = Fst()
    for _ in range(P + 1):
        fst.add_state()
    fst.start = 0
    for q in range(P + 1):
        if q > 0:
            fst.set_final(q, -math.log(max(final[q], prune_floor)))
        row = trans[q]
        for p in range(1, P + 1):
            if row[p] > prune_floor:
                fst.add_arc(q, Arc(p, p, -math.log(row[p]), p))
    return fst


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


def make_normalization_fst(den: Fst, num_iters: int = 100) -> Fst:
    """den.fst with power-iterated initial probabilities and all states final
    (kaldi chain-make-den-fst's second output; used to weight numerator
    supervisions so num/den share the same normalization)."""
    n = den.num_states
    # transition matrix in prob space
    probs = np.zeros(n)
    probs[den.start] = 1.0
    rows: List[List[Tuple[int, float]]] = [[] for _ in range(n)]
    for s in range(n):
        tot = 0.0
        outs = []
        for a in den.arcs[s]:
            w = math.exp(-a.weight)
            outs.append((a.nextstate, w))
            tot += w
        if tot > 0:
            rows[s] = [(d, w / tot) for d, w in outs]
    # kaldi chain-den-graph ComputeInitialProbs: occupancies AVERAGED over the
    # first num_iters steps (so the true start state keeps nonzero mass and
    # numerator paths beginning at BOS stay composable)
    acc = probs.copy()
    for _ in range(num_iters):
        nxt = np.zeros(n)
        for s in range(n):
            ps = probs[s]
            if ps > 0:
                for d, w in rows[s]:
                    nxt[d] += ps * w
        probs = nxt / max(nxt.sum(), 1e-30)
        acc += probs
    probs = acc / max(acc.sum(), 1e-30)
    out = Fst()
    new_start = out.add_state()
    for _ in range(n):
        out.add_state()
    out.start = new_start
    for s in range(n):
        if probs[s] > 1e-20:
            out.add_arc(new_start, Arc(0, 0, -math.log(probs[s]), s + 1))
        out.set_final(s + 1, 0.0)
        for a in den.arcs[s]:
            out.add_arc(s + 1, Arc(a.ilabel, a.olabel, a.weight, a.nextstate + 1))
    return out


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


def _resample_linear(x: np.ndarray, out_len: int) -> np.ndarray:
    """Length-exact linear resample (the speed perturbation itself)."""
    in_len = x.shape[-1]
    if in_len == out_len:
        return x.astype(np.float32)
    pos = np.linspace(0.0, in_len - 1.0, out_len)
    i0 = np.floor(pos).astype(np.int64)
    i1 = np.minimum(i0 + 1, in_len - 1)
    frac = (pos - i0).astype(np.float32)
    return (x[..., i0] * (1.0 - frac) + x[..., i1] * frac).astype(np.float32)


def perturb_speed_to_allowed_lengths(data_dir: str, out_dir: str,
                                     num_lengths: int = 12,
                                     speeds: Sequence[float] = (0.9, 1.0, 1.1),
                                     max_stretch: float = 0.1) -> Dict[str, int]:
    """Create a speed-perturbed copy of ``data_dir`` where every utterance
    lands exactly on an allowed length (prepare_data.sh:137-141). Returns the
    new utt2len (samples). Writes wav files under out_dir/wavs plus wav.scp,
    utt2spk, text, utt2len, allowed_lengths.txt."""
    os.makedirs(os.path.join(out_dir, "wavs"), exist_ok=True)
    utt2wav = kaldi_data.read_wav_scp(os.path.join(data_dir, "wav.scp"))
    utt2spk = kaldi_data.read_keyed_text(os.path.join(data_dir, "utt2spk"))
    text_path = os.path.join(data_dir, "text")
    utt2text = kaldi_data.read_keyed_text(text_path) if os.path.exists(text_path) else {}

    wavs: Dict[str, Tuple[np.ndarray, int]] = {}
    for utt, spec in utt2wav.items():
        w, r = kaldi_data.load_wav_from_scp(spec)
        wavs[utt] = (w[0], r)
    allowed = allowed_sample_lengths([len(w) for w, _ in wavs.values()],
                                     num_lengths=num_lengths)

    new_scp: Dict[str, str] = {}
    new_spk: Dict[str, str] = {}
    new_text: Dict[str, str] = {}
    new_len: Dict[str, int] = {}
    for utt, (w, rate) in wavs.items():
        L = len(w)
        for sp in speeds:
            target_nominal = L / sp
            # closest allowed length within the stretch tolerance
            cands = [a for a in allowed
                     if abs(a - target_nominal) / target_nominal <= max_stretch]
            if not cands:
                continue
            target = min(cands, key=lambda a: abs(a - target_nominal))
            name = utt if sp == 1.0 else f"sp{sp:.1f}-{utt}"
            if name in new_len:
                continue
            if sp == 1.0 and target == L:
                y = w.astype(np.float32)
            else:
                y = _resample_linear(w, target)
            path = os.path.join(out_dir, "wavs", f"{name}.wav")
            kaldi_data.write_wav(path, y, rate)
            new_scp[name] = path
            new_spk[name] = utt2spk.get(utt, utt)
            if utt in utt2text:
                new_text[name] = utt2text[utt]
            new_len[name] = target
    kaldi_data.write_keyed_text(new_scp, os.path.join(out_dir, "wav.scp"))
    kaldi_data.write_keyed_text(new_spk, os.path.join(out_dir, "utt2spk"))
    if new_text:
        kaldi_data.write_keyed_text(new_text, os.path.join(out_dir, "text"))
    kaldi_data.write_keyed_text({k: str(v) for k, v in new_len.items()},
                                os.path.join(out_dir, "utt2len"))
    with open(os.path.join(out_dir, "allowed_lengths.txt"), "w") as f:
        for a in allowed:
            f.write(f"{a}\n")
    return new_len


def prepare_chain_data(data_dir: str, out_dir: str,
                       lexicon_path: Optional[str] = None,
                       num_lengths: int = 12, biphone: bool = True,
                       between_silprob: float = 0.1,
                       valid_fraction: float = 0.05,
                       speed_perturb: bool = True, seed: int = 0) -> Dict[str, object]:
    """data dir (wav.scp/text/utt2spk) -> trainable chain artifacts in
    out_dir: egs/ (perturbed data), fst_train.{ark,scp}, fst_valid.scp,
    den.fst, normalization.fst, tree.json, phones.txt, num_pdfs.

    Returns a summary dict (num_pdfs, counts, paths)."""
    rng = random.Random(seed)
    os.makedirs(out_dir, exist_ok=True)
    egs_dir = os.path.join(out_dir, "egs")
    if speed_perturb:
        perturb_speed_to_allowed_lengths(data_dir, egs_dir, num_lengths=num_lengths)
    else:
        os.makedirs(egs_dir, exist_ok=True)
        for f in ("wav.scp", "utt2spk", "text"):
            src = os.path.join(data_dir, f)
            if os.path.exists(src):
                kaldi_data.write_keyed_text(kaldi_data.read_keyed_text(src),
                                            os.path.join(egs_dir, f))
        kaldi_data.gen_utt2len(os.path.join(egs_dir, "wav.scp"),
                               os.path.join(egs_dir, "utt2len"))

    utt2text = kaldi_data.read_keyed_text(os.path.join(egs_dir, "text"))
    words = [w for t in utt2text.values() for w in t.split()]
    lexicon = (Lexicon.load(lexicon_path) if lexicon_path
               else Lexicon.grapheme(words))
    phones = lexicon.phones()
    phone_id = {p: i + 1 for i, p in enumerate(phones)}
    sil_id = phone_id[lexicon.sil] if lexicon.sil in phone_id else None

    # phone sequences (with sampled silences) for LM + tree estimation
    lm_seqs: List[List[int]] = []
    utt_phones: Dict[str, List[int]] = {}
    for utt, text in utt2text.items():
        ph = text_to_phones(text.split(), lexicon, between_silprob, rng)
        ids = [phone_id[p] for p in ph]
        lm_seqs.append(ids)
        # numerator uses the deterministic (no sampled silence) sequence
        ph_det = text_to_phones(text.split(), lexicon, 0.0, rng)
        utt_phones[utt] = [phone_id[p] for p in ph_det]

    init, trans, final = estimate_phone_bigram(lm_seqs, len(phones))
    tree = BiphoneTree.build(lm_seqs, phones, biphone=biphone)
    den = make_den_fst(trans, final, tree)
    norm = make_normalization_fst(den)
    den.write(os.path.join(out_dir, "den.fst"))
    norm.write(os.path.join(out_dir, "normalization.fst"))
    with open(os.path.join(out_dir, "tree.json"), "w") as f:
        f.write(tree.to_json())
    with open(os.path.join(out_dir, "phones.txt"), "w") as f:
        f.write("<eps> 0\n")
        for p, i in phone_id.items():
            f.write(f"{p} {i}\n")
    with open(os.path.join(out_dir, "num_pdfs"), "w") as f:
        f.write(str(tree.num_pdfs))

    fsts = {utt: numerator_fst(ids, tree, optional_sil=sil_id)
            for utt, ids in utt_phones.items() if ids}
    utts = sorted(fsts)
    rng.shuffle(utts)
    n_valid = max(1, int(len(utts) * valid_fraction)) if len(utts) > 2 else 0
    valid_utts = set(utts[:n_valid])
    write_fst_ark({u: fsts[u] for u in utts if u not in valid_utts},
                  os.path.join(out_dir, "fst_train.ark"),
                  os.path.join(out_dir, "fst_train.scp"))
    if valid_utts:
        write_fst_ark({u: fsts[u] for u in sorted(valid_utts)},
                      os.path.join(out_dir, "fst_valid.ark"),
                      os.path.join(out_dir, "fst_valid.scp"))
    # decoding graph + word table (mkgraph equivalent) for eval_anon
    try:
        vocab, _, wtrans, wfinal = estimate_word_bigram(
            [t.split() for t in utt2text.values()])
        graph, word_table = make_decode_graph(tree, lexicon, phone_id, vocab,
                                              wtrans, wfinal)
        graph.write(os.path.join(out_dir, "HCLG.fst"))
        with open(os.path.join(out_dir, "words.txt"), "w") as f:
            f.write("<eps> 0\n")
            for i, w in word_table.items():
                f.write(f"{w} {i}\n")
    except Exception as e:  # pragma: no cover - graph build is best-effort
        logging.warning("decode graph build failed: %s", e)
    logging.info("prepare_chain_data: %d phones, %d pdfs, %d train / %d valid "
                 "numerator graphs, den %d states / %d arcs",
                 len(phones), tree.num_pdfs, len(utts) - len(valid_utts),
                 len(valid_utts), den.num_states, den.num_arcs)
    return {"num_pdfs": tree.num_pdfs, "num_phones": len(phones),
            "egs_dir": egs_dir, "den_fst": os.path.join(out_dir, "den.fst"),
            "normalization_fst": os.path.join(out_dir, "normalization.fst"),
            "fst_train_scp": os.path.join(out_dir, "fst_train.scp"),
            "fst_valid_scp": os.path.join(out_dir, "fst_valid.scp") if valid_utts else "",
            "tree": tree}



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
