"""Kaldi TransitionModel reader/writer and the transition-id -> pdf-id
mapping, pure Python (a copy of ``satpu.chain.hmm``, kept so the port
imports nothing of satpu).

Kaldi-prepared numerator graphs carry transition-id labels; the reference
maps them to pdf ids through kaldi's ReadTransitionModel. This module
parses kaldi's binary format directly (\\0B + tokenized fields):
HmmTopology (phones, phone2idx, per-entry states with pdf classes and
transitions) and the tuples/triples table, and ``relabel_fst_to_pdfs``
relabels a graph to the chain convention (pdf+1) for ``EgsDataset``.

A matching writer exists for round-trip tests (kaldi is absent here).
"""
from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import BinaryIO, Dict, List, Tuple


# ---------------------------------------------------------------------------
# kaldi binary primitives
# ---------------------------------------------------------------------------


def read_token(f: BinaryIO) -> str:
    tok = b""
    while True:
        c = f.read(1)
        if not c:
            raise EOFError("token")
        if c == b" ":
            if tok:
                break
            continue
        tok += c
    return tok.decode()


def expect_token(f: BinaryIO, want: str) -> None:
    got = read_token(f)
    if got != want:
        raise ValueError(f"expected {want!r}, got {got!r}")


def read_int32(f: BinaryIO) -> int:
    size = f.read(1)
    assert size == b"\x04", f"bad int size marker {size!r}"
    return struct.unpack("<i", f.read(4))[0]


def write_int32(f: BinaryIO, v: int) -> None:
    f.write(b"\x04" + struct.pack("<i", v))


def read_float(f: BinaryIO) -> float:
    size = f.read(1)
    assert size == b"\x04", f"bad float size marker {size!r}"
    return struct.unpack("<f", f.read(4))[0]


def write_float(f: BinaryIO, v: float) -> None:
    f.write(b"\x04" + struct.pack("<f", v))


def read_int_vector(f: BinaryIO) -> List[int]:
    n = read_int32(f)
    out = []
    for _ in range(n):
        sz = f.read(1)
        assert sz == b"\x04"
        out.append(struct.unpack("<i", f.read(4))[0])
    return out


def write_int_vector(f: BinaryIO, v: List[int]) -> None:
    write_int32(f, len(v))
    for x in v:
        f.write(b"\x04" + struct.pack("<i", x))


def read_float_vector(f: BinaryIO) -> List[float]:
    tok = read_token(f)
    if tok == "FV":
        n = read_int32(f)
        return list(struct.unpack(f"<{n}f", f.read(4 * n)))
    if tok == "DV":
        n = read_int32(f)
        return list(struct.unpack(f"<{n}d", f.read(8 * n)))
    raise ValueError(f"unexpected vector token {tok!r}")


def write_float_vector(f: BinaryIO, v: List[float]) -> None:
    f.write(b"FV ")
    write_int32(f, len(v))
    f.write(struct.pack(f"<{len(v)}f", *v))


# ---------------------------------------------------------------------------
# HmmTopology + TransitionModel
# ---------------------------------------------------------------------------


@dataclass
class HmmState:
    forward_pdf_class: int
    self_loop_pdf_class: int
    transitions: List[Tuple[int, float]] = field(default_factory=list)


@dataclass
class HmmTopology:
    phones: List[int] = field(default_factory=list)
    phone2idx: List[int] = field(default_factory=list)
    entries: List[List[HmmState]] = field(default_factory=list)

    def entry_for_phone(self, phone: int) -> List[HmmState]:
        return self.entries[self.phone2idx[phone]]

    @classmethod
    def read(cls, f: BinaryIO) -> "HmmTopology":
        expect_token(f, "<Topology>")
        topo = cls()
        topo.phones = read_int_vector(f)
        topo.phone2idx = read_int_vector(f)
        n_entries = read_int32(f)
        for _ in range(n_entries):
            n_states = read_int32(f)
            entry: List[HmmState] = []
            for _ in range(n_states):
                fwd = read_int32(f)
                # kaldi >= 5.2 writes both pdf classes; self-loop == forward
                # for classic topologies, distinct for "chain" topology
                sl = read_int32(f)
                n_trans = read_int32(f)
                trans = [(read_int32(f), read_float(f)) for _ in range(n_trans)]
                entry.append(HmmState(fwd, sl, trans))
            topo.entries.append(entry)
        expect_token(f, "</Topology>")
        return topo

    def write(self, f: BinaryIO) -> None:
        f.write(b"<Topology> ")
        write_int_vector(f, self.phones)
        write_int_vector(f, self.phone2idx)
        write_int32(f, len(self.entries))
        for entry in self.entries:
            write_int32(f, len(entry))
            for st in entry:
                write_int32(f, st.forward_pdf_class)
                write_int32(f, st.self_loop_pdf_class)
                write_int32(f, len(st.transitions))
                for idx, p in st.transitions:
                    write_int32(f, idx)
                    write_float(f, p)
        f.write(b"</Topology> ")


@dataclass
class TransitionModel:
    """tuples[t] = (phone, hmm_state, forward_pdf, self_loop_pdf); transition
    ids are 1-based, grouped by transition state (= tuple index + 1)."""

    topo: HmmTopology
    tuples: List[Tuple[int, int, int, int]]
    log_probs: List[float] = field(default_factory=list)

    def __post_init__(self):
        # state2id[ts] = first transition-id of transition-state ts (1-based)
        self.state2id = [0, 1]
        for (phone, hmm_state, _, _) in self.tuples:
            n = len(self.topo.entry_for_phone(phone)[hmm_state].transitions)
            self.state2id.append(self.state2id[-1] + n)
        self.num_transition_ids = self.state2id[-1] - 1

    @property
    def num_pdfs(self) -> int:
        m = 0
        for (_, _, fp, sp) in self.tuples:
            m = max(m, fp, sp)
        return m + 1

    def transition_id_to_pdf(self, tid: int) -> int:
        """TransitionModel::TransitionIdToPdf: self-loop transitions emit the
        self-loop pdf, others the forward pdf."""
        # binary search over state2id
        import bisect

        ts = bisect.bisect_right(self.state2id, tid) - 1
        phone, hmm_state, fwd_pdf, sl_pdf = self.tuples[ts - 1]
        offset = tid - self.state2id[ts]
        dest, _ = self.topo.entry_for_phone(phone)[hmm_state].transitions[offset]
        return sl_pdf if dest == hmm_state else fwd_pdf

    def pdf_map(self) -> Dict[int, int]:
        return {tid: self.transition_id_to_pdf(tid)
                for tid in range(1, self.num_transition_ids + 1)}

    @classmethod
    def read(cls, f: BinaryIO) -> "TransitionModel":
        hdr = f.read(2)
        if hdr != b"\x00B":
            f.seek(-2, 1)
        expect_token(f, "<TransitionModel>")
        topo = HmmTopology.read(f)
        tok = read_token(f)
        tuples: List[Tuple[int, int, int, int]] = []
        if tok == "<Tuples>":
            n = read_int32(f)
            for _ in range(n):
                tuples.append((read_int32(f), read_int32(f), read_int32(f),
                               read_int32(f)))
            expect_token(f, "</Tuples>")
        elif tok == "<Triples>":
            n = read_int32(f)
            for _ in range(n):
                phone, hmm_state, pdf = (read_int32(f), read_int32(f),
                                         read_int32(f))
                tuples.append((phone, hmm_state, pdf, pdf))
            expect_token(f, "</Triples>")
        else:
            raise ValueError(f"unexpected token {tok!r}")
        expect_token(f, "<LogProbs>")
        log_probs = read_float_vector(f)
        expect_token(f, "</LogProbs>")
        expect_token(f, "</TransitionModel>")
        return cls(topo, tuples, log_probs)

    def write(self, f: BinaryIO) -> None:
        f.write(b"\x00B<TransitionModel> ")
        self.topo.write(f)
        f.write(b"<Tuples> ")
        write_int32(f, len(self.tuples))
        for t in self.tuples:
            for x in t:
                write_int32(f, x)
        f.write(b"</Tuples> ")
        f.write(b"<LogProbs> ")
        write_float_vector(f, self.log_probs or
                           [0.0] * (self.num_transition_ids + 1))
        f.write(b" </LogProbs> ")
        f.write(b"</TransitionModel> ")


def read_transition_model(path: str) -> TransitionModel:
    with open(path, "rb") as f:
        return TransitionModel.read(f)


def relabel_fst_to_pdfs(fst, tmodel: TransitionModel):
    """Map a transition-id-labeled kaldi training graph onto the chain
    convention (ilabel = pdf + 1) in place; returns the fst."""
    pdf_of = tmodel.pdf_map()
    for arcs in fst.arcs:
        for a in arcs:
            if a.ilabel > 0:
                a.ilabel = pdf_of[a.ilabel] + 1
    return fst


def chain_topology(phones: List[int]) -> HmmTopology:
    """Kaldi 'chain' topology: one state, forward pdf-class 0 on the forward
    transition, self-loop pdf-class 1 (gen_topo.py chain variant)."""
    topo = HmmTopology()
    topo.phones = list(phones)
    topo.phone2idx = [0] * (max(phones) + 1)
    for p in phones:
        topo.phone2idx[p] = 0
    # state 0: transitions to itself (index 0) and to final state 1 (index 1)
    st = HmmState(0, 1, [(0, 0.5), (1, 0.5)])
    final = HmmState(-1, -1, [])
    topo.entries.append([st, final])
    return topo
