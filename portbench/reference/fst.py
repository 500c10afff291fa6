"""Frozen copy of ``satpu_torch/chain/fst.py`` for the benchmark's plain reference.

Unchanged.

The original docstring follows.

Weighted FSTs for LF-MMI training, numpy only (a copy of
``satpu.chain.fst``, kept so the port imports nothing of satpu).

Provides:
- an in-memory ``Fst`` (tropical/log weights as -log probs, standard arcs),
- OpenFst-compatible binary read/write (VectorFst<StdArc>, the format kaldi's
  den.fst / normalization.fst / per-utt numerator FSTs use) so graphs
  prepared with kaldi tooling load directly,
- text-format (AT&T) parsing for tests and graph construction,
- conversion to flat arc arrays for the batched forward-backward
  (satpu_torch.chain.objf).
"""
from __future__ import annotations

import io
import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

OPENFST_MAGIC = 2125659606  # 0x7eb2fdd6
INF = float("inf")
# finite stand-in for log(0): keeps autodiff NaN-free (exp(-1e30) == 0)
NEG_INF = -1.0e30


@dataclass
class Arc:
    ilabel: int
    olabel: int
    weight: float  # -log prob (tropical/log semiring value)
    nextstate: int


@dataclass
class Fst:
    """Simple mutable FST; state 0-based; final weights -log prob (inf = not final)."""

    arcs: List[List[Arc]] = field(default_factory=list)
    finals: List[float] = field(default_factory=list)
    start: int = 0

    def add_state(self) -> int:
        self.arcs.append([])
        self.finals.append(INF)
        return len(self.arcs) - 1

    def add_arc(self, state: int, arc: Arc) -> None:
        self.arcs[state].append(arc)

    def set_final(self, state: int, weight: float = 0.0) -> None:
        self.finals[state] = weight

    @property
    def num_states(self) -> int:
        return len(self.arcs)

    @property
    def num_arcs(self) -> int:
        return sum(len(a) for a in self.arcs)

    # ------------------------------------------------------------------
    # text format (AT&T): "src dst ilabel olabel [weight]" / "state [weight]"
    # ------------------------------------------------------------------

    @classmethod
    def from_text(cls, text: str) -> "Fst":
        fst = cls()

        def ensure(n):
            while fst.num_states <= n:
                fst.add_state()

        for line in text.strip().splitlines():
            parts = line.split()
            if not parts:
                continue
            if len(parts) >= 4:
                src, dst, il, ol = int(parts[0]), int(parts[1]), int(parts[2]), int(parts[3])
                w = float(parts[4]) if len(parts) > 4 else 0.0
                ensure(max(src, dst))
                fst.add_arc(src, Arc(il, ol, w, dst))
            else:
                s = int(parts[0])
                w = float(parts[1]) if len(parts) > 1 else 0.0
                ensure(s)
                fst.set_final(s, w)
        return fst

    def to_text(self) -> str:
        out = []
        for s, arcs in enumerate(self.arcs):
            for a in arcs:
                out.append(f"{s}\t{a.nextstate}\t{a.ilabel}\t{a.olabel}\t{a.weight}")
        for s, w in enumerate(self.finals):
            if w != INF:
                out.append(f"{s}\t{w}")
        return "\n".join(out)

    # ------------------------------------------------------------------
    # OpenFst binary (VectorFst<StdArc>)
    # ------------------------------------------------------------------

    def write_binary(self, f) -> None:
        def wstr(s: str):
            f.write(struct.pack("<i", len(s)))
            f.write(s.encode())

        f.write(struct.pack("<i", OPENFST_MAGIC))
        wstr("vector")
        wstr("standard")
        f.write(struct.pack("<i", 2))  # version
        f.write(struct.pack("<i", 0))  # flags
        f.write(struct.pack("<Q", 0))  # properties
        f.write(struct.pack("<q", self.start))
        f.write(struct.pack("<q", self.num_states))
        f.write(struct.pack("<q", self.num_arcs))
        for s in range(self.num_states):
            w = self.finals[s]
            f.write(struct.pack("<f", w if w != INF else np.float32(np.inf)))
            f.write(struct.pack("<q", len(self.arcs[s])))
            for a in self.arcs[s]:
                f.write(struct.pack("<iifi", a.ilabel, a.olabel, a.weight, a.nextstate))

    @classmethod
    def read_binary(cls, f) -> "Fst":
        magic = struct.unpack("<i", f.read(4))[0]
        assert magic == OPENFST_MAGIC, f"bad OpenFst magic {magic}"

        def rstr():
            n = struct.unpack("<i", f.read(4))[0]
            return f.read(n).decode()

        fsttype = rstr()
        arctype = rstr()
        assert arctype == "standard", f"unsupported arc type {arctype}"
        version = struct.unpack("<i", f.read(4))[0]
        _flags = struct.unpack("<i", f.read(4))[0]
        _props = struct.unpack("<Q", f.read(8))[0]
        start = struct.unpack("<q", f.read(8))[0]
        num_states = struct.unpack("<q", f.read(8))[0]
        _num_arcs = struct.unpack("<q", f.read(8))[0]
        if fsttype == "const":
            return cls._read_const_body(f, start, num_states)
        fst = cls()
        for _ in range(max(num_states, 0)):
            fst.add_state()
        fst.start = max(start, 0)
        for s in range(max(num_states, 0)):
            w = struct.unpack("<f", f.read(4))[0]
            fst.finals[s] = w if np.isfinite(w) else INF
            narcs = struct.unpack("<q", f.read(8))[0]
            if narcs > 0:
                raw = np.frombuffer(f.read(16 * narcs), dtype=np.uint8).reshape(narcs, 16)
                il = raw[:, 0:4].copy().view("<i4")[:, 0]
                ol = raw[:, 4:8].copy().view("<i4")[:, 0]
                wt = raw[:, 8:12].copy().view("<f4")[:, 0]
                ns = raw[:, 12:16].copy().view("<i4")[:, 0]
                fst.arcs[s] = [Arc(int(a), int(b), float(c), int(d))
                               for a, b, c, d in zip(il, ol, wt, ns)]
        return fst

    @classmethod
    def _read_const_body(cls, f, start, num_states) -> "Fst":
        """ConstFst<StdArc> body (openfst const-fst.h, version >= 2): the
        state and arc arrays are 16-byte aligned relative to the absolute
        stream position (MappedFile::kArchAlignment). Each ConstState is
        (final f32, pos u32, narcs u32, niepsilons u32, noepsilons u32);
        arcs are (ilabel, olabel, weight, nextstate). kaldi HCLG graphs are
        commonly stored this way after fstconvert."""

        def align16():
            pos = f.tell()
            pad = (-pos) % 16
            if pad:
                f.read(pad)

        fst = cls()
        for _ in range(max(num_states, 0)):
            fst.add_state()
        fst.start = max(start, 0)
        align16()
        sraw = np.frombuffer(f.read(20 * num_states), dtype=np.uint8).reshape(num_states, 20)
        final_w = sraw[:, 0:4].copy().view("<f4")[:, 0]
        pos_arr = sraw[:, 4:8].copy().view("<u4")[:, 0]
        narcs_arr = sraw[:, 8:12].copy().view("<u4")[:, 0]
        align16()
        total_arcs = int(pos_arr[-1] + narcs_arr[-1]) if num_states else 0
        araw = np.frombuffer(f.read(16 * total_arcs), dtype=np.uint8).reshape(total_arcs, 16)
        il = araw[:, 0:4].copy().view("<i4")[:, 0]
        ol = araw[:, 4:8].copy().view("<i4")[:, 0]
        wt = araw[:, 8:12].copy().view("<f4")[:, 0]
        ns = araw[:, 12:16].copy().view("<i4")[:, 0]
        for s in range(num_states):
            w = float(final_w[s])
            fst.finals[s] = w if np.isfinite(w) else INF
            lo, n = int(pos_arr[s]), int(narcs_arr[s])
            fst.arcs[s] = [Arc(int(a), int(b), float(c), int(d))
                           for a, b, c, d in zip(il[lo:lo+n], ol[lo:lo+n],
                                                 wt[lo:lo+n], ns[lo:lo+n])]
        return fst

    def write(self, path: str) -> None:
        with open(path, "wb") as f:
            self.write_binary(f)

    @classmethod
    def read(cls, path: str) -> "Fst":
        with open(path, "rb") as f:
            return cls.read_binary(f)


def read_fst_kaldi(f) -> Fst:
    """Read a kaldi-wrapped FST (binary header \\0B + openfst binary)."""
    pos = f.tell()
    hdr = f.read(2)
    if hdr != b"\0B":
        f.seek(pos)
    return Fst.read_binary(f)


# ---------------------------------------------------------------------------
# flat arc arrays for the batched forward-backward
# ---------------------------------------------------------------------------


@dataclass
class GraphArrays:
    """Flattened transition tables of one FST for the dense recursion.

    Labels follow the chain convention: ilabel = pdf-id + 1 (0 = epsilon).
    Weights are stored as log-probs (negated OpenFst weights).
    """

    num_states: int
    arc_src: np.ndarray  # [E] int32
    arc_dst: np.ndarray  # [E] int32
    arc_pdf: np.ndarray  # [E] int32 (pdf-id, -1 for epsilon)
    arc_logprob: np.ndarray  # [E] float32 (log prob)
    start_logprob: np.ndarray  # [S] (0 at start state, -inf elsewhere)
    final_logprob: np.ndarray  # [S]


def fst_to_arrays(fst: Fst, label_offset: int = 1) -> GraphArrays:
    srcs, dsts, pdfs, ws = [], [], [], []
    for s, arcs in enumerate(fst.arcs):
        for a in arcs:
            srcs.append(s)
            dsts.append(a.nextstate)
            pdfs.append(a.ilabel - label_offset if a.ilabel > 0 else -1)
            ws.append(-a.weight)
    start = np.full(fst.num_states, NEG_INF, dtype=np.float32)
    start[fst.start] = 0.0
    final = np.array([-w if w != INF else NEG_INF for w in fst.finals], dtype=np.float32)
    return GraphArrays(
        num_states=fst.num_states,
        arc_src=np.asarray(srcs, dtype=np.int32),
        arc_dst=np.asarray(dsts, dtype=np.int32),
        arc_pdf=np.asarray(pdfs, dtype=np.int32),
        arc_logprob=np.asarray(ws, dtype=np.float32),
        start_logprob=start,
        final_logprob=final,
    )


def pad_graph_arrays(graphs: List[GraphArrays]) -> Dict[str, np.ndarray]:
    """Pad a list of per-utterance graphs to common (S, E) for batching.

    Padding arcs point from the last padded state to itself with -inf weight.
    Returns stacked arrays (dict of [B, ...]).
    """
    S = max(g.num_states for g in graphs)
    E = max(len(g.arc_src) for g in graphs)
    B = len(graphs)
    out = {
        "arc_src": np.zeros((B, E), np.int32),
        "arc_dst": np.zeros((B, E), np.int32),
        "arc_pdf": np.zeros((B, E), np.int32),
        "arc_logprob": np.full((B, E), NEG_INF, np.float32),
        "start_logprob": np.full((B, S), NEG_INF, np.float32),
        "final_logprob": np.full((B, S), NEG_INF, np.float32),
        "num_states": np.zeros((B,), np.int32),
    }
    for i, g in enumerate(graphs):
        e = len(g.arc_src)
        out["arc_src"][i, :e] = g.arc_src
        out["arc_dst"][i, :e] = g.arc_dst
        out["arc_pdf"][i, :e] = np.maximum(g.arc_pdf, 0)
        out["arc_logprob"][i, :e] = g.arc_logprob
        out["start_logprob"][i, : g.num_states] = g.start_logprob
        out["final_logprob"][i, : g.num_states] = g.final_logprob
        out["num_states"][i] = g.num_states
        # padding arcs: self-loop on state 0 with -inf weight (already -inf)
    return out


def fst_connect(fst: Fst) -> Fst:
    """Trim states not reachable from start or not reaching a final state."""
    n = fst.num_states
    if n == 0:
        return fst
    fwd = [False] * n
    stack = [fst.start]
    fwd[fst.start] = True
    while stack:
        s = stack.pop()
        for a in fst.arcs[s]:
            if not fwd[a.nextstate]:
                fwd[a.nextstate] = True
                stack.append(a.nextstate)
    # backward reachability over reversed arcs
    rev: List[List[int]] = [[] for _ in range(n)]
    for s in range(n):
        for a in fst.arcs[s]:
            rev[a.nextstate].append(s)
    bwd = [False] * n
    stack = [s for s in range(n) if fst.finals[s] != INF]
    for s in stack:
        bwd[s] = True
    while stack:
        s = stack.pop()
        for p in rev[s]:
            if not bwd[p]:
                bwd[p] = True
                stack.append(p)
    keep = [s for s in range(n) if fwd[s] and bwd[s]]
    remap = {s: i for i, s in enumerate(keep)}
    out = Fst()
    for _ in keep:
        out.add_state()
    if fst.start not in remap:
        return out  # empty language
    out.start = remap[fst.start]
    for s in keep:
        out.finals[remap[s]] = fst.finals[s]
        for a in fst.arcs[s]:
            if a.nextstate in remap:
                out.add_arc(remap[s], Arc(a.ilabel, a.olabel, a.weight, remap[a.nextstate]))
    return out


def fst_rmepsilon(fst: Fst) -> Fst:
    """Weighted epsilon removal (tropical): replace each state's epsilon
    closure with direct arcs/finals. REQUIRED before fst_to_arrays — the
    dense forward-backward treats every arc as emitting, so epsilon arcs
    would each consume a frame."""
    n = fst.num_states
    import heapq

    out = Fst()
    for _ in range(n):
        out.add_state()
    out.start = fst.start
    for s in range(n):
        # Dijkstra over epsilon arcs from s
        dist = {s: 0.0}
        heap = [(0.0, s)]
        while heap:
            c, u = heapq.heappop(heap)
            if c > dist.get(u, INF):
                continue
            for a in fst.arcs[u]:
                if a.ilabel == 0:
                    nc = c + a.weight
                    if nc < dist.get(a.nextstate, INF):
                        dist[a.nextstate] = nc
                        heapq.heappush(heap, (nc, a.nextstate))
        best_final = INF
        seen_arcs = {}
        for t, w in dist.items():
            if fst.finals[t] != INF:
                best_final = min(best_final, w + fst.finals[t])
            for a in fst.arcs[t]:
                if a.ilabel == 0:
                    continue
                key = (a.ilabel, a.olabel, a.nextstate)
                cost = w + a.weight
                if cost < seen_arcs.get(key, INF):
                    seen_arcs[key] = cost
        for (il, ol, ns), w in seen_arcs.items():
            out.add_arc(s, Arc(il, ol, w, ns))
        if best_final != INF:
            out.set_final(s, best_final)
    return fst_connect(out)


def fst_compose_acceptor(a: Fst, b: Fst) -> Fst:
    """Weighted intersection of two acceptors over the same label alphabet
    (tropical semiring: weights add). Epsilon (ilabel 0) arcs in either side
    move freely without consuming from the other (sufficient for
    normalization graphs, whose epsilons only leave the start state). This is
    the core of the reference's ``AddWeightToSupervisionFst`` supervision
    normalization (kaldi chain-supervision; bound at csrc/pkwrap-main.h:113)."""
    out = Fst()
    state_map: Dict[Tuple[int, int], int] = {}

    def get_state(sa: int, sb: int) -> int:
        key = (sa, sb)
        if key not in state_map:
            state_map[key] = out.add_state()
            fa, fb = a.finals[sa], b.finals[sb]
            if fa != INF and fb != INF:
                out.set_final(state_map[key], fa + fb)
        return state_map[key]

    out.start = get_state(a.start, b.start)
    # b arcs indexed by (state, label) for fast matching
    b_index: List[Dict[int, List[Arc]]] = []
    for arcs in b.arcs:
        d: Dict[int, List[Arc]] = {}
        for arc in arcs:
            d.setdefault(arc.ilabel, []).append(arc)
        b_index.append(d)
    stack = [(a.start, b.start)]
    seen = {(a.start, b.start)}

    def visit(key):
        if key not in seen:
            seen.add(key)
            stack.append(key)

    while stack:
        sa, sb = stack.pop()
        src = get_state(sa, sb)
        for arc in a.arcs[sa]:
            if arc.ilabel == 0:  # epsilon: advance a only
                key = (arc.nextstate, sb)
                out.add_arc(src, Arc(0, 0, arc.weight, get_state(*key)))
                visit(key)
                continue
            for barc in b_index[sb].get(arc.ilabel, ()):
                key = (arc.nextstate, barc.nextstate)
                out.add_arc(src, Arc(arc.ilabel, arc.olabel,
                                     arc.weight + barc.weight, get_state(*key)))
                visit(key)
        for barc in b_index[sb].get(0, ()):  # epsilon: advance b only
            key = (sa, barc.nextstate)
            out.add_arc(src, Arc(0, 0, barc.weight, get_state(*key)))
            visit(key)
    return fst_connect(out)


def linear_fst_from_pdf_sequence(pdf_ids, self_loops: bool = True) -> Fst:
    """A trivial numerator-style FST accepting the given pdf sequence (with
    optional self-loops), for tests and toy training."""
    fst = Fst()
    s0 = fst.add_state()
    cur = s0
    for pdf in pdf_ids:
        nxt = fst.add_state()
        fst.add_arc(cur, Arc(int(pdf) + 1, int(pdf) + 1, 0.0, nxt))
        if self_loops:
            fst.add_arc(nxt, Arc(int(pdf) + 1, int(pdf) + 1, 0.0, nxt))
        cur = nxt
    fst.set_final(cur, 0.0)
    return fst
