"""A traced stretch of a run: ``torch.profiler`` over the CPU and the card,
digested into what the per-layer readers and the result's ``breakdown``
use; a stretch with the program's own span recorder on; and the
benchmark's own spans (host clock, or CUDA events on the card's stream).

The digest names the host ranges of the benchmark (``portbench.``) and of
each span family the program lists (``program_prefixes``), so a family
that the program adds reaches ``breakdown`` and the readers with no edit
here."""
from __future__ import annotations

import bisect
import contextlib
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

WINDOW = "portbench.window"
# the ranges a digest names where the program lists no span families
DEFAULT_PREFIXES = ("portbench.", "chain.")


class Spans:
    """Named host-clock spans and CUDA-event spans of the benchmark's own
    making, kept in memory: ``host[name]`` and ``device[name]`` are lists
    of milliseconds."""

    def __init__(self, torch, device):
        self.torch, self.device = torch, device
        self.host: Dict[str, List[float]] = {}
        self.device_ms: Dict[str, List[float]] = {}
        self._pending: List[Tuple[str, object, object]] = []

    @contextlib.contextmanager
    def host_span(self, name: str):
        """Host milliseconds of the block, under a profiler range
        ``portbench.<name>``."""
        from torch.profiler import record_function

        t0 = time.perf_counter()
        with record_function("portbench." + name):
            yield
        self.host.setdefault(name, []).append((time.perf_counter() - t0) * 1e3)

    @staticmethod
    def range(name: str, on: bool):
        """A profiler range around the block when ``on``."""
        from torch.profiler import record_function

        return record_function(name) if on else contextlib.nullcontext()

    def event(self):
        """A recorded CUDA event on the current stream (None off the card)."""
        if self.device.type != "cuda":
            return None
        ev = self.torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def stream_span(self, name: str, start, end) -> None:
        if start is not None:
            self._pending.append((name, start, end))

    def snapshot(self) -> "Spans":
        """A copy of what the spans hold now."""
        out = Spans(self.torch, self.device)
        out.host = {k: list(v) for k, v in self.host.items()}
        out.device_ms = {k: list(v) for k, v in self.device_ms.items()}
        return out

    def resolve(self) -> None:
        """Turn the recorded event pairs into milliseconds (after a sync)."""
        for name, a, b in self._pending:
            self.device_ms.setdefault(name, []).append(a.elapsed_time(b))
        self._pending.clear()


@contextlib.contextmanager
def timed_ranges(torch, device, module, spans: Spans):
    """Time on the host clock, with no profiler running, the profiler
    ranges that ``module`` opens through its ``record_function``, with the
    card synchronised at each edge so that a range holds its own device
    work: milliseconds into ``spans.host[<range name>]``. A module that
    opens no such range leaves ``spans`` as it was."""
    sync = ((lambda: torch.cuda.synchronize(device)) if device.type == "cuda"
            else (lambda: None))

    @contextlib.contextmanager
    def timed(name):
        sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            sync()
            spans.host.setdefault(name, []).append((time.perf_counter() - t0) * 1e3)

    saved = getattr(module, "record_function", None)
    if saved is not None:
        module.record_function = timed
    try:
        yield
    finally:
        if saved is not None:
            module.record_function = saved


def program_trace():
    """The program's spans and counters (``satpu_torch.utils.trace``), or
    None where the program has no such module."""
    try:
        from satpu_torch.utils import trace as program
    except ImportError:
        return None
    return program


def program_prefixes() -> Tuple[str, ...]:
    """The digest's range prefixes: ``portbench.`` and each of the
    program's span families (the first segment of every name in its
    ``NAMES``); ``DEFAULT_PREFIXES`` where the program lists none."""
    names = getattr(program_trace(), "NAMES", None)
    if not names:
        return DEFAULT_PREFIXES
    return ("portbench.",) + tuple(sorted({n.split(".", 1)[0] + "." for n in names}))


@contextlib.contextmanager
def recorded(torch, device, steps: int):
    """Run the block, which serves ``steps`` batches or takes ``steps``
    steps, with the program's recorder on (a CUDA event pair a span on the
    card). Yields a holder; on exit its ``spans`` is ``{"spans": the
    recorded spans, "steps": steps}`` (what ``span_ms`` reads from a
    layer's ``recorded``) and its ``launches`` the change over the block of
    every counter that the program keeps, with ``steps``. Both stay None where the program has no
    recorder."""
    program = program_trace()
    holder = type("Recorded", (), {"spans": None, "launches": None})()
    if not hasattr(program, "recording"):
        yield holder
        return
    before = program.counters()
    with program.recording(events=device.type == "cuda"):
        yield holder
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    after = program.counters()
    holder.spans = {"spans": program.collect(), "steps": steps}
    holder.launches = {"steps": steps, **{k: n - before.get(k, 0) for k, n in after.items()}}


@contextlib.contextmanager
def profiled(torch, device, prefixes: Sequence[str]):
    """Profile the block (host and, on the card, device activity) inside a
    ``portbench.window`` range; yields a holder whose ``digest`` (naming
    the host ranges that start with one of ``prefixes``) is set on exit."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    holder = type("Traced", (), {"digest": None})()
    with profile(activities=acts) as prof:
        with record_function(WINDOW):
            yield holder
            if device.type == "cuda":
                torch.cuda.synchronize(device)
    holder.digest = digest(prof.events(), prefixes)


def _union(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def digest(events, ranges_prefixes: Sequence[str] = DEFAULT_PREFIXES) -> Dict:
    """From a profiler's events: the traced window, the device items, the
    device's busy time (the union of its items' intervals inside the
    window), the device time by operation, the idle time by the innermost
    named host range open while the card idled, and each named range with the
    device items launched inside it (times in microseconds)."""
    from torch.autograd import DeviceType

    window = None
    ranges, launches, items = [], {}, []
    for e in events:
        if e.device_type == DeviceType.CPU:
            tr = e.time_range
            if e.name == WINDOW:
                window = (tr.start, tr.end)
            elif any(e.name.startswith(p) for p in ranges_prefixes):
                ranges.append((tr.start, tr.end, e.name))
            elif e.name.startswith("cu"):  # runtime calls share their item's id
                launches[e.id] = tr.start
        elif not getattr(e, "is_user_annotation", False):
            items.append((e.time_range.start, e.time_range.end, e.name, e.id))
    if window is None:
        window = (min((i[0] for i in items), default=0.0), max((i[1] for i in items), default=0.0))
    w0, w1 = window
    busy_iv = _union((max(a, w0), min(b, w1)) for a, b, _, _ in items if b > w0 and a < w1)
    by_op: Dict[str, float] = {}
    for a, b, name, _ in items:
        by_op[name] = by_op.get(name, 0.0) + (b - a)
    ranges.sort()
    starts = [r[0] for r in ranges]

    def open_range(t: float) -> str:
        """The innermost named range open at host time t."""
        for a, b, name in reversed(ranges[:bisect.bisect_right(starts, t)]):
            if b >= t:  # the latest-starting range that holds t
                return name
        return "(no range)"

    gaps: Dict[str, float] = {}
    marks = sorted({x for r in ranges for x in r[:2]})
    edges = [w0] + [x for iv in busy_iv for x in iv] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        # an idle gap, cut where a named range opens or closes inside it
        cuts = [a] + marks[bisect.bisect_right(marks, a):bisect.bisect_left(marks, b)] + [b]
        for p, q in zip(cuts, cuts[1:]):
            if q > p:
                name = open_range((p + q) / 2)
                gaps[name] = gaps.get(name, 0.0) + (q - p)
    inside: Dict[str, List[Tuple[str, float]]] = {}
    for a, b, name, eid in items:
        t = launches.get(eid)
        if t is not None:
            inside.setdefault(open_range(t), []).append((name, b - a))
    return {"window_us": w1 - w0, "busy_us": sum(b - a for a, b in busy_iv),
            "items": [(name, b - a) for a, b, name, _ in items], "by_op": by_op,
            "idle_by_range": gaps, "ranges": ranges, "inside": inside}


def phase_ms(layer: Dict, names) -> Optional[float]:
    """Milliseconds a step of the host spans ``names`` together, over the
    ``phase_steps`` steps that timed them."""
    ms = sum(sum(layer["spans"].host.get(n, ())) for n in names)
    return ms / layer["phase_steps"] if ms > 0 and layer.get("phase_steps") else None


def span_ms(layer: Dict, names: Sequence[str]) -> Optional[float]:
    """Stream milliseconds a batch or step of the program's recorded spans
    ``names`` together (``layer["recorded"]``, from ``recorded``); None
    where none of them was recorded with its events."""
    rec = layer.get("recorded")
    if not rec or not rec["steps"]:
        return None
    ms = [s.stream_ms for s in rec["spans"] if s.name in names and s.stream_ms is not None]
    return sum(ms) / rec["steps"] if ms else None


def launches_inside(layer: Dict, names: Sequence[str]) -> Optional[float]:
    """Device items launched inside the host ranges ``names`` (each item
    under the innermost named range open at its launch) a batch or step of
    the profiled stretch (``layer["profiled_steps"]``); None where none."""
    d, steps = layer.get("digest"), layer.get("profiled_steps")
    n = sum(len(d["inside"].get(name, ())) for name in names) if d else 0
    return n / steps if n and steps else None


def idle_percent(layer: Dict) -> Optional[float]:
    """The card's idle share at the untraced rate, in %: the device's busy
    seconds an audio-second in the traced stretch (the union of its items'
    intervals, which the profiler does not stretch) times the audio-seconds
    a second of the untraced stretch (which it would)."""
    audio = layer.get("traced_audio_s")
    if not audio or not layer.get("audio_s_per_s"):
        return None
    return 100.0 * (1 - layer["digest"]["busy_us"] / 1e6 / audio * layer["audio_s_per_s"])


def kernel_us(d: Dict, *needles: str) -> float:
    """Device microseconds of the items whose name holds one of ``needles``."""
    return sum(us for name, us in d["items"] if any(n in name for n in needles))


def breakdown(d: Optional[Dict], top: int = 10) -> Optional[Dict]:
    if not d:
        return None
    ops = sorted(d["by_op"].items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(d["idle_by_range"].items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n[:120], us / 1e6] for n, us in ops],
            "idle_gaps": [[n, us / 1e6] for n, us in gaps]}
