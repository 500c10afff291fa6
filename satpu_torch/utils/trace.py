"""The port's one tracing mechanism: named spans and counters.

``span(name)`` marks a stretch of the program's work. It has three states:

- off (the default): one shared no-op context, after a check of two
  module flags; nothing is allocated, recorded or synchronised;
- under a running ``torch.profiler``: a ``record_function`` range of the
  same name, so that the spans share the profiler's clock with the device
  items launched inside them;
- inside ``recording()``: the span is kept in memory with its id, the id
  of the span open around it on the same thread (its parent), the step set
  by ``step(k)``, its thread, host start and end (``perf_counter_ns``) and,
  with ``events``, a CUDA event pair on the current stream. The events are
  read when the caller ``collect()``s the spans, after its own sync. A span
  named in ``recording``'s ``sync`` synchronises the card at its entry and
  its exit, so that its host time holds its device work.

Under ``torch.compiler.is_compiling()`` (``torch.export``, ``torch.compile``)
a span is a no-op in every state. Spans opened on the autograd engine's
threads (``chain.den_backward``) are recorded as any other; a span has a
parent only on its own thread.

``count(name, n)`` adds to a counter that always counts (the kernels'
launches); ``counters()`` reads them.

``NAMES`` lists every span the port opens, by layer.
"""
from __future__ import annotations

import contextlib
import itertools
import threading
import time
from typing import Dict, Iterable, List, NamedTuple, Optional

import torch
from torch.autograd import profiler as _profiler

NAMES = (
    # F0 (ops/yaapt.py)
    "yaapt.batch", "yaapt.bandpass", "yaapt.nlfer", "yaapt.spec_track", "yaapt.shc",
    "yaapt.peaks", "yaapt.dynamic5", "yaapt.time_track", "yaapt.refine", "yaapt.dynamic_final",
    # BN extractor and generator (models/anonymizer.py, models/asrbn.py)
    "anon.extractor", "anon.generator", "asrbn.fbank", "asrbn.cmvn", "asrbn.tdnnf", "asrbn.vq",
    # the wav2vec2 front (models/wav2vec2.py)
    "wav2vec2.front", "wav2vec2.conv", "wav2vec2.pos_conv", "wav2vec2.attention", "wav2vec2.ffn",
    # chain training (chain/trainer.py PHASES, chain/objf.py, chain/den_fb.py)
    "chain.net_forward", "chain.objective_forward", "chain.objective_backward",
    "chain.net_backward", "chain.sync", "chain.ng", "chain.optimizer",
    "chain.num_forward", "chain.xent_posteriors", "chain.den_forward", "chain.den_backward",
    # ASV training (sidekit/trainer.py PHASES)
    "asv.frontend", "asv.forward", "asv.backward", "asv.sync", "asv.optimizer",
    # GAN training (hifigan/trainer.py PHASES)
    "gan.generator", "gan.d_forward", "gan.d_backward", "gan.d_sync", "gan.d_optimizer",
    "gan.g_forward", "gan.g_backward", "gan.g_sync", "gan.g_optimizer",
)


class Span(NamedTuple):
    """One recorded span. Times in milliseconds; ``stream_ms`` is None
    without events."""

    name: str
    id: int
    parent: Optional[int]
    step: Optional[int]
    thread: int
    start_ns: int
    end_ns: int
    host_ms: float
    stream_ms: Optional[float]


_NOOP = contextlib.nullcontext()
_on = False            # inside recording()
_events = False        # record a CUDA event pair a span
_sync: frozenset = frozenset()
_step: Optional[int] = None
_ids = itertools.count(1)
_lock = threading.Lock()
_done: List[tuple] = []  # finished spans, their events not yet read
_local = threading.local()
_counters: Dict[str, int] = {}


def span(name: str):
    """A context marking the block as ``name`` (see the module's doc)."""
    if not _on and not _profiler._is_profiler_enabled:
        return _NOOP
    if torch.compiler.is_compiling():
        return _NOOP
    if not _on:
        return _profiler.record_function(name)
    return _Recorded(name)


class _Recorded:
    __slots__ = ("name", "id", "parent", "step", "range", "t0", "e0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = _stack()
        self.parent = stack[-1] if stack else None
        self.id = next(_ids)
        stack.append(self.id)
        self.step = _step
        self.range = None
        if _profiler._is_profiler_enabled:
            self.range = _profiler.record_function(self.name)
            self.range.__enter__()
        if self.name in _sync:
            torch.cuda.synchronize()
        self.t0 = time.perf_counter_ns()
        self.e0 = _event() if _events else None
        return self

    def __exit__(self, *exc):
        e1 = _event() if _events else None
        if self.name in _sync:
            torch.cuda.synchronize()
        t1 = time.perf_counter_ns()
        if self.range is not None:
            self.range.__exit__(*exc)
        _stack().pop()
        with _lock:
            _done.append((self.name, self.id, self.parent, self.step, threading.get_ident(),
                          self.t0, t1, self.e0, e1))
        return False


def _stack() -> List[int]:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _event():
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


@contextlib.contextmanager
def recording(events: Optional[bool] = None, sync: Iterable[str] = ()):
    """Keep every span opened inside the block (``collect()`` reads them).
    ``events``: a CUDA event pair a span (default: when CUDA is initialised);
    ``sync``: names of spans that synchronise the card at both edges (only
    where CUDA is initialised)."""
    global _on, _events, _sync
    if _on:
        raise RuntimeError("trace.recording() is already on")
    cuda = torch.cuda.is_initialized()
    _events = cuda if events is None else bool(events)
    _sync = frozenset(sync) if cuda else frozenset()
    _on = True
    try:
        yield
    finally:
        _on, _events, _sync = False, False, frozenset()


def step(k: Optional[int]) -> None:
    """Set the step (or batch) number that the spans opened from now carry."""
    global _step
    _step = k


def collect() -> List[Span]:
    """The spans finished since the last collection, in the order they
    closed, with their events read (call after synchronising the card)."""
    with _lock:
        done = _done[:]
        _done.clear()
    return [Span(name, sid, parent, k, thread, t0, t1, (t1 - t0) / 1e6,
                 e0.elapsed_time(e1) if e0 is not None else None)
            for name, sid, parent, k, thread, t0, t1, e0, e1 in done]


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def counters() -> Dict[str, int]:
    """Every counter's value now (a copy)."""
    with _lock:
        return dict(_counters)
