"""The port's recorder (``satpu_torch.utils.trace``) on the CPU: off, a span
is one shared no-op that records nothing and opens no profiler range;
recording, nested spans carry their parent's id and the step number, spans
of other threads are collected, and only the spans named for it synchronise
the card at their edges; under ``torch.profiler`` every span of F0,
``convert`` and the chain objective appears as a range of its name in one
tiny anonymizer batch and one tiny chain step; the launch counters count;
``torch.export`` of F0 + ``convert`` holds no profiler op and matches eager;
every span the package opens is in ``NAMES``."""
import os
import re
import sys
import threading

import numpy as np
import pytest
import torch

from satpu_torch.utils import trace
from torch_parity import ANON_TINY, ASRBN_TINY, yaapt_batch_signals

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
P = 40  # pdfs of random_bigram_den(5, 3)

F0_SPANS = ("yaapt.batch", "yaapt.bandpass", "yaapt.nlfer", "yaapt.spec_track", "yaapt.shc",
            "yaapt.peaks", "yaapt.dynamic5", "yaapt.time_track", "yaapt.refine",
            "yaapt.dynamic_final")
CONVERT_SPANS = ("anon.extractor", "asrbn.fbank", "asrbn.cmvn", "asrbn.tdnnf", "asrbn.vq",
                 "anon.generator")
CHAIN_SPANS = ("chain.net_forward", "chain.objective_forward", "chain.objective_backward",
               "chain.net_backward", "chain.ng", "chain.optimizer", "chain.num_forward",
               "chain.xent_posteriors", "chain.den_forward", "chain.den_backward",
               "asrbn.fbank", "asrbn.cmvn", "asrbn.tdnnf", "asrbn.vq")


@pytest.fixture(autouse=True)
def fresh():
    """Each test starts with no spans pending and none left behind."""
    trace.collect()
    trace.step(None)
    yield
    trace.collect()
    trace.step(None)


def _anonymizer():
    from satpu_torch import infer_helper

    return infer_helper.build_model("anonymizer_tdnnf_hifigan", device="cpu", seed=0,
                                    asrbn=ASRBN_TINY, **ANON_TINY).eval()


def _serve_batch(net):
    wav = torch.from_numpy(yaapt_batch_signals()[:2])
    with torch.no_grad():
        return net.convert(wav, net.get_f0(wav), torch.tensor([0, 2]))


def _chain_step():
    """One step of a tiny ChainTrainer (NG on, dropout off) over a 5-phone
    den graph; returns its metrics."""
    from satpu_torch import infer_helper
    from satpu_torch.chain.fst import fst_rmepsilon, fst_to_arrays, pad_graph_arrays
    from satpu_torch.chain.objf import DenominatorGraph, graphs_to_torch
    from satpu_torch.chain.prep import numerator_fst, random_bigram_den, random_phone_walk
    from satpu_torch.chain.trainer import ChainTrainer

    fst, tree, trans = random_bigram_den(5, 3, seed=2)
    rng = np.random.default_rng(7)
    n, b = 16000, 2
    frames = np.full(b, ((n + 80) // 160 - 2) // 3, np.int32)
    graphs = pad_graph_arrays([fst_to_arrays(fst_rmepsilon(numerator_fst(
        random_phone_walk(trans, 9, rng), tree))) for _ in range(b)])
    torch.manual_seed(0)
    net = infer_helper.build_model("asrbn_tdnnf", device="cpu", seed=0,
                                   **dict(ASRBN_TINY, output_dim=P, p_dropout=0.0,
                                          natural_gradient=True))
    trainer = ChainTrainer(net, DenominatorGraph.from_fst(fst, P))
    wav = torch.from_numpy((rng.standard_normal((b, n)) * 0.1).astype(np.float32))
    return trainer.step(wav, graphs_to_torch(graphs, "cpu"), torch.from_numpy(frames))


def test_span_off_is_one_shared_noop(monkeypatch):
    """Off, with no profiler: the same object for every name, no record, no
    profiler range."""
    def refuse(name):
        raise AssertionError(f"a profiler range was opened for {name}")

    monkeypatch.setattr(trace._profiler, "record_function", refuse)
    first = trace.span("yaapt.batch")
    assert first is trace.span("chain.den_backward") is trace._NOOP
    with trace.span("yaapt.batch"):
        with trace.span("yaapt.nlfer"):
            pass
    assert trace.collect() == []


def test_nested_spans_carry_parent_and_step():
    with trace.recording(events=False):
        trace.step(3)
        with trace.span("anon.extractor"):
            with trace.span("asrbn.fbank"):
                pass
            with trace.span("asrbn.cmvn"):
                pass
        trace.step(4)
        with trace.span("anon.generator"):
            pass
    with trace.span("anon.generator"):  # after the block: off again
        pass
    spans = {s.name: s for s in trace.collect()}
    assert list(spans) == ["asrbn.fbank", "asrbn.cmvn", "anon.extractor", "anon.generator"]
    outer = spans["anon.extractor"]
    assert outer.parent is None and spans["anon.generator"].parent is None
    assert spans["asrbn.fbank"].parent == spans["asrbn.cmvn"].parent == outer.id
    assert [s.step for s in spans.values()] == [3, 3, 3, 4]
    assert outer.start_ns <= spans["asrbn.fbank"].start_ns <= spans["asrbn.cmvn"].end_ns \
        <= outer.end_ns
    assert all(s.host_ms >= 0 and s.stream_ms is None for s in spans.values())
    assert trace.collect() == []


@pytest.mark.parametrize("where", ["thread", "chain_step"])
def test_spans_of_every_thread_are_collected(where):
    """A span opened on another thread is collected with that thread and no
    parent; in a CPU chain step the den backward (which the autograd engine
    runs on the calling thread for CPU work) sits under the objective's
    backward, and every phase is recorded once."""
    with trace.recording(events=False):
        trace.step(7)
        if where == "thread":
            with trace.span("chain.objective_backward"):
                worker = threading.Thread(target=lambda: trace.span("chain.den_backward")
                                          .__enter__().__exit__(None, None, None))
                worker.start()
                worker.join(timeout=60)
            assert not worker.is_alive()
        else:
            _chain_step()
    spans = trace.collect()
    by_name = {}
    for s in spans:
        by_name.setdefault(s.name, []).append(s)
    assert all(s.step == 7 for s in spans)
    den, = by_name["chain.den_backward"]
    outer, = by_name["chain.objective_backward"]
    if where == "thread":
        assert den.thread == worker.ident != outer.thread and den.parent is None
    else:
        assert den.parent == outer.id
        for name in ("chain.net_forward", "chain.objective_forward", "chain.net_backward",
                     "chain.ng", "chain.optimizer", "chain.num_forward",
                     "chain.xent_posteriors", "chain.den_forward"):
            assert len(by_name[name]) == 1, name
        fwd, = by_name["chain.objective_forward"]
        assert {by_name[n][0].parent for n in ("chain.num_forward", "chain.den_forward",
                                                "chain.xent_posteriors")} == {fwd.id}


@pytest.mark.parametrize("path", ["anonymizer", "chain_step"])
def test_every_span_is_a_profiler_range(path):
    from torch.profiler import ProfilerActivity, profile

    net = _anonymizer() if path == "anonymizer" else None
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        if net is not None:
            _serve_batch(net)
        else:
            _chain_step()
    names = {e.name for e in prof.events()}
    want = F0_SPANS + CONVERT_SPANS if path == "anonymizer" else CHAIN_SPANS
    assert set(want) <= names, sorted(set(want) - names)
    assert trace.collect() == []  # the profiler alone records nothing


def test_sync_at_edges_only_for_the_named_spans(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: calls.append(
        (trace._stack()[-1] if trace._stack() else None)))
    with trace.recording(events=False, sync=("chain.objective_forward",)):
        with trace.span("chain.net_forward"):
            pass
        with trace.span("chain.objective_forward"):
            with trace.span("chain.num_forward"):
                pass
    net, num, obj = trace.collect()
    # one sync at the entry and one at the exit of the named span, none for
    # the others (the spans open at each sync: the named one alone)
    assert calls == [obj.id, obj.id]
    assert (net.name, num.name, obj.name) == ("chain.net_forward", "chain.num_forward",
                                              "chain.objective_forward")


@pytest.mark.parametrize("threads", [1, 16])
def test_counters_count(threads):
    """Counters always count, from any thread (more threads than cores, the
    interpreter switching often), and read back as a copy."""
    before = trace.counters().get("test.launches", 0)

    def add():
        for _ in range(2000):
            trace.count("test.launches")

    workers = [threading.Thread(target=add) for _ in range(threads)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(w.is_alive() for w in workers)
    trace.count("test.launches", 5)
    got = trace.counters()
    assert got["test.launches"] - before == 2000 * threads + 5
    got["test.launches"] = -1
    assert trace.counters()["test.launches"] != -1


def test_export_holds_no_profiler_op_and_matches_eager():
    """F0 + convert exported while the profiler runs and the recorder is on:
    no profiler op in the graph, no span recorded, the program equals eager."""
    from torch.profiler import ProfilerActivity, profile

    from satpu_torch import hub

    net = _anonymizer()
    wav = torch.from_numpy(yaapt_batch_signals()[:2])
    tid = torch.tensor([0, 2])
    with profile(activities=[ProfilerActivity.CPU]), trace.recording(events=False):
        program = torch.export.export(hub._Fn(net, hub._convert), (wav, tid), strict=False)
    assert trace.collect() == []
    ops = {str(n.target) for _, m in program.graph_module.named_modules()
           if hasattr(m, "graph") for n in m.graph.nodes if n.op == "call_function"}
    assert "satpu_torch.shc_band.default" in ops
    assert not [op for op in ops if "profiler" in op or "record_function" in op], ops
    with torch.no_grad():
        out = program.module()(wav, tid)
        eager = _serve_batch(net)
    assert float((out - eager).abs().max()) <= 1e-6


def test_every_span_opened_is_in_names():
    """The spans the package opens (literal names, and the trainers'
    ``PHASES``) are the recorder's ``NAMES``, and no module but the
    recorder reaches ``record_function`` itself."""
    from satpu_torch.chain.trainer import PHASES as CHAIN
    from satpu_torch.hifigan.trainer import PHASES as GAN
    from satpu_torch.sidekit.trainer import PHASES as ASV

    opened = set()
    for d, _, files in os.walk(os.path.join(ROOT, "satpu_torch")):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(d, f)
            text = open(path).read()
            opened |= set(re.findall(r"(?:span|record_function)\(\"([^\"]+)\"", text))
            if not path.endswith(os.path.join("utils", "trace.py")):
                assert "torch.profiler" not in text and "autograd.profiler" not in text, path
    phases = {f"{p}.{x}" for p, names in (("chain", CHAIN), ("gan", GAN), ("asv", ASV))
              for x in names}
    assert opened | phases == set(trace.NAMES)
    assert len(trace.NAMES) == len(set(trace.NAMES))
