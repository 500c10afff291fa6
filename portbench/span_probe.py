"""Read the program's own spans and launch counters (``satpu_torch.utils.trace``)
in one cell, as a ``--trace 1`` run would read them once the cell's job
records them: the readings a batch or a step, how far the spans cover the
benchmark's own measures, what the recorder costs when on, and where a
profiled stretch's idle time falls among the program's spans.

    python3 portbench/span_probe.py --workload <cell> --seed <n> [--rounds 3] \\
        [--passes 3] [--steps 20] [--profile 1] [--out chiprun_out/probe.json]

It sets the cell up as its job does (the same weights, corpus or training
data from the seed), then measures ``--rounds`` rounds of windows, in turn,
each doing the same work (serving: ``--passes`` whole passes over the corpus
from its first batch; chain: the same ``--steps`` sampler batches), so that
their rates compare pair by pair:

- serving cells: ``off``, the recorder off and CUDA events around each
  ``get_f0`` and ``convert`` (the traced run's window); ``on``, the same
  with the recorder on (a CUDA event pair a span, the batch as the step);
- chain cells: ``off``, no span timed (the traced run's first half);
  ``patched``, the trainer's phases timed by ``trace.timed_ranges`` (the
  traced run's second half as the benchmark times it); ``on``, the
  recorder on with the phases synchronised at their edges and a CUDA event
  pair a span.

With ``--profile 1``, one profiled pass (a corpus pass; the first
``traced_steps`` of the chain's batches) with the recorder off, twice,
digested with the program's span names beside ``portbench.``. It checks
nothing against the reference and prints one JSON object, which ``--out``
also writes. It needs the card and a program with the recorder.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from statistics import fmean  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:0] = [p for p in (ROOT,) if p not in sys.path]

from portbench import gen, harness  # noqa: E402
from portbench import trace as bench_trace  # noqa: E402
from portbench.run import CACHES, Context  # noqa: E402

F0_DP = ("yaapt.dynamic5", "yaapt.dynamic_final")
NUMERATOR = ("chain.num_forward", "chain.xent_posteriors")
DEN = ("chain.den_forward", "chain.den_backward")


def prefixes(trace):
    """The digest's range prefixes: the benchmark's and each of the
    program's span families."""
    return ("portbench.",) + tuple(sorted({n.split(".", 1)[0] + "." for n in trace.NAMES}))


def by_step(spans, names):
    """{step: stream ms of the spans ``names``} over the recorded spans."""
    out = {}
    for s in spans:
        if s.name in names and s.stream_ms is not None:
            out[s.step] = out.get(s.step, 0.0) + s.stream_ms
    return out


def per_step(spans, names, steps):
    """Stream ms a step of the spans ``names``, over ``steps`` steps."""
    return sum(by_step(spans, names).values()) / steps if steps else None


def launches_inside(d, names, n):
    """Device items launched inside the spans ``names`` (innermost), a pass's
    batch or step, over ``n`` of them."""
    return sum(len(d["inside"].get(name, ())) for name in names) / n


def idle_named(d, named_prefixes):
    """Seconds of the digest's idle time under a span whose name starts
    with one of ``named_prefixes``, and in all."""
    gaps = d["idle_by_range"]
    return (sum(us for k, us in gaps.items() if k.startswith(named_prefixes)) / 1e6,
            sum(gaps.values()) / 1e6)


def serve(ctx, trace, args):
    torch, dev, cfg, mix = ctx.torch, ctx.device, ctx.cell.config, ctx.cell.traffic
    job = ctx.cell.job()
    model, _ = job.build_program(torch, cfg, ctx.seed, dev)
    corpus = job.Corpus(torch, mix, ctx.seed, dev)
    nb = len(corpus.batches)
    sinks = [torch.empty((len(b["idx"]), b["pad"] + 1), pin_memory=True) for b in corpus.batches]
    state = {"it": 0}

    def event():
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def one(k, ev, ranges):
        b = corpus.batches[k]
        rng = (lambda name: bench_trace.Spans.range(name, ranges))
        with rng("portbench.copy_in"):
            wav = torch.from_numpy(b["wav"]).to(dev)
            tid = torch.from_numpy(b["tid"]).to(dev)
        e1 = event() if ev is not None else None
        with rng("portbench.get_f0"):
            f0 = model.get_f0(wav)
        e2 = event() if ev is not None else None
        with rng("portbench.convert"):
            out = model.convert(wav, f0, tid)
        e3 = event() if ev is not None else None
        with rng("portbench.copy_out"):
            sinks[k].copy_(out[:len(b["idx"])], non_blocking=True)
        if ev is not None:
            ev.append((e1, e2, e3))
        return event()

    def loop(batches, ev=None, ranges=False, numbered=False):
        """``batches`` batches from the corpus's first."""
        state["it"], prev, n, audio = 0, None, 0, 0.0
        t0 = time.perf_counter()
        while True:
            k = state["it"] % nb
            if numbered:
                trace.step(n)
            done = one(k, ev, ranges)
            audio += corpus.batches[k]["audio_s"]
            if prev is not None:
                prev.synchronize()
            prev = done
            state["it"] += 1
            n += 1
            if n >= batches:
                break
        torch.cuda.synchronize(dev)
        return n, audio / (time.perf_counter() - t0)

    with torch.inference_mode():
        loop(nb)  # every padded shape once
        setup_s = time.perf_counter() - ctx.t_start
        windows = []
        k1 = []
        for _ in range(args.rounds):
            for mode in ("off", "on"):
                ev = []
                c0 = trace.counters().get("k1.launches", 0)
                if mode == "on":
                    with trace.recording(events=True):
                        n, rate = loop(args.passes * nb, ev=ev, numbered=True)
                else:
                    n, rate = loop(args.passes * nb, ev=ev)
                spans = trace.collect()
                trace.step(None)
                k1.append((trace.counters().get("k1.launches", 0) - c0) / n)
                w = {"mode": mode, "batches": n, "serve_audio_s_per_s": rate,
                     "f0_span_ms": fmean(a.elapsed_time(b) for a, b, _ in ev),
                     "convert_span_ms": fmean(b.elapsed_time(c) for _, b, c in ev)}
                if mode == "on":
                    w.update({"f0_dp_ms": per_step(spans, F0_DP, n),
                              "extractor_ms": per_step(spans, ("anon.extractor",), n),
                              "generator_ms": per_step(spans, ("anon.generator",), n),
                              "stages_ms": {name: per_step(spans, (name,), n) for name in
                                            sorted({s.name for s in spans})},
                              "spans_a_batch": len(spans) / n})
                windows.append(w)
        passes = []
        for _ in range(2 if args.profile else 0):
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                with torch.profiler.record_function(bench_trace.WINDOW):
                    loop(nb, ranges=True)
            d = bench_trace.digest(prof.events(), prefixes(trace))
            named, idle = idle_named(d, ("yaapt.", "anon.", "asrbn."))
            passes.append({"f0_dp_launches": launches_inside(d, F0_DP, nb),
                           "idle_s": idle, "idle_named_s": named,
                           "idle_by_range_s": {k: v / 1e6 for k, v in
                                               d["idle_by_range"].items()},
                           "breakdown": bench_trace.breakdown(d, top=16)})
    return {"setup_s": setup_s, "windows": windows, "k1_launches_a_batch": k1,
            "profiled": passes}


def chain(ctx, trace, args):
    import shutil
    import tempfile

    torch, dev, cfg = ctx.torch, ctx.device, ctx.cell.config
    job = ctx.cell.job()
    root = tempfile.mkdtemp(prefix="portbench-probe-")
    try:
        from satpu_torch.chain import trainer as program_trainer

        data = job.ChainData(torch, cfg, ctx.cell.traffic, ctx.seed, dev, root)
        prog = job.Program(ctx, data)
        prog.set_up()
        torch.cuda.synchronize(dev)
        setup_s = time.perf_counter() - ctx.t_start
        feed_it = prog.later()
        fixed = [next(feed_it) for _ in range(args.steps)]

        def loop(idxs, record=False):
            """A step of each of the sampler batches ``idxs``."""
            n, audio = 0, 0.0
            t0 = time.perf_counter()
            for idx in idxs:
                batch, _, samples = prog.feed(idx)
                if record:
                    trace.step(n)
                prog.trainer.step(*batch)
                audio += samples / gen.SR
                n += 1
            torch.cuda.synchronize(dev)
            return n, audio / (time.perf_counter() - t0)

        phases = ["chain." + p for p in program_trainer.PHASES]
        windows = []
        for _ in range(args.rounds):
            for mode in ("off", "patched", "on"):
                c0 = trace.counters()
                spans = []
                if mode == "patched":
                    held = bench_trace.Spans(torch, dev)
                    with bench_trace.timed_ranges(torch, dev, program_trainer, held):
                        n, rate = loop(fixed)
                elif mode == "on":
                    with trace.recording(events=True, sync=phases):
                        n, rate = loop(fixed, record=True)
                    spans = trace.collect()
                    trace.step(None)
                else:
                    n, rate = loop(fixed)
                c1 = trace.counters()
                w = {"mode": mode, "steps": n, "train_audio_s_per_s": rate,
                     "launches_a_step": {k: (c1.get(k, 0) - c0.get(k, 0)) / n
                                         for k in ("k2f.launches", "k2b.launches")}}
                if mode == "patched":
                    w["phases_ms"] = {k: sum(v) / n for k, v in held.host.items()}
                if mode == "on":
                    host = {}
                    for s in spans:
                        if s.name in phases:
                            host[s.name] = host.get(s.name, 0.0) + s.host_ms
                    obj_bwd = by_step(spans, ("chain.objective_backward",))
                    den_bwd = by_step(spans, ("chain.den_backward",))
                    self_bwd = sum(v - den_bwd.get(k, 0.0) for k, v in obj_bwd.items())
                    w.update({"phases_ms": {k: v / n for k, v in host.items()},
                              "numerator_ms": per_step(spans, NUMERATOR, n) + self_bwd / n,
                              "den_ms": per_step(spans, DEN, n),
                              "stream_ms": {name: per_step(spans, (name,), n) for name in
                                            sorted({s.name for s in spans})},
                              "spans_a_step": len(spans) / n})
                windows.append(w)
        passes = []
        for _ in range(2 if args.profile else 0):
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                with torch.profiler.record_function(bench_trace.WINDOW):
                    loop(fixed[:cfg["traced_steps"]])
            d = bench_trace.digest(prof.events(), prefixes(trace))
            named, idle = idle_named(d, ("chain.num_forward", "chain.xent_posteriors",
                                         "chain.den_forward", "chain.den_backward"))
            passes.append({"idle_s": idle, "idle_named_s": named,
                           "idle_by_range_s": {k: v / 1e6 for k, v in
                                               d["idle_by_range"].items()},
                           "breakdown": bench_trace.breakdown(d, top=16)})
        return {"setup_s": setup_s, "windows": windows, "profiled": passes}
    finally:
        shutil.rmtree(root, ignore_errors=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--rounds", type=int, default=3)
    p.add_argument("--passes", type=int, default=3, help="corpus passes a serving window")
    p.add_argument("--steps", type=int, default=20, help="steps a chain window")
    p.add_argument("--profile", type=int, choices=(0, 1), default=1)
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    cell = harness.Cell(harness.benchmark(), args.workload)
    os.environ.update(CACHES)
    import torch

    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        print("span_probe: needs a CUDA card", file=sys.stderr)
        return 2
    try:
        from satpu_torch.utils import trace
    except ImportError as e:
        print(f"span_probe: the program has no recorder: {e}", file=sys.stderr)
        return 2
    ctx = Context(cell, argparse.Namespace(seed=args.seed, seconds=0.0, trace=1),
                  torch, torch.device("cuda", 0))
    ctx.t_start = T_START
    run = serve if cell.config["job"] == "serve" else chain
    out = {"workload": args.workload, "seed": args.seed, "device": torch.cuda.get_device_name(0),
           **run(ctx, trace, args)}
    text = json.dumps(out)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
