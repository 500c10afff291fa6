"""Serving cells: the anonymizer over a corpus, as ``anonymize`` runs it.

Set-up makes the weights and the corpus from the seed and warms every
padded shape the corpus has. The weights are drawn on the card; the
plain reference then sets the extractor's batch-norm statistics and VQ
codebook from one pass over voiced utterances made from the seed
(``weights.calibrate``), so that the codes, and with them the waveform,
follow the input. The window is a closed loop over the corpus,
pass after pass, in the serving CLI's order (sorted by length, batches of
the mix's size padded to its bucket ladder): each batch is copied to the
card from pageable host memory, runs ``get_f0`` then ``convert``, and its
unpadded rows are copied back to pinned host memory while the next batch
is enqueued (one batch in flight). No wav is written.

After the window a sample of the corpus drawn from the seed, with its
longest utterance, is anonymized again by the plain reference, batch by
batch from the same padded rows, weights and targets, in bfloat16 under
the serving policy as the configuration states and in float32; each
served waveform is compared with the first over its own length, in units
of the gap between the two; how many VQ codes none of the sample's frames
takes is read from the first too.

A traced run (``--trace 1``) measures the window with CUDA events around
each call and no profiler, then serves one more pass over the corpus with
the program's span recorder on, then profiles one more.
"""
from __future__ import annotations

import time
from typing import Dict, List

import numpy as np

from portbench import counts, gen, harness, trace, weights
from portbench.reference import anonymizer as ref_anonymizer
from portbench.reference import precision
from portbench.reference import yaapt as ref_yaapt

# the CPU size of the harness's own tests (``tests/tiny.py``)
TINY_ASRBN = {"output_dim": 16, "hidden_dim": 32, "bottleneck_dim": 16,
              "prefinal_bottleneck_dim": 16}
TINY_GENERATOR = {"upsample_initial_channel": 32}


def tiny(cfg: Dict, mix: Dict):
    """``cfg`` and ``mix`` cut to CPU size in place (every width and count),
    returned."""
    cfg["build"]["asrbn"].update(TINY_ASRBN)
    cfg["build"].update(num_speakers=3, bn_dim=16, **TINY_GENERATOR)
    cfg["generator"].update(TINY_GENERATOR)
    mix.update(utterances=6, batch=2, targets=3, check_utterances=3)
    mix["lengths"].update(mean_s=1.0, min_s=0.6, max_s=1.8)
    return cfg, mix


def build_program(torch, cfg: Dict, seed: int, device):
    """The port's anonymizer as the serving CLI builds it, on ``device``,
    and the benchmark's weights for it: drawn from the seed, with the
    extractor's batch-norm statistics and codebook calibrated by the plain
    reference (``calibration_batch``)."""
    from satpu_torch import infer_helper

    torch.manual_seed(seed)
    with torch.device(device):
        model = infer_helper.build_model(cfg["model_id"], device=device, seed=None,
                                         **cfg["build"])
    w = weights.draw(torch, model, seed, device)
    # the generator's biases at zero: drawn about zero with the spread of
    # the port's initialisation, they outweigh the signal that five
    # upsampling stages of random weights let through, and the waveform
    # depends on nothing of its input (its rows differ by 0.7%; 13% at zero)
    w.update({k: torch.zeros_like(v) for k, v in w.items()
              if k.startswith("hifigan.") and k.endswith("bias")})
    ref = build_reference(torch, cfg, w, device)
    cal = weights.calibrate(torch, ref.bn_extractor, calibration_batch(torch, cfg, seed, device),
                            seed)
    w.update({"bn_extractor." + k: v for k, v in cal.items()})
    del ref
    model.load_state_dict(w)
    return model.eval(), w


def calibration_batch(torch, cfg: Dict, seed: int, device):
    """Voiced utterances that set the extractor's statistics: the
    configuration's ``calibration`` count, seconds and pitch range, with
    pitches from the seed."""
    spec = cfg["calibration"]
    n, length = spec["utterances"], int(spec["seconds"] * gen.SR)
    f0, phase = gen.speakers(np.random.default_rng([seed, 2]), spec, n)
    noise = torch.Generator(device=device).manual_seed(seed + 2)
    return gen.voiced(torch, [length] * n, length, f0, phase, noise, device)


def build_reference(torch, cfg: Dict, w, device, compute_dtype: str = "float32"):
    """The plain reference anonymizer with the same weights, computing in
    ``compute_dtype`` (the serving policy's casts for "bfloat16")."""
    b = dict(cfg["build"])
    asrbn = ref_anonymizer.TDNNFNetConfig(**{k: tuple(v) if isinstance(v, list) else v
                                             for k, v in b.pop("asrbn").items()},)
    b["compute_dtype"] = compute_dtype
    b = {k: tuple(v) if isinstance(v, list) else v for k, v in b.items()}
    with torch.device(device):
        model = ref_anonymizer.AnonymizationNet(ref_anonymizer.AnonymizerConfig(asrbn=asrbn, **b))
    model.load_state_dict(w)
    return model.eval()


class Corpus:
    """The cell's utterances: lengths, padded host batches (in the serving
    CLI's order), targets, and each utterance's place."""

    def __init__(self, torch, mix: Dict, seed: int, device):
        rng = np.random.default_rng(seed)
        n, bs = mix["utterances"], mix["batch"]
        self.lengths = gen.corpus_lengths(mix["lengths"], n)  # ascending
        f0, phase = gen.speakers(rng, mix, n)
        self.targets = rng.integers(0, mix["targets"], n)
        noise = torch.Generator(device=device).manual_seed(seed)
        self.batches: List[Dict] = []
        for i in range(0, n, bs):
            idx = np.arange(i, min(i + bs, n))
            pad = gen.bucket_for(int(self.lengths[idx].max()), mix["buckets"])
            wav = np.zeros((bs, pad), np.float32)  # the batch dim padded, as the CLI does
            wav[:len(idx)] = gen.voiced(torch, self.lengths[idx], pad, f0[idx], phase[idx],
                                        noise, device).cpu().numpy()
            tid = np.zeros(bs, np.int64)
            tid[:len(idx)] = self.targets[idx]
            self.batches.append({"idx": idx, "wav": wav, "tid": tid, "pad": pad,
                                 "audio_s": float(self.lengths[idx].sum()) / gen.SR})

    def where(self) -> Dict[int, tuple]:
        """Utterance -> (batch, row)."""
        return {int(i): (k, r) for k, b in enumerate(self.batches) for r, i in enumerate(b["idx"])}


def run(ctx) -> Dict:
    torch, dev, cfg, mix = ctx.torch, ctx.device, ctx.cell.config, ctx.cell.traffic
    on_card = dev.type == "cuda"
    model, w = build_program(torch, cfg, ctx.seed, dev)
    corpus = Corpus(torch, mix, ctx.seed, dev)
    nb = len(corpus.batches)
    spans = trace.Spans(torch, dev)
    sinks = [torch.empty((len(b["idx"]), b["pad"] + 1), pin_memory=on_card)
             for b in corpus.batches]
    state = {"it": 0, "audio": 0.0, "flops": 0.0, "k1_bound_s": 0.0}
    written = [-1] * nb
    params = ref_yaapt._merged_params(ref_anonymizer.YAAPT_OPTS)
    shapes = {"asrbn": cfg["build"]["asrbn"], "generator": cfg["generator"],
              "num_speakers": cfg["build"]["num_speakers"]}

    def serve(k: int, record: bool, ranges: bool):
        """One batch, as the serving CLI runs it; returns its copy's event.
        ``record``: CUDA events around each call; ``ranges``: a profiler
        range around each."""
        b = corpus.batches[k]
        e0 = spans.event() if record else None
        with spans.range("portbench.copy_in", ranges):
            wav = torch.from_numpy(b["wav"]).to(dev)
            tid = torch.from_numpy(b["tid"]).to(dev)
        e1 = spans.event() if record else None
        with spans.range("portbench.get_f0", ranges):
            f0 = model.get_f0(wav)
        e2 = spans.event() if record else None
        with spans.range("portbench.convert", ranges):
            out = model.convert(wav, f0, tid)
        e3 = spans.event() if record else None
        with spans.range("portbench.copy_out", ranges):
            sinks[k].copy_(out[:len(b["idx"])], non_blocking=on_card)
        if record:
            spans.stream_span("copy_in", e0, e1)
            spans.stream_span("get_f0", e1, e2)
            spans.stream_span("convert", e2, e3)
        return spans.event()

    def loop(t0: float, seconds: float = 0.0, batches: int = 0, record: bool = False,
             ranges: bool = False):
        """Serve batches in corpus order, one in flight, until ``batches``
        are done or ``seconds`` have passed since ``t0``; returns the time
        the last one completed."""
        prev, n = None, 0
        while True:
            k = state["it"] % nb
            b = corpus.batches[k]
            done = serve(k, record, ranges)
            written[k] = state["it"]
            state["audio"] += b["audio_s"]
            state["flops"] += counts.convert_flops(shapes, len(b["wav"]), b["pad"])
            state["k1_bound_s"] += counts.k1_bound_s(len(b["wav"]), b["pad"], params)
            if prev is not None:
                prev.synchronize()  # the previous batch's output has landed
            prev = done
            state["it"] += 1
            n += 1
            if (batches and n >= batches) or (seconds and time.perf_counter() - t0 >= seconds):
                break
        if on_card:
            torch.cuda.synchronize(dev)
        return time.perf_counter()

    with torch.inference_mode():
        for pad in sorted({b["pad"] for b in corpus.batches}):  # every padded shape once
            state["it"] = next(k for k, b in enumerate(corpus.batches) if b["pad"] == pad)
            loop(0.0, batches=1)
        state.update(it=0, audio=0.0, flops=0.0, k1_bound_s=0.0)
        written = [-1] * nb
        if on_card:
            torch.cuda.reset_peak_memory_stats(dev)
        setup_s = time.perf_counter() - ctx.t_start
        t0 = time.perf_counter()
        layer = launches = None
        t1 = loop(t0, seconds=ctx.seconds, record=ctx.trace)
        if ctx.trace:
            # the window untraced, with CUDA events around each call, then
            # one pass over the corpus (every shape once) with the program's
            # recorder on, then one profiled: launch-bound host code runs
            # slower for the rest of the process once the profiler has run
            spans.resolve()
            layer = {"spans": spans, "audio_s_per_s": state["audio"] / (t1 - t0),
                     "mfu": state["flops"] / (t1 - t0) / counts.PEAK_FLOPS[cfg["peak"]]}
            with trace.recorded(torch, dev, nb) as rec:
                loop(t0, batches=nb)
            layer["recorded"], launches = rec.spans, rec.launches
            audio, state["k1_bound_s"] = state["audio"], 0.0
            with trace.profiled(torch, dev, trace.program_prefixes()) as traced:
                loop(t0, batches=nb, ranges=True)
            layer.update(digest=traced.digest, k1_bound_s=state["k1_bound_s"],
                         traced_audio_s=state["audio"] - audio, profiled_steps=nb)
    device = harness.device_info(torch, 1) if on_card else {"platform": dev.type}
    if ctx.trace:
        metrics = harness.read_layers(ctx.cell, layer)
        device["busy_s"] = layer["digest"]["busy_us"] / 1e6
        device["window_s"] = layer["digest"]["window_us"] / 1e6
    else:
        metrics = {"setup_s": harness.metric(setup_s, "s"),
                   "serve_audio_s_per_s": harness.metric(state["audio"] / (t1 - t0), "audio-s/s")}
    del model
    if on_card:
        torch.cuda.empty_cache()
    utts = sample(mix, corpus, ctx.seed)
    codes = []
    want = reference_outputs(torch, cfg, corpus, w, dev, utts, cfg["precision"], codes=codes)
    exact = reference_outputs(torch, cfg, corpus, w, dev, utts)
    where = corpus.where()
    got = [sinks[where[u][0]][where[u][1], :corpus.lengths[u]].double() for u in utts]
    read = readings(got, want, exact)
    read["vq_codes_unused"] = codes_unused(codes, cfg["build"]["asrbn"]["codebook_size"])
    checks = {k: {"value": v, "limit": cfg["limits"][k]} for k, v in read.items()
              if k in cfg["limits"]}
    checks["batches_unserved"] = {"value": float(sum(x < 0 for x in written)), "limit": 0.0}
    served = sum(len(corpus.batches[i % nb]["idx"]) for i in range(state["it"]))
    return {"correct": all(c["value"] <= c["limit"] for c in checks.values()),
            "attempted": served, "failed": 0, "metrics": metrics, "device": device,
            "checks": checks, "breakdown": trace.breakdown(layer and layer["digest"]),
            "extra": {"readings": read, **({"launches": launches} if launches else {})}}


def sample(mix: Dict, corpus: Corpus, seed: int) -> List[int]:
    """The utterances checked: the longest and ``check_utterances - 1``
    others drawn from the seed."""
    n = len(corpus.lengths)
    rng = np.random.default_rng([seed, 1])
    longest = int(np.argmax(corpus.lengths))
    rest = rng.choice([i for i in range(n) if i != longest], mix["check_utterances"] - 1,
                      replace=False)
    return [longest] + sorted(int(i) for i in rest)


def reference_outputs(torch, cfg, corpus: Corpus, w, dev, utts: List[int],
                      compute_dtype: str = "float32", lower=None, cudnn: bool = True,
                      codes=None):
    """The reference's waveform of each of ``utts`` over its own length (on
    the host, float64): each padded batch that holds one of them is run
    whole, as the timed path ran it, with the same weights and targets, in
    ``compute_dtype`` and, with ``lower``, with the values the serving
    policy holds in bfloat16 rounded to that precision instead;
    ``cudnn=False`` takes the convolutions off cuDNN (another order of
    the same sums). A list ``codes`` receives the VQ code of each of the
    utterances' frames."""
    ref = build_reference(torch, cfg, w, dev, compute_dtype)
    where = corpus.where()
    picked = {}
    vq = ref.bn_extractor.tdnnfs[-1].tdnn.bottleneck_func.vq
    hook = vq.register_forward_hook(lambda m, i, o: picked.update(codes=o[3]))
    out = {}
    try:
        with torch.inference_mode(), precision.lower(lower), \
                torch.backends.cudnn.flags(enabled=cudnn):
            for k in sorted({where[u][0] for u in utts}):
                b = corpus.batches[k]
                wav = torch.from_numpy(b["wav"]).to(dev)
                y = ref.convert(wav, ref.get_f0(wav), torch.from_numpy(b["tid"]).to(dev))
                for u in utts:
                    if where[u][0] == k:
                        out[u] = y[where[u][1], :corpus.lengths[u]].double().cpu()
                        if codes is not None:
                            frames = bn_frames(int(corpus.lengths[u]))
                            codes.append(picked["codes"][where[u][1], :frames].cpu())
                del y, wav
    finally:
        hook.remove()
    return [out[u] for u in utts]


def bn_frames(samples: int) -> int:
    """The bottleneck frames that lie inside an utterance of ``samples``:
    10 ms fbank frames, halved by the extractor's subsampling."""
    return (samples // 160) // 2


def codes_unused(codes, size: int) -> float:
    """How many of the codebook's ``size`` codes no frame in ``codes``
    takes: ``size - 1`` when the quantizer ignores its input."""
    return float(size - len({int(c) for x in codes for c in x.ravel()}))


def gap(got, want) -> float:
    """The relative L2 distance ||got - want|| / ||want|| (infinite where
    it is not finite)."""
    g = float((got - want).norm() / want.norm().clamp(min=1e-30))
    return g if np.isfinite(g) else float("inf")


def per_utterance(got, want, exact):
    """Each checked utterance's relative gap of ``got`` from ``want``, and
    the gap that bfloat16 arithmetic itself opens on it (``want`` from
    ``exact``)."""
    return ([gap(g, r) for g, r in zip(got, want)],
            [max(gap(r, x), 1e-30) for r, x in zip(want, exact)])


def readings(got, want, exact) -> Dict[str, float]:
    """The numbers that can be compared, over the checked utterances, of
    served waveforms ``got`` against the reference computed as the
    configuration states (bfloat16 under the serving policy, ``want``) and
    in float32 (``exact``): ``wav_gap``, the worst relative L2 gap from
    ``want``; ``wav_gap_vs_bf16``, the worst ratio of an utterance's gap to
    the gap that bfloat16 arithmetic itself opens on the same utterance
    (``want`` from ``exact``). The ratio reads each seed's random network in
    units of its own sensitivity to rounding, which differs from seed to
    seed."""
    gaps, unit = per_utterance(got, want, exact)
    return {"wav_gap": max(gaps), "wav_gap_vs_bf16": max(a / b for a, b in zip(gaps, unit)),
            "bf16_gap": max(unit)}
