"""Chain (LF-MMI) training cells of the B5 extractor: wav2vec2-large's 24
layers before the TDNN-F, VQ-48 and the chain objective, as ``train_asr``
trains ``tdnnf_wav2vec2_vq`` (``egs/asr/librispeech/configs/
tdnnf_wav2vec2_vq_48.ini``).

What it shares with the fbank net's cells it takes from ``jobs/chain.py``:
the training data on disk (``ChainData``), the program's dataset, sampler
and set-up steps (``Program``), the readings compared and their gaps, the
learning-rate decay and the natural-gradient states. Its own are the
front's update factor, which the program takes from ``train_asr`` and the
reference from the recipe as written here; the front's frames, from the
reference's arithmetic; the step's operations and the attention's bound
(``counts_w2v2``); and the plain reference's net (``reference/wav2vec2.py``).

The weights are the chain job's draw with the VQ's state set as a codebook
in use holds it (``codebook_in_use``), from the first set-up batch.

A run goes as a chain run does (``jobs/chain.py``): set-up takes a step of
every length, the window takes the trainer on, and a traced run then
records and profiles ``traced_steps`` steps each. The layer carries, besides
the chain job's keys, ``attn_bound_s``: the attention's bound over the
profiled steps. The reference follows the first three steps from the same
weights, NG states, batches and schedules, and is compared as there, and
by one number of the front's own (``front_gap``): its features in the
first step.
"""
from __future__ import annotations

import contextlib
import functools
import itertools
import math
import shutil
import tempfile
import time
from typing import Dict, List

import numpy as np

from portbench import counts, counts_w2v2, gen, harness, trace, weights
from portbench.jobs import chain as base
from portbench.reference import asrbn as ref_asrbn
from portbench.reference import fst as ref_fst
from portbench.reference import objf as ref_objf
from portbench.reference import precision
from portbench.reference import trainer as ref_trainer
from portbench.reference import wav2vec2 as ref_w2v2

CHECK_STEPS = base.CHECK_STEPS
ChainData, Readings = base.ChainData, base.Readings
# the CPU size of the harness's own tests: a 2-layer front of width 32 with
# the published kernels and strides at 16 channels
TINY_FRONT = {"conv_dim": [16] * 7, "hidden_size": 32, "num_hidden_layers": 2,
              "num_attention_heads": 4, "intermediate_size": 64,
              "num_conv_pos_embeddings": 16, "num_conv_pos_embedding_groups": 4}


def tiny(cfg: Dict, mix: Dict):
    """``cfg`` and ``mix`` cut to CPU size in place, returned."""
    cfg, mix = base.tiny(cfg, mix)
    cfg["build"]["wav2vec2"].update(TINY_FRONT)
    return cfg, mix


class Schedule:
    """``train_asr``'s learning-rate decay over the recipe's steps
    (``jobs/chain.lr_schedule``) and, by ``front``, the B5 recipe's update
    factor on the wav2vec2 front: 1/20 for the first tenth of the steps,
    1/5 until nine tenths, 0 (frozen) after."""

    def __init__(self, cfg: Dict, steps_per_epoch: int):
        self.total = max(steps_per_epoch, 1) * cfg["train"]["num_epochs"]
        self.lr = base.lr_schedule(cfg, steps_per_epoch)

    def __call__(self, step: int) -> float:
        return self.lr(step)

    def front(self, step: int) -> float:
        frac = step / float(self.total)
        return 1.0 / 20.0 if frac < 0.1 else 1.0 / 5.0 if frac < 0.9 else 0.0


class Program(base.Program):
    """The chain job's program side, with the trainer ``train_asr`` builds
    for a wav2vec2 net: the front's update scaled by ``train_asr``'s own
    ``wav2vec2_update_factor`` over the run's steps."""

    def __init__(self, ctx, data: ChainData):
        from satpu_torch.bin.train_asr import wav2vec2_update_factor
        from satpu_torch.chain.trainer import ChainTrainer, ChainTrainOpts

        super().__init__(ctx, data)
        torch, cfg = ctx.torch, ctx.cell.config
        wav = np.stack([base.read_wav(data.wavs[self.ds.egs[i].utt]) for i in self.first[0]])
        self.w0.update(codebook_in_use(torch, cfg, self.w0, torch.from_numpy(wav).to(ctx.device),
                                       ctx.seed))
        self.model.load_state_dict(self.w0)
        self.lr_at = Schedule(cfg, len(self.sampler))
        self.trainer = ChainTrainer(
            self.model, self.trainer.den, ChainTrainOpts(**base.opts(cfg)),
            lr_schedule=self.lr_at, seed=ctx.seed, ng_states=self.ng0,
            preprocessor_schedule=functools.partial(wav2vec2_update_factor,
                                                    total_steps=self.lr_at.total))

    def set_up(self, steps: int = 0):
        """As the chain job's, and the readings also hold the front's
        features in the first step (``front``)."""
        with first_front(self.model) as front:
            mine, checked = super().set_up(steps)
        mine.front = front[0]
        return mine, checked


@contextlib.contextmanager
def first_front(model):
    """Yields a list that holds, once the block has run ``model``, the
    output of its front (``model.preprocessor``) in its first forward, in
    float32."""
    out = []

    def keep(mod, inp, feats):
        if not out:
            out.append(feats.detach().float())

    hook = model.preprocessor.register_forward_hook(keep)
    try:
        yield out
    finally:
        hook.remove()


def gaps(got: Readings, want: Readings) -> Dict[str, float]:
    """The chain job's gaps (``jobs/chain.gaps``) and ``front_gap``: the
    front's features in the first step, ``got``'s less ``want``'s, in norm
    over ``want``'s norm, on the rows both took (a half-batch fault takes
    the first half). The whole net's gaps mix the front's rounding with the
    rest's; this one reads the front alone."""
    out = base.gaps(got, want)
    rows = min(len(got.front), len(want.front))
    a, b = got.front[:rows].double(), want.front[:rows].double()
    gap = float((a - b).norm() / b.norm().clamp(min=1e-30))
    out["front_gap"] = gap if math.isfinite(gap) else math.inf
    return out


def reference_net(torch, cfg: Dict, device):
    """The plain reference's net of the configuration, on ``device``."""
    build = dict(cfg["build"])
    w2v2 = build.pop("wav2vec2")
    net = {k: tuple(v) if isinstance(v, list) else v for k, v in build.items()}
    with torch.device(device):
        return ref_w2v2.Wav2Vec2TDNNFNet(ref_asrbn.TDNNFNetConfig(**net), w2v2)


def codebook_in_use(torch, cfg: Dict, w0, wav, seed: int) -> Dict:
    """The VQ's state as a codebook in use holds it, in place of the drawn
    one: the codebook the centroids (``weights.kmeans``, seeded) of the VQ's
    input frames on ``wav`` as a training forward of the plain reference
    gives them (batch statistics, weights ``w0``), the EMA's cluster sizes
    each centroid's count of those frames, and its sums the centroids times
    the counts. A drawn codebook lies far from every input, so every frame
    takes one code, and the EMA's first update moves that code onto the
    frames' mean: the VQ's output is then the same for every frame, the
    batch norms after it divide rounding by their epsilon, and the
    gradients differ by up to a quarter between two sound computations."""
    ref = reference_net(torch, cfg, wav.device)
    ref.load_state_dict(w0)
    name = next(n for n, m in ref.named_modules() if type(m).__name__ == "VectorQuantizerEMA")
    vq = ref.get_submodule(name)
    seen = []
    hook = vq.register_forward_pre_hook(
        lambda mod, inp: seen.append(inp[0].transpose(1, 2).reshape(-1, inp[0].shape[1])))
    try:
        with torch.no_grad(), precision.lower(None):
            ref.train()
            ref.tdnnfs[-1](ref._stage1(wav, None), return_bottleneck=True)
    finally:
        hook.remove()
    x = seen[0].float()
    gen = torch.Generator(device=x.device).manual_seed(seed)
    centers = weights.kmeans(torch, x, vq.num_embeddings, gen)
    dist = (x ** 2).sum(1, keepdim=True) - 2 * x @ centers.T + (centers ** 2).sum(1)
    counts = torch.bincount(dist.argmin(1), minlength=vq.num_embeddings).to(x.dtype)
    del ref
    return {f"{name}.embedding": centers, f"{name}.ema_cluster_size": counts,
            f"{name}.ema_w": centers * counts[:, None]}


def reference_steps(torch, cfg: Dict, data: ChainData, batches: List[List[str]], w0, ng0,
                    seed: int, lr_at: Schedule, device, lower=None,
                    half: bool = False) -> Readings:
    """The plain reference's first steps on ``batches`` (utterance ids), from
    the files, the weights ``w0`` and the NG states ``ng0``. ``lower``:
    "tf32" runs its matmuls and convs in TF32, "bfloat16" its front under
    the bf16 training policy; ``half`` leaves each batch's second half out
    (a fault)."""
    model = reference_net(torch, cfg, device)
    model.load_state_dict(w0)
    model.front_dtype = torch.bfloat16 if lower == "bfloat16" else None
    tr = ref_w2v2.FrontChainTrainer(model, data.den, ref_trainer.ChainTrainOpts(**base.opts(cfg)),
                                    lr_schedule=lr_at, seed=seed, ng_states=ng0,
                                    front_factor=lr_at.front)
    names = [n for n, _ in model.named_parameters()]
    params = [p for _, p in model.named_parameters()]
    out = Readings(names)
    with precision.lower(None if lower == "bfloat16" else lower), first_front(model) as front:
        for utts in batches:
            if half:
                utts = utts[:len(utts) // 2]
            wav = np.stack([base.read_wav(data.wavs[u]) for u in utts])
            graphs = [data.graph(u) for u in utts]
            # the numerator's frames as the egs count them; the den takes every network frame
            frames = np.array([base.output_frames(len(x)) for x in wav], np.int32)
            m = tr.step(torch.from_numpy(wav).to(device),
                        ref_objf.graphs_to_torch(ref_fst.pad_graph_arrays(graphs), device),
                        torch.from_numpy(frames).to(device))
            out.after_step(torch, tr, params, w0, float(m["loss"]))
    out.front = front[0]
    del tr, model
    return out


def run(ctx) -> Dict:
    root = tempfile.mkdtemp(prefix="portbench-chain-w2v2-")
    try:
        return drive(ctx, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def drive(ctx, root) -> Dict:
    # the recipe's schedule of the front is the port's own function: a port
    # without it cannot run this cell, and stops before any set-up
    from satpu_torch.bin.train_asr import wav2vec2_update_factor  # noqa: F401

    torch, dev, cfg = ctx.torch, ctx.device, ctx.cell.config
    net, w2v2 = cfg["build"], cfg["build"]["wav2vec2"]
    on_card = dev.type == "cuda"
    flags = {"matmul_tf32": torch.backends.cuda.matmul.allow_tf32,
             "cudnn_tf32": torch.backends.cudnn.allow_tf32}
    data = ChainData(torch, cfg, ctx.cell.traffic, ctx.seed, dev, root)
    prog = Program(ctx, data)
    mine, checked = prog.set_up()
    if on_card:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    spans, trainer, ds = prog.spans, prog.trainer, prog.ds
    spans.host.clear()
    setup_s = time.perf_counter() - ctx.t_start

    feed_it = prog.later()
    state = {"steps": 0, "audio": 0.0, "flops": 0.0, "lengths": []}
    losses = []

    def loop(t0: float, seconds: float = 0.0, steps: int = 0) -> float:
        n = 0
        while True:
            idx = next(feed_it)
            batch, _, samples = prog.feed(idx)
            m = trainer.step(*batch)
            losses.append(m["loss"])
            state["audio"] += samples / gen.SR
            lens = [ds.egs[i].num_samples for i in idx]
            state["flops"] += counts_w2v2.train_step_flops(net, lens)
            state["lengths"].append(lens)
            state["steps"] += 1
            n += 1
            if (steps and n >= steps) or (seconds and time.perf_counter() - t0 >= seconds):
                break
        if on_card:
            torch.cuda.synchronize(dev)
        return time.perf_counter()

    t0 = time.perf_counter()
    layer = launches = None
    if ctx.trace:
        from satpu_torch.chain import trainer as program_trainer

        t_half = loop(t0, seconds=ctx.seconds / 2)
        layer = {"audio_s_per_s": state["audio"] / (t_half - t0),
                 "mfu": state["flops"] / (t_half - t0) / counts.PEAK_FLOPS[cfg["peak"]]}
        spans.host.clear()
        s_half = state["steps"]
        with trace.timed_ranges(torch, dev, program_trainer, spans):
            t1 = loop(t_half, seconds=ctx.seconds / 2)
        layer.update(spans=spans.snapshot(), phase_steps=state["steps"] - s_half)
        with trace.recorded(torch, dev, cfg["traced_steps"]) as rec:
            loop(t1, steps=cfg["traced_steps"])
        layer["recorded"], launches = rec.spans, rec.launches
        audio = state["audio"]
        ahead = list(itertools.islice(feed_it, cfg["traced_steps"]))
        feed_it = itertools.chain(ahead, feed_it)
        with trace.profiled(torch, dev, trace.program_prefixes()) as traced:
            loop(t1, steps=cfg["traced_steps"])
        shapes = [(len(idx), max(ds.egs[i].num_samples for i in idx)) for idx in ahead]
        layer.update(
            digest=traced.digest, traced_audio_s=state["audio"] - audio,
            profiled_steps=cfg["traced_steps"],
            den_bound_s=sum(sum(counts.k2_bound_s(b, ref_w2v2.chain_frames(n, net, w2v2),
                                                  data.den.num_states, data.den_nnz))
                            for b, n in shapes),
            num_bound_s=sum(sum(counts.k3_bound_s(
                base.output_frames(n), [data.graph_size(ds.egs[i].utt) for i in idx]))
                for idx, (_, n) in zip(ahead, shapes)),
            attn_bound_s=sum(counts_w2v2.attention_bound_s(w2v2, b, n) for b, n in shapes))
    else:
        t1 = loop(t0, seconds=ctx.seconds)
    bad = sum(not math.isfinite(float(v)) for v in losses)
    device = harness.device_info(torch, 1) if on_card else {"platform": dev.type}
    if ctx.trace:
        metrics = harness.read_layers(ctx.cell, layer)
        device["busy_s"] = layer["digest"]["busy_us"] / 1e6
        device["window_s"] = layer["digest"]["window_us"] / 1e6
    else:
        metrics = {"setup_s": harness.metric(setup_s, "s"),
                   "train_audio_s_per_s": harness.metric(state["audio"] / (t1 - t0),
                                                         "audio-s/s")}
    dropped, w0, ng0, lr_at = prog.dropped, prog.w0, prog.ng0, prog.lr_at
    del trainer, ds, prog
    if on_card:
        torch.cuda.empty_cache()
    want = reference_steps(torch, cfg, data, checked, w0, ng0, ctx.seed, lr_at, dev)
    limits, read = cfg["limits"], gaps(mine, want)
    checks = {k: {"value": v, "limit": limits[k]} for k, v in read.items() if k in limits}
    checks["losses_not_finite"] = {"value": float(bad), "limit": 0.0}
    checks["utterances_dropped"] = {"value": float(dropped), "limit": 0.0}
    return {"correct": all(c["value"] <= c["limit"] for c in checks.values()),
            "attempted": state["steps"], "failed": bad, "metrics": metrics, "device": device,
            "checks": checks, "breakdown": trace.breakdown(layer and layer["digest"]),
            "extra": {"tf32": flags, "readings": read,
                      **({"launches": launches} if launches else {})}}
