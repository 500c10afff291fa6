"""Chain (LF-MMI) training cells: the TDNN-F extractor's recipe step, as
``train_asr`` runs it.

Set-up writes the cell's training data into a fresh directory under the
temporary directory: voiced utterances at the recipe's allowed lengths
(wav files), one numerator graph each (a random walk of the den graph's
phone bigram, a third of the output frames long; an fst ark) and the den
graph. The port reads them back as ``train_asr`` does (``EgsDataset``,
``DenominatorGraph.from_fst``), builds one ``ChainTrainer`` with the
benchmark's weights and natural-gradient states, and drives it through one
step of every length (the first steps of epoch 0, which warm every shape);
the window then takes the trainer on, batch after batch of
``BucketBatchSampler``, epoch after epoch.

A traced run (``--trace 1``) measures half the window as an untraced run
does, half with the trainer's ranges timed on the host clock
(``trace.timed_ranges``), then takes ``traced_steps`` more steps with the
program's span recorder on, then profiles ``traced_steps`` more (the
profiler slows launch-bound host code for the rest of the process).

The plain reference follows the first three steps from the same weights,
states, dropout seed and batches, which it reads from the same files
itself. Compared: each step's loss, each parameter's gradient as the
optimizer received it in step 1 (from AdamW's first moment), and each
parameter's change after three steps, by the norm of each parameter.
"""
from __future__ import annotations

import itertools
import math
import os
import shutil
import tempfile
import time
import wave
from typing import Dict, List

import numpy as np

from portbench import counts, gen, harness, trace, weights
from portbench.reference import asrbn as ref_asrbn
from portbench.reference import fst as ref_fst
from portbench.reference import ngsgd as ref_ngsgd
from portbench.reference import objf as ref_objf
from portbench.reference import precision
from portbench.reference import prep as ref_prep
from portbench.reference import trainer as ref_trainer

CHECK_STEPS = 3
# the CPU size of the harness's own tests (``tests/tiny.py``)
TINY_NET = {"output_dim": 16, "hidden_dim": 32, "bottleneck_dim": 16,
            "prefinal_bottleneck_dim": 16}


def tiny(cfg: Dict, mix: Dict):
    """``cfg`` and ``mix`` cut to CPU size in place (every width and count,
    the den graph), returned."""
    cfg["build"].update(TINY_NET, output_dim=40, codebook_size=8)
    cfg["den_graph"] = {"phones": 5, "successors": 3, "seed": 2}
    cfg["traced_steps"] = 1
    mix.update(utterances=8, batch=2, allowed_lengths=2)
    mix["lengths"].update(mean_s=1.2, min_s=0.8, max_s=1.6)
    return cfg, mix


def write_wav(path: str, x: np.ndarray) -> None:
    """16-bit PCM mono at 16 kHz."""
    pcm = np.clip(np.round(x * 32768.0), -32768, 32767).astype("<i2")
    with wave.open(path, "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(gen.SR)
        f.writeframes(pcm.tobytes())


def read_wav(path: str) -> np.ndarray:
    with wave.open(path, "rb") as f:
        return np.frombuffer(f.readframes(f.getnframes()), "<i2").astype(np.float32) / 32768.0


def output_frames(num_samples: int) -> int:
    """The network's output frames: 10 ms fbank frames, then 3x subsampling."""
    return max(((num_samples + 80) // 160 - 2) // 3, 0)


class ChainData:
    """The cell's training set on disk, made from the seed."""

    def __init__(self, torch, cfg: Dict, mix: Dict, seed: int, device, root: str):
        self.root = root
        den_spec = cfg["den_graph"]
        den, tree, trans = ref_prep.random_bigram_den(den_spec["phones"], den_spec["successors"],
                                                      den_spec["seed"])
        if tree.num_pdfs != cfg["build"]["output_dim"]:
            raise ValueError(f"den graph of {tree.num_pdfs} pdfs for a network of "
                             f"{cfg['build']['output_dim']} outputs")
        self.den_fst = os.path.join(root, "den.fst")
        den.write(self.den_fst)
        # the den graph's size, as the reference works it out
        self.den = ref_objf.DenominatorGraph.from_fst(den, tree.num_pdfs)
        self.den_nnz = int(np.count_nonzero(self.den.factored.A_fwd))
        raw = gen.corpus_lengths(mix["lengths"], mix["utterances"])
        self.allowed = ref_prep.allowed_sample_lengths(raw, mix["allowed_lengths"],
                                                       mix["coverage"])
        lengths = gen.whole_batches(gen.snap_lengths(raw, self.allowed), mix["batch"])
        rng = np.random.default_rng(seed)
        order = rng.permutation(len(lengths))  # utterance ids in no length order
        self.lengths = lengths[order]
        f0, phase = gen.speakers(rng, mix, len(lengths))
        noise = torch.Generator(device=device).manual_seed(seed)
        data = os.path.join(root, "data")
        os.makedirs(data)
        self.utts = [f"utt{i:05d}" for i in range(len(lengths))]
        self.wavs = {u: os.path.join(data, u + ".wav") for u in self.utts}
        for n in np.unique(self.lengths):
            ids = np.flatnonzero(self.lengths == n)
            x = gen.voiced(torch, [int(n)] * len(ids), int(n), f0[ids], phase[ids], noise,
                           device).cpu().numpy()
            for i, row in zip(ids, x):
                write_wav(self.wavs[self.utts[i]], row)
        nums = {}
        for u, n in zip(self.utts, self.lengths):
            walk = gen.random_phone_walk(trans, max(output_frames(int(n)) // 3, 1), rng)
            nums[u] = ref_prep.numerator_fst(walk, tree)
        self.fst_scp = os.path.join(root, "fst.scp")
        ref_prep.write_fst_ark(nums, os.path.join(root, "fsts.ark"), self.fst_scp)
        self.wav_scp = os.path.join(data, "wav.scp")
        self.utt2len = os.path.join(data, "utt2len")
        with open(self.wav_scp, "w") as f:
            f.writelines(f"{u} {self.wavs[u]}\n" for u in self.utts)
        with open(self.utt2len, "w") as f:
            f.writelines(f"{u} {int(n)}\n" for u, n in zip(self.utts, self.lengths))
        with open(self.fst_scp) as f:
            self.fst_rx = dict(line.split(None, 1) for line in f.read().splitlines())

    def graph(self, utt: str):
        """The utterance's numerator graph as the reference reads it back
        from the ark: epsilon-free arrays (``GraphArrays``)."""
        path, off = self.fst_rx[utt].rsplit(":", 1)
        with open(path, "rb") as f:
            f.seek(int(off))
            return ref_fst.fst_to_arrays(ref_fst.fst_rmepsilon(ref_fst.read_fst_kaldi(f)))

    def graph_size(self, utt: str):
        """(states, live arcs, pdfs on live arcs) of the utterance's
        numerator graph."""
        g = self.graph(utt)
        live = g.arc_logprob > ref_fst.NEG_INF / 2
        return g.num_states, int(np.count_nonzero(live)), len(np.unique(g.arc_pdf[live]))


def lr_schedule(cfg: Dict, steps_per_epoch: int):
    """train_asr's exponential decay from lr_initial to lr_final over the
    recipe's epochs."""
    total = max(steps_per_epoch, 1) * cfg["train"]["num_epochs"]
    lo, hi = cfg["train"]["lr_final"], cfg["train"]["lr_initial"]

    def lr_at(step: int) -> float:
        return hi * math.exp(min(step / float(total), 1.0) * math.log(lo / hi))

    return lr_at


def ng_states(model, seed: int):
    """Fresh natural-gradient states of every affine with a bias, made the
    way the trainer makes its own (random bases from ``seed``), by the
    reference's code."""
    import torch

    g = torch.Generator().manual_seed(seed)
    return {name: {side: ref_ngsgd.ng_init(dim, generator=g)
                   for side, dim in (("in", m.in_dim + 1), ("out", m.out_dim))}
            for name, m in model.named_modules()
            if type(m).__name__ == "NaturalAffineTransform" and m.bias is not None}


def opts(cfg: Dict) -> Dict:
    t = cfg["train"]
    return dict(lr=t["lr_initial"], xent_regularize=t["xent_regularize"],
                l2_regularize=t["l2_regularize"], leaky_hmm_coefficient=t["leaky_hmm_coefficient"])


class Readings:
    """What is compared of the first steps: the losses, each parameter's
    step-1 gradient norm (from AdamW's first moment) and each parameter's
    change norm after the steps."""

    def __init__(self, names: List[str]):
        self.names = names
        self.losses: List[float] = []
        self.grad = None
        self.change = None

    def after_step(self, torch, trainer, params, w0, loss: float) -> None:
        self.losses.append(loss)
        if len(self.losses) == 1:
            beta1 = trainer.optimizer.param_groups[0]["betas"][0]
            moments = [trainer.optimizer.state.get(p, {}).get("exp_avg") for p in params]
            # a parameter the optimizer never stepped got no gradient
            self.grad = torch.stack([(m / (1 - beta1)).norm() if m is not None
                                     else p.new_zeros(()) for m, p in zip(moments, params)]
                                    ).double().cpu()
        if len(self.losses) == CHECK_STEPS:
            self.change = torch.stack([(p.detach() - w0[n]).norm() for n, p in
                                       zip(self.names, params)]).double().cpu()


def gaps(got: Readings, want: Readings) -> Dict[str, float]:
    """The numbers that can be compared. ``loss1_gap``: the first step's
    relative loss gap; ``loss_gap``: the worst step's. For the step-1
    gradient and for the change after the steps, each parameter's gap of
    norms (the program's norm less the reference's) over the larger of its
    own reference norm and the median parameter's: ``grad_gap`` and
    ``change_gap`` take the worst parameter, ``grad_median_gap`` and
    ``change_median_gap`` the median one. A parameter whose reference
    gradient is under a thousandth of the median one's (rounding noise,
    such as a bias before a batch norm) is left out of the change: Adam
    moves it by round-off alone."""
    def rel(a, b):
        return abs(a - b) / max(abs(b), 1e-30)

    def per_leaf(a, b, keep=None):
        if keep is not None:
            a, b = a[keep], b[keep]
        return (a - b).abs() / b.clamp(min=float(b.median()))

    g = per_leaf(got.grad, want.grad)
    keep = want.grad >= 1e-3 * float(want.grad.median())
    c = per_leaf(got.change, want.change, keep)
    out = {"loss1_gap": rel(got.losses[0], want.losses[0]),
           "loss_gap": max(rel(a, b) for a, b in zip(got.losses, want.losses)),
           "grad_gap": float(g.max()), "grad_median_gap": float(g.median()),
           "change_gap": float(c.max()), "change_median_gap": float(c.median())}
    return {k: v if math.isfinite(v) else math.inf for k, v in out.items()}


def reference_steps(torch, cfg: Dict, data: ChainData, batches: List[List[str]], w0, ng0,
                    seed: int, lr_at, device, lower=None, half: bool = False) -> Readings:
    """The plain reference's first steps on ``batches`` (utterance ids), from
    the files (the den graph as the reference read it at set-up), the
    weights ``w0`` and the NG states ``ng0``; with ``lower``
    its operands in that precision; with ``half`` each batch's second half
    left out (a fault)."""
    den = data.den
    net = {k: tuple(v) if isinstance(v, list) else v for k, v in cfg["build"].items()}
    with torch.device(device):
        model = ref_asrbn.TDNNFNet(ref_asrbn.TDNNFNetConfig(**net))
    model.load_state_dict(w0)
    tr = ref_trainer.ChainTrainer(model, den, ref_trainer.ChainTrainOpts(**opts(cfg)),
                                  lr_schedule=lr_at, seed=seed, ng_states=ng0)
    names = [n for n, _ in model.named_parameters()]
    params = [p for _, p in model.named_parameters()]
    out = Readings(names)
    with precision.lower(lower):
        for utts in batches:
            if half:
                utts = utts[:len(utts) // 2]
            wav = np.stack([read_wav(data.wavs[u]) for u in utts])
            graphs = [data.graph(u) for u in utts]
            frames = np.array([output_frames(len(x)) for x in wav], np.int32)
            m = tr.step(torch.from_numpy(wav).to(device),
                        ref_objf.graphs_to_torch(ref_fst.pad_graph_arrays(graphs), device),
                        torch.from_numpy(frames).to(device))
            out.after_step(torch, tr, params, w0, float(m["loss"]))
    del tr, model
    return out


class Program:
    """The port's side of a chain cell: its dataset, sampler and one
    trainer with the benchmark's weights and NG states, as ``train_asr``
    builds them from the cell's files."""

    def __init__(self, ctx, data: ChainData):
        from satpu_torch import infer_helper
        from satpu_torch.chain.dataset import BucketBatchSampler, EgsDataset
        from satpu_torch.chain.fst import Fst
        from satpu_torch.chain.objf import DenominatorGraph
        from satpu_torch.chain.trainer import ChainTrainer, ChainTrainOpts

        torch, dev, cfg = ctx.torch, ctx.device, ctx.cell.config
        self.torch, self.dev, self.data = torch, dev, data
        den = DenominatorGraph.from_fst(Fst.read(data.den_fst), cfg["build"]["output_dim"])
        self.ds = ds = EgsDataset(data.wav_scp, data.fst_scp, data.utt2len)
        self.dropped = ds.filter_min_path()
        for i in range(len(ds)):  # the supervision cache train_asr fills in its first epoch
            ds.supervision_arrays(i)
        self.sampler = BucketBatchSampler(ds, ctx.cell.traffic["batch"], seed=ctx.seed)
        self.lr_at = lr_schedule(cfg, len(self.sampler))
        torch.manual_seed(ctx.seed)
        with torch.device(dev):
            self.model = infer_helper.build_model(cfg["model_id"], device=dev, seed=None,
                                                  **cfg["build"])
        self.w0 = weights.draw(torch, self.model, ctx.seed, dev)
        self.model.load_state_dict(self.w0)
        self.ng0 = ng_states(self.model, ctx.seed)
        self.trainer = ChainTrainer(self.model, den, ChainTrainOpts(**opts(cfg)),
                                    lr_schedule=self.lr_at, seed=ctx.seed, ng_states=self.ng0)
        self.names = [n for n, _ in self.model.named_parameters()]
        self.params = [p for _, p in self.model.named_parameters()]
        self.spans = trace.Spans(torch, dev)
        # epoch 0's batches in the sampler's order: set-up takes the first
        # batch of every length (and enough for the checked steps), the
        # window the rest, then the later epochs
        epoch0 = list(self.sampler)
        self.first, seen = [], set()
        for idx in epoch0:
            n = ds.egs[idx[0]].num_samples
            if n not in seen:
                seen.add(n)
                self.first.append(idx)
        self.first += [idx for idx in epoch0
                       if idx not in self.first][:max(CHECK_STEPS - len(self.first), 0)]
        self.rest0 = [idx for idx in epoch0 if idx not in self.first]

    def feed(self, idx: List[int]):
        """(batch on the card, utterance ids, samples) of a sampler batch:
        ``load_batch`` and the copy, in the span ``load``."""
        from satpu_torch.chain.objf import graphs_to_torch

        torch, dev = self.torch, self.dev
        with self.spans.host_span("load"):
            wavs, graphs, frames, utts = self.ds.load_batch(idx)
            batch = (torch.from_numpy(wavs).to(dev), graphs_to_torch(graphs, dev),
                     torch.from_numpy(frames).to(dev))
        return batch, utts, int(wavs.shape[0]) * int(wavs.shape[1])

    def later(self):
        """The window's batches: the rest of epoch 0, then epoch after epoch."""
        yield from self.rest0
        epoch = 1
        while True:
            self.sampler.set_epoch(epoch)
            yield from self.sampler
            epoch += 1

    def set_up(self, steps: int = 0):
        """The first steps (all of ``first`` unless ``steps``): returns the
        readings of the checked ones and their utterance ids."""
        mine, checked = Readings(self.names), []
        for idx in self.first[:steps or None]:
            batch, utts, _ = self.feed(idx)
            m = self.trainer.step(*batch)
            if len(checked) < CHECK_STEPS:
                checked.append(utts)
                mine.after_step(self.torch, self.trainer, self.params, self.w0, float(m["loss"]))
        return mine, checked


def run(ctx) -> Dict:
    root = tempfile.mkdtemp(prefix="portbench-chain-")
    try:
        return drive(ctx, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def drive(ctx, root) -> Dict:
    torch, dev, cfg = ctx.torch, ctx.device, ctx.cell.config
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
            state["flops"] += counts.train_step_flops(cfg["build"], lens)
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
        # half the window untraced (the rate and MFU), half with the
        # trainer's ranges timed (the phases), then the recorded steps and
        # the profiled ones
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
        audio, n_lengths = state["audio"], len(state["lengths"])
        # the profiled steps' batches, drawn ahead: K3's bound counts their graphs
        ahead = list(itertools.islice(feed_it, cfg["traced_steps"]))
        feed_it = itertools.chain(ahead, feed_it)
        with trace.profiled(torch, dev, trace.program_prefixes()) as traced:
            loop(t1, steps=cfg["traced_steps"])
        layer.update(digest=traced.digest, traced_audio_s=state["audio"] - audio,
                     profiled_steps=cfg["traced_steps"],
                     den_bound_s=sum(sum(counts.k2_bound_s(len(lens), output_frames(lens[0]),
                                                           data.den.num_states, data.den_nnz))
                                     for lens in state["lengths"][n_lengths:]),
                     num_bound_s=sum(sum(counts.k3_bound_s(
                         output_frames(max(ds.egs[i].num_samples for i in idx)),
                         [data.graph_size(ds.egs[i].utt) for i in idx])) for idx in ahead))
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
