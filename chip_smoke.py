#!/usr/bin/env python3
"""On-card smoke test of satpu_torch, the PyTorch/CUDA port of satpu.

Phases (each prints its lines; any failure exits non-zero with no result):

1. build: compiles every CUDA kernel from satpu_torch/csrc with nvcc
   (sm_90a), one nvcc per source, all started together;
2. kernel: holds the SHC kernel against its plain PyTorch version at the
   serving path's shapes (random and real YAAPT inputs) and times both;
3. slice: builds the flagship anonymizer at full width (TDNNF 1024 + VQ-48,
   3280 outputs, 247 speakers, HiFi-GAN 512, bf16 serving policy; random
   weights from a seed), saves it, and runs the ``anonymize`` CLI on the
   card over a synthetic kaldi dir of 8 voiced utterances (2-10 s); checks
   every written wav, that the main path launched every kernel, and the
   card's F0 against the known contours;
4. cpu: the card against the port's own CPU path at f32 (TF32 off) on one
   2 s utterance, for get_f0 and convert;
5. throughput: get_f0 and convert as two calls at B=32 and B=128 x 10 s,
   bf16, in audio-seconds per second;
6. profile: the kernels that take the device time of one B=32 batch, and
   the device's busy share of each call;
7. den kernel: holds the LF-MMI den forward (K2f) and backward (K2b)
   kernels against their plain versions at the training path's shapes (the
   full-scale den graph of 1641 states, B=16, T=99) on random loglikes and
   on the full-width network's chain output, and times them;
8. train: builds a chain fixture (den graph, numerator FSTs, 32 + 16
   synthetic 3 s egs) and runs the ``train_asr`` CLI on the card for 4 steps
   of the full-width TDNN-F + VQ-48 with natural gradient; checks the
   logged objf, that every step launched both den kernels, and that
   final.ckpt serves as an ``asrbn_tdnnf`` extractor;
9. train-cpu: one tiny train step on the card against the port's CPU path;
10. train-throughput: full-width train steps at B=16 and B=64 x 3 s, then a
    profile of as many steps: the step's phases (the trainer's profiler
    ranges), the busy share, and the device items of a B=16 step.

The line before the last is the card's name and power limit from
nvidia-smi; the last line is the run's JSON verdict. Needs one CUDA card.

Usage (from the repository root):  python3 chip_smoke.py
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "build", "chip_smoke")
SR = 16000
# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth; f32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
FLAGSHIP = {"asrbn": {"output_dim": 3280, "bottleneck": "vq", "codebook_size": 48},
            "num_speakers": 247}
SPEAKERS = [f"spk{i:03d}" for i in range(247)]
SLICE_UTTS = [(2.0, 105.0), (3.1, 125.0), (4.2, 145.0), (5.3, 165.0), (6.4, 185.0),
              (7.5, 205.0), (8.6, 225.0), (10.0, 245.0)]  # (seconds, base F0 Hz)
KERNEL_SOURCES = ("shc", "den_fb")
# chain training: the full-scale den graph (a 164-phone bigram, 9 successors
# each: 3280 pdfs, 1641 states) and 3 s egs (99 output frames)
DEN_PHONES, DEN_SUCC, NUM_PDFS, DEN_STATES = 164, 9, 3280, 1641
EG_SECONDS, EG_FRAMES = 3.0, 99
TRAIN_NET = {"output_dim": NUM_PDFS, "bottleneck": "vq", "codebook_size": 48,
             "natural_gradient": True}
# the train-cpu phase: a tiny TDNN-F over a 5-phone den graph (40 pdfs)
TINY_NET = {"output_dim": 40, "hidden_dim": 32, "bottleneck_dim": 16,
            "prefinal_bottleneck_dim": 16, "bottleneck": "vq", "codebook_size": 8,
            "natural_gradient": True, "p_dropout": 0.0}


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke FAILED: {what}")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def voiced_utterance(np, seconds: float, f0_base: float, seed: int):
    """A harmonic signal whose F0 glides +-5% around f0_base, with 0.25 s of
    noise floor at each end. Returns (float32 samples, F0 at every sample,
    voiced mask per sample)."""
    rng = np.random.default_rng(seed)
    n = int(seconds * SR)
    t = np.arange(n) / SR
    f0 = f0_base * (1 + 0.05 * np.sin(2 * np.pi * 0.5 * t))
    phase = 2 * np.pi * np.cumsum(f0) / SR
    s = sum(a * np.sin(h * phase) for h, a in [(1, 1.0), (2, 0.55), (3, 0.35), (4, 0.18)])
    voiced = (t >= 0.25) & (t < seconds - 0.25)
    ramp = np.clip(np.minimum(t - 0.25, seconds - 0.25 - t) / 0.02, 0, 1)
    x = 0.3 * s * ramp * voiced + rng.standard_normal(n) * 0.002
    return x.astype(np.float32), f0, voiced


def cuda_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    """Mean device milliseconds per call of fn, from CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(ops: float, nbytes: float):
    """(least milliseconds, "operations" | "bytes") at the card's f32 peak
    and memory rate."""
    ops_ms, bytes_ms = ops / F32_FLOPS_PER_S * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def phase_build():
    """Every kernel source, one nvcc each, all started together."""
    from concurrent.futures import ThreadPoolExecutor

    from satpu_torch.utils import cuda_build

    def build(name):
        t0 = time.perf_counter()
        path, log = cuda_build.build(name, force=True)
        return name, path, log, time.perf_counter() - t0

    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
        built = list(pool.map(build, KERNEL_SOURCES))
    for name, path, log, secs in built:
        usage = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
        print(f"[build] csrc/{name}.cu -> {os.path.relpath(path, ROOT)} in {secs:.2f} s"
              " (nvcc sm_90a)")
        for ln in usage:
            print(f"[build] ptxas: {ln}")


def phase_kernel(np, torch):
    """SHC band kernel vs its plain version; returns the kernel's JSON entry
    (without the main path's launch count)."""
    import torch.nn.functional as F

    from satpu_torch.models.anonymizer import YAAPT_OPTS
    from satpu_torch.ops import yaapt as Y

    p = Y._merged_params(YAAPT_OPTS)
    to_pad, frame_size, frame_jump, nfft = Y.frame_geometry(p)
    g = Y.shc_params(nfft, p)
    args = (g["min_shc"], g["n_out"], g["n_harm"], g["window_length"])
    M, I, H, J = g["top_bin"] + g["half_window"], g["n_out"], g["n_harm"], g["window_length"]

    # real input: the SHC magnitudes of 16 synthetic voiced 10 s utterances
    x = np.stack([voiced_utterance(np, 10.0, 100.0 + 10 * k, seed=k)[0] for k in range(16)])
    xp = F.pad(torch.from_numpy(x).cuda(), (to_pad, to_pad))
    nl = Y.bandpass(xp ** 2, p["sr"], p["bp_low"], p["bp_high"])
    real = Y.shc_magnitude(nl, Y.num_frames(x.shape[1], p), frame_size, frame_jump, nfft, p)
    n_frames = real.shape[0]  # B=16 x 10 s -> 8000 frames
    gen = torch.Generator(device="cuda").manual_seed(0)
    rand = torch.rand((n_frames, M), generator=gen, device="cuda")

    worst = 0.0
    for name, mag in (("random", rand), ("yaapt", real)):
        out = Y.shc_band(mag, *args)
        ref = Y.shc_band_plain(mag, *args)
        torch.cuda.synchronize()
        max_abs = (out - ref).abs().max().item()
        rel = max_abs / ref.abs().max().item()
        worst = max(worst, max_abs)
        print(f"[kernel] shc_band vs plain, {name} mag [{n_frames} x {M}] -> [{n_frames} x {I}]:"
              f" max abs err {max_abs:.3e}, rel {rel:.3e} (tolerance rel 1e-5)")
        check(rel <= 1e-5, f"shc_band disagrees with its plain version on {name} input")

    def shc_bound(frames):  # mag in, shc out; J x H products an output
        return bound(frames * I * J * H, frames * (M + I) * 4)

    # time on inputs that do not stay in the 50 MB L2: cycle 4 copies
    bufs = [torch.rand((n_frames, M), generator=gen, device="cuda") for _ in range(4)]
    it = iter(range(1 << 30))
    ms = cuda_ms(torch, lambda: Y.shc_band(bufs[next(it) % 4], *args), iters=200)
    plain_ms = cuda_ms(torch, lambda: Y.shc_band_plain(bufs[0], *args), iters=5, warmup=1)
    big = torch.rand((8 * n_frames, M), generator=gen, device="cuda")  # B=128 x 10 s
    ms_big = cuda_ms(torch, lambda: Y.shc_band(big, *args), iters=50)
    b, by = shc_bound(n_frames)
    b_big, _ = shc_bound(8 * n_frames)
    print(f"[kernel] shc_band F={n_frames}: {ms * 1e3:.1f} us (bound {b * 1e3:.1f} us by {by},"
          f" {b / ms:.0%} of it); plain version {plain_ms * 1e3:.1f} us")
    print(f"[kernel] shc_band F={8 * n_frames}: {ms_big * 1e3:.1f} us (bound {b_big * 1e3:.1f} us,"
          f" {b_big / ms_big:.0%} of it)")
    del bufs, big, rand, real
    return {"name": "shc_band", "route": "cuda", "source": "satpu_torch/csrc/shc.cu",
            "replaces": "satpu/ops/yaapt.py:588", "launches": 0, "max_abs_err": worst,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b, "bound_by": by, "library_ms": None}


def phase_slice(np, torch):
    """The flagship anonymize CLI on the card; returns the kernels' launch
    counts over that run and the checkpoint path."""
    from satpu_torch import infer_helper
    from satpu_torch.bin import anonymize
    from satpu_torch.models.anonymizer import YAAPT_OPTS
    from satpu_torch.ops import yaapt as Y
    from satpu_torch.utils import kaldi_data

    shutil.rmtree(WORK, ignore_errors=True)
    data = os.path.join(WORK, "data")
    os.makedirs(data)
    t0 = time.perf_counter()
    model = infer_helper.build_model("anonymizer_tdnnf_hifigan", device="cpu", seed=0,
                                     **FLAGSHIP)
    c = model.cfg
    check((c.asrbn.hidden_dim, c.asrbn.codebook_size, c.asrbn.output_dim, c.num_speakers,
           c.upsample_initial_channel) == (1024, 48, 3280, 247, 512), "flagship widths")
    n_params = sum(v.numel() for v in model.state_dict().values())
    ckpt = os.path.join(WORK, "flagship.pt")
    infer_helper.save_model(ckpt, "anonymizer_tdnnf_hifigan", FLAGSHIP, model.state_dict(),
                            extra_meta={"speakers": SPEAKERS})
    del model
    print(f"[slice] flagship anonymizer, {n_params / 1e6:.1f} M weights from seed 0,"
          f" saved in {time.perf_counter() - t0:.1f} s")

    wav_scp, utt2spk, truth = {}, {}, {}
    for k, (secs, f0) in enumerate(SLICE_UTTS):
        x, f0_true, voiced = voiced_utterance(np, secs, f0, seed=100 + k)
        utt = f"utt{k}"
        path = os.path.join(WORK, f"{utt}.wav")
        kaldi_data.write_wav(path, x, SR)
        wav_scp[utt], utt2spk[utt] = path, f"src{k % 3}"
        truth[utt] = (kaldi_data.load_wav_from_scp(path)[0][0], f0_true, voiced)
    kaldi_data.write_keyed_text(wav_scp, os.path.join(data, "wav.scp"))
    kaldi_data.write_keyed_text(utt2spk, os.path.join(data, "utt2spk"))

    Y.shc_band.launches = 0
    t0 = time.perf_counter()
    rc = anonymize.main(["--checkpoint", ckpt, "--directory", data, "--batch-size", "8",
                         "--target-selection-algorithm", "random_per_utt",
                         "--results-dir", os.path.join(WORK, "out")])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"shc_band": Y.shc_band.launches}
    check(rc == 0, f"anonymize exited {rc}")
    audio = sum(s for s, _ in SLICE_UTTS)
    print(f"[slice] anonymize CLI on cuda: {len(SLICE_UTTS)} utterances, {audio:.1f} s of audio"
          f" in {wall:.2f} s (first call, cold); kernel launches {launches}")
    check(all(n > 0 for n in launches.values()), f"a kernel was not launched: {launches}")

    scp = kaldi_data.read_wav_scp(os.path.join(data + "_anon", "wav.scp"))
    check(sorted(scp) == sorted(truth), "one output wav per utterance")
    for utt, (x, _, _) in truth.items():
        y, rate = kaldi_data.load_wav_from_scp(scp[utt])
        check(rate == SR and y.shape == (1, len(x)), f"{utt}: length {y.shape} vs {len(x)}")
        check(bool(np.isfinite(y).all()) and float(np.abs(y).max()) > 1e-3,
              f"{utt}: output not finite or silent")
    print(f"[slice] {len(scp)} wavs written, lengths equal to the inputs, finite, not silent")

    # the card's F0 on the same padded batch against the known contours
    batch = np.zeros((len(truth), max(len(v[0]) for v in truth.values())), np.float32)
    for j, (x, _, _) in enumerate(truth.values()):
        batch[j, :len(x)] = x
    f0 = Y.yaapt(batch, YAAPT_OPTS, device="cuda").cpu().numpy()
    hits = total = 0
    for j, (x, f0_true, voiced) in enumerate(truth.values()):
        centers = np.arange(Y.num_frames(len(x), Y._merged_params(YAAPT_OPTS))) * 320
        keep = np.array([voiced[max(c - 800, 0):c + 800].all() for c in centers])
        est, ref = f0[j, :len(centers)][keep], f0_true[np.minimum(centers, len(x) - 1)][keep]
        hits += int(np.sum((est > 0) & (np.abs(est - ref) < 0.05 * ref)))
        total += int(keep.sum())
    agree = hits / total
    print(f"[slice] card get_f0 within 5% of the known F0 on {agree:.4f} of {total}"
          " voiced frames")
    check(agree >= 0.9, f"F0 agreement {agree:.3f}")
    return launches, ckpt


def phase_cpu(np, torch, ckpt):
    """The card against the port's own CPU path at f32 on a 2 s utterance."""
    from satpu_torch import infer_helper

    opts = infer_helper.serving_option_args("float32")
    cpu, _ = infer_helper.load_model(ckpt, device="cpu", option_args=opts)
    gpu, _ = infer_helper.load_model(ckpt, device="cuda", option_args=opts)
    x = torch.from_numpy(voiced_utterance(np, 2.0, 150.0, seed=7)[0])[None]
    tid = torch.tensor([5])
    with torch.inference_mode():
        f0_cpu = cpu.get_f0(x)
        f0_gpu = gpu.get_f0(x.cuda()).cpu()
        vc, vg = f0_cpu > 0, f0_gpu > 0
        voicing = (vc == vg).float().mean().item()
        both = vc & vg
        rel = ((f0_gpu[both] - f0_cpu[both]).abs() / f0_cpu[both]).numpy()
        p99 = float(np.quantile(rel, 0.99)) if rel.size else 0.0
        w_cpu = cpu.convert(x, f0_cpu, tid)
        w_gpu = gpu.convert(x.cuda(), f0_cpu.cuda(), tid.cuda()).cpu()
        wrel = ((w_gpu - w_cpu).abs().max() / w_cpu.abs().max()).item()
    print(f"[cpu] f32, TF32 off, 2 s: get_f0 voicing agreement {voicing:.4f}, voiced rel err"
          f" p99 {p99:.3e} ({int(both.sum())} frames); convert waveform rel err {wrel:.3e}")
    check(voicing >= 0.95 and p99 <= 1e-2, "card F0 departs from the CPU path")
    check(wrel <= 1e-2, "card waveform departs from the CPU path")


def phase_throughput(torch, ckpt, card):
    from satpu_torch import infer_helper

    model, _ = infer_helper.load_model(ckpt, option_args=infer_helper.serving_option_args())
    gen = torch.Generator(device="cuda").manual_seed(0)
    T = 10 * SR
    for B, iters in ((32, 3), (128, 2)):
        wav = torch.randn((B, T), generator=gen, device="cuda") * 0.05
        tid = torch.arange(B, device="cuda") % 247
        torch.cuda.reset_peak_memory_stats()
        with torch.inference_mode():
            out = model.convert(wav, model.get_f0(wav), tid)  # warm-up
            torch.cuda.synchronize()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3 * iters)]
            t0 = time.perf_counter()
            for i in range(iters):
                ev[3 * i].record()
                f0 = model.get_f0(wav)
                ev[3 * i + 1].record()
                out = model.convert(wav, f0, tid)
                ev[3 * i + 2].record()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        f0_ms = sum(ev[3 * i].elapsed_time(ev[3 * i + 1]) for i in range(iters)) / iters
        cv_ms = sum(ev[3 * i + 1].elapsed_time(ev[3 * i + 2]) for i in range(iters)) / iters
        check(tuple(out.shape) == (B, T + 1) and bool(torch.isfinite(out).all()),
              f"throughput output at B={B}")
        rate = B * 10.0 * iters / wall
        print(f"[throughput] B={B} x 10 s bf16: {rate:.1f} audio-s/s ({wall / iters * 1e3:.1f} ms"
              f" per batch, host clock); device get_f0 {f0_ms:.1f} ms + convert {cv_ms:.1f} ms;"
              f" peak mem {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB [{card}]")
        del wav, out, f0


def phase_profile(torch, ckpt, card):
    """Where one B=32 x 10 s batch spends its time: torch.profiler over each
    serving call, kernels ranked by device time, and the device's busy share
    of the call's host-clock span. Informational: nothing here can fail."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from satpu_torch import infer_helper

    model, _ = infer_helper.load_model(ckpt, option_args=infer_helper.serving_option_args())
    gen = torch.Generator(device="cuda").manual_seed(1)
    wav = torch.randn((32, 10 * SR), generator=gen, device="cuda") * 0.05
    tid = torch.arange(32, device="cuda")
    with torch.inference_mode():
        f0 = model.get_f0(wav)
        model.convert(wav, f0, tid)  # warm-up
        for name, fn in (("get_f0", lambda: model.get_f0(wav)),
                         ("convert", lambda: model.convert(wav, f0, tid))):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            span_us = (time.perf_counter() - t0) * 1e6  # without the profiler
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            # device-side rows only: the aten ops that launched them carry the
            # same time again
            rows = [(e.self_device_time_total, e.count, e.key) for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
            busy = sum(r[0] for r in rows)
            if not rows:
                print(f"[profile] {name}: the profiler recorded no device time")
                continue
            print(f"[profile] B=32 x 10 s bf16 {name}: {span_us / 1e3:.1f} ms (host clock, "
                  f"unprofiled), kernels {busy / 1e3:.1f} ms = {busy / span_us:.0%} busy, "
                  f"{sum(r[1] for r in rows)} kernel launches [{card}]")
            for dev_us, count, key in sorted(rows, reverse=True)[:8]:
                print(f"[profile]   {dev_us / 1e3:8.2f} ms {dev_us / busy:5.1%} x{count:<5d}"
                      f" {key[:90]}")


def den_graph():
    from satpu_torch.chain.objf import DenominatorGraph
    from satpu_torch.chain.prep import random_bigram_den

    fst, tree, _ = random_bigram_den(DEN_PHONES, DEN_SUCC, seed=0)
    den = DenominatorGraph.from_fst(fst, tree.num_pdfs)
    print(f"[den] den graph from a {DEN_PHONES}-phone bigram x {DEN_SUCC} successors:"
          f" {tree.num_pdfs} pdfs, {den.num_states} states, {fst.num_arcs} arcs, factored"
          f" {den.factored is not None}")
    check((tree.num_pdfs, den.num_states) == (NUM_PDFS, DEN_STATES)
          and den.factored is not None, "the full-scale den graph")
    return den


def phase_den_kernel(np, torch, den):
    """K2f and K2b against their plain versions at the training path's
    shapes (B=16, T=99, S=1641, leak 1e-5), on random loglikes and on the
    chain output of the full-width network, then timed; returns their JSON
    entries (without the main path's launch counts)."""
    from satpu_torch import infer_helper
    from satpu_torch.chain import den_fb

    B, T, S = 16, EG_FRAMES, den.num_states
    g = den.tensors("cuda")
    graph = (g["A"], g["log_self"], g["log_init"])
    lk = den_fb.leak_log(1e-5)
    a0 = g["start"].expand(B, S).contiguous()
    net = infer_helper.build_model("asrbn_tdnnf", device="cuda", seed=0, **TRAIN_NET)
    wav = np.stack([voiced_utterance(np, EG_SECONDS, 100.0 + 9 * k, seed=200 + k)[0]
                    for k in range(B)])
    with torch.no_grad():
        chain_out = net(torch.from_numpy(wav).cuda())[0]
    del net
    check(tuple(chain_out.shape) == (B, T, NUM_PDFS), f"chain_out {tuple(chain_out.shape)}")
    gen = torch.Generator(device="cuda").manual_seed(2)
    inputs = {"random": torch.randn((B, T, NUM_PDFS), generator=gen, device="cuda") * 2,
              "chain_out": chain_out}
    err_f = err_b = 0.0
    for name, ll in inputs.items():
        llf, lls = ll.index_select(-1, g["pdf_fwd"]), ll.index_select(-1, g["pdf_self"])
        res = []
        for scan in (den_fb.den_scan, den_fb.den_scan_plain):
            x1, x2 = llf.clone().requires_grad_(True), lls.clone().requires_grad_(True)
            v = den_fb.final_value(scan(x1, x2, a0, *graph, lk), g["final"], g["log_init"], lk)
            v.sum().backward()
            res.append((v.detach(), x1.grad, x2.grad))
        torch.cuda.synchronize()
        (v, gf, gs), (v_p, gf_p, gs_p) = res
        v_abs = (v - v_p).abs().max().item()
        v_rel = v_abs / v_p.abs().max().item()
        g_abs = max((gf - gf_p).abs().max().item(), (gs - gs_p).abs().max().item())
        occupation = (gf + gs).sum(-1)  # the den posteriors of each frame sum to one
        occ_err = (occupation - 1).abs().max().item()
        # K2f's own output, the stored alphas, over the states the plain
        # version reaches (the rest hold NEG_INF on both sides)
        alphas = den_fb.den_fb_forward(llf, lls, a0, *graph, lk)
        alphas_p = den_fb.den_fb_forward_plain(llf, lls, a0, *graph, lk)
        live = alphas_p > den_fb.NEG_INF / 2
        a_abs = (alphas - alphas_p)[live].abs().max().item()
        same_live = bool(torch.equal(live, alphas > den_fb.NEG_INF / 2))
        print(f"[kernel] den_fb K2f+K2b vs plain, {name} loglikes B={B} T={T} S={S} leak 1e-5:"
              f" value max abs err {v_abs:.3e}, rel {v_rel:.3e} (tolerance rel 1e-5);"
              f" alphas max abs err {a_abs:.3e}, rel {a_abs / alphas_p[live].abs().max():.3e}"
              f" over the {live.float().mean().item():.1%} live entries (same live set:"
              f" {same_live});"
              f" gradient max abs err {g_abs:.3e} (tolerance 1e-4); posteriors sum to 1"
              f" within {occ_err:.1e}")
        check(bool(torch.isfinite(v).all() and torch.isfinite(gf).all()
                   and torch.isfinite(gs).all()), f"den_fb output not finite on {name}")
        check(v_rel <= 1e-5 and same_live, f"K2f disagrees with its plain version on {name}")
        check(g_abs <= 1e-4, f"K2b disagrees with its plain version on {name}")
        check(occ_err <= 1e-3, f"den posteriors do not sum to one on {name}")
        err_f, err_b = max(err_f, v_abs, a_abs), max(err_b, g_abs)

    # timed on the chain output (the last input): A stays in the 50 MB L2
    # across a call's frames, as it does in a train step
    a_T = alphas[-1].clone().requires_grad_(True)
    den_fb.final_value(a_T, g["final"], g["log_init"], lk).sum().backward()
    g_final = a_T.grad
    ms_f = cuda_ms(torch, lambda: den_fb.den_fb_forward(llf, lls, a0, *graph, lk), iters=20)
    plain_f = cuda_ms(torch, lambda: den_fb.den_fb_forward_plain(llf, lls, a0, *graph, lk),
                      iters=3, warmup=1)
    ms_b = cuda_ms(torch, lambda: den_fb.den_fb_backward(g_final, alphas, llf, lls, *graph, lk),
                   iters=20)
    plain_b = cuda_ms(torch, lambda: den_fb.den_fb_backward_plain(g_final, alphas, llf, lls,
                                                                  *graph, lk),
                      iters=3, warmup=1)
    BTS, SS = B * T * S, S * S
    # operations: A comes from the den graph's arcs, so e @ A needs one FMA
    # per nonzero of A, per batch row and frame (the backward twice: sums
    # again, and d_sums @ A^T). Bytes: each input read once and each output
    # written once: llf, lls, alpha0, A, log_self, log_init in; alphas
    # [T+1, B, S] out (the backward: g_final, alphas, llf, lls and the graph
    # in; dllf, dlls out)
    nnz = int((g["A"] != 0).sum())
    b_f, by_f = bound(2 * B * T * nnz, 4 * (2 * BTS + B * S + SS + 2 * S + (T + 1) * B * S))
    b_b, by_b = bound(4 * B * T * nnz, 4 * (B * S + (T + 1) * B * S + 2 * BTS + SS + 2 * S
                                           + 2 * BTS))
    print(f"[kernel] den graph A: {nnz} nonzeros of {SS} ({nnz / SS:.2%} dense)")
    for name, ms, plain, b, by in (("K2f den_fb_forward", ms_f, plain_f, b_f, by_f),
                                   ("K2b den_fb_backward", ms_b, plain_b, b_b, by_b)):
        print(f"[kernel] {name} B={B} T={T} S={S}: {ms * 1e3:.1f} us (bound {b * 1e3:.1f} us"
              f" by {by}, {b / ms:.2%} of it); plain version {plain * 1e3:.1f} us")
    entry = {"route": "cuda", "source": "satpu_torch/csrc/den_fb.cu", "launches": 0,
             "library_ms": None}
    return [dict(entry, name="den_fb_forward", replaces="satpu/chain/pallas_fb.py:234",
                 max_abs_err=err_f, ms=ms_f, plain_ms=plain_f, bound_ms=b_f, bound_by=by_f),
            dict(entry, name="den_fb_backward", replaces="satpu/chain/pallas_fb.py:278",
                 max_abs_err=err_b, ms=ms_b, plain_ms=plain_b, bound_ms=b_b, bound_by=by_b)]


def phase_train(np, torch):
    """The train_asr CLI on the card: the full-width TDNN-F + VQ-48 chain
    model (3280 pdfs, natural gradient on) for 4 steps of B=16 x 3 s egs
    over the full-scale den graph, with a held-out set (diagnostics every
    step, final combination). Returns the den kernels' launch counts over
    that run and the fixture."""
    from satpu_torch import infer_helper
    from satpu_torch.bin import train_asr
    from satpu_torch.chain import den_fb
    from satpu_torch.chain.prep import write_random_chain_corpus
    from satpu_torch.models.asrbn import bn_num_frames

    t0 = time.perf_counter()
    fx = write_random_chain_corpus(os.path.join(WORK, "chain"), n_utts=32, seconds=EG_SECONDS,
                                   n_phones=DEN_PHONES, succ_per_phone=DEN_SUCC, seed=0,
                                   n_valid=16)
    check(fx["num_pdfs"] == NUM_PDFS, f"fixture num_pdfs {fx['num_pdfs']}")
    print(f"[train] fixture: 32 train + 16 held-out noise egs of {EG_SECONDS} s with"
          f" numerators over the {NUM_PDFS}-pdf den graph, written in"
          f" {time.perf_counter() - t0:.1f} s")
    exp = os.path.join(WORK, "chain", "exp")
    steps = 4  # 32 egs of one length, B=16: 2 steps an epoch, 2 epochs
    den_fb.den_fb_forward.launches = den_fb.den_fb_backward.launches = 0
    t0 = time.perf_counter()
    rc = train_asr.main(["--train-set", fx["data"], "--fst-scp", fx["fst_scp"],
                         "--valid-set", fx["valid"], "--valid-fst-scp", fx["valid_fst_scp"],
                         "--den-fst", fx["den_fst"], "--num-pdfs", str(NUM_PDFS),
                         "--model", "tdnnf_vq", "--codebook-size", "48",
                         "--minibatch-size", "16", "--num-epochs", "2",
                         "--diagnostics-interval", "1", "--dirname", exp])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"den_fb_forward": den_fb.den_fb_forward.launches,
                "den_fb_backward": den_fb.den_fb_backward.launches}
    check(rc == 0, f"train_asr exited {rc}")
    print(f"[train] train_asr on cuda: tdnnf_vq 1024 / VQ-48 / {NUM_PDFS} pdfs, NG on,"
          f" {steps} steps of B=16 x {EG_SECONDS} s + held-out diagnostics every step and"
          f" final combination in {wall:.1f} s (first call, cold); kernel launches {launches}")
    check(all(n >= steps for n in launches.values()), f"a den kernel was not launched once"
          f" a step: {launches}")
    with open(os.path.join(exp, "metrics.jsonl")) as f:
        logged = [json.loads(line) for line in f]
    check([r["step"] for r in logged] == list(range(1, steps + 1)), "one log line a step")
    for r in logged:
        check(all(np.isfinite(r[k]) for k in ("chain_objf", "loss", "valid_objf")),
              f"objf not finite at step {r['step']}: {r}")
        print(f"[train]   step {r['step']}: objf {r['chain_objf']:.4f} (num"
              f" {r['num_logprob']:.3f}, den {r['den_logprob']:.3f}), loss {r['loss']:.4f},"
              f" vq_loss {r['vq_loss']:.4f}, perplexity {r['vq_perplexity']:.2f}, valid objf"
              f" {r['valid_objf']:.4f}, lr {r['lr']:.6f}")

    model, meta = infer_helper.load_model(os.path.join(exp, "final.ckpt"), device="cuda")
    c = model.cfg
    check(meta["model_id"] == "asrbn_tdnnf"
          and (c.hidden_dim, c.codebook_size, c.output_dim) == (1024, 48, NUM_PDFS),
          f"final.ckpt: {meta['model_id']} {c}")
    x = voiced_utterance(np, EG_SECONDS, 140.0, seed=9)[0]
    with torch.inference_mode():
        bn = model.extract_bn(torch.from_numpy(x)[None].cuda())
    want = (1, bn_num_frames(len(x)), c.prefinal_bottleneck_dim)
    check(tuple(bn.shape) == want and bool(torch.isfinite(bn).all()),
          f"extract_bn {tuple(bn.shape)} vs {want}")
    print(f"[train] final.ckpt loads on cuda as asrbn_tdnnf (hidden {c.hidden_dim}, codebook"
          f" {c.codebook_size}, {c.output_dim} outputs); extract_bn on {EG_SECONDS} s:"
          f" finite {list(bn.shape)}")
    return launches, fx


def chain_batch(torch, fx, B: int, device):
    """A training batch of B egs of the fixture (repeated when B > 32):
    (wav, numerator graphs, num_frames) on ``device``."""
    from satpu_torch.chain.dataset import EgsDataset
    from satpu_torch.chain.objf import graphs_to_torch

    ds = EgsDataset(os.path.join(fx["data"], "wav.scp"), fx["fst_scp"],
                    os.path.join(fx["data"], "utt2len"))
    wavs, graphs, frames, _ = ds.load_batch([i % len(ds) for i in range(B)])
    return (torch.from_numpy(wavs).to(device), graphs_to_torch(graphs, device),
            torch.from_numpy(frames).to(device))


def phase_train_cpu(np, torch):
    """One train step of a tiny TDNN-F + VQ (NG on, no dropout) on the card
    against the port's CPU path, from the same weights, NG states and data:
    loss rel <= 1e-5, preconditioned gradients rel <= 1e-3."""
    import copy

    from satpu_torch import infer_helper
    from satpu_torch.chain.fst import fst_rmepsilon, fst_to_arrays, pad_graph_arrays
    from satpu_torch.chain.objf import DenominatorGraph, graphs_to_torch
    from satpu_torch.chain.prep import numerator_fst, random_bigram_den, random_phone_walk
    from satpu_torch.chain.trainer import ChainTrainer

    fst, tree, trans = random_bigram_den(5, 3, seed=2)
    check(tree.num_pdfs == TINY_NET["output_dim"], f"tiny den graph: {tree.num_pdfs} pdfs")
    den = DenominatorGraph.from_fst(fst, tree.num_pdfs)
    rng = np.random.default_rng(3)
    wav = (rng.standard_normal((4, 16000)) * 0.1).astype(np.float32)
    frames = np.full(4, ((16000 + 80) // 160 - 2) // 3, np.int32)
    graphs = pad_graph_arrays([fst_to_arrays(fst_rmepsilon(numerator_fst(
        random_phone_walk(trans, int(frames[0]) // 3, rng), tree))) for _ in range(4)])
    cpu = infer_helper.build_model("asrbn_tdnnf", device="cpu", seed=0, **TINY_NET)
    gpu = copy.deepcopy(cpu).cuda()
    out = {}
    for dev, model in (("cpu", cpu), ("cuda", gpu)):
        trainer = ChainTrainer(model, den, seed=0)
        loss, _ = trainer.compute_grads(torch.from_numpy(wav).to(dev),
                                        graphs_to_torch(graphs, dev),
                                        torch.from_numpy(frames).to(dev))
        out[dev] = (loss.item(), {n: p.grad.cpu() for n, p in model.named_parameters()})
    (l_cpu, g_cpu), (l_gpu, g_gpu) = out["cpu"], out["cuda"]
    l_rel = abs(l_gpu - l_cpu) / abs(l_cpu)
    # the biases whose constant the next batch norm removes have a zero
    # gradient in exact arithmetic: there both sides hold rounding noise (at
    # most 8e-7 of the largest gradient on the CPU; the smallest gradient
    # that is not zero is 3.5e-5 of it)
    top = max(g.abs().max().item() for g in g_cpu.values())
    zero = {n for n, g in g_cpu.items() if g.abs().max().item() <= 1e-5 * top}
    g_rel = max(((g_gpu[n] - g).abs().max() / g.abs().max()).item()
                for n, g in g_cpu.items() if n not in zero)
    noise = max([g_gpu[n].abs().max().item() / top for n in zero], default=0.0)
    print(f"[train-cpu] tiny TDNN-F + VQ-8, NG on, f32, TF32 off, B=4 x 1 s: loss card"
          f" {l_gpu:.6f} vs CPU {l_cpu:.6f}, rel {l_rel:.3e} (tolerance 1e-5); preconditioned"
          f" gradients max rel {g_rel:.3e} over {len(g_cpu) - len(zero)} tensors (tolerance"
          f" 1e-3); {len(zero)} bias gradients zero in exact arithmetic, at most"
          f" {noise:.1e} of the largest gradient on the card (tolerance 1e-5)")
    check(l_rel <= 1e-5, "card loss departs from the CPU path")
    check(g_rel <= 1e-3, "card gradients depart from the CPU path")
    check(noise <= 1e-5, "a zero gradient is not zero on the card")


def train_split(prof, iters: int):
    """Per step, from a profile of ``iters`` train steps: each trainer phase's
    host ms (its ``chain.<phase>`` range on the calling thread) and the
    device ms of the kernels, copies and fills launched inside it. A device
    item belongs to the range whose host window holds its launch call, from
    whatever thread made it (the autograd engine launches the backward's from
    its own). Items launched outside every range count as ``other``."""
    import bisect

    from torch.autograd import DeviceType

    from satpu_torch.chain.trainer import PHASES

    events = prof.events()
    ranges = sorted((e.time_range.start, e.time_range.end, e.name[len("chain."):])
                    for e in events if e.device_type == DeviceType.CPU
                    and e.name.startswith("chain.") and e.name[len("chain."):] in PHASES)
    starts = [r[0] for r in ranges]
    # runtime calls (cudaLaunchKernel, cudaMemcpyAsync, ...) share their
    # device item's correlation id
    launch = {e.id: e.time_range.start for e in events
              if e.device_type == DeviceType.CPU and e.name.startswith("cu")}
    host = dict.fromkeys(PHASES, 0.0)
    dev = dict.fromkeys(PHASES + ("other",), 0.0)
    for t0, t1, name in ranges:
        host[name] += (t1 - t0) / 1e3 / iters
    for e in events:
        if e.device_type != DeviceType.CUDA or e.is_user_annotation:
            continue
        t = launch.get(e.id)
        i = bisect.bisect_right(starts, t) - 1 if t is not None else -1
        name = ranges[i][2] if i >= 0 and t <= ranges[i][1] else "other"
        dev[name] += e.time_range.elapsed_us() / 1e3 / iters
    return host, dev


def phase_train_throughput(np, torch, fx, card):
    """Full-width train steps (TDNN-F 1024 + VQ-48, NG on, f32) at B=16 and
    B=64 x 3 s: ms per step and audio-seconds per second (host clock,
    unprofiled), peak memory, then a profile of as many steps for the step's
    phase split (host ms, device ms), busy share and launch count, the top
    device items at B=16, and the den kernels timed alone at the same
    shapes. The profile is informational: nothing read from it can fail."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from satpu_torch import infer_helper
    from satpu_torch.chain import den_fb
    from satpu_torch.chain.fst import Fst
    from satpu_torch.chain.objf import DenominatorGraph
    from satpu_torch.chain.trainer import ChainTrainer

    den = DenominatorGraph.from_fst(Fst.read(fx["den_fst"]), NUM_PDFS)
    g = den.tensors("cuda")
    lk = den_fb.leak_log(1e-5)
    for B, iters in ((16, 8), (64, 4)):  # multiples of 4: NG update steps in proportion
        model = infer_helper.build_model("asrbn_tdnnf", device="cuda", seed=0, **TRAIN_NET)
        trainer = ChainTrainer(model, den, lr_schedule=lambda step: 1e-3)
        batch = chain_batch(torch, fx, B, "cuda")
        for _ in range(2):  # warm-up (the first is an NG subspace-update step)
            trainer.step(*batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(iters):
            metrics = trainer.step(*batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / iters
        check(bool(torch.isfinite(metrics["loss"])), f"loss not finite at B={B}")
        peak = torch.cuda.max_memory_allocated() / 2**30
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                trainer.step(*batch)
            torch.cuda.synchronize()
        host, dev = train_split(prof, iters)
        rows = [(e.self_device_time_total / iters, e.count // iters, e.key)
                for e in prof.key_averages() if e.device_type == DeviceType.CUDA
                and not e.is_user_annotation and e.self_device_time_total > 0]
        busy = sum(r[0] for r in rows) / 1e3
        # the den kernels alone at this step's shapes (inside objective_*)
        with torch.no_grad():
            co = model(batch[0], generator=trainer.generator)[0]
        llf, lls = (co.index_select(-1, g[k]).contiguous() for k in ("pdf_fwd", "pdf_self"))
        a0 = g["start"].expand(B, den.num_states).contiguous()
        graph = (g["A"], g["log_self"], g["log_init"])
        alphas = den_fb.den_fb_forward(llf, lls, a0, *graph, lk)
        g_final = torch.ones_like(a0)
        k2f = cuda_ms(torch, lambda: den_fb.den_fb_forward(llf, lls, a0, *graph, lk), iters=5)
        k2b = cuda_ms(torch, lambda: den_fb.den_fb_backward(g_final, alphas, llf, lls, *graph,
                                                             lk), iters=5)
        audio = B * EG_SECONDS
        print(f"[train-throughput] B={B} x {EG_SECONDS} s, tdnnf_vq 1024, NG on, f32:"
              f" {wall * 1e3:.1f} ms/step (host clock), {audio / wall:.1f} audio-s/s; peak mem"
              f" {peak:.2f} GiB [{card}]")
        print(f"[train-throughput]   profiled split ms/step, host / device: "
              + ", ".join(f"{k} {host[k]:.2f} / {dev[k]:.2f}" for k in host)
              + f", other - / {dev['other']:.2f}; device {busy:.2f} ms ="
              f" {busy / (wall * 1e3):.0%} busy of the unprofiled step,"
              f" {sum(r[1] for r in rows)} launches; K2f alone {k2f:.2f}, K2b alone {k2b:.2f}")
        if B == 16:
            for dev_us, count, key in sorted(rows, reverse=True)[:12]:
                print(f"[train-profile]   {dev_us / 1e3:8.2f} ms {dev_us / 1e3 / busy:5.1%}"
                      f" x{count:<5d} {key[:90]}")
        del trainer, model, batch, prof


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on the card",
              file=sys.stderr)
        return 1
    import numpy as np

    # f32 checks are f32: no TF32 in matmuls or cuDNN convs
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"[card] {torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}, torch"
          f" {torch.__version__}, CUDA {torch.version.cuda} [{card}]")
    t_start = time.perf_counter()
    phase_build()
    # serving: anonymize (kernel K1)
    entries = [phase_kernel(np, torch)]
    launches, ckpt = phase_slice(np, torch)
    phase_cpu(np, torch, ckpt)
    phase_throughput(torch, ckpt, card)
    phase_profile(torch, ckpt, card)
    # chain training: train_asr (kernels K2f, K2b)
    entries += phase_den_kernel(np, torch, den_graph())
    train_launches, fx = phase_train(np, torch)
    launches.update(train_launches)
    phase_train_cpu(np, torch)
    phase_train_throughput(np, torch, fx, card)
    for entry in entries:
        entry["launches"] = launches[entry["name"]]
    shutil.rmtree(WORK, ignore_errors=True)
    print(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": entries}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
