#!/usr/bin/env python3
"""On-card smoke test of satpu_torch, the PyTorch/CUDA port of satpu.

Phases (each prints its lines; any failure exits non-zero with no result):

1. build: compiles every CUDA kernel of the serving path from
   satpu_torch/csrc with nvcc (sm_90a);
2. kernel: holds each kernel against its plain PyTorch version at the
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
   the device's busy share of each call.

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


def phase_build():
    from satpu_torch.utils import cuda_build

    t0 = time.perf_counter()
    path, log = cuda_build.build("shc", force=True)
    secs = time.perf_counter() - t0
    usage = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
    print(f"[build] csrc/shc.cu -> {os.path.relpath(path, ROOT)} in {secs:.2f} s (nvcc sm_90a)")
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

    def bound(frames):
        bytes_ms = frames * (M + I) * 4 / HBM_BYTES_PER_S * 1e3
        ops_ms = frames * I * J * H / F32_FLOPS_PER_S * 1e3
        return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")

    # time on inputs that do not stay in the 50 MB L2: cycle 4 copies
    bufs = [torch.rand((n_frames, M), generator=gen, device="cuda") for _ in range(4)]
    it = iter(range(1 << 30))
    ms = cuda_ms(torch, lambda: Y.shc_band(bufs[next(it) % 4], *args), iters=200)
    plain_ms = cuda_ms(torch, lambda: Y.shc_band_plain(bufs[0], *args), iters=5, warmup=1)
    big = torch.rand((8 * n_frames, M), generator=gen, device="cuda")  # B=128 x 10 s
    ms_big = cuda_ms(torch, lambda: Y.shc_band(big, *args), iters=50)
    b, by = bound(n_frames)
    b_big, _ = bound(8 * n_frames)
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
    entry = phase_kernel(np, torch)
    launches, ckpt = phase_slice(np, torch)
    entry["launches"] = launches[entry["name"]]
    phase_cpu(np, torch, ckpt)
    phase_throughput(torch, ckpt, card)
    phase_profile(torch, ckpt, card)
    shutil.rmtree(WORK, ignore_errors=True)
    print(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [entry]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
