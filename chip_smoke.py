#!/usr/bin/env python3
"""On-card smoke test of satpu_torch, the PyTorch/CUDA port of satpu.

Phases (each prints its lines; any failure exits non-zero with no result):

1. build: compiles every CUDA kernel from satpu_torch/csrc with nvcc
   (sm_90a), one nvcc per source, all started together;
2. kernel: holds the SHC kernel against its plain PyTorch version at the
   serving path's shapes (random and real YAAPT inputs at 8000, 16000 and
   64000 frames, two calls bitwise equal) and times it at each; then the
   Viterbi kernel (K4) against its plain version, bitwise, at B=32 and each
   serving rung's frames for dynamic5's 4 candidates and dynamic_final's 6,
   one launch a call, timed beside the plain loop, and a B=32 get_f0 with
   the kernel and with the plain loop;
3. slice: builds the flagship anonymizer at full width (TDNNF 1024 + VQ-48,
   3280 outputs, 247 speakers, HiFi-GAN 512, bf16 serving policy; random
   weights from a seed), saves it, and runs the ``anonymize`` CLI on the
   card over a synthetic kaldi dir of 8 voiced utterances (2-10 s); checks
   every written wav, that the main path launched every kernel, and the
   card's F0 against the known contours;
4. cpu: the card against the port's own CPU path at f32 (TF32 off) on one
   2 s utterance, for get_f0 and convert;
5. den kernel: holds the LF-MMI den forward (K2f) and backward (K2b)
   kernels against their plain versions at the training path's shapes (the
   full-scale den graph of 1641 states, B=16, T=99) on random loglikes and
   on the full-width network's chain output, and on a 4001-state graph
   whose arcs do not fit shared memory (B=4, T=20); checks that two calls
   give the same bits and that a call is one kernel launch in a profiler
   trace, and times them; then the numerator forward (K3f) and backward
   (K3b) kernels against their plain versions at the chain cell's shapes
   (B=16, T = 247 and 661, its random-walk numerators): the same checks,
   each timed beside its plain version, and a training step's numerator
   (one call) against the three plain passes it replaced;
6. train: builds a chain fixture (den graph, numerator FSTs, 32 + 16
   synthetic 3 s egs) and runs the ``train_asr`` CLI on the card for 4 steps
   of the full-width TDNN-F + VQ-48 with natural gradient; checks the
   logged objf, that every step launched both den kernels and both
   numerator kernels, and that
   final.ckpt serves as an ``asrbn_tdnnf`` extractor;
7. train-cpu: one tiny train step on the card against the port's CPU path;
8. train-throughput: full-width train steps at B=64 x 3 s, then a profile
    of as many steps: the step's phases (the trainer's profiler ranges) and
    the busy share (B=16 is the benchmark's ``chain_libri100_b16``);
9. eval: the ``eval_anon`` CLI on the card over the slice phase's
    anonymized dir (original-enrol / anonymized-trial: 8 target and 16
    non-target trials), with a full-width ``tdnnf`` ASR model (1024 wide,
    3280 pdfs, f32) decoding a word-bigram graph built over the den graph's
    3280-pdf biphone tree, and a full-width ECAPA x-vector model (chunked
    x-vectors, the ArcMargin centres as AS-norm cohort); checks the
    results, that the native decoder decoded every utterance, and the card
    against the port's CPU path at f32 (the same hyps, loglikes rel <= 1e-3,
    x-vector cosine >= 0.9999, the same trial ranking);
10. eval-throughput: x-vector extraction (chunked, B=64 windows of 3 s) and
    loglikes (B=32 x 10 s) in audio-seconds per second with their busy
    shares, and the host decoder's milliseconds per audio-second at beam
    16 / lattice beam 8, one thread and a thread pool;
11. gan: the ``train_vc`` CLI on the card at full width
    (egs/vc/libritts/configs/hifigan.ini: generator 512 over the flagship's
    247 speakers, full MPD and MSD, B=32, segment 16320, f32; cuDNN's
    deterministic conv algorithms, the CLI's default) for one epoch
    over 247 synthetic voiced utterances (1.1-1.6 s, one a speaker) with a
    dev dir of 32, the frozen flagship extractor's F0 through the SHC
    kernel; checks every step's metrics, that the warm-up launched the
    kernel, the checkpoint triplet, g_best and the validation error, and
    that the ``anonymize`` CLI serves the written generator;
12. gan-cpu: one tiny GAN step on the card against the port's CPU path;
13. gan-throughput: the ops of a GAN step that torch calls
    nondeterministic; full-width GAN steps from a fixed batch, B=32 f32 and
    B=128 bf16 at segment 16320: ms per step with cuDNN's default and its
    deterministic conv algorithms, audio-seconds per second, peak memory,
    then a profile of as many steps: the step's phases (the trainer's
    profiler ranges), the busy share and the top device items;
14. asv: the ``train_asv`` CLI on the card with
    egs/asv/voxceleb/configs/ecapa.ini's widths and batch (ECAPA 512, B=1024
    = 16 speakers x 64, 3 s, f32, SpecAugment, batch statistics) for 2
    epochs over 16 synthetic speakers x 4 voiced utterances of 3.5-6 s;
    checks every epoch's loss and validation EER, the checkpoints, best.ckpt
    and the metrics log, and that best.ckpt loads on the card and embeds the
    validation chunks;
15. asv-cpu: one tiny ECAPA step and one tiny half-ResNet step on the card
    against the port's CPU path (loss, gradients, batch-norm statistics);
16. asv-throughput: full-width ECAPA steps from a fixed batch of 3 s with the
    head over 5994 speakers, B=1024 f32, B=1024 bf16 and B=128 f32: ms per
    step, audio-seconds per second, peak memory, then a profile of as many
    steps: the ``asv.<phase>`` split, the busy share and the top device
    items;
17. fbank: the port's fbank (+ CMVN) on the card against the CPU on the
    slice phase's anonymized wavs and its voiced inputs, both against the
    same fbank in f64 on the host;
18. w2v2-train: the ``prepare_data`` CLI (prepare_data.ini: grapheme
    lexicon, speed perturbation) over 32 voiced utterances of 3 s, then the
    ``train_asr`` CLI with egs/asr/librispeech/configs/
    tdnnf_wav2vec2_vq_48.ini at full width, cut in depth by
    ``--wav2vec2-layers CUT_LAYERS`` (wav2vec2 large at CUT_LAYERS of its
    24 layers, TDNN-F 1024, VQ-48, B=16, f32, NG on) for 4
    steps on prepare_data's den graph,
    normalization FST and egs: the logged objf, K2f/K2b launched every step,
    final.ckpt served on the card by ``infer_helper.load_model`` with
    finite ``extract_bn`` features and VQ indices in range; then 2 steps
    each of the same net under the bf16 training policy and of
    tdnnf_spkadv.ini;
19. w2v2-cpu: one tiny wav2vec2-VQ step and one tiny speaker-adversarial
    step on the card against the port's CPU path (loss, gradients in
    relative L2, batch-norm statistics);
20. w2v2-den: K2f/K2b held against their plain versions (bitwise on
    repeat) on the chain output of the full-width B5 extractor (CUT_LAYERS
    layers) after two f32 train steps from a fixed batch of B=16 x 3 s at
    3280 pdfs on the 1641-state den graph (its speed is the benchmark's
    ``chain_w2v2_libri100_b16``, at 24 layers);
21. wavlm-eval: the ``asv_xvector`` WavLM-large + ECAPA-512 judge (its
    transformer cut to CUT_LAYERS of 24 layers of 1024, relative position
    buckets, ECAPA on its 1024-wide
    weighted layer sum; random weights from seed 0, batch norms
    calibrated) saved, and the ``eval_anon`` CLI on the card over the slice
    phase's dirs (24 trials), then on the CPU: every x-vector (cosine >=
    0.9999), the trial ranking and the EER held card against CPU;
22. wavlm-throughput: that judge's chunked x-vectors at B=64 x 3 s, f32:
    audio-seconds per second, busy share, launches, peak memory, top items;
23. wavlm-train: ASV train steps of the judge with the head over 5994
    speakers, B=64 x 3 s (halved until it fits), f32 and bf16 (satpu's
    policy, the WavLM front included): ms per step, the ``asv.<phase>``
    split, busy share, peak memory, top items; then a small-width step
    held card against the CPU (10x the CPU f32's own departure from f64);
24. distribution: a reference-format ``final.pt`` of the flagship's
    weights through the ``import_model`` CLI into a fresh zoo, then
    ``hub.load(tag + "+f0-transformation=quant_16")`` on the card (convert
    held against the original checkpoint's), then ``anonymize --num-procs
    2`` with the zoo checkpoint against one process (the same wavs, each of
    its input's length, within bf16 serving's 2e-2), and a run whose shards
    cannot start exits non-zero;
25. dp-train: data parallelism on the one card. The ``train_asr``,
    ``train_asv`` and ``train_vc`` CLIs under ``torch.distributed.run
    --nproc-per-node 1`` (NCCL) with the arguments of phases 6, 14 and 11,
    their logged losses against those runs' (rel 1e-3), and ``train_vc``
    again without a group: its logged values and g_best.ckpt bitwise phase
    11's; each trainer's step (TDNN-F B=16, ECAPA-512 B=128 over 5994
    speakers, the GAN at B=32) from seed 0 without and with a one-rank
    NCCL group: ms per step, the sync ranges' split, the first losses;
    then two gloo ranks on cuda:0 (CUDA tensors),
    each on half of every global batch, against one rank on the global
    batches for 2 steps of each trainer (the networks in f64, the GAN at
    B=8): losses rel 1e-5, every tensor of the states rel 1e-4 in relative
    L2, rank 1 equal to rank 0, K2f/K2b launched in every chain step (a correctness
    check: gloo stages through the host);
26. serve-mesh: ``anonymize --serve-mesh true`` on the card bitwise the run
    without the flag (one device runs unsharded), and ``process_data`` over
    [cuda:0, cuda:0] (each batch in two blocks) within 1e-6 of the
    unsharded run, K1 launched once per block;
27. export: ``hub.export_convert`` of the flagship (bf16 serving) at B=2 x
    2 s, loaded with ``torch.export.load`` in a fresh process that imports
    only the SHC op's registration and run there: export and load times,
    K1's launches inside the program, its departure from eager, and
    audio-seconds per second exported and eager;
28. surface: fault 4 (ECAPA's batch norm in training at |mean|/std = 1e4
    without a group, in one-rank NCCL and gloo groups and two gloo ranks on
    cuda:0, against f64) and the ECAPA-512 B=128 step's cost of the
    two-pass moments; the eval phase's judge under the reference sidekit's
    names through ``convert_sidekit`` and ``eval_anon`` (x-vectors
    bitwise, the same results and ranking); ``global_cmvn``, ``CMVN`` and
    ``AdaptivePCMN`` card vs CPU; the flagship generator with
    ``bf16_min_channels=128`` served at B=32 x 10 s beside uniform bf16;
    ``hub.load(..., load_weight=False)`` on the card.

The line before the last is the card's name and power limit from
nvidia-smi; the last line is the run's JSON verdict. Needs one CUDA card.

Usage (from the repository root):  python3 chip_smoke.py
``python3 chip_smoke.py --kernel-only NAME`` runs one kernel source's build
and its kernel phase alone, then prints the kernels line with the launches
that phase made: ``shc`` (K1; to time another tree's SHC kernel with the
same phase, run this file from that tree's root), ``viterbi`` (K4, its part
of phase 2) or ``num_fb`` (K3f/K3b, their part of phase 5).

``python3 chip_smoke.py --cards N`` is the multi-card run (satpu's
``dryrun_multichip``; N = 4 on a four-H100 host; it refuses with exit 1
when fewer than N cards are visible). After the build it runs only: K1 and
K2f/K2b on every card with another card current (against their plain
versions, bitwise on repeat, one launch a call on the tensors' card,
timed on each card); the slice, train and asv phases and the gan phase's
data (the one-card runs the rest is held against); data parallelism over
N NCCL ranks (the f64 check against one process, with controls that say
where the chain's runs part; each trainer's f32 step a card alone and in
the N ranks with the scaling efficiency; the three training CLIs under
``torch.distributed.run --nproc-per-node N`` against one process on the
same global batches); ``anonymize --device cuda:1``,
``anonymize --serve-mesh true`` and ``process_data`` over the N cards,
then the flagship bf16 at B=128 x 10 s split over them; the eval phase and
``eval_anon --serve-mesh true``; the exported anonymizer on cuda:1. Each
path prints a ``[time]`` line; the last two lines are the ones above.
``--cards N --only PARTS`` runs the parts named (a comma list of
CARD_PARTS: kernels, f64, speed, clis, serve, eval, export).
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import re
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
KERNEL_SOURCES = ("shc", "den_fb", "num_fb", "viterbi")
# chain training: the full-scale den graph (a 164-phone bigram, 9 successors
# each: 3280 pdfs, 1641 states) and 3 s egs (99 output frames)
DEN_PHONES, DEN_SUCC, NUM_PDFS, DEN_STATES = 164, 9, 3280, 1641
EG_SECONDS, EG_FRAMES = 3.0, 99
# a den graph whose arcs do not fit a block's shared memory (4001 states)
BIG_DEN = (400, 9, 4, 20)  # phones, successors, B, T
# the numerator kernels at the chain cell's shapes (portbench's
# chain_libri100_b16): B=16 numerators of random phone walks of the den
# graph's bigram, a third of the output frames long, at the shortest and the
# longest of its 12 allowed lengths
NUM_SHAPES = ((16, 247), (16, 661))
# the 4-step train_asr run's objf with the earlier den kernels (one launch
# per frame, products dense over A), measured on an H100
PER_FRAME_OBJF = [-1.8248, -1.4224, -1.3493, -1.3041]
TRAIN_NET = {"output_dim": NUM_PDFS, "bottleneck": "vq", "codebook_size": 48,
             "natural_gradient": True}
# the train-cpu phase: a tiny TDNN-F over a 5-phone den graph (40 pdfs)
TINY_NET = {"output_dim": 40, "hidden_dim": 32, "bottleneck_dim": 16,
            "prefinal_bottleneck_dim": 16, "bottleneck": "vq", "codebook_size": 8,
            "natural_gradient": True, "p_dropout": 0.0}
# evaluation: egs/asr/librispeech/configs/tdnnf_asr_eval.ini (model = tdnnf)
EVAL_ASR = {"output_dim": NUM_PDFS, "bottleneck": "none"}
# the decoding graph's vocabulary: words are 3-6 phone walks of the den
# graph's bigram; the word bigram is estimated from random sentences
EVAL_WORDS, EVAL_SENTENCES = 60, 200
# GAN training: the reference recipe's config; one utterance for each of the
# flagship's 247 speakers (8 steps at B=32) and a dev dir of 32 (one
# validation batch)
GAN_CONFIG = "egs/vc/libritts/configs/hifigan.ini"
GAN_SEGMENT, GAN_DEV = 16320, 32
# ASV training: the reference recipe's config (B=1024 = 16 speakers x 64) over
# 16 synthetic speakers; the throughput head spans VoxCeleb2 dev's speakers
ASV_CONFIG = "egs/asv/voxceleb/configs/ecapa.ini"
ASV_SPEAKERS, ASV_HEAD = 16, 5994
# the ASR-BN variants: chain data prep and the B5 extractor's recipe (wav2vec2
# large + TDNN-F 1024 + VQ-48), and the speaker-adversarial net's
W2V2_PREP_CONFIG = "egs/asr/librispeech/configs/prepare_data.ini"
W2V2_CONFIG = "egs/asr/librispeech/configs/tdnnf_wav2vec2_vq_48.ini"
SPKADV_CONFIG = "egs/asr/librispeech/configs/tdnnf_spkadv.ini"
# the B5 front (wav2vec2 large) and the WavLM-large judge run at CUT_LAYERS of
# their 24 transformer layers, every width kept, to keep the script within
# its time limit: their full-depth rates stand in PERF.md section 5
CUT_LAYERS = 4
# the WavLM-large + ECAPA-512 judge (XVectorConfig's defaults otherwise; the
# front's config in wavlm_asv()), the small one of the card-vs-CPU step, and
# the distribution phase's zoo tag
WAVLM_TINY = {"frontend": "wavlm", "num_speakers": 10, "channels": 32, "embedding_size": 16,
              "wavlm": {"conv_dim": [16, 16, 16], "conv_kernel": [10, 8, 4],
                        "conv_stride": [5, 8, 8], "hidden_size": 32, "num_hidden_layers": 2,
                        "num_attention_heads": 4, "intermediate_size": 64,
                        "num_conv_pos_embeddings": 16, "num_conv_pos_embedding_groups": 4,
                        "num_buckets": 32, "max_bucket_distance": 50,
                        "feat_extract_norm": "layer", "conv_bias": True}}
DIST_TAG = "hifigan_bn_tdnnf_600h_vq_48_v1"
# scale-out: the steps of the data-parallel check, the exported program's shapes
DP_STEPS, DP_LR = 2, 1e-3
DP_GAN_BATCH = 8  # the f64 GAN of the data-parallel checks (4 a rank of two, 2 of four)
EXPORT_BATCH, EXPORT_SECONDS = 2, 2


def wavlm_asv():
    """The WavLM judge's build parameters: WavLM-large at CUT_LAYERS layers
    into ECAPA-512."""
    from satpu_torch.models.wavlm import WavLMConfig

    front = dataclasses.replace(WavLMConfig.large(), num_hidden_layers=CUT_LAYERS)
    return {"frontend": "wavlm", "wavlm": dataclasses.asdict(front)}


def w2v2_cut():
    """The B5 front at CUT_LAYERS layers: wav2vec2 large's config, which
    train_asr builds with ``--wav2vec2-layers CUT_LAYERS``."""
    from satpu_torch.models.wav2vec2 import Wav2Vec2Config

    return dataclasses.replace(Wav2Vec2Config.large(), num_hidden_layers=CUT_LAYERS)


def kernel_launches(kernel: str) -> int:
    """The launches of ``kernel`` (``k1``, ``k2f``, ``k2b``, ...) the port has
    counted so far in this process (``satpu_torch.utils.trace.counters``)."""
    from satpu_torch.utils import trace

    return trace.counters().get(kernel + ".launches", 0)


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


def phase_build(sources=KERNEL_SOURCES):
    """Every kernel source, one nvcc each, all started together."""
    from concurrent.futures import ThreadPoolExecutor

    from satpu_torch.utils import cuda_build

    def build(name):
        t0 = time.perf_counter()
        path, log = cuda_build.build(name, force=True)
        return name, path, log, time.perf_counter() - t0

    with ThreadPoolExecutor(len(sources)) as pool:
        built = list(pool.map(build, sources))
    for name, path, log, secs in built:
        print(f"[build] csrc/{name}.cu -> {os.path.relpath(path, ROOT)} in {secs:.2f} s"
              " (nvcc sm_90a)")
        usage = {}  # kernel -> its register and spill lines, in ptxas' order
        kernel = "?"
        for ln in log.splitlines():
            entry = re.search(r"Compiling entry function '(\w+)'", ln)
            if entry:
                kernel = kernel_name(entry.group(1))
            elif "registers" in ln or "spill" in ln:
                usage.setdefault(kernel, []).append(ln.split(":", 1)[-1].strip())
        for kernel, lines in usage.items():
            print(f"[build] ptxas: {kernel}: {'; '.join(lines)}")


def kernel_name(mangled: str) -> str:
    """A kernel's name and template arguments (den_fwd<2, 1>) from its
    mangled name in a namespace (_ZN<len><namespace><len><name>I...E...);
    else the mangled name."""
    m = re.match(r"_ZN(\d+)", mangled)
    rest = mangled[m.end() + int(m.group(1)):] if m else ""
    n = re.match(r"(\d+)", rest)
    if not n:
        return mangled
    end = n.end() + int(n.group(1))
    args = re.match(r"I((?:L[ib]\d+E)+)E", rest[end:])
    return rest[n.end():end] + (
        f"<{', '.join(re.findall(r'L[ib](\d+)E', args.group(1)))}>" if args else "")


def shc_wavefronts(lib, M: int, I: int, H: int, J: int):
    """Shared-memory wavefronts an output of csrc/shc.cu, by a model of its
    design over the phase layout the built library ``lib`` reports
    (``satpu_shc_layout``): {part: wavefronts}. A warp's access of 4/8/16
    bytes a lane is 1/2/4 wavefronts without conflicts; a scalar store with k
    lanes on one bank is k."""
    import ctypes

    words = (ctypes.c_int * (3 * H + 1))()
    check(lib.satpu_shc_layout(I, H, J, words) == 0, "satpu_shc_layout")
    pitches, lens = words[1:3 * H:3], words[2:3 * H:3]
    Q = -(-I // 4)

    def store_ways(s, p, w, i):  # a warp's i-th scalar store of harmonic s
        banks = [((e % s) * p + e // s) % 32 for e in (4 * (32 * w + l) + i for l in range(32))]
        return max(banks.count(b) for b in set(banks))

    taps = sum((3 + -(-(J - rho) // s) + 3) // 4 for s in range(1, H + 1) for rho in range(s))
    deint = 0.0  # per frame, averaged over the frame's offset in its float4
    for s, p, n in zip(range(1, H + 1), pitches, lens):
        for w in range(-(-s * n // 128)):  # warp steps of 32 threads x 4 elements
            reads = 4 * (1 + 3 / 4)  # one float4 read, two for 3 of 4 offsets
            stores = 4 if s < 3 else sum(store_ways(s, p, w % s, i) for i in range(4))
            deint += reads + stores
    raw, outs = M / 32, Q / 8 + I / 32  # cp.async writes; outputs staged and read back
    return {"taps": taps / 32, "deinterleave": deint / I, "copy": raw / I, "outputs": outs / I}


def phase_kernel(np, torch):
    """SHC band kernel vs its plain version at F = 8000 (16 utterances of
    10 s), 16000 and 64000 frames (the B=32 and B=128 x 10 s serving
    batches), on random and real YAAPT input, two calls bitwise equal, then
    timed at each F. Returns the kernel's JSON entry at F = 8000 (its
    ``launches`` set by the caller)."""
    import torch.nn.functional as F

    from satpu_torch.models.anonymizer import YAAPT_OPTS
    from satpu_torch.ops import yaapt as Y
    from satpu_torch.utils import cuda_build

    p = Y._merged_params(YAAPT_OPTS)
    to_pad, frame_size, frame_jump, nfft = Y.frame_geometry(p)
    g = Y.shc_params(nfft, p)
    args = (g["min_shc"], g["n_out"], g["n_harm"], g["window_length"])
    M, I, H, J = g["top_bin"] + g["half_window"], g["n_out"], g["n_harm"], g["window_length"]

    # real input: the SHC magnitudes of 16 synthetic voiced 10 s utterances,
    # repeated to the larger batches
    x = np.stack([voiced_utterance(np, 10.0, 100.0 + 10 * k, seed=k)[0] for k in range(16)])
    xp = F.pad(torch.from_numpy(x).cuda(), (to_pad, to_pad))
    nl = Y.bandpass(xp ** 2, p["sr"], p["bp_low"], p["bp_high"])
    real16 = Y.shc_magnitude(nl, Y.num_frames(x.shape[1], p), frame_size, frame_jump, nfft, p)
    n_frames = real16.shape[0]  # B=16 x 10 s -> 8000 frames
    gen = torch.Generator(device="cuda").manual_seed(0)

    def shc_bound(frames):  # mag's columns from min_shc on in, shc out; J x H products an output
        return bound(frames * I * J * H, frames * (M - g["min_shc"] + I) * 4)

    # the design's model (an older tree's kernel, timed with this file from
    # that tree's root, has no layout to model)
    lib = cuda_build.load("shc")
    wf = shc_wavefronts(lib, M, I, H, J) if hasattr(lib, "satpu_shc_layout") else None
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = float(subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=clocks.max.sm",
                                "--format=csv,noheader,nounits"],
                               capture_output=True, text=True, check=True).stdout.split()[0])
    if wf:
        print(f"[kernel] shc_band design model: {sum(wf.values()):.3f} shared-memory wavefronts"
              " an output (" + ", ".join(f"{k} {v:.3f}" for k, v in wf.items())
              + f"); one wavefront a clock on {sms} SMs at {mhz:.0f} MHz")
    worst, timed = 0.0, {}
    for rep, iters in ((1, 200), (2, 100), (8, 50)):
        frames = rep * n_frames
        inputs = (("random", torch.rand((frames, M), generator=gen, device="cuda")),
                  ("yaapt", real16.repeat(rep, 1)))
        for name, mag in inputs:
            out = Y.shc_band(mag, *args)
            again = Y.shc_band(mag, *args)
            ref = Y.shc_band_plain(mag, *args)
            torch.cuda.synchronize()
            max_abs = (out - ref).abs().max().item()
            rel = max_abs / ref.abs().max().item()
            same = bool(torch.equal(out, again))
            worst = max(worst, max_abs)
            print(f"[kernel] shc_band vs plain, {name} mag [{frames} x {M}] -> [{frames} x {I}]:"
                  f" max abs err {max_abs:.3e}, rel {rel:.3e} (tolerance rel 1e-5); two calls"
                  f" bitwise equal: {same}")
            check(rel <= 1e-5, f"shc_band disagrees with its plain version on {name} input")
            check(same, f"two shc_band calls differ on {name} input")
            del out, again, ref
        del inputs, mag
        # time on inputs that do not stay in the 50 MB L2: cycle copies of
        # at least 150 MB together
        n_bufs = -(-150_000_000 // (frames * M * 4))
        bufs = [torch.rand((frames, M), generator=gen, device="cuda") for _ in range(n_bufs)]
        it = iter(range(1 << 30))
        ms = cuda_ms(torch, lambda: Y.shc_band(bufs[next(it) % n_bufs], *args), iters=iters)
        b, by = shc_bound(frames)
        timed[frames] = (ms, b, by)
        floor = (f"; modelled shared-memory floor {frames * I * sum(wf.values()) / sms / mhz:.1f}"
                 " us" if wf else "")
        print(f"[kernel] shc_band F={frames}: {ms * 1e3:.1f} us (bound {b * 1e3:.1f} us by {by},"
              f" {b / ms:.1%} of it{floor}), {n_bufs} input copies cycled")
        if rep == 1:
            plain_ms = cuda_ms(torch, lambda: Y.shc_band_plain(bufs[0], *args), iters=5, warmup=1)
            print(f"[kernel] shc_band_plain F={frames}: {plain_ms * 1e3:.1f} us")
        del bufs
    # the wrapper's host time a call: 4-frame calls (one group, a kernel of a
    # few us) back to back, so the host sets the pace
    small = torch.rand((4, M), generator=gen, device="cuda")
    Y.shc_band(small, *args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(2000):
        Y.shc_band(small, *args)
    torch.cuda.synchronize()
    print(f"[kernel] shc_band host time: {(time.perf_counter() - t0) / 2000 * 1e6:.2f} us a call"
          " (wall clock over 2000 calls at F=4)")
    ms, b, by = timed[n_frames]
    return {"name": "shc_band", "route": "cuda", "source": "satpu_torch/csrc/shc.cu",
            "replaces": "satpu/ops/yaapt.py:588", "max_abs_err": worst,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b, "bound_by": by, "library_ms": None}


def viterbi_inputs(np, torch, B: int, C: int, T: int, seed: int):
    """(local [B, C, T], trans [B, C, C, T]) on the card as dynamic5 builds
    them: uniform costs up to a random number of valid frames a row (every
    frame in row 0), then zero local cost and identity transitions, INF
    elsewhere."""
    rng = np.random.default_rng(seed)
    local = rng.random((B, C, T), dtype=np.float32)
    trans = rng.random((B, C, C, T), dtype=np.float32) * 3
    eye = np.eye(C, dtype=bool)[:, :, None]
    for b, n in enumerate([T] + list(rng.integers(0, T + 1, B - 1))):
        local[b, :, n:] = 0.0
        trans[b, :, :, n:] = np.where(eye, 0.0, 1e30)
    return torch.from_numpy(local).cuda(), torch.from_numpy(trans).cuda()


def phase_viterbi_kernel(np, torch):
    """K4 against its plain version at B=32 and the frames of every serving
    rung (and a 35 s utterance's 1750), for C = 4 (dynamic5) and 6
    (dynamic_final, its trans a transposed view as there): paths bitwise
    equal, one launch a call in a profiler trace, each shape timed beside
    the plain loop on the card; the wrapper's host time a call; then a B=32
    x 10 s get_f0 with K4 and with the plain loop. Returns K4's JSON entry at
    C = 6, T = 1000 (its ``launches`` set by the caller)."""
    from satpu_torch.bin.pipeline import DEFAULT_BUCKETS
    from satpu_torch.models.anonymizer import YAAPT_OPTS
    from satpu_torch.ops import yaapt as Y

    p = Y._merged_params(YAAPT_OPTS)
    frames = [Y.num_frames(n, p) for n in DEFAULT_BUCKETS] + [1750]
    B, timed = 32, {}
    for C in (4, 6):
        for T in frames:
            local, trans = viterbi_inputs(np, torch, B, C, T, seed=T + C)
            if C == 6:
                trans = trans.transpose(1, 2).contiguous().transpose(1, 2)
            out = Y.viterbi_path_op(local, trans)
            same = bool(torch.equal(out, Y.viterbi_path_op(local, trans)))
            plain = Y.viterbi_path_plain(local.cpu(), trans.cpu())
            check(bool(torch.equal(out.cpu(), plain)),
                  f"K4 and the plain Viterbi part at C={C} T={T}")
            check(same, f"two K4 calls differ at C={C} T={T}")
            ms = cuda_ms(torch, lambda: Y.viterbi_path_op(local, trans), iters=50)
            plain_ms = cuda_ms(torch, lambda: Y.viterbi_path_plain(local, trans), iters=3,
                               warmup=1)
            # trans and local read once, the path written
            b, by = bound(0, B * (C * C + C) * T * 4 + B * T * 8)
            timed[C, T] = (ms, plain_ms, b, by)
            print(f"[kernel] viterbi_path K4 B={B} C={C} T={T}: {ms * 1e3:.1f} us ="
                  f" {ms * 1e6 / T:.1f} ns a frame (bound {b * 1e3:.2f} us by {by}, {b / ms:.2%}"
                  f" of it; the T dependent frames bound it in fact); plain loop on the card"
                  f" {plain_ms * 1e3:.1f} us; bitwise equal to plain: True")
    per_call = launches_per_call(torch, (("viterbi_kernel",
                                          lambda: Y.viterbi_path_op(local, trans)),))
    check(per_call == [1], f"a K4 call is not one launch: {per_call}")
    # the wrapper's host time a call: T = 1 calls back to back, so the host
    # sets the pace
    small = viterbi_inputs(np, torch, B, 6, 1, seed=0)
    Y.viterbi_path_op(*small)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(2000):
        Y.viterbi_path_op(*small)
    torch.cuda.synchronize()
    print(f"[kernel] viterbi_path host time: {(time.perf_counter() - t0) / 2000 * 1e6:.2f} us a"
          " call through the registered op (wall clock over 2000 calls at T=1)")

    # get_f0 of a B=32 x 10 s batch with K4 and with the plain loop
    x = np.stack([voiced_utterance(np, 10.0, 100.0 + 5 * k, seed=k)[0] for k in range(B)])
    x = torch.from_numpy(x).cuda()
    n0 = kernel_launches("k4")
    f0 = Y.yaapt_batch(x, p)
    check(kernel_launches("k4") - n0 == 2, "a yaapt_batch is not two K4 launches")
    walls, op = [], Y.viterbi_path_op
    try:
        for fn in (op, Y.viterbi_path_plain):
            Y.viterbi_path_op = fn
            out = Y.yaapt_batch(x, p)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(5):
                Y.yaapt_batch(x, p)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) / 5 * 1e3)
            check(bool(torch.equal(out, f0)), "get_f0 with K4 and with the plain loop differ")
    finally:
        Y.viterbi_path_op = op
    print(f"[kernel] get_f0 B={B} x 10 s (wall clock): {walls[0]:.2f} ms with K4,"
          f" {walls[1]:.2f} ms with the plain loop; F0 bitwise equal")
    ms, plain_ms, b, by = timed[6, frames[-2]]
    return {"name": "viterbi_path", "route": "cuda", "source": "satpu_torch/csrc/viterbi.cu",
            "replaces": None, "max_abs_err": 0.0, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b, "bound_by": by, "library_ms": None}


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

    n0 = [kernel_launches(k) for k in ("k1", "k4")]
    t0 = time.perf_counter()
    rc = anonymize.main(["--checkpoint", ckpt, "--directory", data, "--batch-size", "8",
                         "--target-selection-algorithm", "random_per_utt",
                         "--results-dir", os.path.join(WORK, "out")])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"shc_band": kernel_launches("k1") - n0[0],
                "viterbi_path": kernel_launches("k4") - n0[1]}
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


def den_placement(den_fb, g):
    """Where K2f and K2b keep the arcs of the den graph tensors ``g``:
    (forward, backward), each "shared" or "global"."""
    S, nnz = g["A"].shape[0], g["A_sparse"].in_src.numel()
    return tuple(den_fb.placement(S, nnz, backward) for backward in (False, True))


def den_check(torch, den_fb, g, ll, lk, name: str):
    """K2f+K2b (through den_scan) against the plain version on loglikes
    ``ll`` [B, T, P]: value rel <= 1e-5, gradient max abs <= 1e-4, the same
    live set of stored alphas, posteriors summing to 1 within 1e-3, and the
    same bits from two calls. Returns (forward err, backward err, llf, lls,
    alphas)."""
    B, T, _ = ll.shape
    S = g["A"].shape[0]
    graph = (g["A"], g["log_self"], g["log_init"])
    a0 = g["start"].expand(B, S).contiguous()
    llf, lls = ll.index_select(-1, g["pdf_fwd"]), ll.index_select(-1, g["pdf_self"])
    res = []
    for scan, extra in ((den_fb.den_scan, (g["A_sparse"],)), (den_fb.den_scan, (g["A_sparse"],)),
                        (den_fb.den_scan_plain, ())):
        x1, x2 = llf.clone().requires_grad_(True), lls.clone().requires_grad_(True)
        v = den_fb.final_value(scan(x1, x2, a0, *graph, lk, *extra), g["final"], g["log_init"], lk)
        v.sum().backward()
        res.append((v.detach(), x1.grad, x2.grad))
    torch.cuda.synchronize()
    (v, gf, gs), again, (v_p, gf_p, gs_p) = res
    v_abs = (v - v_p).abs().max().item()
    v_rel = v_abs / v_p.abs().max().item()
    g_abs = max((gf - gf_p).abs().max().item(), (gs - gs_p).abs().max().item())
    occupation = (gf + gs).sum(-1)  # the den posteriors of each frame sum to one
    occ_err = (occupation - 1).abs().max().item()
    # K2f's own output, the stored alphas, over the states the plain
    # version reaches (the rest hold NEG_INF on both sides)
    alphas = den_fb.den_fb_forward(llf, lls, a0, *graph, lk, g["A_sparse"])
    same_bits = bool(torch.equal(alphas, den_fb.den_fb_forward(llf, lls, a0, *graph, lk,
                                                                g["A_sparse"]))
                     and all(torch.equal(a, b) for a, b in zip((v, gf, gs), again)))
    alphas_p = den_fb.den_fb_forward_plain(llf, lls, a0, *graph, lk)
    live = alphas_p > den_fb.NEG_INF / 2
    a_abs = (alphas - alphas_p)[live].abs().max().item()
    same_live = bool(torch.equal(live, alphas > den_fb.NEG_INF / 2))
    place = den_placement(den_fb, g)
    print(f"[kernel] den_fb K2f+K2b vs plain, {name} loglikes B={B} T={T} S={S} leak 1e-5"
          f" (arcs in {place[0]} memory forward, {place[1]} backward):"
          f" value max abs err {v_abs:.3e}, rel {v_rel:.3e} (tolerance rel 1e-5);"
          f" alphas max abs err {a_abs:.3e}, rel {a_abs / alphas_p[live].abs().max():.3e}"
          f" over the {live.float().mean().item():.1%} live entries (same live set:"
          f" {same_live}); gradient max abs err {g_abs:.3e} (tolerance 1e-4); posteriors sum"
          f" to 1 within {occ_err:.1e}; two calls bitwise equal: {same_bits}")
    check(bool(torch.isfinite(v).all() and torch.isfinite(gf).all()
               and torch.isfinite(gs).all()), f"den_fb output not finite on {name}")
    check(v_rel <= 1e-5 and same_live, f"K2f disagrees with its plain version on {name}")
    check(g_abs <= 1e-4, f"K2b disagrees with its plain version on {name}")
    check(occ_err <= 1e-3, f"den posteriors do not sum to one on {name}")
    check(same_bits, f"two calls of the den kernels differ on {name}")
    return max(v_abs, a_abs), g_abs, llf, lls, alphas


def launches_per_call(torch, calls) -> list:
    """For each (kernel name, fn) of ``calls``: the device kernels of that
    name in one profiler trace of all the calls, each made inside its own
    profiler range (as the trainer's phases make them). The calls share one
    trace: a trace taken right after another (K2b's after K2f's) once held
    no device item at all on an H100, and that reads as a missing launch."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for k, (_, fn) in enumerate(calls):  # the range's name is a device item too
            with record_function(f"call {k}"):
                fn()
        torch.cuda.synchronize()
    device = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    counts = [sum(1 for item in device if name in item) for name, _ in calls]
    if counts != [1] * len(calls):
        print(f"[kernel] device items in the trace: {device}")
    return counts


def phase_den_kernel(np, torch, den):
    """K2f and K2b against their plain versions at the training path's
    shapes (B=16, T=99, S=1641, leak 1e-5), on random loglikes and on the
    chain output of the full-width network, and on the 4001-state graph;
    launches per call from a profiler trace; then timed. Returns their JSON
    entries (without the main path's launch counts)."""
    from satpu_torch import infer_helper
    from satpu_torch.chain import den_fb
    from satpu_torch.chain.objf import DenominatorGraph
    from satpu_torch.chain.prep import random_bigram_den

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
        e_f, e_b, llf, lls, alphas = den_check(torch, den_fb, g, ll, lk, name)
        err_f, err_b = max(err_f, e_f), max(err_b, e_b)
    place = den_placement(den_fb, g)

    phones, succ, b_big, t_big = BIG_DEN
    fst, tree, _ = random_bigram_den(phones, succ, seed=0)
    big = DenominatorGraph.from_fst(fst, tree.num_pdfs).tensors("cuda")
    ll = torch.randn((b_big, t_big, tree.num_pdfs), generator=gen, device="cuda") * 2
    e_f, e_b, *big_ll = den_check(torch, den_fb, big, ll, lk, f"random ({phones}-phone graph)")
    err_f, err_b = max(err_f, e_f), max(err_b, e_b)
    check(den_placement(den_fb, big) == ("global", "global"),
          "the 4001-state graph's arcs fit shared memory")

    # launches per call, then timed: on the chain output (the last input of
    # the full-scale graph) at B=16, on random loglikes at B=64, and on the
    # 4001-state graph
    sp = g["A_sparse"]
    a_T = alphas[-1].clone().requires_grad_(True)
    den_fb.final_value(a_T, g["final"], g["log_init"], lk).sum().backward()
    g_final = a_T.grad
    per_call = tuple(launches_per_call(torch, (
        ("den_fwd", lambda: den_fb.den_fb_forward(llf, lls, a0, *graph, lk, sp)),
        ("den_bwd", lambda: den_fb.den_fb_backward(g_final, alphas, llf, lls, *graph, lk,
                                                   sp)))))
    print(f"[kernel] den kernel launches per call in a profiler trace: K2f {per_call[0]},"
          f" K2b {per_call[1]} (one launch per frame: {T} and {3 * T})")
    check(per_call == (1, 1), f"a den kernel call is not one launch: {per_call}")
    nnz = sp.in_src.numel()
    print(f"[kernel] den graph A: {nnz} nonzeros of {S * S} ({nnz / (S * S):.2%} dense),"
          f" {nnz * 6 + (S + 1) * 4} bytes in sparse form; arcs in {place[0]} memory forward,"
          f" {place[1]} backward")
    timed = den_timing(torch, den_fb, g, llf, lls, lk)
    # the leak's share: without it a frame has one block reduction, not three
    # (four backward), and no leak terms
    off = (g["A"], g["log_self"], g["log_init"], den_fb.leak_log(0.0), sp)
    no_leak = (cuda_ms(torch, lambda: den_fb.den_fb_forward(llf, lls, a0, *off), iters=20),
               cuda_ms(torch, lambda: den_fb.den_fb_backward(g_final, alphas, llf, lls, *off),
                           iters=20))
    print(f"[kernel] the same B={B} calls without the leak: K2f {no_leak[0] * 1e3:.1f} us,"
          f" K2b {no_leak[1] * 1e3:.1f} us")
    ll = torch.randn((64, T, NUM_PDFS), generator=gen, device="cuda") * 2
    den_timing(torch, den_fb, g, ll.index_select(-1, g["pdf_fwd"]),
               ll.index_select(-1, g["pdf_self"]), lk)
    den_timing(torch, den_fb, big, big_ll[0], big_ll[1], lk)
    entry = {"route": "cuda", "source": "satpu_torch/csrc/den_fb.cu", "launches": 0,
             "library_ms": None}
    (ms_f, plain_f, b_f, by_f), (ms_b, plain_b, b_b, by_b) = timed
    return [dict(entry, name="den_fb_forward", replaces="satpu/chain/pallas_fb.py:234",
                 max_abs_err=err_f, ms=ms_f, plain_ms=plain_f, bound_ms=b_f, bound_by=by_f),
            dict(entry, name="den_fb_backward", replaces="satpu/chain/pallas_fb.py:278",
                 max_abs_err=err_b, ms=ms_b, plain_ms=plain_b, bound_ms=b_b, bound_by=by_b)]


def cell_numerators(np, torch, B: int, T: int, seed: int):
    """B numerator graphs on the card as the chain cell makes them: random
    walks of T // 3 phones over the full-scale den graph's bigram."""
    from satpu_torch.chain.fst import fst_rmepsilon, fst_to_arrays, pad_graph_arrays
    from satpu_torch.chain.objf import graphs_to_torch
    from satpu_torch.chain.prep import numerator_fst, random_bigram_den, random_phone_walk

    _, tree, trans = random_bigram_den(DEN_PHONES, DEN_SUCC, seed=0)
    rng = np.random.default_rng(seed)
    return graphs_to_torch(pad_graph_arrays(
        [fst_to_arrays(fst_rmepsilon(numerator_fst(random_phone_walk(trans, max(T // 3, 1), rng),
                                                   tree)))
         for _ in range(B)]), "cuda")


def phase_num_kernel(np, torch):
    """K3f and K3b against their plain versions at the chain cell's shapes
    (NUM_SHAPES, the cell's own graphs, random loglikes): value rel <= 1e-6,
    posteriors max abs <= 1e-5, two calls bitwise equal, one launch a call
    in a profiler trace; then each timed beside its plain version, and the
    numerator of a training step (forward, backward and the xent targets)
    on the host's clock, one call against the three plain passes the
    objective ran before. Returns their JSON entries at the longer shape
    (their ``launches`` set by the caller)."""
    from satpu_torch.chain import num_fb

    gen = torch.Generator(device="cuda").manual_seed(3)
    entries = []
    for B, T in NUM_SHAPES:
        g = cell_numerators(np, torch, B, T, seed=T)
        S, E = g["start_logprob"].shape[-1], g["arc_src"].shape[-1]
        ll = torch.randn((B, T, NUM_PDFS), generator=gen, device="cuda") * 2
        frames = torch.full((B,), T, dtype=torch.int64, device="cuda")
        arcs = num_fb.num_arcs(g, NUM_PDFS)
        L = int(arcs.in_ptr[:, S].max())
        runs = []
        for _ in range(2):
            v, a, m = num_fb.num_fb_forward(ll, g, frames, arcs)
            runs.append((v, a, m, num_fb.num_fb_backward(ll, g, frames, a, m, v, arcs)))
        v_p, a_p, _ = num_fb.num_fb_forward_plain(ll, g, frames)
        posts_p = num_fb.num_fb_backward_plain(ll, g, frames)
        torch.cuda.synchronize()
        v, a, m, posts = runs[0]
        same = all(torch.equal(x, y) for x, y in zip(*runs))
        v_abs = (v - v_p).abs().max().item()
        v_rel = v_abs / v_p.abs().max().item()
        p_abs = (posts - posts_p).abs().max().item()
        print(f"[kernel] num_fb K3f+K3b vs plain, the chain cell's numerators B={B} T={T}:"
              f" S={S}, E={E} ({L} live arcs at most a row), P={NUM_PDFS}; value max abs err"
              f" {v_abs:.3e}, rel {v_rel:.3e} (tolerance rel 1e-6); posteriors max abs err"
              f" {p_abs:.3e} (tolerance 1e-5); bitwise equal"
              f" values and posteriors: {bool(torch.equal(v, v_p))},"
              f" {bool(torch.equal(posts, posts_p))}; two calls bitwise equal: {same}")
        check(bool(torch.isfinite(v).all() and torch.isfinite(posts).all()),
              "num_fb output not finite")
        check(v_rel <= 1e-6 and p_abs <= 1e-5, "K3f/K3b disagree with their plain versions")
        check(same, "two calls of the numerator kernels differ")
        per_call = tuple(launches_per_call(torch, (
            ("num_fwd", lambda: num_fb.num_fb_forward(ll, g, frames, arcs)),
            ("num_bwd", lambda: num_fb.num_fb_backward(ll, g, frames, a, m, v, arcs)))))
        check(per_call == (1, 1), f"a numerator kernel call is not one launch: {per_call}")
        ms_f = cuda_ms(torch, lambda: num_fb.num_fb_forward(ll, g, frames, arcs), iters=20)
        ms_b = cuda_ms(torch, lambda: num_fb.num_fb_backward(ll, g, frames, a, m, v, arcs),
                       iters=20)
        ms_arcs = cuda_ms(torch, lambda: num_fb.num_arcs(g, NUM_PDFS), iters=20)
        plain_f = cuda_ms(torch, lambda: num_fb.num_fb_forward_plain(ll, g, frames), iters=2,
                          warmup=1)
        plain_b = cuda_ms(torch, lambda: num_fb.num_fb_backward_plain(ll, g, frames), iters=2,
                          warmup=1)
        # bytes: the gathered ll read (B T L) and the alphas written
        # [B, T+1, S]; the backward reads both and writes the dense
        # posteriors [B, T, P] (the timed call's zero fill and K3b's entries);
        # operations: about 5 a live arc and frame forward, 10 backward
        BTL, alph = B * T * L, B * (T + 1) * S
        b_f, by_f = bound(5 * BTL, 4 * (BTL + alph))
        b_b, by_b = bound(10 * BTL, 4 * (BTL + alph + B * T * NUM_PDFS))
        for name, ms, plain, b, by in (("K3f num_fb_forward", ms_f, plain_f, b_f, by_f),
                                       ("K3b num_fb_backward (and the posteriors' fill; plain:"
                                        " the forward again and its autograd)", ms_b, plain_b,
                                        b_b, by_b)):
            print(f"[kernel] {name} B={B} T={T} S={S} E={E}: {ms * 1e3:.1f} us ="
                  f" {ms * 1e3 / T:.2f} us a frame (bound {b * 1e3:.1f} us by {by},"
                  f" {b / ms:.2%} of it); plain version {plain * 1e3:.1f} us")
        print(f"[kernel] num_arcs (the three stable sorts, once a batch) B={B} E={E}:"
              f" {ms_arcs * 1e3:.1f} us")

        # a training step's numerator on the host's clock: one num_fb call
        # and its backward, against the plain forward, its backward and the
        # xent targets' second plain forward and backward
        def one_call():
            x = ll.clone().requires_grad_(True)
            value, targets = num_fb.num_fb(x, g, frames, posteriors=True)
            value.sum().backward()
            return x.grad, targets

        def three_passes():
            x = ll.clone().requires_grad_(True)
            num_fb.num_fb_forward_plain(x, g, frames)[0].sum().backward()
            return x.grad, num_fb.num_fb_backward_plain(ll, g, frames)

        walls = []
        for fn, n in ((one_call, 10), (three_passes, 2)):
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) / n * 1e3)
        print(f"[kernel] a training step's numerator at B={B} T={T} (wall clock): one num_fb"
              f" call {walls[0]:.2f} ms, the three plain passes {walls[1]:.1f} ms")
        err_f, err_b = max(v_abs, (a - a_p).abs().max().item()), p_abs
        entries = [{"name": "num_fb_forward", "route": "cuda", "replaces": None,
                    "source": "satpu_torch/csrc/num_fb.cu", "library_ms": None,
                    "max_abs_err": err_f, "ms": ms_f, "plain_ms": plain_f, "bound_ms": b_f,
                    "bound_by": by_f},
                   {"name": "num_fb_backward", "route": "cuda", "replaces": None,
                    "source": "satpu_torch/csrc/num_fb.cu", "library_ms": None,
                    "max_abs_err": err_b, "ms": ms_b, "plain_ms": plain_b, "bound_ms": b_b,
                    "bound_by": by_b}]
    return entries


def den_timing(torch, den_fb, g, llf, lls, lk):
    """K2f and K2b on llf/lls [B, T, S] over the graph tensors g: each one's
    device ms (CUDA events, arcs and A warm in L2 as in a train step), its
    plain version's ms and its bound; printed, and returned as two tuples
    (ms, plain ms, bound ms, bound by)."""
    B, T, S = llf.shape
    sp = g["A_sparse"]
    graph = (g["A"], g["log_self"], g["log_init"], lk)
    a0 = g["start"].expand(B, S).contiguous()
    alphas = den_fb.den_fb_forward(llf, lls, a0, *graph, sp)
    a_T = alphas[-1].clone().requires_grad_(True)
    den_fb.final_value(a_T, g["final"], g["log_init"], lk).sum().backward()
    g_final = a_T.grad
    ms_f = cuda_ms(torch, lambda: den_fb.den_fb_forward(llf, lls, a0, *graph, sp), iters=20)
    plain_f = cuda_ms(torch, lambda: den_fb.den_fb_forward_plain(llf, lls, a0, *graph),
                      iters=3, warmup=1)
    ms_b = cuda_ms(torch, lambda: den_fb.den_fb_backward(g_final, alphas, llf, lls, *graph, sp),
                   iters=20)
    plain_b = cuda_ms(torch, lambda: den_fb.den_fb_backward_plain(g_final, alphas, llf, lls,
                                                                  *graph),
                      iters=3, warmup=1)
    # operations: one FMA per nonzero of A, per batch row and frame (the
    # backward twice: sums again, and d_sums @ A^T). Bytes: each input read
    # once and each output written once: llf, lls, alpha0, A in its sparse
    # form (nnz values and 16-bit states, S + 1 pointers: the least any
    # implementation must read of it), log_self, log_init in; alphas
    # [T+1, B, S] out (the backward: g_final, alphas, llf, lls and the graph
    # in; dllf, dlls out)
    BTS, nnz = B * T * S, sp.in_src.numel()
    a_bytes = nnz * (4 + 2) + (S + 1) * 4
    b_f, by_f = bound(2 * B * T * nnz, 4 * (2 * BTS + B * S + 2 * S + (T + 1) * B * S)
                      + a_bytes)
    b_b, by_b = bound(4 * B * T * nnz, 4 * (B * S + (T + 1) * B * S + 2 * BTS + 2 * S
                                           + 2 * BTS) + a_bytes)
    out = ((ms_f, plain_f, b_f, by_f), (ms_b, plain_b, b_b, by_b))
    for name, (ms, plain, b, by), place in zip(
            ("K2f den_fb_forward", "K2b den_fb_backward"), out, den_placement(den_fb, g)):
        print(f"[kernel] {name} B={B} T={T} S={S}, arcs in {place} memory: {ms * 1e3:.1f} us"
              f" = {ms * 1e3 / T:.2f} us a frame (bound {b * 1e3:.1f} us by {by},"
              f" {b / ms:.2%} of it); plain version {plain * 1e3:.1f} us")
    return out


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
    n0 = [kernel_launches(k) for k in ("k2f", "k2b", "k3f", "k3b")]
    t0 = time.perf_counter()
    rc = train_asr.main(["--train-set", fx["data"], "--fst-scp", fx["fst_scp"],
                         "--valid-set", fx["valid"], "--valid-fst-scp", fx["valid_fst_scp"],
                         "--den-fst", fx["den_fst"], "--num-pdfs", str(NUM_PDFS),
                         "--model", "tdnnf_vq", "--codebook-size", "48",
                         "--minibatch-size", "16", "--num-epochs", "2",
                         "--diagnostics-interval", "1", "--dirname", exp])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"den_fb_forward": kernel_launches("k2f") - n0[0],
                "den_fb_backward": kernel_launches("k2b") - n0[1],
                "num_fb_forward": kernel_launches("k3f") - n0[2],
                "num_fb_backward": kernel_launches("k3b") - n0[3]}
    check(rc == 0, f"train_asr exited {rc}")
    print(f"[train] train_asr on cuda: tdnnf_vq 1024 / VQ-48 / {NUM_PDFS} pdfs, NG on,"
          f" {steps} steps of B=16 x {EG_SECONDS} s + held-out diagnostics every step and"
          f" final combination in {wall:.1f} s (first call, cold); kernel launches {launches}")
    check(all(n >= steps for n in launches.values()), f"a chain kernel was not launched once"
          f" a step: {launches}")
    with open(os.path.join(exp, "metrics.jsonl")) as f:
        logged = [json.loads(line) for line in f]
    check([r["step"] for r in logged] == list(range(1, steps + 1)), "one log line a step")
    print(f"[train] objf by step: {[round(r['chain_objf'], 4) for r in logged]}; with the"
          f" earlier per-frame den kernels {PER_FRAME_OBJF}")
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


def train_split(prof, iters: int, prefix: str = "chain.", phases=None):
    """Per step, from a profile of ``iters`` train steps: each trainer phase's
    host ms (its ``<prefix><phase>`` range on the calling thread) and the
    device ms of the kernels, copies and fills launched inside it. A device
    item belongs to the range whose host window holds its launch call, from
    whatever thread made it (the autograd engine launches the backward's from
    its own). Items launched outside every range count as ``other``. The
    phases are the chain trainer's unless given."""
    import bisect

    from torch.autograd import DeviceType

    if phases is None:
        from satpu_torch.chain.trainer import PHASES as phases

    events = prof.events()
    ranges = sorted((e.time_range.start, e.time_range.end, e.name[len(prefix):])
                    for e in events if e.device_type == DeviceType.CPU
                    and e.name.startswith(prefix) and e.name[len(prefix):] in phases)
    starts = [r[0] for r in ranges]
    # runtime calls (cudaLaunchKernel, cudaMemcpyAsync, ...) share their
    # device item's correlation id
    launch = {e.id: e.time_range.start for e in events
              if e.device_type == DeviceType.CPU and e.name.startswith("cu")}
    host = dict.fromkeys(phases, 0.0)
    dev = dict.fromkeys(tuple(phases) + ("other",), 0.0)
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
    """Full-width train steps (TDNN-F 1024 + VQ-48, NG on, f32) at B=64 x
    3 s, a batch no benchmark cell drives: ms per step and audio-seconds per
    second (host clock, unprofiled), peak memory, then a profile of as many
    steps for the step's phase split (host ms, device ms), busy share and
    launch count, and the den kernels timed alone at the same shapes. The
    profile is informational: nothing read from it can fail."""
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
    B, iters = 64, 4  # a multiple of 4: NG update steps in proportion
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
    graph = (g["A"], g["log_self"], g["log_init"], lk, g["A_sparse"])
    alphas = den_fb.den_fb_forward(llf, lls, a0, *graph)
    g_final = torch.ones_like(a0)
    k2f = cuda_ms(torch, lambda: den_fb.den_fb_forward(llf, lls, a0, *graph), iters=5)
    k2b = cuda_ms(torch, lambda: den_fb.den_fb_backward(g_final, alphas, llf, lls, *graph),
                  iters=5)
    audio = B * EG_SECONDS
    print(f"[train-throughput] B={B} x {EG_SECONDS} s, tdnnf_vq 1024, NG on, f32:"
          f" {wall * 1e3:.1f} ms/step (host clock), {audio / wall:.1f} audio-s/s; peak mem"
          f" {peak:.2f} GiB [{card}]")
    print(f"[train-throughput]   profiled split ms/step, host / device: "
          + ", ".join(f"{k} {host[k]:.2f} / {dev[k]:.2f}" for k in host)
          + f", other - / {dev['other']:.2f}; device {busy:.2f} ms ="
          f" {busy / (wall * 1e3):.0%} busy of the unprofiled step,"
          f" {sum(r[1] for r in rows)} launches; K2f alone {k2f:.2f}, K2b alone {k2b:.2f}")


def eval_graph(np):
    """The decoding graph at the network's 3280 pdfs: the den graph's
    biphone tree (164 phones x 9 successors), words that are 3-6 phone walks
    of its bigram, and a word bigram from random sentences. Returns (graph,
    word table, sentence sampler)."""
    from satpu_torch.chain.prep import (Lexicon, estimate_word_bigram, make_decode_graph,
                                        random_bigram_den, random_phone_walk)

    t0 = time.perf_counter()
    _, tree, trans = random_bigram_den(DEN_PHONES, DEN_SUCC, seed=0)
    check(tree.num_pdfs == NUM_PDFS, f"decoding tree has {tree.num_pdfs} pdfs")
    rng = np.random.default_rng(0)
    lex = Lexicon({f"w{i:03d}": [[tree.phones[p - 1] for p in
                                  random_phone_walk(trans, int(rng.integers(3, 7)), rng)]]
                   for i in range(EVAL_WORDS)})
    names = sorted(lex.entries)

    def sentence(r):
        return [names[j] for j in r.integers(0, len(names), int(r.integers(3, 9)))]

    vocab, _, w_trans, w_final = estimate_word_bigram([sentence(rng)
                                                       for _ in range(EVAL_SENTENCES)])
    phone_id = {p: i + 1 for i, p in enumerate(tree.phones)}
    graph, table = make_decode_graph(tree, lex, phone_id, vocab, w_trans, w_final)
    print(f"[eval] decoding graph: {len(vocab)} words, {tree.num_pdfs} pdfs, {graph.num_states}"
          f" states, {graph.num_arcs} arcs, built in {time.perf_counter() - t0:.1f} s")
    return graph, table, sentence


def calibrate_norms(np, torch, model):
    """Batch-norm statistics of speech for a randomly initialized model: one
    forward pass over 8 synthetic voiced utterances of 3 s (not the eval
    data) in which every batch norm first takes the mean and biased
    variance of its own input over all but the channel axis, so each sees
    its upstream norms already set, as a trained model's would be. With
    the init's 0 / 1 the random ECAPA maps every utterance to nearly the
    same x-vector, and the trial scores differ by little more than
    rounding."""
    def take(module, inputs):
        x = inputs[0]
        dims = [0] + list(range(2, x.dim()))
        module.running_mean.copy_(x.mean(dims))
        module.running_var.copy_(x.var(dims, correction=0))

    hooks = [m.register_forward_pre_hook(take) for m in model.modules()
             if isinstance(getattr(m, "running_var", None), torch.Tensor)]
    wavs = np.stack([voiced_utterance(np, 3.0, 90.0 + 20 * k, seed=200 + k)[0] for k in range(8)])
    with torch.no_grad():
        model(torch.from_numpy(wavs).to(next(model.parameters()).device))
    for h in hooks:
        h.remove()
    return len(hooks)


def rank_scores(np, xv_enroll, spk_of, xv_trial, trials):
    """asv_test's cosine scores of (speaker, utt, target) trials from
    per-utterance x-vectors: enrolment speaker means, normalized."""
    from satpu_torch.sidekit import scoring

    means = {}
    for s in sorted(set(spk_of)):
        m = xv_enroll[[i for i, x in enumerate(spk_of) if x == s]].mean(axis=0)
        means[s] = m / np.maximum(np.linalg.norm(m), 1e-12)
    return scoring.cosine_scoring(np.stack([means[s] for s, _, _ in trials]),
                                  np.stack([xv_trial[u] for _, u, _ in trials]))


def eval_cli(paths, device: str, name: str, *extra):
    """The eval_anon CLI over the slice phase's anonymized dir with the eval
    phase's models (``paths``) on ``device``, results in WORK/eval/<name>:
    (results, wall s, native lattice decodes, ctm words by utterance,
    loglikes by utterance)."""
    from satpu_torch import native
    from satpu_torch.bin import eval_anon
    from satpu_torch.utils.scp_io import read_ark

    res = os.path.join(WORK, "eval", name)
    native.decode_lattice.calls = 0
    t0 = time.perf_counter()
    rc = eval_anon.main([
        "--device", device, "--data", os.path.join(WORK, "data_anon"), "--asr-checkpoint",
        paths["asr"], "--decode-graph", paths["graph"], "--words-txt", paths["words"],
        "--write-ctm", "true", "--dump-loglikes", os.path.join(res, "loglikes.ark"),
        "--asv-checkpoint", paths["asv"], "--enroll-dir", os.path.join(WORK, "data"),
        "--trials", paths["trials"], "--xvector-mode", "chunked", "--results", res, *extra])
    wall = time.perf_counter() - t0
    check(rc == 0, f"eval_anon on {device} {' '.join(extra)} exited {rc}")
    with open(os.path.join(res, "results.json")) as f:
        out = json.load(f)
    ctm = {}
    with open(os.path.join(res, "hyp.ctm")) as f:
        for line in f:
            ctm.setdefault(line.split()[0], []).append(line.split()[4])
    return out, wall, native.decode_lattice.calls, ctm, dict(read_ark(
        os.path.join(res, "loglikes.ark")))


def eval_setup(np, torch):
    """The eval phase's inputs: the word graph, the full-width ASR and
    x-vector checkpoints (norms calibrated), the slice phase's anonymized
    dir's text and the trials. Returns (graph, paths, the words' count, the
    trials)."""
    from satpu_torch import infer_helper
    from satpu_torch.utils import kaldi_data

    graph, table, sentence = eval_graph(np)
    ev = os.path.join(WORK, "eval")
    os.makedirs(ev)
    paths = {k: os.path.join(ev, f) for k, f in (
        ("graph", "HCLG.fst"), ("words", "words.txt"), ("asr", "asr_eval.pt"),
        ("asv", "asv_xvector.pt"), ("trials", "trials"))}
    graph.write(paths["graph"])
    with open(paths["words"], "w") as f:
        f.write("<eps> 0\n" + "".join(f"{w} {i}\n" for i, w in sorted(table.items())))
    t0 = time.perf_counter()
    for key, model_id, params in (("asr", "asrbn_tdnnf", EVAL_ASR), ("asv", "asv_xvector", {})):
        model = infer_helper.build_model(model_id, device="cpu", seed=0, **params)
        norms = calibrate_norms(np, torch, model)
        infer_helper.save_model(paths[key], model_id, params, model.state_dict())
        n = sum(v.numel() for v in model.state_dict().values())
        print(f"[eval] {model_id} {params or 'defaults'}: {n / 1e6:.2f} M weights from seed 0,"
              f" {norms} batch norms calibrated")
    c = model.cfg
    check((c.arch, c.n_mels, c.channels, c.embedding_size, c.num_speakers)
          == ("ecapa", 80, 512, 192, 1211), "ECAPA x-vector widths")
    del model
    print(f"[eval] checkpoints built and saved in {time.perf_counter() - t0:.1f} s")

    # VoicePrivacy's original-enrol / anonymized-trial setting
    data, anon = os.path.join(WORK, "data"), os.path.join(WORK, "data_anon")
    utt2spk = kaldi_data.read_keyed_text(os.path.join(data, "utt2spk"))
    anon_utts = sorted(kaldi_data.read_wav_scp(os.path.join(anon, "wav.scp")))
    check(len(anon_utts) == len(SLICE_UTTS), "the anonymized dir holds every utterance")
    rng = np.random.default_rng(1)
    text = {u: " ".join(sentence(rng)) for u in anon_utts}
    kaldi_data.write_keyed_text(text, os.path.join(anon, "text"))
    n_words = sum(len(t.split()) for t in text.values())
    speakers = sorted(set(utt2spk.values()))
    trials = [(s, u, utt2spk[u] == s) for u in anon_utts for s in speakers]
    with open(paths["trials"], "w") as f:
        f.writelines(f"{s} {u} {'target' if t else 'nontarget'}\n" for s, u, t in trials)
    return graph, paths, n_words, trials


def phase_eval(np, torch, card):
    """The eval_anon CLI on the card over the slice phase's anonymized dir,
    then the same run on the port's CPU path. Returns what eval-throughput
    reuses: the graph, the two checkpoints."""
    from satpu_torch import infer_helper, native
    from satpu_torch.bin.pipeline import DEFAULT_BUCKETS, bucket_for
    from satpu_torch.sidekit.trainer import extract_xvectors
    from satpu_torch.utils import kaldi_data

    graph, paths, n_words, trials = eval_setup(np, torch)
    data, anon = os.path.join(WORK, "data"), os.path.join(WORK, "data_anon")
    utt2spk = kaldi_data.read_keyed_text(os.path.join(data, "utt2spk"))
    anon_utts = sorted(kaldi_data.read_wav_scp(os.path.join(anon, "wav.scp")))

    def run(device):
        return eval_cli(paths, device, f"results_{device}")

    check(native.available(), "the native decoder does not build")
    out, wall, decodes, ctm, lls = run("cuda")
    asr, asv = out["asr"], out["asv"]
    print(f"[eval] eval_anon CLI on cuda: {len(anon_utts)} utterances, {len(trials)} trials"
          f" ({sum(t for *_, t in trials)} target) in {wall:.2f} s (first call, cold);"
          f" {decodes} native lattice decodes [{card}]")
    print(f"[eval]   asr {json.dumps(asr)}")
    print(f"[eval]   asv {json.dumps(asv)}")
    check(decodes == len(anon_utts), f"the native decoder decoded {decodes} utterances")
    check(asr["words"] == n_words and all(np.isfinite(v) for v in asr.values()),
          f"asr results {asr}")
    check(all(np.isfinite(v) for v in asv.values()) and 0 <= asv["eer"] <= 100
          and "asnorm_eer" in asv, f"asv results {asv}")
    check(sorted(lls) == anon_utts and all(np.isfinite(x).all() for x in lls.values()),
          "a loglike matrix is missing or not finite")

    out_cpu, wall_cpu, _, ctm_cpu, lls_cpu = run("cpu")
    ll_rel = max(float(np.abs(lls[u] - lls_cpu[u]).max() / np.abs(lls_cpu[u]).max())
                 for u in anon_utts)
    same_hyps = all(ctm.get(u, []) == ctm_cpu.get(u, []) for u in anon_utts)
    scp = {d: kaldi_data.read_wav_scp(os.path.join(d, "wav.scp")) for d in (data, anon)}
    enroll = sorted(utt2spk)
    wavs = ([kaldi_data.load_wav_from_scp(scp[data][u])[0][0] for u in enroll]
            + [kaldi_data.load_wav_from_scp(scp[anon][u])[0][0] for u in anon_utts])
    rms = [float(np.sqrt(np.mean(w.astype(np.float64) ** 2))) for w in wavs[len(enroll):]]
    # where the loglikes part: the frontend (fbank, CMVN) or the network,
    # on eval_anon's padded batch
    batch = np.zeros((len(anon_utts), bucket_for(max(map(len, wavs[len(enroll):])),
                                                 DEFAULT_BUCKETS)), np.float32)
    for j, w in enumerate(wavs[len(enroll):]):
        batch[j, :len(w)] = w
    lens = torch.tensor([len(w) for w in wavs[len(enroll):]])
    nets = {d: infer_helper.load_model(paths["asr"], device=d)[0] for d in ("cuda", "cpu")}
    with torch.inference_mode():
        feats = {d: m.features(torch.from_numpy(batch).to(d), lens.to(d)).cpu()
                 for d, m in nets.items()}
        # the card's network on the CPU's features
        hook = nets["cuda"].tdnn1.register_forward_pre_hook(
            lambda mod, inp: (feats["cpu"].transpose(1, 2).cuda(),))
        net_ll = {"cuda": nets["cuda"](torch.from_numpy(batch).cuda(), lens.cuda())[0].cpu()}
        hook.remove()
        net_ll["cpu"] = nets["cpu"](torch.from_numpy(batch), lens)[0]
    del nets
    feat_diff = (feats["cuda"] - feats["cpu"]).abs()
    feat_err = float(feat_diff.max())
    feat_rel = feat_err / float(feats["cpu"].abs().max())
    feat_frame = int(feat_diff.amax(dim=(0, 2)).argmax())
    net_rel = float((net_ll["cuda"] - net_ll["cpu"]).abs().max() / net_ll["cpu"].abs().max())
    # x-vectors of every enrolment and trial utterance on both devices
    xv = {}
    for device in ("cuda", "cpu"):
        model, _ = infer_helper.load_model(paths["asv"], device=device)
        xv[device] = extract_xvectors(model, wavs)
        del model
    a, b = xv["cuda"], xv["cpu"]
    cos = float(((a * b).sum(1) / np.linalg.norm(a, axis=1) / np.linalg.norm(b, axis=1)).min())
    scores = {}
    for device, x in xv.items():
        scores[device] = rank_scores(np, x[:len(enroll)], [utt2spk[u] for u in enroll],
                                     dict(zip(anon_utts, x[len(enroll):])), trials)
    # trials whose x-vectors are bitwise equal on a device tie exactly on it
    same_rank = bool((np.argsort(scores["cuda"], kind="stable")
                      == np.argsort(scores["cpu"], kind="stable")).all())
    distinct = np.unique(scores["cpu"])
    n_xv = len(np.unique(xv["cpu"][len(enroll):], axis=0))
    metric_diff = max(abs(asv[k] - out_cpu["asv"][k]) for k in asv)
    print(f"[eval] the anonymized utterances: rms {min(rms):.6f}-{max(rms):.6f}, {n_xv} distinct"
          f" x-vectors of {len(anon_utts)}, {len(distinct)} distinct trial scores of"
          f" {len(trials)}")
    print(f"[eval] cuda vs cpu (f32, TF32 off; cpu CLI {wall_cpu:.2f} s): hyps equal"
          f" {same_hyps}; loglikes rel {ll_rel:.3e} (fbank+CMVN features max abs {feat_err:.3e},"
          f" rel {feat_rel:.3e}, at frame {feat_frame}; the network on the same features rel"
          f" {net_rel:.3e});"
          f" x-vector cosine min {cos:.7f} over {len(wavs)} utterances; trial ranking equal"
          f" {same_rank} (score max abs diff {float(np.abs(scores['cuda'] - scores['cpu']).max()):.3e},"
          f" smallest gap between distinct scores {float(np.diff(distinct).min()):.3e});"
          f" ASV metrics max abs diff {metric_diff:.3e}; WER {asr['wer']:.2f} vs"
          f" {out_cpu['asr']['wer']:.2f}")
    check(same_hyps, "the card's hyps differ from the CPU path's")
    check(ll_rel <= 1e-3, "the card's loglikes depart from the CPU path")
    check(cos >= 0.9999, "the card's x-vectors depart from the CPU path")
    check(same_rank, "the card ranks the trials differently from the CPU path")
    return graph, paths


def busy_share(torch, fn):
    """(host-clock ms of one unprofiled call, device ms of one profiled
    call, kernel launches) of fn; a warm-up call first."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    span = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    return span, sum(e.self_device_time_total for e in rows) / 1e3, sum(e.count for e in rows)


def phase_eval_throughput(np, torch, graph, paths, card):
    """Evaluation throughput: x-vector extraction and loglikes on the card,
    the host decoder on the loglikes of random 10 s utterances."""
    from concurrent.futures import ThreadPoolExecutor

    from satpu_torch import infer_helper, native
    from satpu_torch.models.asrbn import output_num_frames
    from satpu_torch.sidekit.trainer import extract_xvectors

    rng = np.random.default_rng(2)
    asv, _ = infer_helper.load_model(paths["asv"])
    windows = list((rng.standard_normal((64, 3 * SR)) * 0.1).astype(np.float32))
    iters = 5
    extract_xvectors(asv, windows)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        xv = extract_xvectors(asv, windows)
    wall = (time.perf_counter() - t0) / iters
    check(xv.shape == (64, 192) and bool(np.isfinite(xv).all()), "x-vector batch")
    span, dev, launches = busy_share(torch, lambda: extract_xvectors(asv, windows))
    print(f"[eval-throughput] x-vectors, ECAPA 512, chunked, B=64 windows of 3 s, f32:"
          f" {64 * 3.0 / wall:.1f} audio-s/s ({wall * 1e3:.1f} ms a batch, host clock);"
          f" device {dev:.1f} of {span:.1f} ms = {dev / span:.0%} busy, {launches} launches"
          f" [{card}]")
    del asv

    asr, _ = infer_helper.load_model(paths["asr"])
    B, T = 32, 10 * SR
    wav = torch.from_numpy((rng.standard_normal((B, T)) * 0.1).astype(np.float32)).cuda()
    lens = torch.full((B,), T, device="cuda")
    with torch.inference_mode():
        asr(wav, lens)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            ll = asr(wav, lens)[0]
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / 3
        span, dev, launches = busy_share(torch, lambda: asr(wav, lens))
    check(tuple(ll.shape) == (B, output_num_frames(T), NUM_PDFS)
          and bool(torch.isfinite(ll).all()), "loglike batch")
    print(f"[eval-throughput] loglikes, tdnnf 1024, 3280 pdfs, B=32 x 10 s, f32:"
          f" {B * 10.0 / wall:.1f} audio-s/s ({wall * 1e3:.1f} ms a batch, host clock);"
          f" device {dev:.1f} of {span:.1f} ms = {dev / span:.0%} busy, {launches} launches"
          f" [{card}]")
    lls = list(ll.cpu().numpy())
    del asr, wav, ll

    ng = native.NativeGraph(graph)

    def decode(x):
        return native.decode_lattice(ng, x, beam=16.0, lattice_beam=8.0, max_active=7000)

    n1 = 8
    t0 = time.perf_counter()
    arcs = [decode(x).num_arcs for x in lls[:n1]]
    one = (time.perf_counter() - t0) / (n1 * 10.0)
    workers = os.cpu_count() or 4
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=workers) as pool:
        lats = list(pool.map(decode, lls))
    pooled = (time.perf_counter() - t0) / (B * 10.0)
    check(all(lat.num_arcs > 0 for lat in lats), "an empty lattice")
    print(f"[eval-throughput] host decoder, beam 16 / lattice beam 8, {graph.num_states}-state"
          f" graph: {one * 1e3:.3f} ms per audio-s on one thread ({n1} utterances of 10 s,"
          f" lattices of {min(arcs)}-{max(arcs)} arcs), {pooled * 1e3:.3f} ms per audio-s with a"
          f" pool of {workers} threads ({B} utterances) [{card}]")


def gan_batch(np, torch, B: int, device):
    """A fixed full-width GAN batch of B segments of GAN_SEGMENT samples:
    the flagship's 256-d bottleneck features, F0 with unvoiced frames, the
    247-speaker one-hot, and audio; made from a seed."""
    rng = np.random.default_rng(4)
    t_bn = GAN_SEGMENT // 320
    f0 = (rng.uniform(80, 250, (B, t_bn)) * (rng.random((B, t_bn)) > 0.2)).astype(np.float32)
    batch = {"bn": rng.standard_normal((B, 256, t_bn)).astype(np.float32), "f0": f0,
             "spk": np.eye(247, dtype=np.float32)[rng.integers(0, 247, B)],
             "audio": (rng.standard_normal((B, GAN_SEGMENT)) * 0.1).astype(np.float32)}
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def gan_shc_check(np, torch, data):
    """K1 against its plain version at the GAN warm-up's shapes: one
    utterance of the phase's train dir a call, peak-normalized and padded to
    a feature bucket as HifiGanDataset pads it for get_f0 (the 16000, 32000
    and 48000-sample buckets), two calls bitwise equal. Returns the largest
    abs error."""
    import torch.nn.functional as F

    from satpu_torch.hifigan.dataset import FEATURE_BUCKETS, _bucket_pad, normalize_audio
    from satpu_torch.models.anonymizer import YAAPT_OPTS
    from satpu_torch.ops import yaapt as Y
    from satpu_torch.utils import kaldi_data

    p = Y._merged_params(YAAPT_OPTS)
    to_pad, frame_size, frame_jump, nfft = Y.frame_geometry(p)
    g = Y.shc_params(nfft, p)
    args = (g["min_shc"], g["n_out"], g["n_harm"], g["window_length"])
    scp = sorted(kaldi_data.read_wav_scp(os.path.join(data, "wav.scp")).values())
    wavs = [normalize_audio(kaldi_data.load_wav_from_scp(w)[0][0]) for w in scp[:2]]
    worst = 0.0
    # 0.9 s of an utterance, the utterance, two utterances end to end
    for audio in (wavs[0][:14400], wavs[0], np.concatenate(wavs)):
        x = torch.from_numpy(_bucket_pad(audio, FEATURE_BUCKETS)).cuda()
        nl = Y.bandpass(F.pad(x, (to_pad, to_pad)) ** 2, p["sr"], p["bp_low"], p["bp_high"])
        mag = Y.shc_magnitude(nl, Y.num_frames(x.shape[1], p), frame_size, frame_jump, nfft, p)
        out, again = Y.shc_band(mag, *args), Y.shc_band(mag, *args)
        ref = Y.shc_band_plain(mag, *args)
        max_abs = (out - ref).abs().max().item()
        rel = max_abs / ref.abs().max().item()
        same = bool(torch.equal(out, again))
        worst = max(worst, max_abs)
        print(f"[gan] shc_band vs plain at the warm-up's shape, {len(audio)} samples padded to"
              f" {x.shape[1]}: mag [{mag.shape[0]} x {mag.shape[1]}] -> [{out.shape[0]} x"
              f" {out.shape[1]}]: max abs err {max_abs:.3e}, rel {rel:.3e} (tolerance rel 1e-5);"
              f" two calls bitwise equal: {same}")
        check(rel <= 1e-5, f"shc_band disagrees with its plain version at {x.shape[1]} samples")
        check(same, f"two shc_band calls differ at {x.shape[1]} samples")
    return worst


def gan_dirs(np):
    """The gan phase's data: a train dir of one voiced utterance for each of
    the flagship's 247 speakers and a dev dir of GAN_DEV (1.1-1.6 s), and
    the frozen extractor (the flagship's TDNN-F + VQ-48, random weights):
    {"train", "dev", "asrbn"} paths under WORK/gan."""
    from satpu_torch import infer_helper
    from satpu_torch.utils import kaldi_data

    root = os.path.join(WORK, "gan")
    t0 = time.perf_counter()
    dirs = {}
    for name, n in (("train", len(SPEAKERS)), ("dev", GAN_DEV)):
        d = dirs[name] = os.path.join(root, name)
        os.makedirs(d)
        wav_scp, utt2spk = {}, {}
        for k in range(n):
            # 1.1-1.6 s in whole BN frames of 320 samples
            samples = 320 * (55 + 5 * (k % 6))
            x = voiced_utterance(np, (samples + 0.5) / SR, 90.0 + (37 * k) % 160,
                                 seed=(300 if name == "train" else 900) + k)[0]
            utt = f"{SPEAKERS[k]}-{name}{k}"
            wav_scp[utt] = os.path.join(root, f"{utt}.wav")
            kaldi_data.write_wav(wav_scp[utt], x, SR)
            utt2spk[utt] = SPEAKERS[k]
        kaldi_data.write_keyed_text(wav_scp, os.path.join(d, "wav.scp"))
        kaldi_data.write_keyed_text(utt2spk, os.path.join(d, "utt2spk"))
    dirs["asrbn"] = os.path.join(root, "asrbn.pt")
    net = infer_helper.build_model("asrbn_tdnnf", device="cpu", seed=0, **FLAGSHIP["asrbn"])
    infer_helper.save_model(dirs["asrbn"], "asrbn_tdnnf", FLAGSHIP["asrbn"], net.state_dict())
    del net
    print(f"[gan] {len(SPEAKERS)} train + {GAN_DEV} dev voiced utterances of 1.1-1.6 s and the"
          f" flagship extractor written in {time.perf_counter() - t0:.1f} s")
    return dirs


def phase_gan(np, torch, card):
    """The train_vc CLI on the card at hifigan.ini's widths for one epoch;
    returns K1's and K4's launches over that run by kernel name and K1's
    largest abs error against the plain version at the run's shapes."""
    from satpu_torch.bin import anonymize, train_vc
    from satpu_torch.hifigan import trainer as gan_trainer
    from satpu_torch.ops import yaapt as Y
    from satpu_torch.utils import kaldi_data

    root = os.path.join(WORK, "gan")
    dirs = gan_dirs(np)
    asrbn = dirs["asrbn"]

    recorded = []
    step = gan_trainer.GanTrainer.train_step

    def recording(self, batch):  # every step's metrics (the CLI logs every 50th)
        m = step(self, batch)
        recorded.append({k: float(v) for k, v in m.items()})
        return m

    exp = os.path.join(root, "exp")
    gan_trainer.GanTrainer.train_step = recording
    counters = {"shc_band": "k1", "viterbi_path": "k4"}
    n0 = {k: kernel_launches(c) for k, c in counters.items()}
    try:
        t0 = time.perf_counter()
        rc = train_vc.main(["--config", os.path.join(ROOT, GAN_CONFIG), "--train-set",
                            dirs["train"], "--dev-set", dirs["dev"], "--dirname", exp,
                            "--asrbn-checkpoint", asrbn, "--training-epochs", "1"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        gan_trainer.GanTrainer.train_step = step
    launches = {k: kernel_launches(c) - n0[k] for k, c in counters.items()}
    check(rc == 0, f"train_vc exited {rc}")
    steps = -(-len(SPEAKERS) // 32)
    print(f"[gan] train_vc on cuda ({GAN_CONFIG}: generator 512, MPD 2/3/5/7/11, MSD x3, B=32,"
          f" segment {GAN_SEGMENT}, f32): fake_epoch over {len(SPEAKERS)} utterances, {steps}"
          f" steps, validation and checkpoints in {wall:.1f} s (first call, cold); kernel"
          f" launches {launches} [{card}]")
    check(launches["shc_band"] >= len(SPEAKERS), f"the warm-up's kernel launches {launches}")
    check(launches["viterbi_path"] == 2 * launches["shc_band"],
          f"not two K4 launches a get_f0: {launches}")
    shc_err = gan_shc_check(np, torch, dirs["train"])
    check(len(recorded) == steps, f"{len(recorded)} steps, not {steps}")
    for i, m in enumerate(recorded, 1):
        check(all(np.isfinite(v) for v in m.values()), f"step {i} metrics not finite: {m}")
        print(f"[gan]   step {i}: loss_gen_all {m['loss_gen_all']:.4f}, loss_disc_all"
              f" {m['loss_disc_all']:.4f}, mel_spec_error {m['mel_spec_error']:.4f},"
              f" lr {m['lr']:.6f}")
    names = set(os.listdir(exp))
    triplet = {f"g_{steps}.ckpt", f"d_{steps}.ckpt", f"trainer_{steps}.ckpt", "g_best.ckpt"}
    check(triplet <= names, f"checkpoints {sorted(names)}")
    with open(os.path.join(exp, "metrics.jsonl")) as f:
        val = [json.loads(line) for line in f]
    val = [r["val_mel_error"] for r in val if "val_mel_error" in r]
    check(len(val) == 1 and np.isfinite(val[0]), f"validation mel error {val}")
    print(f"[gan] {sorted(triplet)} written; validation mel error {val[0]:.4f}")

    # the written generator serves through the anonymize CLI
    serve = os.path.join(root, "serve")
    os.makedirs(serve)
    src = kaldi_data.read_wav_scp(os.path.join(dirs["dev"], "wav.scp"))
    two = dict(sorted(src.items())[:2])
    kaldi_data.write_keyed_text(two, os.path.join(serve, "wav.scp"))
    kaldi_data.write_keyed_text({u: u.split("-")[0] for u in two}, os.path.join(serve, "utt2spk"))
    rc = anonymize.main(["--checkpoint", os.path.join(exp, "g_best.ckpt"), "--directory", serve,
                         "--target-selection-algorithm", "random_per_utt",
                         "--results-dir", os.path.join(root, "serve_out")])
    check(rc == 0, f"anonymize exited {rc}")
    out = kaldi_data.read_wav_scp(os.path.join(serve + "_anon", "wav.scp"))
    check(sorted(out) == sorted(two), "one output wav per utterance")
    for utt, path in out.items():
        y, _ = kaldi_data.load_wav_from_scp(path)
        n = kaldi_data.load_wav_from_scp(two[utt])[0].shape[1]
        check(y.shape == (1, n) and bool(np.isfinite(y).all())
              and float(np.abs(y).max()) > 1e-3, f"{utt}: served wav {y.shape}, input {n}")
    print(f"[gan] g_best.ckpt served by the anonymize CLI on cuda: {len(out)} wavs of the"
          " input's length, finite, not silent")
    return launches, shc_err


def phase_gan_cpu(np, torch):
    """One tiny GAN step (a 4 x 4 upsampling generator, periods 2 and 3, two
    scales at 1/16 of the widths, f32) on the card against the port's CPU
    path, from the same weights and batch: metrics rel <= 1e-4, gradients rel
    <= 1e-3 per tensor, the spectral-norm state rel <= 1e-5."""
    import copy

    from satpu_torch.hifigan.trainer import GanHparams, GanTrainer
    from satpu_torch.models.anonymizer import AnonymizationNet, AnonymizerConfig
    from satpu_torch.models.asrbn import TDNNFNetConfig

    cfg = AnonymizerConfig(asrbn=TDNNFNetConfig(output_dim=8, hidden_dim=16, bottleneck_dim=8,
                                                prefinal_bottleneck_dim=8),
                           num_speakers=4, bn_dim=8, upsample_rates=(4, 4),
                           upsample_kernel_sizes=(8, 8), upsample_initial_channel=32)
    h = GanHparams(segment_size=256, n_fft=64, num_mels=8, hop_size=16, win_size=64,
                   mpd_periods=(2, 3), msd_scales=2, disc_channel_scale=1 / 16)
    rng = np.random.default_rng(5)
    batch = {"f0": (np.abs(rng.standard_normal((2, 16))) * 100).astype(np.float32),
             "bn": rng.standard_normal((2, 8, 16)).astype(np.float32),
             "spk": np.eye(4, dtype=np.float32)[[0, 1]],
             "audio": (rng.standard_normal((2, 256)) * 0.1).astype(np.float32)}
    cpu = GanTrainer(AnonymizationNet(cfg), h)
    gpu = GanTrainer(copy.deepcopy(cpu.model).cuda(), h)
    gpu.mpd.load_state_dict(cpu.mpd.state_dict())
    gpu.msd.load_state_dict(cpu.msd.state_dict())
    out = {}
    for dev, trainer in (("cpu", cpu), ("cuda", gpu)):
        m = trainer.train_step({k: torch.from_numpy(v).to(dev) for k, v in batch.items()})
        grads = {f"{part}.{n}": p.grad.cpu() for part, mod in
                 (("g", trainer.model), ("mpd", trainer.mpd), ("msd", trainer.msd))
                 for n, p in mod.named_parameters() if p.grad is not None}
        sn = {k: v.cpu() for k, v in trainer.msd.state_dict().items() if k.endswith((".u", ".v"))}
        out[dev] = ({k: float(v) for k, v in m.items()}, grads, sn)
    (m_c, g_c, sn_c), (m_g, g_g, sn_g) = out["cpu"], out["cuda"]

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))

    m_rel = max(abs(m_g[k] - m_c[k]) / abs(m_c[k]) for k in m_c)
    g_rel = max(rel(g_g[k], g_c[k]) for k in g_c)
    sn_rel = max(rel(sn_g[k], sn_c[k]) for k in sn_c)
    print(f"[gan-cpu] tiny GAN step, f32, TF32 off: metrics max rel {m_rel:.3e} (tolerance"
          f" 1e-4); gradients max rel {g_rel:.3e} over {len(g_c)} tensors (tolerance 1e-3);"
          f" spectral-norm (u, v) max rel {sn_rel:.3e} over {len(sn_c)} vectors (tolerance"
          f" 1e-5); loss_gen_all card {m_g['loss_gen_all']:.6f} vs CPU {m_c['loss_gen_all']:.6f}")
    check(set(g_g) == set(g_c) and len(sn_c) == 16, "the same gradients and SN state")
    check(m_rel <= 1e-4, "card GAN metrics depart from the CPU path")
    check(g_rel <= 1e-3, "card GAN gradients depart from the CPU path")
    check(sn_rel <= 1e-5, "card spectral-norm state departs from the CPU path")


def phase_gan_throughput(np, torch, card):
    """Full-width GAN steps (the flagship generator over 247 speakers, full
    MPD and MSD) from a fixed batch at segment 16320: B=32 f32 (hifigan.ini)
    and B=128 bf16 (hifigan_tpu.ini's policy). ms per step and audio-seconds
    per second (host clock, unprofiled), peak memory, then a profile of as
    many steps: the step's phases, busy share, launches, top device items.
    The profile is informational: nothing read from it can fail."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import warnings

    from satpu_torch import deterministic_convs, infer_helper
    from satpu_torch.hifigan.trainer import PHASES, GanHparams, GanTrainer

    def trainer_for(dtype, B):
        model = infer_helper.build_model("anonymizer_tdnnf_hifigan", device="cuda", seed=0,
                                         compute_dtype=dtype, **FLAGSHIP)
        trainer = GanTrainer(model, GanHparams(segment_size=GAN_SEGMENT, compute_dtype=dtype))
        return model, trainer, gan_batch(np, torch, B, "cuda")

    # the ops of a GAN step that PyTorch calls nondeterministic (under
    # deterministic_convs, train_vc's default)
    kinds = set()
    for dtype in ("float32", "bfloat16"):
        model, trainer, batch = trainer_for(dtype, 4)
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            with deterministic_convs(), warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                trainer.train_step(batch)
                torch.cuda.synchronize()
        finally:
            torch.use_deterministic_algorithms(False)
        kinds |= {str(w.message).split(" does not have")[0].split("\n")[0][:100]
                  for w in caught if "determinis" in str(w.message)}
        del model, trainer, batch
    print(f"[gan-throughput] ops of a GAN step (f32 and bf16) that torch calls"
          f" nondeterministic: {sorted(kinds) or 'none'}")

    for dtype, B, iters in (("float32", 32, 3), ("bfloat16", 128, 1)):
        model, trainer, batch = trainer_for(dtype, B)
        for _ in range(2):  # warm-up: cuDNN's algorithm search, the optimizers' state
            trainer.train_step(batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(iters):
            metrics = trainer.train_step(batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / iters
        # the same steps under train_vc's default deterministic conv algorithms
        with deterministic_convs():
            trainer.train_step(batch)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(iters):
                trainer.train_step(batch)
            torch.cuda.synchronize()
            det_wall = (time.perf_counter() - t0) / iters
        check(all(bool(torch.isfinite(torch.as_tensor(v))) for v in metrics.values()),
              f"GAN metrics not finite at B={B} {dtype}")
        peak = torch.cuda.max_memory_allocated() / 2**30
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                trainer.train_step(batch)
            torch.cuda.synchronize()
        host, dev = train_split(prof, iters, prefix="gan.", phases=PHASES)
        rows = [(e.self_device_time_total / iters, e.count // iters, e.key)
                for e in prof.key_averages() if e.device_type == DeviceType.CUDA
                and not e.is_user_annotation and e.self_device_time_total > 0]
        busy = sum(r[0] for r in rows) / 1e3
        audio = B * GAN_SEGMENT / SR
        print(f"[gan-throughput] B={B} x {GAN_SEGMENT} samples, {dtype}, generator 512 + MPD +"
              f" MSD: {wall * 1e3:.1f} ms/step (host clock), {audio / wall:.1f} audio-s/s; peak"
              f" mem {peak:.2f} GiB; with cuDNN's deterministic algorithms (train_vc's"
              f" default) {det_wall * 1e3:.1f} ms/step, {det_wall / wall - 1:+.1%} [{card}]")
        print(f"[gan-throughput]   profiled split ms/step, host / device: "
              + ", ".join(f"{k} {host[k]:.2f} / {dev[k]:.2f}" for k in host)
              + f", other - / {dev['other']:.2f}; device {busy:.2f} ms ="
              f" {busy / (wall * 1e3):.0%} busy of the unprofiled step,"
              f" {sum(r[1] for r in rows)} launches")
        for dev_us, count, key in sorted(rows, reverse=True)[:10]:
            print(f"[gan-profile]   {dev_us / 1e3:8.2f} ms {dev_us / 1e3 / busy:5.1%}"
                  f" x{count:<5d} {key[:90]}")
        del trainer, model, batch, prof


def phase_asv(np, torch, card):
    """The train_asv CLI on the card at ecapa.ini's widths and batch (ECAPA
    512, 192-d embedding, 80 mels, ArcMargin s=30 m=0.2, B=1024 as 16
    speakers x 64, 3 s segments, f32, SpecAugment and batch statistics) for 2
    epochs of 2 steps over 16 synthetic speakers x 4 voiced utterances of
    3.5-6 s: every epoch's loss and validation EER finite, the model and
    trainer checkpoints, best.ckpt and the metrics log written, best.ckpt
    loaded on the card and embedding the validation chunks."""
    from satpu_torch import infer_helper
    from satpu_torch.bin import train_asv
    from satpu_torch.sidekit.dataset import SideSet
    from satpu_torch.sidekit.trainer import extract_xvectors
    from satpu_torch.utils import kaldi_data

    root = os.path.join(WORK, "asv")
    data = os.path.join(root, "data")
    os.makedirs(data)
    wav_scp, utt2spk = {}, {}
    for s in range(ASV_SPEAKERS):
        for u in range(4):
            seconds = 3.5 + 2.5 * ((7 * s + 3 * u) % 8) / 7  # 3.5-6 s
            x = voiced_utterance(np, seconds, 90.0 + 12 * s + 5 * u, seed=500 + 10 * s + u)[0]
            utt = f"asv{s:02d}-u{u}"
            wav_scp[utt] = os.path.join(root, f"{utt}.wav")
            kaldi_data.write_wav(wav_scp[utt], x, SR)
            utt2spk[utt] = f"asv{s:02d}"
    kaldi_data.write_keyed_text(wav_scp, os.path.join(data, "wav.scp"))
    kaldi_data.write_keyed_text(utt2spk, os.path.join(data, "utt2spk"))
    exp = os.path.join(root, "exp")
    t0 = time.perf_counter()
    rc = train_asv.main(["--config", os.path.join(ROOT, ASV_CONFIG), "--train-set", data,
                         "--dirname", exp, "--samples-per-speaker", "2", "--epochs", "2"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(rc == 0, f"train_asv exited {rc}")
    with open(os.path.join(exp, "metrics.jsonl")) as f:
        logged = [json.loads(line) for line in f]
    check([r["epoch"] for r in logged] == [0, 1], f"epochs logged: {logged}")
    side = SideSet.from_data_dir(data)
    steps = 2 * ASV_SPEAKERS * 2 * 64 // 1024
    print(f"[asv] train_asv on cuda ({ASV_CONFIG}: ECAPA 512, 192-d, ArcMargin s=30 m=0.2,"
          f" B=1024 = 16 speakers x 64, 3 s, f32, SpecAugment, batch statistics): 2 epochs of"
          f" {steps // 2} steps over {len(side)} chunks of {len(wav_scp)} utterances (3.5-6 s)"
          f" in {wall:.1f} s (first call, cold) [{card}]")
    for r in logged:
        check(np.isfinite(r["loss"]) and np.isfinite(r["val_eer"]), f"epoch {r}")
        print(f"[asv]   epoch {int(r['epoch'])}: step {r['step']}, loss {r['loss']:.4f},"
              f" validation EER {100 * r['val_eer']:.2f}%")
    check(logged[-1]["step"] == steps, f"{logged[-1]['step']} steps, not {steps}")
    names = set(os.listdir(exp))
    want = {"0.ckpt", "1.ckpt", "trainer_0.ckpt", "trainer_1.ckpt", "best.ckpt",
            "metrics.jsonl"}
    check(want <= names and os.path.islink(os.path.join(exp, "best.ckpt")),
          f"written: {sorted(names)}")
    model, meta = infer_helper.load_model(os.path.join(exp, "best.ckpt"), device="cuda")
    model.eval()
    val = [side[i][0] for i in range(0, len(side), max(len(side) // 64, 1))][:64]
    xv = extract_xvectors(model, val)
    check(meta["model_id"] == "asv_xvector" and xv.shape == (len(val), 192)
          and bool(np.isfinite(xv).all()), f"best.ckpt x-vectors {xv.shape}")
    print(f"[asv] {sorted(want)} written; best.ckpt (epoch {meta['epoch']}, "
          f"{len(meta['speakers'])} speakers) loads on cuda and embeds the {len(val)}"
          f" validation chunks: finite {list(xv.shape)}")


def phase_asv_cpu(np, torch):
    """One tiny ECAPA step and one tiny half-ResNet step (24 mels, 32
    channels, 10 speakers, B=8 x 8000 samples, f32, SpecAugment off) on the
    card against the port's CPU path from the same weights and batch: the
    log-mel features (max abs error) and the loss from the audio; then, fed
    the CPU's features on both sides (the train-mode trunk amplifies a
    difference in its input features), the loss, the new batch-norm
    statistics and each gradient (max rel error each; tensors whose CPU
    gradient is under 1e-6 of the largest, zero in exact arithmetic, left
    out and counted). A ReLU input within rounding of zero takes either
    branch, so single gradient entries move by more than rounding between
    any two f32 runs (the half-ResNet's tensors by up to 4e-2 of their
    largest between the CPU's f32 and f64): the card's gradients are held,
    all tensors together, to the CPU's f64 ones in relative L2 norm within
    10 times the CPU f32's own departure (1e-4 at least)."""
    import copy

    from satpu_torch import infer_helper
    from satpu_torch.sidekit.trainer import AsvTrainer, make_asv_optimizer

    rng = np.random.default_rng(6)
    wav = torch.from_numpy((rng.standard_normal((8, 8000)) * 0.1).astype(np.float32))
    target = torch.arange(8) % 10

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))

    for arch in ("ecapa", "resnet"):
        cpu = infer_helper.build_model("asv_xvector", device="cpu", seed=3, arch=arch, n_mels=24,
                                       channels=32, embedding_size=16, num_speakers=10,
                                       spec_augment=False)
        feats = cpu.features(wav)
        f_abs = float((cpu.cuda().features(wav.cuda()).cpu() - feats).abs().max())
        cpu.cpu()
        out = {}
        for dev, dtype, fed in (("cpu", torch.float32, False), ("cuda", torch.float32, False),
                                ("cpu", torch.float32, True), ("cuda", torch.float32, True),
                                ("cpu", torch.float64, True)):
            model = copy.deepcopy(cpu).to(dev, dtype)
            if fed:
                model.features = lambda w, generator=None, d=dev, t=dtype: feats.to(d, t)
            trainer = AsvTrainer(model, make_asv_optimizer(model, lr=1e-3))
            m = trainer.train_step(wav.to(dev, dtype), target.to(dev))
            out[dev, dtype, fed] = (
                float(m["loss"]), {n: p.grad.cpu().double() for n, p in model.named_parameters()},
                {k: v.cpu().double() for k, v in model.state_dict().items() if "running" in k})
        f32 = torch.float32
        l_c, l_g = out["cpu", f32, False][0], out["cuda", f32, False][0]
        l_wav = abs(l_g - l_c) / abs(l_c)
        (l_c, g_c, s_c), (l_g, g_g, s_g) = out["cpu", f32, True], out["cuda", f32, True]
        g_64 = out["cpu", torch.float64, True][1]
        top = max(float(g.abs().max()) for g in g_c.values())
        live = [k for k, g in g_c.items() if float(g.abs().max()) > 1e-6 * top]
        l_rel = abs(l_g - l_c) / abs(l_c)
        s_rel = max(rel(s_g[k], s_c[k]) for k in s_c)
        g_rel = max(rel(g_g[k], g_c[k]) for k in live)

        def l2(grads):  # relative L2 distance to the f64 gradients, all tensors
            return float(sum(float(((grads[k] - g_64[k]) ** 2).sum()) for k in live) ** 0.5
                         / sum(float((g_64[k] ** 2).sum()) for k in live) ** 0.5)

        d_card, d_cpu = l2(g_g), l2(g_c)
        print(f"[asv-cpu] tiny {arch} step, f32, TF32 off, batch statistics: log-mel features"
              f" max abs err {f_abs:.3e} (tolerance 1e-3); from the audio, loss rel {l_wav:.3e}"
              f" (tolerance 1e-4); on the CPU's features, loss card {l_g:.6f} vs CPU {l_c:.6f},"
              f" rel {l_rel:.3e} (tolerance 1e-5), batch-norm statistics max rel {s_rel:.3e}"
              f" over {len(s_c)} tensors (tolerance 1e-5), gradients max rel {g_rel:.3e} over"
              f" {len(live)} tensors ({len(g_c) - len(live)} zero in exact arithmetic left"
              f" out); relative L2 distance to the CPU's f64 gradients: card {d_card:.3e}, CPU"
              f" f32 {d_cpu:.3e} (tolerance 10x the CPU's, 1e-4 at least)")
        check(f_abs <= 1e-3, f"card {arch} features depart from the CPU path")
        check(l_wav <= 1e-4, f"card {arch} loss from the audio departs from the CPU path")
        check(l_rel <= 1e-5, f"card {arch} loss departs from the CPU path")
        check(s_rel <= 1e-5, f"card {arch} batch-norm statistics depart from the CPU path")
        check(d_card <= max(10 * d_cpu, 1e-4), f"card {arch} gradients depart from the CPU's")


def phase_asv_throughput(np, torch, card):
    """Full-width ECAPA train steps (512 channels, 192-d, the ArcMargin head
    over VoxCeleb2 dev's 5994 speakers, SpecAugment on, batch statistics)
    from a fixed batch of 3 s segments: B=1024 f32, B=1024 bf16 (satpu's
    policy) and B=128 f32. ms per step and audio-seconds per second (host
    clock, unprofiled), peak memory, then a profile of as many steps: the
    step's phases (the trainer's ``asv.<phase>`` ranges), the busy share and
    the top device items. The profile is informational: nothing read from
    it can fail."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from satpu_torch import infer_helper
    from satpu_torch.sidekit.trainer import PHASES, AsvTrainer, make_asv_optimizer

    rng = np.random.default_rng(7)
    for dtype, B, iters in (("float32", 1024, 3), ("bfloat16", 1024, 3), ("float32", 128, 4)):
        model = infer_helper.build_model("asv_xvector", device="cuda", seed=0,
                                         num_speakers=ASV_HEAD)
        trainer = AsvTrainer(model, make_asv_optimizer(model), compute_dtype=dtype)
        wav = torch.from_numpy((rng.standard_normal((B, 3 * SR)) * 0.1).astype(np.float32)
                               ).cuda()
        target = torch.from_numpy(rng.integers(0, ASV_HEAD, B)).cuda()
        gen = torch.Generator(device="cuda").manual_seed(0)
        for _ in range(2):  # warm-up: cuDNN's algorithms, the optimizer's state
            trainer.train_step(wav, target, gen)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(iters):
            metrics = trainer.train_step(wav, target, gen)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / iters
        check(bool(torch.isfinite(metrics["loss"])), f"ASV loss not finite at B={B} {dtype}")
        peak = torch.cuda.max_memory_allocated() / 2**30
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                trainer.train_step(wav, target, gen)
            torch.cuda.synchronize()
        host, dev = train_split(prof, iters, prefix="asv.", phases=PHASES)
        rows = [(e.self_device_time_total / iters, e.count // iters, e.key)
                for e in prof.key_averages() if e.device_type == DeviceType.CUDA
                and not e.is_user_annotation and e.self_device_time_total > 0]
        busy = sum(r[0] for r in rows) / 1e3
        print(f"[asv-throughput] B={B} x 3 s, {dtype}, ECAPA 512 + ArcMargin over {ASV_HEAD}"
              f" speakers: {wall * 1e3:.1f} ms/step (host clock), {B * 3.0 / wall:.1f}"
              f" audio-s/s; peak mem {peak:.2f} GiB [{card}]")
        print(f"[asv-throughput]   profiled split ms/step, host / device: "
              + ", ".join(f"{k} {host[k]:.2f} / {dev[k]:.2f}" for k in host)
              + f", other - / {dev['other']:.2f}; device {busy:.2f} ms ="
              f" {busy / (wall * 1e3):.0%} busy of the unprofiled step,"
              f" {sum(r[1] for r in rows)} launches")
        for dev_us, count, key in sorted(rows, reverse=True)[:10]:
            print(f"[asv-profile]   {dev_us / 1e3:8.2f} ms {dev_us / 1e3 / busy:5.1%}"
                  f" x{count:<5d} {key[:90]}")
        del trainer, model, wav, prof
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# ASR-BN variants: chain data prep and the wav2vec2 / speaker-adversarial nets
# ---------------------------------------------------------------------------


def fbank_f64(torch, x):
    """The port's fbank (``ops.fbank.fbank``, 80 bins, snip_edges False) in
    f64 on the host, the same steps and constants: (log-mel [m, 80], mel
    energies [m, 80], each frame's total spectral power [m])."""
    from satpu_torch.ops.fbank import LOG_EPS, PREEMPHASIS, _povey_window, frame_signal, mel_banks

    w = torch.from_numpy(x).double()[None] * 32768.0
    frames = frame_signal(w, 400, 160, False)
    frames = frames - frames.mean(dim=-1, keepdim=True)
    prev = torch.cat([frames[..., :1], frames[..., :-1]], dim=-1)
    frames = (frames - PREEMPHASIS * prev) * torch.from_numpy(_povey_window(400)).double()
    spec = torch.fft.rfft(frames, n=512)
    power = spec.real ** 2 + spec.imag ** 2
    mel = power @ torch.from_numpy(mel_banks(80, 512, 16000.0)).double().T
    return torch.log(torch.clamp(mel, min=LOG_EPS))[0], mel[0], power.sum(-1)[0]


def fbank_cmvn_check(np, torch):
    """The port's fbank (+ utterance CMVN, as ``TDNNFNet.features`` runs them)
    on the card against the CPU, f32, utterance by utterance, on the slice
    phase's anonymized wavs and its voiced inputs; both against the same
    fbank in f64 on the host. A mel bin whose energy is a small share of its
    frame's spectral power holds f32 rounding amplified by the log (a share
    r rounds to about eps32 / sqrt(r) in the log), and cuFFT and the host's
    FFT round differently. The card is held to 10 times the CPU f32's own
    largest departure from f64 (and 1e-3 at least): then a card-CPU gap
    above the 1e-3 parity bound is rounding, not a fault. Prints where the
    gaps above 1e-3 lie (the largest energy share among their bins)."""
    from satpu_torch.ops.cmvn import utt_cmvn
    from satpu_torch.ops.fbank import fbank
    from satpu_torch.utils import kaldi_data

    for name, d in (("anonymized", "data_anon"), ("voiced input", "data")):
        scp = kaldi_data.read_wav_scp(os.path.join(WORK, d, "wav.scp"))
        gap = card64 = cpu64 = cmvn_gap = 0.0
        n_far, share_far, at = 0, 0.0, ""
        for utt in sorted(scp):
            x = kaldi_data.load_wav_from_scp(scp[utt])[0][0]
            f = {dev: fbank(torch.from_numpy(x).to(dev)[None] * 32768.0, num_mel_bins=80,
                            snip_edges=False)[0] for dev in ("cuda", "cpu")}
            c = {dev: utt_cmvn(v[None])[0].cpu() for dev, v in f.items()}
            f = {dev: v.cpu().double() for dev, v in f.items()}
            f64, mel, total = fbank_f64(torch, x)
            diff = (f["cuda"] - f["cpu"]).abs()
            if float(diff.max()) > gap:
                t, b = divmod(int(diff.argmax()), 80)
                gap, at = float(diff.max()), f"{utt} frame {t} bin {b}"
            card64 = max(card64, float((f["cuda"] - f64).abs().max()))
            cpu64 = max(cpu64, float((f["cpu"] - f64).abs().max()))
            cmvn_gap = max(cmvn_gap, float((c["cuda"] - c["cpu"]).abs().max()))
            far = diff > 1e-3
            n_far += int(far.sum())
            if far.any():
                share = mel / total[:, None].clamp_min(1e-300)
                share_far = max(share_far, float(share[far].max()))
        print(f"[fbank] {name} ({len(scp)} utterances): fbank card vs CPU max abs diff {gap:.3e}"
              f" ({at}), after CMVN {cmvn_gap:.3e} (parity bound 1e-3); against f64 on the host:"
              f" card {card64:.3e}, CPU f32 {cpu64:.3e} (tolerance 10x the CPU's, 1e-3 at"
              f" least); {n_far} entries differ by more than 1e-3, their bins' largest share"
              f" of the frame's power {share_far:.3e}")
        check(card64 <= max(10 * cpu64, 1e-3),
              f"the card's fbank departs from f64 more than the CPU's on the {name} wavs")


W2V2_WORDS = ["alpha", "bravo", "charlie", "delta", "echo", "foxtrot", "golf", "hotel",
              "india", "juliet", "kilo", "lima"]


def w2v2_data_dir(np, root: str) -> str:
    """A kaldi data dir of 32 voiced utterances of 3 s (F0 90-245 Hz, 8
    speakers) whose text is 3-6 words of ``W2V2_WORDS``. One length: the
    speed perturbation's allowed lengths are then 48000 and 48480 samples,
    the 0.9 copies land on the second, the 1.1 copies on none, and the egs
    fill two length buckets of about 30 (4 steps of B=16)."""
    from satpu_torch.utils import kaldi_data

    rng = np.random.default_rng(40)
    data = os.path.join(root, "data")
    os.makedirs(data)
    wav_scp, text, utt2spk = {}, {}, {}
    for i in range(32):
        utt = f"w{i % 8}-u{i:02d}"
        x = voiced_utterance(np, EG_SECONDS, 90.0 + 5 * i, seed=700 + i)[0]
        wav_scp[utt] = os.path.join(data, f"{utt}.wav")
        kaldi_data.write_wav(wav_scp[utt], x, SR)
        text[utt] = " ".join(rng.choice(W2V2_WORDS, int(rng.integers(3, 7))))
        utt2spk[utt] = f"w{i % 8}"
    kaldi_data.write_keyed_text(wav_scp, os.path.join(data, "wav.scp"))
    kaldi_data.write_keyed_text(text, os.path.join(data, "text"))
    kaldi_data.write_keyed_text(utt2spk, os.path.join(data, "utt2spk"))
    return data


def train_asr_cli(torch, config: str, args, env):
    """train_asr.main on ``config`` with the ini's [var] entries given by the
    environment ``env`` (as a user sets them); returns (rc, wall seconds, den
    kernel launches, logged metrics)."""
    from satpu_torch.bin import train_asr
    from satpu_torch.chain import den_fb

    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    n0 = [kernel_launches(k) for k in ("k2f", "k2b")]
    t0 = time.perf_counter()
    try:
        rc = train_asr.main(["--config", os.path.join(ROOT, config)] + list(args))
        torch.cuda.synchronize()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    wall = time.perf_counter() - t0
    launches = {"den_fb_forward": kernel_launches("k2f") - n0[0],
                "den_fb_backward": kernel_launches("k2b") - n0[1]}
    with open(os.path.join(env["exp"], "metrics.jsonl")) as f:
        logged = [json.loads(line) for line in f]
    return rc, wall, launches, logged


def phase_w2v2_train(np, torch, card):
    """The prepare_data -> train_asr path of egs/asr/librispeech/configs/
    tdnnf_wav2vec2_vq_48.ini at full width: prepare_data (prepare_data.ini:
    grapheme lexicon, speed perturbation, 12 allowed lengths) over 32 voiced
    utterances, then the train_asr CLI with the ini (wav2vec2 large, TDNN-F
    1024 [3,3,3] / [1,3,3,3], VQ-48, NG on, B=16, f32; random init instead
    of the ini's warm start, the prepared tree's pdfs) for one epoch of 4
    steps with held-out diagnostics every step. Checks the logged objf, that
    every step launched K2f and K2b, and that final.ckpt loads through
    ``infer_helper.load_model`` on the card as ``asrbn_tdnnf_wav2vec2`` and
    gives finite ``extract_bn`` features whose VQ indices lie in the
    codebook. Then 2 steps each of the same net under the bf16 training
    policy and of tdnnf_spkadv.ini (B=32, one batch a length bucket).
    Returns the den kernels' launches over the 4-step run."""
    from satpu_torch import infer_helper
    from satpu_torch.bin import prepare_data
    from satpu_torch.models.asrbn import wav2vec2_output_num_frames

    root = os.path.join(WORK, "w2v2")
    data = w2v2_data_dir(np, root)
    prep = os.path.join(root, "prep")
    t0 = time.perf_counter()
    rc = prepare_data.main(["--config", os.path.join(ROOT, W2V2_PREP_CONFIG),
                            "--data-dir", data, "--out-dir", prep])
    check(rc == 0, f"prepare_data exited {rc}")
    with open(os.path.join(prep, "num_pdfs")) as f:
        num_pdfs = int(f.read())
    lengths = sorted(set(open(os.path.join(prep, "egs", "utt2len")).read().split()[1::2]))
    n_egs = len(open(os.path.join(prep, "egs", "wav.scp")).read().splitlines())
    print(f"[w2v2-train] prepare_data ({W2V2_PREP_CONFIG}) over 32 voiced utterances of"
          f" {EG_SECONDS} s in {time.perf_counter() - t0:.1f} s: {n_egs} egs at lengths"
          f" {lengths}, {num_pdfs} pdfs, den.fst, normalization.fst, numerators, HCLG.fst")

    exp = os.path.join(root, "exp")
    rc, wall, launches, logged = train_asr_cli(
        torch, W2V2_CONFIG, ["--num-pdfs", str(num_pdfs), "--init-weight-model", "",
                             "--num-epochs", "1", "--diagnostics-interval", "1",
                             "--wav2vec2-layers", str(CUT_LAYERS)],
        {"prep": prep, "exp": exp})
    check(rc == 0, f"train_asr exited {rc}")
    steps = [r["step"] for r in logged]
    print(f"[w2v2-train] train_asr on cuda ({W2V2_CONFIG}: wav2vec2 large at {CUT_LAYERS}"
          f" layers, TDNN-F 1024, VQ-48,"
          f" {num_pdfs} pdfs, NG on, B=16, f32) {len(steps)} steps + held-out diagnostics"
          f" every step in {wall:.1f} s (first call, cold); den kernel launches {launches}"
          f" [{card}]")
    check(steps == [1, 2, 3, 4], f"steps logged: {steps}")
    check(all(n >= len(steps) for n in launches.values()),
          f"a den kernel was not launched once a step: {launches}")
    for r in logged:
        check(all(np.isfinite(r[k]) for k in ("chain_objf", "loss", "valid_objf", "vq_loss")),
              f"objf not finite at step {r['step']}: {r}")
        print(f"[w2v2-train]   step {r['step']}: objf {r['chain_objf']:.4f} (num"
              f" {r['num_logprob']:.3f}, den {r['den_logprob']:.3f}), loss {r['loss']:.4f},"
              f" vq_loss {r['vq_loss']:.4f}, perplexity {r['vq_perplexity']:.2f}, valid objf"
              f" {r['valid_objf']:.4f}, lr {r['lr']:.7f}")

    model, meta = infer_helper.load_model(os.path.join(exp, "final.ckpt"), device="cuda")
    c, w = model.cfg, model.w2v2
    check(meta["model_id"] == "asrbn_tdnnf_wav2vec2"
          and (w.hidden_size, w.num_hidden_layers, c.hidden_dim, c.codebook_size)
          == (1024, CUT_LAYERS, 1024, 48), f"final.ckpt: {meta['model_id']} {c} {w}")
    n_params = sum(p.numel() for p in model.parameters())
    x = voiced_utterance(np, EG_SECONDS, 140.0, seed=9)[0]
    with torch.inference_mode():
        bn = model.eval().extract_bn(torch.from_numpy(x)[None].cuda())
        idx = model.tdnnfs[-1].tdnn.bottleneck_func.vq(bn.transpose(1, 2))[3]
    check(bool(torch.isfinite(bn).all()) and bn.shape[-1] == c.prefinal_bottleneck_dim,
          f"extract_bn {tuple(bn.shape)}")
    check(0 <= int(idx.min()) and int(idx.max()) < c.codebook_size, "VQ indices out of range")
    t_out = wav2vec2_output_num_frames(len(x), c, w)
    print(f"[w2v2-train] final.ckpt loads on cuda as asrbn_tdnnf_wav2vec2 ({n_params / 1e6:.1f}"
          f" M weights); extract_bn on {EG_SECONDS} s: finite {list(bn.shape)}, VQ indices"
          f" {sorted(set(idx.flatten().tolist()))} of {c.codebook_size}; the net's chain frames"
          f" for {len(x)} samples {t_out} (the egs' count {((len(x) + 80) // 160 - 2) // 3})")
    del model

    for name, config, extra in (
            ("tdnnf_wav2vec2_vq bf16", W2V2_CONFIG, ["--compute-dtype", "bfloat16",
                                                      "--init-weight-model", "",
                                                      "--wav2vec2-layers", str(CUT_LAYERS)]),
            ("tdnnf_spkadv", SPKADV_CONFIG, [])):
        exp2 = os.path.join(root, name.split()[0] + ("_bf16" if "bf16" in name else ""))
        rc, wall, runs, logged = train_asr_cli(
            torch, config, ["--num-pdfs", str(num_pdfs), "--num-epochs", "1",
                            "--minibatch-size", "32", "--diagnostics-interval", "1"] + extra,
            {"prep": prep, "exp": exp2})
        check(rc == 0, f"train_asr {name} exited {rc}")
        check([r["step"] for r in logged] == [1, 2], f"{name}: steps {logged}")
        check(all(n >= 2 for n in runs.values()), f"{name}: den kernel launches {runs}")
        for r in logged:
            check(all(np.isfinite(v) for v in r.values()), f"{name}: not finite: {r}")
        keys = ("chain_objf", "loss", "vq_loss", "spkadv_loss", "spkadv_accuracy")
        print(f"[w2v2-train] train_asr {name} (B=32, full width) 2 steps in {wall:.1f} s"
              f" (cold): " + "; ".join(", ".join(f"{k} {r[k]:.4f}" for k in keys if k in r)
                                       for r in logged) + f"; den kernel launches {runs}")
        _, meta = infer_helper.load_model(os.path.join(exp2, "final.ckpt"), device="cuda")
        check(meta["model_id"] == ("asrbn_tdnnf_spkadv" if "spkadv" in name
                                   else "asrbn_tdnnf_wav2vec2"), f"{name}: {meta['model_id']}")
    shutil.rmtree(root, ignore_errors=True)
    return launches


def w2v2_tiny(infer_helper, kind: str):
    """The w2v2-cpu phase's tiny nets (random weights from seed 0, dropout
    0, NG on): (model_id, build params)."""
    net = dict(output_dim=40, hidden_dim=32, bottleneck_dim=16, prefinal_bottleneck_dim=16,
               p_dropout=0.0, natural_gradient=True)
    if kind == "wav2vec2":
        return "asrbn_tdnnf_wav2vec2", dict(
            net, bottleneck="vq", codebook_size=8, kernel_size_list=[3, 3, 3],
            subsampling_factor_list=[1, 1, 1],
            wav2vec2=dict(conv_dim=[32] * 7, hidden_size=64, num_hidden_layers=2,
                          num_attention_heads=4, intermediate_size=128,
                          num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4))
    return "asrbn_tdnnf_spkadv", dict(net, num_speakers=4)


def phase_w2v2_cpu(np, torch):
    """One tiny train step on the card against the port's CPU path, f32 with
    TF32 off, for a wav2vec2-VQ net (the real 7-conv front at 32 channels,
    hidden 64, 2 layers) and a speaker-adversarial net (its half-ResNet
    branch), from the same weights, NG states and batch (B=4 x 1 s over the
    5-phone den graph): the loss, the gradients of all tensors together in
    relative L2, and the batch-norm statistics after the step. The
    train-mode nets are ill-conditioned at f32 (a VQ, batch norms over the
    batch, ReLUs within rounding of zero), so each quantity is held against
    the CPU's f64 step to 10 times the CPU f32's own departure from it (and
    1e-4 at least), as the asv-cpu phase holds the half-ResNet."""
    import copy

    from satpu_torch import infer_helper
    from satpu_torch.chain.fst import fst_rmepsilon, fst_to_arrays, pad_graph_arrays
    from satpu_torch.chain.objf import DenominatorGraph, graphs_to_torch
    from satpu_torch.chain.prep import numerator_fst, random_bigram_den, random_phone_walk
    from satpu_torch.chain.trainer import ChainTrainer

    fst, tree, trans = random_bigram_den(5, 3, seed=2)
    den = DenominatorGraph.from_fst(fst, tree.num_pdfs)
    rng = np.random.default_rng(8)
    wav = np.stack([voiced_utterance(np, 1.0, 110.0 + 30 * k, seed=60 + k)[0]
                    for k in range(4)])
    frames = np.full(4, ((16000 + 80) // 160 - 2) // 3, np.int32)
    graphs = pad_graph_arrays([fst_to_arrays(fst_rmepsilon(numerator_fst(
        random_phone_walk(trans, int(frames[0]) // 3, rng), tree))) for _ in range(4)])
    target = np.array([0, 1, 2, 3])
    for kind in ("wav2vec2", "spkadv"):
        model_id, params = w2v2_tiny(infer_helper, kind)
        base = infer_helper.build_model(model_id, device="cpu", seed=0, **params)
        out = {}
        for dev, dtype in (("cpu", torch.float64), ("cpu", torch.float32),
                           ("cuda", torch.float32)):
            model = copy.deepcopy(base).to(dev, dtype)
            trainer = ChainTrainer(model, den, seed=0)
            kw = {"spk_target": torch.from_numpy(target).to(dev)} if kind == "spkadv" else {}
            loss, m = trainer.compute_grads(torch.from_numpy(wav).to(dev),
                                            graphs_to_torch(graphs, dev),
                                            torch.from_numpy(frames).to(dev), **kw)
            out[dev, dtype] = (float(loss), {n: p.grad.cpu().double()
                                              for n, p in model.named_parameters()},
                               {k: v.cpu().double() for k, v in model.state_dict().items()
                                if "running" in k})
        ref = out["cpu", torch.float64]

        def departs(o):
            l_rel = abs(o[0] - ref[0]) / abs(ref[0])
            g = (sum(float(((o[1][k] - ref[1][k]) ** 2).sum()) for k in ref[1]) ** 0.5
                 / sum(float((v ** 2).sum()) for v in ref[1].values()) ** 0.5)
            s = max(float((o[2][k] - ref[2][k]).abs().max() / ref[2][k].abs().max()
                          .clamp_min(1e-30)) for k in ref[2])
            return l_rel, g, s

        own, card = departs(out["cpu", torch.float32]), departs(out["cuda", torch.float32])
        print(f"[w2v2-cpu] tiny {kind} step, f32, TF32 off, B=4 x 1 s: against the CPU's f64"
              f" step, loss rel card {card[0]:.3e} / CPU f32 {own[0]:.3e}; gradients in relative"
              f" L2 over {len(ref[1])} tensors card {card[1]:.3e} / CPU f32 {own[1]:.3e};"
              f" batch-norm statistics max rel card {card[2]:.3e} / CPU f32 {own[2]:.3e}"
              f" (tolerance 10x the CPU f32's, 1e-4 at least)")
        for what, c_, o_ in zip(("loss", "gradients", "batch-norm statistics"), card, own):
            check(c_ <= max(10 * o_, 1e-4), f"card {kind} {what} depart from the CPU path")


def phase_w2v2_den(np, torch, fx):
    """K2f and K2b held against their plain versions (bitwise on repeat) on
    the chain output, at this path's T, of the full-width B5 extractor
    (wav2vec2 large at CUT_LAYERS layers + TDNN-F 1024 + VQ-48, NG on, f32,
    the front's 1/20 update factor) after two train steps from a fixed
    batch of B=16 x 3 s (the ini's batch) at 3280 pdfs on the 1641-state den
    graph. Returns the den kernels' largest errors."""
    from satpu_torch import infer_helper
    from satpu_torch.chain import den_fb
    from satpu_torch.chain.fst import Fst
    from satpu_torch.chain.objf import DenominatorGraph
    from satpu_torch.chain.trainer import ChainTrainer, ChainTrainOpts
    from satpu_torch.models.asrbn import wav2vec2_tdnnf_config

    den = DenominatorGraph.from_fst(Fst.read(fx["den_fst"]), NUM_PDFS)
    B = 16
    wav = torch.from_numpy(np.stack([voiced_utterance(np, EG_SECONDS, 95.0 + 9 * k,
                                                      seed=900 + k)[0] for k in range(B)])).cuda()
    _, graphs, frames = chain_batch(torch, fx, B, "cuda")
    params = dict(dataclasses.asdict(wav2vec2_tdnnf_config(NUM_PDFS, "vq", 48)),
                  natural_gradient=True, compute_dtype="float32",
                  wav2vec2=dataclasses.asdict(w2v2_cut()))
    model = infer_helper.build_model("asrbn_tdnnf_wav2vec2", device="cuda", seed=0, **params)
    trainer = ChainTrainer(model, den, ChainTrainOpts(lr=3e-4, compute_dtype="float32"),
                           lr_schedule=lambda step: 3e-4,
                           preprocessor_schedule=lambda step: 1.0 / 20.0)
    for _ in range(2):  # the first is an NG subspace-update step
        trainer.step(wav, graphs, frames)
    with torch.no_grad():
        co = model.train()(wav, generator=trainer.generator)[0].float()
    e_f, e_b, *_ = den_check(torch, den_fb, den.tensors("cuda"), co, den_fb.leak_log(1e-5),
                             f"wav2vec2 chain_out (T={co.shape[1]})")
    del trainer, model
    torch.cuda.empty_cache()
    return e_f, e_b


# ---------------------------------------------------------------------------
# The WavLM-large x-vector front (eval_anon, ASV training) and model
# distribution (a reference final.pt -> import_model -> hub -> anonymize)
# ---------------------------------------------------------------------------


def device_rows(prof, iters: int):
    """[(device us per call, launches per call, name)] of a profile, largest
    first."""
    from torch.autograd import DeviceType

    return sorted(((e.self_device_time_total / iters, e.count // iters, e.key)
                   for e in prof.key_averages() if e.device_type == DeviceType.CUDA
                   and not e.is_user_annotation and e.self_device_time_total > 0),
                  reverse=True)


def phase_wavlm_eval(np, torch, card):
    """The eval_anon CLI with the WavLM-large + ECAPA-512 judge, on the card
    and then on the CPU, over the slice phase's dirs (original enrolment,
    anonymized trials: 24 trials); every x-vector the CLI extracts is kept
    (``extract_xvectors`` wrapped) to compare the devices. Returns the
    checkpoint's path."""
    from satpu_torch import infer_helper
    from satpu_torch.bin import eval_anon
    from satpu_torch.sidekit import scoring, trainer
    from satpu_torch.utils import kaldi_data

    root = os.path.join(WORK, "wavlm")
    os.makedirs(root)
    path = os.path.join(root, "asv_wavlm.pt")
    t0 = time.perf_counter()
    params = wavlm_asv()
    model = infer_helper.build_model("asv_xvector", device="cuda", seed=0, **params)
    c, w = model.cfg, model.preprocessor.feature_extract.cfg
    check((c.arch, c.channels, c.embedding_size, c.num_speakers, c.arc_s, c.arc_m, w.hidden_size,
           w.num_hidden_layers, w.num_attention_heads, w.intermediate_size, w.num_buckets,
           w.max_bucket_distance, w.do_stable_layer_norm, w.feat_extract_norm, w.conv_bias,
           w.num_conv_pos_embeddings, w.num_conv_pos_embedding_groups, w.conv_dim[0])
          == ("ecapa", 512, 192, 1211, 30.0, 0.2, 1024, CUT_LAYERS, 16, 4096, 320, 800, True,
              "layer", True, 128, 16, 512), "WavLM-large + ECAPA-512 widths")
    norms = calibrate_norms(np, torch, model)
    n = sum(v.numel() for v in model.state_dict().values())
    n_front = sum(p.numel() for p in model.preprocessor.parameters())
    infer_helper.save_model(path, "asv_xvector", params, model.state_dict())
    del model
    torch.cuda.empty_cache()
    print(f"[wavlm-eval] asv_xvector (WavLM-large cut to {CUT_LAYERS} of its 24 x 1024 layers,"
          f" 16 heads, FFN 4096,"
          f" 320 buckets over 800, pre-norm, layer-norm extractor; ECAPA-512 on 1024 channels,"
          f" 192-d, ArcMargin over 1211): {n / 1e6:.2f} M weights ({n_front / 1e6:.2f} M in the"
          f" front) from seed 0, {norms} batch norms calibrated, saved in"
          f" {time.perf_counter() - t0:.1f} s")

    data, anon = os.path.join(WORK, "data"), os.path.join(WORK, "data_anon")
    utt2spk = kaldi_data.read_keyed_text(os.path.join(data, "utt2spk"))
    anon_utts = sorted(kaldi_data.read_wav_scp(os.path.join(anon, "wav.scp")))
    speakers = list(dict.fromkeys(utt2spk[u] for u in kaldi_data.read_wav_scp(
        os.path.join(data, "wav.scp"))))  # the CLI's enrolment order
    trials = [(s, u, utt2spk[u] == s) for u in anon_utts for s in sorted(speakers)]
    trials_path = os.path.join(root, "trials")
    with open(trials_path, "w") as f:
        f.writelines(f"{s} {u} {'target' if t else 'nontarget'}\n" for s, u, t in trials)
    real = trainer.extract_xvectors
    calls = []

    def recorded(*args, **kw):
        out = real(*args, **kw)
        calls.append(out)
        return out

    def run(device):
        res = os.path.join(root, f"results_{device}")
        calls.clear()
        trainer.extract_xvectors = recorded
        t0 = time.perf_counter()
        try:
            rc = eval_anon.main([
                "--device", device, "--data", anon, "--asv-checkpoint", path,
                "--enroll-dir", data, "--trials", trials_path, "--xvector-mode", "chunked",
                "--results", res])
        finally:
            trainer.extract_xvectors = real
        wall = time.perf_counter() - t0
        check(rc == 0, f"eval_anon with the WavLM judge on {device} exited {rc}")
        with open(os.path.join(res, "results.json")) as f:
            asv = json.load(f)["asv"]
        # asv_test: one call per enrolment speaker, then the trial utterances
        check(len(calls) == len(speakers) + 1, f"{len(calls)} x-vector calls")
        means = {s: x.mean(0) / max(np.linalg.norm(x.mean(0)), 1e-12)
                 for s, x in zip(speakers, calls)}
        utt = dict(zip(list(dict.fromkeys(u for _, u, _ in trials)), calls[-1]))
        scores = scoring.cosine_scoring(np.stack([means[s] for s, _, _ in trials]),
                                        np.stack([utt[u] for _, u, _ in trials]))
        return asv, wall, np.concatenate(calls), scores

    asv, wall, xv, scores = run("cuda")
    print(f"[wavlm-eval] eval_anon CLI on cuda: {len(anon_utts)} anonymized utterances,"
          f" {len(trials)} trials ({sum(t for *_, t in trials)} target), chunked x-vectors, in"
          f" {wall:.2f} s (first call, cold) [{card}]")
    print(f"[wavlm-eval]   asv {json.dumps(asv)}")
    check(all(np.isfinite(v) for v in asv.values()) and 0 <= asv["eer"] <= 100
          and "asnorm_eer" in asv, f"asv results {asv}")
    check(xv.shape[1] == 192 and bool(np.isfinite(xv).all()), "WavLM x-vectors")
    asv_cpu, wall_cpu, xv_cpu, scores_cpu = run("cpu")
    cos = float(((xv * xv_cpu).sum(1) / np.linalg.norm(xv, axis=1)
                 / np.linalg.norm(xv_cpu, axis=1)).min())
    same_rank = bool((np.argsort(scores, kind="stable")
                      == np.argsort(scores_cpu, kind="stable")).all())
    distinct = np.unique(scores_cpu)
    gap = float(np.diff(distinct).min()) if len(distinct) > 1 else float("inf")
    print(f"[wavlm-eval] cuda vs cpu (f32, TF32 off; the CPU CLI {wall_cpu:.2f} s): x-vector"
          f" cosine min {cos:.7f} over {len(xv)} rows ({len(np.unique(xv_cpu, axis=0))} distinct"
          f" on the CPU); trial ranking equal {same_rank} (score max abs diff"
          f" {float(np.abs(scores - scores_cpu).max()):.3e}, {len(distinct)} distinct scores of"
          f" {len(trials)}, smallest gap {gap:.3e}); EER {asv['eer']:.4f} vs"
          f" {asv_cpu['eer']:.4f}; ASV metrics max abs diff"
          f" {max(abs(asv[k] - asv_cpu[k]) for k in asv):.3e}")
    check(cos >= 0.9999, "the card's WavLM x-vectors depart from the CPU path")
    check(same_rank, "the card ranks the trials differently from the CPU path")
    check(asv["eer"] == asv_cpu["eer"], "the card's EER differs from the CPU path's")
    return path


def phase_wavlm_throughput(np, torch, card, path):
    """x-vector extraction with the WavLM judge on the card: chunked, B=64
    windows of 3 s, f32 (TF32 off): audio-seconds per second, ms a batch,
    device ms and busy share, launches, peak memory, the top device items."""
    from torch.profiler import ProfilerActivity, profile

    from satpu_torch import infer_helper
    from satpu_torch.sidekit.trainer import extract_xvectors

    rng = np.random.default_rng(8)
    model, _ = infer_helper.load_model(path)
    windows = list((rng.standard_normal((64, 3 * SR)) * 0.1).astype(np.float32))
    extract_xvectors(model, windows)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    iters = 3
    t0 = time.perf_counter()
    for _ in range(iters):
        xv = extract_xvectors(model, windows)
    wall = (time.perf_counter() - t0) / iters
    peak = torch.cuda.max_memory_allocated() / 2**30
    check(xv.shape == (64, 192) and bool(np.isfinite(xv).all()), "WavLM x-vector batch")
    span, dev, launches = busy_share(torch, lambda: extract_xvectors(model, windows))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        extract_xvectors(model, windows)
        torch.cuda.synchronize()
    rows = device_rows(prof, 1)
    busy = sum(r[0] for r in rows) / 1e3
    print(f"[wavlm-throughput] x-vectors, WavLM-large ({CUT_LAYERS} layers) + ECAPA-512, chunked,"
          f" B=64 windows of 3 s,"
          f" f32: {64 * 3.0 / wall:.1f} audio-s/s ({wall * 1e3:.1f} ms a batch, host clock);"
          f" device {dev:.1f} of {span:.1f} ms = {dev / span:.0%} busy, {launches} launches;"
          f" peak mem {peak:.2f} GiB [{card}]")
    for dev_us, count, key in rows[:5]:
        print(f"[wavlm-profile]   {dev_us / 1e3:8.2f} ms {dev_us / 1e3 / busy:5.1%}"
              f" x{count:<5d} {key[:90]}")
    del model
    torch.cuda.empty_cache()


def wavlm_train_steps(np, torch, model, B: int, dtype: str, iters: int):
    """A trainer of ``model`` (a fresh AdamW) at B x 3 s: 2 warm-up steps and
    ``iters`` timed ones. Returns (trainer, batch, ms/step, peak GiB, last
    metrics)."""
    from satpu_torch.sidekit.trainer import AsvTrainer, make_asv_optimizer

    rng = np.random.default_rng(9)
    trainer = AsvTrainer(model, make_asv_optimizer(model), compute_dtype=dtype)
    batch = (torch.from_numpy((rng.standard_normal((B, 3 * SR)) * 0.1).astype(np.float32)
                              ).cuda(),
             torch.from_numpy(rng.integers(0, ASV_HEAD, B)).cuda(),
             torch.Generator(device="cuda").manual_seed(0))
    for _ in range(2):
        trainer.train_step(*batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(iters):
        metrics = trainer.train_step(*batch)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / iters
    return trainer, batch, wall, torch.cuda.max_memory_allocated() / 2**30, metrics


def phase_wavlm_train(np, torch, card):
    """ASV train steps of the WavLM-large + ECAPA-512 judge with the head over
    VoxCeleb2 dev's 5994 speakers, B=64 x 3 s (halved until it fits), f32
    then bf16 (satpu's policy, the front included; the same model, a fresh
    optimizer), 4 timed steps each after 2 of warm-up: ms per step,
    audio-seconds per second, peak memory, then a profile of 4 steps: the
    ``asv.<phase>`` split (host / device ms), the busy share, launches and
    the top items. Then one small-width step (a 2-layer, 32-wide WavLM,
    ECAPA 32) on the card against the CPU."""
    import gc

    from torch.profiler import ProfilerActivity, profile

    from satpu_torch import infer_helper
    from satpu_torch.sidekit.trainer import PHASES

    iters = 4
    model = infer_helper.build_model("asv_xvector", device="cuda", seed=0,
                                     num_speakers=ASV_HEAD, **wavlm_asv())
    for dtype in ("float32", "bfloat16"):
        B = 64
        while True:
            try:
                trainer, batch, wall, peak, metrics = wavlm_train_steps(np, torch, model, B,
                                                                        dtype, iters)
                break
            except torch.cuda.OutOfMemoryError:
                trainer = batch = None
            gc.collect()
            torch.cuda.empty_cache()
            print(f"[wavlm-train]   B={B} {dtype} does not fit in the card's memory")
            B //= 2
            check(B >= 8, "the WavLM train step does not fit at B=8")
        check(bool(torch.isfinite(metrics["loss"])), f"WavLM ASV loss not finite ({dtype})")
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                trainer.train_step(*batch)
            torch.cuda.synchronize()
        host, dev = train_split(prof, iters, prefix="asv.", phases=PHASES)
        rows = device_rows(prof, iters)
        busy = sum(r[0] for r in rows) / 1e3
        print(f"[wavlm-train] B={B} x 3 s, {dtype}, WavLM-large ({CUT_LAYERS} layers) + ECAPA-512"
              f" + ArcMargin over"
              f" {ASV_HEAD} speakers: {wall * 1e3:.1f} ms/step (host clock),"
              f" {B * 3.0 / wall:.1f} audio-s/s; peak mem {peak:.2f} GiB; loss"
              f" {float(metrics['loss']):.4f} [{card}]")
        print(f"[wavlm-train]   profiled split ms/step, host / device: "
              + ", ".join(f"{k} {host[k]:.2f} / {dev[k]:.2f}" for k in host)
              + f", other - / {dev['other']:.2f}; device {busy:.2f} ms ="
              f" {busy / (wall * 1e3):.0%} busy of the unprofiled step,"
              f" {sum(r[1] for r in rows)} launches")
        for dev_us, count, key in rows[:5]:
            print(f"[wavlm-profile]   {dev_us / 1e3:8.2f} ms {dev_us / 1e3 / busy:5.1%}"
                  f" x{count:<5d} {key[:90]}")
        del trainer, batch, prof
        gc.collect()
        torch.cuda.empty_cache()
    del model
    torch.cuda.empty_cache()
    wavlm_train_cpu(np, torch)


def wavlm_train_cpu(np, torch):
    """One small-width WavLM-ECAPA train step (WAVLM_TINY, B=8 x 8000
    samples, f32, TF32 off) on the card against the port's CPU path from the
    same weights and batch: the loss (rel 1e-4), and the gradients and new
    batch-norm statistics held, all tensors together, to the CPU's f64 ones
    in relative L2 within 10 times the CPU f32's own departure (1e-4 at
    least), as asv-cpu holds the mel trunks."""
    import copy

    from satpu_torch import infer_helper
    from satpu_torch.sidekit.trainer import AsvTrainer, make_asv_optimizer

    rng = np.random.default_rng(10)
    wav = torch.from_numpy((rng.standard_normal((8, 8000)) * 0.1).astype(np.float32))
    target = torch.arange(8) % 10
    cpu = infer_helper.build_model("asv_xvector", device="cpu", seed=3, **WAVLM_TINY)
    out = {}
    for dev, dtype in (("cpu", torch.float32), ("cuda", torch.float32), ("cpu", torch.float64)):
        model = copy.deepcopy(cpu).to(dev, dtype)
        trainer = AsvTrainer(model, make_asv_optimizer(model, lr=1e-3))
        m = trainer.train_step(wav.to(dev, dtype), target.to(dev))
        out[dev, dtype] = (
            float(m["loss"]), {n: p.grad.cpu().double() for n, p in model.named_parameters()},
            {k: v.cpu().double() for k, v in model.state_dict().items() if "running" in k})
    (l_c, g_c, s_c), (l_g, g_g, s_g) = out["cpu", torch.float32], out["cuda", torch.float32]
    _, g_64, s_64 = out["cpu", torch.float64]

    def l2(a, b):
        return float(sum(float(((a[k] - b[k]) ** 2).sum()) for k in b) ** 0.5
                     / sum(float((b[k] ** 2).sum()) for k in b) ** 0.5)

    l_rel = abs(l_g - l_c) / abs(l_c)
    dg_card, dg_cpu = l2(g_g, g_64), l2(g_c, g_64)
    ds_card, ds_cpu = l2(s_g, s_64), l2(s_c, s_64)
    print(f"[wavlm-train-cpu] small WavLM-ECAPA step, f32, TF32 off, batch statistics: loss card"
          f" {l_g:.6f} vs CPU {l_c:.6f}, rel {l_rel:.3e} (tolerance 1e-4); relative L2 distance"
          f" to the CPU's f64 over {len(g_64)} gradients: card {dg_card:.3e}, CPU f32"
          f" {dg_cpu:.3e}; over {len(s_64)} batch-norm statistics: card {ds_card:.3e}, CPU f32"
          f" {ds_cpu:.3e} (tolerance 10x the CPU's, 1e-4 at least)")
    check(l_rel <= 1e-4, "card WavLM loss departs from the CPU path")
    check(dg_card <= max(10 * dg_cpu, 1e-4), "card WavLM gradients depart from the CPU's")
    check(ds_card <= max(10 * ds_cpu, 1e-4), "card WavLM statistics depart from the CPU's")


def reference_name(key: str) -> str:
    """A port anonymizer key -> the reference's (the names satpu's importer
    reads): TDNN-F Sequential index k -> 2k (a dropout follows every layer),
    the VQ's ``vq.*`` -> ``quant._*``."""
    key = re.sub(r"\b(tdnnfs|tdnnfs_after)\.(\d+)\.",
                 lambda m: f"{m.group(1)}.{2 * int(m.group(2))}.", key)
    for new, old in (("vq.embedding", "quant._embedding.weight"),
                     ("vq.ema_cluster_size", "quant._ema_cluster_size"),
                     ("vq.ema_w", "quant._ema_w")):
        key = key.replace("bottleneck_func." + new, "bottleneck_func." + old)
    return key


def phase_distribution(np, torch, card, ckpt):
    """A reference-format final.pt of the flagship anonymizer's weights ->
    the import_model CLI into a fresh zoo -> ``hub.load(tag +
    "+f0-transformation=quant_16")`` on the card, its convert held against
    the original checkpoint's -> ``anonymize --num-procs 2`` with the zoo
    checkpoint over the slice's 8 utterances against one process; then a
    run whose shards cannot start must exit non-zero."""
    from satpu_torch import hub, infer_helper
    from satpu_torch.bin import anonymize, import_model
    from satpu_torch.utils import kaldi_data

    root = os.path.join(WORK, "dist")
    os.makedirs(root)
    final = os.path.join(root, "final.pt")
    t0 = time.perf_counter()
    _, sd = infer_helper.read_checkpoint(ckpt)
    torch.save({"base_model_state_dict": {reference_name(k): v for k, v in sd.items()},
                "base_model_params": {"utt2spk": {f"ref{i:03d}": s
                                                  for i, s in enumerate(SPEAKERS)}}}, final)
    t_write = time.perf_counter() - t0
    saved = os.environ.get("SATPU_ZOO")
    os.environ["SATPU_ZOO"] = os.path.join(root, "zoo")
    try:
        t0 = time.perf_counter()
        rc = import_model.main(["--torch-checkpoint", final, "--tag", DIST_TAG])
        t_import = time.perf_counter() - t0
        check(rc == 0, f"import_model exited {rc}")
        zoo_ckpt = hub.resolve(DIST_TAG)
        t0 = time.perf_counter()
        model, meta = hub.load(DIST_TAG + "+f0-transformation=quant_16")
        t_load = time.perf_counter() - t0
    finally:
        if saved is None:
            os.environ.pop("SATPU_ZOO")
        else:
            os.environ["SATPU_ZOO"] = saved
    ref, _ = infer_helper.load_model(ckpt, option_args={"f0_transformation": "quant_16"})
    check(model.cfg == ref.cfg and meta["speakers"] == SPEAKERS,
          f"imported config {model.cfg} / {len(meta['speakers'])} speakers")
    wav = torch.from_numpy(np.stack([voiced_utterance(np, 2.0, f, seed=700 + i)[0]
                                     for i, f in enumerate((110.0, 190.0))])).cuda()
    tid = torch.tensor([3, 200], device="cuda")
    with torch.inference_mode():
        f0 = model.get_f0(wav)
        out, want = model.convert(wav, f0, tid), ref.convert(wav, f0, tid)
    conv_err = float((out - want).abs().max() / want.abs().max())
    print(f"[distribution] reference final.pt of the flagship ({len(sd)} tensors) written in"
          f" {t_write:.1f} s; import_model --tag {DIST_TAG} in {t_import:.1f} s; hub.load(tag"
          f" +f0-transformation=quant_16) on cuda in {t_load:.1f} s: {meta['model_id']},"
          f" {len(meta['speakers'])} speakers; its convert vs the original checkpoint's on 2 x"
          f" 2 s: max rel {conv_err:.3e} (tolerance 1e-6) [{card}]")
    check(bool(torch.isfinite(out).all()) and conv_err <= 1e-6,
          "the imported model's convert departs from the original's")
    del model, ref, wav, f0, out, want
    torch.cuda.empty_cache()

    data = os.path.join(WORK, "data")
    common = ["--checkpoint", zoo_ckpt, "--directory", data, "--batch-size", "1",
              "--target-constant-spkid", SPEAKERS[7]]
    walls, wavs = {}, {}
    for name, extra in (("one", []), ("procs", ["--num-procs", "2"])):
        t0 = time.perf_counter()
        rc = anonymize.main(common + ["--new-datadir-suffix", f"_{name}"] + extra)
        walls[name] = time.perf_counter() - t0
        check(rc == 0, f"anonymize ({name}) exited {rc}")
        scp = kaldi_data.read_wav_scp(os.path.join(data + f"_{name}", "wav.scp"))
        wavs[name] = {u: kaldi_data.load_wav_from_scp(p)[0][0] for u, p in scp.items()}
    inputs = kaldi_data.read_wav_scp(os.path.join(data, "wav.scp"))
    check(sorted(wavs["procs"]) == sorted(wavs["one"]) == sorted(inputs),
          "--num-procs 2 wrote another set of wavs")
    rel = 0.0
    for u, x in wavs["procs"].items():
        n = len(kaldi_data.load_wav_from_scp(inputs[u])[0][0])
        check(len(x) == n and bool(np.isfinite(x).all()), f"{u}: {len(x)} samples, not {n}")
        y = wavs["one"][u]
        rel = max(rel, float(np.abs(x - y).max() / max(np.abs(y).max(), 1e-30)))
    t0 = time.perf_counter()
    rc_fail = anonymize.main(["--checkpoint", os.path.join(root, "missing.pt"), "--directory",
                              data, "--num-procs", "2", "--new-datadir-suffix", "_fail"])
    t_fail = time.perf_counter() - t0
    print(f"[distribution] anonymize with the zoo checkpoint, --batch-size 1, constant target:"
          f" one process {walls['one']:.1f} s, --num-procs 2 {walls['procs']:.1f} s (two shard"
          f" processes on the card); {len(wavs['procs'])} wavs of their inputs' lengths, max"
          f" rel to one process {rel:.3e} (tolerance 2e-2, bf16 serving); shards that cannot"
          f" start: exit {rc_fail} in {t_fail:.1f} s [{card}]")
    check(rel <= 2e-2, "--num-procs 2 departs from one process")
    check(rc_fail != 0, "a run whose shards fail exited 0")


# ---- scale-out: data-parallel training, the serving mesh, export ---------------


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_child(cmd, timeout: float, what: str, env=None) -> str:
    """Run a child process to its end (killed at ``timeout``); fails the phase
    unless it exits 0. Returns its standard output."""
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, 9)
        proc.communicate()
        raise SystemExit(f"chip_smoke FAILED: {what} ran past {timeout} s")
    check(proc.returncode == 0, f"{what} exited {proc.returncode}:\n{err[-3000:]}")
    return out


def child_env():
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (ROOT, os.environ.get("PYTHONPATH")) if p))


def dp_inputs(np, torch, fx):
    """The dp-train phase's global batches, on the host: B=16 x 3 s egs of
    the chain fixture (with a codebook warmed on them: 48 frames of the
    batch's bottleneck, EMA cluster size 50, as the CPU tests warm it; a
    random codebook collapses at its first update and leaves the gradients
    upstream of it rounding noise), B=128 x 3 s for the ECAPA over 5994
    speakers, B=32 segments for the GAN."""
    from satpu_torch import infer_helper

    wav, graphs, frames = chain_batch(torch, fx, 16, "cpu")
    model = infer_helper.build_model("asrbn_tdnnf", device="cuda", seed=0, **TRAIN_NET)
    vq = model.tdnnfs[-1].tdnn.bottleneck_func.vq
    name = next(n for n, m in model.named_modules() if m is vq)
    seen = []
    hook = vq.register_forward_pre_hook(lambda m, i: seen.append(i[0].detach()))
    with torch.no_grad():
        model.train()(wav.cuda())
    hook.remove()
    feats = seen[0].transpose(1, 2).reshape(-1, seen[0].shape[1]).cpu()
    emb = feats[torch.linspace(0, len(feats) - 1, 48).long()].contiguous()
    warm = {f"{name}.embedding": emb, f"{name}.ema_cluster_size": torch.full((48,), 50.0),
            f"{name}.ema_w": emb * 50.0}
    del model
    rng = np.random.default_rng(11)
    asv = [(torch.from_numpy((rng.standard_normal((128, 3 * SR)) * 0.1).astype(np.float32)),
            torch.from_numpy(rng.integers(0, ASV_HEAD, 128))) for _ in range(DP_STEPS)]
    return {"chain": {"batch": (wav, graphs, frames), "warm": warm, "den_fst": fx["den_fst"]},
            "asv": asv, "gan": gan_batch(np, torch, DP_GAN_BATCH, "cpu"), "fx": fx}


def tensor_digest(t) -> str:
    """A digest of a CPU tensor's bytes: equal digests, equal bits."""
    import hashlib

    return hashlib.sha1(t.contiguous().numpy().tobytes()).hexdigest() + str(t.dtype)


def dp_run(torch, inp, rank: int, world: int, trainers=("chain", "asv", "gan"),
           chain_dtype: str = "float64"):
    """DP_STEPS steps of each of ``trainers`` at full width on the current
    card on this rank's block of each global batch (all of it for one
    rank): the chain trainer (TDNN-F 1024 + VQ-48, NG on, 1641-state den
    graph; the network in ``chain_dtype``, the objective in f32 as always),
    the ECAPA-512 judge's and the GAN's (at B=DP_GAN_BATCH) in f64. In f32
    the steps are ill-conditioned: the train-mode batch norms amplify
    rounding to 1e-4 of a gradient, the random generator's near-silent
    output puts the mel loss's log on tiny bins (the generator's gradients
    then part by 2.7e-2 of a tensor's largest between a batch of 32 and two
    of 16, whose cuDNN algorithms differ), and Adam's first update is the
    gradient's sign; the CPU tests run f64 for the same reason. An f64 GAN
    at B=32 would not fit beside its ranks. Returns per trainer the losses,
    the final state (rank 0; other ranks its per-tensor digests) and, for
    the chain, the kernels' launches and each step's gradients (after NG and
    clipping), state and NG eigenvalues (d, rho of every side)."""
    from satpu_torch import infer_helper
    from satpu_torch.chain import den_fb
    from satpu_torch.chain.fst import Fst
    from satpu_torch.chain.objf import DenominatorGraph
    from satpu_torch.chain.trainer import ChainTrainer
    from satpu_torch.hifigan.trainer import GanHparams, GanTrainer
    from satpu_torch.parallel.mesh import local_batch_slice
    from satpu_torch.sidekit.trainer import AsvTrainer, make_asv_optimizer

    def rows(x):
        return x[local_batch_slice(x.shape[0], rank, world)].cuda()

    def keep(state):
        state = {k: v.detach().cpu() for k, v in state.items()}
        if rank == 0:
            return state
        return {k: tensor_digest(v) for k, v in state.items()}

    out = {}
    if "chain" in trainers:
        dt = getattr(torch, chain_dtype)
        model = infer_helper.build_model("asrbn_tdnnf", device="cuda", seed=0, **TRAIN_NET)
        model.load_state_dict({**model.state_dict(),
                               **{k: v.cuda() for k, v in inp["chain"]["warm"].items()}})
        model.to(dt)
        trainer = ChainTrainer(model, DenominatorGraph.from_fst(
            Fst.read(inp["chain"]["den_fst"]), NUM_PDFS), lr_schedule=lambda step: DP_LR)
        wav, graphs, frames = inp["chain"]["batch"]
        n0 = [kernel_launches(k) for k in ("k2f", "k2b")]
        loss, steps = [], []
        for _ in range(DP_STEPS):
            loss.append(float(trainer.step(rows(wav).to(dt), {k: rows(v) for k, v in
                                                              graphs.items()},
                                           rows(frames))["loss"]))
            steps.append({
                "grad": keep({n: p.grad for n, p in model.named_parameters()
                              if p.grad is not None}),
                "state": keep(model.state_dict()),
                "ng": keep({f"{n}.{side}.{k}": st[k] for n, sides in trainer.ng_states.items()
                            for side, st in sides.items() for k in ("d", "rho")})})
        out["chain"] = {"loss": loss, "state": steps[-1]["state"], "steps": steps,
                        "launches": {"den_fb_forward": kernel_launches("k2f") - n0[0],
                                     "den_fb_backward": kernel_launches("k2b") - n0[1]}}
        del trainer, model
        torch.cuda.empty_cache()

    if "asv" in trainers:
        model = infer_helper.build_model("asv_xvector", device="cuda", seed=0,
                                         num_speakers=ASV_HEAD).double()
        trainer = AsvTrainer(model, make_asv_optimizer(model))
        gen = torch.Generator(device="cuda").manual_seed(0)  # the SpecAugment draws
        loss = [float(trainer.train_step(rows(w).double(), rows(t), gen)["loss"])
                for w, t in inp["asv"]]
        out["asv"] = {"loss": loss, "state": keep(model.state_dict())}
        del trainer, model
        torch.cuda.empty_cache()

    if "gan" in trainers:
        model = infer_helper.build_model("anonymizer_tdnnf_hifigan", device="cuda", seed=0,
                                         **FLAGSHIP).double()
        trainer = GanTrainer(model, GanHparams(segment_size=GAN_SEGMENT))
        trainer.mpd.double(), trainer.msd.double()
        batch = {k: rows(v).double() for k, v in inp["gan"].items()}
        loss = []
        for _ in range(DP_STEPS):
            m = trainer.train_step(batch)
            loss += [float(m["loss_gen_all"]), float(m["loss_disc_all"])]
        state = {k: v for k, v in model.state_dict().items() if k.startswith("hifigan.")}
        out["gan"] = {"loss": loss,
                      "state": keep({**state, **trainer.discriminator_state_dict()})}
        del trainer, model, batch
        torch.cuda.empty_cache()
    return out


def dp_worker(rank: int, world: int, port: int, inputs: str, result: str,
              backend: str = "gloo", parts: str = "chain,asv,gan",
              chain_dtype: str = "float64") -> int:
    """One rank of a data-parallel check (``--dp-worker``): ``dp_run`` of
    the trainers among ``parts`` on this rank's blocks, then, with "speed"
    among them, each trainer's f32 step in the group (``dp_speed``). Backend
    "gloo" is a gloo rank on cuda:0 (the dp-train phase), "gloo-cards" a
    gloo rank on cuda:<rank>, "nccl" an NCCL rank on cuda:<rank> (the
    multi-card run); "none" is one card without a group: ``dp_speed``
    alone, in a process as fresh as the ranks'."""
    import numpy as np
    import torch
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0 if backend == "gloo" else rank)
    inp = torch.load(inputs, weights_only=False)
    parts = parts.split(",")
    if backend == "none":
        torch.save({"speed": dp_speed(np, torch, inp["fx"])}, result)
        return 0
    dist.init_process_group("gloo" if backend.startswith("gloo") else backend,
                            init_method=f"tcp://localhost:{port}", world_size=world, rank=rank)
    try:
        out = dp_run(torch, inp, rank, world, [p for p in parts if p != "speed"], chain_dtype)
        if "speed" in parts:
            out["speed"] = dp_speed(np, torch, inp["fx"])
        torch.save(out, result)
    finally:
        dist.destroy_process_group()
    return 0


def tensor_departures(got, want):
    """[(relative L2, name)] of every float tensor of ``want`` against
    ``got``'s, worst first."""
    return sorted(((float((got[k].double() - v.double()).norm()
                          / max(float(v.double().norm()), 1e-30)), k)
                   for k, v in want.items() if v.is_floating_point()), reverse=True)


def chain_stages(got, want) -> str:
    """Where two chain runs of ``dp_run`` part, step by step: the worst
    tensor of the gradients (after NG and clipping), of the NG eigenvalues
    (d, rho) and of the state; for the state's, how many entries part by
    more than half a learning rate (Adam's first update is lr x the
    gradient's sign) and the largest gap."""
    out = []
    for k, (g, w) in enumerate(zip(got["steps"], want["steps"]), 1):
        grad, ng, state = (tensor_departures(g[x], w[x])[0] for x in ("grad", "ng", "state"))
        gap = (g["state"][state[1]].double() - w["state"][state[1]].double()).abs()
        out.append(f"step {k}: gradient {grad[0]:.3e} ({grad[1]}), NG d/rho {ng[0]:.3e}"
                   f" ({ng[1]}), state {state[0]:.3e} ({state[1]}: {int((gap > DP_LR / 2).sum())}"
                   f" of {gap.numel()} entries apart by more than lr/2, largest"
                   f" {float(gap.max()):.3e})")
    return "; ".join(out)


def dp_compare(torch, ranks, ref, label: str):
    """Each trainer of the ranks' ``dp_run`` against one process's
    (``ref``): losses rel 1e-5, every tensor of the state rel 1e-4 in
    relative L2 (the relative L2 over all of them printed beside), every
    other rank's per-tensor digests rank 0's; for the chain, where the runs
    part (``chain_stages``). Prints a line a trainer; returns the lines
    that failed."""
    failed = []
    for name in [t for t in ("chain", "asv", "gan") if t in ref]:
        got, want = ranks[0][name], ref[name]
        loss_err = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(got["loss"], want["loss"]))
        worst = tensor_departures(got["state"], want["state"])
        bad = sum(e > 1e-4 for e, _ in worst)
        same = all(r[name]["state"][k] == tensor_digest(v)
                   for r in ranks[1:] for k, v in got["state"].items())
        line = (f"{label}, {name}: losses rel {loss_err:.3e}, worst tensor {worst[0][0]:.3e}"
                f" ({worst[0][1]}; {bad} of {len(worst)} tensors above 1e-4), state rel L2"
                f" {rel_l2(torch, got['state'], want['state']):.3e}, other ranks = rank 0:"
                f" {same}")
        print(line)
        if name == "chain":
            print(f"{label}, chain by step: {chain_stages(got, want)}")
        if not (same and loss_err <= 1e-5 and bad == 0):
            failed.append(line)
    return failed


def dp_workers(torch, inputs: str, n: int, backend: str, parts: str = "chain,asv,gan",
               chain_dtype: str = "float64"):
    """``n`` ``--dp-worker`` processes of ``backend`` on ``inputs`` (killed
    at 600 s); returns each one's result."""
    port = free_port()
    results = [os.path.join(WORK, f"dp_{backend}{r}.pt") for r in range(n)]
    # the host's cores shared out: n processes of a thread a core each thrash
    env = dict(child_env(), OMP_NUM_THREADS=str(max(1, (os.cpu_count() or n) // n)))
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--dp-worker", str(r),
                               str(n), str(port), inputs, results[r], backend, parts,
                               chain_dtype], cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(n)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=600)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        check(p.returncode == 0, f"{backend} worker {r} exited {p.returncode}:\n{logs[r][-3000:]}")
    return [torch.load(r, weights_only=False) for r in results]


def dp_speed(np, torch, fx):
    """Each trainer's f32 step (``step_setups``) on the current card, in the
    process group if one is up, over three times the setup's timed steps:
    {name: {"ms": [host ms of each step], "sync": {range: (host ms, device
    ms)}, "audio": audio-s a step on this card}}."""
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for name, (setup, prefix, phases, sync, iters, audio) in step_setups(np, torch, fx).items():
        step = setup()
        first_losses(step)  # warm-up (the chain's first is an NG subspace update)
        ms = timed_steps(torch, step, 3 * iters)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            step()
            torch.cuda.synchronize()
        host, dev = train_split(prof, 1, prefix=prefix, phases=phases)
        out[name] = {"ms": ms, "sync": {s: (host[s], dev[s]) for s in sync}, "audio": audio,
                     "prefix": prefix}
        del step, prof
        torch.cuda.empty_cache()
    return out


def rel_l2(torch, got, want) -> float:
    num = sum(float(((got[k].double() - v.double()) ** 2).sum()) for k, v in want.items()
              if v.is_floating_point())
    den = sum(float((v.double() ** 2).sum()) for v in want.values() if v.is_floating_point())
    return (num / max(den, 1e-300)) ** 0.5


def step_setups(np, torch, fx):
    """Each trainer's f32 step at full width from seed 0 on the current card,
    at the batch a card takes in the dp-train timings: {name: (setup,
    profiler prefix, phases, sync ranges, timed steps, audio-s a step)};
    ``setup()`` builds the model and trainer (in the process group, if one
    is up) and returns the step."""
    from satpu_torch import infer_helper
    from satpu_torch.chain.fst import Fst
    from satpu_torch.chain.objf import DenominatorGraph
    from satpu_torch.chain.trainer import PHASES as CHAIN_PHASES
    from satpu_torch.chain.trainer import ChainTrainer
    from satpu_torch.hifigan.trainer import PHASES as GAN_PHASES
    from satpu_torch.hifigan.trainer import GanHparams, GanTrainer
    from satpu_torch.sidekit.trainer import PHASES as ASV_PHASES
    from satpu_torch.sidekit.trainer import AsvTrainer, make_asv_optimizer

    fx_den = DenominatorGraph.from_fst(Fst.read(fx["den_fst"]), NUM_PDFS)
    rng = np.random.default_rng(3)
    asv_batch = (torch.from_numpy((rng.standard_normal((128, 3 * SR)) * 0.1).astype(
        np.float32)).cuda(), torch.from_numpy(rng.integers(0, ASV_HEAD, 128)).cuda())

    def chain_setup():
        model = infer_helper.build_model("asrbn_tdnnf", device="cuda", seed=0, **TRAIN_NET)
        trainer = ChainTrainer(model, fx_den, lr_schedule=lambda step: 1e-3)
        batch = chain_batch(torch, fx, 16, "cuda")
        return lambda: trainer.step(*batch)

    def asv_setup():
        model = infer_helper.build_model("asv_xvector", device="cuda", seed=0,
                                         num_speakers=ASV_HEAD)
        trainer = AsvTrainer(model, make_asv_optimizer(model))
        gen = torch.Generator(device="cuda").manual_seed(0)  # the SpecAugment draws
        return lambda: trainer.train_step(*asv_batch, gen)

    def gan_setup():
        model = infer_helper.build_model("anonymizer_tdnnf_hifigan", device="cuda", seed=0,
                                         **FLAGSHIP)
        trainer = GanTrainer(model, GanHparams(segment_size=GAN_SEGMENT))
        batch = gan_batch(np, torch, 32, "cuda")
        return lambda: trainer.train_step(batch)

    return {
        "train_asr tdnnf_vq B=16 x 3 s": (chain_setup, "chain.", CHAIN_PHASES, ("sync",), 3,
                                          16 * EG_SECONDS),
        "train_asv ECAPA-512 B=128 x 3 s": (asv_setup, "asv.", ASV_PHASES, ("sync",), 3,
                                            128 * 3.0),
        "train_vc hifigan B=32": (gan_setup, "gan.", GAN_PHASES, ("d_sync", "g_sync"), 2,
                                  32 * GAN_SEGMENT / SR)}


def timed_step(torch, step, iters: int) -> float:
    """Host-clock milliseconds a step over ``iters`` steps, synchronized."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        step()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e3


def timed_steps(torch, step, iters: int):
    """Host-clock milliseconds of each of ``iters`` steps, each synchronized."""
    out = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def first_losses(step, n=DP_STEPS):
    """The losses of the next ``n`` steps (the GAN's generator loss)."""
    out = []
    for _ in range(n):
        m = step()
        out.append(float(m["loss_gen_all"] if "loss_gen_all" in m else m["loss"]))
    return out


def train_clis(fx):
    """The training CLIs' arguments of the train, asv and gan phases (their
    runs in WORK/<root>/exp): {name: (arguments but --dirname, root, logged
    keys held against another run's)}."""
    chain, asv, gan = (os.path.join(WORK, d) for d in ("chain", "asv", "gan"))
    return {
        "train_asr": (["--train-set", fx["data"], "--fst-scp", fx["fst_scp"], "--valid-set",
                       fx["valid"], "--valid-fst-scp", fx["valid_fst_scp"], "--den-fst",
                       fx["den_fst"], "--num-pdfs", str(NUM_PDFS), "--model", "tdnnf_vq",
                       "--codebook-size", "48", "--minibatch-size", "16", "--num-epochs", "2",
                       "--diagnostics-interval", "1"], chain, ("loss", "chain_objf")),
        "train_asv": (["--config", os.path.join(ROOT, ASV_CONFIG), "--train-set",
                       os.path.join(asv, "data"), "--samples-per-speaker", "2", "--epochs",
                       "2"], asv, ("loss",)),
        "train_vc": (["--config", os.path.join(ROOT, GAN_CONFIG), "--train-set",
                      os.path.join(gan, "train"), "--dev-set", os.path.join(gan, "dev"),
                      "--asrbn-checkpoint", os.path.join(gan, "asrbn.pt"),
                      "--training-epochs", "1"], gan, ("val_mel_error",)),
    }


def torchrun_cli(name: str, args, nproc: int, counts=None):
    """``python -m torch.distributed.run --nproc-per-node <nproc>`` of the
    ``satpu_torch.bin.<name>`` CLI (NCCL, rank r on cuda:r), killed at 600
    s. With a ``counts`` dir each rank runs through this file's
    ``--cli-rank`` entry, which writes its kernels' launches and its card
    there. Returns (wall s with the process start, [each rank's counts])."""
    target = ([os.path.abspath(__file__), "--cli-rank", name, counts] if counts
              else ["-m", f"satpu_torch.bin.{name}"])
    t0 = time.perf_counter()
    run_child([sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", str(nproc),
               "--master-addr", "localhost", "--master-port", str(free_port()), *target,
               *args], 600, f"torchrun --nproc-per-node {nproc} {name}", child_env())
    wall = time.perf_counter() - t0
    ranks = []
    for r in range(nproc if counts else 0):
        with open(os.path.join(counts, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    return wall, ranks


def cli_rank(name: str, counts: str, args) -> int:
    """One rank of ``torchrun_cli`` (``--cli-rank``): the CLI's ``main``,
    then this rank's kernel launches and current card into
    ``counts/rank<RANK>.json``."""
    import importlib

    import torch

    from satpu_torch.chain import den_fb
    from satpu_torch.ops import yaapt as Y

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rc = importlib.import_module(f"satpu_torch.bin.{name}").main(args)
    os.makedirs(counts, exist_ok=True)
    with open(os.path.join(counts, f"rank{os.environ['RANK']}.json"), "w") as f:
        json.dump({"card": torch.cuda.current_device(), "shc_band": kernel_launches("k1"),
                   "den_fb_forward": kernel_launches("k2f"),
                   "den_fb_backward": kernel_launches("k2b")}, f)
    return rc


def logged_departure(np, root: str, ref: str, got: str, keys, name: str):
    """(lines, largest relative departure of the ``keys``, [(step, key,
    relative departure)]) between two runs' metrics.jsonl under ``root``;
    fails unless they logged the same steps and finite values."""
    logged = []
    for d in (ref, got):
        with open(os.path.join(root, d, "metrics.jsonl")) as f:
            logged.append([json.loads(x) for x in f])
    want, have = logged
    check([r["step"] for r in have] == [r["step"] for r in want] and want,
          f"{name}: {got} logged other steps than {ref}")
    check(all(np.isfinite(g[k]) for g in have for k in keys if k in g),
          f"{name}: {got} logged a value that is not finite")
    rels = [(r["step"], k, abs(g[k] - r[k]) / max(abs(r[k]), 1e-30))
            for g, r in zip(have, want) for k in keys if k in r]
    return len(have), max(e for *_, e in rels), rels


def phase_dp_train(np, torch, card, fx):
    """Data-parallel training on the card (one H100: NCCL refuses two ranks on
    one device). (a) the three training CLIs under ``torch.distributed.run
    --nproc-per-node 1`` over NCCL with the earlier phases' arguments: their
    logged losses against those no-group runs'; each trainer's step in this
    process without and with a one-rank NCCL group (ms per step, and the
    group's ``*.sync`` / ``*_sync`` ranges in a profile). (b) two gloo ranks
    on cuda:0 with CUDA tensors, each on half of every global batch, against
    one rank on the global batches (TF32 off, DP_STEPS steps; the chain and
    ECAPA and GAN networks in f64, the GAN at B=DP_GAN_BATCH, ``dp_run``):
    losses rel 1e-5, every parameter and batch-norm / VQ buffer rel 1e-4 in
    relative L2, rank 1 equal to rank 0,
    K2f/K2b launched every chain step. gloo stages CUDA tensors through the host:
    (b) checks correctness, not speed. Returns the ranks' den kernel
    launches."""
    from concurrent.futures import ThreadPoolExecutor

    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from satpu_torch import infer_helper

    torch.cuda.empty_cache()
    # (a) the CLIs, one rank over NCCL, against the earlier phases' no-group runs
    gan = os.path.join(WORK, "gan")
    clis = train_clis(fx)

    def torchrun(name):
        args, root, _ = clis[name]
        return torchrun_cli(name, args + ["--dirname", os.path.join(root, "exp_dp")], 1)[0]

    # the three side by side (peaks of ~2, 29 and 37 GiB)
    with ThreadPoolExecutor(3) as pool:
        walls = dict(zip(clis, pool.map(torchrun, clis)))
    # train_vc again without a group, alone on the card: with less memory
    # free, cuDNN takes deterministic algorithms of smaller workspaces, whose
    # sums round otherwise
    args, _, _ = clis["train_vc"]
    t0 = time.perf_counter()
    run_child([sys.executable, "-m", "satpu_torch.bin.train_vc", *args, "--dirname",
               os.path.join(gan, "exp_repeat")], 600, "train_vc's repeat", child_env())
    t_repeat = time.perf_counter() - t0
    logged = {}
    for d in ("exp", "exp_repeat"):
        with open(os.path.join(gan, d, "metrics.jsonl")) as f:
            logged[d] = [{k: v for k, v in json.loads(x).items() if k != "t"} for x in f]
    ckpts = [infer_helper.read_checkpoint(os.path.join(gan, d, "g_best.ckpt"))[1]
             for d in ("exp", "exp_repeat")]
    same = sorted(ckpts[0]) == sorted(ckpts[1]) and all(
        torch.equal(v, ckpts[1][k]) for k, v in ckpts[0].items())
    print(f"[dp-train] train_vc without a group, again ({t_repeat:.1f} s with the process"
          f" start): logged {[r.get('val_mel_error') for r in logged['exp_repeat']]} vs phase"
          f" 13's {[r.get('val_mel_error') for r in logged['exp']]}; the same logged values"
          f" {logged['exp_repeat'] == logged['exp']}, g_best.ckpt bitwise {same}")
    check(logged["exp_repeat"] == logged["exp"] and same,
          "train_vc does not repeat bit for bit without a group")
    for name, (args, root, keys) in clis.items():
        n_logged, worst, _ = logged_departure(np, root, "exp", "exp_dp", keys, name)
        print(f"[dp-train] torchrun --nproc-per-node 1 (NCCL) {name}: {n_logged} logged"
              f" {'/'.join(keys)} values within rel {worst:.3e} of the no-group run's"
              f" ({walls[name]:.1f} s with the process start; the three CLIs side by side)")
        check(worst <= 1e-3, f"{name}: the one-rank NCCL run departs by {worst:.3e}")

    # (a) each trainer's step in this process, without and with a one-rank NCCL group
    for name, (setup, prefix, phases, sync, iters, _) in step_setups(np, torch, fx).items():
        # the same first steps from the same seed without and with a group
        step = setup()
        plain_loss = first_losses(step)
        plain = timed_step(torch, step, iters)
        del step
        torch.cuda.empty_cache()
        dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}",
                                world_size=1, rank=0)
        try:
            step = setup()
            group_loss = first_losses(step)
            grouped = timed_step(torch, step, iters)
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                step()
                torch.cuda.synchronize()
            host, dev = train_split(prof, 1, prefix=prefix, phases=phases)
        finally:
            dist.destroy_process_group()
        del step
        torch.cuda.empty_cache()
        errs = [abs(a - b) / max(abs(b), 1e-30) for a, b in zip(group_loss, plain_loss)]
        print(f"[dp-train] {name}, f32, from seed 0: {plain:.1f} ms/step without a process"
              f" group, {grouped:.1f} ms/step in a one-rank NCCL group; its sync split host /"
              f" device ms/step: "
              + ", ".join(f"{prefix}{s} {host[s]:.2f} / {dev[s]:.2f}" for s in sync)
              + f"; losses of steps 1-{len(errs)} rel "
              + ", ".join(f"{e:.3e}" for e in errs) + f" from the no-group run's [{card}]")
        check(errs[0] <= 1e-5, f"{name}: the one-rank group's first loss departs by {errs[0]:.3e}")

    # (b) two gloo ranks on cuda:0 against one rank on the global batches
    inp = dp_inputs(np, torch, fx)
    path = os.path.join(WORK, "dp_inputs.pt")
    torch.save(inp, path)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = dp_workers(torch, path, 2, "gloo")
    wall = time.perf_counter() - t0
    ref = one_process(torch, inp)
    print(f"[dp-train] the one-rank reference took {time.perf_counter() - t0 - wall:.1f} s")
    launches = {"den_fb_forward": 0, "den_fb_backward": 0}
    failed = dp_compare(torch, ranks, ref, "[dp-train] 2 gloo ranks on cuda:0 vs 1 rank")
    check(not failed, "dp: " + "; ".join(failed))
    for r in range(2):
        n = ranks[r]["chain"]["launches"]
        check(all(v >= DP_STEPS for v in n.values()), f"rank {r} den launches {n}")
        for k, v in n.items():
            launches[k] += v
    print(f"[dp-train] the two ranks took {wall:.1f} s (process start, full-width builds and"
          f" {DP_STEPS} steps of each trainer over gloo); den kernel launches in the ranks'"
          f" chain steps {launches}")
    return launches


def phase_serve_mesh(np, torch, ckpt):
    """``anonymize --serve-mesh true`` on one card over the slice phase's dir:
    the wavs bitwise those of the run without the flag (one device: it runs
    unsharded). Then ``process_data(devices=[cuda:0, cuda:0])`` with the
    flagship in f32, each batch split into two blocks on the card:
    every waveform within 1e-6 of the unsharded run's, K1 launched once and
    K4 twice per block. Returns K1's and K4's launches by kernel name."""
    from satpu_torch import infer_helper
    from satpu_torch.bin import anonymize, pipeline
    from satpu_torch.ops import yaapt as Y
    from satpu_torch.utils import kaldi_data

    data = os.path.join(WORK, "data")
    counters = {"shc_band": "k1", "viterbi_path": "k4"}
    n0 = {k: kernel_launches(c) for k, c in counters.items()}
    rc = anonymize.main(["--checkpoint", ckpt, "--directory", data, "--batch-size", "8",
                         "--target-selection-algorithm", "random_per_utt", "--serve-mesh",
                         "true", "--new-datadir-suffix", "_mesh", "--results-dir",
                         os.path.join(WORK, "out_mesh")])
    check(rc == 0, f"anonymize --serve-mesh exited {rc}")
    a = kaldi_data.read_wav_scp(os.path.join(data + "_anon", "wav.scp"))
    b = kaldi_data.read_wav_scp(os.path.join(data + "_mesh", "wav.scp"))
    check(sorted(a) == sorted(b), "serve-mesh wrote other utterances")
    same = all(np.array_equal(kaldi_data.load_wav_from_scp(a[u])[0],
                              kaldi_data.load_wav_from_scp(b[u])[0]) for u in a)
    print(f"[serve-mesh] anonymize --serve-mesh true on one card: {len(b)} wavs bitwise those"
          f" of the run without the flag: {same}")
    check(same, "serve-mesh on one card changed the wavs")

    model, meta = infer_helper.load_model(ckpt, device="cuda")
    write = pipeline.kaldi_data.write_wav
    outs, launches = {}, {}
    for name, devices in (("one", None), ("two", [torch.device("cuda", 0)] * 2)):
        captured = outs[name] = {}

        def capture(path, x, rate, captured=captured):
            captured[os.path.basename(path)] = np.array(x)
            write(path, x, rate)

        pipeline.kaldi_data.write_wav = capture
        n1 = {k: kernel_launches(c) for k, c in counters.items()}
        try:
            pipeline.process_data(model, meta["speakers"], data, os.path.join(WORK, f"mesh_{name}"),
                                  target_selection_algorithm="random_per_utt", batch_size=8,
                                  new_datadir_suffix=f"_{name}", devices=devices)
            torch.cuda.synchronize()
        finally:
            pipeline.kaldi_data.write_wav = write
        launches[name] = {k: kernel_launches(c) - n1[k] for k, c in counters.items()}
    total = {k: kernel_launches(c) - n0[k] for k, c in counters.items()}
    worst = max(float(np.abs(outs["two"][u] - outs["one"][u]).max()) for u in outs["one"])
    print(f"[serve-mesh] process_data over [cuda:0, cuda:0] (the flagship in f32, a batch of 8"
          f" in two blocks): {len(outs['two'])} wavs within {worst:.3e} of the unsharded run's;"
          f" launches {launches['two']} split, {launches['one']} unsharded")
    check(sorted(outs["two"]) == sorted(outs["one"]) and worst <= 1e-6,
          f"two replicas depart by {worst:.3e}")
    for name in counters:
        check(launches["two"][name] == 2 * launches["one"][name] > 0,
              f"{name} launches {launches}")
    check(launches["two"]["viterbi_path"] == 2 * launches["two"]["shc_band"],
          f"not two K4 launches a block: {launches}")
    return total


# what the exported program's process loads: K1's and K4's op registrations and the
# recorder its wrapper counts launches in (``satpu_torch.utils`` imports the
# host utilities beside it); no model code
EXPORT_MODULES = ["satpu_torch", "satpu_torch.ops", "satpu_torch.ops.yaapt", "satpu_torch.utils",
                  "satpu_torch.utils.checkpoint", "satpu_torch.utils.config",
                  "satpu_torch.utils.kaldi_data", "satpu_torch.utils.scp_io",
                  "satpu_torch.utils.trace"]
EXPORT_RUN = """
import json, sys, time
import torch
import satpu_torch.ops.yaapt as Y
modules = sorted(m for m in sys.modules if m.startswith("satpu"))
t0 = time.perf_counter()
prog = torch.export.load(sys.argv[1]).module()
load_s = time.perf_counter() - t0
io = torch.load(sys.argv[2])
wav, tid = io["wav"].cuda(), io["tid"].cuda()
from satpu_torch.utils import trace
counters = {"shc_band": "k1.launches", "viterbi_path": "k4.launches"}
n0 = {k: trace.counters().get(c, 0) for k, c in counters.items()}
with torch.no_grad():
    out = prog(wav, tid)
    torch.cuda.synchronize()
    launches = {k: trace.counters().get(c, 0) - n0[k] for k, c in counters.items()}
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        prog(wav, tid)
    end.record()
    end.synchronize()
ref = io["eager"].cuda().float()
print(json.dumps({"load_s": load_s, "launches": launches, "ms": start.elapsed_time(end) / 3,
                  "max_abs": float((out.float() - ref).abs().max()),
                  "rel": float((out.float() - ref).abs().max() / ref.abs().max()),
                  "modules": modules}))
"""


def phase_export(np, torch, card, ckpt):
    """``hub.export_convert`` of the flagship anonymizer (bf16 serving
    policy) at B=EXPORT_BATCH x EXPORT_SECONDS: export wall time, then the
    .pt2 loaded with ``torch.export.load`` in a fresh process that imports
    only the ops' registrations and run on the same input: load time, K1's
    and K4's launches inside the program, its departure from eager (held to
    the bf16 serving rule, rel 2e-2), and audio-seconds per second exported
    and eager. Returns K1's and K4's launches in the exported program by
    kernel name."""
    from satpu_torch import hub, infer_helper

    model, _ = infer_helper.load_model(ckpt, option_args=infer_helper.serving_option_args(),
                                       device="cuda")
    model.eval()
    B, T = EXPORT_BATCH, EXPORT_SECONDS * SR
    path = os.path.join(WORK, "convert.pt2")
    t0 = time.perf_counter()
    hub.export_convert(model, path, batch=B, num_samples=T)
    export_s = time.perf_counter() - t0
    gen = torch.Generator(device="cuda").manual_seed(5)
    wav = torch.randn((B, T), generator=gen, device="cuda") * 0.05
    tid = torch.arange(B, device="cuda") % len(SPEAKERS)
    with torch.no_grad():
        eager = model.convert(wav, model.get_f0(wav), tid)
        eager_ms = cuda_ms(torch, lambda: model.convert(wav, model.get_f0(wav), tid), iters=3,
                           warmup=0)
    io = os.path.join(WORK, "export_io.pt")
    torch.save({"wav": wav.cpu(), "tid": tid.cpu(), "eager": eager.cpu()}, io)
    del model
    torch.cuda.empty_cache()
    res = json.loads(run_child([sys.executable, "-c", EXPORT_RUN, path, io], 900,
                               "the exported program's process", child_env()).strip()
                     .split("\n")[-1])
    audio = B * EXPORT_SECONDS
    print(f"[export] flagship convert (bf16 serving) at B={B} x {EXPORT_SECONDS} s: exported in"
          f" {export_s:.1f} s ({os.path.getsize(path) / 2**20:.1f} MiB); a fresh process"
          f" importing {res['modules']} loaded it in {res['load_s']:.1f} s; launches inside"
          f" the program {res['launches']}; departure from eager {res['max_abs']:.3e} abs,"
          f" rel {res['rel']:.3e}; {audio / res['ms'] * 1e3:.1f} audio-s/s exported,"
          f" {audio / eager_ms * 1e3:.1f} eager [{card}]")
    check(res["modules"] == EXPORT_MODULES,
          f"the exported program's process imported {res['modules']}")
    n = res["launches"]
    check(n["shc_band"] >= 1, "the exported program did not launch K1")
    check(n["viterbi_path"] == 2 * n["shc_band"], f"the exported program's launches {n}:"
          " not two K4 a get_f0")
    check(res["rel"] <= 2e-2, f"exported convert departs from eager by rel {res['rel']:.3e}")
    return res["launches"]


# ---- the rest of satpu's surface: fault 4, a reference judge, the new modules ---


def bn_fault_input(np):
    """ECAPA batch norm's fault-4 input: |mean| / std = 1e4, [B, C, T] f32."""
    return (1000.0 + 0.1 * np.random.default_rng(0).standard_normal((64, 16, 200))).astype(
        np.float32)


def bn_train(torch, x, device):
    """``sidekit.nn.BatchNorm`` in training on ``x`` (in ``x``'s dtype) on
    ``device``, under whatever process group is up: (output, running mean,
    running variance) on the host."""
    from satpu_torch.sidekit.nn import BatchNorm

    bn = BatchNorm(x.shape[1]).to(device, x.dtype).train()
    with torch.no_grad():
        y = bn(x.to(device))
    return y.cpu(), bn.running_mean.cpu(), bn.running_var.cpu()


def bn_worker(rank: int, world: int, port: int, result: str) -> int:
    """One gloo rank of the surface phase's batch-norm check on cuda:0
    (``--bn-worker``): its block of the fault-4 input."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from satpu_torch.parallel.mesh import local_batch_slice

    torch.cuda.set_device(0)
    x = torch.from_numpy(bn_fault_input(np))
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=world,
                            rank=rank)
    try:
        torch.save(bn_train(torch, x[local_batch_slice(len(x), rank, world)], "cuda"), result)
    finally:
        dist.destroy_process_group()
    return 0


def one_pass_batch_norm(self, x):
    """The global moments in one collective (the sums of x and x^2 in f32,
    the variance E[x^2] - E[x]^2) that the two-pass form replaced: timed
    beside it, never used to train."""
    import torch

    from satpu_torch.parallel import mesh

    C = x.shape[1]
    dims = [0] + list(range(2, x.ndim))
    s = mesh.global_sum(torch.cat([x.sum(dim=dims), (x * x).sum(dim=dims),
                                   x.new_full((1,), x.numel() // C)]))
    n = s[-1]
    mean = s[:C] / n
    var = (s[C:2 * C] / n - mean * mean).clamp(min=0.0)
    shape = (1, C) + (1,) * (x.ndim - 2)
    return ((x - mean.reshape(shape)) * (var + self.eps).rsqrt().reshape(shape)
            * self.weight.reshape(shape) + self.bias.reshape(shape))


def reference_sidekit_name(key: str) -> str:
    """A port ECAPA x-vector key -> the reference sidekit's (what
    ``convert_sidekit`` reads): the ``before_speaker_embedding`` Sequential
    and ECAPA's ``layer<k>.<i>`` (the port's ``layer<k>.block.<i>``)."""
    key = re.sub(r"\bbefore_speaker_embedding_([a-z0-9_]+?)\.", r"before_speaker_embedding.\1.",
                 key)
    return re.sub(r"\b(layer[234])\.block\.(\d+)\.", r"\1.\2.", key)


def phase_surface(np, torch, card, paths, ckpt):
    """(a) fault 4: ECAPA's batch norm in training on 1000 + 0.1 randn
    [64, 16, 200] f32 without a group, in a one-rank NCCL group, a one-rank
    gloo group and two gloo ranks on cuda:0, each against f64: the output
    within 1e-3 of its largest entry and within 4x the no-group error, the
    running statistics rel 1e-5; the ECAPA-512 B=128 step (5994 speakers)
    without a group and in a one-rank NCCL group with the two-pass moments
    and with the one-pass form they replaced, in turns. (b) a judge the
    reference trained: the eval phase's ECAPA-512 under the reference
    sidekit's names through ``convert_sidekit`` into a checkpoint, and the
    ``eval_anon`` CLI with it over the slice's anonymized dir: its
    x-vectors bitwise the original judge's, the same results and trial
    ranking. (c) the new modules on the card against the CPU: global_cmvn
    and CMVN rel 1e-6, AdaptivePCMN at D=80, T=1000, B=32 rel 1e-5; the
    flagship generator with bf16_min_channels=128 serving B=32 x 10 s
    (finite; audio-seconds per second of convert beside the uniform bf16
    generator's, in turns); ``hub.load(..., load_weight=False)`` on the
    card."""
    import dataclasses as dc

    import torch.distributed as dist

    from satpu_torch import hub, infer_helper
    from satpu_torch.bin import eval_anon
    from satpu_torch.models.convert import convert_sidekit
    from satpu_torch.models.hifigan import CoreHifiGan
    from satpu_torch.ops.cmvn import CMVN, AdaptivePCMN, global_cmvn
    from satpu_torch.sidekit import nn as sk_nn
    from satpu_torch.sidekit.trainer import AsvTrainer, extract_xvectors, make_asv_optimizer
    from satpu_torch.utils import kaldi_data

    # (a) fault 4
    x = torch.from_numpy(bn_fault_input(np))
    want = bn_train(torch, x.double(), "cuda")
    port = free_port()
    results = [os.path.join(WORK, f"bn_rank{r}.pt") for r in range(2)]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--bn-worker", str(r),
                               "2", str(port), results[r]], cwd=ROOT, env=child_env(),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    got = {"no group": bn_train(torch, x, "cuda")}
    for backend in ("nccl", "gloo"):
        dist.init_process_group(backend, init_method=f"tcp://localhost:{free_port()}",
                                world_size=1, rank=0)
        try:
            got[f"one-rank {backend} group"] = bn_train(torch, x, "cuda")
        finally:
            dist.destroy_process_group()
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        check(p.returncode == 0, f"bn rank {r} exited {p.returncode}:\n{logs[r][-3000:]}")
    ranks = [torch.load(r) for r in results]
    check(all(torch.equal(a, b) for a, b in zip(ranks[0][1:], ranks[1][1:])),
          "the two ranks' running statistics differ")
    got["two gloo ranks"] = (torch.cat([ranks[0][0], ranks[1][0]]),) + ranks[0][1:]

    def rel(a, b):
        return float((a.double() - b).abs().max() / b.abs().max())

    errs = {k: [rel(a, b) for a, b in zip(v, want)] for k, v in got.items()}
    print("[surface] fault 4: ECAPA's batch norm in training on 1000 + 0.1 randn [64, 16, 200]"
          " f32 against f64, output / running mean / running var rel: " + "; ".join(
              f"{k} {e[0]:.3e} / {e[1]:.3e} / {e[2]:.3e}" for k, e in errs.items()) + f" [{card}]")
    base = errs["no group"][0]
    for k, e in errs.items():
        check(e[0] <= 1e-3 and e[0] <= 4 * base and max(e[1:]) <= 1e-5,
              f"fault 4: {k}: output rel {e[0]:.3e} (no group {base:.3e}), stats {e[1:]}")

    rng = np.random.default_rng(3)
    asv_batch = (torch.from_numpy((rng.standard_normal((128, 3 * SR)) * 0.1).astype(
        np.float32)).cuda(), torch.from_numpy(rng.integers(0, ASV_HEAD, 128)).cuda())

    def asv_step_ms(iters=3):
        model = infer_helper.build_model("asv_xvector", device="cuda", seed=0,
                                         num_speakers=ASV_HEAD)
        trainer = AsvTrainer(model, make_asv_optimizer(model))
        gen = torch.Generator(device="cuda").manual_seed(0)
        for _ in range(2):
            trainer.train_step(*asv_batch, gen)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            trainer.train_step(*asv_batch, gen)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / iters * 1e3

    two_pass = sk_nn.BatchNorm._global_batch_norm
    steps = {"no group": [asv_step_ms()], "two-pass": [], "one-pass": []}
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}",
                            world_size=1, rank=0)
    try:
        for form in ("two-pass", "one-pass", "one-pass", "two-pass"):
            sk_nn.BatchNorm._global_batch_norm = (two_pass if form == "two-pass"
                                                  else one_pass_batch_norm)
            steps[form].append(asv_step_ms())
    finally:
        sk_nn.BatchNorm._global_batch_norm = two_pass
        dist.destroy_process_group()
    print("[surface] ECAPA-512 B=128 x 3 s train step, f32, 5994 speakers, ms/step (host"
          " clock): " + "; ".join(f"{k} {', '.join(f'{t:.1f}' for t in v)}"
                                  for k, v in steps.items())
          + " (one-rank NCCL group for the two forms) [" + card + "]")
    torch.cuda.empty_cache()

    # (b) the eval phase's judge as the reference would have trained it
    meta, sd = infer_helper.read_checkpoint(paths["asv"])
    ref_sd = {reference_sidekit_name(k): v for k, v in sd.items()}
    ref_sd.update({k[:-len("running_var")] + "num_batches_tracked": torch.tensor(100)
                   for k in list(ref_sd) if k.endswith("running_var")})
    ref_path = os.path.join(WORK, "eval", "reference_judge.pt")
    torch.save(ref_sd, ref_path)
    converted = convert_sidekit(torch.load(ref_path), arch="ecapa")
    judge = os.path.join(WORK, "eval", "asv_imported.pt")
    infer_helper.save_model(judge, meta["model_id"], meta["build_params"], converted)
    data, anon = os.path.join(WORK, "data"), os.path.join(WORK, "data_anon")
    asv_out = {}
    for name, path in (("original", paths["asv"]), ("imported", judge)):
        res = os.path.join(WORK, "eval", f"results_{name}_judge")
        rc = eval_anon.main(["--device", "cuda", "--data", anon, "--asv-checkpoint", path,
                             "--enroll-dir", data, "--trials", paths["trials"],
                             "--xvector-mode", "chunked", "--results", res])
        check(rc == 0, f"eval_anon with the {name} judge exited {rc}")
        with open(os.path.join(res, "results.json")) as f:
            asv_out[name] = json.load(f)["asv"]
    utt2spk = kaldi_data.read_keyed_text(os.path.join(data, "utt2spk"))
    enroll = sorted(utt2spk)
    anon_utts = sorted(kaldi_data.read_wav_scp(os.path.join(anon, "wav.scp")))
    scp = {d: kaldi_data.read_wav_scp(os.path.join(d, "wav.scp")) for d in (data, anon)}
    wavs = ([kaldi_data.load_wav_from_scp(scp[data][u])[0][0] for u in enroll]
            + [kaldi_data.load_wav_from_scp(scp[anon][u])[0][0] for u in anon_utts])
    with open(paths["trials"]) as f:
        trials = [(s, u, t == "target") for s, u, t in (line.split() for line in f)]
    xv, ranking = {}, {}
    for name, path in (("original", paths["asv"]), ("imported", judge)):
        model, _ = infer_helper.load_model(path, device="cuda")
        xv[name] = extract_xvectors(model, wavs)
        ranking[name] = np.argsort(rank_scores(
            np, xv[name][:len(enroll)], [utt2spk[u] for u in enroll],
            dict(zip(anon_utts, xv[name][len(enroll):])), trials), kind="stable")
        del model
    same_xv = bool(np.array_equal(xv["original"], xv["imported"]))
    same_rank = bool((ranking["original"] == ranking["imported"]).all())
    print(f"[surface] the eval judge (ECAPA-512) under the reference's names ({len(ref_sd)}"
          f" tensors) -> convert_sidekit -> eval_anon on cuda over {len(anon_utts)} anonymized"
          f" utterances: x-vectors bitwise the original's {same_xv} ({len(wavs)} utterances),"
          f" trial ranking equal {same_rank}, EER {asv_out['imported']['eer']:.4f} vs"
          f" {asv_out['original']['eer']:.4f}, results equal {asv_out['imported'] == asv_out['original']}"
          f" [{card}]")
    check(sorted(converted) == sorted(sd) and same_xv and same_rank
          and asv_out["imported"] == asv_out["original"],
          "the judge imported through convert_sidekit departs from the original")

    # (c) the new modules, card against CPU
    g = np.random.default_rng(8)
    feats = torch.from_numpy((g.standard_normal((32, 1000, 80)) * 2 + 3).astype(np.float32))
    spk_feats = {s: g.standard_normal((300, 80)) * (1 + i) + 2 for i, s in enumerate("ABC")}
    stats = {s: np.stack([np.append(f.sum(0), len(f)), np.append((f ** 2).sum(0), 0.0)])
             for s, f in spk_feats.items()}
    errs = {}
    for var_norm in (False, True):
        a, b = (global_cmvn(feats.to(d), stats["A"], var_norm=var_norm).cpu()
                for d in ("cuda", "cpu"))
        errs[f"global_cmvn var_norm={var_norm}"] = rel(a, b.double())
    for reverse in (False, True):
        cm = CMVN(stats, norm_vars=True, utt2spk={"u1": "B"}, reverse=reverse)
        for utt in ("u1", "generic-spk"):
            a, b = cm(feats.cuda(), utt).cpu(), cm(feats, utt)
            errs[f"CMVN reverse={reverse} {utt}"] = rel(a, b.double())
    pcmn = AdaptivePCMN(80)
    pcmn.reset_parameters(torch.Generator().manual_seed(0))
    with torch.no_grad():
        pcmn.bias.normal_(0.0, 0.01, generator=torch.Generator().manual_seed(1))
        b = pcmn(feats)
        a = pcmn.cuda()(feats.cuda()).cpu()
    pcmn_err = rel(a, b.double())
    print("[surface] card vs CPU, f32 (TF32 off), [32, 1000, 80]: " + ", ".join(
        f"{k} rel {v:.3e}" for k, v in errs.items()) + f"; AdaptivePCMN(80, -10, 10) rel"
          f" {pcmn_err:.3e} [{card}]")
    check(max(errs.values()) <= 1e-6 and pcmn_err <= 1e-5, "CMVN / AdaptivePCMN card vs CPU")

    model, _ = infer_helper.load_model(ckpt, option_args=infer_helper.serving_option_args(),
                                       device="cuda")
    model.eval()
    uniform = model.hifigan
    narrow = CoreHifiGan(dc.replace(uniform.cfg, bf16_min_channels=128)).cuda().eval()
    narrow.load_state_dict(uniform.state_dict())
    B, T = 32, 10 * SR
    wav = torch.from_numpy(np.stack([voiced_utterance(np, 10.0, 90.0 + 5 * k, seed=900 + k)[0]
                                     for k in range(B)])).cuda()
    tid = torch.arange(B, device="cuda") % len(SPEAKERS)
    ms = {"uniform bf16": [], "bf16_min_channels=128": []}
    outs = {}
    with torch.inference_mode():
        f0 = model.get_f0(wav)
        for name in ("uniform bf16", "bf16_min_channels=128", "bf16_min_channels=128",
                     "uniform bf16"):
            model.hifigan = uniform if name == "uniform bf16" else narrow
            outs[name] = model.convert(wav, f0, tid)
            ms[name].append(cuda_ms(torch, lambda: model.convert(wav, f0, tid), iters=3,
                                    warmup=1))
    model.hifigan = uniform
    a, b = outs["bf16_min_channels=128"].float(), outs["uniform bf16"].float()
    print(f"[surface] flagship convert (bf16 serving) at B={B} x 10 s, F0 computed once:"
          f" audio-s/s " + "; ".join(f"{k} {', '.join(f'{B * 10 / t * 1e3:.1f}' for t in v)}"
                                     for k, v in ms.items())
          + f" (in turns); bf16_min_channels=128 finite {bool(torch.isfinite(a).all())}, rel to"
          f" uniform {float((a - b).abs().max() / b.abs().max()):.3e} [{card}]")
    check(a.shape == b.shape and bool(torch.isfinite(a).all()),
          "bf16_min_channels=128 output not finite")
    del model, uniform, narrow, wav, f0, outs, a, b
    torch.cuda.empty_cache()

    # the gan phase's trained generator: its weights are not build_model's init
    trained = os.path.join(WORK, "gan", "exp", "g_best.ckpt")
    t0 = time.perf_counter()
    built, meta = hub.load(trained, device="cuda", load_weight=False)
    t_build = time.perf_counter() - t0
    loaded, _ = hub.load(trained, device="cuda")
    loaded_sd = loaded.state_dict()
    differ = sum(not torch.equal(v, loaded_sd[k]) for k, v in built.state_dict().items())
    print(f"[surface] hub.load(train_vc's g_best.ckpt, load_weight=False) on cuda in"
          f" {t_build:.1f} s: {meta['model_id']}, the loaded model's config"
          f" {built.cfg == loaded.cfg}, {differ} of {len(loaded_sd)} tensors at build_model's"
          f" init, not the file's")
    check(next(built.parameters()).device.type == "cuda" and built.cfg == loaded.cfg
          and differ > 0, "hub.load(load_weight=False) built another model, or the file's")


# ---- the multi-card run (``--cards N``): satpu's dryrun_multichip on N cards ----


@contextlib.contextmanager
def kernel_cards(torch):
    """Within the block a profiler traces every card; after it, the list
    yielded holds the card of each launch of K1, K2f or K2b, in order."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    seen = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        yield seen
        for k in range(torch.cuda.device_count()):
            torch.cuda.synchronize(k)
    seen += [e.device_index for e in sorted(prof.events(), key=lambda e: e.time_range.start)
             if e.device_type == DeviceType.CUDA
             and any(n in e.name for n in ("shc_band_kernel", "den_fwd", "den_bwd"))]


def phase_cards_kernels(np, torch, n: int):
    """K1 and K2f/K2b on each of cuda:0..n-1 with the next card current (the
    launch must follow its tensors, not the current device): K1 at F = 8000
    (16 utterances of 10 s, the flagship geometry) and at a generic geometry,
    K2f/K2b at B=16, T=99 over the 1641-state den graph; each against its
    plain version on that card at the kernel phases' bounds (SHC rel 1e-5,
    den value rel 1e-5, gradients 1e-4 abs), two calls bitwise equal, one
    launch a call on the tensors' card in a profiler trace; then timed on
    each card (CUDA events with the card current). Returns {card: (K1, K2f,
    K2b) us a call}."""
    import torch.nn.functional as F

    from satpu_torch.chain import den_fb
    from satpu_torch.models.anonymizer import YAAPT_OPTS
    from satpu_torch.ops import yaapt as Y

    p = Y._merged_params(YAAPT_OPTS)
    to_pad, frame_size, frame_jump, nfft = Y.frame_geometry(p)
    g = Y.shc_params(nfft, p)
    flagship = (g["min_shc"], g["n_out"], g["n_harm"], g["window_length"])
    M = g["top_bin"] + g["half_window"]
    generic = (20, 100, 3, 9)  # min_shc, n_out, n_harm, window: the <0, 0> instantiation
    x = np.stack([voiced_utterance(np, 10.0, 100.0 + 10 * k, seed=k)[0] for k in range(16)])
    xp = F.pad(torch.from_numpy(x).cuda(0), (to_pad, to_pad))
    nl = Y.bandpass(xp ** 2, p["sr"], p["bp_low"], p["bp_high"])
    real16 = Y.shc_magnitude(nl, Y.num_frames(x.shape[1], p), frame_size, frame_jump, nfft,
                             p).cpu()
    rand = torch.from_numpy(np.random.default_rng(6).random((4000, M), np.float32))
    den = den_graph()
    B, T = 16, EG_FRAMES
    ll = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (B, T, NUM_PDFS)).astype(np.float32) * 2)
    lk = den_fb.leak_log(1e-5)
    times = {}
    for k in range(n):
        dev, other = torch.device("cuda", k), (k + 1) % n
        torch.cuda.set_device(other)
        for geometry, args, mag in (("flagship", flagship, real16.to(dev)),
                                    ("generic", generic, rand.to(dev))):
            n0 = kernel_launches("k1")
            out, again = Y.shc_band(mag, *args), Y.shc_band(mag, *args)
            calls = kernel_launches("k1") - n0
            ref = Y.shc_band_plain(mag, *args)
            rel = (out - ref).abs().max().item() / ref.abs().max().item()
            same = bool(torch.equal(out, again))
            with kernel_cards(torch) as cards:
                Y.shc_band(mag, *args)
            print(f"[cards] K1 {geometry} mag [{mag.shape[0]} x {M}] on cuda:{k}, cuda:{other}"
                  f" current ({Y.shc_instantiation(*args[2:])} instantiation): rel {rel:.3e}"
                  f" (tolerance 1e-5), two calls bitwise {same}, {calls} wrapper counts for 2"
                  f" calls, a call's kernels in the trace on cards {cards}")
            check(out.device == dev and rel <= 1e-5 and same and calls == 2 and cards == [k],
                  f"K1 {geometry} on cuda:{k} with cuda:{other} current")
        g_k = den.tensors(dev)
        _, _, llf, lls, alphas = den_check(torch, den_fb, g_k, ll.to(dev), lk,
                                           f"cuda:{k}, cuda:{other} current,")
        graph = (g_k["A"], g_k["log_self"], g_k["log_init"], lk, g_k["A_sparse"])
        a0 = g_k["start"].expand(B, den.num_states).contiguous()
        a_T = alphas[-1].clone().requires_grad_(True)
        den_fb.final_value(a_T, g_k["final"], g_k["log_init"], lk).sum().backward()
        g_final = a_T.grad
        with kernel_cards(torch) as fwd:
            den_fb.den_fb_forward(llf, lls, a0, *graph)
        with kernel_cards(torch) as bwd:
            den_fb.den_fb_backward(g_final, alphas, llf, lls, *graph)
        cards = (fwd, bwd)
        print(f"[cards] K2f / K2b on cuda:{k}, cuda:{other} current: a call's kernels in the"
              f" trace on cards {cards[0]} / {cards[1]}")
        check(cards == ([k], [k]), f"K2 on cuda:{k}: kernels on cards {cards}")
        with torch.cuda.device(dev):
            # K1 on random inputs that do not stay in the 50 MB L2 (phase 2's timing)
            gen = torch.Generator(device=dev).manual_seed(0)
            bufs = [torch.rand(real16.shape, generator=gen, device=dev)
                    for _ in range(-(-150_000_000 // real16.nbytes))]
            it = iter(range(1 << 30))
            shc_ms = cuda_ms(torch, lambda: Y.shc_band(bufs[next(it) % len(bufs)], *flagship),
                             iters=200)
            del bufs
            (f_ms, *_), (b_ms, *_) = den_timing(torch, den_fb, g_k, llf, lls, lk)
        times[k] = (shc_ms * 1e3, f_ms * 1e3, b_ms * 1e3)
        del g_k, llf, lls, alphas, g_final, graph, a0
    torch.cuda.set_device(0)
    card_names = {k: torch.cuda.get_device_name(k) for k in range(n)}
    for k, (a, b, c) in times.items():
        print(f"[cards] cuda:{k} ({card_names[k]}): K1 F={real16.shape[0]} {a:.1f} us, K2f"
              f" B={B} T={T} S={den.num_states} {b:.1f} us, K2b {c:.1f} us a call")
    return times


def gan_global_reference(args, n: int) -> None:
    """train_vc in this process on the global batches of ``n`` ranks: each
    step's batch is the ranks' host-local batches concatenated, each rank's
    crops drawn from a generator of its own in the state a rank's dataset
    starts in, as many steps an epoch as the ranks take."""
    import copy

    import numpy as np

    from satpu_torch.bin import train_vc
    from satpu_torch.hifigan.dataset import HifiGanDataset

    local, steps_per_epoch = HifiGanDataset.batches, train_vc.steps_per_epoch
    views = {}

    def global_batches(self, batch_size, shuffle=True, epoch=0, process_index=0,
                       process_count=1):
        if not shuffle:
            return local(self, batch_size, shuffle=False)
        if id(self) not in views:
            views[id(self)] = [copy.copy(self) for _ in range(n)]
            for v in views[id(self)]:
                v.rng = copy.deepcopy(self.rng)
        parts = [local(v, batch_size // n, True, epoch, k, n)
                 for k, v in enumerate(views[id(self)])]
        return ({key: np.concatenate([p[key] for p in ps]) for key in ps[0]}
                for ps in zip(*parts))

    HifiGanDataset.batches = global_batches
    train_vc.steps_per_epoch = lambda items, local_bs, world: steps_per_epoch(
        items, local_bs // n, n)
    try:
        rc = train_vc.main(args)
    finally:
        HifiGanDataset.batches, train_vc.steps_per_epoch = local, steps_per_epoch
    check(rc == 0, f"train_vc on {n} ranks' global batches exited {rc}")


def ckpt_departure(torch, got: str, want: str):
    """(relative L2 over every float tensor, (worst tensor's relative L2,
    its name)) of checkpoint ``got`` against ``want``; fails unless they hold
    the same tensors and equal integer ones."""
    from satpu_torch.utils.checkpoint import load_checkpoint

    a, b = load_checkpoint(got)[1], load_checkpoint(want)[1]
    check(sorted(a) == sorted(b), f"{got} holds other tensors than {want}")
    check(all(torch.equal(a[k], v) for k, v in b.items() if not v.is_floating_point()),
          f"{got}: an integer tensor differs from {want}'s")
    worst = max((float((a[k].double() - v.double()).norm() / max(float(v.double().norm()),
                                                                    1e-30)), k)
                for k, v in b.items() if v.is_floating_point())
    return rel_l2(torch, a, b), worst


def one_process(torch, inp, trainers=("chain", "asv", "gan"), chain_dtype="float64",
                card: int = 0):
    """``dp_run`` on the global batches in this process on cuda:<card>, in a
    one-rank gloo group (the ranks' code path)."""
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"tcp://localhost:{free_port()}",
                            world_size=1, rank=0)
    try:
        with torch.cuda.device(card):
            return dp_run(torch, inp, 0, 1, trainers, chain_dtype)
    finally:
        dist.destroy_process_group()


def den_split_check(torch, fx) -> str:
    """K2f/K2b through ``objf.den_forward`` on a batch of 16 x 99 frames and
    on its four blocks of 4: whether the values and the loglikes' gradients
    keep their bits when a batch is split (the kernels' rows are
    independent)."""
    from satpu_torch.chain.fst import Fst
    from satpu_torch.chain.objf import DenominatorGraph, den_forward

    den = DenominatorGraph.from_fst(Fst.read(fx["den_fst"]), NUM_PDFS)
    gen = torch.Generator(device="cuda").manual_seed(4)
    ll = (torch.randn((16, EG_FRAMES, NUM_PDFS), generator=gen, device="cuda") * 2
          ).requires_grad_(True)
    value = den_forward(ll, den)
    grad, = torch.autograd.grad(value.sum(), ll)
    values, grads = [], []
    for block in ll.detach().split(4):
        block.requires_grad_(True)
        v = den_forward(block, den)
        values.append(v.detach())
        grads.append(torch.autograd.grad(v.sum(), block)[0])
    return (f"values bitwise {torch.equal(value.detach(), torch.cat(values))}, gradients bitwise"
            f" {torch.equal(grad, torch.cat(grads))}")


def phase_cards_train(np, torch, card, n: int, fx, parts):
    """Data parallelism over n NCCL ranks, rank r on cuda:r; ``parts`` picks
    among f64, speed and clis. f64: ``dp_run`` (the chain, ECAPA-512 and GAN
    networks in f64, DP_STEPS steps; the GAN at B=DP_GAN_BATCH) against one
    process on the global batches: losses rel 1e-5, every tensor of the
    states rel 1e-4, ranks 1..n-1 equal to rank 0, K2f/K2b launched in
    every chain step of every rank; then, printed and not held, where the
    chain's runs part from that one process step by step (``chain_stages``)
    for the n NCCL ranks and for controls that change one thing each: one
    process again on cuda:0 and on cuda:1, n gloo ranks on cuda:0..n-1 and
    on cuda:0, and the n NCCL ranks with the network in f32 against one
    process in f32; and whether the den kernels keep their bits when a batch
    is split. speed: each trainer's f32 step at the same batch a card
    without a group and in the n ranks (``dp_speed``): ms a step (the median
    of the steps and their range), audio-s/s, the sync ranges' split,
    scaling efficiency. clis: the three training CLIs under
    ``torch.distributed.run --nproc-per-node n`` with the train, asv and gan
    phases' arguments, against one process on the same global batches:
    every logged value and every tensor of the final checkpoints within rel
    1e-5 (train_asr, train_asv: the one-rank group's bound) and 1e-3
    (train_vc: fault 5's), each rank's kernel launches on its card. Returns
    what failed."""
    from concurrent.futures import ThreadPoolExecutor

    failed = []
    inp = dp_inputs(np, torch, fx)
    path = os.path.join(WORK, "dp_inputs.pt")
    torch.save(inp, path)
    torch.cuda.empty_cache()
    if "f64" in parts or "speed" in parts:
        t0 = time.perf_counter()
        ranks = dp_workers(torch, path, n, "nccl", ",".join(
            (["chain", "asv", "gan"] if "f64" in parts else [])
            + (["speed"] if "speed" in parts else [])))
        print(f"[cards-train] {n} NCCL ranks on cuda:0..{n - 1} took"
              f" {time.perf_counter() - t0:.1f} s (process start, full-width builds, then"
              f" {'the f64 steps' if 'f64' in parts else ''}"
              f"{' and ' if len({'f64', 'speed'} & set(parts)) == 2 else ''}"
              f"{'the f32 timings' if 'speed' in parts else ''})")
    if "f64" in parts:
        t0 = time.perf_counter()
        ref = one_process(torch, inp)
        print(f"[cards-train] the one-process reference took {time.perf_counter() - t0:.1f} s")
        failed += dp_compare(torch, ranks, ref, f"[cards-train] {n} NCCL ranks vs one process,"
                                                f" f64")
        per_rank = [r["chain"]["launches"] for r in ranks]
        print(f"[cards-train] den kernel launches in the {DP_STEPS} chain steps, by rank:"
              f" {per_rank}")
        if not all(v >= DP_STEPS for c in per_rank for v in c.values()):
            failed.append(f"a rank's chain step did not launch K2f/K2b: {per_rank}")
        t0 = time.perf_counter()
        controls = (("one process again on cuda:0", lambda: one_process(torch, inp, ("chain",))),
                    (f"one process on cuda:{min(1, n - 1)}",
                     lambda: one_process(torch, inp, ("chain",), card=min(1, n - 1))),
                    (f"{n} gloo ranks on cuda:0..{n - 1}",
                     lambda: dp_workers(torch, path, n, "gloo-cards", "chain")[0]),
                    (f"{n} gloo ranks on cuda:0", lambda: dp_workers(torch, path, n, "gloo",
                                                                     "chain")[0]))
        for label, run in controls:
            got, want = run()["chain"], ref["chain"]
            loss = max(abs(a - b) / abs(b) for a, b in zip(got["loss"], want["loss"]))
            print(f"[cards-train] control, the chain in f64, {label} vs one process: losses rel"
                  f" {loss:.3e}; by step: {chain_stages(got, want)}")
        ranks32 = dp_workers(torch, path, n, "nccl", "chain", "float32")
        ref32 = one_process(torch, inp, ("chain",), "float32")
        got, want = ranks32[0]["chain"], ref32["chain"]
        loss = max(abs(a - b) / abs(b) for a, b in zip(got["loss"], want["loss"]))
        print(f"[cards-train] control, the chain in f32, {n} NCCL ranks vs one process: losses"
              f" rel {loss:.3e}; by step: {chain_stages(got, want)}")
        print(f"[cards-train] den kernels, a batch of 16 against its 4 blocks of 4:"
              f" {den_split_check(torch, fx)}; the controls took {time.perf_counter() - t0:.1f} s")

    if "speed" in parts:
        one = dp_workers(torch, path, 1, "none")[0]["speed"]
        for name, o in one.items():
            got = [r["speed"][name] for r in ranks]
            t1, tn = o["ms"], got[0]["ms"]
            m1, mn = float(np.median(t1)), float(np.median(tn))
            rate1, raten = o["audio"] / m1 * 1e3, n * o["audio"] / mn * 1e3
            sync = ", ".join(f"{o['prefix']}{s} {o['sync'][s][0]:.2f} / {o['sync'][s][1]:.2f} vs"
                             f" {got[0]['sync'][s][0]:.2f} / {got[0]['sync'][s][1]:.2f}"
                             for s in o["sync"])
            print(f"[cards-train] {name} a card, f32, TF32 off: one rank without a group"
                  f" {m1:.1f} ms/step (median of {len(t1)} steps, {min(t1):.1f}-{max(t1):.1f}),"
                  f" {rate1:.1f} audio-s/s; {n} NCCL ranks {mn:.1f} ms/step (rank 0's median of"
                  f" {len(tn)}, {min(tn):.1f}-{max(tn):.1f}; the ranks' medians"
                  f" {', '.join('%.1f' % np.median(g['ms']) for g in got)}), {raten:.1f}"
                  f" audio-s/s; scaling efficiency {m1 / mn:.3f} (over the steps' range"
                  f" {min(t1) / max(tn):.3f}-{max(t1) / min(tn):.3f}); sync host / device ms a"
                  f" step, no group vs rank 0: {sync} [{card}]")
    if "clis" not in parts:
        return failed

    clis = train_clis(fx)
    refs = {"train_asr": ("exp", "final.ckpt"), "train_asv": ("exp", "1.ckpt"),
            "train_vc": ("exp_global", "g_best.ckpt")}
    # train_vc's reference (cuda:0), on copies of the data dirs: its
    # feature caches are its own
    args, root, _ = clis["train_vc"]
    for d in ("train", "dev"):
        shutil.copytree(os.path.join(root, d), os.path.join(root, d + "_global"))
        args = [a + "_global" if a == os.path.join(root, d) else a for a in args]
    t0 = time.perf_counter()
    gan_global_reference(args + ["--dirname", os.path.join(root, "exp_global")], n)
    print(f"[cards-train] train_vc on the {n} ranks' global batches in one process:"
          f" {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    with ThreadPoolExecutor(3) as pool:  # the three side by side
        runs = {name: pool.submit(torchrun_cli, name, args + [
            "--dirname", os.path.join(root, f"exp_{n}ranks")], n,
            os.path.join(WORK, f"counts_{name}")) for name, (args, root, _) in clis.items()}
        runs = {name: f.result() for name, f in runs.items()}
    steps = -(-len(SPEAKERS) // 32)
    for name, (args, root, keys) in clis.items():
        wall, counts = runs[name]
        ref_dir, ckpt = refs[name]
        n_logged, worst, rels = logged_departure(np, root, ref_dir, f"exp_{n}ranks", keys,
                                                 name)
        bound = 1e-3 if name == "train_vc" else 1e-5
        pairs = [(ckpt, ckpt)] + ([(f"d_{steps}.ckpt", f"d_{steps}.ckpt")]
                                  if name == "train_vc" else [])
        deps = [ckpt_departure(torch, os.path.join(root, f"exp_{n}ranks", a),
                               os.path.join(root, ref_dir, b)) for a, b in pairs]
        line = (f"[cards-train] torchrun --nproc-per-node {n} (NCCL) {name}: {n_logged} logged"
                f" {'/'.join(keys)} values within rel {worst:.3e} of one process's on the same"
                f" global batches (by step: " + ", ".join(f"{step} {k} {e:.3e}"
                                                          for step, k, e in rels) + "); "
                + "; ".join(f"{a} rel L2 {d[0]:.3e}, worst tensor {d[1][0]:.3e} ({d[1][1]})"
                            for (a, _), d in zip(pairs, deps))
                + f" (bound {bound:g} on every logged value and tensor; {wall:.1f} s with the"
                f" process start, the three side by side); by rank (card, K1, K2f, K2b"
                f" launches): " + ", ".join(f"{r} ({c['card']}, {c['shc_band']},"
                                           f" {c['den_fb_forward']}, {c['den_fb_backward']})"
                                           for r, c in enumerate(counts)))
        print(line)
        if not (worst <= bound and all(d[1][0] <= bound for d in deps)):
            failed.append(line)
        if [c["card"] for c in counts] != list(range(n)):
            failed.append(f"{name}: ranks on cards {[c['card'] for c in counts]}")
        kernel = {"train_asr": ("den_fb_forward", "den_fb_backward"),
                  "train_vc": ("shc_band",)}.get(name, ())
        if not all(c[k] > 0 for c in counts for k in kernel):
            failed.append(f"{name}: a rank launched none of {kernel}: {counts}")
    return failed


def slice_dir32(np):
    """32 voiced utterances of 2-4 s (seeded), a kaldi dir for one full
    batch of B=32 over the cards."""
    from satpu_torch.utils import kaldi_data

    d = os.path.join(WORK, "data32")
    os.makedirs(d)
    wav_scp, utt2spk = {}, {}
    for k in range(32):
        utt = f"b{k:02d}"
        wav_scp[utt] = os.path.join(d, f"{utt}.wav")
        kaldi_data.write_wav(wav_scp[utt], voiced_utterance(
            np, 2.0 + 2.0 * k / 31, 95.0 + 5 * k, seed=1000 + k)[0], SR)
        utt2spk[utt] = f"src{k % 4}"
    kaldi_data.write_keyed_text(wav_scp, os.path.join(d, "wav.scp"))
    kaldi_data.write_keyed_text(utt2spk, os.path.join(d, "utt2spk"))
    return d


def phase_cards_serve(np, torch, card, n: int, ckpt):
    """The serving mesh over n cards. ``anonymize --device cuda:1`` and
    ``anonymize --serve-mesh true`` over the slice phase's dir (cuda:0
    current) against the slice phase's one-card run: exit 0, the same
    utterances, within bf16 serving's rel 2e-2 (on cuda:1 bitwise), K1
    once a block, on cuda:1 alone or on every card in block order. ``process_data`` of the flagship in f32 at B=32 over 32
    utterances on cuda:0..n-1 (32 / n rows a card) against cuda:0 alone:
    every waveform within 1e-6, K1 once a block on its own card. Then the
    flagship bf16 at B=128 x 10 s split over the n cards against one card
    at B=128: audio-s/s, the host-clock ms of the cards' get_f0 and convert
    calls, and each card's device ms of either (a profile). Returns what
    failed."""
    import copy

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from satpu_torch import infer_helper
    from satpu_torch.bin import anonymize, pipeline
    from satpu_torch.parallel import mesh
    from satpu_torch.utils import kaldi_data

    failed = []
    data = os.path.join(WORK, "data")
    ref = kaldi_data.read_wav_scp(os.path.join(data + "_anon", "wav.scp"))
    batches = -(-len(ref) // 8)
    for suffix, extra, cards in (
            ("_card1", ["--device", f"cuda:{min(1, n - 1)}"], [min(1, n - 1)] * batches),
            ("_mesh", ["--serve-mesh", "true"], list(range(n)) * batches)):
        with kernel_cards(torch) as seen:
            rc = anonymize.main(["--checkpoint", ckpt, "--directory", data, "--batch-size", "8",
                                 "--target-selection-algorithm", "random_per_utt",
                                 "--new-datadir-suffix", suffix, "--results-dir",
                                 os.path.join(WORK, "out" + suffix), *extra])
        check(rc == 0, f"anonymize {' '.join(extra)} exited {rc}")
        got = kaldi_data.read_wav_scp(os.path.join(data + suffix, "wav.scp"))
        check(sorted(got) == sorted(ref), f"anonymize {' '.join(extra)} wrote other utterances")
        wavs = {u: (kaldi_data.load_wav_from_scp(got[u])[0].astype(np.float64),
                    kaldi_data.load_wav_from_scp(ref[u])[0].astype(np.float64)) for u in ref}
        rel = max(float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))
                  for a, b in wavs.values())
        bitwise = sum(np.array_equal(a, b) for a, b in wavs.values())
        line = (f"[cards-serve] anonymize {' '.join(extra)} (cuda:0 current): exit 0, {len(got)}"
                f" wavs, {bitwise} bitwise the one-card run's, max rel {rel:.3e} (bf16 serving,"
                f" tolerance 2e-2); K1 launches on cards {seen} (one a block: {cards})")
        print(line)
        # on one card the same program on the same kind of card: the same bits
        if rel > 2e-2 or seen != cards or (suffix == "_card1" and bitwise != len(ref)):
            failed.append(line)

    d32 = slice_dir32(np)
    model, meta = infer_helper.load_model(ckpt, device="cuda")
    devices = [torch.device("cuda", k) for k in range(n)]
    write = pipeline.kaldi_data.write_wav
    outs, cards = {}, {}
    for name, devs in (("one", None), ("mesh", devices)):
        captured = outs[name] = {}

        def capture(path, x, rate, captured=captured):
            captured[os.path.basename(path)] = np.array(x)
            write(path, x, rate)

        pipeline.kaldi_data.write_wav = capture
        try:
            with kernel_cards(torch) as seen:
                pipeline.process_data(model, meta["speakers"], d32,
                                      os.path.join(WORK, f"mesh32_{name}"),
                                      target_selection_algorithm="random_per_utt",
                                      batch_size=32, new_datadir_suffix=f"_{name}",
                                      devices=devs)
        finally:
            pipeline.kaldi_data.write_wav = write
        cards[name] = seen
    worst = max(float(np.abs(outs["mesh"][u] - outs["one"][u]).max()) for u in outs["one"])
    line = (f"[cards-serve] process_data over cuda:0..{n - 1} (the flagship in f32, B=32, {32 // n}"
            f" rows a card): {len(outs['mesh'])} wavs within {worst:.3e} of cuda:0 alone"
            f" (tolerance 1e-6); K1 launches on cards {cards['mesh']}, alone {cards['one']}")
    print(line)
    if sorted(outs["mesh"]) != sorted(outs["one"]) or worst > 1e-6:
        failed.append(line)
    if cards["mesh"] != list(range(n)) or cards["one"] != [0]:
        failed.append(f"K1 not once a block on its own card: {cards}")
    del model

    model, _ = infer_helper.load_model(ckpt, option_args=infer_helper.serving_option_args(),
                                       device="cuda")
    replicas = [model] + [copy.deepcopy(model).to(d) for d in devices[1:]]
    B, T = 128, 10 * SR
    gen = torch.Generator().manual_seed(7)
    wav = torch.randn((B, T), generator=gen) * 0.05
    tid = torch.arange(B) % len(SPEAKERS)
    wavs, tids = mesh.split_rows(wav, devices), mesh.split_rows(tid, devices)
    whole = (wav.cuda(0), tid.cuda(0))

    def sync():
        for d in devices:
            torch.cuda.synchronize(d)

    def mesh_f0():
        return [m.get_f0(w) for m, w in zip(replicas, wavs)]

    def mesh_convert(f0s):
        return [m.convert(w, f, t) for m, w, f, t in zip(replicas, wavs, f0s, tids)]

    def one_batch():
        return model.convert(whole[0], model.get_f0(whole[0]), whole[1])

    def wall_ms(fn, iters=2):
        fn()
        sync()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        sync()
        return (time.perf_counter() - t0) / iters * 1e3

    def card_ms(fn):
        """Each card's kernel milliseconds in a profile of fn()."""
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            sync()
        ms = [0.0] * n
        for e in prof.events():
            if e.device_type == DeviceType.CUDA and not e.is_user_annotation:
                ms[e.device_index] += e.time_range.elapsed_us() / 1e3
        return ms

    with torch.inference_mode():
        one_ms = wall_ms(one_batch)
        mesh_ms = wall_ms(lambda: mesh_convert(mesh_f0()))
        f0s = mesh_f0()
        f0_ms, cv_ms = wall_ms(mesh_f0), wall_ms(lambda: mesh_convert(f0s))
        f0_dev, cv_dev = card_ms(mesh_f0), card_ms(lambda: mesh_convert(f0s))
    rate1, raten = B * 10.0 / one_ms * 1e3, B * 10.0 / mesh_ms * 1e3
    print(f"[cards-serve] flagship bf16 B={B} x 10 s: one card {one_ms:.1f} ms a batch, {rate1:.1f}"
          f" audio-s/s; split over {n} cards ({B // n} rows a card, one host thread)"
          f" {mesh_ms:.1f} ms, {raten:.1f} audio-s/s ({raten / rate1:.2f}x); the {n} cards'"
          f" get_f0 calls {f0_ms:.1f} ms, convert calls {cv_ms:.1f} ms (host clock, synchronized);"
          f" device ms a card get_f0 / convert (profiled): "
          + ", ".join(f"cuda:{k} {a:.1f} / {b:.1f}" for k, (a, b) in enumerate(zip(f0_dev, cv_dev)))
          + f" [{card}]")
    del replicas, model, wavs, whole
    torch.cuda.empty_cache()
    return failed


def phase_cards_eval(paths):
    """``eval_anon --serve-mesh true`` over every card against the one-card
    run (the eval phase's models and graph, the slice phase's dirs): the
    same hypotheses and the same ASR and ASV results (WER, EER,
    linkability, Cllr). Returns what failed."""
    import numpy as np

    one, _, _, ctm, lls = eval_cli(paths, "cuda", "cards_one")
    mesh, wall, decodes, ctm_mesh, lls_mesh = eval_cli(paths, "cuda", "cards_mesh",
                                                       "--serve-mesh", "true")
    ll_rel = max(float(np.abs(lls_mesh[u] - lls[u]).max() / np.abs(lls[u]).max()) for u in lls)
    same = ctm_mesh == ctm and mesh == one
    line = (f"[cards-eval] eval_anon --serve-mesh true over the cards ({wall:.2f} s, {decodes}"
            f" lattice decodes): hypotheses and results equal the one-card run's: {same} (WER"
            f" {mesh['asr']['wer']:.2f} vs {one['asr']['wer']:.2f}, EER {mesh['asv']['eer']:.4f}"
            f" vs {one['asv']['eer']:.4f}, linkability {mesh['asv']['linkability']:.4f}, Cllr"
            f" {mesh['asv']['cllr']:.6f}); loglikes rel {ll_rel:.3e}")
    print(line)
    return [] if same else [line]


def phase_cards_export(np, torch, n: int, ckpt):
    """``hub.export_convert`` of the flagship (bf16 serving) on cuda:1 at
    B=2 x 2 s, loaded with ``torch.export.load`` and run with cuda:0
    current: the same bits as the eager convert on cuda:1, K1 launched on
    cuda:1 (cuda:0 with one card). Returns what failed."""
    from satpu_torch import hub, infer_helper

    dev = torch.device("cuda", min(1, n - 1))
    model, _ = infer_helper.load_model(ckpt, option_args=infer_helper.serving_option_args(),
                                       device=dev)
    model.eval()
    B, T = 2, 2 * SR
    path = os.path.join(WORK, "convert_cuda1.pt2")
    t0 = time.perf_counter()
    hub.export_convert(model, path, batch=B, num_samples=T)
    export_s = time.perf_counter() - t0
    gen = torch.Generator(device=dev).manual_seed(5)
    wav = torch.randn((B, T), generator=gen, device=dev) * 0.05
    tid = torch.arange(B, device=dev)
    torch.cuda.set_device(0)
    t0 = time.perf_counter()
    prog = torch.export.load(path).module()
    load_s = time.perf_counter() - t0
    with torch.no_grad():
        eager = model.convert(wav, model.get_f0(wav), tid)
        with kernel_cards(torch) as seen:
            out = prog(wav, tid)
    same = out.device == dev and bool(torch.equal(out, eager))
    line = (f"[cards-export] hub.export_convert of the flagship (bf16 serving) on {dev} at"
            f" B={B} x {T // SR} s in {export_s:.1f} s, loaded in {load_s:.1f} s and run with"
            f" cuda:0 current: output on {out.device}, bitwise the eager convert on {dev}:"
            f" {same} (max abs {float((out.float() - eager.float()).abs().max()):.3e}); K1"
            f" launches on cards {seen}")
    print(line)
    del model, prog
    torch.cuda.empty_cache()
    return [] if same and seen == [dev.index] else [line]


CARD_PARTS = ("kernels", "f64", "speed", "clis", "serve", "eval", "export")


def cards_main(np, torch, n: int, card: str, lap, parts=CARD_PARTS) -> None:
    """``--cards n``: the kernels on every card, then data-parallel training
    over n NCCL ranks, the serving mesh over n cards, eval_anon's mesh and
    the exported anonymizer on cuda:1, after the one-card runs they are held
    against (the slice, train, asv and eval phases; the gan phase's data).
    ``parts`` (``--only``) picks among CARD_PARTS. Fails at the end with
    every comparison that failed."""
    phase_build()
    lap("build")
    if "kernels" in parts:
        phase_cards_kernels(np, torch, n)
        lap("kernels on every card")
    failed = []
    if set(parts) - {"kernels"}:
        _, ckpt = phase_slice(np, torch)
        _, fx = phase_train(np, torch)
        if "clis" in parts:
            phase_asv(np, torch, card)
            gan_dirs(np)
        lap("the one-card runs and data")
    if {"f64", "speed", "clis"} & set(parts):
        failed += phase_cards_train(np, torch, card, n, fx, parts)
        lap("data-parallel training")
    if "serve" in parts:
        failed += phase_cards_serve(np, torch, card, n, ckpt)
        lap("serving mesh")
    if "eval" in parts:
        _, paths, _, _ = eval_setup(np, torch)
        failed += phase_cards_eval(paths)
        lap("eval_anon mesh")
    if "export" in parts:
        failed += phase_cards_export(np, torch, n, ckpt)
        lap("export on cuda:1")
    check(not failed, "the multi-card run:\n" + "\n".join(failed))


# ``--kernel-only NAME``: a source's kernel phase and the counter of each
# entry it returns
KERNEL_PHASES = {"shc": (phase_kernel, {"shc_band": "k1"}),
                 "viterbi": (phase_viterbi_kernel, {"viterbi_path": "k4"}),
                 "num_fb": (phase_num_kernel, {"num_fb_forward": "k3f",
                                               "num_fb_backward": "k3b"})}


def main() -> int:
    import torch

    if sys.argv[1:2] == ["--dp-worker"]:  # a rank of a data-parallel check
        return dp_worker(*(int(a) for a in sys.argv[2:5]), *sys.argv[5:10])
    if sys.argv[1:2] == ["--cli-rank"]:  # a rank of a CLI under torch.distributed.run
        return cli_rank(sys.argv[2], sys.argv[3], sys.argv[4:])
    if sys.argv[1:2] == ["--bn-worker"]:  # a rank of the surface phase's batch-norm check
        return bn_worker(*(int(a) for a in sys.argv[2:5]), sys.argv[5])
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on the card",
              file=sys.stderr)
        return 1
    cards, parts = None, CARD_PARTS
    if sys.argv[1:2] == ["--cards"] and len(sys.argv) in (3, 5):
        cards = int(sys.argv[2])
        if len(sys.argv) == 5:
            parts = tuple(sys.argv[4].split(","))
            if sys.argv[3] != "--only" or not set(parts) <= set(CARD_PARTS):
                print(f"chip_smoke --cards N [--only {','.join(CARD_PARTS)}]", file=sys.stderr)
                return 1
    if cards is not None and not 1 <= cards <= torch.cuda.device_count():
        print(f"chip_smoke --cards {cards}: {torch.cuda.device_count()} CUDA card(s) visible",
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
    if sys.argv[1:2] == ["--kernel-only"]:  # one kernel source's build and phase alone
        name = sys.argv[2] if len(sys.argv) == 3 else None
        if name not in KERNEL_PHASES:
            print(f"chip_smoke --kernel-only {{{','.join(KERNEL_PHASES)}}}", file=sys.stderr)
            return 1
        phase, counters = KERNEL_PHASES[name]
        phase_build((name,))
        n0 = {c: kernel_launches(c) for c in counters.values()}
        entries = phase(np, torch)
        entries = entries if isinstance(entries, list) else [entries]
        for entry in entries:  # the launches this phase made, as counted by the wrapper
            c = counters[entry["name"]]
            entry["launches"] = kernel_launches(c) - n0[c]
        print(json.dumps({"kernels": entries}))
        print(f"[done] {name} kernel phase passed in {time.perf_counter() - t_start:.1f} s")
        return 0
    clock = [t_start]

    def lap(path: str) -> None:
        """Print the wall time since the last lap: each path's share of the
        script's time limit."""
        now = time.perf_counter()
        print(f"[time] {path}: {now - clock[0]:.1f} s")
        clock[0] = now

    if cards is not None:
        for line in subprocess.run(["nvidia-smi", "--query-gpu=index,name,power.limit",
                                    "--format=csv,noheader"], capture_output=True, text=True,
                                   check=True).stdout.splitlines():
            print(f"[card] {line}")
        cards_main(np, torch, cards, card, lap, parts)
        shutil.rmtree(WORK, ignore_errors=True)
        print(f"[done] the {cards}-card run ({','.join(parts)}) passed in"
              f" {time.perf_counter() - t_start:.1f} s")
        print(card)
        print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                                  "kind": torch.cuda.get_device_name(0),
                                                  "count": torch.cuda.device_count()}}))
        return 0
    phase_build()
    lap("build")
    # serving: anonymize (kernel K1)
    entries = [phase_kernel(np, torch), phase_viterbi_kernel(np, torch)]
    launches, ckpt = phase_slice(np, torch)
    phase_cpu(np, torch, ckpt)
    lap("serving")
    # chain training: train_asr (kernels K2f, K2b)
    entries += phase_den_kernel(np, torch, den_graph())
    entries += phase_num_kernel(np, torch)
    train_launches, fx = phase_train(np, torch)
    launches.update(train_launches)
    phase_train_cpu(np, torch)
    phase_train_throughput(np, torch, fx, card)
    lap("chain training")
    # evaluation: eval_anon over the slice phase's output (no kernel of its own)
    graph, paths = phase_eval(np, torch, card)
    phase_eval_throughput(np, torch, graph, paths, card)
    lap("evaluation")
    # GAN training: train_vc (its feature warm-up runs kernels K1 and K4)
    gan_launches, gan_shc_err = phase_gan(np, torch, card)
    for name, n in gan_launches.items():
        print(f"[kernels] {name} launches by path: anonymize {launches[name]}, train_vc {n}"
              " (their sum in the kernels line)")
        launches[name] += n
    shc = next(e for e in entries if e["name"] == "shc_band")
    shc["max_abs_err"] = max(shc["max_abs_err"], gan_shc_err)
    phase_gan_cpu(np, torch)
    phase_gan_throughput(np, torch, card)
    lap("GAN training")
    # ASV training: train_asv (no kernel of its own)
    phase_asv(np, torch, card)
    phase_asv_cpu(np, torch)
    phase_asv_throughput(np, torch, card)
    lap("ASV training")
    # the card's fbank on the slice phase's near-constant anonymized output
    fbank_cmvn_check(np, torch)
    lap("fbank")
    # ASR-BN variants: prepare_data -> train_asr of the B5 extractor (K2f, K2b)
    w2v2_launches = phase_w2v2_train(np, torch, card)
    phase_w2v2_cpu(np, torch)
    w2v2_errs = phase_w2v2_den(np, torch, fx)
    for entry, err in zip((e for e in entries if e["name"].startswith("den_fb")), w2v2_errs):
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
    print("[kernels] den kernel launches by path: " + ", ".join(
        f"{name} train_asr tdnnf_vq {launches[name]}, tdnnf_wav2vec2_vq {w2v2_launches[name]}"
        for name in w2v2_launches) + " (their sums in the kernels line)")
    for name, n in w2v2_launches.items():
        launches[name] += n
    lap("B5 chain training")
    # the WavLM-large judge: eval_anon and ASV training (no kernel of its own)
    wavlm_ckpt = phase_wavlm_eval(np, torch, card)
    phase_wavlm_throughput(np, torch, card, wavlm_ckpt)
    phase_wavlm_train(np, torch, card)
    lap("WavLM judge")
    # model distribution: reference final.pt -> import_model -> hub -> anonymize --num-procs
    phase_distribution(np, torch, card, ckpt)
    lap("distribution")
    # scale-out: data-parallel training (K2f, K2b in the ranks' chain steps),
    # the serving mesh and the exported anonymizer (K1, K4)
    for name, n in phase_dp_train(np, torch, card, fx).items():
        launches[name] += n
    lap("dp-train")
    mesh_launches = phase_serve_mesh(np, torch, ckpt)
    lap("serve-mesh")
    export_launches = phase_export(np, torch, card, ckpt)
    lap("export")
    # the rest of satpu's surface (no kernel of its own)
    phase_surface(np, torch, card, paths, ckpt)
    lap("surface")
    for name in mesh_launches:
        print(f"[kernels] {name} launches of the scale-out paths: serve-mesh"
              f" {mesh_launches[name]}, the exported program {export_launches[name]} (in the"
              " kernels line)")
        launches[name] += mesh_launches[name] + export_launches[name]
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
