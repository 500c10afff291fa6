"""satpu_torch — the PyTorch/CUDA port of satpu: anonymization serving,
LF-MMI chain training of its bottleneck extractor, HiFi-GAN training of its
generator, ASV training of the x-vector privacy judge, and privacy/utility
evaluation.

A package beside ``satpu`` (the JAX reference, which it never imports) that
runs the same models with PyTorch on an NVIDIA GPU. Each module mirrors its
``satpu`` counterpart by path and name (``satpu_torch.ops.yaapt`` ↔
``satpu.ops.yaapt``); the parity tests in ``tests/test_torch_*.py`` hold each
one against it on the same weights and inputs.

- ``satpu_torch.ops``    fbank, CMVN, YAAPT F0 (its SHC band is the
                         hand-written CUDA kernel ``csrc/shc.cu``), the
                         waveform and SpecAugment augmentations.
- ``satpu_torch.models`` TDNN-F ASR-BN extractor (inference and training),
                         its wav2vec2 front, HiFi-GAN generator and
                         discriminators, the anonymizer, the WavLM encoder,
                         and the weight bridge from satpu variables.
- ``satpu_torch.hifigan`` GAN training data (cached features, aligned
                         crops) and the GAN trainer.
- ``satpu_torch.chain``  FST, den-graph and decoding-graph code, the chain
                         objective (its den forward-backward is the CUDA
                         kernel pair ``csrc/den_fb.cu``), NG-SGD, egs, the
                         trainer, lattices, N-best and ARPA rescoring.
- ``satpu_torch.native`` the C++ lattice decoder (satpu's ``decoder.cc``,
                         built with g++ at first use), bound with ctypes.
- ``satpu_torch.sidekit`` x-vector models (ECAPA-TDNN, half-ResNet), their
                         frontends (log-mel, MFCC, WavLM) and training
                         heads, the training data and trainer, x-vector
                         extraction and trial scoring.
- ``satpu_torch.utils``  kaldi data dirs, INI/dataclass options,
                         checkpoints (and a reader of satpu's), metrics log,
                         learning-rate schedules, the CUDA build helper, WER,
                         the kaldi ark writer and fail-fast job fan-out.
- ``satpu_torch.parallel`` data parallelism over torch.distributed with
                         satpu's global-batch semantics, and the process
                         group's set-up from torchrun's or satpu's variables.
- ``satpu_torch.hub``    the model zoo: tags (with option args) to
                         checkpoints under ``$SATPU_ZOO``; ``torch.export``
                         of the anonymizer and the extractors.
- ``satpu_torch.bin``    the ``anonymize`` CLI and its pipeline, the
                         ``train_asr``, ``train_vc``, ``train_asv``,
                         ``eval_anon``, ``prepare_data``, ``import_model``,
                         ``export_model``, ``diff_checkpoints``, ``parity``,
                         ``preprocess_audio``, ``prepare_vctk`` and
                         ``prepare_aug`` CLIs.

Entry points run on ``cuda`` unless the caller asks for the CPU; they raise
when CUDA is absent rather than falling back. Evaluation on the card:
``python -m satpu_torch.bin.eval_anon --data D --asr-checkpoint A
--decode-graph G --words-txt W --asv-checkpoint V --enroll-dir E --trials
T``; add ``--device cpu`` to run it on the CPU. The networks run in f32
with TF32 off; decoding and scoring run on the host.
"""
from __future__ import annotations

import contextlib

import torch

__version__ = "0.1.0"


@contextlib.contextmanager
def f32_matmuls():
    """TF32 off for matmuls and cuDNN convs while the block runs, so that f32
    work runs in f32 on the card (torch leaves cuDNN's TF32 on by default);
    the previous flags are restored on exit."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


@contextlib.contextmanager
def deterministic_convs(enabled: bool = True):
    """cuDNN picks deterministic conv algorithms (no autotuning) while the
    block runs, so that a training run repeats bit for bit on the card: the
    default backward algorithms sum with atomics in a varying order, and
    Adam's sign-like first steps turn those roundings into full updates.
    ``enabled=False`` leaves the flags alone. The previous flags are
    restored on exit."""
    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    if enabled:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; raises if it names CUDA and none exists."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' (or --device cpu) to "
            "run on the CPU")
    return dev
