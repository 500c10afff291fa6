"""satpu_torch — the PyTorch/CUDA port of satpu: anonymization serving and
LF-MMI chain training of its bottleneck extractor.

A package beside ``satpu`` (the JAX reference, which it never imports) that
runs the same models with PyTorch on an NVIDIA GPU. Each module mirrors its
``satpu`` counterpart by path and name (``satpu_torch.ops.yaapt`` ↔
``satpu.ops.yaapt``); the parity tests in ``tests/test_torch_*.py`` hold each
one against it on the same weights and inputs.

- ``satpu_torch.ops``    fbank, CMVN, YAAPT F0 (its SHC band is the
                         hand-written CUDA kernel ``csrc/shc.cu``).
- ``satpu_torch.models`` TDNN-F ASR-BN extractor (inference and training),
                         HiFi-GAN generator, the anonymizer, and the weight
                         bridge from satpu variables.
- ``satpu_torch.chain``  FST and den-graph code, the chain objective (its den
                         forward-backward is the CUDA kernel pair
                         ``csrc/den_fb.cu``), NG-SGD, egs and the trainer.
- ``satpu_torch.utils``  kaldi data dirs, INI/dataclass options,
                         checkpoints, metrics log, the CUDA build helper.
- ``satpu_torch.bin``    the ``anonymize`` CLI and its pipeline, and the
                         ``train_asr`` CLI.

Entry points run on ``cuda`` unless the caller asks for the CPU; they raise
when CUDA is absent rather than falling back.
"""
from __future__ import annotations

import torch

__version__ = "0.1.0"


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; raises if it names CUDA and none exists."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' (or --device cpu) to "
            "run on the CPU")
    return dev
