"""X-vector speaker-embedding models (port of ``satpu.sidekit.xvector``).

- ``EcapaXVector``: frontend -> PreEcapaTDNN -> AttentiveStatsPool ->
  192-d embedding -> ArcMargin(s=30, m=0.2) (tuning/ecapa_tdnn.py:22-88).
- ``ResNetXVector``: PreHalfResNet34 -> AttentivePooling(global context) ->
  256-d embedding -> ArcMargin (tuning/resnet.py:34-76).

``forward(wav, target=None, arc_m=None, generator=None)`` returns
((loss, logits), x_vector) like the reference. In training mode (the
module's ``.train()``) batch norm uses batch statistics, and with
``spec_augment`` each utterance's features get a time and a frequency mask
drawn from ``generator``. ``arc_m`` overrides the ArcMargin margin for the
call (fine-tuning raises it to 0.4). Run the forward under
``sidekit.nn.autocast(torch.bfloat16)`` for satpu's bf16 policy: every conv
and linear layer in bf16 (the pooling's and the embedding's too), batch
norm, the pooling statistics and the ArcMargin head in f32.

The frontend is log-mel (``melspec``), MFCC (``mfcc``) or WavLM
(``wavlm``: ``models.wavlm.WavLmFrontEnd``, the module ``preprocessor``,
trained with the rest; no SpecAugment), and the trunk's input width is
the frontend's: ``n_mels``, or WavLM's hidden size. ``wavlm`` is None
(WavLM-large), a ``WavLMConfig`` or its dict (a checkpoint's build
params).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn

from ..models.wavlm import WavLMConfig, WavLmFrontEnd
from ..parallel import mesh
from .archi import PreEcapaTDNN, PreHalfResNet34
from .loss import ArcMarginProduct, normalize
from .nn import BatchNorm, Linear
from .pooling import AttentivePooling, AttentiveStatsPool
from .preprocessor import apply_spec_masks, draw_spec_masks, mel_spec_frontend, mfcc_frontend


@dataclasses.dataclass(frozen=True)
class XVectorConfig:
    """Same fields and defaults as satpu's."""

    num_speakers: int = 1211
    n_mels: int = 80
    arch: str = "ecapa"  # "ecapa" | "resnet"
    channels: int = 512
    embedding_size: int = 192  # 256 for resnet
    arc_s: float = 30.0
    arc_m: float = 0.2
    spec_augment: bool = True
    # "melspec" | "mfcc" | "wavlm" (sidekit/preprocessor.py frontends)
    frontend: str = "melspec"
    wavlm: object = None  # WavLMConfig (or its dict) when frontend == "wavlm"


def wavlm_config(wavlm) -> WavLMConfig:
    """``XVectorConfig.wavlm`` as a ``WavLMConfig``: None is WavLM-large."""
    if wavlm is None:
        return WavLMConfig.large()
    return wavlm if isinstance(wavlm, WavLMConfig) else WavLMConfig.from_dict(wavlm)


class _XVector(nn.Module):
    def __init__(self, cfg: XVectorConfig):
        super().__init__()
        if cfg.frontend not in ("melspec", "mfcc", "wavlm"):
            raise ValueError(f"unknown frontend {cfg.frontend!r}")
        self.cfg = cfg
        if cfg.frontend == "wavlm":
            self.preprocessor = WavLmFrontEnd(wavlm_config(cfg.wavlm))

    @property
    def in_feat(self) -> int:
        """The trunk's input width: the frontend's feature count."""
        if self.cfg.frontend == "wavlm":
            return wavlm_config(self.cfg.wavlm).hidden_size
        return self.cfg.n_mels

    def features(self, wav: torch.Tensor, generator=None) -> torch.Tensor:
        """[B, T] audio -> [B, features, frames], masked in training mode with
        ``spec_augment`` (never the WavLM frontend's)."""
        if self.cfg.frontend == "wavlm":
            return self.preprocessor(wav)
        if self.cfg.frontend == "mfcc":
            x = mfcc_frontend(wav, n_mfcc=self.cfg.n_mels)
        else:
            x = mel_spec_frontend(wav, n_mels=self.cfg.n_mels)
        if self.training and self.cfg.spec_augment:
            # the global batch's masks under data parallelism, this rank's rows
            B, F, T = x.shape
            r, n = mesh.rank(), mesh.world()
            masks = draw_spec_masks(B * n, T, F, generator)
            x = apply_spec_masks(x, [m[r * B:(r + 1) * B] for m in masks])
        return x

    @property
    def head_dtype(self) -> torch.dtype:
        """The parameters' dtype, in which pooling and the head run (f32
        unless the module was cast), whatever the trunk's compute dtype."""
        return self.after_speaker_embedding.weight.dtype

    def embed(self, x: torch.Tensor) -> torch.Tensor:
        """Features -> the embedding before normalization."""
        raise NotImplementedError

    def forward(self, wav: torch.Tensor, target=None, arc_m=None, generator=None):
        x = self.embed(self.features(wav, generator))
        loss, logits = self.after_speaker_embedding(x, target=target, m=arc_m)
        return (loss, logits), normalize(x, dim=1)


class EcapaXVector(_XVector):
    def __init__(self, cfg: XVectorConfig):
        super().__init__(cfg)
        c = cfg.channels
        self.sequence_network = PreEcapaTDNN(self.in_feat, c)
        self.stat_pooling = AttentiveStatsPool(c * 3, 128)
        self.before_speaker_embedding_lin = Linear(c * 3 * 2, cfg.embedding_size, bias=False)
        self.before_speaker_embedding_bn2 = BatchNorm(cfg.embedding_size)
        self.after_speaker_embedding = ArcMarginProduct(cfg.embedding_size, cfg.num_speakers,
                                                        s=cfg.arc_s, m=cfg.arc_m)

    def embed(self, x: torch.Tensor) -> torch.Tensor:
        x = self.stat_pooling(self.sequence_network(x).to(self.head_dtype))
        return self.before_speaker_embedding_bn2(self.before_speaker_embedding_lin(x))


class ResNetXVector(_XVector):
    def __init__(self, cfg: XVectorConfig):
        super().__init__(cfg)
        freqs = self.in_feat // 8
        self.sequence_network = PreHalfResNet34()
        self.stat_pooling = AttentivePooling(256, freqs, global_context=True)
        self.before_speaker_embedding_lin_be = Linear(256 * freqs * 2, cfg.embedding_size,
                                                      bias=False)
        self.before_speaker_embedding_bn_be = BatchNorm(cfg.embedding_size)
        self.after_speaker_embedding = ArcMarginProduct(cfg.embedding_size, cfg.num_speakers,
                                                        s=cfg.arc_s, m=cfg.arc_m)

    def embed(self, x: torch.Tensor) -> torch.Tensor:
        x = self.stat_pooling(self.sequence_network(x).to(self.head_dtype))
        return self.before_speaker_embedding_bn_be(self.before_speaker_embedding_lin_be(x))


def build_xvector(cfg: XVectorConfig) -> nn.Module:
    if cfg.arch == "ecapa":
        return EcapaXVector(cfg)
    if cfg.arch == "resnet":
        return ResNetXVector(dataclasses.replace(cfg, embedding_size=256))
    raise ValueError(cfg.arch)
