"""TDNN-F ASR-BN acoustic models (port of ``satpu.models.asrbn``).

``TDNNFNet``: fbank80 -> UttCMVN -> replicate-pad -> TDNNF x12 (subsample
/2, then /1.5 after the BN layer) -> chain/xent heads; ``extract_bn``
returns the stage-1 prefinal bottleneck (dim 256), vector-quantized for
the "vq" variant and Laplace-noised for "dp" (``DpLaplaceBottleneck``,
noise b = 1 / epsilon in training and at inference, as in satpu).
``Wav2Vec2TDNNFNet`` puts a wav2vec2 front (``models.wav2vec2``) before a
3-layer stage 1 (``wav2vec2_tdnnf_config``): the VoicePrivacy B5 model.

Public functions keep satpu's layouts ([B, T, C]); the layers run in NCW.
In training mode (``net.train()``) the forward is satpu's ``train=True``:
dropout after every hidden layer (none in the wav2vec2 net, as in satpu),
batch statistics, the VQ EMA update, and natural-gradient affines where
the config asks for them. Random draws (dropout, the DP noise) come from
the ``generator`` a forward is given (torch's default one if None).

``TDNNFNet`` runs its fbank, CMVN, TDNN-F layers and BN layer (with its VQ)
in the spans ``asrbn.fbank``, ``asrbn.cmvn``, ``asrbn.tdnnf`` and
``asrbn.vq`` (``utils.trace``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn as nn

from ..ops.cmvn import utt_cmvn
from ..parallel import mesh
from ..utils.trace import span
from ..ops.fbank import fbank as kaldi_fbank
from ..ops.fbank import num_frames
from .tdnnf import (
    NaturalAffineTransform,
    TDNNFBatchNorm,
    VQBottleneck,
    get_padding,
    mask_replicate_tail,
    pad_input_replicate,
)
from .wav2vec2 import Wav2Vec2Config, Wav2Vec2Model


@dataclasses.dataclass(frozen=True)
class TDNNFNetConfig:
    """Architecture hyperparameters (same fields and defaults as satpu's)."""

    output_dim: int = 3280
    hidden_dim: int = 1024
    bottleneck_dim: int = 128
    prefinal_bottleneck_dim: int = 256
    kernel_size_list: Tuple[int, ...] = (3, 3, 3, 1, 3, 3, 3, 3, 3, 3, 3, 3)
    subsampling_factor_list: Tuple[float, ...] = (1, 1, 1, 2, 1, 1, 1, 1, 1, 1, 1, 1)
    kernel_size_list_after: Tuple[int, ...] = (1, 3, 3, 3)
    subsampling_factor_list_after: Tuple[float, ...] = (1.5, 1, 1, 1)
    num_mel_bins: int = 80
    # bottleneck transform at the BN layer: "none" | "vq" | "dp"
    bottleneck: str = "none"
    codebook_size: int = 0
    # "float32" | "bfloat16": matmul compute dtype for serving
    compute_dtype: str = "float32"
    # training: dropout after each hidden layer; NG-SGD on every affine
    p_dropout: float = 0.1
    natural_gradient: bool = False
    # the "dp" bottleneck's Laplace noise scale is 1 / epsilon
    epsilon: float = 0.0


def laplace_noise(x: torch.Tensor, u: torch.Tensor, epsilon: float) -> torch.Tensor:
    """x plus Laplace(0, 1 / epsilon) noise by inversion of ``u``, uniform
    in [-0.5 + 1e-7, 0.5): x - b sign(u) log(1 - 2|u|)."""
    return x - (1.0 / epsilon) * torch.sign(u) * torch.log1p(-2.0 * u.abs())


class DpLaplaceBottleneck(nn.Module):
    """Laplace-noise bottleneck for differential privacy: every call (in
    training and at inference, as satpu's) adds noise of scale 1 /
    ``epsilon``, drawn uniform from ``generator`` (set by the network for
    each forward; torch's default generator if None)."""

    def __init__(self, epsilon: float):
        super().__init__()
        self.epsilon = epsilon
        self.generator: Optional[torch.Generator] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lo = -0.5 + 1e-7
        u = mesh.global_rows(lambda shape: torch.rand(
            shape, generator=self.generator, device=x.device, dtype=x.dtype), x.shape)
        u = u * (0.5 - lo) + lo
        return laplace_noise(x, u, self.epsilon)


class TDNNFNet(nn.Module):
    """The 13-layer TDNN-F chain network with BN extraction.

    ``input_dim`` is the width of the features stage 1 reads (the fbank's
    ``num_mel_bins`` unless a subclass has another front)."""

    def __init__(self, cfg: TDNNFNetConfig, input_dim: Optional[int] = None):
        super().__init__()
        if cfg.bottleneck not in ("none", "vq", "dp"):
            raise ValueError(f"unknown bottleneck {cfg.bottleneck!r}")
        if cfg.bottleneck == "dp" and not cfg.epsilon > 0:
            # satpu's noise scale 1 / epsilon turns every bottleneck to inf / NaN
            raise ValueError(f"the dp bottleneck needs epsilon > 0, not {cfg.epsilon}")
        self.cfg = c = cfg
        ks, ss = list(c.kernel_size_list), list(c.subsampling_factor_list)
        ksa, ssa = list(c.kernel_size_list_after), list(c.subsampling_factor_list_after)
        self.padding = get_padding(ks, ss) // 2
        self.padding_after = get_padding(ksa, ssa) // 2
        kw = dict(compute_dtype=c.compute_dtype, natural_gradient=c.natural_gradient)
        self.tdnn1 = TDNNFBatchNorm(input_dim or c.num_mel_bins, c.hidden_dim,
                                    c.bottleneck_dim, context_len=ks[0],
                                    subsampling_factor=ss[0], **kw)
        layers = [TDNNFBatchNorm(c.hidden_dim, c.hidden_dim, c.bottleneck_dim,
                                 context_len=ks[i], subsampling_factor=ss[i], **kw)
                  for i in range(1, len(ks) - 1)]
        bfunc = (VQBottleneck(c.codebook_size, c.prefinal_bottleneck_dim)
                 if c.bottleneck == "vq" else DpLaplaceBottleneck(c.epsilon)
                 if c.bottleneck == "dp" else None)
        layers.append(TDNNFBatchNorm(c.hidden_dim, c.hidden_dim, c.prefinal_bottleneck_dim,
                                     context_len=ks[-1], subsampling_factor=ss[-1],
                                     bypass_scale=0.0, bottleneck_func=bfunc, **kw))
        self.tdnnfs = nn.ModuleList(layers)
        self.tdnnfs_after = nn.ModuleList(
            TDNNFBatchNorm(c.hidden_dim, c.hidden_dim, c.bottleneck_dim,
                           context_len=ksa[i], subsampling_factor=ssa[i], **kw)
            for i in range(len(ksa)))
        self.prefinal_chain = TDNNFBatchNorm(c.hidden_dim, c.hidden_dim,
                                             c.prefinal_bottleneck_dim, **kw)
        self.prefinal_xent = TDNNFBatchNorm(c.hidden_dim, c.hidden_dim,
                                            c.prefinal_bottleneck_dim, **kw)
        dt = c.compute_dtype
        self.chain_output = NaturalAffineTransform(c.hidden_dim, c.output_dim, compute_dtype=dt)
        self.xent_output = NaturalAffineTransform(c.hidden_dim, c.output_dim, compute_dtype=dt)

    def features(self, wav: torch.Tensor,
                 lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        """[B, T] audio in [-1, 1] -> padded CMVN fbank [B, T', 80].

        ``lengths`` ([B] valid sample counts) makes a zero-padded batch give
        the same valid frames as per-length runs."""
        with span("asrbn.fbank"):
            x = kaldi_fbank(wav * 32768.0, num_mel_bins=self.cfg.num_mel_bins,
                            snip_edges=False)
        with span("asrbn.cmvn"):
            if lengths is not None:
                feat_len = (lengths + 80) // 160
                x = utt_cmvn(x, lengths=feat_len)
                x = mask_replicate_tail(x.transpose(1, 2), feat_len).transpose(1, 2)
            else:
                x = utt_cmvn(x)
            return pad_input_replicate(x.transpose(1, 2), self.padding).transpose(1, 2)

    def _dropout(self, x: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
        p = self.cfg.p_dropout
        if not self.training or p <= 0:
            return x
        keep = 1.0 - p
        mask = mesh.global_rows(
            lambda shape: torch.rand(shape, generator=generator, device=x.device), x.shape) < keep
        return torch.where(mask, x / keep, torch.zeros_like(x))

    def _stage1(self, wav: torch.Tensor, lengths: Optional[torch.Tensor],
                generator: Optional[torch.Generator] = None,
                dropout: bool = False) -> torch.Tensor:
        bfunc = self.tdnnfs[-1].tdnn.bottleneck_func
        if isinstance(bfunc, DpLaplaceBottleneck):
            bfunc.generator = generator
        drop = (lambda x: self._dropout(x, generator)) if dropout else (lambda x: x)
        x = self.features(wav, lengths).transpose(1, 2)
        with span("asrbn.tdnnf"):
            x = drop(self.tdnn1(x))
            for layer in self.tdnnfs[:-1]:
                x = drop(layer(x))
        return x

    def forward(self, wav: torch.Tensor, lengths: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None, return_bn: bool = False):
        """-> (chain_out [B, T_sub, pdf], xent log-softmax [B, T_sub, pdf]).

        In training mode the tuple has a third entry, the auxiliary outputs:
        ``{"vq_loss", "vq_perplexity"}`` of the VQ bottleneck (empty without
        one); names ending in ``_loss`` are added to the training loss, the
        rest are metrics. Dropout and the DP noise draw from ``generator``.
        ``return_bn`` appends the BN layer's bottleneck [B, D, T_bn] (NCW),
        the speaker-adversarial tap; as in satpu, the BN layer's TDNN-F then
        runs twice, once for the tap and once for the heads."""
        x = self._stage1(wav, lengths, generator, True)
        with span("asrbn.vq"):
            bn = self.tdnnfs[-1](x, return_bottleneck=True) if return_bn else None
            x = self._dropout(self.tdnnfs[-1](x), generator)
        with span("asrbn.tdnnf"):
            x = pad_input_replicate(x, self.padding_after)
            for layer in self.tdnnfs_after:
                x = self._dropout(layer(x), generator)
            chain_out = self.chain_output(self.prefinal_chain(x))
            xent_out = self.xent_output(self.prefinal_xent(x))
        out = (chain_out.transpose(1, 2), torch.log_softmax(xent_out, dim=1).transpose(1, 2))
        if self.training:
            bfunc = self.tdnnfs[-1].tdnn.bottleneck_func
            out += (dict(getattr(bfunc, "aux", {})),)
        return out + (bn,) if return_bn else out

    def extract_bn(self, wav: torch.Tensor, lengths: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """[B, T] audio -> [B, T_bn, 256] linguistic bottleneck."""
        x = self._stage1(wav, lengths, generator)
        with span("asrbn.vq"):
            x = self.tdnnfs[-1](x, return_bottleneck=True)
        return x.transpose(1, 2)


class Wav2Vec2TDNNFNet(TDNNFNet):
    """The wav2vec2-fronted chain network (satpu's ``Wav2Vec2TDNNFNet``):
    the wav2vec2 encoder's last-layer features, one frame replicate-padded
    at the end (so the front's /320 lines up with the chain frames), then
    replicate padding, a 3-layer stage 1 whose last layer is the BN layer
    (VQ / DP / none), the /1.5 stage 2 [1,3,3,3] and the chain/xent heads.
    ``cfg.num_mel_bins`` and ``cfg.p_dropout`` are unused (satpu's net has
    no dropout); the forward takes no ``lengths``."""

    def __init__(self, cfg: TDNNFNetConfig, w2v2: Wav2Vec2Config):
        super().__init__(cfg, input_dim=w2v2.hidden_size)
        self.w2v2 = w2v2
        self.preprocessor = Wav2Vec2Model(w2v2)

    def features(self, wav: torch.Tensor, lengths: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
        """[B, T] audio -> padded wav2vec2 features [B, T', hidden]."""
        if lengths is not None:
            raise ValueError("the wav2vec2 front takes no lengths (as satpu's)")
        x = self.preprocessor(wav)
        x = torch.cat([x, x[:, -1:]], dim=1)
        return pad_input_replicate(x.transpose(1, 2), self.padding).transpose(1, 2)

    def _dropout(self, x: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
        return x

    def forward(self, wav: torch.Tensor, generator: Optional[torch.Generator] = None):
        """As ``TDNNFNet.forward``, without lengths and the BN tap."""
        return super().forward(wav, generator=generator)

    def extract_bn(self, wav: torch.Tensor,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return super().extract_bn(wav, generator=generator)


def wav2vec2_tdnnf_config(output_dim: int = 3280, bottleneck: str = "none",
                          codebook_size: int = 0, epsilon: float = 0.0) -> TDNNFNetConfig:
    """The tuning/tdnnf_wav2vec2*.py layout: kernels [3,3,3] / [1,3,3,3];
    ``bottleneck="dp"`` with ``epsilon`` is tdnnf_wav2vec2_dp.py's."""
    return TDNNFNetConfig(
        output_dim=output_dim,
        kernel_size_list=(3, 3, 3),
        subsampling_factor_list=(1, 1, 1),
        kernel_size_list_after=(1, 3, 3, 3),
        subsampling_factor_list_after=(1.5, 1, 1, 1),
        bottleneck=bottleneck, codebook_size=codebook_size, epsilon=epsilon)


def fbank_num_frames(num_samples: int) -> int:
    """kaldi fbank frame count, snip_edges=False."""
    return num_frames(num_samples)


def bn_num_frames(num_samples: int) -> int:
    """extract_bn output frames (stage-1 subsampling /2 with replicate pad)."""
    return (fbank_num_frames(num_samples) + 1) // 2


def output_num_frames(num_samples: int, cfg: Optional[TDNNFNetConfig] = None) -> int:
    """Chain-head output frames: per-layer simulation of the splice arithmetic
    (nwin = (T*D - c*D)//int(s*D) + 1, replicate padding before each stage)."""
    c_ = cfg or TDNNFNetConfig()
    F_ = fbank_num_frames(num_samples)
    ks, ss = list(c_.kernel_size_list), list(c_.subsampling_factor_list)
    ksa, ssa = list(c_.kernel_size_list_after), list(c_.subsampling_factor_list_after)
    F_ += 2 * (get_padding(ks, ss) // 2)
    D = c_.num_mel_bins
    for k, s in zip(ks, ss):
        F_ = (F_ * D - k * D) // int(s * D) + 1
        D = c_.hidden_dim
    F_ += 2 * (get_padding(ksa, ssa) // 2)
    for k, s in zip(ksa, ssa):
        F_ = (F_ * D - k * D) // int(s * D) + 1
    return max(F_, 0)


def f0_num_frames(num_samples: int) -> int:
    """YAAPT frame count with the anonymizer options (20 ms hop at 16 kHz)."""
    return (num_samples + 319) // 320


def wav2vec2_output_num_frames(num_samples: int, cfg: TDNNFNetConfig,
                               w2v2: Wav2Vec2Config) -> int:
    """Chain-head output frames of a ``Wav2Vec2TDNNFNet``: the front's
    frames plus the replicate-padded one, then the splice arithmetic of
    ``output_num_frames`` over both stages."""
    from .wav2vec2 import num_frames

    F_ = num_frames(num_samples, w2v2) + 1
    ks, ss = list(cfg.kernel_size_list), list(cfg.subsampling_factor_list)
    ksa, ssa = list(cfg.kernel_size_list_after), list(cfg.subsampling_factor_list_after)
    F_ += 2 * (get_padding(ks, ss) // 2)
    D = w2v2.hidden_size
    for k, s in zip(ks, ss):
        F_ = (F_ * D - k * D) // int(s * D) + 1
        D = cfg.hidden_dim
    F_ += 2 * (get_padding(ksa, ssa) // 2)
    for k, s in zip(ksa, ssa):
        F_ = (F_ * D - k * D) // int(s * D) + 1
    return max(F_, 0)
