"""TDNN-F ASR-BN acoustic model with fbank front (port of ``satpu.models.asrbn``).

fbank80 -> UttCMVN -> replicate-pad -> TDNNF x12 (subsample /2, then /1.5
after the BN layer) -> chain/xent heads; ``extract_bn`` returns the
stage-1 prefinal bottleneck (dim 256), vector-quantized for the "vq"
variant. Public functions keep satpu's layouts ([B, T, C]); the layers run
in NCW.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn as nn

from ..ops.cmvn import utt_cmvn
from ..ops.fbank import fbank as kaldi_fbank
from .tdnnf import (
    NaturalAffineTransform,
    TDNNFBatchNorm,
    VQBottleneck,
    get_padding,
    mask_replicate_tail,
    pad_input_replicate,
)


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
    # bottleneck transform at the BN layer: "none" | "vq" ("dp" is not ported)
    bottleneck: str = "none"
    codebook_size: int = 0
    # "float32" | "bfloat16": matmul compute dtype for serving
    compute_dtype: str = "float32"
    # training-only fields of satpu's config, accepted so its build params
    # load; inference reads none of them
    p_dropout: float = 0.1
    epsilon: float = 0.0
    natural_gradient: bool = False


class TDNNFNet(nn.Module):
    """The 13-layer TDNN-F chain network with BN extraction."""

    def __init__(self, cfg: TDNNFNetConfig):
        super().__init__()
        if cfg.bottleneck not in ("none", "vq"):
            raise NotImplementedError(
                f"bottleneck {cfg.bottleneck!r} is not ported; 'none' and 'vq' are")
        self.cfg = c = cfg
        ks, ss = list(c.kernel_size_list), list(c.subsampling_factor_list)
        ksa, ssa = list(c.kernel_size_list_after), list(c.subsampling_factor_list_after)
        self.padding = get_padding(ks, ss) // 2
        self.padding_after = get_padding(ksa, ssa) // 2
        dt = c.compute_dtype
        self.tdnn1 = TDNNFBatchNorm(c.num_mel_bins, c.hidden_dim, c.bottleneck_dim,
                                    context_len=ks[0], subsampling_factor=ss[0],
                                    compute_dtype=dt)
        layers = [TDNNFBatchNorm(c.hidden_dim, c.hidden_dim, c.bottleneck_dim,
                                 context_len=ks[i], subsampling_factor=ss[i],
                                 compute_dtype=dt)
                  for i in range(1, len(ks) - 1)]
        bfunc = (VQBottleneck(c.codebook_size, c.prefinal_bottleneck_dim)
                 if c.bottleneck == "vq" else None)
        layers.append(TDNNFBatchNorm(c.hidden_dim, c.hidden_dim, c.prefinal_bottleneck_dim,
                                     context_len=ks[-1], subsampling_factor=ss[-1],
                                     bypass_scale=0.0, bottleneck_func=bfunc,
                                     compute_dtype=dt))
        self.tdnnfs = nn.ModuleList(layers)
        self.tdnnfs_after = nn.ModuleList(
            TDNNFBatchNorm(c.hidden_dim, c.hidden_dim, c.bottleneck_dim,
                           context_len=ksa[i], subsampling_factor=ssa[i], compute_dtype=dt)
            for i in range(len(ksa)))
        self.prefinal_chain = TDNNFBatchNorm(c.hidden_dim, c.hidden_dim,
                                             c.prefinal_bottleneck_dim, compute_dtype=dt)
        self.prefinal_xent = TDNNFBatchNorm(c.hidden_dim, c.hidden_dim,
                                            c.prefinal_bottleneck_dim, compute_dtype=dt)
        self.chain_output = NaturalAffineTransform(c.hidden_dim, c.output_dim, compute_dtype=dt)
        self.xent_output = NaturalAffineTransform(c.hidden_dim, c.output_dim, compute_dtype=dt)

    def features(self, wav: torch.Tensor,
                 lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        """[B, T] audio in [-1, 1] -> padded CMVN fbank [B, T', 80].

        ``lengths`` ([B] valid sample counts) makes a zero-padded batch give
        the same valid frames as per-length runs."""
        x = kaldi_fbank(wav * 32768.0, num_mel_bins=self.cfg.num_mel_bins, snip_edges=False)
        if lengths is not None:
            feat_len = (lengths + 80) // 160
            x = utt_cmvn(x, lengths=feat_len)
            x = mask_replicate_tail(x.transpose(1, 2), feat_len).transpose(1, 2)
        else:
            x = utt_cmvn(x)
        return pad_input_replicate(x.transpose(1, 2), self.padding).transpose(1, 2)

    def _stage1(self, wav: torch.Tensor, lengths: Optional[torch.Tensor]) -> torch.Tensor:
        x = self.tdnn1(self.features(wav, lengths).transpose(1, 2))
        for layer in self.tdnnfs[:-1]:
            x = layer(x)
        return x

    def forward(self, wav: torch.Tensor, lengths: Optional[torch.Tensor] = None):
        """-> (chain_out [B, T_sub, pdf], xent log-softmax [B, T_sub, pdf])."""
        x = self.tdnnfs[-1](self._stage1(wav, lengths))
        x = pad_input_replicate(x, self.padding_after)
        for layer in self.tdnnfs_after:
            x = layer(x)
        chain_out = self.chain_output(self.prefinal_chain(x))
        xent_out = self.xent_output(self.prefinal_xent(x))
        return (chain_out.transpose(1, 2),
                torch.log_softmax(xent_out, dim=1).transpose(1, 2))

    def extract_bn(self, wav: torch.Tensor,
                   lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        """[B, T] audio -> [B, T_bn, 256] linguistic bottleneck."""
        x = self.tdnnfs[-1](self._stage1(wav, lengths), return_bottleneck=True)
        return x.transpose(1, 2)


def fbank_num_frames(num_samples: int) -> int:
    """kaldi fbank frame count, snip_edges=False."""
    return (num_samples + 80) // 160


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
