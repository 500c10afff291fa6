"""The anonymization (voice-conversion) model (port of ``satpu.models.anonymizer``).

ASR-BN (TDNNF + VQ) + YAAPT F0 + target-speaker one-hot -> HiFi-GAN
waveform:

- ``get_f0``: YAAPT pitch with the anonymizer's options,
- ``get_bn``: the bottleneck features [B, C, T_bn],
- ``forward_decoder``: F0 UttCMVN(keep_zeros), optional F0 transformation,
  nearest interpolation to the BN frame rate, concat with BN and the speaker
  one-hot, CoreHifiGan,
- ``convert``: get_bn + forward_decoder.

``get_bn`` runs in the span ``anon.extractor``, ``forward_decoder`` in
``anon.generator`` (``utils.trace``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn as nn

from ..ops.cmvn import utt_cmvn_keep_zeros
from ..ops.yaapt import _merged_params, yaapt_batch
from ..utils.trace import span
from .asrbn import TDNNFNet, TDNNFNetConfig
from .hifigan import CoreHifiGan, CoreHifiGanConfig, apply_f0_transformation


def interpolate_nearest(x: torch.Tensor, out_len: int) -> torch.Tensor:
    """Nearest-neighbour resampling of the last axis; the source index is
    floor(i * (in_len / out_len)) computed in float32, as satpu does."""
    in_len = x.shape[-1]
    ratio = torch.full((), in_len / out_len, dtype=torch.float32, device=x.device)
    pos = torch.arange(out_len, device=x.device, dtype=torch.float32) * ratio
    idx = torch.clamp(torch.floor(pos).to(torch.int64), 0, in_len - 1)
    return x[..., idx]


YAAPT_OPTS = {
    "frame_length": 35.0,
    "frame_space": 20.0,
    "nccf_thresh1": 0.25,
    "tda_frame_length": 25.0,
}


@dataclasses.dataclass(frozen=True)
class AnonymizerConfig:
    asrbn: TDNNFNetConfig = TDNNFNetConfig()
    # 0 = any-to-one: no target-speaker conditioning
    num_speakers: int = 247
    f0_transformation: str = ""
    # "utt" = UttCMVN(keep_zeros) inside the model; "none" = the caller
    # hands normalized F0 over
    f0_norm: str = "utt"
    upsample_rates: Tuple[int, ...] = (5, 4, 4, 2, 2)
    upsample_kernel_sizes: Tuple[int, ...] = (11, 8, 8, 4, 4)
    upsample_initial_channel: int = 512
    bn_dim: int = 256
    # "float32" | "bfloat16": serving compute dtype for generator convs and
    # TDNNF matmuls (parameters, YAAPT and normalizations stay f32)
    compute_dtype: str = "float32"

    def hifigan_config(self) -> CoreHifiGanConfig:
        return CoreHifiGanConfig(
            input_dim=self.bn_dim + 1 + self.num_speakers,
            upsample_rates=self.upsample_rates,
            upsample_kernel_sizes=self.upsample_kernel_sizes,
            upsample_initial_channel=self.upsample_initial_channel,
            compute_dtype=self.compute_dtype,
        )


class AnonymizationNet(nn.Module):
    """convert(wav, f0, target_ids) -> anonymized waveform."""

    def __init__(self, cfg: AnonymizerConfig):
        super().__init__()
        self.cfg = cfg
        asrbn = cfg.asrbn
        if cfg.compute_dtype != asrbn.compute_dtype:
            asrbn = dataclasses.replace(asrbn, compute_dtype=cfg.compute_dtype)
        self.bn_extractor = TDNNFNet(asrbn)
        self.hifigan = CoreHifiGan(cfg.hifigan_config())

    @staticmethod
    @torch.no_grad()
    def get_f0(wav: torch.Tensor) -> torch.Tensor:
        """[B, T] -> [B, T_f0] YAAPT pitch, on the device of ``wav``."""
        return yaapt_batch(wav.to(torch.float32), _merged_params(YAAPT_OPTS))

    def get_bn(self, wav: torch.Tensor) -> torch.Tensor:
        """[B, T] -> [B, bn_dim, T_bn]."""
        with span("anon.extractor"):
            return self.bn_extractor.extract_bn(wav).transpose(1, 2)

    def forward_decoder(self, f0: torch.Tensor, bn: torch.Tensor, spk_onehot: torch.Tensor,
                        generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(f0 [B, T_f0], bn [B, C, T_bn], spk_onehot [B, S]) -> wav [B, T_out].

        ``generator`` drives the random F0 transformations (awgn)."""
        with span("anon.generator"):
            if self.cfg.f0_norm == "utt":
                f0 = utt_cmvn_keep_zeros(f0, var_norm=True)
            f0 = f0[:, None, :]
            if self.cfg.f0_transformation:
                f0 = apply_f0_transformation(f0, self.cfg.f0_transformation, generator)
            x = torch.cat([bn, interpolate_nearest(f0, bn.shape[-1])], dim=1)
            if self.cfg.num_speakers > 0:
                spk = spk_onehot[:, :, None].to(x.dtype).expand(-1, -1, x.shape[-1])
                x = torch.cat([x, spk], dim=1)
            return self.hifigan(x)[:, 0]

    def convert(self, wav: torch.Tensor, f0: torch.Tensor, target_ids: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """wav [B, T], f0 [B, T_f0], target_ids [B] -> [B, T_out]."""
        bn = self.get_bn(wav)
        if self.cfg.num_speakers > 0:
            # a comparison, not F.one_hot: that one checks the range on the
            # host and so waits for the device
            speakers = torch.arange(self.cfg.num_speakers, device=target_ids.device)
            spk = (target_ids.to(torch.int64)[:, None] == speakers).to(torch.float32)
        else:  # any-to-one: ignored by forward_decoder
            spk = torch.zeros((wav.shape[0], 0), device=wav.device)
        return self.forward_decoder(f0, bn, spk, generator=generator)

    def forward(self, wav: torch.Tensor, f0: torch.Tensor, target_ids: torch.Tensor):
        return self.convert(wav, f0, target_ids)
