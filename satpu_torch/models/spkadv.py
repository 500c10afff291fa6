"""Speaker-adversarial chain network (port of ``satpu.models.spkadv``).

A TDNN-F chain acoustic model whose BN bottleneck also feeds, through a
gradient-reversal layer, an x-vector speaker classifier: a
``PreHalfResNet34`` trunk over the bottleneck seen as a [D, T] image,
attentive pooling without global context, a linear embedding (256) and an
ArcMargin head (s 30, m 0.2). Training adds the speaker cross-entropy to
the chain objective; the reversed gradient pushes the bottleneck to carry
no speaker (the privacy knob of the ASR-BN extractor). With ``adversarial``
off the branch is a plain second task.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from ..parallel import mesh
from ..sidekit.archi import PreHalfResNet34
from ..sidekit.loss import ArcMarginProduct
from ..sidekit.pooling import AttentivePooling
from .asrbn import TDNNFNet, TDNNFNetConfig
from .tdnnf import rev_grad
from .torchlayers import Linear


class SpkAdvTDNNFNet(nn.Module):
    """(wav, spk_target) -> (chain_out, xent_out[, aux]); in training with
    ``spk_target`` the aux outputs hold ``spkadv_loss`` (``adv_weight`` x
    the ArcMargin cross-entropy, added to the training loss) and
    ``spkadv_accuracy`` (a metric)."""

    def __init__(self, cfg: TDNNFNetConfig, num_speakers: int, adversarial: bool = True,
                 rev_alpha: float = 1.0, emb_dim: int = 256, adv_weight: float = 1.0):
        super().__init__()
        self.cfg = cfg
        self.adversarial, self.rev_alpha, self.adv_weight = adversarial, rev_alpha, adv_weight
        self.acoustic = TDNNFNet(cfg)
        self.asi_trunk = PreHalfResNet34()
        # the trunk turns the [D, T] bottleneck into [256, D/8, T/8]
        pooled = 256 * (cfg.prefinal_bottleneck_dim // 8)
        self.asi_pool = AttentivePooling(pooled, 1, global_context=False)
        self.asi_emb = Linear(2 * pooled, emb_dim)
        self.asi_margin = ArcMarginProduct(emb_dim, num_speakers, s=30.0, m=0.2)

    def speaker_logits(self, bn: torch.Tensor, target: Optional[torch.Tensor] = None):
        """bn [B, D, T] -> (loss, logits) of the x-vector branch."""
        emb = self.asi_emb(self.asi_pool(self.asi_trunk(bn)))
        emb = emb / torch.clamp(torch.linalg.vector_norm(emb, dim=-1, keepdim=True), min=1e-12)
        return self.asi_margin(emb, target=target)

    def forward(self, wav: torch.Tensor, lengths: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                spk_target: Optional[torch.Tensor] = None):
        if not self.training:
            return self.acoustic(wav, lengths, generator)
        chain_out, xent_out, aux, bn = self.acoustic(wav, lengths, generator, return_bn=True)
        if spk_target is not None:
            h = rev_grad(bn, self.rev_alpha) if self.adversarial else bn
            loss, logits = self.speaker_logits(h, spk_target)
            # under data parallelism each rank's (equal) block gives its
            # share of the global batch's mean
            share = 1.0 / mesh.world()
            aux["spkadv_loss"] = self.adv_weight * loss * share
            aux["spkadv_accuracy"] = ((logits.argmax(-1) == spk_target).float().mean().detach()
                                      * share)
        return chain_out, xent_out, aux

    def extract_bn(self, wav: torch.Tensor, lengths: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.acoustic.extract_bn(wav, lengths, generator)
