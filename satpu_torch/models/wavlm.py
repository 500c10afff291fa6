"""WavLM encoder and the sidekit WavLM front end (port of ``satpu.models.wavlm``).

The reference's self-supervised ASV front end (sidekit/preprocessor.py:
79-163) wraps a WavLM-large, takes all of its hidden states, sums them
with softmax weights and instance-norms the sum.

WavLM is wav2vec 2.0 with a gated relative position bias in
self-attention (Chen et al., 2022). The graph is HuggingFace's
``WavLMModel``: a T5-style bucketed relative position embedding, held by
layer 0 and shared by every layer, that each layer gates with a GRU-style
gate computed from its attention input. The feature extractor, the
feature projection and the positional conv are ``models.wav2vec2``'s.

Parameter names are HuggingFace's (``encoder.layers.{i}.attention.
gru_rel_pos_linear``, ``gru_rel_pos_const``, and on layer 0 only
``rel_attn_embed.weight``), so ``convert_wavlm`` imports an HF state_dict
and ``models.convert.from_satpu_xvector`` maps satpu's params onto the
same names. Under ``models.torchlayers.autocast(bf16)`` the convs and
linears run in bf16, the layer norms in f32, and the attention logits
(bf16) plus the f32 gated bias promote the softmax to f32, as in satpu.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .torchlayers import LayerNorm, Linear
from .wav2vec2 import (FeatureExtractor, FeatureProjection, PositionalConvEmbedding,
                       Wav2Vec2Config, convert_wav2vec2)


@dataclasses.dataclass(frozen=True)
class WavLMConfig:
    """Same fields and defaults as satpu's (HuggingFace's ``WavLMConfig``
    defaults: a group-norm extractor without conv biases)."""

    conv_dim: Tuple[int, ...] = (512, 512, 512, 512, 512, 512, 512)
    conv_kernel: Tuple[int, ...] = (10, 3, 3, 3, 3, 2, 2)
    conv_stride: Tuple[int, ...] = (5, 2, 2, 2, 2, 2, 2)
    hidden_size: int = 1024
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    intermediate_size: int = 4096
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16
    num_buckets: int = 320
    max_bucket_distance: int = 800
    do_stable_layer_norm: bool = True  # wavlm-large
    layer_norm_eps: float = 1e-5
    feat_extract_norm: str = "group"
    conv_bias: bool = False

    @classmethod
    def large(cls) -> "WavLMConfig":
        """WavLM-large: a layer norm and a conv bias after every extractor
        conv."""
        return cls(feat_extract_norm="layer", conv_bias=True)

    @classmethod
    def base(cls) -> "WavLMConfig":
        return cls(hidden_size=768, num_hidden_layers=12, num_attention_heads=12,
                   intermediate_size=3072, do_stable_layer_norm=False)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "WavLMConfig":
        """From ``dataclasses.asdict`` output (lists back to tuples)."""
        return cls(**{k: tuple(v) if isinstance(v, list) else v for k, v in d.items()})

    def w2v2(self) -> Wav2Vec2Config:
        """The wav2vec2 config of the shared conv and projection modules."""
        return Wav2Vec2Config(
            conv_dim=self.conv_dim, conv_kernel=self.conv_kernel, conv_stride=self.conv_stride,
            hidden_size=self.hidden_size, num_hidden_layers=self.num_hidden_layers,
            num_attention_heads=self.num_attention_heads,
            intermediate_size=self.intermediate_size,
            num_conv_pos_embeddings=self.num_conv_pos_embeddings,
            num_conv_pos_embedding_groups=self.num_conv_pos_embedding_groups,
            do_stable_layer_norm=self.do_stable_layer_norm, layer_norm_eps=self.layer_norm_eps,
            feat_extract_norm=self.feat_extract_norm, conv_bias=self.conv_bias)


def relative_positions_bucket(relative_positions: np.ndarray, num_buckets: int,
                              max_distance: int) -> np.ndarray:
    """T5-style log bucketing (HF ``WavLMAttention._relative_positions_bucket``),
    in float64 numpy and truncated to int64 as satpu computes it: an f32
    log moves entries across bucket edges."""
    num_buckets = num_buckets // 2
    buckets = (relative_positions > 0).astype(np.int64) * num_buckets
    rel = np.abs(relative_positions)
    max_exact = num_buckets // 2
    is_small = rel < max_exact
    large = np.log(np.maximum(rel, 1).astype(np.float64) / max_exact)
    large = large / math.log(max_distance / max_exact)
    large = (max_exact + large * (num_buckets - max_exact)).astype(np.int64)
    large = np.minimum(large, num_buckets - 1)
    return buckets + np.where(is_small, rel, large)


class RelativeEmbedding(nn.Module):
    """The [num_buckets, heads] bucket embedding (HF's ``nn.Embedding``
    ``rel_attn_embed``), initialized N(0, 0.02) as satpu does."""

    def __init__(self, num_buckets: int, heads: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(num_buckets, heads))

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.weight.copy_(torch.randn(self.weight.shape, generator=generator) * 0.02)


class WavLMAttention(nn.Module):
    """Multi-head attention with the gated relative position bias."""

    def __init__(self, cfg: WavLMConfig, has_relative_position_bias: bool = False):
        super().__init__()
        d, H = cfg.hidden_size, cfg.num_attention_heads
        self.cfg, self.num_heads = cfg, H
        self.q_proj, self.k_proj = Linear(d, d), Linear(d, d)
        self.v_proj, self.out_proj = Linear(d, d), Linear(d, d)
        self.gru_rel_pos_linear = Linear(d // H, 8)
        self.gru_rel_pos_const = nn.Parameter(torch.ones(1, H, 1, 1))
        self.rel_attn_embed = (RelativeEmbedding(cfg.num_buckets, H)
                               if has_relative_position_bias else None)
        self._buckets: Dict[Tuple[int, torch.device], torch.Tensor] = {}

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.gru_rel_pos_const.fill_(1.0)

    def buckets(self, T: int, device: torch.device) -> torch.Tensor:
        """The [T, T] bucket indices (key position minus query position),
        computed once per sequence length and kept on ``device``."""
        key = (T, device)
        if key not in self._buckets:
            pos = np.arange(T)
            # a plain tensor even when first asked for under inference_mode,
            # so that a later training step can index with it
            with torch.inference_mode(False):
                self._buckets[key] = torch.from_numpy(relative_positions_bucket(
                    pos[None, :] - pos[:, None], self.cfg.num_buckets,
                    self.cfg.max_bucket_distance)).to(device)
        return self._buckets[key]

    def forward(self, x: torch.Tensor, position_bias: Optional[torch.Tensor] = None):
        """[B, T, d] -> ([B, T, d], the ungated [H, T, T] bias)."""
        B, T, d = x.shape
        H = self.num_heads
        hd = d // H
        if position_bias is None:
            position_bias = self.rel_attn_embed.weight[self.buckets(T, x.device)].permute(2, 0, 1)

        # the gate from the attention input (modeling_wavlm.py)
        proj = self.gru_rel_pos_linear(x.reshape(B, T, H, hd).transpose(1, 2))
        proj = proj.reshape(B, H, T, 2, 4).sum(-1)
        gate_a, gate_b = torch.sigmoid(proj[..., 0]), torch.sigmoid(proj[..., 1])
        const = self.gru_rel_pos_const[:, :, 0, 0][..., None]  # [1, H, 1]
        gate = gate_a * (gate_b * const - 1.0) + 2.0  # [B, H, T]
        gated_bias = gate[..., None] * position_bias[None]  # [B, H, T, T]

        def split(t):
            return t.reshape(B, T, H, hd).transpose(1, 2)

        q = self.q_proj(x) * (hd ** -0.5)
        # bf16 logits + the f32 bias: the softmax runs in f32, as in satpu
        attn = torch.softmax(split(q) @ split(self.k_proj(x)).transpose(-1, -2) + gated_bias,
                             dim=-1)
        v = split(self.v_proj(x))
        out = attn @ v.to(torch.promote_types(v.dtype, attn.dtype))
        return self.out_proj(out.transpose(1, 2).reshape(B, T, d)), position_bias


class WavLMFeedForward(nn.Module):
    def __init__(self, cfg: WavLMConfig):
        super().__init__()
        self.intermediate_dense = Linear(cfg.hidden_size, cfg.intermediate_size)
        self.output_dense = Linear(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.output_dense(F.gelu(self.intermediate_dense(x)))


class WavLMEncoderLayer(nn.Module):
    def __init__(self, cfg: WavLMConfig, has_relative_position_bias: bool = False):
        super().__init__()
        d, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.pre_norm = cfg.do_stable_layer_norm
        self.attention = WavLMAttention(cfg, has_relative_position_bias)
        self.layer_norm = LayerNorm(d, eps)
        self.feed_forward = WavLMFeedForward(cfg)
        self.final_layer_norm = LayerNorm(d, eps)

    def forward(self, x: torch.Tensor, position_bias: Optional[torch.Tensor]):
        if self.pre_norm:  # large
            a, position_bias = self.attention(self.layer_norm(x), position_bias)
            x = x + a
            return x + self.feed_forward(self.final_layer_norm(x)), position_bias
        a, position_bias = self.attention(x, position_bias)  # base: post-norm
        x = self.layer_norm(x + a)
        return self.final_layer_norm(x + self.feed_forward(x)), position_bias


class WavLMEncoder(nn.Module):
    def __init__(self, cfg: WavLMConfig):
        super().__init__()
        self.pos_conv_embed = PositionalConvEmbedding(cfg.w2v2())
        self.layer_norm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)
        self.layers = nn.ModuleList(WavLMEncoderLayer(cfg, has_relative_position_bias=(i == 0))
                                    for i in range(cfg.num_hidden_layers))
        self.stable = cfg.do_stable_layer_norm

    def forward(self, h: torch.Tensor) -> List[torch.Tensor]:
        """The hidden states: after the positional conv (and, post-norm, the
        encoder's layer norm), then after each layer; pre-norm, the last
        one through the final layer norm."""
        h = h + self.pos_conv_embed(h)
        if not self.stable:
            h = self.layer_norm(h)
        states = [h]
        position_bias = None
        for layer in self.layers:
            h, position_bias = layer(h, position_bias)
            states.append(h)
        if self.stable:
            states[-1] = self.layer_norm(h)
        return states


class WavLMModel(nn.Module):
    """Waveform [B, T] -> hidden states [B, T', hidden] (the last one, or
    all ``num_hidden_layers + 1`` with ``return_all``)."""

    def __init__(self, cfg: WavLMConfig):
        super().__init__()
        self.cfg = cfg
        w2 = cfg.w2v2()
        self.feature_extractor = FeatureExtractor(w2)
        self.feature_projection = FeatureProjection(w2)
        self.encoder = WavLMEncoder(cfg)

    def forward(self, wav: torch.Tensor, return_all: bool = False):
        states = self.encoder(self.feature_projection(self.feature_extractor(wav)))
        return states if return_all else states[-1]


class WavLmFrontEnd(nn.Module):
    """sidekit/preprocessor.py:79-163: the softmax-weighted sum of every
    WavLM hidden state, plus 1e-6, instance-normed over time (biased
    variance, eps 1e-5). [B, T] audio -> [B, hidden, frames], channels
    first for the x-vector trunks. satpu's channel dropout has no field in
    its ``XVectorConfig`` and stays off, as here."""

    def __init__(self, cfg: WavLMConfig):
        super().__init__()
        self.feature_extract = WavLMModel(cfg)
        self.feature_weight = nn.Parameter(torch.zeros(cfg.num_hidden_layers + 1))

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.feature_weight.zero_()

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        states = self.feature_extract(wav, return_all=True)
        weights = torch.softmax(self.feature_weight, dim=0)
        # an f32 weight times a bf16 state is f32, as in JAX (torch would
        # keep a 0-d tensor's product in the state's dtype)
        h = sum(weights[i] * s.to(torch.promote_types(s.dtype, weights.dtype))
                for i, s in enumerate(states)) + 1e-6
        mean = h.mean(dim=1, keepdim=True)
        var = h.var(dim=1, correction=0, keepdim=True)
        return ((h - mean) / torch.sqrt(var + 1e-5)).transpose(1, 2)


def convert_wavlm(hf_state_dict: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """HuggingFace ``WavLMModel`` state_dict (with or without the ``wavlm.``
    prefix of a model with heads) -> ``WavLMModel``'s state_dict: the
    wav2vec2 importer (the positional conv's weight norm folded, other
    heads' keys dropped) keeps the attention's gate and bucket embedding
    under their names."""
    prefix = "wavlm." if any(k.startswith("wavlm.") for k in hf_state_dict) else ""
    return convert_wav2vec2({k[len(prefix):]: v for k, v in hf_state_dict.items()
                             if k.startswith(prefix)})
