"""wav2vec 2.0 encoder (port of ``satpu.models.wav2vec2``).

The front end of the strongest ASR-BN extractors (``Wav2Vec2TDNNFNet``, the
VoicePrivacy B5 model): the computation graph of HuggingFace's
``Wav2Vec2Model`` without masking or quantizer:

- conv feature extractor: 7 temporal convs (512 channels; kernels
  10,3,3,3,3,2,2; strides 5,2,2,2,2,2,2), then exact-erf GELU, with a layer
  norm over the channels after every conv (``feat_extract_norm="layer"``,
  the large models) or a per-channel group norm over time after conv 0
  only (``"group"``, the base models, whose convs have no bias);
- feature projection: layer norm, then Linear(512 -> hidden);
- encoder: a grouped conv positional embedding (k = 128, 16 groups, padded
  k // 2 on both sides and its last step dropped; a plain conv, not weight
  normed as in HuggingFace: the importers fold the norm), then the
  transformer stack, post-norm ("base") or pre-norm with a final layer norm
  ("large", ``do_stable_layer_norm``).

Layer norms use the biased variance and compute in f32. Activations are
[B, T, C]; convs run in NCW. Under ``models.torchlayers.autocast(bf16)``
every conv and linear runs in bf16.

Attention is one fused call, ``F.scaled_dot_product_attention``, on the
queries already scaled by 1 / sqrt(head size) (as satpu and HuggingFace
scale them) with a scale of 1: softmax(q k^T) v, the softmax in f32 inside
the kernel whatever the operands' dtype. On the card that is the
memory-efficient kernel in f32 and flash attention under the bf16 policy:
neither keeps the [B, heads, T', T'] scores or probabilities for the
backward (one log-sum-exp a row and head), which at wav2vec2-large's 24
layers, B=16 and 19.86 s egs would take 1.01 GB a layer.

``Wav2Vec2Model``'s forward runs in the span ``wav2vec2.front``; inside it,
``wav2vec2.conv`` (the feature extractor and the projection), ``wav2vec2.pos_conv``
and, in each transformer layer, ``wav2vec2.attention`` and ``wav2vec2.ffn`` (each
block with its layer norm and residual; ``utils.trace``).

Parameter names are HuggingFace's (without its ``wav2vec2.`` prefix), so
``convert_wav2vec2`` imports an HF state_dict by folding the positional
conv's weight norm, and ``convert_fairseq_wav2vec2`` /
``import_fairseq_checkpoint`` a raw fairseq or voxpopuli one by renaming
first. No checkpoint is in the repository.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..utils.trace import span
from .torchlayers import Conv1d, LayerNorm, Linear


@dataclasses.dataclass(frozen=True)
class Wav2Vec2Config:
    conv_dim: Tuple[int, ...] = (512, 512, 512, 512, 512, 512, 512)
    conv_kernel: Tuple[int, ...] = (10, 3, 3, 3, 3, 2, 2)
    conv_stride: Tuple[int, ...] = (5, 2, 2, 2, 2, 2, 2)
    hidden_size: int = 1024
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    intermediate_size: int = 4096
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16
    do_stable_layer_norm: bool = True  # "large"-style pre-norm
    layer_norm_eps: float = 1e-5
    # "layer": a layer norm (and conv bias) after every extractor conv
    # (wav2vec2-large / voxpopuli, the B5 front); "group": a group norm after
    # conv 0 only (base models)
    feat_extract_norm: str = "layer"
    conv_bias: bool = True

    @classmethod
    def large(cls) -> "Wav2Vec2Config":
        return cls()

    @classmethod
    def base(cls) -> "Wav2Vec2Config":
        return cls(hidden_size=768, num_hidden_layers=12, num_attention_heads=12,
                   intermediate_size=3072, do_stable_layer_norm=False,
                   feat_extract_norm="group", conv_bias=False)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Wav2Vec2Config":
        """From ``dataclasses.asdict`` output (lists back to tuples)."""
        return cls(**{k: tuple(v) if isinstance(v, list) else v for k, v in d.items()})


def num_frames(num_samples: int, cfg: Optional[Wav2Vec2Config] = None) -> int:
    """Frames the feature extractor gives for ``num_samples`` samples."""
    c = cfg or Wav2Vec2Config()
    n = num_samples
    for k, s in zip(c.conv_kernel, c.conv_stride):
        n = (n - k) // s + 1
    return max(n, 0)


class GroupNormPerChannel(nn.Module):
    """Group norm with one group per channel (instance norm over time) of
    [B, C, T], affine, computed in f32."""

    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.weight.fill_(1.0)
        self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(torch.promote_types(x.dtype, torch.float32))
        mean = x.mean(dim=-1, keepdim=True)
        var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
        return ((x - mean) / torch.sqrt(var + self.eps) * self.weight[:, None]
                + self.bias[:, None])


class ConvLayer(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config, i: int, in_dim: int):
        super().__init__()
        dim = cfg.conv_dim[i]
        self.conv = Conv1d(in_dim, dim, cfg.conv_kernel[i], stride=cfg.conv_stride[i],
                           bias=cfg.conv_bias)
        self.layer_mode = cfg.feat_extract_norm == "layer"
        if self.layer_mode:
            self.layer_norm = LayerNorm(dim, cfg.layer_norm_eps)
        elif i == 0:
            self.layer_norm = GroupNormPerChannel(dim, cfg.layer_norm_eps)
        else:
            self.layer_norm = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[B, C_in, T] -> [B, C_out, T']."""
        h = self.conv(x)
        if self.layer_mode:
            h = self.layer_norm(h.transpose(1, 2)).transpose(1, 2)
        elif self.layer_norm is not None:
            h = self.layer_norm(h)
        return F.gelu(h)


class FeatureExtractor(nn.Module):
    """The conv waveform encoder: [B, T] -> [B, T', conv_dim[-1]]."""

    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        dims = (1,) + tuple(cfg.conv_dim)
        self.conv_layers = nn.ModuleList(ConvLayer(cfg, i, dims[i])
                                         for i in range(len(cfg.conv_dim)))

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        h = wav[:, None, :]
        for layer in self.conv_layers:
            h = layer(h)
        return h.transpose(1, 2)


class SelfAttention(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        d = cfg.hidden_size
        self.num_heads = cfg.num_attention_heads
        self.q_proj, self.k_proj = Linear(d, d), Linear(d, d)
        self.v_proj, self.out_proj = Linear(d, d), Linear(d, d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, T, d = x.shape
        H = self.num_heads
        hd = d // H

        def split(t):
            return t.reshape(B, T, H, hd).transpose(1, 2)

        q = self.q_proj(x) * (hd ** -0.5)
        out = F.scaled_dot_product_attention(split(q), split(self.k_proj(x)),
                                             split(self.v_proj(x)), scale=1.0)
        return self.out_proj(out.transpose(1, 2).reshape(B, T, d))


class FeedForward(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        self.intermediate_dense = Linear(cfg.hidden_size, cfg.intermediate_size)
        self.output_dense = Linear(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.output_dense(F.gelu(self.intermediate_dense(x)))


class EncoderLayer(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        d, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.pre_norm = cfg.do_stable_layer_norm
        self.attention = SelfAttention(cfg)
        self.layer_norm = LayerNorm(d, eps)
        self.feed_forward = FeedForward(cfg)
        self.final_layer_norm = LayerNorm(d, eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.pre_norm:
            with span("wav2vec2.attention"):
                x = x + self.attention(self.layer_norm(x))
            with span("wav2vec2.ffn"):
                return x + self.feed_forward(self.final_layer_norm(x))
        with span("wav2vec2.attention"):
            x = self.layer_norm(x + self.attention(x))
        with span("wav2vec2.ffn"):
            return self.final_layer_norm(x + self.feed_forward(x))


class PositionalConvEmbedding(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        k = cfg.num_conv_pos_embeddings
        self.conv = Conv1d(cfg.hidden_size, cfg.hidden_size, k, padding=k // 2,
                           groups=cfg.num_conv_pos_embedding_groups)
        self.drop_last = k % 2 == 0

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        """[B, T, C] -> GELU(pos conv) [B, T, C]."""
        pos = self.conv(h.transpose(1, 2))
        if self.drop_last:
            pos = pos[..., :-1]
        return F.gelu(pos).transpose(1, 2)


class Encoder(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        self.pos_conv_embed = PositionalConvEmbedding(cfg)
        self.layer_norm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)
        self.layers = nn.ModuleList(EncoderLayer(cfg) for _ in range(cfg.num_hidden_layers))
        self.stable = cfg.do_stable_layer_norm

    def forward(self, h: torch.Tensor, num_layers: Optional[int] = None) -> torch.Tensor:
        with span("wav2vec2.pos_conv"):
            h = h + self.pos_conv_embed(h)
        if not self.stable:
            h = self.layer_norm(h)
        n = len(self.layers) if num_layers is None else num_layers
        for layer in self.layers[:n]:
            h = layer(h)
        if self.stable:
            h = self.layer_norm(h)
        return h


class FeatureProjection(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        self.layer_norm = LayerNorm(cfg.conv_dim[-1], cfg.layer_norm_eps)
        self.projection = Linear(cfg.conv_dim[-1], cfg.hidden_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.projection(self.layer_norm(x))


class Wav2Vec2Model(nn.Module):
    """Waveform [B, T] -> features [B, T', hidden] (inference and
    fine-tuning path: no masking, no quantizer)."""

    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        self.cfg = cfg
        self.feature_extractor = FeatureExtractor(cfg)
        self.feature_projection = FeatureProjection(cfg)
        self.encoder = Encoder(cfg)

    def forward(self, wav: torch.Tensor, num_layers: Optional[int] = None) -> torch.Tensor:
        with span("wav2vec2.front"):
            with span("wav2vec2.conv"):
                h = self.feature_projection(self.feature_extractor(wav))
            return self.encoder(h, num_layers)


# ---------------------------------------------------------------------------
# Importers: HuggingFace / fairseq state_dicts -> this module's state_dict
# ---------------------------------------------------------------------------


def _tensor(v) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().to(torch.float32).clone()
    return torch.from_numpy(np.array(v, dtype=np.float32))


def convert_wav2vec2(hf_state_dict: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """HuggingFace ``Wav2Vec2Model`` state_dict (with or without the
    ``wav2vec2.`` prefix of a CTC model) -> ``Wav2Vec2Model``'s state_dict.

    The weight-normed positional conv (``weight_g`` / ``weight_v``, or the
    parametrization's ``original0`` / ``original1``; norm over dims 0 and 1
    of the [out, in/groups, k] weight) is folded into a plain weight; keys
    of other heads (``lm_head``, ``masked_spec_embed``, quantizer) are
    dropped."""
    prefix = "wav2vec2." if any(k.startswith("wav2vec2.") for k in hf_state_dict) else ""
    sd = {k[len(prefix):]: v for k, v in hf_state_dict.items() if k.startswith(prefix)}
    keep = ("feature_extractor.", "feature_projection.", "encoder.")
    out = {k: _tensor(v) for k, v in sd.items()
           if k.startswith(keep) and ".pos_conv_embed.conv." not in k}
    base = "encoder.pos_conv_embed.conv."
    if base + "weight_g" in sd or base + "parametrizations.weight.original0" in sd:
        if base + "weight_g" in sd:
            g, v = _tensor(sd[base + "weight_g"]), _tensor(sd[base + "weight_v"])
        else:
            g = _tensor(sd[base + "parametrizations.weight.original0"])
            v = _tensor(sd[base + "parametrizations.weight.original1"])
        g, v = g.numpy(), v.numpy()  # numpy's f32 sums, as satpu folds it
        w = torch.from_numpy(g * v / np.sqrt((v ** 2).sum(axis=(0, 1), keepdims=True)))
    else:
        w = _tensor(sd[base + "weight"])
    out[base + "weight"] = w
    out[base + "bias"] = _tensor(sd[base + "bias"])
    return out


def fairseq_to_hf_names(fairseq_sd: Dict[str, Any]) -> Dict[str, Any]:
    """Rename a raw fairseq / voxpopuli wav2vec2 state_dict to the
    HuggingFace names ``convert_wav2vec2`` reads (satpu's key map, after the
    reference's utils/import_fairseq_model.py)."""
    out: Dict[str, Any] = {}
    for k, v in fairseq_sd.items():
        if k.startswith("w2v_encoder."):
            k = k[len("w2v_encoder."):]
        if k.startswith("w2v_model."):
            k = k[len("w2v_model."):]
        nk = None
        if k.startswith("feature_extractor.conv_layers."):
            parts = k.split(".")
            i, sub = parts[2], ".".join(parts[3:])
            if sub == "0.weight":
                nk = f"feature_extractor.conv_layers.{i}.conv.weight"
            elif sub == "0.bias":
                nk = f"feature_extractor.conv_layers.{i}.conv.bias"
            elif sub.startswith("2."):
                # the group norm (conv 0, group mode) or the layer norm
                # (every conv, layer mode)
                nk = f"feature_extractor.conv_layers.{i}.layer_norm.{sub.split('.')[-1]}"
        elif k.startswith("layer_norm."):  # before the projection
            nk = "feature_projection.layer_norm." + k.split(".", 1)[1]
        elif k.startswith("post_extract_proj."):
            nk = "feature_projection.projection." + k.split(".", 1)[1]
        elif k.startswith("encoder.pos_conv.0."):
            nk = "encoder.pos_conv_embed.conv." + k[len("encoder.pos_conv.0."):]
        elif k.startswith("encoder.layers."):
            parts = k.split(".")
            i, sub = parts[2], ".".join(parts[3:])
            sub = (sub.replace("self_attn_layer_norm", "layer_norm")
                      .replace("self_attn.", "attention.")
                      .replace("fc1.", "feed_forward.intermediate_dense.")
                      .replace("fc2.", "feed_forward.output_dense."))
            nk = f"encoder.layers.{i}.{sub}"
        elif k.startswith("encoder.layer_norm."):
            nk = k
        if nk is not None:
            out[nk] = v
    return out


def convert_fairseq_wav2vec2(fairseq_sd: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Raw fairseq / voxpopuli wav2vec2 state_dict -> ``Wav2Vec2Model``'s."""
    return convert_wav2vec2(fairseq_to_hf_names(fairseq_sd))


def import_fairseq_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """Load a fairseq ``.pt`` (voxpopuli releases, or s3prl-converted with a
    ``model_weight`` entry) and convert it."""
    data = torch.load(path, map_location="cpu", weights_only=True)
    if "model_weight" in data:
        sd = data["model_weight"]
    elif "model" in data:
        sd = data["model"]
    else:
        sd = data
    return convert_fairseq_wav2vec2(sd)
