"""The B5 extractor for the benchmark's plain reference: the wav2vec 2.0
front (Baevski et al., NeurIPS 2020, arXiv:2006.11477) as published, before
the reference's TDNN-F stage 1 (``asrbn.TDNNFNet`` at the front's width), and
the chain trainer with the recipe's update factor on the front.

Written from the published architecture, not copied from the port:

- feature extractor: 7 temporal convs (kernels 10,3,3,3,3,2,2, strides
  5,2,2,2,2,2,2; 512 channels, with a bias), each followed by a layer norm
  over the channels and the exact (erf) GELU;
- feature projection: a layer norm, then a linear layer to the hidden size;
- positional embedding: one grouped conv over time (k = 128, 16 groups,
  padded k // 2 on both sides, its last step dropped for an even k), GELU,
  added to its input;
- 24 pre-norm transformer layers (the "large" layout): x + attention(LN(x)),
  then x + FFN(LN(x)), with attention softmax(q k^T / sqrt(d_h)) v written
  out over 16 heads of 64, an FFN of 4096 with the erf GELU; a final layer
  norm.

Every layer norm takes the biased variance. Departures from the published
model, each the port's too:

- the positional conv is a plain conv whose weight is the weight norm's
  product, folded (the port's state_dict holds it so);
- no masking, no quantizer and no dropout (the fine-tuning forward of the
  B5 recipe);
- the extractor's last frame is repeated once before the TDNN-F, so the
  front's 20 ms frames line up with the chain's frames (SA-toolkit's net).

The front runs in float32 (TF32 off, ``precision.lower``). With
``front_dtype`` bfloat16 its convs and linears take bfloat16 operands and
give bfloat16 results, its layer norms and softmax computing in float32:
the bf16 training policy, a precision below the configuration's, which is
a control and a planted fault. Each transformer layer runs under
``torch.utils.checkpoint``, which recomputes the same arithmetic in the
backward, so that three steps at B=16 and 19.86 s fit beside the program's
state: the scores and probabilities are [B, heads, T', T'] a layer.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from . import ngsgd
from .asrbn import TDNNFNet, TDNNFNetConfig
from .tdnnf import get_padding, pad_input_replicate
from .trainer import ChainTrainer, ChainTrainOpts

# the published front (wav2vec 2.0 large); the configuration's own values are used
CONV_KERNEL = (10, 3, 3, 3, 3, 2, 2)
CONV_STRIDE = (5, 2, 2, 2, 2, 2, 2)


def num_frames(num_samples: int, kernels=CONV_KERNEL, strides=CONV_STRIDE) -> int:
    """Frames the conv extractor gives for ``num_samples`` samples: each conv
    takes no padding, so a conv of kernel k and stride s gives (n - k) // s + 1."""
    n = num_samples
    for k, s in zip(kernels, strides):
        n = (n - k) // s + 1
    return max(n, 0)


def chain_frames(num_samples: int, net: Dict, w2v2: Dict) -> int:
    """The network's chain output frames: the front's frames and the repeated
    last one, replicate-padded by stage 1's context, then each TDNN-F
    layer's windows (``(T D - k D) // int(s D) + 1`` over the flattened
    frames of width D, which staggers the 1.5 factor), stage 2 padded by its
    own context."""
    t = num_frames(num_samples, w2v2["conv_kernel"], w2v2["conv_stride"]) + 1
    dim = w2v2["hidden_size"]
    for ks, ss in ((net["kernel_size_list"], net["subsampling_factor_list"]),
                   (net["kernel_size_list_after"], net["subsampling_factor_list_after"])):
        t += 2 * (get_padding(ks, ss) // 2)
        for k, s in zip(ks, ss):
            t = (t * dim - k * dim) // int(s * dim) + 1
            dim = net["hidden_dim"]
    return max(t, 0)


def linear(mod: nn.Linear, x: torch.Tensor, dtype) -> torch.Tensor:
    if dtype is None:
        return F.linear(x, mod.weight, mod.bias)
    return F.linear(x.to(dtype), mod.weight.to(dtype), mod.bias.to(dtype))


def conv(mod: nn.Conv1d, x: torch.Tensor, dtype) -> torch.Tensor:
    """The conv in float32, or on ``dtype``'s operands with its sums in
    float32 and the result in ``dtype`` (as a bf16 conv accumulates; PyTorch's
    CPU bf16 grouped conv1d is wrong at small widths)."""
    w, b = mod.weight, mod.bias
    if dtype is None:
        return F.conv1d(x, w, b, mod.stride, mod.padding, groups=mod.groups)
    x, w, b = (t.to(dtype).float() for t in (x, w, b))
    return F.conv1d(x, w, b, mod.stride, mod.padding, groups=mod.groups).to(dtype)


class LayerNorm(nn.Module):
    """Over the last dim, biased variance, in float32."""

    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(torch.promote_types(x.dtype, torch.float32))
        mean = x.mean(-1, keepdim=True)
        var = ((x - mean) ** 2).mean(-1, keepdim=True)
        return (x - mean) / torch.sqrt(var + self.eps) * self.weight + self.bias


class ConvLayer(nn.Module):
    def __init__(self, c: Dict, i: int, in_dim: int):
        super().__init__()
        dim = c["conv_dim"][i]
        self.conv = nn.Conv1d(in_dim, dim, c["conv_kernel"][i], stride=c["conv_stride"][i])
        self.layer_norm = LayerNorm(dim, c["layer_norm_eps"])


class FeatureExtractor(nn.Module):
    def __init__(self, c: Dict):
        super().__init__()
        dims = [1] + list(c["conv_dim"])
        self.conv_layers = nn.ModuleList(ConvLayer(c, i, dims[i])
                                         for i in range(len(c["conv_dim"])))


class FeatureProjection(nn.Module):
    def __init__(self, c: Dict):
        super().__init__()
        self.layer_norm = LayerNorm(c["conv_dim"][-1], c["layer_norm_eps"])
        self.projection = nn.Linear(c["conv_dim"][-1], c["hidden_size"])


class PositionalConv(nn.Module):
    def __init__(self, c: Dict):
        super().__init__()
        k, d = c["num_conv_pos_embeddings"], c["hidden_size"]
        self.conv = nn.Conv1d(d, d, k, padding=k // 2, groups=c["num_conv_pos_embedding_groups"])


class Attention(nn.Module):
    def __init__(self, c: Dict):
        super().__init__()
        d = c["hidden_size"]
        self.heads = c["num_attention_heads"]
        self.q_proj, self.k_proj = nn.Linear(d, d), nn.Linear(d, d)
        self.v_proj, self.out_proj = nn.Linear(d, d), nn.Linear(d, d)

    def forward(self, x: torch.Tensor, dtype) -> torch.Tensor:
        B, T, d = x.shape
        H = self.heads
        dh = d // H

        def heads(t):
            return t.reshape(B, T, H, dh).transpose(1, 2)

        q = heads(linear(self.q_proj, x, dtype)) / math.sqrt(dh)
        scores = q @ heads(linear(self.k_proj, x, dtype)).transpose(-1, -2)
        probs = torch.softmax(scores.float(), dim=-1).to(scores.dtype)
        out = (probs @ heads(linear(self.v_proj, x, dtype))).transpose(1, 2).reshape(B, T, d)
        return linear(self.out_proj, out, dtype)


class FeedForward(nn.Module):
    def __init__(self, c: Dict):
        super().__init__()
        self.intermediate_dense = nn.Linear(c["hidden_size"], c["intermediate_size"])
        self.output_dense = nn.Linear(c["intermediate_size"], c["hidden_size"])


class TransformerLayer(nn.Module):
    def __init__(self, c: Dict):
        super().__init__()
        d, eps = c["hidden_size"], c["layer_norm_eps"]
        self.attention = Attention(c)
        self.layer_norm = LayerNorm(d, eps)
        self.feed_forward = FeedForward(c)
        self.final_layer_norm = LayerNorm(d, eps)

    def forward(self, x: torch.Tensor, dtype) -> torch.Tensor:
        x = x + self.attention(self.layer_norm(x), dtype)
        ff = self.feed_forward
        h = F.gelu(linear(ff.intermediate_dense, self.final_layer_norm(x), dtype))
        return x + linear(ff.output_dense, h, dtype)


class Encoder(nn.Module):
    def __init__(self, c: Dict):
        super().__init__()
        self.pos_conv_embed = PositionalConv(c)
        self.layer_norm = LayerNorm(c["hidden_size"], c["layer_norm_eps"])
        self.layers = nn.ModuleList(TransformerLayer(c) for _ in range(c["num_hidden_layers"]))


class Wav2Vec2Front(nn.Module):
    """Waveform [B, T] -> the last layer's features [B, T', hidden]."""

    def __init__(self, c: Dict):
        super().__init__()
        if c["feat_extract_norm"] != "layer" or not c["do_stable_layer_norm"] \
                or not c["conv_bias"]:
            raise ValueError("the reference holds wav2vec2's large layout only")
        self.feature_extractor = FeatureExtractor(c)
        self.feature_projection = FeatureProjection(c)
        self.encoder = Encoder(c)

    def forward(self, wav: torch.Tensor, dtype=None) -> torch.Tensor:
        h = wav[:, None, :]
        for layer in self.feature_extractor.conv_layers:
            h = conv(layer.conv, h, dtype)
            h = F.gelu(layer.layer_norm(h.transpose(1, 2)).transpose(1, 2))
        proj = self.feature_projection
        h = linear(proj.projection, proj.layer_norm(h.transpose(1, 2)), dtype)
        pos = conv(self.encoder.pos_conv_embed.conv, h.transpose(1, 2), dtype)
        if self.encoder.pos_conv_embed.conv.kernel_size[0] % 2 == 0:
            pos = pos[..., :-1]
        h = h + F.gelu(pos).transpose(1, 2)
        for layer in self.encoder.layers:
            if torch.is_grad_enabled():
                h = checkpoint(layer, h, dtype, use_reentrant=False)
            else:
                h = layer(h, dtype)
        return self.encoder.layer_norm(h)


class Wav2Vec2TDNNFNet(TDNNFNet):
    """The wav2vec2 front, its last frame repeated once, replicate-padded by
    stage 1's context, then the reference's TDNN-F stages and heads at the
    front's width. No dropout; the forward takes no lengths. The front
    computes in ``front_dtype`` (None: float32)."""

    def __init__(self, cfg: TDNNFNetConfig, w2v2: Dict):
        super().__init__(cfg, input_dim=w2v2["hidden_size"])
        self.preprocessor = Wav2Vec2Front(w2v2)
        self.front_dtype: Optional[torch.dtype] = None

    def features(self, wav: torch.Tensor, lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        if lengths is not None:
            raise ValueError("the wav2vec2 front takes no lengths")
        x = self.preprocessor(wav, self.front_dtype)
        x = torch.cat([x, x[:, -1:]], dim=1)
        return pad_input_replicate(x.transpose(1, 2), self.padding).transpose(1, 2)

    def _dropout(self, x: torch.Tensor, generator) -> torch.Tensor:
        return x


class FrontChainTrainer(ChainTrainer):
    """The reference's chain trainer with the front's parameters (those under
    ``preprocessor``) in an AdamW group of their own, whose learning rate is
    the step's times ``front_factor(step)``. An AdamW update, its decoupled
    weight decay included, is proportional to the learning rate, so this is
    the recipe's scaling of the front's update."""

    def __init__(self, model: nn.Module, den, opts: ChainTrainOpts,
                 lr_schedule: Callable[[int], float], seed: int,
                 ng_states: Dict[str, Dict[str, ngsgd.State]],
                 front_factor: Callable[[int], float]):
        super().__init__(model, den, opts, lr_schedule, seed, ng_states)
        named = list(model.named_parameters())
        front = [p for n, p in named if n.split(".")[0] == "preprocessor"]
        rest = [p for n, p in named if n.split(".")[0] != "preprocessor"]
        self.front_factor = front_factor
        self.optimizer = torch.optim.AdamW(
            [{"params": rest}, {"params": front}], lr=opts.lr, betas=(0.9, 0.999), eps=1e-8,
            weight_decay=opts.weight_decay)

    @torch.no_grad()
    def apply_grads(self, lr: float) -> None:
        for p in self.params:
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            p.grad = g.clamp(-self.opts.grad_clip_value, self.opts.grad_clip_value)
        rest, front = self.optimizer.param_groups
        rest["lr"], front["lr"] = lr, lr * self.front_factor(self.step_count)
        self.optimizer.step()
