"""TDNN-F layers (port of ``satpu.models.tdnnf``).

Layouts: weights keep satpu's torch layout (affine [out, in]); activations
are torch's NCW ([B, C, T]) inside the network. The context splice of a
TDNNF layer with an integer subsampling factor runs as one strided
``F.conv1d`` whose kernel is the [out, c*D] weight seen tap-major; the
fractional 1.5 factor keeps the reference's flattened-feature stagger as an
explicit gather.

``compute_dtype="bfloat16"`` is the serving policy: splice/affine matmuls in
bf16 with f32 parameters, batch norm and VQ in f32, inter-layer activations
stored bf16.

Training (``module.train()``, f32) follows satpu's ``train=True``: batch
norm normalizes with the batch's statistics over (B, T) and updates its
running ones (flax semantics, momentum 0.9), the VQ codebook takes its EMA
update and reports its commitment loss and perplexity, and with natural
gradient on every affine runs on spliced rows through
``chain.ngsgd.NatAffine`` once the trainer has given it an ``ng_slot``.
``constrain_orthonormal`` is the orthonormal constraint on the ``inner_nat``
weights, applied between steps.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

# satpu's fixed training constants: the VQ's commitment weight and EMA
# decay/smoothing, and the batch norm's running-statistics momentum
VQ_COMMITMENT_COST = 0.25
VQ_DECAY = 0.95
VQ_EPSILON = 1e-5
BN_MOMENTUM = 0.9


def get_padding(kernel_sizes: Sequence[int], subsampling_factors: Sequence[float]) -> int:
    """Total context consumed by a TDNNF stack."""
    pad = 0
    global_subsampling = 1.0
    for k, s in zip(kernel_sizes, subsampling_factors):
        pad += (k - 1) * global_subsampling
        global_subsampling *= s
    return int(pad)


def pad_input_replicate(x: torch.Tensor, pad_amount: int) -> torch.Tensor:
    """Replicate the first/last frame pad_amount times; x [B, C, T]."""
    if pad_amount <= 0:
        return x
    return torch.cat([x[..., :1].expand(-1, -1, pad_amount), x,
                      x[..., -1:].expand(-1, -1, pad_amount)], dim=-1)


def mask_replicate_tail(x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """x[b, :, t] = x[b, :, min(t, len_b - 1)] for x [B, C, T]: a zero-padded
    batch then behaves like per-utterance replicate edge padding."""
    T = x.shape[-1]
    t = torch.arange(T, device=x.device)
    idx = torch.minimum(t[None, :], torch.clamp(lengths.to(x.device)[:, None] - 1, min=0))
    return x.gather(-1, idx[:, None, :].expand(-1, x.shape[1], -1))


def splice_frames(x: torch.Tensor, context_len: int, subsampling_factor: float) -> torch.Tensor:
    """The reference's unfold splicing on the flattened [T*D] sequence.

    x [B, D, T] -> [B, D*context_len, nwin]; window j starts at element
    ``j * int(D * subsampling_factor)`` of the time-major flattening, which
    for the factor 1.5 staggers windows across frame boundaries."""
    B, D, T = x.shape
    step = int(D * subsampling_factor)
    win = D * context_len
    nwin = (T * D - win) // step + 1
    flat = x.transpose(1, 2).reshape(B, T * D)
    idx = torch.from_numpy((np.arange(nwin) * step)[:, None] + np.arange(win)[None, :])
    return flat[:, idx.to(x.device)].transpose(1, 2)


class NaturalAffineTransform(nn.Module):
    """Affine layer, weight [out, in], bias [out]; input and output [B, C, T].

    ``splice=(context_len, stride)`` evaluates the layer on the
    context-spliced input without materializing it: the [out, c*D] weight,
    whose columns are tap-major, becomes a width-c conv kernel.

    ``ng_slot`` (a ``chain.ngsgd.NGSlot``, set by the chain trainer and not
    part of the state_dict) routes a training forward through
    ``ngsgd.NatAffine``, whose backward records the layer's NG statistics."""

    def __init__(self, in_dim: int, out_dim: int, use_bias: bool = True,
                 compute_dtype: str = "float32"):
        super().__init__()
        self.in_dim, self.out_dim = in_dim, out_dim
        self.compute_dtype = compute_dtype
        self.weight = nn.Parameter(torch.empty(out_dim, in_dim))
        self.bias = nn.Parameter(torch.empty(out_dim)) if use_bias else None
        self.ng_slot = None
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        scale = 1.0 / math.sqrt(self.in_dim * self.out_dim)
        self.weight.copy_(torch.randn(self.weight.shape, generator=generator) * scale)
        if self.bias is not None:
            self.bias.copy_(torch.randn(self.bias.shape, generator=generator))

    def forward(self, x: torch.Tensor,
                splice: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        if self.ng_slot is not None and self.training and splice is None:
            from ..chain.ngsgd import nat_affine

            B, C, T = x.shape
            x2d = x.transpose(1, 2).reshape(B * T, C).to(self.weight.dtype)
            y = nat_affine(x2d, self.weight, self.bias, self.ng_slot)
            return y.reshape(B, T, self.out_dim).transpose(1, 2)
        w = self.weight
        if self.compute_dtype == "bfloat16":
            x, w = x.to(torch.bfloat16), w.to(torch.bfloat16)
        elif x.dtype != w.dtype:
            w = w.to(x.dtype)
        if splice is not None:
            c, s = splice
            kernel = w.reshape(self.out_dim, c, x.shape[1]).permute(0, 2, 1)
            y = F.conv1d(x, kernel, stride=s)
        else:
            y = torch.einsum("bit,oi->bot", x, w)
        y = y.to(torch.promote_types(y.dtype, torch.float32))  # bf16 out -> f32
        if self.bias is not None:
            y = y + self.bias[:, None]
        return y


class OrthonormalLinear(nn.Module):
    """NaturalAffineTransform under the ``inner_nat`` name (its orthonormal
    constraint is a training-time update)."""

    def __init__(self, in_dim: int, out_dim: int, use_bias: bool = True,
                 compute_dtype: str = "float32"):
        super().__init__()
        self.inner_nat = NaturalAffineTransform(in_dim, out_dim, use_bias, compute_dtype)

    def forward(self, x: torch.Tensor,
                splice: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        return self.inner_nat(x, splice=splice)


class VectorQuantizerEMA(nn.Module):
    """VQ-VAE quantizer with EMA codebook updates: nearest codebook entry per
    frame, straight-through gradients.

    Buffers ``embedding``, ``ema_cluster_size`` and ``ema_w`` hold satpu's
    ``vq_stats``. In training mode the codebook first takes its EMA update
    from this batch's assignments, and the quantized output uses the
    updated codebook. Returns (vq_loss, quantized, perplexity, indices); the
    loss and perplexity only in training mode (None otherwise)."""

    def __init__(self, num_embeddings: int, embedding_dim: int):
        super().__init__()
        self.num_embeddings = num_embeddings
        self.register_buffer("embedding", torch.empty(num_embeddings, embedding_dim))
        self.register_buffer("ema_cluster_size", torch.zeros(num_embeddings))
        self.register_buffer("ema_w", torch.empty(num_embeddings, embedding_dim))
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.embedding.copy_(torch.randn(self.embedding.shape, generator=generator))
        self.ema_cluster_size.zero_()
        self.ema_w.copy_(torch.randn(self.ema_w.shape, generator=generator))

    @torch.no_grad()
    def _ema_update(self, flat: torch.Tensor, indices: torch.Tensor) -> None:
        K = self.num_embeddings
        one_hot = F.one_hot(indices, K).to(flat.dtype)
        cs = self.ema_cluster_size * VQ_DECAY + (1 - VQ_DECAY) * one_hot.sum(0)
        n = cs.sum()
        cs = (cs + VQ_EPSILON) / (n + K * VQ_EPSILON) * n
        self.ema_w.mul_(VQ_DECAY).add_((1 - VQ_DECAY) * (one_hot.T @ flat))
        self.ema_cluster_size.copy_(cs)
        self.embedding.copy_(self.ema_w / cs[:, None])

    def forward(self, inputs: torch.Tensor):
        """inputs [B, C, T] (f32)."""
        B, C, T = inputs.shape
        x = inputs.transpose(1, 2)  # [B, T, C]
        flat = x.reshape(-1, C)
        w = self.embedding
        distances = ((flat ** 2).sum(dim=1, keepdim=True) + (w ** 2).sum(dim=1)[None, :]
                     - 2.0 * flat @ w.T)
        indices = distances.argmin(dim=1)
        vq_loss = perplexity = None
        if self.training:
            self._ema_update(flat.detach(), indices)
        quantized = self.embedding[indices].reshape(x.shape)
        if self.training:
            vq_loss = VQ_COMMITMENT_COST * torch.mean((quantized.detach() - x) ** 2)
            avg_probs = (torch.bincount(indices, minlength=self.num_embeddings).float()
                         / flat.shape[0])
            perplexity = torch.exp(-torch.sum(avg_probs * torch.log(avg_probs + 1e-10)))
        # straight-through estimator, literally: in f32 its value is not
        # exactly `quantized`
        quantized = x + (quantized - x).detach()
        return vq_loss, quantized.transpose(1, 2), perplexity, indices.reshape(B, T)


class VQBottleneck(nn.Module):
    """VectorQuantizerEMA as a TDNNF bottleneck function: returns the
    quantized features; in training mode it keeps this forward's
    ``{"vq_loss", "vq_perplexity"}`` in ``aux`` for the network to return."""

    def __init__(self, num_embeddings: int, embedding_dim: int):
        super().__init__()
        self.vq = VectorQuantizerEMA(num_embeddings, embedding_dim)
        self.aux = {}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        vq_loss, quantized, perplexity, _ = self.vq(x)
        self.aux = ({"vq_loss": vq_loss, "vq_perplexity": perplexity.detach()}
                    if self.training else {})
        return quantized


def constrain_orthonormal(M: torch.Tensor, scale: float, update_speed: float = 0.125
                          ) -> torch.Tensor:
    """One step of Povey's orthonormal-constraint update; ``scale < 0`` is
    the floating scale estimated from the matrix itself. Returns the new
    matrix."""
    rows, cols = M.shape
    transposed = rows < cols
    W = M.T if transposed else M
    d = W.shape[0]
    P = W @ W.T
    if scale < 0.0:
        trace_P = torch.trace(P)
        ratio = torch.sum(P ** 2) / trace_P
        ratio2 = ratio * d / trace_P
        speed = torch.where(ratio2 > 1.1, update_speed * 0.25,
                            torch.where(ratio2 > 1.02, update_speed * 0.5,
                                        torch.tensor(update_speed, device=M.device)))
        scale2 = ratio
    else:
        speed = update_speed
        scale2 = scale ** 2
    P = P - scale2 * torch.eye(d, dtype=M.dtype, device=M.device)
    W = W + (-4.0 * speed / scale2) * (P @ W)
    return W.T if transposed else W


def orthonormal_weights(model: nn.Module):
    """(name, weight) of every ``inner_nat`` affine: the weights the
    orthonormal constraint applies to."""
    return [(name, p) for name, p in model.named_parameters()
            if "inner_nat" in name.split(".") and name.endswith(".weight")]


class TDNNF(nn.Module):
    """Factorized TDNN layer: linearB (splice) -> [bottleneck] -> linearA
    (+ scaled bypass)."""

    def __init__(self, feat_dim: int, output_dim: int, bottleneck_dim: int,
                 context_len: int = 1, subsampling_factor: float = 1,
                 bypass_scale: float = 0.66,
                 bottleneck_func: Optional[nn.Module] = None,
                 compute_dtype: str = "float32", natural_gradient: bool = False):
        super().__init__()
        self.context_len = context_len
        self.subsampling_factor = subsampling_factor
        self.natural_gradient = natural_gradient
        self.bypass_scale = bypass_scale
        self.linearB = OrthonormalLinear(feat_dim * context_len, bottleneck_dim,
                                         compute_dtype=compute_dtype)
        self.linearA = NaturalAffineTransform(bottleneck_dim, output_dim,
                                              compute_dtype=compute_dtype)
        self.bottleneck_func = bottleneck_func
        self.use_bypass = bypass_scale > 0.0 and feat_dim == output_dim

    def _bypass(self, x: torch.Tensor, inp: torch.Tensor) -> torch.Tensor:
        c = self.context_len
        s = self.subsampling_factor
        if s == 1.5:
            T = inp.shape[-1]
            n = int(T / 1.5)
            idx = torch.from_numpy(np.floor(np.arange(0, n) * 1.5).astype(np.int64))
            y = inp[..., idx.to(inp.device)] * self.bypass_scale
            tx, ty = x.shape[-1], y.shape[-1]
            if tx < ty:
                x = F.pad(x, (0, ty - tx))
            elif ty < tx:
                y = F.pad(y, (0, tx - ty))
            return x + y
        s = int(s)
        if c > 1:
            if c == 2:
                lidx, ridx = 1, None
            elif c % 2 == 1:
                lidx = c // 2
                ridx = -lidx
            else:
                lidx = c // 2
                ridx = -lidx + 1
        else:
            lidx, ridx = 0, None
        ident = inp[..., lidx:ridx:s]
        return x + ident[..., :x.shape[-1]] * self.bypass_scale

    def forward(self, x: torch.Tensor, return_bottleneck: bool = False) -> torch.Tensor:
        inp = x
        s = self.subsampling_factor
        # natural-gradient training needs the spliced rows themselves (its
        # input-side statistics); otherwise the splice runs as a conv
        if float(s).is_integer() and not (self.natural_gradient and self.training):
            if self.context_len > 1:
                h = self.linearB(x, splice=(self.context_len, int(s)))
            else:
                h = self.linearB(x[..., ::int(s)] if int(s) > 1 else x)
        else:
            h = self.linearB(splice_frames(x, self.context_len, s))
        if self.bottleneck_func is not None:
            h = self.bottleneck_func(h)
        if return_bottleneck:
            return h
        h = self.linearA(h)
        if self.use_bypass:
            h = self._bypass(h, inp)
        return h


class BatchNormStats(nn.Module):
    """Non-affine batch norm over the channels of [B, C, T], buffers
    running_mean/running_var. Training mode uses flax's statistics: mean
    and biased variance E[x^2] - E[x]^2 (clipped at 0) over (B, T), and
    running = 0.9 * running + 0.1 * batch."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.register_buffer("running_mean", torch.zeros(dim))
        self.register_buffer("running_var", torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            mean = x.mean(dim=(0, 2))
            var = torch.clamp((x * x).mean(dim=(0, 2)) - mean * mean, min=0.0)
            with torch.no_grad():
                self.running_mean.mul_(BN_MOMENTUM).add_((1 - BN_MOMENTUM) * mean)
                self.running_var.mul_(BN_MOMENTUM).add_((1 - BN_MOMENTUM) * var)
        else:
            mean, var = self.running_mean, self.running_var
        return (x - mean[:, None]) * torch.rsqrt(var + self.eps)[:, None]


class TDNNFBatchNorm(nn.Module):
    """TDNNF + non-affine BatchNorm + ReLU."""

    def __init__(self, feat_dim: int, output_dim: int, bottleneck_dim: int,
                 context_len: int = 1, subsampling_factor: float = 1,
                 bypass_scale: float = 0.66,
                 bottleneck_func: Optional[nn.Module] = None,
                 compute_dtype: str = "float32", natural_gradient: bool = False):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.tdnn = TDNNF(feat_dim, output_dim, bottleneck_dim, context_len=context_len,
                          subsampling_factor=subsampling_factor, bypass_scale=bypass_scale,
                          bottleneck_func=bottleneck_func, compute_dtype=compute_dtype,
                          natural_gradient=natural_gradient)
        self.bn = BatchNormStats(output_dim)

    def forward(self, x: torch.Tensor, return_bottleneck: bool = False) -> torch.Tensor:
        h = self.tdnn(x, return_bottleneck=return_bottleneck)
        if return_bottleneck:
            return h
        h = torch.relu(self.bn(h))
        if self.compute_dtype == "bfloat16" and not self.training:
            # serving: inter-layer activations stored bf16 (the next matmul
            # casts to bf16 anyway; BN statistics stay f32)
            h = h.to(torch.bfloat16)
        return h
